"""The leftovers of the port: ``models/norms.py``'s ``PreNorm``,
``BatchNorm`` and ``ChannelRMSNorm`` against the JAX modules (within 1e-6
of each output's or statistic's scale, float32; ``BatchNorm``'s running
statistics over three updates), the dead
``core/advanced_diffusion_config.py`` against its JAX copy, and
``utils/profiling.py`` (``trace`` with a program span in its file, and
``device_memory_stats``, on the CPU)."""

import json

import jax
import numpy as np
import torch

from diffbinaural_tpu.core.advanced_diffusion_config import \
    AdvancedDiffusionConfig as JaxAdvancedConfig
from diffbinaural_tpu.models import norms as jax_norms
from diffbinaural_tpu_torch.convert import norm_params_from_flax
from diffbinaural_tpu_torch.core.advanced_diffusion_config import \
    AdvancedDiffusionConfig
from diffbinaural_tpu_torch.models import ChannelRMSNorm, norms
from diffbinaural_tpu_torch.utils import device_memory_stats, span, trace

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import t, to_numpy_tree

TOL = 1e-6
C = 12


def _x(seed, shape=(3, 5, 7, C), offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 1.5 + offset).astype(np.float32)


def _assert_close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def _randomised(variables, seed):
    """Every leaf of a flax variable tree perturbed from its init, so that
    a dropped or mixed-up leaf shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.standard_normal(a.shape).astype(
            np.float32), to_numpy_tree(variables))


def test_channel_rms_norm_matches_jax():
    x = _x(0)
    x[0, 0, 0] = 0.0  # a zero vector: the 1e-12 floor
    jm = jax_norms.ChannelRMSNorm()
    variables = _randomised(jm.init(jax.random.PRNGKey(0), x), 1)
    want = np.asarray(jm.apply(variables, x))
    m = ChannelRMSNorm(C)
    m.load_state_dict(norm_params_from_flax(variables), strict=True)
    _assert_close(m(t(x)), want)
    assert (want[0, 0, 0] == 0).all()


def test_pre_norm_matches_jax():
    """``fn`` of the normalised input, keyword arguments passed on; the
    tree holds ``norm`` and ``fn``."""

    class JaxScale(jax_norms.nn.Module):
        @jax_norms.nn.compact
        def __call__(self, x, shift=0.0):
            return jax_norms.nn.Dense(4, name="proj")(x) + shift

    class Scale(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(C, 4)

        def forward(self, x, shift=0.0):
            return self.proj(x) + shift

    x = _x(2)
    jm = jax_norms.PreNorm(fn=JaxScale())
    variables = _randomised(jm.init(jax.random.PRNGKey(0), x), 3)
    assert set(variables["params"]) == {"fn", "norm"}
    want = np.asarray(jm.apply(variables, x, shift=0.5))
    m = norms.PreNorm(C, Scale())
    m.load_state_dict(norm_params_from_flax(variables), strict=True)
    _assert_close(m(t(x), shift=0.5), want)


def test_batch_norm_matches_jax_over_three_updates():
    """Three training-mode calls update the running mean / var with the
    BIASED batch variance (``nn.BatchNorm2d`` would take the unbiased
    one); the outputs, the buffers after each update and the
    running-average output all within 1e-6 of their scale."""
    jm = jax_norms.BatchNorm()
    x0 = _x(10)
    variables = jm.init(jax.random.PRNGKey(0), x0, use_running_average=False)
    variables = {"params": _randomised(variables["params"], 4),
                 "batch_stats": to_numpy_tree(variables["batch_stats"])}
    m = norms.BatchNorm(C)
    m.load_state_dict(norm_params_from_flax(variables), strict=True)
    assert {n for n, _ in m.named_buffers()} == {"mean", "var"}
    params, stats = variables["params"], variables["batch_stats"]
    for step in range(3):
        x = _x(20 + step, offset=0.5 * step)
        want, upd = jm.apply({"params": params, "batch_stats": stats}, x,
                             use_running_average=False,
                             mutable=["batch_stats"])
        stats = to_numpy_tree(upd["batch_stats"])
        got = m(t(x), use_running_average=False)
        _assert_close(got, want)
        for k in ("mean", "var"):
            _assert_close(getattr(m, k), stats[k])
    # the biased variance: 1/N, not 1/(N - 1)
    xs = t(_x(99)).reshape(-1, C)
    before = m.var.clone()
    m(t(_x(99)), use_running_average=False)
    biased = xs.var(dim=0, unbiased=False)
    _assert_close(m.var, (0.1 * biased + 0.9 * before).numpy())
    m.mean.copy_(torch.from_numpy(stats["mean"]))
    m.var.copy_(torch.from_numpy(stats["var"]))
    x = _x(30)
    want = jm.apply({"params": params, "batch_stats": stats}, x)
    _assert_close(m(t(x)), want)


def test_norms_are_exported_as_in_jax():
    from diffbinaural_tpu import models as jax_models
    from diffbinaural_tpu_torch import models

    for name in ("ChannelLayerNorm", "ChannelRMSNorm"):
        assert hasattr(jax_models, name) and hasattr(models, name)
        assert name in models.__all__


def test_advanced_diffusion_config_is_the_jax_copy():
    for name in dir(JaxAdvancedConfig):
        if name.isupper():
            assert getattr(AdvancedDiffusionConfig, name) == getattr(
                JaxAdvancedConfig, name), name
        elif name.startswith("get_"):
            assert getattr(AdvancedDiffusionConfig, name)() == getattr(
                JaxAdvancedConfig, name)(), name


def test_trace_with_a_span_and_memory_stats_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "prof")):
        with span("unet"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = [e.get("name", "") for e in events["traceEvents"]]
    assert any("mm" in n for n in names)
    assert "diffbinaural.unet" in names
    assert device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert device_memory_stats() is None
