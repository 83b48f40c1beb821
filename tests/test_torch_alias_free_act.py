"""Port's ``ops.fused_alias_free_snake`` (plain version, CPU tensors) against
the JAX package: the unfused composition on EVERY sample, and the
interpreted Pallas kernel on the interior (the TPU kernel continues the FIR
over the replicated input, which differs on the outer <= 3 samples)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.models.bigvgan import (
    Activation1d as JaxActivation1d,
    downsample2_nhc,
    snake,
    upsample2_nhc,
)
from diffbinaural_tpu.ops import fused_alias_free_snake as jax_fused
from diffbinaural_tpu.signal.filters import kaiser_sinc_filter1d as jax_taps
from diffbinaural_tpu_torch.models.bigvgan import Activation1d
from diffbinaural_tpu_torch.ops import (
    alias_free_snake_plain,
    fused_alias_free_snake,
)
from diffbinaural_tpu_torch.signal.filters import (
    DownSample1d,
    UpSample1d,
    kaiser_sinc_filter1d,
)

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

EDGE = 4  # boundary samples where the TPU kernel's convention differs
TOL = dict(rtol=1e-5, atol=1e-5)  # same float32 arithmetic, other order


def _world(c, t, logscale, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    if logscale:
        alpha = rng.standard_normal(c).astype(np.float32) * 0.1
        beta = rng.standard_normal(c).astype(np.float32) * 0.1
    else:
        alpha = 1.0 + 0.3 * rng.random(c).astype(np.float32)
        beta = 1.0 + 0.3 * rng.random(c).astype(np.float32)
    return x, alpha, beta


def _jax_composition(x, alpha, beta, logscale):
    a = jnp.exp(alpha) if logscale else jnp.asarray(alpha)
    b = jnp.exp(beta) if logscale else jnp.asarray(beta)
    return np.asarray(downsample2_nhc(snake(upsample2_nhc(jnp.asarray(x)), a, b)))


def _port(x, alpha, beta, logscale):
    got = fused_alias_free_snake(
        torch.from_numpy(x).permute(0, 2, 1).contiguous(),
        torch.from_numpy(alpha), torch.from_numpy(beta), logscale)
    return got.permute(0, 2, 1).numpy()


@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("t", [160, 513])
@pytest.mark.parametrize("c", [24, 128])
def test_matches_jax_composition_on_all_samples(c, t, logscale):
    x, alpha, beta = _world(c, t, logscale)
    want = _jax_composition(x, alpha, beta, logscale)
    got = _port(x, alpha, beta, logscale)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("t", [160, 513])
@pytest.mark.parametrize("c", [24, 128])
def test_matches_interpreted_pallas_kernel_on_interior(c, t, logscale):
    x, alpha, beta = _world(c, t, logscale, seed=1)
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(alpha),
                                jnp.asarray(beta), logscale))
    got = _port(x, alpha, beta, logscale)
    np.testing.assert_allclose(got[:, EDGE:-EDGE], want[:, EDGE:-EDGE], **TOL)


def test_short_clip_edges_overlap():
    """T smaller than the filters' reach: both edge clamps act at once."""
    x, alpha, beta = _world(8, 5, True, seed=2)
    np.testing.assert_allclose(_port(x, alpha, beta, True),
                               _jax_composition(x, alpha, beta, True), **TOL)


def test_taps_equal_jax():
    for args in ((0.25, 0.3, 12), (0.125, 0.15, 24), (0.5, 0.6, 7)):
        np.testing.assert_array_equal(kaiser_sinc_filter1d(*args),
                                      jax_taps(*args))


@pytest.mark.parametrize("ratio", [2, 4])
def test_resamplers_match_jax(ratio):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 50, 6)).astype(np.float32)
    k = int(6 * ratio // 2) * 2
    xt = torch.from_numpy(x).permute(0, 2, 1)
    up = UpSample1d(ratio)(xt).permute(0, 2, 1).numpy()
    np.testing.assert_allclose(
        up, np.asarray(upsample2_nhc(jnp.asarray(x), ratio, k)), **TOL)
    down = DownSample1d(ratio)(xt).permute(0, 2, 1).numpy()
    np.testing.assert_allclose(
        down, np.asarray(downsample2_nhc(jnp.asarray(x), ratio, k)), **TOL)


@pytest.mark.parametrize("activation", ["snake", "snakebeta"])
def test_activation1d_module_matches_jax(activation):
    import jax

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 12)).astype(np.float32)
    jm = JaxActivation1d(12, activation, True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.2 * jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), params)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = Activation1d(12, activation, True)
    tm.load_state_dict({
        "act." + k: torch.from_numpy(np.array(v))
        for k, v in params["params"]["act"].items()})
    got = tm(torch.from_numpy(x).permute(0, 2, 1)).permute(0, 2, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x, alpha, beta = _world(8, 64, True)
    xt = torch.from_numpy(x).permute(0, 2, 1).contiguous()
    before = fused_alias_free_snake.launches
    got = fused_alias_free_snake(xt, torch.from_numpy(alpha),
                                 torch.from_numpy(beta))
    assert fused_alias_free_snake.launches == before
    torch.testing.assert_close(got, alias_free_snake_plain(
        xt, torch.from_numpy(alpha), torch.from_numpy(beta)))


def test_rejects_bad_inputs():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        fused_alias_free_snake(x, torch.zeros(4), torch.zeros(8))
    with pytest.raises(ValueError):
        fused_alias_free_snake(x[0], torch.zeros(8), torch.zeros(8))
    with pytest.raises(TypeError):
        fused_alias_free_snake(x.double(), torch.zeros(8), torch.zeros(8))
