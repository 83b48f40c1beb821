"""Port's stage-1 UNet and its attention stack against the JAX package, with
the JAX parameters carried over by ``convert.unet_params_from_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.models import AudioVisualModel as JaxAudioVisualModel
from diffbinaural_tpu.models import attention as jax_attention
from diffbinaural_tpu.models import unet as jax_unet
from diffbinaural_tpu_torch.convert import unet_params_from_flax
from diffbinaural_tpu_torch.models import attention, build_unet, unet
from diffbinaural_tpu_torch.core.config import UnetConfig

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import random_params, t, to_numpy_tree

TOL = dict(rtol=1e-4, atol=1e-4)  # float32 both sides, ~40 layers deep


def _load(module, params):
    module.load_state_dict(unet_params_from_flax(to_numpy_tree(params)),
                           strict=True)
    return module.eval()


def _world(seed=0, b=2, hw=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, hw, hw)).astype(np.float32)
    mix = rng.uniform(-1, 1, (b, 1, hw, hw)).astype(np.float32)
    feat = rng.standard_normal((b, 512)).astype(np.float32)
    tt = np.array([3, 700], np.int32)
    return rng, x, mix, feat, tt


@pytest.fixture(scope="module")
def world():
    """One tiny JAX model and its random parameters for the module."""
    rng, x, mix, feat, tt = _world()
    jm = JaxAudioVisualModel(dim=16)
    cond = (jnp.asarray(mix), jnp.asarray(feat), jnp.asarray(x))
    params = random_params(jm, rng, jnp.asarray(x), jnp.asarray(tt), cond)
    return jm, params, cond, (x, mix, feat, tt)


def test_audio_visual_model_matches_jax(world):
    jm, params, cond, (x, mix, feat, tt) = world
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                        jnp.asarray(tt), cond))
    tm = _load(unet.AudioVisualModel(dim=16), params)
    with torch.no_grad():
        got = tm(t(x), t(tt), (t(mix), t(feat), t(x)))
    assert got.shape == (2, 2, 16, 16) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mix_t_is_inert_and_self_cond_defaults_to_zero(world):
    _, params, _, (x, mix, feat, tt) = world
    tm = _load(unet.AudioVisualModel(dim=16), params)
    with torch.no_grad():
        a = tm(t(x), t(tt), (t(mix), t(feat), t(x)))
        b = tm(t(x), t(tt), (t(mix), t(feat), None))
        c = tm(t(x), t(tt), (t(mix), t(feat), 5.0 * t(x) + 1.0))
        z = tm.net_unet(t(x), t(tt), None, None, t(feat))
        z0 = tm.net_unet(t(x), t(tt), torch.zeros(2, 1, 16, 16), None, t(feat))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    torch.testing.assert_close(z, z0, rtol=0, atol=0)


def test_build_unet_has_the_jax_parameter_tree(world):
    """``build_unet``'s module takes the JAX tree strictly: same names, same
    shapes, at the configured widths."""
    _, params, _, _ = world
    tm = build_unet(UnetConfig(dim=16), device="cpu")
    sd = unet_params_from_flax(to_numpy_tree(params))
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    n_jax = sum(p.size for p in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tm.parameters()) == n_jax


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 6, 8, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        unet.space_to_depth(t(x)).numpy(),
        np.asarray(jax_unet.space_to_depth(jnp.asarray(x))))


def test_sinusoidal_embedding_matches_jax():
    tt = np.array([0, 1, 500, 999], np.int32)
    want = np.asarray(jax_unet.SinusoidalPosEmb(64)(jnp.asarray(tt)))
    got = unet.SinusoidalPosEmb(64)(t(tt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _module_pair(jax_module, torch_module, x, *args, seed=4, **kwargs):
    rng = np.random.default_rng(seed)
    jargs = tuple(jnp.asarray(a) for a in args)
    jkwargs = {k: jnp.asarray(v) for k, v in kwargs.items()}
    params = random_params(jax_module, rng, jnp.asarray(x), *jargs, **jkwargs)
    want = np.asarray(jax.jit(jax_module.apply)(
        params, jnp.asarray(x), *jargs, **jkwargs))
    _load(torch_module, params)
    with torch.no_grad():
        got = torch_module(t(x), *(t(a) for a in args),
                           **{k: t(v) for k, v in kwargs.items()})
    return got.numpy(), want


@pytest.mark.parametrize("axis", ["f_window", "t_window"])
def test_linear_attention_matches_jax(axis):
    x = np.random.default_rng(5).standard_normal((2, 8, 12, 16)).astype(np.float32)
    got, want = _module_pair(
        jax_attention.LinearAttention(16, 2, 8, **{axis: 4}),
        attention.LinearAttention(16, 2, 8, **{axis: 4}), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_cross_attention_one_token_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 1, 24)).astype(np.float32)
    got, want = _module_pair(
        jax_attention.CrossAttention(16, context_dim=24, heads=2, dim_head=8),
        attention.CrossAttention(16, context_dim=24, heads=2, dim_head=8),
        x, context=ctx)
    np.testing.assert_allclose(got, want, **TOL)


def test_self_attention_with_time_film_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    temb = rng.standard_normal((2, 20)).astype(np.float32)
    got, want = _module_pair(
        jax_attention.Attention(16, 2, 8, use_time_film=True),
        attention.Attention(16, 2, 8, use_time_film=True, time_dim=20),
        x, temb)
    np.testing.assert_allclose(got, want, **TOL)


def test_feed_forward_uses_tanh_gelu():
    x = 3.0 * np.random.default_rng(8).standard_normal((2, 5, 16)).astype(np.float32)
    for glu in (True, False):
        got, want = _module_pair(jax_attention.FeedForward(16, glu=glu),
                                 attention.FeedForward(16, glu=glu), x)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resnet_block_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 6, 16)).astype(np.float32)
    temb = rng.standard_normal((2, 20)).astype(np.float32)
    got, want = _module_pair(
        jax_unet.ResnetBlock(32, groups=4, time_emb_dim=20),
        unet.ResnetBlock(16, 32, groups=4, time_emb_dim=20), x, temb)
    np.testing.assert_allclose(got, want, **TOL)


def test_long_sequences_go_through_the_flash_wrapper(monkeypatch):
    """n >= 1024 tokens take ``ops.flash_sdpa``; shorter ones stay dense."""
    calls = []
    real = attention.flash_sdpa

    def spy(q, k, v, scale):
        calls.append(q.shape[2])
        return real(q, k, v, scale)

    monkeypatch.setattr(attention, "flash_sdpa", spy)
    rng = np.random.default_rng(10)
    for n in (1024, 400):
        q, k, v = (t(rng.standard_normal((1, 2, n, 32)).astype(np.float32))
                   for _ in range(3))
        out = attention._sdpa(q, k, v, 32**-0.5)
        want = np.asarray(jax_attention._sdpa(
            *(jnp.asarray(a.numpy()) for a in (q, k, v)), 32**-0.5))
        np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
    assert calls == [1024]
