"""Port's BigVGAN generator against the JAX package, with the JAX parameters
carried over by ``convert.bigvgan_params_from_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.core.config import VocoderConfig as JaxVocoderConfig
from diffbinaural_tpu.models import bigvgan as jax_bigvgan
from diffbinaural_tpu_torch.convert import bigvgan_params_from_flax
from diffbinaural_tpu_torch.core.config import VocoderConfig
from diffbinaural_tpu_torch.models import bigvgan, build_vocoder

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import TINY_VOCODER, random_params, t, to_numpy_tree

TOL = dict(rtol=1e-4, atol=1e-4)  # float32 both sides


def _load(module, params):
    module.load_state_dict(
        bigvgan_params_from_flax(to_numpy_tree(params)), strict=True)
    return module.eval()


@pytest.mark.parametrize("resblock,final", [("1", False), ("1", True),
                                            ("2", False)])
def test_bigvgan_matches_jax(resblock, final):
    """``final``: tanh + bias on the last layer (the upstream JSON default)
    against clip and no bias (the dataclass default)."""
    rng = np.random.default_rng(0)
    kw = dict(TINY_VOCODER, resblock=resblock, use_tanh_at_final=final,
              use_bias_at_final=final)
    mel = rng.standard_normal((2, 8, 16)).astype(np.float32)
    jm = jax_bigvgan.BigVGAN(JaxVocoderConfig(**kw))
    params = random_params(jm, rng, jnp.asarray(mel))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(mel)))
    tm = _load(bigvgan.BigVGAN(VocoderConfig(**kw)), params)
    with torch.no_grad():
        got = tm(t(mel))
    assert got.shape == (2, 1, 16 * 8) and got.dtype == torch.float32
    assert 0.05 < np.abs(want).max() <= 1.0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_binaural_bigvgan_matches_jax():
    rng = np.random.default_rng(1)
    left = rng.standard_normal((2, 8, 12)).astype(np.float32)
    right = rng.standard_normal((2, 8, 12)).astype(np.float32)
    jm = jax_bigvgan.BinauralBigVGAN(JaxVocoderConfig(**TINY_VOCODER))
    params = random_params(jm, rng, jnp.asarray(left), jnp.asarray(right))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(left),
                                        jnp.asarray(right)))
    tm = _load(bigvgan.BinauralBigVGAN(VocoderConfig(**TINY_VOCODER)), params)
    with torch.no_grad():
        got = tm(t(left), t(right))
    assert got.shape == (2, 2, 96)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k,u", [(8, 4), (4, 2), (7, 3)])
def test_wn_conv_transpose_matches_jax(k, u):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    jm = jax_bigvgan.WNConvTranspose1d(4, k, u)
    params = random_params(jm, rng, jnp.asarray(x))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = _load(bigvgan.WNConvTranspose1d(6, 4, k, u), params)
    with torch.no_grad():
        got = tm(t(x).permute(0, 2, 1)).permute(0, 2, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the norm is per INPUT channel, over (out, k)
    v, g = tm.v.detach(), tm.g.detach()
    kernel = tm.kernel().detach()
    torch.testing.assert_close(
        torch.sqrt((kernel**2).sum(dim=(1, 2))), g.abs(), rtol=1e-5, atol=1e-6)
    assert v.shape == (6, 4, k) and g.shape == (6,)


@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_wn_conv_matches_jax(k, d):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    jm = jax_bigvgan.WNConv1d(5, k, dilation=d)
    params = random_params(jm, rng, jnp.asarray(x))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = _load(bigvgan.WNConv1d(6, 5, k, dilation=d), params)
    with torch.no_grad():
        got = tm(t(x).permute(0, 2, 1)).permute(0, 2, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_remove_weight_norm_is_a_numerical_no_op():
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((1, 8, 16)).astype(np.float32)
    jm = jax_bigvgan.BigVGAN(JaxVocoderConfig(**TINY_VOCODER))
    params = random_params(jm, rng, jnp.asarray(mel))
    tm = _load(bigvgan.BigVGAN(VocoderConfig(**TINY_VOCODER)), params)
    with torch.no_grad():
        before = tm(t(mel))
        v_before = tm.conv_pre.v.clone()
        bigvgan.remove_weight_norm(tm)
        after = tm(t(mel))
    assert not torch.equal(v_before, tm.conv_pre.v)
    # float32 rounding of v*g/||v|| folded once instead of at every call
    torch.testing.assert_close(after, before, rtol=1e-5, atol=1e-5)
    folded = jax_bigvgan.remove_weight_norm(to_numpy_tree(params))
    sd = bigvgan_params_from_flax(to_numpy_tree(folded))
    for name, value in tm.state_dict().items():
        torch.testing.assert_close(value, sd[name], rtol=1e-5, atol=1e-6,
                                   msg=name)


def test_widest_amp_stage_takes_the_fused_snake_conv_gate():
    for d in (1, 3, 5):
        assert bigvgan._snake_conv_fusable(768, 3, d)
        assert bigvgan._snake_conv_fusable(768, 7, d)
        assert not bigvgan._snake_conv_fusable(768, 11, d)
        assert not bigvgan._snake_conv_fusable(384, 3, d)


def test_fused_amp_block_equals_unfused():
    """An AMP block routed through ``ops.fused_snake_conv`` (plain version
    here) equals the same block with activation and conv kept apart."""
    rng = np.random.default_rng(5)
    block = bigvgan.AMPBlock1(128, 3, (1, 3))
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(t(0.05 * rng.standard_normal(tuple(p.shape)).astype(np.float32)))
        x = t(rng.standard_normal((1, 128, 50)).astype(np.float32))
        assert block.fuse == ((False, False), (False, False))
        want = block(x)
        block.fuse = ((True, True), (True, True))
        got = block(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_build_vocoder_default_config_has_the_jax_shapes():
    """Full-width generator: same parameter names and shapes as the JAX
    tree (shapes only — nothing is run at this size on the CPU)."""
    jm = jax_bigvgan.BigVGAN(JaxVocoderConfig())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 80, 16)))
    as_np = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    want = {k: tuple(v.shape)
            for k, v in bigvgan_params_from_flax(as_np).items()}
    with torch.device("meta"):
        tm = bigvgan.BigVGAN(VocoderConfig())
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want


def test_from_attrdict_defaults_differ_from_dataclass():
    from diffbinaural_tpu_torch.core.config import AttrDict

    h = AttrDict(num_mels=8, upsample_rates=[4, 2],
                 upsample_kernel_sizes=[8, 4], upsample_initial_channel=32,
                 resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]])
    got = VocoderConfig.from_attrdict(h)
    want = JaxVocoderConfig.from_attrdict(h)
    for f in ("num_mels", "upsample_rates", "upsample_kernel_sizes",
              "upsample_initial_channel", "resblock", "resblock_kernel_sizes",
              "resblock_dilation_sizes", "activation", "snake_logscale",
              "use_tanh_at_final", "use_bias_at_final"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.use_tanh_at_final and not VocoderConfig().use_tanh_at_final
    assert build_vocoder(got, device="cpu").conv_post.b is not None
