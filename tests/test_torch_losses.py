"""Port's stage-2 losses against the JAX package: LS-GAN and feature
matching, the multi-scale mel loss (value and gradient), the silence-aware
losses and the binaural-enhanced loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu import losses as jl
from diffbinaural_tpu_torch import losses as tl

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import t

TOL = dict(rtol=1e-5, atol=1e-6)  # float32 both sides


def _logits_and_maps(seed=0):
    rng = np.random.default_rng(seed)
    logits = [rng.standard_normal((2, n)).astype(np.float32) for n in (7, 13)]
    maps = [[rng.standard_normal((2, 3, 5, c)).astype(np.float32)
             for c in (4, 8)] for _ in range(2)]
    return logits, maps


def test_gan_losses_match_jax():
    rs, fr = _logits_and_maps(0)
    gs, fg = _logits_and_maps(1)
    j = jl.discriminator_loss([jnp.asarray(a) for a in rs],
                              [jnp.asarray(a) for a in gs])
    p = tl.discriminator_loss([t(a) for a in rs], [t(a) for a in gs])
    np.testing.assert_allclose(float(p[0]), float(j[0]), **TOL)
    for a, b in zip(p[1] + p[2], j[1] + j[2]):
        np.testing.assert_allclose(float(a), float(b), **TOL)
    j = jl.generator_loss([jnp.asarray(a) for a in gs])
    p = tl.generator_loss([t(a) for a in gs])
    np.testing.assert_allclose(float(p[0]), float(j[0]), **TOL)
    j = jl.feature_loss(jax.tree_util.tree_map(jnp.asarray, fr),
                        jax.tree_util.tree_map(jnp.asarray, fg))
    p = tl.feature_loss([[t(a) for a in d] for d in fr],
                        [[t(a) for a in d] for d in fg])
    np.testing.assert_allclose(float(p), float(j), **TOL)


def test_gan_losses_upcast_bfloat16():
    rs, _ = _logits_and_maps(2)
    gs, _ = _logits_and_maps(3)
    p16 = tl.discriminator_loss([t(a).bfloat16() for a in rs],
                                [t(a).bfloat16() for a in gs])[0]
    assert p16.dtype == torch.float32
    want = tl.discriminator_loss([t(a).bfloat16().float() for a in rs],
                                 [t(a).bfloat16().float() for a in gs])[0]
    torch.testing.assert_close(p16, want)


@pytest.mark.parametrize("scales", [((5, 32), (10, 64)), ((80, 512),)])
def test_multiscale_mel_loss_and_gradient_match_jax(scales):
    n_mels, windows = zip(*scales)
    rng = np.random.default_rng(4)
    x = (0.3 * rng.standard_normal((2, 1, 2000))).astype(np.float32)
    y = (0.3 * rng.standard_normal((2, 1, 2000))).astype(np.float32)
    jm = jl.MultiScaleMelSpectrogramLoss(22050, n_mels=n_mels,
                                         window_lengths=windows)
    tm = tl.MultiScaleMelSpectrogramLoss(22050, n_mels=n_mels,
                                         window_lengths=windows)
    want, want_grad = jax.value_and_grad(jm)(jnp.asarray(x), jnp.asarray(y))
    xt = t(x).requires_grad_()
    got = tm(xt, t(y))
    (grad,) = torch.autograd.grad(got, [xt])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want_grad)).max())


def test_multiscale_mel_loss_default_scales():
    tm = tl.MultiScaleMelSpectrogramLoss(22050)
    assert [s[:3] for s in tm._scales] == [
        (5, 32, 8), (10, 64, 16), (20, 128, 32), (40, 256, 64),
        (80, 512, 128), (160, 1024, 256), (320, 2048, 512)]


def _mels(seed, silent_frames=()):
    rng = np.random.default_rng(seed)
    mel = np.exp(rng.uniform(-6, 1, (2, 8, 24))).astype(np.float32)
    for f in silent_frames:
        mel[:, :, f] = 1e-6
    return mel


def test_silence_losses_match_jax():
    y_mel = _mels(5, silent_frames=range(3, 12))
    g_mel = _mels(6)
    rng = np.random.default_rng(7)
    y = rng.standard_normal((2, 1, 24 * 8 + 3)).astype(np.float32)
    g = rng.standard_normal((2, 1, 24 * 8 + 3)).astype(np.float32)
    J = lambda *a: [jnp.asarray(v) for v in a]  # noqa: E731
    T = lambda *a: [t(v) for v in a]  # noqa: E731

    mask_j = np.asarray(jl.detect_silence_regions(*J(y_mel), -50.0))
    mask_t = tl.detect_silence_regions(*T(y_mel), -50.0).numpy()
    np.testing.assert_array_equal(mask_t, mask_j)
    assert 0 < mask_t.sum() < mask_t.size

    for want, got in (
        (jl.simple_silence_aware_mel_loss(*J(y_mel, g_mel), -50.0, 2.0),
         tl.simple_silence_aware_mel_loss(*T(y_mel, g_mel), -50.0, 2.0)),
        (jl.spectral_consistency_loss(*J(g_mel)),
         tl.spectral_consistency_loss(*T(g_mel))),
        (jl.energy_regularization_loss(*J(y_mel, g_mel, g)),
         tl.energy_regularization_loss(*T(y_mel, g_mel, g))),
        (jl.energy_regularization_loss(*J(y_mel, g_mel)),
         tl.energy_regularization_loss(*T(y_mel, g_mel))),
    ):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    for want, got in zip(
            jl.silence_aware_loss(*J(y_mel, g_mel, y, g), silence_threshold_db=-50.0),
            tl.silence_aware_loss(*T(y_mel, g_mel, y, g), silence_threshold_db=-50.0)):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(tl.silence_aware_loss(*T(y_mel, g_mel))[1]) == 0.0
    from diffbinaural_tpu.losses.silence import adaptive_loss_weighting
    for step in (0, 500, 2000):
        np.testing.assert_allclose(tl.adaptive_loss_weighting(step, 1000),
                                   adaptive_loss_weighting(step, 1000))


def test_binaural_enhanced_losses_match_jax():
    rng = np.random.default_rng(8)
    pred = rng.standard_normal((2, 2, 8, 12)).astype(np.float32)
    target = rng.standard_normal((2, 2, 8, 12)).astype(np.float32)
    np.testing.assert_allclose(
        float(tl.enhanced_l1_loss(t(pred), t(target))),
        float(jl.enhanced_l1_loss(jnp.asarray(pred), jnp.asarray(target))),
        **TOL)
    want = jl.BinauralEnhancedLoss()(jnp.asarray(pred), jnp.asarray(target), 0.5)
    got = tl.BinauralEnhancedLoss()(t(pred), t(target), 0.5)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # one channel: only the dynamics term joins the base loss
    want = jl.BinauralEnhancedLoss()(jnp.asarray(pred[:, :1]),
                                     jnp.asarray(target[:, :1]), 0.5)
    got = tl.BinauralEnhancedLoss()(t(pred[:, :1]), t(target[:, :1]), 0.5)
    np.testing.assert_allclose(float(got), float(want), **TOL)
