"""Port's stage-2 frontends and discriminators against the JAX package:
``stft_complex``, the CQT (kernels, framing, decimation, octave stack), and
every discriminator family at narrow widths with the JAX parameters carried
over by ``convert.discriminator_params_from_flax`` — logits and every
feature map (the port's maps are NCHW, the JAX ones NHWC)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.models import discriminators as jd
from diffbinaural_tpu.signal import cqt as jcqt
from diffbinaural_tpu.signal.stft import stft_complex as jax_stft_complex
from diffbinaural_tpu_torch.convert import (discriminator_params_from_flax,
                                            tree_to_flax)
from diffbinaural_tpu_torch.core.config import load_hparams_from_json
from diffbinaural_tpu_torch.losses import feature_loss, generator_loss
from diffbinaural_tpu_torch.models import build_discriminators
from diffbinaural_tpu_torch.models import discriminators as td
from diffbinaural_tpu_torch.signal import cqt, cqt_kernels, stft_complex
from diffbinaural_tpu_torch.signal.cqt import _decimate2, _frame_const_pad

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import random_params, t, to_numpy_tree

TOL = dict(rtol=1e-4, atol=1e-5)  # float32 both sides, other sum orders


def _audio(b=2, n=1024, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((b, 1, n))).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop", [(32, 8), (64, 16), (512, 128)])
def test_stft_complex_matches_jax(n_fft, hop):
    y = _audio(n=1000)[:, 0]
    want = np.asarray(jax_stft_complex(jnp.asarray(y), n_fft, hop))
    got = stft_complex(t(y), n_fft, hop)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bpo,n_oct", [(2, 9), (3, 9), (4, 5), (24, 9)])
def test_cqt_kernels_equal_jax(bpo, n_oct):
    """The top octave falls as the octave count falls, and its kernels grow
    (L = ceil(Q sr / f)): 9 octaves at 24 bins give the production length."""
    for want, got in zip(jcqt.cqt_kernels(44100, bpo, n_oct),
                         cqt_kernels(44100, bpo, n_oct)):
        np.testing.assert_array_equal(got, want)


def test_framing_and_decimation_match_jax():
    x = _audio(n=999, seed=1)[:, 0]
    for frame_len, hop in ((13, 4), (14, 256), (363, 8)):
        np.testing.assert_array_equal(
            _frame_const_pad(t(x), frame_len, hop).numpy(),
            np.asarray(jcqt._frame_const_pad(jnp.asarray(x), frame_len, hop)))
    np.testing.assert_allclose(_decimate2(t(x)).numpy(),
                               np.asarray(jcqt._decimate2(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hop,n_oct,bpo", [(256, 9, 2), (256, 9, 3),
                                           (64, 4, 5)])
def test_cqt_matches_jax(hop, n_oct, bpo):
    x = _audio(n=2048, seed=2)[:, 0]
    want = np.asarray(jcqt.cqt(jnp.asarray(x), 44100, hop, n_oct, bpo))
    got = cqt(t(x), 44100, hop, n_oct, bpo)
    assert got.shape == want.shape == (2, n_oct * bpo, 2048 // hop + 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _check(jm, tm, y, y_hat, rng):
    """Carry random JAX parameters over, run both, compare every output."""
    params = random_params(jm, rng, jnp.asarray(y), jnp.asarray(y_hat))
    tm.load_state_dict(discriminator_params_from_flax(to_numpy_tree(params)),
                       strict=True)
    want = jax.jit(jm.apply)(params, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = tm(t(y), t(y_hat))
    rs, gs, fr, fg = want
    assert len(got[0]) == len(rs) and len(got[2]) == len(fr)
    for g, w in zip(got[0] + got[1], rs + gs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    n_maps = 0
    for gd, wd in zip(got[2] + got[3], fr + fg):
        assert len(gd) == len(wd)
        for g, w in zip(gd, wd):
            g = g.permute(0, 2, 3, 1).numpy()  # NCHW -> NHWC
            np.testing.assert_allclose(g, np.asarray(w), **TOL)
            n_maps += 1
    # and back: the converter's inverse gives the flax tree again
    back = tree_to_flax(dict(tm.named_parameters()))
    flat = jax.tree_util.tree_leaves_with_path(params["params"])
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    return n_maps


def test_multi_period_discriminator_matches_jax():
    rng = np.random.default_rng(3)
    y, y_hat = _audio(n=1001, seed=4), _audio(n=1001, seed=5)  # reflect pad
    n = _check(jd.MultiPeriodDiscriminator(periods=(2, 3), channel_mult=0.125),
               td.MultiPeriodDiscriminator(periods=(2, 3), channel_mult=0.125),
               y, y_hat, rng)
    assert n == 2 * 2 * 6


def test_multi_resolution_discriminator_matches_jax():
    rng = np.random.default_rng(6)
    res = ((128, 32, 64), (64, 16, 64))
    n = _check(jd.MultiResolutionDiscriminator(res, channel_mult=0.25),
               td.MultiResolutionDiscriminator(res, channel_mult=0.25),
               _audio(seed=7), _audio(seed=8), rng)
    assert n == 2 * 2 * 6


def test_multi_band_discriminator_matches_jax():
    rng = np.random.default_rng(9)
    n = _check(jd.MultiBandDiscriminator(fft_sizes=(128, 64)),
               td.MultiBandDiscriminator(fft_sizes=(128, 64)),
               _audio(seed=10), _audio(seed=11), rng)
    assert n == 2 * 2 * (5 * 4 + 1)


def test_cqt_discriminator_matches_jax():
    """Two scales of 9 octaves with few bins each (the production layout,
    narrow): x2 resample, CQT, per-octave pre-convs, dilated stack."""
    rng = np.random.default_rng(12)
    kw = dict(sampling_rate=22050, hop_lengths=(256, 256), n_octaves=(9, 9),
              bins_per_octaves=(2, 3), filters=8)
    n = _check(jd.MultiScaleSubbandCQTDiscriminator(**kw),
               td.MultiScaleSubbandCQTDiscriminator(**kw),
               _audio(seed=13), _audio(seed=14), rng)
    assert n == 2 * 2 * 5


def test_combined_discriminator_matches_jax():
    rng = np.random.default_rng(15)
    n = _check(
        jd.CombinedDiscriminator((
            jd.MultiPeriodDiscriminator(periods=(2,), channel_mult=0.125),
            jd.MultiBandDiscriminator(fft_sizes=(64,)))),
        td.CombinedDiscriminator((
            td.MultiPeriodDiscriminator(periods=(2,), channel_mult=0.125),
            td.MultiBandDiscriminator(fft_sizes=(64,)))),
        _audio(seed=16), _audio(seed=17), rng)
    assert n == 2 * (6 + 21)


def test_single_is_one_half_of_the_contract():
    torch.manual_seed(0)
    mpd = td.init_discriminator(
        td.MultiPeriodDiscriminator(periods=(2, 3), channel_mult=0.125))
    y, y_hat = t(_audio(seed=18)), t(_audio(seed=19))
    with torch.no_grad():
        rs, gs, fr, fg = mpd(y, y_hat)
        logits, fmaps = mpd.single(y_hat)
    for a, b in zip(gs, logits):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(fmaps) == len(fg) == 2


@pytest.mark.parametrize("family", ["cqtd", "mbd", "mrd"])
def test_build_discriminators_follows_the_config(family):
    h = load_hparams_from_json("configs/bigvgan_binaural_22khz_80band_256x.json")
    h = dict(h, use_cqtd_instead_of_mrd=family == "cqtd",
             use_mbd_instead_of_mrd=family == "mbd",
             resolutions=[[1024, 120, 600], [2048, 240, 1200], [512, 50, 240]])
    mpd, mrd = build_discriminators(h, device="cpu")
    kind = {"cqtd": td.MultiScaleSubbandCQTDiscriminator,
            "mbd": td.MultiBandDiscriminator,
            "mrd": td.MultiResolutionDiscriminator}[family]
    assert isinstance(mrd, kind)
    assert [m.period for m in mpd.subs()] == [2, 3, 5, 7, 11]
    assert all(p.device.type == "cpu" for p in mrd.parameters())
    if family == "cqtd":  # the production config's CQTD
        subs = mrd.subs()
        assert [(d.hop_length, d.n_octaves, d.bins_per_octave) for d in subs] \
            == [(512, 9, 24), (256, 9, 36), (256, 9, 48)]
        assert subs[0].conv_0.v.shape == (128, 2, 3, 9)


# The production families (MPD + sub-band CQTD) at toy width, as the JAX
# package's precision audit of bfloat16 discriminator convolutions runs them.
BF16_H = {"use_cqtd_instead_of_mrd": True, "mpd_reshapes": [2, 3],
          "cqtd_hop_lengths": [512], "cqtd_n_octaves": [5],
          "cqtd_bins_per_octaves": [24], "cqtd_filters": 8,
          "sampling_rate": 22050, "discriminator_channel_mult": 0.25}


def _tones(seed, b=2, n=8192):
    """Sine mixture + noise at vocoder-output-like amplitude."""
    rng = np.random.default_rng(seed)
    time_s = np.arange(n) / 22050.0
    wav = sum(a * np.sin(2 * np.pi * f * time_s + p) for a, f, p in zip(
        rng.uniform(0.05, 0.3, 4), rng.uniform(80, 6000, 4),
        rng.uniform(0, 6, 4)))
    wav = wav[None] + 0.02 * rng.standard_normal((b, n))
    return wav.astype(np.float32)[:, None, :]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def bf16_pair():
    """``build_discriminators`` in float32 and in bfloat16 with the same
    (JAX-drawn) parameters, and the JAX pair's logits in both types."""
    rng = np.random.default_rng(20)
    y, y_hat = _tones(0), _tones(1)
    flax_families = {
        "mpd": lambda dt: jd.MultiPeriodDiscriminator(
            periods=(2, 3), channel_mult=0.25, dtype=dt),
        "mrd": lambda dt: jd.MultiScaleSubbandCQTDiscriminator(
            sampling_rate=22050, hop_lengths=(512,), n_octaves=(5,),
            bins_per_octaves=(24,), filters=8, dtype=dt)}
    port = {jnp.float32: build_discriminators(BF16_H, device="cpu"),
            jnp.bfloat16: build_discriminators(BF16_H, dtype=torch.bfloat16,
                                               device="cpu")}
    jax_logits = {}
    for i, (name, make) in enumerate(flax_families.items()):
        params = random_params(make(jnp.float32), rng, jnp.asarray(y),
                               jnp.asarray(y_hat))
        state = discriminator_params_from_flax(to_numpy_tree(params))
        for dt in port:
            port[dt][i].load_state_dict(state, strict=True)
            rs, gs, _, _ = jax.jit(make(dt).apply)(
                params, jnp.asarray(y), jnp.asarray(y_hat))
            jax_logits[name, dt] = rs + gs
    return port, jax_logits, y, y_hat


def test_bf16_discriminator_logits_match_jax(bf16_pair):
    """``dtype=torch.bfloat16`` runs the convolutions in bfloat16: the
    logits are bfloat16, within 6e-2 (relative norm) of the float32 pair's
    and of the JAX bfloat16 pair's (measured up to 2.4e-2 and 1.4e-2 over
    three parameter draws: bfloat16's 2^-8 through five or six
    convolutions; the JAX package's own bound is 0.15), and no further from
    float32 than the JAX bfloat16 pair is, with 2x slack (measured up to
    1.04x)."""
    port, jax_logits, y, y_hat = bf16_pair
    for i, name in enumerate(("mpd", "mrd")):
        with torch.no_grad():
            r16, g16, _, _ = port[jnp.bfloat16][i](t(y), t(y_hat))
            r32, g32, _, _ = port[jnp.float32][i](t(y), t(y_hat))
        assert r16[0].dtype == torch.bfloat16 and r32[0].dtype == torch.float32
        for a16, a32, j16, j32 in zip(r16 + g16, r32 + g32,
                                      jax_logits[name, jnp.bfloat16],
                                      jax_logits[name, jnp.float32]):
            a16 = a16.float().numpy()
            assert _rel(a32.numpy(), j32) < 1e-5, name
            assert _rel(a16, a32.numpy()) < 6e-2, name
            assert _rel(a16, j16) < 6e-2, name
            assert _rel(a16, j32) < 2 * _rel(j16, j32), name


def test_bf16_generator_gradient_direction(bf16_pair):
    """The gradient the generator receives (with respect to its waveform)
    through the bfloat16 discriminators points the float32 way: cosine
    >= 0.98 and magnitude within 10 %, the JAX package's bounds."""
    port, _, y, y_hat = bf16_pair
    grads = {}
    for dt, (mpd, mrd) in port.items():
        wav = t(y_hat).requires_grad_(True)
        loss = 0.0
        for disc in (mpd, mrd):
            with torch.no_grad():
                _, fm_r = disc.single(t(y))
            logits, fm_g = disc.single(wav)
            loss = loss + generator_loss(logits)[0] + feature_loss(fm_r, fm_g)
        assert loss.dtype == torch.float32  # the losses upcast
        (grads[dt],) = torch.autograd.grad(loss, wav)
    a = grads[jnp.float32].double().flatten()
    b = grads[jnp.bfloat16].double().flatten()
    assert float(a @ b / (a.norm() * b.norm())) > 0.98
    assert 0.9 < float(b.norm() / a.norm()) < 1.1
