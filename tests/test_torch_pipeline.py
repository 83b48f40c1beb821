"""The ported slice as a whole: ``BinauralPipeline`` (windows -> DDIM over
the UNet -> stitch -> vocoder) against the JAX pipeline, with converted
weights and the JAX pipeline's noise reproduced and injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.core.config import VocoderConfig as JaxVocoderConfig
from diffbinaural_tpu.infer import pipeline as jax_pipeline
from diffbinaural_tpu.infer import stage1 as jax_stage1
from diffbinaural_tpu.infer import vocoder as jax_vocoder
from diffbinaural_tpu.models import AudioVisualModel as JaxAudioVisualModel
from diffbinaural_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from diffbinaural_tpu_torch.convert import (
    bigvgan_params_from_flax,
    unet_params_from_flax,
)
from diffbinaural_tpu_torch.core.config import VocoderConfig
from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
from diffbinaural_tpu_torch.infer import (
    BinauralPipeline,
    Stage1Sampler,
    Vocoder,
    crop_spans,
    denormalize_mel,
    detect_and_exclude_zero_frames,
    generate_clip,
    normalize_mel,
    reconstruct_audio_with_silence,
    window_starts,
)
from diffbinaural_tpu_torch.models import bigvgan, unet

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import TINY_VOCODER, random_params, t, to_numpy_tree

M, WINDOW, FRAMES, GROUP, STEPS = 16, 80, 200, 3, 4
VOC = dict(TINY_VOCODER, num_mels=M)


def _build_world():
    """Tiny UNet (dim 16) + tiny vocoder in both frameworks with the same
    weights; a 200-frame clip = 4 windows in 2 groups of 3 (two spare
    slots).  Windows are 16 x 80 = 1280 tokens, so the port's attention goes
    through the ``flash_sdpa`` wrapper."""
    rng = np.random.default_rng(0)
    junet = JaxAudioVisualModel(dim=16)
    jvoc = JaxBigVGAN(JaxVocoderConfig(**VOC))
    x0 = jnp.zeros((1, 2, M, WINDOW))
    cond0 = (jnp.zeros((1, 1, M, WINDOW)), jnp.zeros((1, 512)), x0)
    up = random_params(junet, rng, x0, jnp.zeros((1,), jnp.int32), cond0)
    vp = random_params(jvoc, rng, jnp.zeros((1, M, 16)))
    # a random UNet's output is ~100 and every x0 prediction would sit on the
    # clip at +-1: scale the output projection so predictions are O(1)
    up = jax.tree_util.tree_map_with_path(
        lambda path, p: p * 0.01 if "final_conv" in str(path) else p, up)

    tunet = unet.AudioVisualModel(dim=16).eval()
    tunet.load_state_dict(unet_params_from_flax(to_numpy_tree(up)), strict=True)
    tvoc = bigvgan.BigVGAN(VocoderConfig(**VOC)).eval()
    tvoc.load_state_dict(bigvgan_params_from_flax(to_numpy_tree(vp)),
                         strict=True)

    mono = (rng.standard_normal((1, M, FRAMES)) * 2.0 - 5.0).astype(np.float32)
    feats = rng.standard_normal((4, 512)).astype(np.float32)
    return dict(junet=junet, jvoc=jvoc, up=up, vp=vp, tunet=tunet, tvoc=tvoc,
                mono=mono, feats=feats)


@pytest.fixture(scope="module")
def world():
    return _build_world()


def _jax_group_noise(key, n_groups, shape):
    """Initial noise of every window group as the JAX pipeline draws it:
    fold the group index into the key, split, normal from the first half."""
    out = []
    for i in range(n_groups):
        rng_init, _ = jax.random.split(jax.random.fold_in(key, i))
        out.append(np.asarray(jax.random.normal(rng_init, shape, jnp.float32)))
    return np.stack(out)


def test_pipeline_matches_jax(world):
    w = world
    jpipe = jax_pipeline.BinauralPipeline(
        lambda p, x, tt, c: w["junet"].apply(p, x, tt, c),
        lambda p, mel: w["jvoc"].apply(p, mel),
        FRAMES, num_mels=M, window=WINDOW, unet_batch=GROUP,
        sampling_timesteps=STEPS, fuse_vocoder=False)
    key = jax.random.PRNGKey(13)
    want_wav = np.asarray(jpipe(w["up"], w["vp"], w["mono"], w["feats"], key))
    feats_padded = np.concatenate([w["feats"], w["feats"][-1:].repeat(2, 0)])
    want_mel = np.asarray(jpipe._run_mel(
        w["up"], jnp.asarray(w["mono"]), jnp.asarray(feats_padded), key))

    pipe = BinauralPipeline(w["tunet"], w["tvoc"], FRAMES, num_mels=M,
                            window=WINDOW, unet_batch=GROUP,
                            sampling_timesteps=STEPS, device="cpu")
    assert (pipe.n_windows, pipe.n_batches, pipe.n_slots) == (
        jpipe.n_windows, jpipe.n_batches, jpipe.n_slots) == (4, 2, 6)
    noise = _jax_group_noise(key, 2, (GROUP, 2, M, WINDOW))
    got_mel = pipe.stitched_mel(w["mono"], w["feats"], noise=noise)
    got_wav = pipe(w["mono"], w["feats"], noise=noise)

    assert got_mel.shape == (2, M, FRAMES)
    # float32 both sides; 4 UNet calls deep, mel values span [-12, 2.5]
    np.testing.assert_allclose(got_mel.numpy(), want_mel, rtol=1e-4, atol=1e-4)
    assert got_wav.shape == (2, FRAMES * 8) and got_wav.dtype == torch.float32
    assert np.abs(want_wav).max() > 0.05
    # the vocoder amplifies the mel's 1e-4 through two upsampling stages
    np.testing.assert_allclose(got_wav.numpy(), want_wav, rtol=0, atol=1e-3)


def test_generator_path_is_reproducible_and_seeded(world):
    w = world
    pipe = BinauralPipeline(w["tunet"], w["tvoc"], FRAMES, num_mels=M,
                            window=WINDOW, unet_batch=GROUP,
                            sampling_timesteps=1, device="cpu")
    a = pipe.stitched_mel(w["mono"], w["feats"])
    b = pipe.stitched_mel(w["mono"], w["feats"],
                          generator=torch.Generator().manual_seed(13))
    c = pipe.stitched_mel(w["mono"], w["feats"],
                          generator=torch.Generator().manual_seed(14))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    shared = pipe.stitched_mel(w["mono"], w["feats"][0])
    assert shared.shape == (2, M, FRAMES)


@pytest.mark.parametrize("total,batch", [(200, 3), (861, 8), (80, 8), (50, 2),
                                         (130, 4)])
def test_stitch_is_the_overlap_average(total, batch):
    """_stitch against the plain numpy overlap-average, frames that no
    cropped window covers included (they stay 0)."""
    pipe = BinauralPipeline(None, None, total, num_mels=4, unet_batch=batch,
                            device="cpu")
    rng = np.random.default_rng(total)
    preds = rng.uniform(-1, 1, (pipe.n_slots, 2, 4, 80)).astype(np.float32)
    got = pipe._stitch(t(preds)).numpy()

    den = np.asarray(jax_stage1.denormalize_mel(jnp.asarray(preds)))
    mel = np.zeros((2, 4, total), np.float32)
    count = np.zeros((total,), np.float32)
    starts = jax_stage1.window_starts(total, 80, 40)
    for i, (s, (lo, hi)) in enumerate(
            zip(starts, jax_stage1.crop_spans(starts, total, 80, 8))):
        mel[:, :, s + lo: s + hi] += den[i, :, :, lo:hi]
        count[s + lo: s + hi] += 1
    want = mel / np.clip(count, 1, None)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if total > 80:
        assert (count[:8] == 0).all() and (got[:, :, :8] == 0).all()


def test_make_windows_repeats_the_last_window():
    pipe = BinauralPipeline(None, None, 200, num_mels=4, unet_batch=3,
                            device="cpu")
    mono = np.random.default_rng(1).standard_normal((1, 4, 200)).astype(np.float32) * 8
    wins = pipe._make_windows(t(mono))
    assert wins.shape == (6, 1, 4, 80)
    assert wins.min() >= -1 and wins.max() <= 1
    torch.testing.assert_close(wins[4], wins[3])
    torch.testing.assert_close(wins[5], wins[3])
    torch.testing.assert_close(wins[3], normalize_mel(t(mono)[:, :, 120:200]))


def test_wrong_clip_length_raises():
    pipe = BinauralPipeline(None, None, 200, num_mels=4, device="cpu")
    with pytest.raises(ValueError, match="total_frames=200"):
        pipe(np.zeros((1, 4, 199), np.float32), np.zeros((4, 512), np.float32))


def test_wrong_feature_rows_raises():
    pipe = BinauralPipeline(None, None, 200, num_mels=4, device="cpu")
    with pytest.raises(ValueError, match="n_windows=4"):
        pipe(np.zeros((1, 4, 200), np.float32), np.zeros((5, 512), np.float32))


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="unknown sampler 'heun'"):
        BinauralPipeline(None, None, 200, sampler="heun", device="cpu")
    with pytest.raises(ValueError, match="unknown sampler 'heun'"):
        Stage1Sampler(None, sampler="heun", device="cpu")
    pipe = BinauralPipeline(None, None, 200, sampler="dpm++", device="cpu")
    assert (pipe.sampler, pipe.time_grid) == ("dpm++", None)


@pytest.mark.parametrize("total", [30, 80, 81, 200, 861, 1000])
def test_window_starts_and_crop_spans_equal_jax(total):
    for window, stride, crop in ((80, 40, 8), (16, 8, 2), (80, 40, 45)):
        starts = window_starts(total, window, stride)
        assert starts == jax_stage1.window_starts(total, window, stride)
        assert crop_spans(starts, total, window, crop) == \
            jax_stage1.crop_spans(starts, total, window, crop)


def test_mel_normalisation_equals_jax():
    x = np.linspace(-15, 5, 50, dtype=np.float32)
    np.testing.assert_allclose(
        normalize_mel(t(x)).numpy(),
        np.asarray(jax_stage1.normalize_mel(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        denormalize_mel(t(x)).numpy(),
        np.asarray(jax_stage1.denormalize_mel(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_generate_clip_matches_the_pipeline_stitch(world):
    """The host-side path (Stage1Sampler + generate_clip) stitches the same
    windows to the same mel as the pipeline, given the same noise."""
    w = world
    diffusion = GaussianDiffusion(image_size=WINDOW, sampling_timesteps=2,
                                  device="cpu")
    noise = np.random.default_rng(2).standard_normal(
        (1, 4, 2, M, WINDOW)).astype(np.float32)
    pipe = BinauralPipeline(w["tunet"], w["tvoc"], FRAMES, num_mels=M,
                            unet_batch=4, diffusion=diffusion, device="cpu")
    want = pipe.stitched_mel(w["mono"], w["feats"], noise=noise).numpy()

    class FixedNoise(Stage1Sampler):
        def sample(self, mono_mel, visual_feat, generator=None, noise_=None):
            return super().sample(mono_mel, visual_feat, noise=t(noise[0]))

    sampler = FixedNoise(w["tunet"], diffusion=diffusion, device="cpu")
    got = generate_clip(sampler, w["mono"], w["feats"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_vocoder_wrapper_matches_jax(world):
    w = world
    jv = jax_vocoder.Vocoder(JaxVocoderConfig(**VOC), hop_size=8, pad_multiple=16)
    tv = Vocoder(VocoderConfig(**VOC), hop_size=8, pad_multiple=16,
                 model=w["tvoc"], device="cpu")
    rng = np.random.default_rng(3)
    mel = (rng.standard_normal((2, M, 21)) - 4).astype(np.float32)
    np.testing.assert_allclose(tv(mel), jv(w["vp"], mel), rtol=0, atol=1e-4)
    left, right = mel[0].copy(), mel[1].copy()
    left[:, 3:6] = 0.0
    right[:] = 0.0
    got = tv.vocode_binaural(left, right)
    want = jv.vocode_binaural(w["vp"], left, right)
    assert got.shape == (2, 21 * 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got[0, 24:48] == 0).all() and (got[1] == 0).all()
    np.testing.assert_allclose(
        tv.vocode_binaural(left, right, interpolate_zero_frames=False),
        jv.vocode_binaural(w["vp"], left, right, interpolate_zero_frames=False),
        rtol=0, atol=1e-4)


def test_zero_frame_helpers_equal_jax():
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((4, 10)).astype(np.float32)
    mel[:, [2, 7]] = 0
    got = detect_and_exclude_zero_frames(mel)
    want = jax_vocoder.detect_and_exclude_zero_frames(mel)
    for g, ww in zip(got, want):
        np.testing.assert_array_equal(g, ww)
    audio = rng.standard_normal(8 * 4).astype(np.float32)
    np.testing.assert_array_equal(
        reconstruct_audio_with_silence(audio, got[1], got[2], 4, 40),
        jax_vocoder.reconstruct_audio_with_silence(audio, want[1], want[2], 4, 40))
