"""Port's wav IO and resampling against the JAX package's ``audio_io`` (both
are numpy/scipy, so the results agree to rounding)."""

import numpy as np
import pytest
from scipy.io import wavfile

from diffbinaural_tpu.data import audio_io as jax_audio_io
from diffbinaural_tpu_torch.data import (load_wav, normalize_audio, resample,
                                         save_wav)


def _audio(seed=0, channels=2, n=4000):
    rng = np.random.default_rng(seed)
    return np.clip(0.3 * rng.standard_normal((channels, n)), -1, 1).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_matches_jax(tmp_path, channels):
    audio = _audio(channels=channels)
    if channels == 1:
        audio = audio[0]
    ours, theirs = tmp_path / "a" / "ours.wav", tmp_path / "theirs.wav"
    save_wav(str(ours), audio, 22050)  # makes the directory
    jax_audio_io.save_wav(str(theirs), audio, 22050)
    assert ours.read_bytes() == theirs.read_bytes()
    got, sr = load_wav(str(ours))
    want, sr_want = jax_audio_io.load_wav(str(theirs))
    assert sr == sr_want == 22050
    assert got.shape == audio.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # one int16 step of truncation plus the 32767-out / 32768-in scales
    np.testing.assert_allclose(got, audio, rtol=0, atol=2.0 / 32768)


@pytest.mark.parametrize("dtype,scale", [(np.int32, 2147483648.0),
                                         (np.uint8, None), (np.float32, 1.0)])
def test_load_wav_sample_formats(tmp_path, dtype, scale):
    audio = _audio(seed=1, channels=1)[0]
    if dtype == np.uint8:
        pcm = np.round(audio * 127 + 128).astype(np.uint8)
        want = (pcm.astype(np.float32) - 128.0) / 128.0
    elif dtype == np.float32:
        pcm, want = audio, audio
    else:
        pcm = (audio * 2**30).astype(np.int32)
        want = pcm.astype(np.float32) / scale
    path = tmp_path / "x.wav"
    wavfile.write(str(path), 16000, pcm)
    got, sr = load_wav(str(path))
    assert sr == 16000 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got, jax_audio_io.load_wav(str(path))[0],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("orig,target", [(44100, 22050), (16000, 22050),
                                         (22050, 22050)])
def test_resample_matches_jax(orig, target):
    audio = _audio(seed=2, channels=2, n=3000)
    got = resample(audio, orig, target)
    want = jax_audio_io.resample(audio, orig, target)
    assert got.dtype == np.float32
    assert got.shape == want.shape
    assert abs(got.shape[-1] - round(3000 * target / orig)) <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_load_wav_resamples_to_the_target_rate(tmp_path):
    audio = _audio(seed=3, channels=2, n=4410)
    path = tmp_path / "x.wav"
    save_wav(str(path), audio, 44100)
    got, sr = load_wav(str(path), target_sr=22050)
    want, _ = jax_audio_io.load_wav(str(path), target_sr=22050)
    assert sr == 22050 and got.shape == (2, 2205)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_normalize_audio_matches_jax():
    audio = _audio(seed=4)
    got = normalize_audio(audio)
    np.testing.assert_allclose(got, jax_audio_io.normalize_audio(audio),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.abs(got).max(), 0.95, rtol=1e-6)
    silent = np.zeros((2, 10), np.float64)
    assert normalize_audio(silent).dtype == np.float32
    assert not normalize_audio(silent).any()
