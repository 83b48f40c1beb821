"""Port's mel frontend (``signal.stft``) against the JAX package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.core.config import AudioConfig as JaxAudioConfig
from diffbinaural_tpu.signal import stft as jax_stft
from diffbinaural_tpu_torch.core.config import AudioConfig
from diffbinaural_tpu_torch.signal import stft

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import t


def _signal(seed=0, channels=2, seconds=1.0, sr=22050):
    """A seeded signal with tones, noise and a silent stretch."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    time = np.arange(n) / sr
    y = (0.4 * np.sin(2 * np.pi * 440.0 * time)[None]
         + 0.2 * np.sin(2 * np.pi * 3000.0 * time)[None]
         + 0.05 * rng.standard_normal((channels, n)))
    y[:, n // 2: n // 2 + 2000] = 0.0
    return y.astype(np.float32)


@pytest.mark.parametrize("args", [(22050, 1024, 80, 0.0, None),
                                  (22050, 1024, 80, 0.0, 8000.0),
                                  (16000, 512, 40, 50.0, None)])
def test_mel_filterbank_matches_jax(args):
    want = jax_stft.mel_filterbank(*args)
    got = stft.mel_filterbank(*args)
    assert got.shape == (args[2], 1 + args[1] // 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("win", [600, 1024])
def test_hann_window_matches_jax_and_torch(win):
    got = stft.hann_window(win)
    np.testing.assert_allclose(got, jax_stft.hann_window(win), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got, torch.hann_window(win, periodic=True).numpy(),
                               rtol=0, atol=1e-6)


def test_mel_spectrogram_matches_jax():
    """1e-4 in the log domain: the two FFTs sum in different orders, and the
    log amplifies relative differences of small magnitudes."""
    y = _signal()
    want = np.asarray(jax_stft.mel_spectrogram(jnp.asarray(y)))
    got = stft.mel_spectrogram(t(y))
    assert got.dtype == torch.float32
    assert got.shape == (2, 80, stft.num_frames(y.shape[-1])) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert want.min() < -9 and want.max() > 0  # silence and tones both there


def test_mel_spectrogram_keeps_leading_axes_and_takes_float64():
    y = _signal(seed=1, channels=3, seconds=0.3)
    flat = stft.mel_spectrogram(t(y))
    shaped = stft.mel_spectrogram(t(y).reshape(3, 1, -1).double())
    assert shaped.shape == (3, 1) + flat.shape[1:] and shaped.dtype == torch.float32
    torch.testing.assert_close(shaped[:, 0], flat, rtol=0, atol=1e-5)
    mono = stft.mel_spectrogram(t(y[0]))
    torch.testing.assert_close(mono, flat[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_fft,hop,win,pad", [(1024, 256, 1024, True),
                                               (1024, 120, 600, True),
                                               (512, 128, 512, False)])
def test_stft_magnitude_matches_jax(n_fft, hop, win, pad):
    """A window shorter than n_fft is centre-padded; pad=False frames the
    signal as it is."""
    y = _signal(seed=2, channels=1, seconds=0.25)
    want = np.asarray(jax_stft.stft_magnitude(jnp.asarray(y), n_fft, hop, win,
                                              pad=pad))
    got = stft.stft_magnitude(t(y), n_fft, hop, win, pad=pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


def test_stft_magnitude_equals_torch_stft():
    y = t(_signal(seed=3, channels=2, seconds=0.25))
    padding = (1024 - 256) // 2
    padded = torch.nn.functional.pad(y[None], (padding, padding),
                                     mode="reflect")[0]
    spec = torch.stft(padded, 1024, hop_length=256, win_length=1024,
                      window=torch.hann_window(1024), center=False,
                      return_complex=True)
    want = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    got = stft.stft_magnitude(y, 1024, 256, 1024)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("n", [22050, 2048, 1000, 20480])
def test_num_frames(n):
    y = torch.zeros(1, n)
    assert stft.mel_spectrogram(y).shape[-1] == stft.num_frames(n)
    assert stft.num_frames(n) == jax_stft.num_frames(n)


def test_dynamic_range_compression_round_trip():
    x = t(np.array([0.0, 1e-6, 1e-5, 0.5, 3.0], np.float32))
    got = stft.dynamic_range_compression(x)
    want = np.asarray(jax_stft.dynamic_range_compression(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    back = stft.dynamic_range_decompression(got)
    np.testing.assert_allclose(back.numpy(), np.clip(x.numpy(), 1e-5, None),
                               rtol=1e-6)


def test_audio_config_equals_jax():
    assert dataclasses.asdict(AudioConfig()) == dataclasses.asdict(JaxAudioConfig())
