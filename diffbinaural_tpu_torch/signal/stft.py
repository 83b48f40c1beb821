"""STFT + slaney mel frontend — counterpart of the mel half of
``diffbinaural_tpu/signal/stft.py``: slaney-norm mel filterbank (the librosa
default), periodic Hann window, reflect pad of (n_fft - hop) / 2, a
``center=False`` STFT, magnitude sqrt(re^2 + im^2 + 1e-9), then
ln(clamp(x, 1e-5)).  Always float32.

Also ``stft_complex``, the centered complex STFT of the discriminators and
the multi-scale mel loss (``torch.stft(center=True)`` semantics).

The filterbank and the window are computed in numpy float64 and cached; the
framing is a strided view (``Tensor.unfold``), the transform
``torch.fft.rfft`` and the mel projection one matmul, on whatever device the
signal lies on.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    return np.where(
        f >= _MIN_LOG_HZ,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        f / _F_SP,
    )


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(
        m >= _MIN_LOG_MEL,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
        _F_SP * m,
    )


@functools.lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_mels, 1 + n_fft // 2)
    float32 — numerically librosa.filters.mel(htk=False, norm='slaney').
    The array is cached: do not write to it."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins, dtype=np.float64)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]  # (n_mels + 2, n_bins)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])  # slaney area norm
    return (weights * enorm[:, None]).astype(np.float32)


def hann_window(win_size: int) -> np.ndarray:
    """Periodic Hann window — torch.hann_window(win, periodic=True)."""
    n = np.arange(win_size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * math.pi * n / win_size))).astype(np.float32)


def _frame(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), a strided view."""
    return y.unfold(-1, frame_length, hop)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int,
                   *, pad: bool = True, eps: float = 1e-9) -> torch.Tensor:
    """|STFT|.  y: (..., T) -> (..., 1 + n_fft // 2, frames), float32.

    ``pad=True`` applies the reflect pad of (n_fft - hop) / 2 on both ends
    and then a ``center=False`` STFT.  A window shorter than n_fft is
    centre-padded with zeros to n_fft (``torch.stft``'s rule)."""
    win_np = hann_window(win_size)
    if win_size < n_fft:
        lpad = (n_fft - win_size) // 2
        win_np = np.pad(win_np, (lpad, n_fft - win_size - lpad))
    window = torch.from_numpy(win_np).to(y.device)
    y = y.float()
    if pad:
        padding = (n_fft - hop_size) // 2
        y = _pad_last(y, padding, padding, "reflect")
    frames = _frame(y, n_fft, hop_size) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps)
    return mag.transpose(-1, -2)


def _pad_last(y: torch.Tensor, left: int, right: int, mode: str):
    """Pad the last axis of (..., T); ``F.pad``'s reflect and replicate
    modes want a (batch, channel, T) input."""
    lead = y.shape[:-1]
    return F.pad(y.reshape(1, -1, y.shape[-1]), (left, right),
                 mode=mode).reshape(*lead, -1)


def stft_complex(y: torch.Tensor, n_fft: int, hop_size: int,
                 win_size: Optional[int] = None, *, center: bool = True,
                 window: Optional[np.ndarray] = None) -> torch.Tensor:
    """Complex STFT.  y: (..., T) -> complex64 (..., 1 + n_fft // 2,
    n_frames), n_frames = 1 + T // hop when ``center`` (a reflect pad of
    n_fft // 2 on each side).  The window (periodic Hann of ``win_size``
    unless one is given) must have n_fft samples."""
    if win_size is None:
        win_size = n_fft
    win = window if window is not None else hann_window(win_size)
    win = torch.from_numpy(np.asarray(win, dtype=np.float32)).to(y.device)
    y = y.float()
    if center:
        y = _pad_last(y, n_fft // 2, n_fft // 2, "reflect")
    frames = _frame(y, n_fft, hop_size) * win
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def dynamic_range_compression(x, C: float = 1.0, clip_val: float = 1e-5):
    """ln-compress."""
    return torch.log(x.clamp(min=clip_val) * C)


def dynamic_range_decompression(x, C: float = 1.0):
    return torch.exp(x) / C


def mel_spectrogram(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 22050, hop_size: int = 256,
                    win_size: int = 1024, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """ln-mel spectrogram, (..., T) audio -> (..., num_mels, frames),
    float32, on y's device."""
    mag = stft_magnitude(y, n_fft, hop_size, win_size)
    basis = torch.from_numpy(
        mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
    ).to(mag.device)
    return dynamic_range_compression(torch.matmul(basis, mag))


def num_frames(n_samples: int, n_fft: int = 1024, hop_size: int = 256) -> int:
    """Frame count ``mel_spectrogram`` gives for ``n_samples`` samples."""
    padding = (n_fft - hop_size) // 2
    return 1 + (n_samples + 2 * padding - n_fft) // hop_size
