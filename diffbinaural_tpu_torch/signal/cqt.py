"""Constant-Q transform — counterpart of ``diffbinaural_tpu/signal/cqt.py``
(the CQT of the CQT discriminator, in nnAudio's ``CQT2010v2`` layout).

Complex Hann-windowed kernels are designed once, in numpy, for the TOP
octave only; each lower octave low-passes and decimates the signal by 2
(24-tap kaiser-sinc) and reuses the same kernels at half the hop, so every
octave gives the same number of frames and is one (frames x L) . (L x bpo)
product per part (real, imaginary).  Octave 0 is the top octave; the
result is stacked in ascending frequency.  Kernels are l1-normalised.

Everything is float32 at full precision: the decimation and the kernel
products are matrix products (``torch.matmul`` keeps float32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set; the stage-2 step keeps it
off), as the JAX code pins ``Precision.HIGHEST``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .filters import kaiser_sinc_filter1d

C1_HZ = 32.70319566257483  # nnAudio's default fmin


@lru_cache(maxsize=16)
def cqt_kernels(sr: float, bins_per_octave: int, n_octaves: int,
                fmin: float = C1_HZ, filter_scale: float = 1.0):
    """Top-octave kernel bank -> (real (L, bpo), imag (L, bpo), L), float32
    numpy; each kernel centred in the L-sample bank.  Cached: do not write
    to the arrays."""
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    top_start = fmin * 2.0 ** (n_octaves - 1)
    freqs = top_start * 2.0 ** (np.arange(bins_per_octave) / bins_per_octave)
    lengths = np.ceil(q * sr / freqs).astype(int)
    L = int(lengths.max())

    real = np.zeros((L, bins_per_octave), dtype=np.float32)
    imag = np.zeros((L, bins_per_octave), dtype=np.float32)
    for j, (f, n_taps) in enumerate(zip(freqs, lengths)):
        n = np.arange(n_taps, dtype=np.float64)
        win = (0.5 * (1.0 - np.cos(2.0 * math.pi * n / (n_taps - 1)))
               if n_taps > 1 else np.ones(1))
        phase = 2.0 * math.pi * f / sr * (n - (n_taps - 1) / 2.0)
        k = win * np.exp(1j * phase)
        k /= np.abs(k).sum()  # l1 norm
        start = (L - n_taps) // 2
        real[start: start + n_taps, j] = k.real.astype(np.float32)
        imag[start: start + n_taps, j] = k.imag.astype(np.float32)
    return real, imag, L


def _frame_const_pad(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Centred framing with zero padding (nnAudio ``pad_mode='constant'``).
    x: (B, T) -> (B, T // hop + 1, frame_len).  A frame that runs past the
    padded signal reads zeros there (the JAX gather clamps its index onto
    the last pad sample, which is zero)."""
    if frame_len < 2:
        raise ValueError("_frame_const_pad: frame_len must be >= 2")
    t = x.shape[-1]
    half = frame_len // 2
    n_frames = t // hop + 1
    right = max(half, hop * (n_frames - 1) + frame_len - t - half)
    x = F.pad(x, (half, right))
    return x.unfold(-1, frame_len, hop)[:, :n_frames]


@lru_cache(maxsize=1)
def _decimation_taps() -> np.ndarray:
    return kaiser_sinc_filter1d(0.25, 0.3, 24)


def _decimate2(x: torch.Tensor) -> torch.Tensor:
    """Anti-aliased /2 along the last axis of (B, T): zero pad (11, 12),
    24-tap kaiser-sinc low-pass, stride 2."""
    taps = torch.from_numpy(_decimation_taps()).to(x.device)
    k = taps.shape[0]
    x = F.pad(x, (k // 2 - 1, k // 2))
    return torch.matmul(x.unfold(-1, k, 2), taps)


def cqt(x: torch.Tensor, sr: float, hop_length: int, n_octaves: int,
        bins_per_octave: int, fmin: float = C1_HZ) -> torch.Tensor:
    """x: (B, T) -> (B, n_octaves * bins_per_octave, n_frames, 2), float32,
    bins ascending in frequency, last axis (real, imag) — nnAudio's
    'Complex' output layout."""
    if not (hop_length % (2 ** (n_octaves - 1)) == 0
            or hop_length >= 2 ** (n_octaves - 1)):
        raise ValueError("cqt: hop must divide by 2^(n_octaves-1)")
    real, imag, L = cqt_kernels(sr, bins_per_octave, n_octaves, fmin)
    kernels = torch.from_numpy(np.concatenate([real, imag], axis=1)).to(x.device)

    octaves = []
    sig = x.float()
    hop = hop_length
    for k in range(n_octaves):
        if k > 0:
            sig = _decimate2(sig)
            hop = max(hop // 2, 1)
        frames = _frame_const_pad(sig, L, hop)           # (B, n_frames, L)
        prod = torch.matmul(frames, kernels)             # (B, n_frames, 2 bpo)
        re, im = prod.split(bins_per_octave, dim=-1)
        octaves.append(torch.stack([re, im], dim=-1).transpose(1, 2))

    n_frames = min(o.shape[2] for o in octaves)
    return torch.cat([o[:, :, :n_frames] for o in reversed(octaves)], dim=1)
