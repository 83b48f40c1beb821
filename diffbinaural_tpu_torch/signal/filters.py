"""Kaiser-windowed-sinc FIR design + anti-aliased 1-D resampling on
(B, C, T) tensors.

Counterpart of ``diffbinaural_tpu/signal/filters.py``: same taps (designed
once in numpy float64), same replicate padding and transposed-conv crop
arithmetic, expressed as depthwise ``F.conv1d`` / ``F.conv_transpose1d``.
The filters always run in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """Windowed-sinc low-pass taps, shape (kernel_size,), sum == 1 (Kaiser
    beta from the standard attenuation estimate; even kernels sample time
    at half-integer offsets)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2

    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)

    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size

    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def _depthwise(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(C, 1, k) view of shared taps for a depthwise conv over x (B, C, T)."""
    return taps.to(device=x.device, dtype=x.dtype).view(1, 1, -1).expand(
        x.shape[1], 1, -1
    )


class LowPassFilter1d:
    """Strided anti-aliasing FIR with replicate padding."""

    def __init__(self, cutoff=0.5, half_width=0.6, stride: int = 1,
                 padding: bool = True, kernel_size: int = 12):
        if cutoff < 0.0:
            raise ValueError("Minimum cutoff must be larger than zero.")
        if cutoff > 0.5:
            raise ValueError("A cutoff above 0.5 does not make sense.")
        self.kernel_size = kernel_size
        self.even = kernel_size % 2 == 0
        self.pad_left = kernel_size // 2 - int(self.even)
        self.pad_right = kernel_size // 2
        self.stride = stride
        self.padding = padding
        self.taps = torch.from_numpy(
            kaiser_sinc_filter1d(cutoff, half_width, kernel_size)
        )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding:
            x = F.pad(x, (self.pad_left, self.pad_right), mode="replicate")
        return F.conv1d(x, _depthwise(x, self.taps), stride=self.stride,
                        groups=x.shape[1])


class UpSample1d:
    """ratio x anti-aliased upsampling: replicate pad, depthwise transposed
    conv with the low-pass taps (x ratio gain), crop."""

    def __init__(self, ratio: int = 2, kernel_size: int | None = None):
        self.ratio = ratio
        self.kernel_size = (
            int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        )
        self.stride = ratio
        self.pad = self.kernel_size // ratio - 1
        self.pad_left = (
            self.pad * self.stride + (self.kernel_size - self.stride) // 2
        )
        self.pad_right = (
            self.pad * self.stride + (self.kernel_size - self.stride + 1) // 2
        )
        self.taps = torch.from_numpy(kaiser_sinc_filter1d(
            cutoff=0.5 / ratio, half_width=0.6 / ratio,
            kernel_size=self.kernel_size,
        ))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (self.pad, self.pad), mode="replicate")
        y = self.ratio * F.conv_transpose1d(
            x, _depthwise(x, self.taps), stride=self.stride, groups=x.shape[1]
        )
        return y[..., self.pad_left: y.shape[-1] - self.pad_right]


class DownSample1d:
    """ratio x anti-aliased downsampling (strided low-pass)."""

    def __init__(self, ratio: int = 2, kernel_size: int | None = None):
        self.ratio = ratio
        self.kernel_size = (
            int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        )
        self.lowpass = LowPassFilter1d(
            cutoff=0.5 / ratio,
            half_width=0.6 / ratio,
            stride=ratio,
            kernel_size=self.kernel_size,
        )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.lowpass(x)
