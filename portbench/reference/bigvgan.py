"""Plain float32 PyTorch reference of the BigVGAN generator (v1, AMPBlock1).

A frozen copy of the published architecture as the port lays out its
parameters: a weight-normed 7-tap conv_pre, transposed-conv upsampling
stages, three AMP blocks per stage averaged, each a run of (dilated conv,
unit conv) pairs behind the anti-aliased SnakeBeta activation (2x
kaiser-sinc upsample with replicate padding, x + sin^2(a x) / (b + 1e-9),
2x low-pass downsample; a and b on the log scale), activation_post and a
7-tap conv_post, then tanh or a clamp to [-1, 1].  Every activation is the
unfused composition of depthwise convolutions and every convolution the
library's: no kernel of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def kaiser_sinc_taps(cutoff, half_width, kernel_size):
    """Kaiser-windowed sinc low-pass taps, float32, summing to 1."""
    half = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if kernel_size % 2 == 0:
        time = np.arange(-half, half) + 0.5
    else:
        time = np.arange(kernel_size) - half
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


ACT_TAPS = kaiser_sinc_taps(0.25, 0.3, 12)


def alias_free_snake(x, alpha, beta):
    """x (B, C, T); raw log-scale alpha, beta (C,)."""
    c = x.shape[1]
    a = torch.exp(alpha)[None, :, None]
    inv_b = (1.0 / (torch.exp(beta) + 1e-9))[None, :, None]
    taps = torch.from_numpy(ACT_TAPS).to(x.device).view(1, 1, 12).expand(
        c, 1, 12)
    up = 2 * F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), taps,
                                stride=2, groups=c)
    up = up[..., 15: up.shape[-1] - 15]
    mid = up + inv_b * torch.sin(up * a) ** 2
    mid = F.pad(mid, (5, 6), mode="replicate")
    return F.conv1d(mid, taps, stride=2, groups=c)


def weight_norm(v, g):
    dims = tuple(range(1, v.dim()))
    norm = torch.sqrt((v * v).sum(dim=dims, keepdim=True))
    return v * (g.reshape((-1,) + (1,) * (v.dim() - 1)) / norm.clamp_min(1e-12))


class WNConv1d(nn.Module):
    def __init__(self, c_in, c_out, k, dilation=1, bias=True):
        super().__init__()
        self.k, self.dilation = k, dilation
        self.v = nn.Parameter(torch.empty(c_out, c_in, k))
        self.g = nn.Parameter(torch.ones(c_out))
        self.b = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x):
        return F.conv1d(x, weight_norm(self.v, self.g), self.b,
                        padding=(self.k * self.dilation - self.dilation) // 2,
                        dilation=self.dilation)


class WNConvTranspose1d(nn.Module):
    def __init__(self, c_in, c_out, k, stride):
        super().__init__()
        self.k, self.stride = k, stride
        self.v = nn.Parameter(torch.empty(c_in, c_out, k))
        self.g = nn.Parameter(torch.ones(c_in))
        self.b = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return F.conv_transpose1d(x, weight_norm(self.v, self.g), self.b,
                                  stride=self.stride,
                                  padding=(self.k - self.stride) // 2)


class SnakeBeta(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(c))
        self.beta = nn.Parameter(torch.zeros(c))


class Activation1d(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.act = SnakeBeta(c)

    def forward(self, x):
        return alias_free_snake(x, self.act.alpha, self.act.beta)


class AMPBlock1(nn.Module):
    def __init__(self, c, k, dilations):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            setattr(self, f"act{2 * i}", Activation1d(c))
            setattr(self, f"conv1_{i}", WNConv1d(c, c, k, dilation=d))
            setattr(self, f"act{2 * i + 1}", Activation1d(c))
            setattr(self, f"conv2_{i}", WNConv1d(c, c, k))

    def forward(self, x):
        for i in range(self.n):
            xt = getattr(self, f"conv1_{i}")(getattr(self, f"act{2 * i}")(x))
            xt = getattr(self, f"conv2_{i}")(
                getattr(self, f"act{2 * i + 1}")(xt))
            x = xt + x
        return x


class BigVGAN(nn.Module):
    """mel (B, num_mels, T) -> waveform (B, 1, T * prod(upsample_rates))."""

    def __init__(self, h: dict):
        super().__init__()
        if str(h.get("resblock", "1")) != "1" or h.get(
                "activation", "snakebeta") != "snakebeta" or not h.get(
                "snake_logscale", True):
            raise ValueError("the reference covers AMPBlock1 with log-scale "
                             "SnakeBeta only")
        self.h = h
        self.num_kernels = len(h["resblock_kernel_sizes"])
        c0 = h["upsample_initial_channel"]
        self.conv_pre = WNConv1d(h["num_mels"], c0, 7)
        ch = c0
        for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                       h["upsample_kernel_sizes"])):
            ch = c0 // (2 ** (i + 1))
            setattr(self, f"up_{i}", WNConvTranspose1d(ch * 2, ch, k, u))
            for j, (rk, rd) in enumerate(zip(h["resblock_kernel_sizes"],
                                             h["resblock_dilation_sizes"])):
                setattr(self, f"resblock_{i}_{j}", AMPBlock1(ch, rk, rd))
        self.activation_post = Activation1d(ch)
        self.conv_post = WNConv1d(ch, 1, 7,
                                  bias=h.get("use_bias_at_final", True))

    def forward(self, mel):
        x = self.conv_pre(mel)
        for i in range(len(self.h["upsample_rates"])):
            x = getattr(self, f"up_{i}")(x)
            xs = None
            for j in range(self.num_kernels):
                out = getattr(self, f"resblock_{i}_{j}")(x)
                xs = out if xs is None else xs + out
            x = xs / self.num_kernels
        x = self.conv_post(self.activation_post(x))
        if self.h.get("use_tanh_at_final", True):
            return torch.tanh(x)
        return x.clamp(-1.0, 1.0)
