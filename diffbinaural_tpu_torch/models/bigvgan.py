"""BigVGAN-style vocoder generator on (B, C, T) — counterpart of
``diffbinaural_tpu/models/bigvgan.py``.

  * 7-tap weight-norm conv_pre 80 -> 1536
  * 6 ConvTranspose1d upsample stages, rates (4,4,2,2,2,2), kernels
    (8,8,4,4,4,4), channels halving each stage
  * per stage, 3 AMPBlock1s (kernels 3/7/11, dilations 1/3/5) averaged;
    AMPBlock2 variant
  * anti-aliased Snake/SnakeBeta activations: 2x kaiser-sinc upsample ->
    snake -> 2x low-pass downsample, through ``ops.fused_alias_free_snake``
    (one kernel on the card) and, for the widest AMP stage, fused into the
    following convolution by ``ops.fused_snake_conv``
  * activation_post + 7-tap conv to 1 channel, tanh or clamp at the end

Time is the contiguous axis inside; the public contract is
(B, num_mels, T) -> (B, 1, T*256).  Convolutions are ``F.conv1d`` /
``F.conv_transpose1d``.  Weight norm is parametrised directly (v, g, b) with
g initialised to ||v||, so the initial kernel equals v.  Sub-modules carry
the flax names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import VocoderConfig
from ..ops.alias_free_act import fused_alias_free_snake
from ..ops.snake_conv import fused_snake_conv, snake_conv_eligible


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """v * g / max(||v||, 1e-12), the norm over all axes but the first."""
    norm = torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True))
    return v * (g[:, None, None] / norm.clamp_min(1e-12))


class WNConv1d(nn.Module):
    """weight_norm(Conv1d) on (B, C, T).  v: (out, in, k); the norm is taken
    over (in, k) per output channel."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 dilation: int = 1, stride: int = 1, use_bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.dilation, self.stride = kernel_size, dilation, stride
        self.dtype = dtype
        self.v = nn.Parameter(torch.empty(features, in_channels, kernel_size))
        self.g = nn.Parameter(torch.ones(features))
        self.b = nn.Parameter(torch.zeros(features)) if use_bias else None

    def kernel(self) -> torch.Tensor:
        return _weight_norm(self.v, self.g)

    def forward(self, x: torch.Tensor, snake=None) -> torch.Tensor:
        """snake=(raw_alpha, raw_beta, logscale): fuse the anti-aliased
        snake activation INTO this convolution via ``ops.fused_snake_conv``
        (the caller passes the raw per-channel parameters of the preceding
        Activation1d instead of applying it)."""
        kernel = self.kernel().to(self.dtype)
        if snake is not None:
            alpha, beta, logscale = snake
            bias = self.b if self.b is not None else torch.zeros(
                kernel.shape[0], device=kernel.device)
            return fused_snake_conv(
                x.to(self.dtype).contiguous(), alpha, beta, kernel, bias,
                dilation=self.dilation, logscale=logscale,
            )
        bias = None if self.b is None else self.b.to(self.dtype)
        return F.conv1d(
            x.to(self.dtype), kernel, bias, stride=self.stride,
            padding=get_padding(self.kernel_size, self.dilation),
            dilation=self.dilation,
        )


class WNConvTranspose1d(nn.Module):
    """weight_norm(ConvTranspose1d(k, stride=u, padding=(k-u)//2)) on
    (B, C, T) -> (B, C', T*u).  v: (in, out, k); the norm is taken over
    (out, k) per INPUT channel."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int, dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.stride, self.dtype = kernel_size, stride, dtype
        self.v = nn.Parameter(torch.empty(in_channels, features, kernel_size))
        self.g = nn.Parameter(torch.ones(in_channels))
        self.b = nn.Parameter(torch.zeros(features))

    def kernel(self) -> torch.Tensor:
        return _weight_norm(self.v, self.g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(
            x.to(self.dtype), self.kernel().to(self.dtype),
            self.b.to(self.dtype), stride=self.stride,
            padding=(self.kernel_size - self.stride) // 2,
        )


# ---------------------------------------------------------------------------
# snake activations
# ---------------------------------------------------------------------------


def snake(x, alpha, beta, eps: float = 1e-9):
    """x + 1/beta * sin^2(alpha x), per-channel alpha/beta on axis 1."""
    a, b = alpha[None, :, None], beta[None, :, None]
    return x + (1.0 / (b + eps)) * torch.sin(x * a) ** 2


class Snake(nn.Module):
    """alpha-only snake: beta == alpha.  ``raw()`` returns the raw
    (alpha, beta) pair for the fused ops, which apply the log-scale
    themselves."""

    def __init__(self, channels: int, alpha_logscale: bool = False):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        init = torch.zeros if alpha_logscale else torch.ones
        self.alpha = nn.Parameter(init(channels))

    def raw(self):
        return self.alpha, self.alpha

    def forward(self, x):
        alpha, beta = self.raw()
        if self.alpha_logscale:
            alpha, beta = torch.exp(alpha), torch.exp(beta)
        return snake(x, alpha, beta)


class SnakeBeta(Snake):
    """separate alpha (frequency) and beta (magnitude)."""

    def __init__(self, channels: int, alpha_logscale: bool = False):
        super().__init__(channels, alpha_logscale)
        init = torch.zeros if alpha_logscale else torch.ones
        self.beta = nn.Parameter(init(channels))

    def raw(self):
        return self.alpha, self.beta


class Activation1d(nn.Module):
    """2x up-FIR -> snake -> 2x down-FIR (12-tap kaiser-sinc resamplers) as
    ``ops.fused_alias_free_snake``: one kernel on the card, its plain
    version for a tensor on the CPU."""

    def __init__(self, channels: int, activation: str = "snakebeta",
                 alpha_logscale: bool = True):
        super().__init__()
        act_cls = SnakeBeta if activation == "snakebeta" else Snake
        self.act = act_cls(channels, alpha_logscale)
        self.alpha_logscale = alpha_logscale

    def raw(self):
        """(raw_alpha, raw_beta, logscale) for the fused snake->conv path."""
        return self.act.raw() + (self.alpha_logscale,)

    def forward(self, x):
        alpha, beta = self.act.raw()
        return fused_alias_free_snake(x.contiguous(), alpha, beta,
                                      self.alpha_logscale)


# ---------------------------------------------------------------------------
# AMP blocks
# ---------------------------------------------------------------------------


def _snake_conv_fusable(channels: int, kernel_size: int) -> bool:
    """Gate for the fused snake->conv kernel: the widest AMP stage
    (channels >= 768) with at most 7 taps, on an eligible shape.  The gate
    is the JAX package's; whether the fused kernel or the activation kernel
    followed by a library convolution wins on this card is still to be
    decided from measurements."""
    return (
        channels >= 768
        and kernel_size <= 7
        and snake_conv_eligible(channels, channels, kernel_size)
    )


class AMPBlock1(nn.Module):
    """Pairs of (dilated conv, unit conv) with anti-aliased snake between."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5),
                 activation: str = "snakebeta", alpha_logscale: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.n = len(dilation)
        self.fuse = _snake_conv_fusable(channels, kernel_size)
        for i, d in enumerate(dilation):
            setattr(self, f"act{2 * i}",
                    Activation1d(channels, activation, alpha_logscale))
            setattr(self, f"conv1_{i}",
                    WNConv1d(channels, channels, kernel_size, dilation=d,
                             dtype=dtype))
            setattr(self, f"act{2 * i + 1}",
                    Activation1d(channels, activation, alpha_logscale))
            setattr(self, f"conv2_{i}",
                    WNConv1d(channels, channels, kernel_size, dilation=1,
                             dtype=dtype))

    def forward(self, x):
        for i in range(self.n):
            act_a, conv_a = getattr(self, f"act{2 * i}"), getattr(self, f"conv1_{i}")
            act_b, conv_b = getattr(self, f"act{2 * i + 1}"), getattr(self, f"conv2_{i}")
            if self.fuse:
                xt = conv_b(conv_a(x, snake=act_a.raw()), snake=act_b.raw())
            else:
                xt = conv_b(act_b(conv_a(act_a(x))))
            x = xt + x
        return x


class AMPBlock2(nn.Module):
    """Single conv per dilation."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5),
                 activation: str = "snakebeta", alpha_logscale: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.n = len(dilation)
        self.fuse = _snake_conv_fusable(channels, kernel_size)
        for i, d in enumerate(dilation):
            setattr(self, f"act{i}",
                    Activation1d(channels, activation, alpha_logscale))
            setattr(self, f"conv_{i}",
                    WNConv1d(channels, channels, kernel_size, dilation=d,
                             dtype=dtype))

    def forward(self, x):
        for i in range(self.n):
            act, conv = getattr(self, f"act{i}"), getattr(self, f"conv_{i}")
            xt = conv(x, snake=act.raw()) if self.fuse else conv(act(x))
            x = xt + x
        return x


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


@torch.no_grad()
def remove_weight_norm(module: nn.Module) -> nn.Module:
    """Fold every (v, g) pair in place so that the direction IS the
    effective kernel (v <- v*g/||v||, g <- ||v||, after which the in-module
    normalisation is the identity).  Numerically a no-op; returns the
    module."""
    for m in module.modules():
        if isinstance(m, (WNConv1d, WNConvTranspose1d)):
            m.v.copy_(m.kernel())
            m.g.copy_(m.g.abs())
    return module


class BigVGAN(nn.Module):
    """mel (B, num_mels, T) -> waveform (B, 1, T * prod(rates)), float32."""

    def __init__(self, config: VocoderConfig = VocoderConfig(),
                 dtype=torch.float32):
        super().__init__()
        h = self.config = config
        self.dtype = dtype
        self.num_kernels = len(h.resblock_kernel_sizes)
        block_cls = AMPBlock1 if h.resblock == "1" else AMPBlock2
        c0 = h.upsample_initial_channel

        self.conv_pre = WNConv1d(h.num_mels, c0, 7, dtype=dtype)
        ch = c0
        for i, (u, k) in enumerate(zip(h.upsample_rates,
                                       h.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            setattr(self, f"up_{i}",
                    WNConvTranspose1d(ch * 2, ch, k, u, dtype=dtype))
            for j, (rk, rd) in enumerate(zip(h.resblock_kernel_sizes,
                                             h.resblock_dilation_sizes)):
                setattr(self, f"resblock_{i}_{j}",
                        block_cls(ch, rk, rd, activation=h.activation,
                                  alpha_logscale=h.snake_logscale,
                                  dtype=dtype))
        self.activation_post = Activation1d(ch, h.activation, h.snake_logscale)
        self.conv_post = WNConv1d(ch, 1, 7, use_bias=h.use_bias_at_final,
                                  dtype=dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = self.config
        x = self.conv_pre(mel)
        for i in range(len(h.upsample_rates)):
            x = getattr(self, f"up_{i}")(x)
            xs = None
            for j in range(self.num_kernels):
                out = getattr(self, f"resblock_{i}_{j}")(x)
                xs = out if xs is None else xs + out
            x = xs / self.num_kernels
        x = self.conv_post(self.activation_post(x)).float()
        return torch.tanh(x) if h.use_tanh_at_final else x.clamp(-1.0, 1.0)


class BinauralBigVGAN(nn.Module):
    """A shared mono generator applied to each channel:
    (mel_left (B, 80, T), mel_right (B, 80, T)) -> (B, 2, T*256)."""

    def __init__(self, config: VocoderConfig = VocoderConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.generator = BigVGAN(config, dtype=dtype)

    def forward(self, mel_left, mel_right):
        b = mel_left.shape[0]
        # both channels through ONE generator call, as a doubled batch
        y = self.generator(torch.cat([mel_left, mel_right], dim=0))
        return torch.cat([y[:b], y[b:]], dim=1)
