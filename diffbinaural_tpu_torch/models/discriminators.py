"""GAN discriminators for stage-2 vocoder training — counterpart of
``diffbinaural_tpu/models/discriminators.py``:

  * ``DiscriminatorP`` / ``MultiPeriodDiscriminator``
  * ``DiscriminatorR`` / ``MultiResolutionDiscriminator`` (STFT magnitude)
  * ``DiscriminatorB`` / ``MultiBandDiscriminator`` (band-split complex STFT)
  * ``DiscriminatorCQT`` / ``MultiScaleSubbandCQTDiscriminator`` (x2
    kaiser-sinc upsample, then the octave-stacked CQT of ``signal.cqt``)
  * ``CombinedDiscriminator``

Every multi-discriminator keeps the reference contract
``disc(y, y_hat) -> (real_logits, fake_logits, real_fmaps, fake_fmaps)``;
``single(x) -> (logits, fmaps)`` runs every sub-discriminator on one input
(the train step runs the real branch of the G phase without a gradient).

Audio enters as (B, 1, T).  The 2-D stacks run NCHW here where the JAX code
runs NHWC: H is the time (or period-frame) axis and W the period or
frequency axis in both, so logits flatten in the same order and every
feature map is the JAX one with its channel axis moved.  ``dtype`` is the
convolutions' compute type; the spectral frontends run in float32.  On a
card PyTorch's cuDNN convolutions use TF32 unless
``torch.backends.cudnn.allow_tf32`` is off; the stage-2 step turns it off
while it runs.  Sub-modules carry the flax names.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..signal.cqt import cqt
from ..signal.filters import UpSample1d
from ..signal.stft import stft_complex, stft_magnitude


def leaky_relu(x, slope: float = 0.1):
    return torch.where(x >= 0, x, slope * x)


class WNConv2d(nn.Module):
    """weight_norm(Conv2d) on NCHW with torch-style explicit padding.
    v: (out, in, kh, kw); the norm is taken over (in, kh, kw) per output
    channel.  ``use_weight_norm=False`` keeps only v and b."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int], strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), use_weight_norm: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.strides, self.padding = tuple(strides), tuple(padding)
        self.dilation, self.dtype = tuple(dilation), dtype
        self.v = nn.Parameter(torch.empty(features, in_channels, *kernel_size))
        self.g = nn.Parameter(torch.ones(features)) if use_weight_norm else None
        self.b = nn.Parameter(torch.zeros(features))

    def kernel(self) -> torch.Tensor:
        if self.g is None:
            return self.v
        norm = torch.sqrt((self.v * self.v).sum(dim=(1, 2, 3), keepdim=True))
        return self.v * (self.g[:, None, None, None] / norm.clamp_min(1e-12))

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.kernel().to(self.dtype),
                        self.b.to(self.dtype), stride=self.strides,
                        padding=self.padding, dilation=self.dilation)


class _MultiDiscriminator(nn.Module):
    """Sub-discriminators registered in order; each maps (B, 1, T) to
    (logits (B, N), feature maps)."""

    def subs(self):
        return list(self.children())

    def single(self, x):
        logits, fmaps = [], []
        for d in self.subs():
            logit, fmap = d(x)
            logits.append(logit)
            fmaps.append(fmap)
        return logits, fmaps

    def forward(self, y, y_hat):
        y_d_rs, fmap_rs = self.single(y)
        y_d_gs, fmap_gs = self.single(y_hat)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


# ---------------------------------------------------------------------------
# multi-period
# ---------------------------------------------------------------------------


class DiscriminatorP(nn.Module):
    """Period-reshaped 2-D conv stack: (B, 1, T) is reflect-padded to a
    multiple of the period and read as (B, 1, T / p, p)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channel_mult: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.period = period
        widths = [int(w * channel_mult) for w in (32, 128, 512, 1024)]
        c_in = 1
        for i, w in enumerate(widths):
            setattr(self, f"conv_{i}", WNConv2d(
                c_in, w, (kernel_size, 1), strides=(stride, 1), padding=(2, 0),
                dtype=dtype))
            c_in = w
        top = int(1024 * channel_mult)
        self.conv_4 = WNConv2d(c_in, top, (kernel_size, 1), padding=(2, 0),
                               dtype=dtype)
        self.conv_post = WNConv2d(top, 1, (3, 1), padding=(1, 0), dtype=dtype)

    def forward(self, x):
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
            t = x.shape[-1]
        x = x.reshape(b, c, t // self.period, self.period)
        fmap = []
        for i in range(5):
            x = leaky_relu(getattr(self, f"conv_{i}")(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiPeriodDiscriminator(_MultiDiscriminator):
    """Periods from the config's ``mpd_reshapes`` (2, 3, 5, 7, 11)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channel_mult: float = 1.0, dtype=torch.float32):
        super().__init__()
        for p in periods:
            setattr(self, f"disc_{p}", DiscriminatorP(
                p, channel_mult=channel_mult, dtype=dtype))


# ---------------------------------------------------------------------------
# multi-resolution (STFT magnitude)
# ---------------------------------------------------------------------------


class DiscriminatorR(nn.Module):
    """STFT-magnitude 2-D convs; resolution = (n_fft, hop, win), the
    reference's framing (reflect pad (n_fft - hop) / 2, no centring)."""

    def __init__(self, resolution: Tuple[int, int, int],
                 channel_mult: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.resolution = tuple(resolution)
        w = int(32 * channel_mult)
        c_in = 1
        for i, s in enumerate(((1, 1), (1, 2), (1, 2), (1, 2))):
            setattr(self, f"conv_{i}", WNConv2d(
                c_in, w, (3, 9), strides=s, padding=(1, 4), dtype=dtype))
            c_in = w
        self.conv_4 = WNConv2d(w, w, (3, 3), padding=(1, 1), dtype=dtype)
        self.conv_post = WNConv2d(w, 1, (3, 3), padding=(1, 1), dtype=dtype)

    def forward(self, x):
        n_fft, hop, win = self.resolution
        b = x.shape[0]
        x = stft_magnitude(x[:, 0, :], n_fft, hop, win, pad=True,
                           eps=1e-9)[:, None]             # (B, 1, F, frames)
        fmap = []
        for i in range(5):
            x = leaky_relu(getattr(self, f"conv_{i}")(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiResolutionDiscriminator(_MultiDiscriminator):
    def __init__(self, resolutions=((1024, 120, 600), (2048, 240, 1200),
                                    (512, 50, 240)),
                 channel_mult: float = 1.0, dtype=torch.float32):
        super().__init__()
        for i, res in enumerate(resolutions):
            setattr(self, f"disc_{i}", DiscriminatorR(
                tuple(res), channel_mult=channel_mult, dtype=dtype))


# ---------------------------------------------------------------------------
# multi-band (complex STFT, band-split)
# ---------------------------------------------------------------------------


class DiscriminatorB(nn.Module):
    """Band-split complex-STFT convs: DC removal and peak normalisation,
    centred STFT with hop = window / 4, (re, im) as two channels over
    (time, frequency), one conv stack per band, joined over frequency."""

    BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))

    def __init__(self, window_length: int, channels: int = 32,
                 hop_factor: float = 0.25, bands=BANDS, dtype=torch.float32):
        super().__init__()
        self.window_length = window_length
        self.hop = int(window_length * hop_factor)
        n_bins = window_length // 2 + 1
        self.band_idx = [(int(lo * n_bins), int(hi * n_bins)) for lo, hi in bands]
        specs = [((1, 1), (3, 9), (1, 4)), ((1, 2), (3, 9), (1, 4)),
                 ((1, 2), (3, 9), (1, 4)), ((1, 2), (3, 9), (1, 4)),
                 ((1, 1), (3, 3), (1, 1))]
        for bi in range(len(bands)):
            c_in = 2
            for i, (s, k, p) in enumerate(specs):
                setattr(self, f"band{bi}_conv{i}", WNConv2d(
                    c_in, channels, k, strides=s, padding=p, dtype=dtype))
                c_in = channels
        self.conv_post = WNConv2d(channels, 1, (3, 3), padding=(1, 1),
                                  dtype=dtype)

    def forward(self, x):
        b = x.shape[0]
        wav = x[:, 0, :].float()
        wav = wav - wav.mean(dim=-1, keepdim=True)
        wav = 0.8 * wav / (wav.abs().amax(dim=-1, keepdim=True) + 1e-9)
        spec = stft_complex(wav, self.window_length, self.hop)  # (B, F, T)
        z = torch.stack([spec.real, spec.imag], dim=1).transpose(2, 3)
        fmap, outs = [], []
        for bi, (lo, hi) in enumerate(self.band_idx):
            band = z[..., lo:hi]
            for i in range(5):
                band = leaky_relu(getattr(self, f"band{bi}_conv{i}")(band))
                if i > 0:
                    fmap.append(band)
            outs.append(band)
        x = self.conv_post(torch.cat(outs, dim=3))
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiBandDiscriminator(_MultiDiscriminator):
    def __init__(self, fft_sizes: Sequence[int] = (2048, 1024, 512),
                 dtype=torch.float32):
        super().__init__()
        for w in fft_sizes:
            setattr(self, f"disc_{w}", DiscriminatorB(w, dtype=dtype))


# ---------------------------------------------------------------------------
# CQT
# ---------------------------------------------------------------------------


class DiscriminatorCQT(nn.Module):
    """Complex-CQT conv stack: x2 resample (12-tap-per-phase kaiser-sinc,
    replicate pad), CQT at twice the sampling rate, per-octave plain
    pre-convs, then dilated weight-normed convs over (time, bins)."""

    def __init__(self, sampling_rate: int, hop_length: int, n_octaves: int,
                 bins_per_octave: int, filters: int = 128,
                 max_filters: int = 1024, filters_scale: int = 1,
                 dilations: Sequence[int] = (1, 2, 4), in_channels: int = 1,
                 out_channels: int = 1, normalize_volume: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.sampling_rate, self.hop_length = sampling_rate, hop_length
        self.n_octaves, self.bins_per_octave = n_octaves, bins_per_octave
        self.normalize_volume = normalize_volume
        self.resample = UpSample1d(2, kernel_size=24)
        kh, kw = 3, 9
        c2 = in_channels * 2
        for i in range(n_octaves):
            setattr(self, f"conv_pre_{i}", WNConv2d(
                c2, c2, (kh, kw), padding=(1, 4), use_weight_norm=False,
                dtype=dtype))
        self.conv_0 = WNConv2d(c2, filters, (kh, kw), padding=(1, 4),
                               use_weight_norm=False, dtype=dtype)
        c_in = filters
        for i, dil in enumerate(dilations):
            out = min(filters_scale ** (i + 1) * filters, max_filters)
            setattr(self, f"conv_{i + 1}", WNConv2d(
                c_in, out, (kh, kw), strides=(1, 2), dilation=(dil, 1),
                padding=(((kh - 1) * dil) // 2, (kw - 1) // 2), dtype=dtype))
            c_in = out
        self.n_dilated = len(dilations)
        out = min(filters_scale ** (len(dilations) + 1) * filters, max_filters)
        self.conv_final = WNConv2d(c_in, out, (kh, kh), padding=(1, 1),
                                   dtype=dtype)
        self.conv_post = WNConv2d(out, out_channels, (kh, kh), padding=(1, 1),
                                  dtype=dtype)

    def forward(self, x):
        b = x.shape[0]
        wav = x[:, 0, :].float()
        if self.normalize_volume:
            wav = wav - wav.mean(dim=-1, keepdim=True)
            wav = 0.8 * wav / (wav.abs().amax(dim=-1, keepdim=True) + 1e-9)
        up = self.resample(wav[:, None, :])[:, 0, :]
        z = cqt(up, self.sampling_rate * 2, self.hop_length, self.n_octaves,
                self.bins_per_octave)                    # (B, bins, T, 2)
        z = z.permute(0, 3, 2, 1)                        # (B, 2, T, bins)
        bpo = self.bins_per_octave
        latent = torch.cat([
            getattr(self, f"conv_pre_{i}")(z[..., i * bpo:(i + 1) * bpo])
            for i in range(self.n_octaves)], dim=3)
        fmap = []
        latent = leaky_relu(self.conv_0(latent))
        fmap.append(latent)
        for i in range(self.n_dilated):
            latent = leaky_relu(getattr(self, f"conv_{i + 1}")(latent))
            fmap.append(latent)
        latent = leaky_relu(self.conv_final(latent))
        fmap.append(latent)
        latent = self.conv_post(latent)
        return latent.reshape(b, -1), fmap


class MultiScaleSubbandCQTDiscriminator(_MultiDiscriminator):
    """hops (512, 256, 256), 9 octaves, (24, 36, 48) bins per octave (the
    production config's CQTD)."""

    def __init__(self, sampling_rate: int = 22050,
                 hop_lengths: Sequence[int] = (512, 256, 256),
                 n_octaves: Sequence[int] = (9, 9, 9),
                 bins_per_octaves: Sequence[int] = (24, 36, 48),
                 filters: int = 128, dtype=torch.float32):
        super().__init__()
        for i, (hop, n_oct, bpo) in enumerate(
                zip(hop_lengths, n_octaves, bins_per_octaves)):
            setattr(self, f"disc_{i}", DiscriminatorCQT(
                sampling_rate, hop, n_oct, bpo, filters=filters, dtype=dtype))


class CombinedDiscriminator(_MultiDiscriminator):
    """Several multi-discriminators chained into one; their outputs are
    concatenated in order."""

    def __init__(self, discriminators: Sequence[nn.Module]):
        super().__init__()
        for i, d in enumerate(discriminators):
            setattr(self, f"discriminators_{i}", d)

    def single(self, x):
        logits, fmaps = [], []
        for d in self.subs():
            dl, df = d.single(x)
            logits.extend(dl)
            fmaps.extend(df)
        return logits, fmaps


@torch.no_grad()
def init_discriminator(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from ``seed``, the JAX package's initialiser: every v
    truncated-normal (+-2 sigma) with variance 2 / fan_in (He), g = ||v||,
    biases zero."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, WNConv2d):
            fan_in = m.v[0].numel()
            std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.v, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            if m.g is not None:
                m.g.copy_(torch.sqrt((m.v * m.v).sum(dim=(1, 2, 3))))
            m.b.zero_()
    return module
