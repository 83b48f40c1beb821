"""Plain float32 PyTorch reference of the stage-2 GAN step (BigVGAN recipe).

The discriminators (multi-period; multi-scale sub-band CQT), their spectral
frontends, the losses (LS-GAN, feature matching, the 7-scale log-mel L1 at
weight ``lambda_melloss``) and the update (gradients clipped by global norm,
then AdamW with eps 1e-8 and weight decay 1e-2 at ``learning_rate *
lr_decay ** step``), written from the published recipe with the port's
parameter names.  One step is a D step on the detached generator output,
then a G step against the updated discriminators, with the real branch of
the feature matching held without a gradient.

The batch is taken in blocks of rows: every loss is a mean over equal
blocks, so the mean of the blocks' losses is the batch's loss and the mean
of their gradients its gradient.  That keeps the reference's memory at a
block's, whatever the batch.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .bigvgan import kaiser_sinc_taps, weight_norm

# ---------------------------------------------------------------- frontends

_F_SP, _MIN_LOG_HZ = 200.0 / 3.0, 1000.0
_MIN_LOG_MEL, _LOGSTEP = _MIN_LOG_HZ / _F_SP, math.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ, _MIN_LOG_MEL + np.log(
        np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, f / _F_SP)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(
        _LOGSTEP * (m - _MIN_LOG_MEL)), _F_SP * m)


@lru_cache(maxsize=None)
def mel_basis(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """Slaney-normalised mel filterbank (librosa's default), float32."""
    fmax = sr / 2.0 if fmax is None else fmax
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def hann(n):
    return (0.5 * (1.0 - np.cos(2.0 * math.pi * np.arange(n) / n))).astype(
        np.float32)


def _reflect(y, left, right):
    lead = y.shape[:-1]
    return F.pad(y.reshape(1, -1, y.shape[-1]), (left, right),
                 mode="reflect").reshape(*lead, -1)


def stft(y, n_fft, hop, center=True):
    """Complex STFT with a periodic Hann window: (..., T) -> (..., F, frames)."""
    win = torch.from_numpy(hann(n_fft)).to(y.device)
    if center:
        y = _reflect(y, n_fft // 2, n_fft // 2)
    frames = y.unfold(-1, n_fft, hop) * win
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def mel_spectrogram(y, h, fmax):
    """The vocoder's input: ln(max(mel(|STFT|), 1e-5)) with a reflect pad of
    (n_fft - hop) / 2 and no centring; (B, T) -> (B, num_mels, frames)."""
    n_fft, hop = h["n_fft"], h["hop_size"]
    pad = (n_fft - hop) // 2
    spec = stft(_reflect(y, pad, pad), n_fft, hop, center=False)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    basis = torch.from_numpy(mel_basis(h["sampling_rate"], n_fft,
                                       h["num_mels"], h["fmin"], fmax))
    return torch.log(torch.matmul(basis.to(y.device), mag).clamp(min=1e-5))


def multiscale_mel_loss(x, y, sr):
    """Sum over 7 scales (windows 32 ... 2048, hop w / 4, 5 ... 320 mels) of
    the mean |log10 mel(x) - log10 mel(y)|, mels clamped at 1e-5."""
    total = 0.0
    for m, w in zip((5, 10, 20, 40, 80, 160, 320),
                    (32, 64, 128, 256, 512, 1024, 2048)):
        basis = torch.from_numpy(mel_basis(sr, w, m)).to(x.device)
        xm, ym = (torch.log10(torch.matmul(basis, stft(a, w, w // 4).abs())
                              .clamp(min=1e-5)) for a in (x, y))
        total = total + torch.mean(torch.abs(xm - ym))
    return total


C1_HZ = 32.70319566257483


@lru_cache(maxsize=None)
def cqt_kernels(sr, bpo, n_octaves):
    """Top-octave Hann-windowed complex kernels, l1-normalised, centred in
    an L-sample bank: (L, 2 bpo) float32 (real | imaginary)."""
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    freqs = C1_HZ * 2.0 ** (n_octaves - 1) * 2.0 ** (np.arange(bpo) / bpo)
    lengths = np.ceil(q * sr / freqs).astype(int)
    big = int(lengths.max())
    bank = np.zeros((big, 2 * bpo), dtype=np.float32)
    for j, (f, n) in enumerate(zip(freqs, lengths)):
        t = np.arange(n, dtype=np.float64)
        win = 0.5 * (1.0 - np.cos(2.0 * math.pi * t / (n - 1)))
        k = win * np.exp(1j * 2.0 * math.pi * f / sr * (t - (n - 1) / 2.0))
        k /= np.abs(k).sum()
        s = (big - n) // 2
        bank[s: s + n, j] = k.real
        bank[s: s + n, bpo + j] = k.imag
    return bank


def cqt(x, sr, hop, n_octaves, bpo):
    """(B, T) -> (B, n_octaves * bpo, frames, 2), bins ascending; each lower
    octave decimates the signal by 2 (24-tap kaiser-sinc, zero pad) and
    reuses the top octave's kernels at half the hop."""
    bank = torch.from_numpy(cqt_kernels(sr, bpo, n_octaves)).to(x.device)
    big = bank.shape[0]
    dec = torch.from_numpy(kaiser_sinc_taps(0.25, 0.3, 24)).to(x.device)
    octaves = []
    for k in range(n_octaves):
        if k > 0:
            x = torch.matmul(F.pad(x, (11, 12)).unfold(-1, 24, 2), dec)
            hop = max(hop // 2, 1)
        n_frames = x.shape[-1] // hop + 1
        right = max(big // 2, hop * (n_frames - 1) + big - x.shape[-1]
                    - big // 2)
        frames = F.pad(x, (big // 2, right)).unfold(-1, big, hop)[:, :n_frames]
        re, im = torch.matmul(frames, bank).split(bpo, dim=-1)
        octaves.append(torch.stack([re, im], dim=-1).transpose(1, 2))
    n = min(o.shape[2] for o in octaves)
    return torch.cat([o[:, :, :n] for o in reversed(octaves)], dim=1)


def upsample2(x):
    """x2 anti-aliased upsampling of (B, 1, T), 24 taps, replicate pad."""
    taps = torch.from_numpy(kaiser_sinc_taps(0.25, 0.3, 24)).to(x.device)
    y = 2 * F.conv_transpose1d(F.pad(x, (11, 11), mode="replicate"),
                               taps.view(1, 1, -1), stride=2)
    return y[..., 33: y.shape[-1] - 33]


# ----------------------------------------------------------- discriminators


def leaky_relu(x):
    return F.leaky_relu(x, 0.1)


class WNConv2d(nn.Module):
    def __init__(self, c_in, c_out, k, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), use_weight_norm=True):
        super().__init__()
        self.strides, self.padding, self.dilation = strides, padding, dilation
        self.v = nn.Parameter(torch.empty(c_out, c_in, *k))
        self.g = nn.Parameter(torch.ones(c_out)) if use_weight_norm else None
        self.b = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        w = self.v if self.g is None else weight_norm(self.v, self.g)
        return F.conv2d(x, w, self.b, stride=self.strides,
                        padding=self.padding, dilation=self.dilation)


class DiscriminatorP(nn.Module):
    def __init__(self, period):
        super().__init__()
        self.period = period
        c_in = 1
        for i, w in enumerate((32, 128, 512, 1024)):
            setattr(self, f"conv_{i}", WNConv2d(c_in, w, (5, 1), (3, 1),
                                                (2, 0)))
            c_in = w
        self.conv_4 = WNConv2d(1024, 1024, (5, 1), padding=(2, 0))
        self.conv_post = WNConv2d(1024, 1, (3, 1), padding=(1, 0))

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


class DiscriminatorCQT(nn.Module):
    def __init__(self, sr, hop, n_octaves, bpo, filters, max_filters=1024,
                 filters_scale=1, dilations=(1, 2, 4)):
        super().__init__()
        self.sr, self.hop, self.n_octaves, self.bpo = sr, hop, n_octaves, bpo
        for i in range(n_octaves):
            setattr(self, f"conv_pre_{i}", WNConv2d(
                2, 2, (3, 9), padding=(1, 4), use_weight_norm=False))
        self.conv_0 = WNConv2d(2, filters, (3, 9), padding=(1, 4),
                               use_weight_norm=False)
        c_in = filters
        for i, d in enumerate(dilations):
            out = min(filters_scale ** (i + 1) * filters, max_filters)
            setattr(self, f"conv_{i + 1}", WNConv2d(
                c_in, out, (3, 9), (1, 2), (d, 4), (d, 1)))
            c_in = out
        self.n_dilated = len(dilations)
        out = min(filters_scale ** (len(dilations) + 1) * filters, max_filters)
        self.conv_final = WNConv2d(c_in, out, (3, 3), padding=(1, 1))
        self.conv_post = WNConv2d(out, 1, (3, 3), padding=(1, 1))

    def forward(self, x):
        b = x.shape[0]
        z = cqt(upsample2(x)[:, 0], self.sr * 2, self.hop, self.n_octaves,
                self.bpo).permute(0, 3, 2, 1)
        latent = torch.cat([
            getattr(self, f"conv_pre_{i}")(z[..., i * self.bpo:
                                             (i + 1) * self.bpo])
            for i in range(self.n_octaves)], dim=3)
        fmap = []
        latent = leaky_relu(self.conv_0(latent))
        fmap.append(latent)
        for i in range(self.n_dilated):
            latent = leaky_relu(getattr(self, f"conv_{i + 1}")(latent))
            fmap.append(latent)
        latent = leaky_relu(self.conv_final(latent))
        fmap.append(latent)
        return self.conv_post(latent).reshape(b, -1), fmap


class Multi(nn.Module):
    def single(self, x):
        logits, fmaps = [], []
        for d in self.children():
            logit, fmap = d(x)
            logits.append(logit)
            fmaps.append(fmap)
        return logits, fmaps


def build_discriminators(h):
    """(mpd, cqtd) of a config with ``use_cqtd_instead_of_mrd``."""
    if not h.get("use_cqtd_instead_of_mrd", False):
        raise ValueError("the reference covers the MPD + CQTD pair only")
    mpd = Multi()
    for p in h.get("mpd_reshapes", [2, 3, 5, 7, 11]):
        mpd.add_module(f"disc_{p}", DiscriminatorP(p))
    cqtd = Multi()
    for i, (hop, n_oct, bpo) in enumerate(zip(
            h["cqtd_hop_lengths"], h["cqtd_n_octaves"],
            h["cqtd_bins_per_octaves"])):
        cqtd.add_module(f"disc_{i}", DiscriminatorCQT(
            h["sampling_rate"], hop, n_oct, bpo, h["cqtd_filters"],
            h.get("cqtd_max_filters", 1024), h.get("cqtd_filters_scale", 1),
            tuple(h.get("cqtd_dilations", (1, 2, 4)))))
    return mpd, cqtd


# ------------------------------------------------------------------- the step


def _d_loss(discs, y, y_hat):
    loss = 0.0
    for d in discs:
        real, _ = d.single(y)
        fake, _ = d.single(y_hat)
        for dr, dg in zip(real, fake):
            loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def _g_adv(discs, y, y_hat):
    loss = 0.0
    for d in discs:
        with torch.no_grad():
            _, fm_r = d.single(y)
        logits, fm_g = d.single(y_hat)
        for dr, dg in zip(fm_r, fm_g):
            for rl, gl in zip(dr, dg):
                loss = loss + 2.0 * torch.mean(torch.abs(rl - gl))
        for dg in logits:
            loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss


def _clip_(params, max_norm):
    """optax's clip by global norm: g / norm * max_norm above the limit."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    if float(norm) >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


class GanStep:
    """One D + G step of the reference over ``block``-row blocks."""

    def __init__(self, generator, mpd, cqtd, h, block):
        self.gen, self.discs, self.h, self.block = generator, (mpd, cqtd), h, block
        self.g_params = list(generator.parameters())
        self.d_params = [p for d in self.discs for p in d.parameters()]

        def adamw(params):
            return torch.optim.AdamW(params, lr=h["learning_rate"],
                                     betas=(h["adam_b1"], h["adam_b2"]),
                                     eps=1e-8, weight_decay=1e-2,
                                     foreach=False)

        self.g_opt, self.d_opt = adamw(self.g_params), adamw(self.d_params)
        self.step = 0

    def __call__(self, mel, audio):
        """mel (B, M, frames), audio (B, T) -> (d_loss, g_loss) floats."""
        h = self.h
        lr = h["learning_rate"] * h["lr_decay"] ** self.step
        rows = [slice(i, i + self.block)
                for i in range(0, mel.shape[0], self.block)]
        n = len(rows)
        for p in self.g_params + self.d_params:
            p.grad = torch.zeros_like(p)
        d_loss = 0.0
        for r in rows:
            with torch.no_grad():
                y_hat = self.gen(mel[r])
            loss = _d_loss(self.discs, audio[r, None], y_hat) / n
            for p, g in zip(self.d_params, torch.autograd.grad(
                    loss, self.d_params, allow_unused=True)):
                if g is not None:
                    p.grad += g
            d_loss += float(loss.detach())
        _clip_(self.d_params, h["clip_grad_norm"])
        for group in self.d_opt.param_groups:
            group["lr"] = lr
        self.d_opt.step()
        g_loss = 0.0
        for r in rows:
            y = audio[r, None]
            y_hat = self.gen(mel[r])
            loss = (multiscale_mel_loss(y, y_hat, h["sampling_rate"])
                    * h["lambda_melloss"] + _g_adv(self.discs, y, y_hat)) / n
            for p, g in zip(self.g_params, torch.autograd.grad(
                    loss, self.g_params, allow_unused=True)):
                if g is not None:
                    p.grad += g
            g_loss += float(loss.detach())
        _clip_(self.g_params, h["clip_grad_norm"])
        for group in self.g_opt.param_groups:
            group["lr"] = lr
        self.g_opt.step()
        self.step += 1
        return d_loss, g_loss
