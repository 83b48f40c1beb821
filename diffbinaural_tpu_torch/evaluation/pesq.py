"""P.862-style perceptual speech-quality estimate (PESQ-like MOS) on float64
tensors — counterpart of ``diffbinaural_tpu/evaluation/pesq.py``, the same
pipeline on the device the signals lie on:

  1. resample both signals to 16 kHz (:func:`resample_poly`, scipy's
     polyphase resampler reproduced) and align them coarsely by
     cross-correlation (±125 ms),
  2. gain-align to a fixed active-band level,
  3. short-time FFT -> Bark-band pitch power densities (Zwicker scale),
  4. partial frequency-response compensation of the reference toward the
     degraded signal,
  5. Zwicker-law loudness with an absolute-hearing-threshold floor,
  6. per-frame symmetric and asymmetric loudness disturbance with the
     masking deadzone and the asymmetry factor,
  7. L6 over syllables, L2 over time, the P.862 linear MOS combination and
     the wideband logistic to MOS-LQO.

It differs from bit-exact ITU-T P.862 as the JAX module does (analytic
hearing threshold and Bark edges in place of the calibration tables; no IIR
receive filter, no per-utterance re-alignment).  The band geometry is a
host constant.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import firwin

_SR = 16000
_FRAME = 512  # 32 ms at 16 kHz
_HOP = 256
_NBARK = 49
F64 = torch.float64


def _bark(f):
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _hearing_threshold_db(f):
    """Absolute threshold of hearing (ISO-226-style analytic fit), dB."""
    f = np.maximum(np.asarray(f, np.float64), 20.0) / 1000.0
    return (
        3.64 * f ** -0.8
        - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
        + 1e-3 * f ** 4
    )


@lru_cache(maxsize=1)
def _band_geometry():
    """Bark band edges / centres / widths over 100..8000 Hz (host arrays;
    cached, do not write to them)."""
    z_edges = np.linspace(_bark(100.0), _bark(8000.0), _NBARK + 1)
    # invert z(f) by interpolation on a dense grid
    fgrid = np.linspace(20.0, 8000.0, 4096)
    f_edges = np.interp(z_edges, _bark(fgrid), fgrid)
    centers = 0.5 * (f_edges[1:] + f_edges[:-1])
    widths = np.diff(z_edges)  # constant in Bark
    return f_edges, centers, widths


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=like.device)


# ---------------------------------------------------------------------------
# scipy.signal.resample_poly, polyphase on the device
# ---------------------------------------------------------------------------


def _output_len(len_h: int, in_len: int, up: int, down: int) -> int:
    """``upfirdn``'s output length: ceil(((in_len - 1)·up + len_h) / down)."""
    return ((in_len - 1) * up + len_h - 1) // down + 1


@lru_cache(maxsize=8)
def _resample_plan(n_in: int, up: int, down: int):
    """scipy's design for ``resample_poly(x, up, down)`` with its default
    window (Kaiser, β 5.0): the low-pass taps (half-length
    10·max(up, down), cutoff 1 / max(up, down), gain ``up``), zero-padded
    in front so that the outputs fall on the filter's centre (and behind
    as far as the output needs), split into ``up`` phases: row p holds
    ``h[p + up·i]``.  Returns (phases (up, L), n_out, n_pre_remove)."""
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    h = h * up
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while _output_len(len(h) + n_pre_pad + n_post_pad, n_in, up,
                      down) < n_out + n_pre_remove:
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    taps = -(-len(h) // up)
    phases = np.zeros(up * taps)
    phases[:len(h)] = h
    return phases.reshape(taps, up).T.copy(), n_out, n_pre_remove


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """``scipy.signal.resample_poly(x, up, down)`` of a float64 (T,) tensor
    with the default window and zero padding, on ``x``'s device.

    ``upfirdn`` computes y[k] = Σ_j h[j]·x_up[k·down − j] with x_up the
    input with up − 1 zeros after each sample; with k·down = q·up + p only
    the taps h[p + up·i] meet samples, x[q − i].  So each kept output is a
    dot product of one phase row with a window of x read backwards — one
    gather of (outputs, taps)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    x = x.to(F64)
    if up == down == 1:
        return x.clone()
    phases, n_out, n_pre_remove = _resample_plan(x.shape[-1], up, down)
    taps = phases.shape[1]
    k = torch.arange(n_pre_remove, n_pre_remove + n_out, device=x.device)
    t = k * down
    q, p = t // up, t % up
    # x padded with taps - 1 zeros in front (the reach back) and behind
    # (outputs past the end)
    xp = F.pad(x, (taps - 1, taps))
    idx = q[:, None] - torch.arange(taps, device=x.device)[None, :] + taps - 1
    idx = idx.clamp(0, xp.shape[-1] - 1)
    rows = _const(phases, x)[p]
    return (rows * xp[idx]).sum(-1)


# ---------------------------------------------------------------------------
# the measurement
# ---------------------------------------------------------------------------


def _bark_powers(x: torch.Tensor) -> torch.Tensor:
    """(T,) -> (frames, _NBARK) pitch power densities."""
    n = (x.shape[-1] - _FRAME) // _HOP + 1
    if n < 1:
        raise ValueError("signal shorter than one 32 ms frame")
    frames = x.unfold(-1, _FRAME, _HOP) * _const(np.hanning(_FRAME), x)
    spec = torch.fft.rfft(frames, dim=1).abs() ** 2
    freqs = np.fft.rfftfreq(_FRAME, 1.0 / _SR)
    f_edges, _, _ = _band_geometry()
    bins = np.searchsorted(f_edges, freqs) - 1
    valid = (bins >= 0) & (bins < _NBARK)
    out = torch.zeros((n, _NBARK), dtype=F64, device=x.device)
    out.index_add_(1, _const(bins[valid], x),
                   spec[:, _const(np.flatnonzero(valid), x)])
    return out


def _active_level_align(p: torch.Tensor) -> torch.Tensor:
    """Scale band powers so the average active (speech-band) power is a
    fixed target — P.862's level alignment."""
    _, centers, _ = _band_geometry()
    band = _const(np.flatnonzero((centers >= 350.0) & (centers <= 3250.0)), p)
    frame_e = p[:, band].sum(dim=1)
    active = frame_e > (frame_e.max() * 1e-4 + 1e-12)
    mean_p = float(frame_e[active].mean() if active.any() else frame_e.mean())
    return p * (1e7 / max(mean_p, 1e-12))


def pesq_style_mos(ref: torch.Tensor, deg: torch.Tensor, sr: int) -> float:
    """P.862-style MOS-LQO in [1.02, ~4.64] (wideband mapping) of two mono
    signals at ``sr`` (stereo is scored per channel by the caller)."""
    ref = ref.to(F64).reshape(-1)
    deg = deg.to(F64).reshape(-1)
    if sr != _SR:
        g = math.gcd(_SR, sr)
        ref = resample_poly(ref, _SR // g, sr // g)
        deg = resample_poly(deg, _SR // g, sr // g)
    n = min(ref.shape[-1], deg.shape[-1])
    ref, deg = ref[:n], deg[:n]

    # coarse time alignment (cross-correlation, ±125 ms): np.correlate's
    # "valid" mode is conv1d's cross-correlation
    max_lag = _SR // 8
    if n > 4 * max_lag:
        corr = F.conv1d(deg[None, None, : 4 * max_lag + max_lag],
                        ref[None, None, : 4 * max_lag])[0, 0]
        lag = int(torch.argmax(corr.abs()))
        if lag > 0:
            deg = deg[lag:]
            ref = ref[: deg.shape[-1]]

    p_ref = _active_level_align(_bark_powers(ref))
    p_deg = _active_level_align(_bark_powers(deg))
    m = min(p_ref.shape[0], p_deg.shape[0])
    p_ref, p_deg = p_ref[:m], p_deg[:m]

    # partial frequency compensation: move ref toward deg's mean response
    # in each band, gain clipped to ±20 dB (allowed linear filtering)
    mean_ref = p_ref.mean(dim=0) + 1e3
    mean_deg = p_deg.mean(dim=0) + 1e3
    comp = torch.clamp(mean_deg / mean_ref, 1e-2, 1e2)
    p_ref = p_ref * comp[None, :]

    # Zwicker loudness with a hearing-threshold floor
    _, centers, widths = _band_geometry()
    thr = _const(1e4 * 10.0 ** (_hearing_threshold_db(centers) / 10.0), ref)
    gamma = 0.23

    def loud(p):
        return (thr / 0.5) ** gamma * ((0.5 + 0.5 * p / thr) ** gamma - 1.0)

    l_ref = loud(p_ref)
    l_deg = loud(p_deg)

    # disturbance with the masking deadzone
    d = l_deg - l_ref
    dead = 0.25 * torch.minimum(l_deg, l_ref)
    d = torch.sign(d) * torch.clamp(d.abs() - dead, min=0.0)

    w = _const(widths, ref)[None, :]
    frame_sym = torch.sqrt(torch.sum((d * w) ** 2, dim=1) / w.sum())

    # asymmetry factor: additive distortions hurt more than removals
    asym = ((p_deg + 50.0) / (p_ref + 50.0)) ** 1.2
    asym = torch.where(asym < 3.0, torch.zeros_like(asym),
                       torch.clamp(asym, max=12.0))
    frame_asym = torch.sum(d.abs() * asym * w, dim=1)

    # energy-dependent frame weight (quiet frames count less)
    frame_e = p_ref.sum(dim=1)
    weight = ((frame_e + 1e5) / 1e7) ** 0.04

    def aggregate(frame_d):
        chunk = 20  # ≈ "syllable" spans of 320 ms
        pads = (-frame_d.shape[0]) % chunk
        fd = F.pad(frame_d * weight, (0, pads)).reshape(-1, chunk)
        wts = F.pad(weight, (0, pads)).reshape(-1, chunk)
        l6 = (torch.sum(fd ** 6, dim=1)
              / torch.clamp(torch.sum(wts ** 6, dim=1), min=1e-12)) ** (1 / 6)
        return float(torch.sqrt(torch.mean(l6 ** 2)))

    # calibration in lieu of ITU's Sl/Sp tables (the JAX module's: additive
    # white noise maps to MOS ≈ {4.3, 4.2, 4.0, 3.0, 1.2} at SNR
    # {40, 30, 20, 10, 0} dB)
    d_sym = 3.0 * aggregate(frame_sym)
    d_asym = aggregate(frame_asym) / 30.0

    raw = 4.5 - 0.1 * d_sym - 0.0309 * d_asym
    raw = float(np.clip(raw, -0.5, 4.5))
    # wideband logistic raw -> MOS-LQO (P.862.2 mapping)
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))


def pesq_binaural(pred: torch.Tensor, gt: torch.Tensor, sr: int) -> float:
    """Mean P.862-style MOS over the two channels of (2, T) tensors."""
    return float(np.mean([pesq_style_mos(gt[c], pred[c], sr)
                          for c in range(2)]))
