"""Plain reference of serving one clip: windows -> DDIM -> stitch -> vocoder.

The same semantics as the port's whole-clip pipeline, written out from the
DiffBinaural recipe: ln-mels clamped to [-12, 2.5] and mapped to [-1, 1],
80-frame windows at stride 40 (the last one right-aligned; spare slots of
the last group repeat the last window), the cosine schedule over 1000
steps, DDIM with eta 0 on the strided grid of ``steps`` calls with x_0
clipped to [-1, 1], then denormalise, crop 8 frames at each window edge,
average the overlaps, and vocode both channels.  float32 throughout; the
UNet runs in groups of ``unet_batch`` windows as the timed path does, so
each call sees the same rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MEL_MIN, MEL_MAX = -12.0, 2.5


def normalize_mel(x):
    return 2.0 * (x.clamp(MEL_MIN, MEL_MAX) - MEL_MIN) / (MEL_MAX - MEL_MIN) - 1


def denormalize_mel(x):
    return (x + 1.0) * 0.5 * (MEL_MAX - MEL_MIN) + MEL_MIN


def window_starts(total, window, stride):
    if total <= window:
        return [0]
    starts = list(range(0, total - window + 1, stride))
    if starts[-1] != total - window:
        starts.append(total - window)
    return starts


def crop_spans(starts, total, window, crop):
    spans = []
    for s in starts:
        t = min(window, total - s)
        spans.append((crop, t - crop) if t > 2 * crop else (t // 4, t - t // 4))
    return spans


def ddim_pairs(steps, timesteps=1000):
    times = np.linspace(-1, timesteps - 1, steps + 1).astype(int).tolist()
    times = list(reversed(times))
    return list(zip(times[:-1], times[1:]))


class Ddim:
    """The cosine schedule's constants (float64 -> float32) and one DDIM
    step, eta 0, x_0 clipped to [-1, 1]."""

    def __init__(self, device, timesteps=1000, s=0.008):
        t = np.linspace(0, timesteps, timesteps + 1) / timesteps
        ac = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
        ac = np.cumprod(1.0 - np.clip(1 - (ac / ac[0])[1:] / (ac / ac[0])[:-1],
                                      0, 0.999))
        f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
        self.ac = f32(ac)
        self.sqrt_recip, self.sqrt_recipm1 = f32(np.sqrt(1.0 / ac)), f32(
            np.sqrt(1.0 / ac - 1.0))

    @torch.no_grad()
    def eps(self, model, img, time, mono, feats):
        t = torch.full((img.shape[0],), time, dtype=torch.int32,
                       device=img.device)
        return model(img, t, mono, feats)

    def update(self, img, eps, time, time_next):
        """The state after the step (x_0 after the last one)."""
        x0 = (self.sqrt_recip[time] * img
              - self.sqrt_recipm1[time] * eps).clamp(-1, 1)
        if time_next < 0:
            return x0
        return (x0 * torch.sqrt(self.ac[time_next])
                + torch.sqrt(1 - self.ac[time_next]) * eps)


def windows(mono_mel, feats, slots, window, stride):
    """(1, M, T) raw ln-mels and (n_windows, C) features -> the UNet's
    normalised windows (slots, 1, M, window) and features (slots, C)."""
    starts = window_starts(mono_mel.shape[2], window, stride)
    wins = torch.stack([mono_mel[:, :, s: s + window] for s in starts])
    n = len(starts)
    wins = torch.cat([wins, wins[-1:].expand(slots - n, *wins.shape[1:])])
    feats = torch.cat([feats, feats[-1:].expand(slots - n, feats.shape[1])])
    return normalize_mel(wins), feats


def stitch(preds, total, window, stride, crop):
    """(n_windows, 2, M, window) normalised x_0 -> (2, M, T) ln-mels."""
    starts = window_starts(total, window, stride)
    preds = denormalize_mel(preds[: len(starts)])
    mel = torch.zeros((2, preds.shape[2], total), device=preds.device)
    count = torch.zeros((total,), device=preds.device)
    for i, (s, (lo, hi)) in enumerate(zip(starts, crop_spans(
            starts, total, window, crop))):
        mel[:, :, s + lo: s + hi] += preds[i, :, :, lo:hi]
        count[s + lo: s + hi] += 1.0
    return mel / count.clamp(min=1.0)


@torch.no_grad()
def serve(unet, vocoder, mono_mel, feats, noise, steps, window=80, stride=40,
          crop=8) -> dict:
    """A whole clip, with what the benchmark records of the port's run: the
    UNet's input state and output at every call in order, the stitched
    ln-mels the vocoder takes, and the waveform (2, samples); ``noise`` is
    (groups, unet_batch, 2, M, W)."""
    groups, ub = noise.shape[:2]
    wins, feats = windows(mono_mel, feats, groups * ub, window, stride)
    ddim, states, outs, preds = Ddim(mono_mel.device), [], [], []
    for g in range(groups):
        rows = slice(g * ub, (g + 1) * ub)
        img = noise[g]
        for time, time_next in ddim_pairs(steps):
            states.append(img)
            outs.append(ddim.eps(unet, img, time, wins[rows], feats[rows]))
            img = ddim.update(img, outs[-1], time, time_next)
        preds.append(img)
    mel = stitch(torch.cat(preds), mono_mel.shape[2], window, stride, crop)
    return {"states": states, "outs": outs, "mel": mel,
            "wav": vocoder(mel)[:, 0]}
