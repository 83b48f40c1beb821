"""Silence-aware auxiliary losses for vocoder training — counterpart of
``diffbinaural_tpu/losses/silence.py``.  ``simple_silence_aware_mel_loss``
is the stage-2 step's non-multiscale branch; the others are the loss
library of the reference trainers, ported whole."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def detect_silence_regions(mel_spec: torch.Tensor, threshold_db: float = -60.0,
                           min_silence_frames: int = 5) -> torch.Tensor:
    """mel (B, n_mels, T) -> silence mask (B, 1, T) float32, 1 = silence:
    frames whose mean dB is below the threshold, kept only inside runs of
    at least ``min_silence_frames`` (a box filter of that width, zero
    padded, must see silence everywhere)."""
    mel_db = 20.0 * torch.log10(mel_spec.clamp(min=1e-8))
    energy = mel_db.mean(dim=1, keepdim=True)
    mask = (energy < threshold_db).float()
    if min_silence_frames > 1:
        k = min_silence_frames
        box = torch.ones((1, 1, k), dtype=torch.float32, device=mask.device)
        mask = (F.conv1d(mask, box, padding=k // 2) >= k).float()
    return mask


def silence_aware_loss(y_mel, y_g_hat_mel, y: Optional[torch.Tensor] = None,
                       y_g_hat: Optional[torch.Tensor] = None,
                       silence_threshold_db: float = -60.0):
    """Region-weighted mel L1 (silence x3) and, given the waveforms, the
    predicted energy inside silence x10.  Returns (mel loss, energy
    penalty)."""
    silence = detect_silence_regions(y_mel, silence_threshold_db)
    base = torch.abs(y_mel - y_g_hat_mel)
    mel_loss = torch.mean(base * silence * 3.0 + base * (1.0 - silence))
    if y is not None and y_g_hat is not None:
        t_wave = y.shape[-1]
        # nearest-neighbour upsample of the frame mask to the sample rate
        mask_wave = silence.repeat_interleave(t_wave // silence.shape[-1],
                                              dim=-1)
        pad = t_wave - mask_wave.shape[-1]
        if pad > 0:
            mask_wave = F.pad(mask_wave, (0, pad), mode="replicate")
        energy = torch.mean(y_g_hat ** 2 * mask_wave[..., :t_wave])
        return mel_loss, energy * 10.0
    return mel_loss, torch.zeros((), device=y_mel.device)


def simple_silence_aware_mel_loss(y_mel, y_g_hat_mel,
                                  silence_threshold_db: float = -50.0,
                                  silence_penalty: float = 2.0):
    """Mel L1 with the frames whose mean dB is below the threshold weighted
    by ``silence_penalty``."""
    y_db = 20.0 * torch.log10(y_mel.clamp(min=1e-8))
    silence = (y_db.mean(dim=1, keepdim=True) < silence_threshold_db).float()
    base = torch.abs(y_mel - y_g_hat_mel)
    return torch.mean(base * silence * silence_penalty + base * (1.0 - silence))


def spectral_consistency_loss(y_g_hat_mel, low_freq_weight: float = 2.0,
                              high_freq_weight: float = 0.5):
    """Temporal x0.1 + frequency x0.05 smoothness (the two weights are
    accepted and unused, as in the reference)."""
    del low_freq_weight, high_freq_weight
    temporal = torch.mean(torch.abs(torch.diff(y_g_hat_mel, dim=-1)))
    freq = torch.mean(torch.abs(torch.diff(y_g_hat_mel, dim=-2)))
    return temporal * 0.1 + freq * 0.05


def energy_regularization_loss(y_mel, y_g_hat_mel,
                               y_g_hat: Optional[torch.Tensor] = None):
    """Energy conservation x0.1 + dynamic range x0.1 + RMS x0.05."""
    b = y_mel.shape[0]
    energy_loss = torch.mean(torch.abs(y_g_hat_mel.sum(dim=(1, 2))
                                       - y_mel.sum(dim=(1, 2))))
    gt = y_mel.reshape(b, -1)
    pred = y_g_hat_mel.reshape(b, -1)
    dr_loss = torch.mean(torch.abs(
        (pred.amax(dim=1) - pred.amin(dim=1))
        - (gt.amax(dim=1) - gt.amin(dim=1))))
    if y_g_hat is not None:
        gt_rms = torch.sqrt(torch.mean(torch.sum(y_mel ** 2, dim=1), dim=1))
        pred_rms = torch.sqrt(torch.mean(y_g_hat ** 2, dim=(1, 2)))
        rms_loss = torch.mean(torch.abs(pred_rms - gt_rms))
    else:
        rms_loss = 0.0
    return energy_loss * 0.1 + dr_loss * 0.1 + rms_loss * 0.05


def adaptive_loss_weighting(current_step: int, total_steps: int):
    """(silence, spectral, energy) weights rising linearly with progress."""
    progress = min(current_step / max(total_steps, 1), 1.0)
    return 0.5 + 1.5 * progress, 0.1 + 0.4 * progress, 0.3 + 0.2 * progress
