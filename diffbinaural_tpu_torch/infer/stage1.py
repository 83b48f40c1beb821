"""Stage-1 inference: mono log-mel (+ visual features) -> binaural log-mels.
Counterpart of ``diffbinaural_tpu/infer/stage1.py``.

  * normalisation: clamp ln-mels to [-12, 2.5] then affine to [-1, 1];
    inverted after sampling
  * ``Stage1Sampler.sample``: DDIM or DPM++ with the mono mel as the model's
    condition and a noised two-channel mix carried per step
  * ``generate_clip``: full-clip windowed generation with 8-frame edge
    crops and overlap averaging, stitched on the host
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import full_precision
from ..diffusion import GaussianDiffusion

MEL_MIN = -12.0
MEL_MAX = 2.5


def normalize_mel(x: torch.Tensor, lo: float = MEL_MIN, hi: float = MEL_MAX):
    """clamp + affine to [-1, 1]."""
    x = x.clamp(lo, hi)
    return 2.0 * (x - lo) / (hi - lo) - 1.0


def denormalize_mel(x: torch.Tensor, lo: float = MEL_MIN, hi: float = MEL_MAX):
    """[-1, 1] -> raw ln-mel range."""
    return (x + 1.0) * 0.5 * (hi - lo) + lo


class Stage1Sampler:
    """Bundles the denoiser with the diffusion engine.

    ``model(x, t, condition)`` -> prediction; condition is
    (mix, visual_feature, mix_t), all in normalised [-1, 1] space.  Runs on
    the card unless ``device="cpu"``.
    """

    def __init__(
        self,
        model: Callable,
        diffusion: Optional[GaussianDiffusion] = None,
        sampling_timesteps: int = 25,
        sampler: str = "ddim",
        device=None,
    ):
        """``sampler``: ``"ddim"`` (the reference's, 25 steps) or
        ``"dpm++"`` (DPM-Solver++(2M); pair it with about 12 steps)."""
        if sampler not in ("ddim", "dpm++"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.sampler = sampler
        self.device = resolve_device(device)
        self.diffusion = diffusion or GaussianDiffusion(
            image_size=80,
            timesteps=1000,
            sampling_timesteps=sampling_timesteps,
            objective="pred_noise",
            beta_schedule="cosine",
            auto_normalize=False,
            device=self.device,
        )
        self.model = model

    @full_precision()
    def sample(self, mono_mel, visual_feat,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mono_mel: (B, 1, 80, 80) raw ln-mels -> (B, 2, 80, 80) raw
        ln-mels.  ``noise`` is the initial x_T, else drawn from
        ``generator`` (seed 13 when neither is given)."""
        if generator is None and noise is None:
            generator = torch.Generator(device=self.device).manual_seed(13)
        mono = torch.as_tensor(mono_mel, dtype=torch.float32).to(self.device)
        feat = torch.as_tensor(visual_feat, dtype=torch.float32).to(self.device)
        sample = (self.diffusion.dpm_sample if self.sampler == "dpm++"
                  else self.diffusion.ddim_sample)
        pred = sample(self.model, (normalize_mel(mono), feat),
                      generator=generator, noise=noise)
        return denormalize_mel(pred)


def window_starts(total_frames: int, window: int = 80, stride: int = 40):
    """Start offsets covering [0, total); the final window is right-aligned."""
    if total_frames <= window:
        return [0]
    starts = list(range(0, total_frames - window + 1, stride))
    if starts[-1] != total_frames - window:
        starts.append(total_frames - window)
    return starts


def crop_spans(starts, total_frames: int, window: int = 80,
               crop_frames: int = 8):
    """Per-window kept span ``(lo, hi)`` within the window: the 8-frame edge
    crop, the middle half for short segments.  Shared by the host path
    (:func:`generate_clip`) and ``infer.pipeline.BinauralPipeline`` so the
    rule cannot drift between them."""
    spans = []
    for s in starts:
        t = min(window, total_frames - s)
        if t > 2 * crop_frames:
            lo, hi = crop_frames, t - crop_frames
        else:
            lo, hi = t // 4, t - t // 4
        spans.append((lo, hi))
    return spans


def generate_clip(
    sampler: Stage1Sampler,
    mono_mel_full: np.ndarray,
    visual_feats: np.ndarray,
    window: int = 80,
    stride: int = 40,
    crop_frames: int = 8,
    generator: Optional[torch.Generator] = None,
    max_batch: int = 32,
) -> np.ndarray:
    """Full-clip generation.  mono_mel_full: (1, num_mels, T) raw ln-mels of
    the whole clip; visual_feats: (n_windows, 512) per-window conditioning
    (or (512,) shared).  Returns (2, num_mels, T) overlap-averaged ln-mels;
    frames never covered by a cropped window stay at 0."""
    mono_mel_full = np.asarray(mono_mel_full, dtype=np.float32)
    visual_feats = np.asarray(visual_feats, dtype=np.float32)
    _, m, total = mono_mel_full.shape
    starts = window_starts(total, window, stride)
    n = len(starts)

    if total < window:  # pad short clips up to one window
        mono_mel_full = np.pad(
            mono_mel_full, ((0, 0), (0, 0), (0, window - total)),
            constant_values=MEL_MIN,
        )

    windows = np.stack([mono_mel_full[:, :, s: s + window] for s in starts])
    if visual_feats.ndim == 1:
        visual_feats = np.broadcast_to(visual_feats, (n, visual_feats.shape[0]))

    preds = []
    for i in range(0, n, max_batch):
        pred = sampler.sample(windows[i: i + max_batch],
                              visual_feats[i: i + max_batch], generator)
        preds.append(pred.float().cpu().numpy())
    preds = np.concatenate(preds, axis=0)  # (n, 2, m, window)

    mel = np.zeros((2, m, total), dtype=np.float32)
    count = np.zeros((2, m, total), dtype=np.float32)
    for s, (lo, hi), pred in zip(starts, crop_spans(starts, total, window,
                                                    crop_frames), preds):
        mel[:, :, s + lo: s + hi] += pred[:, :, lo:hi]
        count[:, :, s + lo: s + hi] += 1.0
    return mel / np.clip(count, 1.0, None)
