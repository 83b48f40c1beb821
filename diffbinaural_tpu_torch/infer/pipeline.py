"""Whole-clip inference: mono log-mel -> stereo waveform.  Counterpart of
``diffbinaural_tpu/infer/pipeline.py``.

Window extraction, DDIM over the window groups, the
denormalise/crop/overlap-average stitch and the BigVGAN vocoder all run on
one device without a host round trip in between; windows go through the
UNet in groups of ``unet_batch``.

The clip geometry (total frames, window/stride/crop, grouping) is fixed per
pipeline instance.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..diffusion import GaussianDiffusion
from .stage1 import (
    MEL_MIN,
    crop_spans,
    denormalize_mel,
    normalize_mel,
    window_starts,
)


class BinauralPipeline:
    """mono ln-mel clip (1, num_mels, T) + per-window visual features ->
    stereo waveform (2, T*hop).

    ``unet(x, t, condition)`` is the stage-1 denoiser; ``vocoder(mel)`` is
    the BigVGAN generator on (B, num_mels, T).  Both must already live on
    ``device`` — the card unless ``device="cpu"`` is passed.
    """

    def __init__(
        self,
        unet,
        vocoder,
        total_frames: int,
        *,
        num_mels: int = 80,
        window: int = 80,
        stride: int = 40,
        crop_frames: int = 8,
        unet_batch: int = 8,
        sampling_timesteps: int = 25,
        sampler: str = "ddim",
        diffusion: Optional[GaussianDiffusion] = None,
        device=None,
    ):
        if sampler != "ddim":
            raise ValueError(f"unknown sampler {sampler!r} (ported: 'ddim')")
        self.device = resolve_device(device)
        self.unet = unet
        self.vocoder = vocoder
        self.total_frames = total_frames
        self.num_mels = num_mels
        self.window = window
        self.diffusion = diffusion or GaussianDiffusion(
            image_size=window,
            timesteps=1000,
            sampling_timesteps=sampling_timesteps,
            beta_schedule="cosine",
            auto_normalize=False,
            device=self.device,
        )

        self.starts = window_starts(total_frames, window, stride)
        self.n_windows = len(self.starts)
        self.n_batches = -(-self.n_windows // unet_batch)
        self.n_slots = self.n_batches * unet_batch
        self.unet_batch = unet_batch

        # per-window kept span — the same rule as the host path
        self._spans = crop_spans(self.starts, total_frames, window,
                                 crop_frames)
        count = np.zeros((total_frames,), np.float32)
        for s, (lo, hi) in zip(self.starts, self._spans):
            count[s + lo: s + hi] += 1.0
        # never-covered frames divide by a count clipped to 1
        self._inv_count = torch.from_numpy(
            1.0 / np.clip(count, 1.0, None)).to(self.device)

    def _make_windows(self, mono_full: torch.Tensor) -> torch.Tensor:
        """(1, M, T) raw ln-mel -> (n_slots, 1, M, window) normalised; the
        spare slots repeat the last window."""
        wins = torch.stack(
            [mono_full[:, :, s: s + self.window] for s in self.starts])
        if self.n_slots != self.n_windows:
            pad = wins[-1:].expand(
                (self.n_slots - self.n_windows,) + tuple(wins.shape[1:]))
            wins = torch.cat([wins, pad], dim=0)
        return normalize_mel(wins)

    def _stitch(self, preds: torch.Tensor) -> torch.Tensor:
        """(n_slots, 2, M, window) normalised predictions -> (2, M, T)
        ln-mels via denormalise -> edge crop -> overlap-average."""
        preds = denormalize_mel(preds[: self.n_windows])
        mel = torch.zeros((2, self.num_mels, self.total_frames),
                          dtype=preds.dtype, device=preds.device)
        for i, (s, (lo, hi)) in enumerate(zip(self.starts, self._spans)):
            mel[:, :, s + lo: s + hi] += preds[i, :, :, lo:hi]
        return mel * self._inv_count[None, None, :]

    @torch.inference_mode()
    def stitched_mel(self, mono_mel_full, visual_feats,
                     generator: Optional[torch.Generator] = None,
                     noise=None) -> torch.Tensor:
        """The stage-1 half: (2, M, T) stitched binaural ln-mels.
        ``noise``: optional (n_batches, unet_batch, 2, M, window) initial
        x_T of every group; otherwise each group draws from ``generator``
        (seed 13 when absent)."""
        mono = torch.as_tensor(np.asarray(mono_mel_full), dtype=torch.float32)
        if mono.shape[2] != self.total_frames:
            # a mismatched clip would stitch predictions at wrong positions
            raise ValueError(
                f"clip has {mono.shape[2]} frames; this pipeline "
                f"was built for total_frames={self.total_frames}"
            )
        if mono.shape[2] < self.window:  # pad short clips
            mono = torch.nn.functional.pad(
                mono, (0, self.window - mono.shape[2]), value=MEL_MIN)
        feats = torch.as_tensor(np.asarray(visual_feats), dtype=torch.float32)
        if feats.dim() == 1:
            feats = feats.expand(self.n_slots, feats.shape[0])
        elif feats.shape[0] == self.n_slots:
            pass
        elif feats.shape[0] == self.n_windows:  # pad with the last window's
            pad = feats[-1:].expand(self.n_slots - feats.shape[0],
                                    feats.shape[1])
            feats = torch.cat([feats, pad], dim=0)
        else:
            raise ValueError(
                f"visual_feats has {feats.shape[0]} rows; expected "
                f"n_windows={self.n_windows} (or (512,) shared)"
            )
        if generator is None and noise is None:
            generator = torch.Generator(device=self.device).manual_seed(13)

        wins = self._make_windows(mono.to(self.device))
        feats = feats.to(self.device)
        group = (self.n_batches, self.unet_batch)
        wins_g = wins.reshape(group + tuple(wins.shape[1:]))
        feat_g = feats.reshape(group + (-1,))
        preds = [
            self.diffusion.ddim_sample(
                self.unet, (wins_g[i], feat_g[i]), generator=generator,
                noise=None if noise is None else torch.as_tensor(noise[i]),
            )
            for i in range(self.n_batches)
        ]
        return self._stitch(torch.cat(preds, dim=0))

    @torch.inference_mode()
    def __call__(self, mono_mel_full, visual_feats,
                 generator: Optional[torch.Generator] = None,
                 noise=None) -> torch.Tensor:
        """mono_mel_full: (1, num_mels, T) raw ln-mels; visual_feats:
        (n_windows, 512) per-window conditioning or (512,) shared.  Returns
        the generator's output on the stitched binaural mels, (2, T*hop),
        on ``device``."""
        mel = self.stitched_mel(mono_mel_full, visual_feats, generator, noise)
        wav = self.vocoder(mel)
        # BigVGAN emits (B, 1, samples); drop the unit channel axis
        return wav[:, 0] if wav.dim() == 3 and wav.shape[1] == 1 else wav
