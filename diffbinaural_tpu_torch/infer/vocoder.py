"""Vocoder inference: log-mels -> waveform with zero-frame silence handling.
Counterpart of ``diffbinaural_tpu/infer/vocoder.py``.

  * ``detect_and_exclude_zero_frames`` — host-side (numpy) frame filtering
    before vocoding
  * ``reconstruct_audio_with_silence`` — hop-granular silence re-insertion
  * ``Vocoder`` — the generator behind a numpy interface; the L and R mels
    of a clip run as ONE batched call

Clip lengths are padded up to a multiple of ``pad_multiple`` mel frames
with the log-mel floor, as the JAX package does, so both give the same
samples near the end of a clip.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import VocoderConfig
from ..core.device import resolve_device
from ..core.precision import full_precision
from ..models import BigVGAN, build_vocoder
from ..utils.profiling import span


def detect_and_exclude_zero_frames(
    mel_spec: np.ndarray, zero_threshold: float = 1e-10
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(num_mels, T) -> (filtered_mel, zero_mask, nonzero_indices)."""
    frame_sums = np.sum(np.abs(mel_spec), axis=0)
    zero_mask = frame_sums <= zero_threshold
    if not np.any(zero_mask):
        return mel_spec, zero_mask, np.arange(mel_spec.shape[1])
    nonzero = np.where(~zero_mask)[0]
    return mel_spec[:, nonzero], zero_mask, nonzero


def reconstruct_audio_with_silence(
    filtered_audio: np.ndarray,
    zero_mask: np.ndarray,
    nonzero_indices: np.ndarray,
    hop_size: int,
    original_length: int,
) -> np.ndarray:
    """Re-insert hop-sized silence blocks at the original frame positions."""
    restored = np.zeros(original_length, dtype=filtered_audio.dtype)
    for i, orig in enumerate(nonzero_indices):
        src_lo = i * hop_size
        src_hi = min((i + 1) * hop_size, len(filtered_audio))
        dst_lo = orig * hop_size
        dst_hi = min((orig + 1) * hop_size, original_length)
        n = min(src_hi - src_lo, dst_hi - dst_lo)
        if n > 0:
            restored[dst_lo: dst_lo + n] = filtered_audio[src_lo: src_lo + n]
    return restored


class Vocoder:
    """BigVGAN inference over padded lengths.  ``model`` is a ``BigVGAN``
    already on ``device``; without one, a generator with random weights from
    ``seed`` is built.  Runs on the card unless ``device="cpu"``."""

    def __init__(
        self,
        config: VocoderConfig = VocoderConfig(),
        hop_size: int = 256,
        pad_multiple: int = 64,
        dtype=torch.float32,
        model: Optional[BigVGAN] = None,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.hop_size = hop_size
        self.pad_multiple = pad_multiple
        self.model = model if model is not None else build_vocoder(
            config, dtype=dtype, seed=seed, device=self.device)

    @torch.inference_mode()
    @full_precision()
    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """mel: (B, num_mels, T) -> (B, T*hop) float32 in [-1, 1]."""
        with span("vocoder"):
            b, m, t = mel.shape
            with span("vocoder.pad"):
                t_pad = -(-t // self.pad_multiple) * self.pad_multiple
                mel_in = np.full((b, m, t_pad), np.log(1e-5), dtype=np.float32)
                mel_in[:, :, :t] = mel
            with span("vocoder.to_device"):
                x = torch.from_numpy(mel_in).to(self.device)
            y = self.model(x)[:, 0]
            with span("vocoder.to_host"):
                return y[:, : t * self.hop_size].float().cpu().numpy()

    def vocode_binaural(
        self,
        mel_left: np.ndarray,
        mel_right: np.ndarray,
        interpolate_zero_frames: bool = True,
    ) -> np.ndarray:
        """(num_mels, T) x 2 -> stereo (2, T*hop) with zero-frame silence
        handling."""
        t = mel_left.shape[1]
        out_len = t * self.hop_size
        if not interpolate_zero_frames:
            return self(np.stack([mel_left, mel_right]))

        chans = []
        for mel in (mel_left, mel_right):
            filtered, mask, idx = detect_and_exclude_zero_frames(mel)
            if filtered.shape[1] == 0:
                chans.append(np.zeros(out_len, dtype=np.float32))
                continue
            audio = self(filtered[None])[0]
            if mask.any():
                audio = reconstruct_audio_with_silence(
                    audio, mask, idx, self.hop_size, out_len
                )
            chans.append(audio[:out_len])
        return np.stack(chans)
