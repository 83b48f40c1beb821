"""Binaural vocoder datasets (stage 2 on predicted mels, and the
scheduled-sampling curriculum) — counterpart of
``diffbinaural_tpu/data/binaural.py``.

  * ``BinauralMelSpectrogramDataset``: ``left/*.npy`` + ``right/*.npy`` +
    audio paired by basename; even index = L, odd = R, so the dataset is
    twice the pairs; 8-frame edge trims with the matching 8 x hop audio
    trim, a random segment crop, peak normalisation x0.95, the loss mel
    recomputed from the audio.
  * ``BinauralCombinedDataset``: audio files (the ground-truth mel from the
    vocoder's own mel frontend) and/or predicted-mel pairs; the epoch-wise
    curriculum P(pred) 0 -> 50 % (epochs 10-30) -> 90 % (30-60) -> 100 %;
    a coin flip per item between ground truth and prediction; audio
    normalisation deliberately disabled; validation on predicted mels only.

The mel frontend is ``meldataset._MelFrontend`` (the port's mel on CPU
tensors).  Randomness is the stdlib's, as in the JAX package: the mel
dataset's crops and its corrupt-sample redraw use the global ``random``
module, the combined dataset one ``random.Random(seed)`` shared by the coin
flips, the crops and the redraws (so its draws depend on the order in which
loader threads call it; with one worker they are the JAX package's).
"""

from __future__ import annotations

import glob
import os
import random
from typing import List, Optional, Tuple

import numpy as np

from .audio_io import load_wav, normalize_audio
from .meldataset import _MelFrontend

_AUDIO_EXTS = (".wav", ".flac", ".mp3")


def _find_audio(audio_dir: str, base: str) -> Optional[str]:
    for ext in _AUDIO_EXTS:
        p = os.path.join(audio_dir, base + ext)
        if os.path.exists(p):
            return p
    return None


class BinauralMelSpectrogramDataset:
    def __init__(
        self,
        mel_left_dir: str,
        mel_right_dir: str,
        audio_dir: str,
        segment_size: int = 16384,
        n_fft: int = 1024,
        num_mels: int = 80,
        hop_size: int = 256,
        win_size: int = 1024,
        sampling_rate: int = 22050,
        fmin: float = 0.0,
        fmax: Optional[float] = None,
        fmax_loss: Optional[float] = None,
        split: bool = True,
        trim_frames: int = 8,
    ):
        self.segment_size = segment_size
        self.hop_size = hop_size
        self.sampling_rate = sampling_rate
        self.split = split
        self.trim_frames = trim_frames
        self.mel_loss = _MelFrontend(
            n_fft, num_mels, sampling_rate, hop_size, win_size, fmin, fmax_loss
        )

        self.valid_files: List[Tuple[str, str, str]] = []
        for mel_left in sorted(glob.glob(os.path.join(mel_left_dir, "*.npy"))):
            base = os.path.basename(mel_left)
            mel_right = os.path.join(mel_right_dir, base)
            if not os.path.exists(mel_right):
                continue
            audio = _find_audio(audio_dir, base[: -len(".npy")])
            if audio:
                self.valid_files.append((mel_left, mel_right, audio))
        if not self.valid_files:
            raise ValueError(
                f"No matching mel-audio pairs in {mel_left_dir}, {mel_right_dir}, "
                f"{audio_dir}"
            )

    def __len__(self):
        return len(self.valid_files) * 2  # L + R interleaved

    def __getitem__(self, index):
        try:
            return self._load(index)
        except Exception as e:
            print(f"[WARNING] binaural sample {index} failed ({e}); resampling")
            return self[random.randrange(len(self))]

    def _load(self, index):
        file_index, channel = divmod(index, 2)
        mel_l, mel_r, audio_path = self.valid_files[file_index]
        mel = np.load(mel_l if channel == 0 else mel_r)

        tf = self.trim_frames
        trimmed = 0
        if mel.shape[1] > 2 * tf:
            mel = mel[:, tf:-tf]
            trimmed = tf

        stereo, _ = load_wav(audio_path, target_sr=self.sampling_rate)
        if stereo.ndim == 1:
            audio = stereo
        else:
            audio = stereo[min(channel, stereo.shape[0] - 1)]
        if trimmed:
            cut = trimmed * self.hop_size
            audio = audio[cut : len(audio) - cut]
        audio = normalize_audio(audio, 0.95)

        # align lengths: audio = frames · hop
        frames = min(mel.shape[1], len(audio) // self.hop_size)
        mel = mel[:, :frames]
        audio = audio[: frames * self.hop_size]

        if self.split:
            seg_frames = self.segment_size // self.hop_size
            if frames > seg_frames:
                start = random.randint(0, frames - seg_frames)
                mel = mel[:, start : start + seg_frames]
                audio = audio[
                    start * self.hop_size : (start + seg_frames) * self.hop_size
                ]
            else:
                mel = np.pad(mel, ((0, 0), (0, seg_frames - frames)))
                audio = np.pad(audio, (0, self.segment_size - len(audio)))

        mel_loss = self.mel_loss(audio)
        return {
            "mel": mel.astype(np.float32),
            "audio": audio.astype(np.float32),
            "filename": audio_path,
            "mel_loss": mel_loss.astype(np.float32),
        }


class BinauralCombinedDataset:
    """Scheduled-sampling dataset mixing GT-from-audio and predicted mels."""

    def __init__(
        self,
        audio_dir: str,
        pred_mel_left_dir: Optional[str] = None,
        pred_mel_right_dir: Optional[str] = None,
        segment_size: int = 16384,
        n_fft: int = 1024,
        num_mels: int = 80,
        hop_size: int = 256,
        win_size: int = 1024,
        sampling_rate: int = 22050,
        fmin: float = 0.0,
        fmax: Optional[float] = None,
        fmax_loss: Optional[float] = None,
        split: bool = True,
        use_pred_mel_schedule: bool = True,
        always_use_pred: bool = False,
        trim_frames: int = 8,
        seed: int = 1234,
    ):
        self.segment_size = segment_size
        self.hop_size = hop_size
        self.sampling_rate = sampling_rate
        self.split = split
        self.use_pred_mel_schedule = use_pred_mel_schedule
        # validation uses predicted mels ONLY
        self.always_use_pred = always_use_pred
        self.trim_frames = trim_frames
        self.current_epoch = 0
        self._rng = random.Random(seed)
        # GT mel uses the vocoder's own frontend for consistency
        self.mel_fn = _MelFrontend(
            n_fft, num_mels, sampling_rate, hop_size, win_size, fmin, fmax
        )
        self.mel_loss_fn = _MelFrontend(
            n_fft, num_mels, sampling_rate, hop_size, win_size, fmin, fmax_loss
        )

        audio_files = sorted(
            p
            for ext in _AUDIO_EXTS
            for p in glob.glob(os.path.join(audio_dir, "*" + ext))
        )
        self.items: List[Tuple[str, Optional[str], Optional[str]]] = []
        for audio in audio_files:
            base = os.path.splitext(os.path.basename(audio))[0]
            mel_l = mel_r = None
            if pred_mel_left_dir and pred_mel_right_dir:
                cand_l = os.path.join(pred_mel_left_dir, base + ".npy")
                cand_r = os.path.join(pred_mel_right_dir, base + ".npy")
                if os.path.exists(cand_l) and os.path.exists(cand_r):
                    mel_l, mel_r = cand_l, cand_r
            self.items.append((audio, mel_l, mel_r))
        if not self.items:
            raise ValueError(f"no audio files in {audio_dir}")

    # ---- curriculum ----------------------------------------------------
    def get_pred_mel_probability(self) -> float:
        if not self.use_pred_mel_schedule or not self.split:
            return 0.0
        epoch = self.current_epoch
        e_start, e_mid, e_end = 10, 30, 60
        if epoch < e_start:
            return 0.0
        if epoch < e_mid:
            return (epoch - e_start) / (e_mid - e_start) * 0.5
        if epoch < e_end:
            return 0.5 + (epoch - e_mid) / (e_end - e_mid) * 0.4
        return 1.0

    def update_epoch(self, epoch: int):
        self.current_epoch = epoch

    def __len__(self):
        return len(self.items) * 2

    def __getitem__(self, index):
        try:
            return self._load(index)
        except Exception as e:
            print(f"[WARNING] combined sample {index} failed ({e}); resampling")
            return self[self._rng.randrange(len(self))]

    def _load(self, index):
        file_index, channel = divmod(index, 2)
        audio_path, mel_l, mel_r = self.items[file_index]

        stereo, _ = load_wav(audio_path, target_sr=self.sampling_rate)
        audio = stereo if stereo.ndim == 1 else stereo[min(channel, stereo.shape[0] - 1)]
        # normalisation deliberately DISABLED

        use_pred = mel_l is not None and (
            self.always_use_pred
            or self._rng.random() < self.get_pred_mel_probability()
        )

        if use_pred:
            mel = np.load(mel_l if channel == 0 else mel_r)
            tf = self.trim_frames
            if mel.shape[1] > 2 * tf:
                mel = mel[:, tf:-tf]
                cut = tf * self.hop_size
                audio = audio[cut : len(audio) - cut]
        else:
            mel = None  # computed after the crop for GT consistency

        frames_available = (
            mel.shape[1] if mel is not None else len(audio) // self.hop_size
        )
        seg_frames = self.segment_size // self.hop_size
        if self.split:
            if frames_available > seg_frames:
                start = self._rng.randint(0, frames_available - seg_frames)
            else:
                start = 0
            audio = audio[
                start * self.hop_size : (start + seg_frames) * self.hop_size
            ]
            if len(audio) < self.segment_size:
                audio = np.pad(audio, (0, self.segment_size - len(audio)))
            if mel is not None:
                mel = mel[:, start : start + seg_frames]
                if mel.shape[1] < seg_frames:
                    mel = np.pad(mel, ((0, 0), (0, seg_frames - mel.shape[1])))

        if mel is None:
            mel = self.mel_fn(audio)
        mel_loss = self.mel_loss_fn(audio)
        return {
            "mel": mel.astype(np.float32),
            "audio": audio.astype(np.float32),
            "filename": audio_path,
            "mel_loss": mel_loss.astype(np.float32),
            "is_pred": np.float32(use_pred),
        }
