"""Mono vocoder dataset (the stage-2 ground-truth path) — counterpart of
``diffbinaural_tpu/data/meldataset.py``: file-list parsing, a random
segment crop, resampling to the target rate, peak normalisation x0.95, the
training mel and a separate loss mel (``fmax_loss``), the fine-tuning path
on precomputed mels, and a corrupt sample replaced by a random other one.

The mel frontend is the port's ``signal.stft.mel_spectrogram`` on CPU
tensors in float32, whatever device the trainer uses: loading is host work
(the JAX frontend pins ``jax.devices("cpu")`` for the same reason), and a
loader thread never touches CUDA.  Each call runs at its thread's torch
intra-op setting; ``data.loader.DataLoader``'s workers set theirs to 1, so
that the workers, not torch's thread pool, are the parallelism.

Randomness is the stdlib's, in the JAX package's calls and order: the file
order from ``random.Random(seed)``, the crops from the global ``random``
module.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..signal.stft import mel_spectrogram
from .audio_io import load_wav, normalize_audio


def get_dataset_filelist(
    input_training_file: str,
    input_validation_file: str,
    input_wavs_dir: str,
    ext: str = ".wav",
) -> Tuple[List[str], List[str]]:
    """The ``name|...`` lines of the two list files -> wav paths under
    ``input_wavs_dir``."""

    def read(f):
        with open(f, "r", encoding="utf-8") as fi:
            return [
                os.path.join(input_wavs_dir, x.split("|")[0] + ext)
                for x in fi.read().split("\n")
                if len(x) > 0
            ]

    return read(input_training_file), read(input_validation_file)


class _MelFrontend:
    """ln-mel of a 1-D float waveform on the CPU, float32 numpy out."""

    def __init__(self, n_fft, num_mels, sampling_rate, hop_size, win_size,
                 fmin, fmax):
        self.args = (n_fft, num_mels, sampling_rate, hop_size, win_size,
                     fmin, fmax)

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        y = torch.from_numpy(np.ascontiguousarray(wav, np.float32)[None])
        with torch.inference_mode():
            return mel_spectrogram(y, *self.args)[0].numpy()


class MelDataset:
    """Indexable; pair with ``data.loader.DataLoader`` for batching and
    prefetch."""

    def __init__(
        self,
        training_files: List[str],
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
        shuffle: bool = True,
        fine_tuning: bool = False,
        base_mels_path: Optional[str] = None,
        seed: int = 1234,
    ):
        self.audio_files = list(training_files)
        if shuffle:
            random.Random(seed).shuffle(self.audio_files)
        self.segment_size = segment_size
        self.sampling_rate = sampling_rate
        self.hop_size = hop_size
        self.split = split
        self.fine_tuning = fine_tuning
        self.base_mels_path = base_mels_path
        self.mel = _MelFrontend(
            n_fft, num_mels, sampling_rate, hop_size, win_size, fmin, fmax
        )
        self.mel_loss = _MelFrontend(
            n_fft, num_mels, sampling_rate, hop_size, win_size, fmin, fmax_loss
        )

    def __len__(self):
        return len(self.audio_files)

    def __getitem__(self, index):
        try:
            return self._load(index)
        except Exception as e:  # a corrupt file -> a random other sample
            print(f"[WARNING] {self.audio_files[index]} failed ({e}); resampling")
            return self[random.randrange(len(self))]

    def _load(self, index):
        path = self.audio_files[index]
        audio, _sr = load_wav(path, target_sr=self.sampling_rate)
        if audio.ndim == 2:
            audio = audio.mean(axis=0)
        audio = normalize_audio(audio, 0.95)

        if not self.fine_tuning:
            if self.split:
                if len(audio) >= self.segment_size:
                    start = random.randint(0, len(audio) - self.segment_size)
                    audio = audio[start : start + self.segment_size]
                else:
                    audio = np.pad(audio, (0, self.segment_size - len(audio)))
            mel = self.mel(audio)
        else:
            base = os.path.splitext(os.path.basename(path))[0]
            mel = np.load(os.path.join(self.base_mels_path, base + ".npy"))
            if self.split:
                frames = self.segment_size // self.hop_size
                if mel.shape[1] >= frames:
                    start = random.randint(0, mel.shape[1] - frames)
                    mel = mel[:, start : start + frames]
                    audio = audio[
                        start * self.hop_size : (start + frames) * self.hop_size
                    ]
                else:
                    mel = np.pad(mel, ((0, 0), (0, frames - mel.shape[1])))
                    audio = np.pad(audio, (0, self.segment_size - len(audio)))

        mel_loss = self.mel_loss(audio)
        return {
            "mel": mel.astype(np.float32),
            "audio": audio.astype(np.float32),
            "filename": path,
            "mel_loss": mel_loss.astype(np.float32),
        }
