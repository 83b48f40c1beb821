"""Audio IO + resampling on the host (numpy/scipy) — counterpart of
``diffbinaural_tpu/data/audio_io.py``: the native C++ decoder
(``diffbinaural_tpu_torch/native``) for ``.wav`` files, ``scipy.io.wavfile``
for the files it refuses and where it was not built, polyphase kaiser
resampling, and the x0.95 peak normalisation the loaders apply.

The JAX ``load_wav`` swallows every error of its native branch.  Here a
failed build is printed once and reported by ``native.available()`` /
``native.build_error()``; a file the decoder refuses goes through scipy.
"""

from __future__ import annotations

import os
from math import gcd
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from .. import native

MAX_WAV_VALUE = 32767.0


def load_wav(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """-> (audio float32 in [-1, 1], sr).  Shape (T,) mono or (C, T).

    A ``.wav`` goes through the native decoder when it is built (decode and
    int -> float conversion off the GIL); scipy reads the rest."""
    if path.lower().endswith(".wav"):
        got = native.load_wav_native(path)
        if got is not None:
            data, sr = got
            if target_sr is not None and sr != target_sr:
                data = resample(data, sr, target_sr)
                sr = target_sr
            return data, sr
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.T  # (C, T)
    if target_sr is not None and sr != target_sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return data, sr


def save_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """float [-1, 1] -> int16 WAV.  (C, T) with C <= 8 is written as C
    channels."""
    audio = np.asarray(audio)
    if audio.ndim == 2 and audio.shape[0] <= 8:
        audio = audio.T  # (T, C) for the container
    pcm = np.clip(audio * MAX_WAV_VALUE, -32768, 32767).astype(np.int16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sr, pcm)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase kaiser resampling along the last axis."""
    if orig_sr == target_sr:
        return audio
    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(
        np.float32)


def normalize_audio(audio: np.ndarray, level: float = 0.95) -> np.ndarray:
    """Peak normalisation to ``level``; silence is returned as it is."""
    peak = np.max(np.abs(audio))
    if peak < 1e-10:
        return audio.astype(np.float32)
    return (audio / peak * level).astype(np.float32)
