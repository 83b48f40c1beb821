"""ctypes bindings for the native WAV decoder (``audio_native.cpp``) —
counterpart of ``diffbinaural_tpu/native/__init__.py``, same functions.

The shared library is compiled with ``g++`` at first use into
``diffbinaural_tpu_torch/build/`` (git-ignored), named by a hash of its
source and flags as ``ops/_build.py`` names the kernels, so an edited
source is rebuilt and a stale library is never loaded; nothing is written
next to the source.  Nothing happens at import.

A build that fails is printed once, and :func:`available` then says False
and :func:`build_error` says why: ``data.audio_io.load_wav`` goes on
through scipy, and a caller that needs the decoder can tell that it did not
run.  A file the decoder refuses (not RIFF/WAVE, an unknown sample format)
makes :func:`load_wav_native` return None, and ``load_wav`` reads that
file through scipy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "audio_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None

_F32P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libaudio_native_{digest.hexdigest()[:12]}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, lib)  # atomic: concurrent builds agree
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.wav_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
    lib.wav_probe.restype = ctypes.c_int
    lib.wav_decode.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64]
    lib.wav_decode.restype = ctypes.c_int64
    lib.peak_normalize.argtypes = [_F32P, ctypes.c_int64, ctypes.c_float]
    lib.peak_normalize.restype = None
    lib.resample_poly.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _F32P,
        ctypes.c_float, ctypes.c_int32]
    lib.resample_poly.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if need be; None if the build or
    the load failed (reported once, see :func:`build_error`)."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = library_path()
            if not lib.exists():
                _build(lib)
            _lib = _bind(ctypes.CDLL(str(lib)))
        except subprocess.CalledProcessError as exc:
            _error = f"g++ failed (rc={exc.returncode}): {exc.stderr.strip()}"
        except (OSError, subprocess.SubprocessError) as exc:
            _error = f"{type(exc).__name__}: {exc}"
        if _error is not None:
            print(f"[native] the WAV decoder was not built ({_error}); "
                  "load_wav reads every file through scipy", flush=True)
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is not available, after :func:`get_lib` tried."""
    get_lib()
    return _error


def load_wav_native(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """-> (audio float32 (T,) or (C, T), sr), or None when the library is
    not available or refuses the file."""
    lib = get_lib()
    if lib is None:
        return None
    ch, sr, frames = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    if lib.wav_probe(os.fsencode(path), ctypes.byref(ch), ctypes.byref(sr),
                     ctypes.byref(frames)) != 0:
        return None
    out = np.empty((ch.value, frames.value), np.float32)
    n = lib.wav_decode(os.fsencode(path), out.ctypes.data_as(_F32P),
                       frames.value)
    if n < 0:
        return None
    out = out[:, :n]
    return (out[0] if ch.value == 1 else out), sr.value


def peak_normalize_native(x: np.ndarray, level: float = 0.95) -> np.ndarray:
    """Peak normalisation to ``level`` (in place on a float32 C-contiguous
    array); numpy when the library is not available."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        peak = np.abs(x).max()
        return x if peak < 1e-10 else x / peak * level
    lib.peak_normalize(x.ctypes.data_as(_F32P), x.size, level)
    return x


def resample_native(x: np.ndarray, up: int, down: int, beta: float = 8.555,
                    half_taps: int = 10) -> Optional[np.ndarray]:
    """Polyphase kaiser-sinc resampling of a 1-D signal by ``up / down``;
    None when the library is not available."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty((len(x) * up + down - 1) // down, np.float32)
    n = lib.resample_poly(x.ctypes.data_as(_F32P), len(x), up, down,
                          out.ctypes.data_as(_F32P), beta, half_taps)
    return out[:n] if n > 0 else None
