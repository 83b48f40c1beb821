"""Training and inference helpers (numpy, scipy; matplotlib and ffmpeg
where a function needs them) — counterpart of
``diffbinaural_tpu/utils/helpers.py``: ``AverageMeter``, the
log-frequency ``warpgrid``, ``istft_reconstruction``, spectrogram figures
at the fixed ln-mel -12..2.5 scale, min-max / RMS normalisation,
``makedirs``, ``magnitude2heatmap``, and the ffmpeg ``VideoWriter`` /
``combine_video_audio`` behind an ffmpeg presence check.  matplotlib is
imported inside the plotting functions only.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.initialized = False
        self.val = None
        self.avg = None
        self.sum = None
        self.count = None

    def initialize(self, val, weight):
        self.val = val
        self.avg = val
        self.sum = val * weight
        self.count = weight
        self.initialized = True

    def update(self, val, weight=1):
        if not self.initialized:
            self.initialize(val, weight)
        else:
            self.val = val
            self.sum += val * weight
            self.count += weight
            self.avg = self.sum / self.count

    def value(self):
        return self.val

    def average(self):
        return self.avg


def warpgrid(bs: int, HO: int, WO: int, warp: bool = True) -> np.ndarray:
    """Log-frequency warp grid for grid_sample-style resampling."""
    grid = np.zeros((bs, HO, WO, 2), dtype=np.float32)
    grid_x, grid_y = np.meshgrid(np.linspace(-1, 1, WO), np.linspace(-1, 1, HO))
    grid[:, :, :, 0] = grid_x
    if warp:
        grid[:, :, :, 1] = (np.power(21, (grid_y + 1) / 2) - 11) / 10
    else:
        grid[:, :, :, 1] = np.log(grid_y * 10 + 11) / np.log(21) * 2 - 1
    return grid


def istft_reconstruction(mag: np.ndarray, phase: np.ndarray,
                         hop_length: int = 256, win_length: int = 1024,
                         length: Optional[int] = None) -> np.ndarray:
    """|S|·e^{jφ} → waveform via overlap-add inverse STFT."""
    from scipy.signal import istft as _istft

    spec = mag * np.exp(1j * phase)
    n_fft = 2 * (spec.shape[0] - 1)
    _, wav = _istft(
        spec, nperseg=win_length, noverlap=win_length - hop_length,
        nfft=n_fft, input_onesided=True, boundary=True,
    )
    wav = np.clip(wav, -1.0, 1.0).astype(np.float32)
    if length is not None:
        wav = wav[:length]
    return wav


def makedirs(path: str, remove: bool = False):
    if os.path.isdir(path):
        if remove:
            shutil.rmtree(path)
        else:
            return
    os.makedirs(path, exist_ok=True)


def magnitude2heatmap(mag: np.ndarray, log: bool = True,
                      scale: float = 200.0) -> np.ndarray:
    if log:
        mag = np.log10(mag + 1.0)
    mag *= scale
    mag[mag > 255] = 255
    mag = mag.astype(np.uint8)
    import matplotlib

    cm = matplotlib.colormaps["jet"]
    return (cm(mag / 255.0)[..., :3] * 255).astype(np.uint8)


def plot_spectrogram(spectrogram: np.ndarray):
    """Auto-scaled figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    fig.canvas.draw()
    plt.close(fig)
    return fig


def plot_spectrogram_fixed(spectrogram: np.ndarray, vmin: float = -12.0,
                           vmax: float = 2.5):
    """Fixed ln-mel-range figure (the stage-2 trainer passes −11..2)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower",
                   interpolation="none", vmin=vmin, vmax=vmax)
    plt.colorbar(im, ax=ax)
    fig.canvas.draw()
    plt.close(fig)
    return fig


def normalize_audio_pair(a: np.ndarray, b: np.ndarray):
    """Joint min-max pair normalisation."""
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    scale = max(abs(lo), abs(hi)) + 1e-8
    return a / scale, b / scale


def rms_normalize(audio: np.ndarray, target_rms: float = 0.1) -> np.ndarray:
    rms = np.sqrt(np.mean(audio**2))
    return audio * (target_rms / (rms + 1e-8))


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


class VideoWriter:
    """Frame-by-frame video writer through an ffmpeg pipe."""

    def __init__(self, path: str, fps: float = 8.0):
        if not have_ffmpeg():
            raise RuntimeError("ffmpeg not available")
        self.path = path
        self.fps = fps
        self._proc = None
        self._shape = None

    def add_frame(self, frame: np.ndarray):
        """frame: (H, W, 3) uint8 RGB."""
        if self._proc is None:
            h, w = frame.shape[:2]
            self._shape = (h, w)
            self._proc = subprocess.Popen(
                ["ffmpeg", "-y", "-loglevel", "quiet", "-f", "rawvideo",
                 "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(self.fps),
                 "-i", "-", "-c:v", "libx264", "-pix_fmt", "yuv420p",
                 self.path],
                stdin=subprocess.PIPE,
            )
        assert frame.shape[:2] == self._shape
        self._proc.stdin.write(frame.astype(np.uint8).tobytes())

    def close(self):
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
            self._proc = None


def combine_video_audio(src_video: str, src_audio: str, dst_video: str,
                        verbose: bool = False):
    if not have_ffmpeg():
        raise RuntimeError("ffmpeg not available")
    cmd = ["ffmpeg", "-y", "-loglevel", "quiet", "-i", src_video, "-i",
           src_audio, "-c:v", "copy", "-c:a", "aac", "-strict", "experimental",
           dst_video]
    subprocess.check_call(cmd)
