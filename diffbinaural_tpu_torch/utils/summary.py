"""TensorBoard logging — counterpart of ``diffbinaural_tpu/utils/summary.py``:
scalars, ln-mel figures at the fixed -12..2.5 scale, and audio clips,
through tensorboardX when it is installed and a no-op otherwise.  Stage 1
writes to ``{ckpt}/{id}/runs``, stage 2 to ``{checkpoint_path}/logs``.

``mel_figure`` builds its figure only when a writer exists, so without
tensorboardX it writes nothing and needs no matplotlib; ``audio`` skips a
clip when tensorboardX cannot encode it (no ``soundfile``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SummaryLogger:
    def __init__(self, log_dir: Optional[str]):
        """``log_dir`` None: a logger that writes nothing (the ranks of a
        data-parallel job other than rank 0)."""
        self._w = None
        if log_dir is None:
            return
        try:
            from tensorboardX import SummaryWriter

            self._w = SummaryWriter(log_dir)
        except Exception:  # tensorboardX missing or broken: no-op
            self._w = None

    def scalar(self, tag: str, value: float, step: int):
        if self._w:
            self._w.add_scalar(tag, float(value), step)

    def figure(self, tag: str, fig, step: int):
        if self._w:
            self._w.add_figure(tag, fig, step)

    def mel_figure(self, tag: str, mel: np.ndarray, step: int,
                   vmin: float = -12.0, vmax: float = 2.5):
        if self._w:
            from .helpers import plot_spectrogram_fixed

            self.figure(tag, plot_spectrogram_fixed(mel, vmin, vmax), step)

    def audio(self, tag: str, wav: np.ndarray, step: int, sr: int = 22050):
        """tensorboardX encodes audio with ``soundfile``; without it the
        clip is skipped (the JAX logger raises there)."""
        if self._w:
            try:
                self._w.add_audio(tag, wav[None] if wav.ndim == 1 else wav,
                                  step, sample_rate=sr)
            except ImportError:
                pass

    def flush(self):
        if self._w:
            self._w.flush()

    def close(self):
        if self._w:
            self._w.close()
