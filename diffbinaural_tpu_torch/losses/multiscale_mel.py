"""Multi-scale mel-spectrogram loss — counterpart of
``diffbinaural_tpu/losses/multiscale_mel.py``: 7 STFT scales (windows
32 ... 2048, hop = window / 4, centred), slaney mel filterbanks with n_mels
5 ... 320, log10 of the magnitude mel clamped at 1e-5, L1 between the
log-mels summed over the scales.  Float32 throughout.

The filterbanks and windows are designed once in numpy; each scale is one
``torch.fft.rfft`` and one matmul.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..signal.stft import hann_window, mel_filterbank, stft_complex


class MultiScaleMelSpectrogramLoss:
    def __init__(
        self,
        sampling_rate: int,
        n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160, 320),
        window_lengths: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048),
        clamp_eps: float = 1e-5,
        mag_weight: float = 0.0,
        log_weight: float = 1.0,
        pow: float = 1.0,
        mel_fmin: Optional[Sequence[float]] = None,
        mel_fmax: Optional[Sequence[float]] = None,
    ):
        self.sampling_rate = sampling_rate
        self.n_mels = tuple(n_mels)
        self.window_lengths = tuple(window_lengths)
        self.clamp_eps = clamp_eps
        self.mag_weight = mag_weight
        self.log_weight = log_weight
        self.pow = pow
        self.mel_fmin = tuple(mel_fmin or (0.0,) * len(n_mels))
        self.mel_fmax = tuple(mel_fmax or (None,) * len(n_mels))
        # (n_mels, window, hop, basis (m, 1 + w/2) float32, window (w,))
        self._scales = [
            (m, w, w // 4, torch.from_numpy(mel_filterbank(sampling_rate, w, m,
                                                           lo, hi)),
             hann_window(w))
            for m, w, lo, hi in zip(self.n_mels, self.window_lengths,
                                    self.mel_fmin, self.mel_fmax)
        ]

    def _log_mel(self, wav, w, hop, basis, window):
        mag = torch.abs(stft_complex(wav, w, hop, w, center=True,
                                     window=window))   # (..., F, T)
        mel = torch.matmul(basis.to(mag.device), mag)
        return torch.log10(mel.clamp(min=self.clamp_eps) ** self.pow)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (B, C, T) estimate / reference waveforms -> scalar loss."""
        total = 0.0
        for _, w, hop, basis, window in self._scales:
            xm = self._log_mel(x, w, hop, basis, window)
            ym = self._log_mel(y, w, hop, basis, window)
            l1 = torch.mean(torch.abs(xm - ym))
            total = total + (self.log_weight + self.mag_weight) * l1
        return total
