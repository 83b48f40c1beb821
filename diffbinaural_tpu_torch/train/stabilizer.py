"""Host-side training stabilisation — the port's own copy of
``diffbinaural_tpu/train/stabilizer.py`` (plain Python on scalars the train
step already returned): gradient-norm bookkeeping (the clipping itself runs
inside the train step), loss smoothing + anomaly detection, plateau LR
reduction, and the façade called once per step.  ``memory_report`` reads the
card's allocator and nothing on the CPU.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch


class LossStabilizer:
    def __init__(self, smoothing_factor: float = 0.99,
                 anomaly_threshold: float = 10.0):
        self.smoothing_factor = smoothing_factor
        self.anomaly_threshold = anomaly_threshold
        self.loss_history: list[float] = []
        self.smoothed_loss: Optional[float] = None

    def update_and_check(self, loss_value: float) -> Dict[str, Any]:
        self.loss_history.append(loss_value)
        if self.smoothed_loss is None:
            self.smoothed_loss = loss_value
        else:
            self.smoothed_loss = (
                self.smoothing_factor * self.smoothed_loss
                + (1 - self.smoothing_factor) * loss_value
            )
        is_anomaly = False
        if len(self.loss_history) > 10:
            # the 10 PRIOR losses: were the new one part of the average,
            # `loss > 10 * mean(..., loss)` could never hold for positive
            # losses
            recent = float(np.mean(self.loss_history[-11:-1]))
            if loss_value > recent * self.anomaly_threshold:
                is_anomaly = True
                warnings.warn(
                    f"Anomalous loss detected: {loss_value:.6f} "
                    f"(recent avg: {recent:.6f})"
                )
        return {
            "loss": loss_value,
            "smoothed_loss": self.smoothed_loss,
            "is_anomaly": is_anomaly,
            "loss_std": float(np.std(self.loss_history[-100:]))
            if len(self.loss_history) > 10
            else 0.0,
        }


class LearningRateStabilizer:
    """Plateau LR reduction; emits the multiplicative scale the trainer
    writes into the train state's ``lr_scale``."""

    def __init__(self, patience: int = 10, factor: float = 0.5,
                 min_scale: float = 1e-4):
        self.patience = patience
        self.factor = factor
        self.min_scale = min_scale
        self.wait = 0
        self.best_loss = float("inf")
        self.scale = 1.0

    def step(self, val_loss: float) -> Dict[str, Any]:
        reduced = False
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                if self.scale > self.min_scale:
                    self.scale = max(self.scale * self.factor, self.min_scale)
                    reduced = True
                self.wait = 0
        return {
            "lr_reduced": reduced,
            "lr_scale": self.scale,
            "best_loss": self.best_loss,
            "patience_wait": self.wait,
        }


class TrainingStabilizer:
    """Façade called once per host step with already-computed scalars."""

    def __init__(self, clip_norm: float = 1.0, loss_smoothing: float = 0.99,
                 anomaly_threshold: float = 10.0, lr_patience: int = 10):
        self.clip_norm = clip_norm
        self.loss_stab = LossStabilizer(loss_smoothing, anomaly_threshold)
        self.lr_stab = LearningRateStabilizer(patience=lr_patience)
        self.grad_norms: list[float] = []

    def training_step(self, loss: float, grad_norm: float) -> Dict[str, Any]:
        self.grad_norms.append(grad_norm)
        report = self.loss_stab.update_and_check(loss)
        report["grad_norm"] = grad_norm
        report["avg_grad_norm"] = float(np.mean(self.grad_norms[-100:]))
        return report

    def validation_step(self, val_loss: float) -> Dict[str, Any]:
        return self.lr_stab.step(val_loss)

    def memory_report(self, device=None) -> Dict[str, int]:
        """Bytes the allocator holds on the card (now, at the peak, and
        reserved); empty for the CPU or when there is no card."""
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda" if device is None else device)
        if device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(device)
        return {
            "allocated_bytes": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(device)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
        }
