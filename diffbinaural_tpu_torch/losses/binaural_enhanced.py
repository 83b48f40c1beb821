"""Binaural-enhanced loss — counterpart of
``diffbinaural_tpu/losses/binaural_enhanced.py`` (the JAX package's
reconstruction of a module missing from the reference: L1 plus inter-channel
coherence, temporal dynamics and stereo-difference terms on (B, 2, F, T)
mel images).  No train step calls it."""

from __future__ import annotations

import torch


def enhanced_l1_loss(pred, target, stereo_weight: float = 0.15):
    """L1 + weight x L1 on the L - R difference image (the binaural cue)."""
    base = torch.mean(torch.abs(pred - target))
    if pred.shape[1] >= 2:
        side = torch.mean(torch.abs((pred[:, 0] - pred[:, 1])
                                    - (target[:, 0] - target[:, 1])))
        base = base + stereo_weight * side
    return base


class BinauralEnhancedLoss:
    def __init__(self, coherence_weight: float = 0.2,
                 dynamics_weight: float = 0.1, stereo_weight: float = 0.15):
        self.coherence_weight = coherence_weight
        self.dynamics_weight = dynamics_weight
        self.stereo_weight = stereo_weight

    def __call__(self, pred, target, base_loss):
        """pred/target: (B, 2, F, T) mel images; base_loss: scalar."""
        loss = base_loss
        if pred.shape[1] >= 2:
            def frame_corr(x):  # per-frame L/R correlation, (B, T)
                left = x[:, 0] - x[:, 0].mean(dim=1, keepdim=True)
                right = x[:, 1] - x[:, 1].mean(dim=1, keepdim=True)
                num = (left * right).sum(dim=1)
                den = torch.sqrt((left ** 2).sum(dim=1)
                                 * (right ** 2).sum(dim=1)) + 1e-8
                return num / den

            coherence = torch.mean(torch.abs(frame_corr(pred)
                                             - frame_corr(target)))
            loss = loss + self.coherence_weight * coherence
            side = torch.mean(torch.abs((pred[:, 0] - pred[:, 1])
                                        - (target[:, 0] - target[:, 1])))
            loss = loss + self.stereo_weight * side
        dynamics = torch.mean(torch.abs(torch.diff(pred, dim=-1)
                                        - torch.diff(target, dim=-1)))
        return loss + self.dynamics_weight * dynamics
