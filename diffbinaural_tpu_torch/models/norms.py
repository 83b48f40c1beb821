"""Normalisation layers for channels-last feature maps."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ChannelLayerNorm(nn.Module):
    """Gain-only LayerNorm over the last (channel) axis, biased variance,
    eps 1e-5; statistics in float32, output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.g.shape, self.g, None, self.eps)
        return out.to(self.dtype)
