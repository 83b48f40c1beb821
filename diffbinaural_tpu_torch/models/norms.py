"""Normalisation layers for channels-last feature maps — counterpart of
``diffbinaural_tpu/models/norms.py``.  ``PreNorm``, ``BatchNorm`` and
``ChannelRMSNorm`` have no caller in the shipped models (nor in the JAX
package's); they are kept for the inventory."""

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


class PreNorm(nn.Module):
    """``fn(ChannelLayerNorm(x), **kwargs)``; the norm is named ``norm``
    and ``fn`` keeps its own name, as in the flax tree."""

    def __init__(self, dim: int, fn: nn.Module, dtype=torch.float32):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, **kwargs):
        return self.fn(self.norm(x), **kwargs)


class BatchNorm(nn.Module):
    """Batch norm over (B, H, W) per channel of an NHWC map, with running
    statistics as buffers ``mean`` / ``var`` (the flax ``batch_stats``).

    In training mode (``use_running_average=False``) the running variance
    takes the BIASED batch variance, as the JAX module does
    (``nn.BatchNorm2d`` would take the unbiased one):
    ``stat <- momentum·batch + (1 - momentum)·stat``."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor,
                use_running_average: bool = True) -> torch.Tensor:
        xf = x.float()
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean = xf.mean(dim=(0, 1, 2))
            var = ((xf - mean) ** 2).mean(dim=(0, 1, 2))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * mean + (1 - m) * self.mean)
                self.var.copy_(m * var + (1 - m) * self.var)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        return (out * self.gamma + self.beta).to(self.dtype)


class ChannelRMSNorm(nn.Module):
    """Channels L2-normalised (norm floored at 1e-12), times g·sqrt(C)."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        out = F.normalize(x.float(), dim=-1, eps=1e-12) * self.g * (c ** 0.5)
        return out.to(self.dtype)
