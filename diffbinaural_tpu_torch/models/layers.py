"""Small building blocks shared by the UNet and its attention stack:
parameters are float32, ``dtype`` selects the compute type (the analogue of
the ``dtype=`` argument of the flax modules)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> None:
    """Truncated-normal (+-2 sigma) init with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """Linear layer on the last axis, computed in ``dtype``."""

    def __init__(self, dim_in: int, dim_out: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in))
        self.bias = nn.Parameter(torch.zeros(dim_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Conv2dNHWC(nn.Module):
    """k x k 'same' convolution on a channels-last (B, H, W, C) tensor,
    computed in ``dtype``.  The permutes are views: the data stays
    channels-last in memory."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(
            torch.empty(dim_out, dim_in, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(dim_out))

    def kernel(self) -> torch.Tensor:
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(
            x.to(self.dtype).permute(0, 3, 1, 2),
            self.kernel().to(self.dtype),
            self.bias.to(self.dtype),
            padding=self.padding,
        )
        return y.permute(0, 2, 3, 1)


class GroupNormNHWC(nn.Module):
    """GroupNorm over a channels-last tensor (groups are contiguous channel
    blocks, statistics over space and the group's channels), eps 1e-5;
    statistics in float32, output in ``dtype``."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.groups, self.eps, self.dtype = groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xf = x.float().reshape(b, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
        out = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (out * self.weight + self.bias).to(self.dtype)
