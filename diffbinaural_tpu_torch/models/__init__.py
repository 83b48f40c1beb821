"""The port's models and the functions that construct them.

``build_unet`` / ``build_vocoder`` return a module in eval mode with random
weights drawn from ``seed`` (the distributions of the JAX package's
initialisers), on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..core.config import UnetConfig, VocoderConfig
from ..core.device import resolve_device
from .bigvgan import (
    BigVGAN,
    BinauralBigVGAN,
    WNConv1d,
    WNConvTranspose1d,
    remove_weight_norm,
)
from .layers import Conv2dNHWC, Dense, lecun_normal_
from .unet import AudioVisualModel, Unet


@torch.no_grad()
def init_parameters(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from ``seed``: truncated-normal with variance 1/fan_in
    for dense and 2-D conv kernels, N(0, 0.01^2) for the weight-normed 1-D
    kernels (conv_pre: variance 1/fan_in) with g = ||v||; biases, norm gains
    and snake parameters keep their constructor values."""
    gen = torch.Generator().manual_seed(seed)
    for name, m in module.named_modules():
        if isinstance(m, Dense):
            lecun_normal_(m.weight, m.weight.shape[1], gen)
        elif isinstance(m, Conv2dNHWC):
            lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, (WNConv1d, WNConvTranspose1d)):
            if name.endswith("conv_pre"):
                lecun_normal_(m.v, m.v[0].numel(), gen)
            else:
                m.v.normal_(0.0, 0.01, generator=gen)
            m.g.copy_(torch.sqrt((m.v * m.v).sum(dim=(1, 2))))
    final = getattr(getattr(module, "net_unet", module), "final_conv", None)
    if isinstance(final, Dense):  # He-normal on the output projection
        final.weight.normal_(0.0, math.sqrt(2.0 / final.weight.shape[1]),
                             generator=gen)
    return module


def build_unet(config: UnetConfig = UnetConfig(), dtype=torch.float32,
               seed: int = 0, device=None) -> AudioVisualModel:
    """The stage-1 denoiser at ``config``'s widths, ``dtype`` the compute
    type (parameters stay float32).  Returned in ``eval()`` mode with
    parameters that require grad: the stage-1 train step trains it as it
    is, with dropout off, as the JAX train step does."""
    device = resolve_device(device)
    model = AudioVisualModel(
        dim=config.dim, input_nc=config.in_channels,
        output_nc=config.out_channels, dropout=config.dropout, dtype=dtype,
        dim_mults=tuple(config.dim_mults),
        resnet_block_groups=config.resnet_block_groups,
        attn_heads=config.attn_heads, attn_dim_head=config.attn_dim_head,
        context_dim=config.context_dim,
    )
    return init_parameters(model, seed).to(device).eval()


def build_vocoder(config: VocoderConfig = VocoderConfig(),
                  dtype=torch.float32, seed: int = 0, device=None) -> BigVGAN:
    """The BigVGAN generator at ``config``'s widths."""
    device = resolve_device(device)
    return init_parameters(BigVGAN(config, dtype=dtype), seed).to(device).eval()


__all__ = [
    "AudioVisualModel", "BigVGAN", "BinauralBigVGAN", "Unet", "build_unet",
    "build_vocoder", "init_parameters", "remove_weight_norm",
]
