"""The port's models and the functions that construct them.

``build_unet`` / ``build_vocoder`` / ``build_visual`` return a module in
eval mode with random weights drawn from ``seed`` (the distributions of the
JAX package's initialisers), on the card unless ``device="cpu"`` is passed;
``build_discriminators`` returns the config-driven pair of stage-2
discriminators the same way.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..core.config import UnetConfig, VocoderConfig
from ..core.device import resolve_device
from .discriminators import (
    CombinedDiscriminator,
    MultiBandDiscriminator,
    MultiPeriodDiscriminator,
    MultiResolutionDiscriminator,
    MultiScaleSubbandCQTDiscriminator,
    init_discriminator,
)
from .bigvgan import (
    BigVGAN,
    BinauralBigVGAN,
    WNConv1d,
    WNConvTranspose1d,
    remove_weight_norm,
)
from .layers import Conv2dNHWC, Dense, lecun_normal_
from .norms import ChannelLayerNorm, ChannelRMSNorm
from .unet import AudioVisualModel, Unet
from .visual import ENCODER_REGISTRY, apply_visual, build_visual


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


def build_discriminators(h, dtype=torch.float32, seed: int = 0, device=None):
    """The config-driven pair ``(mpd, mrd)`` of the stage-2 GAN (the JAX
    package's ``cli/gan_common.py:build_discriminators``): the
    multi-period discriminator over ``mpd_reshapes``, and as ``mrd`` the
    sub-band CQT discriminator when ``use_cqtd_instead_of_mrd`` (the
    production config), else the multi-band one when
    ``use_mbd_instead_of_mrd``, else the multi-resolution one.  ``dtype``
    is the convolutions' compute type only (parameters float32; the
    spectral frontends and the GAN losses stay float32)."""
    device = resolve_device(device)
    mpd = MultiPeriodDiscriminator(
        periods=tuple(h.get("mpd_reshapes", [2, 3, 5, 7, 11])),
        channel_mult=h.get("discriminator_channel_mult", 1), dtype=dtype)
    if h.get("use_cqtd_instead_of_mrd", False):
        mrd = MultiScaleSubbandCQTDiscriminator(
            sampling_rate=h["sampling_rate"],
            hop_lengths=tuple(h.get("cqtd_hop_lengths", [512, 256, 256])),
            n_octaves=tuple(h.get("cqtd_n_octaves", [9, 9, 9])),
            bins_per_octaves=tuple(h.get("cqtd_bins_per_octaves",
                                         [24, 36, 48])),
            filters=h.get("cqtd_filters", 32), dtype=dtype)
    elif h.get("use_mbd_instead_of_mrd", False):
        mrd = MultiBandDiscriminator(
            fft_sizes=tuple(h.get("mbd_fft_sizes", [2048, 1024, 512])),
            dtype=dtype)
    else:
        mrd = MultiResolutionDiscriminator(
            resolutions=tuple(tuple(r) for r in h["resolutions"]),
            channel_mult=h.get("discriminator_channel_mult", 1), dtype=dtype)
    return (init_discriminator(mpd, seed).to(device),
            init_discriminator(mrd, seed + 1).to(device))


__all__ = [
    "AudioVisualModel", "BigVGAN", "BinauralBigVGAN", "ChannelLayerNorm",
    "ChannelRMSNorm", "CombinedDiscriminator",
    "ENCODER_REGISTRY", "MultiBandDiscriminator", "MultiPeriodDiscriminator",
    "MultiResolutionDiscriminator", "MultiScaleSubbandCQTDiscriminator",
    "Unet", "apply_visual", "build_discriminators", "build_unet",
    "build_visual", "build_vocoder",
    "init_discriminator", "init_parameters", "remove_weight_norm",
]
