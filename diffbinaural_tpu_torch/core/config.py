"""Config ingestion: JSON + AttrDict, ``build_env``, and the typed
dataclasses of the inference and stage-1 training paths and of the CLIP
towers.  Own copy of
the framework-free definitions in ``diffbinaural_tpu/core/config.py`` — the
port never imports that package.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass


class AttrDict(dict):
    """dict with attribute access (the vocoder JSON configs use it)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self


def load_hparams_from_json(path) -> AttrDict:
    with open(path) as f:
        return AttrDict(json.load(f))


def build_env(config, config_name, path):
    """Copy the config file ``config`` into the checkpoint directory
    ``path`` as ``config_name`` (unless it is that file already)."""
    t_path = os.path.join(path, config_name)
    if config != t_path:
        os.makedirs(path, exist_ok=True)
        shutil.copyfile(config, t_path)


@dataclass(frozen=True)
class AudioConfig:
    """Shared audio-frontend parameters (22.05 kHz, 1024-point STFT, hop
    256, 80 mel bands) and the ln-mel range of the stage-1 wrappers."""

    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    num_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None  # None -> sr/2

    mel_min: float = -12.0
    mel_max: float = 2.5


@dataclass(frozen=True)
class DiffusionConfig:
    """Stage-1 diffusion hyperparameters."""

    image_size: int = 80
    timesteps: int = 1000
    sampling_timesteps: int = 25
    beta_schedule: str = "cosine"
    objective: str = "pred_noise"
    loss_type: str = "l1"
    ddim_sampling_eta: float = 0.0
    p2_loss_weight_gamma: float = 0.0
    p2_loss_weight_k: float = 1.0
    cfg_drop_prob: float = 0.1
    self_condition: bool = True


@dataclass(frozen=True)
class UnetConfig:
    """Stage-1 UNet (dim 64, 2 in / 2 out channels, dims 64-64-128-256)."""

    dim: int = 64
    in_channels: int = 2
    out_channels: int = 2
    dim_mults: tuple = (1, 2, 4)
    resnet_block_groups: int = 8
    attn_heads: int = 4
    attn_dim_head: int = 32
    context_dim: int = 512
    dropout: float = 0.1
    linear_attn_resolution: int = 4


@dataclass(frozen=True)
class VocoderConfig:
    """BigVGAN generator (22 kHz, 80 bands, 256x)."""

    num_mels: int = 80
    upsample_rates: tuple = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock: str = "1"
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_tanh_at_final: bool = False
    use_bias_at_final: bool = False

    @classmethod
    def from_attrdict(cls, h) -> "VocoderConfig":
        # a JSON config that omits the two final-layer flags means the
        # upstream defaults (tanh, bias) — NOT the dataclass defaults above
        return cls(
            num_mels=h["num_mels"],
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock=str(h.get("resblock", "1")),
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in h["resblock_dilation_sizes"]
            ),
            activation=h.get("activation", "snakebeta"),
            snake_logscale=h.get("snake_logscale", True),
            use_tanh_at_final=h.get("use_tanh_at_final", True),
            use_bias_at_final=h.get("use_bias_at_final", True),
        )


@dataclass(frozen=True)
class CLIPConfig:
    """ViT-B/32 image tower (``clip.load("ViT-B/32")``'s visual half)."""

    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512


@dataclass(frozen=True)
class CLIPTextConfig:
    """ViT-B/32 text tower (CLIP's ``encode_text``)."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    output_dim: int = 512
