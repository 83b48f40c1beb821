"""Shared CLI machinery — part of ``diffbinaural_tpu/cli/common.py``: the
model builder, the encoders' routing by family, and full-clip mel dumping.

``Stage1Trainer`` (the train / eval / checkpoint epoch loop) is not here
yet: it needs the datasets.  Where the JAX functions take a parameter tree,
these take the port's modules, which hold their weights.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.config import UnetConfig
from ..infer.stage1 import Stage1Sampler, generate_clip
from ..models import build_unet
from ..models.visual import ENCODER_REGISTRY, apply_visual, build_visual


class ModelBuilder:
    """``build_visual`` / ``build_unet`` with the JAX builder's arguments
    (``pool_type``, ``input_channel``, ``fc_out`` and ``weights`` are
    accepted and unused there too); random weights from ``seed``, on the
    card unless ``device="cpu"``."""

    def build_visual(self, pool_type="maxpool", input_channel=3, fc_out=512,
                     weights="", arch_frame="resnet18", clip_config=None, *,
                     seed=0, device=None):
        kwargs = {}
        if clip_config is not None and arch_frame.startswith("clip"):
            kwargs["clip"] = clip_config
        return build_visual(arch_frame, seed=seed, device=device, **kwargs)

    def build_unet(self, dim=64, input_nc=2, output_nc=2, weights="", *,
                   dtype=torch.float32, seed=0, device=None):
        config = UnetConfig(dim=dim, in_channels=input_nc,
                            out_channels=output_nc)
        return build_unet(config, dtype=dtype, seed=seed, device=device)


def visual_apply_fn(net, arch_frame: str):
    """``apply(frames, pos2d, mask, pos3d=None)`` -> (B, 512) for the
    encoder ``net`` of family ``arch_frame`` (``models.visual.apply_visual``
    routes it)."""
    if not isinstance(net, ENCODER_REGISTRY[arch_frame]):
        raise ValueError(f"{type(net).__name__} is not a {arch_frame!r} "
                         "encoder")

    def apply(frames, pos2d, mask, pos3d=None):
        return apply_visual(net, frames, pos2d, mask, pos3d)

    return apply


def dump_clip_mels(args, sampler: Stage1Sampler, dataset, out_left: str,
                   out_right: str, features_fn=None, generator=None,
                   max_batch: int = 32):
    """Generate a clip's L/R ln-mels and save the stage-2 ``.npy`` pair as
    ``{video_id}.npy`` in ``out_left`` / ``out_right``; returns (2, M, T).

    ``dataset``: ``full_mel`` (M, T), ``starts`` (window offsets),
    ``rows[0]["video_id"]``, ``len`` and ``[i]`` (one window's item).
    ``features_fn(item)`` -> (512,) conditioning of one window, run under
    ``torch.inference_mode``; None means zeros (the unconditional branch).
    ``args.crop_frames`` is the edge crop; the windows go through the
    sampler ``max_batch`` at a time."""
    os.makedirs(out_left, exist_ok=True)
    os.makedirs(out_right, exist_ok=True)
    if features_fn is None:
        feats = np.zeros((len(dataset), 512), np.float32)
    else:
        with torch.inference_mode():
            feats = torch.stack([
                torch.as_tensor(features_fn(dataset[i])).float().cpu()
                for i in range(len(dataset))]).numpy()
    starts = dataset.starts
    mel = generate_clip(
        sampler, dataset.full_mel[None], feats,
        stride=starts[1] - starts[0] if len(starts) > 1 else 40,
        crop_frames=args.crop_frames, generator=generator,
        max_batch=max_batch)
    base = dataset.rows[0]["video_id"]
    np.save(os.path.join(out_left, base + ".npy"), mel[0])
    np.save(os.path.join(out_right, base + ".npy"), mel[1])
    return mel
