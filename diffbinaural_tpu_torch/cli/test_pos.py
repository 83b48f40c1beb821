"""The legacy position-conditioned tester (log1p normalisation) —
counterpart of ``diffbinaural_tpu/cli/test_pos.py``, same flags:
log1p(mel)·0.167 in, exp(|pred| / 0.167) − 1 out, 50 DDIM steps on zero
visual features, overlap-average WITHOUT the edge crop, and the newest
numbered ``unet_0*`` checkpoint of ``{ckpt}/{id}`` unless
``--weights_unet`` names one.

As in the JAX CLI, each window is sampled from the diffusion directly, so
``infer.stage1.normalize_mel`` is NOT applied (the legacy normalisation
takes its place), and every window starts from the same x_T: the
generator is reseeded to 13 before each one.

Run: python -m diffbinaural_tpu_torch.cli.test_pos --list_test ... \\
       --data_root data --ckpt ckpt --id pos

``main(argv, device="cpu")`` runs it on the CPU; by default it runs on the
card and raises without one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..convert import unet_params_from_flax
from ..core import checkpoint as ckpt
from ..core.config import UnetConfig
from ..core.device import resolve_device
from ..core.precision import full_precision
from ..data import GenAudioPosDataset
from ..data.stage1 import load_split_csv
from ..diffusion import GaussianDiffusion
from ..infer.stage1 import Stage1Sampler
from ..models import build_unet
from .arguments import ArgParser

LOG_SCALE = 0.167


def legacy_normalize(mel_linear: np.ndarray) -> np.ndarray:
    return np.log1p(mel_linear) * LOG_SCALE


def legacy_denormalize(pred: np.ndarray) -> np.ndarray:
    return np.exp(np.abs(pred) / LOG_SCALE) - 1.0


@full_precision()
def generate_legacy(sampler: Stage1Sampler, dataset,
                    generator: torch.Generator = None) -> np.ndarray:
    """(2, M, T) linear mels of a ``GenAudioPosDataset`` clip: each window
    through ``sampler.diffusion.ddim_sample`` over ``sampler.model`` with
    ``generator`` (one on the sampler's device by default) reseeded to 13,
    overlap-averaged without cropping."""
    device = sampler.device
    if generator is None:
        generator = torch.Generator(device=device)
    total = dataset.total_time_frame
    m = dataset.n_mels
    mel = np.zeros((2, m, total), np.float32)
    count = np.zeros((2, m, total), np.float32)
    feat = torch.zeros((1, 512), device=device)
    for i in range(len(dataset)):
        item = dataset[i]
        norm = legacy_normalize(item["mono_mel"])  # linear mel in
        generator.manual_seed(13)
        pred = sampler.diffusion.ddim_sample(
            sampler.model, (torch.from_numpy(norm[None]).to(device), feat),
            generator=generator)
        pred = legacy_denormalize(pred.float().cpu().numpy()[0])
        start = int(item["start_time_frame"])
        t = min(pred.shape[-1], total - start)
        mel[:, :, start: start + t] += pred[:, :, :t]
        count[:, :, start: start + t] += 1.0
    return mel / np.clip(count, 1.0, None)


def main(argv=None, *, device=None):
    args = ArgParser().parse_test_arguments(argv)
    device = resolve_device(device)
    net_unet = build_unet(UnetConfig(dim=64), device=device)
    diffusion = GaussianDiffusion(
        image_size=80, timesteps=1000, sampling_timesteps=50,
        beta_schedule="cosine", auto_normalize=False, device=device,
    )
    sampler = Stage1Sampler(net_unet, diffusion, sampling_timesteps=50,
                            device=device)
    exp_dir = os.path.join(args.ckpt, args.id)
    unet_cp = args.weights_unet or ckpt.scan_checkpoint(exp_dir, "unet_0")
    net_unet.load_state_dict(
        unet_params_from_flax(ckpt.load_checkpoint(unet_cp)), strict=True)

    os.makedirs(args.output_dir_left, exist_ok=True)
    os.makedirs(args.output_dir_right, exist_ok=True)
    for row in load_split_csv(args.list_test):
        vid = row["video_id"]
        wav = vid if os.path.exists(vid) else os.path.join(
            args.data_root, vid + ".wav"
        )
        ds = GenAudioPosDataset(wav, n_mels=args.num_mels)
        mel = generate_legacy(sampler, ds)
        base = os.path.splitext(os.path.basename(wav))[0]
        np.save(os.path.join(args.output_dir_left, base + ".npy"), mel[0])
        np.save(os.path.join(args.output_dir_right, base + ".npy"), mel[1])
        print(f"{vid}: {mel.shape}")


if __name__ == "__main__":
    main()
