"""Stage 1 over a test split: the full-clip L/R ln-mels of every test clip,
for stage 2 — counterpart of ``diffbinaural_tpu/cli/test_realbinaural.py``,
same flags.  The file list is the CSV's ``video_id`` column; the weights
are ``{ckpt}/{id}/unet_best.pth`` and ``frame_best.pth`` (or
``--weights_unet`` / ``--weights_frame``), flax msgpack as the JAX
trainers write them; each clip's overlap-averaged mels go to
``{output_dir_left}/{base}.npy`` and ``{output_dir_right}/{base}.npy``.

The UNet is the dim-64 model in float32 under DDIM-25 (x_T from seed 13
per window group, as ``Stage1Sampler`` draws it); where the frame
checkpoint exists, every window is conditioned on the ``--arch_frame``
encoder's feature of its frames, else on zeros.

Run: python -m diffbinaural_tpu_torch.cli.test_realbinaural \\
       --data_root data --list_test data/splits/test.csv --ckpt ckpt \\
       --id realBinaural --arch_frame clip_pos2d \\
       --output_dir_left mels/left --output_dir_right mels/right

``main(argv, device="cpu")`` runs it on the CPU; by default it runs on the
card and raises without one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..convert import unet_params_from_flax, visual_params_from_flax
from ..core import checkpoint as ckpt
from ..core.config import UnetConfig
from ..core.device import resolve_device
from ..data import GenAudioRealBinauralDataset
from ..data.stage1 import load_split_csv
from ..diffusion import GaussianDiffusion
from ..infer.stage1 import Stage1Sampler
from ..models import build_unet
from ..models.visual import build_visual
from .arguments import ArgParser
from .common import dump_clip_mels, visual_apply_fn


def build_inference(args, mel_key="mono_mel", *, device=None):
    """-> (sampler, feats_fn): the dim-64 float32 UNet with the checkpoint's
    weights under DDIM-25, and, where the frame checkpoint exists,
    ``feats_fn(item)`` -> (512,) on the device (the ``--arch_frame``
    encoder on the window's frames, ``pos_data`` for ``clip_pos``,
    ``2d_pos_data`` otherwise); None without it (zero conditioning).
    ``mel_key`` is unused, as in the JAX CLI."""
    device = resolve_device(device)
    net_unet = build_unet(UnetConfig(dim=64), device=device)
    diffusion = GaussianDiffusion(
        image_size=80, timesteps=1000, sampling_timesteps=25,
        beta_schedule="cosine", auto_normalize=False, device=device,
    )
    sampler = Stage1Sampler(net_unet, diffusion, device=device)

    exp_dir = os.path.join(args.ckpt, args.id)
    unet_path = args.weights_unet or os.path.join(exp_dir, "unet_best.pth")
    frame_path = args.weights_frame or os.path.join(exp_dir, "frame_best.pth")
    net_unet.load_state_dict(
        unet_params_from_flax(ckpt.load_checkpoint(unet_path)), strict=True)
    feats_fn = None
    if os.path.exists(frame_path):
        net_frame = build_visual(args.arch_frame, device=device)
        net_frame.load_state_dict(
            visual_params_from_flax(ckpt.load_checkpoint(frame_path)),
            strict=True)
        apply = visual_apply_fn(net_frame, args.arch_frame)

        def feats_fn(item):
            pos = (item["pos_data"] if args.arch_frame == "clip_pos"
                   else item["2d_pos_data"])
            inputs = (torch.from_numpy(np.ascontiguousarray(a))[None]
                      .to(device) for a in (item["frames"], pos,
                                            item["mask"]))
            with torch.inference_mode():
                return apply(*inputs)[0]

    return sampler, feats_fn


def run(args, dataset_cls, mel_key="mono_mel", *, device=None):
    """Every clip of ``--list_test``: the audio looked up as the id itself,
    ``processed/mono_audios_22050Hz/{id}.wav`` or ``{id}.wav`` under
    ``--data_root``, then ``dump_clip_mels``."""
    sampler, feats_fn = build_inference(args, mel_key, device=device)
    rows = load_split_csv(args.list_test)
    out_left = args.output_dir_left
    out_right = args.output_dir_right
    detection_csv = os.path.join(
        args.data_root, "action_detection_results", "detection_results.csv"
    )
    for row in rows:
        vid = row["video_id"]
        wav = None
        for cand in (
            vid,
            os.path.join(args.data_root, "processed",
                         "mono_audios_22050Hz", vid + ".wav"),
            os.path.join(args.data_root, vid + ".wav"),
        ):
            if os.path.exists(cand):
                wav = cand
                break
        if wav is None:
            print(f"[WARNING] no audio for {vid}")
            continue
        ds = dataset_cls(wav, video_id=os.path.splitext(os.path.basename(vid))[0],
                         detection_csv=detection_csv,
                         data_root=args.data_root, n_mels=args.num_mels)
        mel = dump_clip_mels(args, sampler, ds, out_left, out_right,
                             features_fn=feats_fn)
        print(f"{vid}: mel {mel.shape} → {out_left}")


def main(argv=None, *, device=None):
    args = ArgParser().parse_test_arguments(argv)
    run(args, GenAudioRealBinauralDataset, mel_key="mono_mel",
        device=resolve_device(device))


if __name__ == "__main__":
    main()
