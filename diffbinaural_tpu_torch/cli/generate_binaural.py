"""One command, mono wav -> binaural stereo wav, over ``BinauralPipeline``.
Counterpart of ``diffbinaural_tpu/cli/generate_binaural.py``, same flags.

The chain: the checkpoints (flax msgpack, as the JAX trainers write them)
-> the port's models; the wav -> ln-mel frontend -> padded up to a multiple
of ``--bucket_frames`` with ln(1e-5) -> windowed DDIM (or DPM-Solver++(2M)
with ``--sampler dpm++``) over the UNet -> stitch -> BigVGAN -> a stereo
wav, ``{base}_binaural_generated.wav``.  One pipeline per length bucket.

Visual conditioning: ``--visual_feats`` is a (512,) or (n_windows, 512)
.npy, or a directory of ``{base}.npy``; without it the model runs on zeros
(classifier-free guidance's null condition).

Run: python -m diffbinaural_tpu_torch.cli.generate_binaural \\
       --input_wav clips/ --output_dir out \\
       --weights_unet ckpt/unet_best.pth \\
       --vocoder_checkpoint ckpt2/g_00050000

``main(argv, device="cpu")`` runs it on the CPU (the plain versions of the
kernels); by default it runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import glob
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from . import load_generator, vocoder_hparams
from ..convert import unet_params_from_flax
from ..core import checkpoint
from ..core.config import UnetConfig, VocoderConfig
from ..core.device import resolve_device
from ..data.audio_io import load_wav, save_wav
from ..infer.pipeline import BinauralPipeline
from ..models import build_unet
from ..signal.stft import mel_spectrogram


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_wav", required=True,
                        help="a .wav file or a directory of them")
    parser.add_argument("--output_dir", default="generated_binaural")
    parser.add_argument("--weights_unet", required=True)
    parser.add_argument("--vocoder_checkpoint", required=True,
                        help="BigVGAN generator ckpt; config.json beside it")
    parser.add_argument("--visual_feats", default=None,
                        help=".npy (512,) or (n_windows, 512); or a dir of "
                             "{base}.npy matching the input wavs")
    parser.add_argument("--ddim_steps", default=25, type=int,
                        help="stage-1 solver steps (model evals per window)")
    parser.add_argument("--sampler", default="ddim",
                        choices=("ddim", "dpm++"),
                        help="'ddim' = reference parity; 'dpm++' = "
                             "DPM-Solver++(2M) (pair with --ddim_steps 12)")
    parser.add_argument("--unet_batch", default=8, type=int)
    parser.add_argument("--unet_dim", default=64, type=int)
    parser.add_argument("--bucket_frames", default=64, type=int)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 compute (parameters stay float32)")
    a = parser.parse_args(argv)
    device = resolve_device(device)

    dtype = torch.bfloat16 if a.bf16 else torch.float32
    unet = build_unet(UnetConfig(dim=a.unet_dim), dtype=dtype, device=device)
    unet.load_state_dict(
        unet_params_from_flax(checkpoint.load_checkpoint(a.weights_unet)),
        strict=True)

    h = vocoder_hparams(a.vocoder_checkpoint)
    cfg = VocoderConfig.from_attrdict(h)
    voc = load_generator(a.vocoder_checkpoint, cfg, dtype=dtype, device=device)
    sr, hop = int(h["sampling_rate"]), int(h["hop_size"])

    paths = (sorted(glob.glob(os.path.join(a.input_wav, "*.wav")))
             if os.path.isdir(a.input_wav) else [a.input_wav])
    os.makedirs(a.output_dir, exist_ok=True)

    pipes = {}  # one pipeline per length bucket

    def pipe_for(frames: int) -> BinauralPipeline:
        bucket = -(-frames // a.bucket_frames) * a.bucket_frames
        if bucket not in pipes:
            pipes[bucket] = BinauralPipeline(
                unet, voc, bucket, num_mels=cfg.num_mels,
                unet_batch=a.unet_batch, sampling_timesteps=a.ddim_steps,
                sampler=a.sampler, device=device)
        return pipes[bucket]

    for path in paths:
        base = os.path.basename(path)[: -len(".wav")]
        audio, in_sr = load_wav(path)
        if in_sr != sr:
            raise SystemExit(f"{path}: expected {sr} Hz, got {in_sr} "
                             "(resample first, e.g. data.audio_io.resample)")
        mono = audio.mean(axis=0) if audio.ndim == 2 else audio
        frames = len(mono) // hop
        with torch.inference_mode():
            mel = mel_spectrogram(
                torch.from_numpy(np.ascontiguousarray(
                    mono[None, : frames * hop])).to(device),
                int(h["n_fft"]), cfg.num_mels, sr, hop, int(h["win_size"]),
                float(h.get("fmin", 0.0) or 0.0), h.get("fmax"),
            )[..., :frames]  # (1, num_mels, frames)

            pipe = pipe_for(frames)
            pad = pipe.total_frames - frames
            if pad:
                mel = F.pad(mel, (0, pad), value=math.log(1e-5))

        if a.visual_feats is None:
            feats = np.zeros((512,), np.float32)
        else:
            fp = (os.path.join(a.visual_feats, base + ".npy")
                  if os.path.isdir(a.visual_feats) else a.visual_feats)
            feats = np.load(fp).astype(np.float32)

        wav = pipe(mel, feats)[:, : frames * hop].float().cpu().numpy()
        out = os.path.join(a.output_dir, base + "_binaural_generated.wav")
        save_wav(out, wav, sr)
        print(f"{base}: {wav.shape} -> {out}")


if __name__ == "__main__":
    main()
