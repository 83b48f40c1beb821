"""Vocoder inference: paired left / right mel .npy directories -> stereo
wavs.  Counterpart of ``diffbinaural_tpu/cli/inference_e2e.py``, same
flags: ``config.json`` is read beside the checkpoint, frames that are all
zero are left out of vocoding and come back as silence
(``--interpolate_zero_frames``, on by default), and each clip is written
as ``{base}_binaural_generated.wav`` (int16 stereo).

Run: python -m diffbinaural_tpu_torch.cli.inference_e2e --checkpoint_file ...
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from . import load_generator, vocoder_hparams
from ..core.config import VocoderConfig
from ..core.device import resolve_device
from ..data.audio_io import save_wav
from ..infer.vocoder import Vocoder


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_mels_left_dir", default="./mels/left_test")
    parser.add_argument("--input_mels_right_dir", default="./mels/right_test")
    parser.add_argument("--output_dir", default="generated_realbinaural_files")
    parser.add_argument("--checkpoint_file", required=True)
    parser.add_argument("--use_cuda_kernel", action="store_true",
                        default=False,
                        help="accepted for compatibility; the port always "
                             "runs its kernels on the card")
    parser.add_argument("--interpolate_zero_frames", action="store_true",
                        default=True)
    a = parser.parse_args(argv)
    device = resolve_device(device)

    h = vocoder_hparams(a.checkpoint_file)
    cfg = VocoderConfig.from_attrdict(h)
    voc = Vocoder(cfg, hop_size=h["hop_size"], device=device,
                  model=load_generator(a.checkpoint_file, cfg, device=device))

    os.makedirs(a.output_dir, exist_ok=True)
    for left_path in sorted(
        glob.glob(os.path.join(a.input_mels_left_dir, "*.npy"))
    ):
        base = os.path.basename(left_path)[: -len(".npy")]
        right_path = os.path.join(a.input_mels_right_dir, base + ".npy")
        if not os.path.exists(right_path):
            print(f"[WARNING] missing right mel for {base}")
            continue
        stereo = voc.vocode_binaural(
            np.load(left_path), np.load(right_path),
            interpolate_zero_frames=a.interpolate_zero_frames,
        )
        out = os.path.join(a.output_dir, base + "_binaural_generated.wav")
        save_wav(out, stereo, h["sampling_rate"])
        print(f"{base}: {stereo.shape} -> {out}")


if __name__ == "__main__":
    main()
