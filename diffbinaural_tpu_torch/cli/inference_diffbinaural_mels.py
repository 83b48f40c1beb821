"""Vocoding of generated left / right mel directories through
``BinauralBigVGAN``.  Counterpart of
``diffbinaural_tpu/cli/inference_diffbinaural_mels.py``, same flags: mels
matched by basename, ``n_mels`` accepted for ``num_mels`` in the config,
output clipped to [-1, 1] and written as ``{base}_binaural_generated.wav``.

Run: python -m diffbinaural_tpu_torch.cli.inference_diffbinaural_mels ...
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from . import vocoder_hparams
from .inference_binaural import load_binaural
from ..core.config import VocoderConfig
from ..core.device import resolve_device
from ..core.precision import full_precision
from ..data.audio_io import save_wav


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_mels_left_dir", required=True)
    parser.add_argument("--input_mels_right_dir", required=True)
    parser.add_argument("--output_dir", default="generated_diffbinaural")
    parser.add_argument("--checkpoint_file", required=True)
    parser.add_argument("--use_cuda_kernel", action="store_true",
                        default=False,
                        help="accepted for compatibility; the port always "
                             "runs its kernels on the card")
    a = parser.parse_args(argv)
    device = resolve_device(device)

    h = vocoder_hparams(a.checkpoint_file)
    sr = h.get("sampling_rate", 22050)
    cfg = VocoderConfig.from_attrdict(
        {**h, "num_mels": h.get("num_mels", h.get("n_mels", 80))})
    model = load_binaural(a.checkpoint_file, cfg, device)

    os.makedirs(a.output_dir, exist_ok=True)
    for lp in sorted(glob.glob(os.path.join(a.input_mels_left_dir, "*.npy"))):
        base = os.path.basename(lp)[: -len(".npy")]
        rp = os.path.join(a.input_mels_right_dir, base + ".npy")
        if not os.path.exists(rp):
            print(f"[WARNING] missing right mel for {base}")
            continue
        with torch.inference_mode(), full_precision():
            y = model(torch.as_tensor(np.load(lp)[None], device=device),
                      torch.as_tensor(np.load(rp)[None], device=device))
        y = np.clip(y[0].float().cpu().numpy(), -1.0, 1.0)
        out = os.path.join(a.output_dir, base + "_binaural_generated.wav")
        save_wav(out, y, sr)
        print(f"{base}: {y.shape} -> {out}")


if __name__ == "__main__":
    main()
