"""Binaural vocoder inference through ``BinauralBigVGAN``.  Counterpart of
``diffbinaural_tpu/cli/inference_binaural.py``, same flags; three input
modes: one ``--input_left_mel`` / ``--input_right_mel`` pair, a directory of
``*_left.npy`` / ``*_right.npy`` pairs, or a directory of stereo wavs whose
mels are computed on the fly.  Each clip is written as
``{base}_generated.wav``.

Run: python -m diffbinaural_tpu_torch.cli.inference_binaural --checkpoint_file ...
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from . import load_generator, vocoder_hparams
from ..core.config import VocoderConfig
from ..core.device import resolve_device
from ..core.precision import full_precision
from ..data.audio_io import load_wav, save_wav
from ..models import BinauralBigVGAN
from ..signal.stft import mel_spectrogram


def load_binaural(checkpoint_file: str, config: VocoderConfig,
                  device) -> BinauralBigVGAN:
    """``BinauralBigVGAN`` around the checkpoint's generator."""
    model = BinauralBigVGAN(config)
    model.generator = load_generator(checkpoint_file, config, device=device)
    return model.eval()


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_mels_dir", default=None,
                        help="dir of paired *_left.npy / *_right.npy")
    parser.add_argument("--input_wavs_dir", default=None,
                        help="dir of stereo wavs (mels computed on the fly)")
    parser.add_argument("--input_left_mel", default=None)
    parser.add_argument("--input_right_mel", default=None)
    parser.add_argument("--output_dir", default="generated_binaural")
    parser.add_argument("--checkpoint_file", required=True)
    parser.add_argument("--use_cuda_kernel", action="store_true",
                        default=False,
                        help="accepted for compatibility; the port always "
                             "runs its kernels on the card")
    a = parser.parse_args(argv)
    device = resolve_device(device)

    h = vocoder_hparams(a.checkpoint_file)
    cfg = VocoderConfig.from_attrdict(h)
    model = load_binaural(a.checkpoint_file, cfg, device)
    os.makedirs(a.output_dir, exist_ok=True)

    def vocode_pair(mel_l, mel_r, base):
        with torch.inference_mode(), full_precision():
            y = model(torch.as_tensor(mel_l[None], device=device),
                      torch.as_tensor(mel_r[None], device=device))
        y = y[0].float().cpu().numpy()
        out = os.path.join(a.output_dir, base + "_generated.wav")
        save_wav(out, y, h["sampling_rate"])
        print(f"{base}: {y.shape} -> {out}")

    if a.input_left_mel and a.input_right_mel:
        base = os.path.basename(a.input_left_mel).replace("_left.npy", "")
        vocode_pair(np.load(a.input_left_mel), np.load(a.input_right_mel), base)
    elif a.input_mels_dir:
        for lp in sorted(glob.glob(os.path.join(a.input_mels_dir,
                                                "*_left.npy"))):
            rp = lp.replace("_left.npy", "_right.npy")
            if os.path.exists(rp):
                base = os.path.basename(lp).replace("_left.npy", "")
                vocode_pair(np.load(lp), np.load(rp), base)
    elif a.input_wavs_dir:
        for wp in sorted(glob.glob(os.path.join(a.input_wavs_dir, "*.wav"))):
            wav, _ = load_wav(wp, target_sr=h["sampling_rate"])
            if wav.ndim == 1:
                wav = np.stack([wav, wav])
            with torch.inference_mode():
                mel = mel_spectrogram(
                    torch.from_numpy(np.ascontiguousarray(wav)).to(device),
                    h["n_fft"], h["num_mels"], h["sampling_rate"],
                    h["hop_size"], h["win_size"], h["fmin"], h["fmax"],
                )
            base = os.path.splitext(os.path.basename(wp))[0]
            vocode_pair(mel[0], mel[1], base)
    else:
        parser.error("provide --input_mels_dir, --input_wavs_dir, or the "
                     "--input_left_mel/--input_right_mel pair")


if __name__ == "__main__":
    main()
