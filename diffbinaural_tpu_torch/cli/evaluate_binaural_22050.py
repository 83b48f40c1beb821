"""The whole binaural metric battery over a directory of generated wavs —
counterpart of ``diffbinaural_tpu/cli/evaluate_binaural_22050.py``, same
flags; the metrics run in float64 on the card
(``evaluation.runner.evaluate_binaural_dirs``).

Run: python -m diffbinaural_tpu_torch.cli.evaluate_binaural_22050 \\
       --generated_dir out/ --gt_dir data/processed/binaural_audios_22050Hz

``main(argv, device="cpu")`` runs it on the CPU; by default it runs on the
card and raises without one.
"""

from __future__ import annotations

import argparse

from ..core.device import resolve_device
from ..evaluation.runner import evaluate_binaural_dirs


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--generated_dir", required=True,
                        help="dir of *_binaural_generated.wav")
    parser.add_argument("--gt_dir", required=True,
                        help="dir of matching GT wavs")
    parser.add_argument("--output_csv", default="binaural_evaluation.csv")
    parser.add_argument("--sr", default=22050, type=int)
    parser.add_argument("--skip_bss", action="store_true",
                        help="skip the (slow) SDR/SIR/SAR computation")
    parser.add_argument("--pesq", action="store_true",
                        help="add the from-scratch P.862-style MOS "
                             "(evaluation/pesq.py)")
    a = parser.parse_args(argv)
    device = resolve_device(device)

    summary = evaluate_binaural_dirs(
        a.generated_dir, a.gt_dir, a.output_csv, sr=a.sr,
        compute_bss=not a.skip_bss, compute_pesq=a.pesq, device=device,
    )
    print("\n==== summary ====")
    for k, s in summary.items():
        print(f"{k:>20}: mean {s['mean']:.4f} ± {s['std']:.4f} "
              f"(n={s['count']})")


if __name__ == "__main__":
    main()
