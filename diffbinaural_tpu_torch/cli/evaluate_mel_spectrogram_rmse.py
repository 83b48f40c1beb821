"""Offline mel RMSE of predicted L/R mel directories against GT wavs —
counterpart of ``diffbinaural_tpu/cli/evaluate_mel_spectrogram_rmse.py``,
same flags; the arithmetic runs in float64 on the card
(``evaluation.mel_rmse.evaluate_mel_rmse_dirs``).

Run: python -m diffbinaural_tpu_torch.cli.evaluate_mel_spectrogram_rmse \\
       --pred_left_dir mels/left --pred_right_dir mels/right \\
       --gt_audio_dir data/processed/binaural_audios_22050Hz

``main(argv, device="cpu")`` runs it on the CPU; by default it runs on the
card and raises without one.
"""

from __future__ import annotations

import argparse

from ..core.device import resolve_device
from ..evaluation.mel_rmse import evaluate_mel_rmse_dirs


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred_left_dir", required=True)
    parser.add_argument("--pred_right_dir", required=True)
    parser.add_argument("--gt_audio_dir", required=True)
    parser.add_argument("--output_csv", default="mel_rmse_evaluation.csv")
    parser.add_argument("--sr", default=22050, type=int)
    a = parser.parse_args(argv)
    device = resolve_device(device)

    summary = evaluate_mel_rmse_dirs(
        a.pred_left_dir, a.pred_right_dir, a.gt_audio_dir, a.output_csv,
        sr=a.sr, device=device,
    )
    print(f"files: {summary['files']}  mean RMSE: {summary['mean']:.4f} "
          f"± {summary['std']:.4f}")


if __name__ == "__main__":
    main()
