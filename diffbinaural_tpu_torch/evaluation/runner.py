"""The whole binaural metric battery over directories of generated and
ground-truth wavs — counterpart of
``diffbinaural_tpu/evaluation/runner.py``: both wavs trimmed 8·256 samples
per side, the filename match ``*_binaural_generated.wav -> *.wav``, a
per-file CSV and a NaN-safe ``_summary.csv``.  The metrics run in float64
on the card unless ``device="cpu"`` is passed."""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.audio_io import load_wav
from .mel_rmse import nan_safe_stats
from .metrics import (
    Envelope_distance,
    MEL_RMSE_distance,
    STFT_RMSE_distance,
    STFT_phase_and_magnitude_RMSE_distance,
    calculate_snr,
    compute_iacc_difference,
    compute_ild_error,
    compute_itd_error,
    compute_sar_sir_sdr,
)
from .pesq import pesq_binaural

TRIM_SAMPLES = 8 * 256


def evaluate_binaural_pair(pred: torch.Tensor, gt: torch.Tensor,
                           sr: int = 22050, compute_bss: bool = True,
                           compute_pesq: bool = False) -> Dict[str, float]:
    """pred / gt: (2, T) tensors on one device, already trimmed."""
    n = min(pred.shape[1], gt.shape[1])
    pred = pred[:, :n].to(torch.float64)
    gt = gt[:, :n].to(torch.float64)
    mag, phase = STFT_phase_and_magnitude_RMSE_distance(pred, gt, sr)
    iacc_diff, iacc_pred, iacc_gt = compute_iacc_difference(pred, gt)
    ild_err, ild_pred, ild_gt = compute_ild_error(pred, gt, sr=sr)
    itd_err, itd_err_ms, itd_pred, itd_gt = compute_itd_error(pred, gt, sr=sr)
    out = {
        "stft_rmse": STFT_RMSE_distance(pred, gt, sr),
        "mag_rmse": mag,
        "phase_rmse": phase,
        "mel_rmse": MEL_RMSE_distance(pred, gt, sr=sr),
        "envelope_distance": Envelope_distance(pred, gt),
        "snr_db": calculate_snr(gt, pred),
        "iacc_diff": iacc_diff,
        "iacc_pred": iacc_pred,
        "iacc_gt": iacc_gt,
        "ild_error_db": ild_err,
        "itd_error_samples": itd_err,
        "itd_error_ms": itd_err_ms,
    }
    if compute_bss:
        sar, sir, sdr = compute_sar_sir_sdr(pred, gt)
        out.update({"sar": sar, "sir": sir, "sdr": sdr})
    if compute_pesq:
        out["pesq_mos"] = pesq_binaural(pred, gt, sr)
    return out


def evaluate_binaural_dirs(
    generated_dir: str,
    gt_dir: str,
    output_csv: Optional[str] = None,
    sr: int = 22050,
    compute_bss: bool = True,
    compute_pesq: bool = False,
    *,
    device=None,
) -> Dict[str, Dict[str, float]]:
    """Every ``*_binaural_generated.wav`` of ``generated_dir`` against its
    GT in ``gt_dir``; returns the summary ``{metric: {mean, std, count}}``.
    Runs on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    rows: List[Dict] = []
    pattern = os.path.join(generated_dir, "*_binaural_generated.wav")
    for gen_path in sorted(glob.glob(pattern)):
        base = os.path.basename(gen_path)
        gt_path = os.path.join(
            gt_dir, base.replace("_binaural_generated.wav", ".wav")
        )
        if not os.path.exists(gt_path):
            print(f"[WARNING] no GT for {base}")
            continue
        pred, _ = load_wav(gen_path, target_sr=sr)
        gt, _ = load_wav(gt_path, target_sr=sr)
        if pred.ndim == 1:
            pred = np.stack([pred, pred])
        if gt.ndim == 1:
            gt = np.stack([gt, gt])
        pred = pred[:, TRIM_SAMPLES: pred.shape[1] - TRIM_SAMPLES]
        gt = gt[:, TRIM_SAMPLES: gt.shape[1] - TRIM_SAMPLES]
        res = evaluate_binaural_pair(
            *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (pred, gt)), sr, compute_bss, compute_pesq)
        res["file"] = base
        rows.append(res)
        print(f"{base}: stft_rmse={res['stft_rmse']:.4f} "
              f"mel_rmse={res['mel_rmse']:.4f} snr={res['snr_db']:.2f}")

    metric_keys = [k for k in (rows[0] if rows else {}) if k != "file"]
    summary = {k: nan_safe_stats([r[k] for r in rows]) for k in metric_keys}

    if output_csv and rows:
        os.makedirs(os.path.dirname(os.path.abspath(output_csv)), exist_ok=True)
        with open(output_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["file"] + metric_keys)
            w.writeheader()
            w.writerows(rows)
        summary_csv = output_csv.replace(".csv", "_summary.csv")
        with open(summary_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["metric", "mean", "std", "count"])
            for k, s in summary.items():
                w.writerow([k, s["mean"], s["std"], s["count"]])
    return summary
