"""Offline mel RMSE of predicted ``.npy`` mels against ground-truth wavs —
counterpart of ``diffbinaural_tpu/evaluation/mel_rmse.py``: the GT mel
recomputed from the wav with the canonical frontend, the GT wav trimmed
8·hop samples per side, the predicted mel 8 frames per side, per-channel
RMSE and their mean, NaN-safe summary statistics, and the
``*_m40_*.npy -> *_0_*.wav`` filename mapping.  The arithmetic runs in
float64 on the card unless ``device="cpu"`` is passed."""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.audio_io import load_wav
from .metrics import _ln_mel


def map_pred_to_gt_name(pred_basename: str) -> str:
    """``*_m40_*.npy -> *_0_*.wav``."""
    base = pred_basename[: -len(".npy")] if pred_basename.endswith(".npy") else (
        pred_basename
    )
    parts = base.split("_")
    parts = ["0" if p.startswith("m") and p[1:].isdigit() else p for p in parts]
    return "_".join(parts) + ".wav"


def evaluate_mel_rmse_pair(
    pred_left: torch.Tensor,
    pred_right: torch.Tensor,
    gt_wav: torch.Tensor,
    sr: int = 22050,
    n_fft: int = 1024,
    num_mels: int = 80,
    hop: int = 256,
    win: int = 1024,
    trim_frames: int = 8,
) -> Dict[str, float]:
    """Predicted mels (80, T) and the GT wav (2, S), tensors on one device
    -> per-channel and mean RMSE."""
    cut = trim_frames * hop
    gt_wav = gt_wav[:, cut: gt_wav.shape[1] - cut]

    out = {}
    rmses = []
    for name, pred, ch in (("left", pred_left, 0), ("right", pred_right, 1)):
        p = pred[:, trim_frames:-trim_frames] if pred.shape[1] > 2 * trim_frames \
            else pred
        g = _ln_mel(gt_wav[ch], n_fft, num_mels, sr, hop, win)
        t = min(p.shape[1], g.shape[1])
        rmse = float(torch.sqrt(torch.mean(
            (p[:, :t].to(torch.float64) - g[:, :t]) ** 2)))
        out[f"rmse_{name}"] = rmse
        rmses.append(rmse)
    out["rmse_mean"] = float(np.mean(rmses))
    return out


def nan_safe_stats(values: List[float]) -> Dict[str, float]:
    """Mean, std and count of the finite values."""
    arr = np.asarray([v for v in values if np.isfinite(v)])
    if arr.size == 0:
        return {"mean": float("nan"), "std": float("nan"), "count": 0}
    return {
        "mean": float(arr.mean()),
        "std": float(arr.std()),
        "count": int(arr.size),
    }


def evaluate_mel_rmse_dirs(
    pred_left_dir: str,
    pred_right_dir: str,
    gt_audio_dir: str,
    output_csv: Optional[str] = None,
    sr: int = 22050,
    *,
    device=None,
) -> Dict[str, float]:
    """Every ``{base}.npy`` pair in the two directories against its GT wav
    (``map_pred_to_gt_name``, else ``{base}.wav``); one CSV row per file.
    Runs on the card unless ``device="cpu"``."""
    device = resolve_device(device)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rows = []
    for left_path in sorted(glob.glob(os.path.join(pred_left_dir, "*.npy"))):
        base = os.path.basename(left_path)
        right_path = os.path.join(pred_right_dir, base)
        if not os.path.exists(right_path):
            continue
        gt_path = os.path.join(gt_audio_dir, map_pred_to_gt_name(base))
        if not os.path.exists(gt_path):
            gt_path = os.path.join(gt_audio_dir, base[: -len(".npy")] + ".wav")
            if not os.path.exists(gt_path):
                continue
        gt, _ = load_wav(gt_path, target_sr=sr)
        if gt.ndim == 1:
            gt = np.stack([gt, gt])
        res = evaluate_mel_rmse_pair(
            on_device(np.load(left_path)), on_device(np.load(right_path)),
            on_device(gt).to(torch.float64), sr=sr)
        res["file"] = base
        rows.append(res)

    summary = nan_safe_stats([r["rmse_mean"] for r in rows])
    if output_csv and rows:
        os.makedirs(os.path.dirname(os.path.abspath(output_csv)), exist_ok=True)
        with open(output_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return {"files": len(rows), **summary}
