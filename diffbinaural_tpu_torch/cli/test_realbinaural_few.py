"""Few-sample visual check of stage 1: at most ``--max_windows`` windows of
each of the first ``--max_files`` test clips, a 2×2 comparison image per
window and a ``.txt`` MSE summary per file — counterpart of
``diffbinaural_tpu/cli/test_realbinaural_few.py``, same flags and files.

The JAX CLI draws the figure with matplotlib (imshow, vmin −9, vmax 1,
origin at the bottom); here Pillow writes ``{base}_w{i}.png`` as the same
four panels (pred L, pred R over mix L, mix R), each clipped to [−9, 1]
and mapped linearly to 8-bit grey, low frequencies at the bottom, without
titles or axes.  The ``.txt`` files are the JAX CLI's, byte for byte.

Run: python -m diffbinaural_tpu_torch.cli.test_realbinaural_few \\
       --list_test ... --data_root data --ckpt ckpt --id realBinaural

``main(argv, device="cpu")`` runs it on the CPU; by default it runs on the
card and raises without one.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.device import resolve_device
from ..data import GenAudioRealBinauralDataset
from ..data.stage1 import load_split_csv
from .arguments import ArgParser
from .test_realbinaural import build_inference


def comparison_image(panels) -> np.ndarray:
    """Four (M, T) ln-mels -> one uint8 (2M, 2T) image: row 0 the first
    two, row 1 the last two; [−9, 1] -> [0, 255], low bands at the
    bottom."""
    tiles = [np.round((np.clip(p, -9.0, 1.0) + 9.0) * 25.5).astype(
        np.uint8)[::-1] for p in panels]
    return np.concatenate([np.concatenate(tiles[:2], axis=1),
                           np.concatenate(tiles[2:], axis=1)], axis=0)


def main(argv=None, *, device=None):
    parser = ArgParser()
    parser.parser.add_argument("--max_files", default=2, type=int)
    parser.parser.add_argument("--max_windows", default=3, type=int)
    parser.parser.add_argument("--output_dir", default="./few_sample_check")
    args = parser.parse_test_arguments(argv)
    device = resolve_device(device)
    from PIL import Image

    sampler, feats_fn = build_inference(args, device=device)
    os.makedirs(args.output_dir, exist_ok=True)

    rows = load_split_csv(args.list_test)[: args.max_files]
    for row in rows:
        vid = row["video_id"]
        wav = vid if os.path.exists(vid) else os.path.join(
            args.data_root, vid + ".wav"
        )
        ds = GenAudioRealBinauralDataset(wav, n_mels=args.num_mels)
        base = os.path.splitext(os.path.basename(wav))[0]
        mses = []
        for wi in range(min(len(ds), args.max_windows)):
            item = ds[wi]
            mono = item["mono_mel"][None]
            feat = (feats_fn(item)[None] if feats_fn
                    else np.zeros((1, 512), np.float32))
            pred = sampler.sample(mono, feat)[0].float().cpu().numpy()
            gt = np.repeat(mono, 2, axis=1)[0]  # mono as stand-in GT view
            mse = float(np.mean((pred - gt) ** 2))
            mses.append(mse)
            Image.fromarray(comparison_image(
                [pred[0], pred[1], gt[0], gt[1]])).save(
                os.path.join(args.output_dir, f"{base}_w{wi}.png"))
        with open(os.path.join(args.output_dir, f"{base}.txt"), "w") as f:
            f.write(f"windows: {len(mses)}\n")
            for wi, m in enumerate(mses):
                f.write(f"window {wi}: mse {m:.5f}\n")
            f.write(f"mean mse: {np.mean(mses):.5f}\n")
        print(f"{base}: mean mse {np.mean(mses):.5f}")


if __name__ == "__main__":
    main()
