"""Stage-1 trainer on the RealBinaural dataset — counterpart of
``diffbinaural_tpu/cli/train_realbinaural.py``, same flags
(``cli.arguments.ArgParser``): the experiment-id checkpoint namespace
``{--ckpt}/{--id}``, auto-resume, an evaluation every ``--eval_epoch``
epochs.  Data: ``{--data_root}/processed/{mono,binaural}_audios_22050Hz/``,
frames under ``processed/frames/{video_id}/`` and the detections in
``action_detection_results/detection_results.csv``.

Run: python -m diffbinaural_tpu_torch.cli.train_realbinaural --mode train ...
Data-parallel over W cards: python -m torch.distributed.run
--nproc_per_node=W -m diffbinaural_tpu_torch.cli.train_realbinaural ... (the same
flags; the batch is the global one, each rank on cuda:LOCAL_RANK).

``main(argv, device="cpu")`` runs it on the CPU (the plain versions of the
kernels); by default it runs on the card and raises without one.  Returns
the trainer.
"""

from __future__ import annotations

import os

from ..core.device import resolve_device
from ..parallel.mesh import shutdown


def main(argv=None, *, device=None):
    from .arguments import ArgParser
    from .common import Stage1Trainer
    from ..data import DataLoader, RealBinauralDataset

    args = ArgParser().parse_train_arguments(argv)
    device = resolve_device(device)

    detection_csv = os.path.join(
        args.data_root, "action_detection_results", "detection_results.csv"
    )
    common = dict(
        data_root=args.data_root,
        detection_csv=detection_csv,
        sample_rate=22050,  # RealBinaural is 22.05 kHz
        audio_len=args.audLen,
        n_mels=args.num_mels,
        num_frames=max(args.num_frames, 1),
        max_sources=args.max_sources,
        simple_frames=False,
    )
    dataset_train = RealBinauralDataset(
        csv_file=args.list_train, split="train", **common
    )
    dataset_val = RealBinauralDataset(
        csv_file=args.list_val, split="val", **common
    )
    batch = args.batch_size_per_gpu * args.num_gpus
    loader_train = DataLoader(
        dataset_train, batch_size=batch, shuffle=True,
        num_workers=min(args.workers, 16), seed=args.seed,
    )
    loader_val = DataLoader(
        dataset_val, batch_size=batch, shuffle=False, drop_last=False,
        num_workers=min(args.workers, 16),
    )

    trainer = Stage1Trainer(args, dataset_train, dataset_val,
                            mel_key="mono_mel", device=device)
    # no batch is drawn ahead for the shapes (the JAX CLI's first batch):
    # its iterator's workers would go on drawing from the dataset's shared
    # RNG until collected, so the first epoch's crops would depend on
    # thread timing
    trainer.init_params()
    trainer.try_resume()
    if args.mode == "train":
        trainer.fit(loader_train, loader_val)
    else:
        trainer.evaluate(loader_val, epoch=0)
    return trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
