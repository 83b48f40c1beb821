"""Stage-1 trainer on FairPlay — counterpart of
``diffbinaural_tpu/cli/train_fairplay.py``, same flags: the ``mix_mel``
batch key, stereo wavs under ``{--data_root}/binaural_audios/`` (the mono
mix is their mean), no detection file (all sources masked).

Run: python -m diffbinaural_tpu_torch.cli.train_fairplay --mode train ...
Data-parallel over W cards: python -m torch.distributed.run
--nproc_per_node=W -m diffbinaural_tpu_torch.cli.train_fairplay ... (the same
flags; the batch is the global one, each rank on cuda:LOCAL_RANK).

``main(argv, device="cpu")`` runs it on the CPU (the plain versions of the
kernels); by default it runs on the card and raises without one.  Returns
the trainer.
"""

from __future__ import annotations

from ..core.device import resolve_device
from ..parallel.mesh import shutdown


def main(argv=None, *, device=None):
    from .arguments import ArgParser
    from .common import Stage1Trainer
    from ..data import DataLoader, FairPlayPosDataset

    args = ArgParser().parse_train_arguments(argv)
    device = resolve_device(device)

    common = dict(
        data_root=args.data_root,
        detection_csv=None,
        sample_rate=args.audRate if args.audRate else 22050,
        audio_len=args.audLen,
        n_mels=args.num_mels,
        num_frames=max(args.num_frames, 1),
        max_sources=args.max_sources,
    )
    dataset_train = FairPlayPosDataset(
        csv_file=args.list_train, split="train", **common
    )
    dataset_val = FairPlayPosDataset(
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
                            mel_key="mix_mel", device=device)
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
