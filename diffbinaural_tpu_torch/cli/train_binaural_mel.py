"""Stage-2 vocoder trainer on precomputed L/R mels — counterpart of
``diffbinaural_tpu/cli/train_binaural_mel.py``, same flags (the
reference's ``type=bool`` flags included: ``--debug False`` parses as
True).  ``BinauralMelSpectrogramDataset`` over ``--mel_{left,right}_*_dir``
and ``--audio_dir``; ``cli.gan_common.GanTrainer``.

Run: python -m diffbinaural_tpu_torch.cli.train_binaural_mel --config ...
Data-parallel over W cards: python -m torch.distributed.run
--nproc_per_node=W -m diffbinaural_tpu_torch.cli.train_binaural_mel ... (the same
flags; the batch is the global one, each rank on cuda:LOCAL_RANK).

``main(argv, device="cpu")`` runs it on the CPU (the plain versions of the
kernels); by default it runs on the card and raises without one.  Returns
the trainer.
"""

from __future__ import annotations

import argparse

from ..core.device import resolve_device
from ..parallel.mesh import shutdown


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--group_name', default=None)
    parser.add_argument('--mel_left_train_dir', default='./mels/left_train')
    parser.add_argument('--mel_right_train_dir', default='./mels/right_train')
    parser.add_argument('--mel_left_val_dir', default='./mels/left_val')
    parser.add_argument('--mel_right_val_dir', default='./mels/right_val')
    parser.add_argument('--audio_dir', default='./binaural_audios_22050Hz')
    parser.add_argument('--checkpoint_path', default='cp_bigvgan_binaural_mel')
    parser.add_argument('--stage1_checkpoint_path', default='')
    parser.add_argument('--config',
                        default='configs/bigvgan_binaural_22khz_80band_256x.json')
    parser.add_argument('--training_epochs', default=2000, type=int)
    parser.add_argument('--stdout_interval', default=50, type=int)
    parser.add_argument('--checkpoint_interval', default=5000, type=int)
    parser.add_argument('--summary_interval', default=100, type=int)
    parser.add_argument('--validation_interval', default=100, type=int)
    parser.add_argument('--freeze_step', default=0, type=int)
    parser.add_argument('--fine_tuning', default=False, type=bool)
    parser.add_argument('--pretrained_bigvgan', default=None)
    parser.add_argument('--load_stage1_checkpoint', default=True, type=bool)
    parser.add_argument('--debug', default=False, type=bool)
    parser.add_argument('--evaluate', default=False, type=bool)
    return parser


def main(argv=None, *, device=None):
    from .gan_common import GanTrainer, load_config
    from ..data import BinauralMelSpectrogramDataset, DataLoader

    a = build_parser().parse_args(argv)
    device = resolve_device(device)
    h = load_config(a)

    common = dict(
        audio_dir=a.audio_dir,
        segment_size=h["segment_size"],
        n_fft=h["n_fft"], num_mels=h["num_mels"], hop_size=h["hop_size"],
        win_size=h["win_size"], sampling_rate=h["sampling_rate"],
        fmin=h["fmin"], fmax=h["fmax"], fmax_loss=h.get("fmax_for_loss"),
    )
    ds_train = BinauralMelSpectrogramDataset(
        a.mel_left_train_dir, a.mel_right_train_dir, split=True, **common
    )
    ds_val = BinauralMelSpectrogramDataset(
        a.mel_left_val_dir, a.mel_right_val_dir, split=True, **common
    )
    loader_train = DataLoader(ds_train, batch_size=h["batch_size"],
                              shuffle=True, num_workers=h["num_workers"])
    loader_val = DataLoader(ds_val, batch_size=1, shuffle=False,
                            drop_last=False, num_workers=2)

    trainer = GanTrainer(a, h, device=device)
    trainer.init_params(h["segment_size"] // h["hop_size"])
    trainer.try_resume()
    if a.evaluate:
        trainer.validate(loader_val)
        return trainer
    trainer.train(loader_train, loader_val)
    return trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
