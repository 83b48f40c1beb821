"""Stage-2 scheduled-sampling fine-tune — counterpart of
``diffbinaural_tpu/cli/train_binaural_both.py``, same flags (the
reference's ``type=bool`` flags included: ``--debug False`` parses as
True): ``BinauralCombinedDataset`` mixing ground-truth mels from the audio
and predicted mels with the epoch-wise P(pred) curriculum, audio
normalisation disabled, validation on predicted mels only;
``cli.gan_common.GanTrainer``.

Run: python -m diffbinaural_tpu_torch.cli.train_binaural_both --config ...
Data-parallel over W cards: python -m torch.distributed.run
--nproc_per_node=W -m diffbinaural_tpu_torch.cli.train_binaural_both ... (the same
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
    parser.add_argument("--group_name", default=None)
    parser.add_argument('--input_wavs_dir', default='./binaural_audios_22050Hz')
    parser.add_argument('--input_mels_dir', default='ft_dataset')
    parser.add_argument('--input_training_file', default='./training_binaural.txt')
    parser.add_argument('--input_validation_file', default='./validation_binaural.txt')
    parser.add_argument('--list_input_unseen_validation_file', default=[],
                        nargs='*')
    parser.add_argument('--list_input_unseen_wavs_dir', default=[], nargs='*')
    parser.add_argument('--mel_pred_left_train_dir', default='./mels/left_train')
    parser.add_argument('--mel_pred_right_train_dir', default='./mels/right_train')
    parser.add_argument('--mel_pred_left_val_dir', default='./mels/left_val')
    parser.add_argument('--mel_pred_right_val_dir', default='./mels/right_val')
    parser.add_argument('--audio_dir', default='./binaural_audios_22050Hz')
    parser.add_argument('--prefer_precomputed_mels', default=True, type=bool)
    parser.add_argument('--use_pred_mel_schedule', default=True, type=bool)
    parser.add_argument('--disable_audio_normalization', default=True,
                        type=bool)
    parser.add_argument("--checkpoint_path", default="cp_bigvgan_binaural_both")
    parser.add_argument("--config",
                        default="configs/bigvgan_binaural_22khz_80band_256x.json")
    parser.add_argument("--training_epochs", default=100000, type=int)
    parser.add_argument("--stdout_interval", default=50, type=int)
    parser.add_argument("--checkpoint_interval", default=3000, type=int)
    parser.add_argument("--summary_interval", default=50, type=int)
    parser.add_argument("--validation_interval", default=600, type=int)
    parser.add_argument("--freeze_step", default=0, type=int)
    parser.add_argument("--fine_tuning", default=False, type=bool)
    parser.add_argument("--stage1_checkpoint_path", default="")
    parser.add_argument("--load_stage1_checkpoint", default=False, type=bool)
    parser.add_argument("--debug", default=False, type=bool)
    parser.add_argument("--evaluate", default=False, type=bool)
    return parser


def main(argv=None, *, device=None):
    from .gan_common import GanTrainer, load_config
    from ..data import BinauralCombinedDataset, DataLoader

    a = build_parser().parse_args(argv)
    device = resolve_device(device)
    h = load_config(a)

    common = dict(
        segment_size=h["segment_size"], n_fft=h["n_fft"],
        num_mels=h["num_mels"], hop_size=h["hop_size"],
        win_size=h["win_size"], sampling_rate=h["sampling_rate"],
        fmin=h["fmin"], fmax=h["fmax"], fmax_loss=h.get("fmax_for_loss"),
    )
    ds_train = BinauralCombinedDataset(
        a.audio_dir,
        pred_mel_left_dir=a.mel_pred_left_train_dir,
        pred_mel_right_dir=a.mel_pred_right_train_dir,
        split=True,
        use_pred_mel_schedule=a.use_pred_mel_schedule,
        **common,
    )
    ds_val = BinauralCombinedDataset(
        a.audio_dir,
        pred_mel_left_dir=a.mel_pred_left_val_dir,
        pred_mel_right_dir=a.mel_pred_right_val_dir,
        split=True,
        use_pred_mel_schedule=False,
        always_use_pred=True,  # validation on predicted mels
        **common,
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
    trainer.train(loader_train, loader_val, dataset_train=ds_train)
    return trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
