"""Stage-1 CLI argument parser — counterpart of
``diffbinaural_tpu/cli/arguments.py``: the same flags, types and defaults.
``--gpu_ids`` is accepted and ignored (the trainers run on one device), as
there.  The reference's ``type=bool`` flags of the stage-2 CLIs are kept
as they are: argparse's ``bool("False")`` is True, so ``--debug False``
turns the flag on.
"""

from __future__ import annotations

import argparse


class ArgParser:
    def __init__(self):
        parser = argparse.ArgumentParser()
        # Model related arguments
        parser.add_argument('--id', default='realBinaural',
                            help="a name for identifying the model")
        parser.add_argument('--arch_frame', default='resnet18',
                            help="architecture of net_frame")
        parser.add_argument('--weights_frame', default='',
                            help="weights to finetune net_frame")
        parser.add_argument('--weights_unet', default='',
                            help="weights to finetune unet")
        parser.add_argument('--num_channels', default=32, type=int)
        parser.add_argument('--num_frames', default=1, type=int)
        parser.add_argument('--img_pool', default='maxpool')
        parser.add_argument('--loss', default='l1')
        parser.add_argument('--weighted_loss', default=1, type=int)
        parser.add_argument('--split', default='val')
        parser.add_argument('--decay_factor', default=0.94, type=float)
        parser.add_argument('--learning_rate_decrease_itr', default=50,
                            type=int)
        parser.add_argument('--max_sources', default=4, type=int)

        # Data related arguments
        parser.add_argument('--num_gpus', default=1, type=int,
                            help='number of devices to use')
        parser.add_argument('--gpu_ids', default="0", type=str,
                            help='accepted for compatibility; ignored')
        parser.add_argument('--batch_size_per_gpu', default=32, type=int)
        parser.add_argument('--workers', default=32, type=int)
        parser.add_argument('--num_val', default=-1, type=int)
        parser.add_argument('--num_vis', default=40, type=int)
        parser.add_argument('--audLen', default=16384, type=int)
        parser.add_argument('--audRate', default=16000, type=int)
        parser.add_argument('--stft_frame', default=1024, type=int)
        parser.add_argument('--stft_hop', default=256, type=int)
        parser.add_argument('--num_mels', default=80, type=int)
        parser.add_argument('--imgSize', default=224, type=int)
        parser.add_argument('--vidRate', default=8, type=float)
        parser.add_argument('--pos_type', default="3D", type=str)

        # Misc arguments
        parser.add_argument('--seed', default=1234, type=int)
        parser.add_argument('--ckpt', default='./checkpoints')
        parser.add_argument('--disp_iter', type=int, default=10)
        parser.add_argument('--eval_epoch', type=int, default=1)
        parser.add_argument('--num_train_timesteps', type=int, default=300)
        parser.add_argument('--num_sample_timesteps', type=int, default=300)
        parser.add_argument('--dir_frames', default='./frames')
        parser.add_argument('--dir_det_pos', default='./det_pos_npy')
        parser.add_argument('--data_root', default='./data',
                            help='dataset root (processed/... layout)')
        parser.add_argument('--crop_frames', default=8, type=int,
                            help='frames cropped per window edge at '
                                 'generation')

        self.parser = parser

    def add_train_arguments(self):
        p = self.parser
        p.add_argument('--mode', default='train', help="train/eval")
        p.add_argument('--list_train', default='./splits/train.csv')
        p.add_argument('--list_val', default='./splits/val.csv')
        p.add_argument('--dup_trainset', default=1, type=int)
        p.add_argument('--num_epoch', default=100, type=int)
        p.add_argument('--lr_frame', default=1e-4, type=float)
        p.add_argument('--lr_unet', default=1e-3, type=float)
        p.add_argument('--lr_steps', nargs='+', type=int, default=[40, 60])
        p.add_argument('--beta1', default=0.9, type=float)
        p.add_argument('--weight_decay', default=1e-4, type=float)

    def add_test_arguments(self):
        p = self.parser
        p.add_argument('--mode', default='eval', help="train/eval")
        p.add_argument('--list_test', default='./splits/test.csv')
        p.add_argument('--output_dir_left', default='./generated_files')
        p.add_argument('--output_dir_right', default='./generated_files')

    def print_arguments(self, args):
        print("Input arguments:")
        for key, val in vars(args).items():
            print("{:16} {}".format(key, val))

    def parse_train_arguments(self, argv=None):
        self.add_train_arguments()
        args = self.parser.parse_args(argv)
        self.print_arguments(args)
        return args

    def parse_test_arguments(self, argv=None):
        self.add_test_arguments()
        args = self.parser.parse_args(argv)
        self.print_arguments(args)
        return args
