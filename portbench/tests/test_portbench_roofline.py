"""The yardstick's arithmetic against hand counts."""

import torch

from portbench import roofline
from portbench.reference import bigvgan


def test_attention_work_by_hand():
    flops, nbytes = roofline.attention_work(8, 4, 6400, 32)
    assert flops == 2 * (2 * 8 * 4 * 6400 * 6400 * 32)
    assert nbytes == 4 * 8 * 4 * 6400 * 32 * 4
    assert roofline.least_seconds(flops, nbytes) == flops / 494.7e12


def test_snake_conv_work_by_hand():
    flops, nbytes = roofline.snake_conv_work(1, 768, 3584, 768, 7)
    assert flops == 2 * 768 * 768 * 7 * 3584
    assert nbytes == 4 * (768 * 3584 * 2 + 768 * 768 * 7 + 3 * 768)


def test_flop_count_on_meta_by_hand():
    lin = roofline.meta(lambda: torch.nn.Linear(64, 32))
    x = torch.empty((10, 64), device="meta")
    assert roofline.count_flops(lin, x) == 2 * 10 * 64 * 32
    conv = roofline.meta(lambda: bigvgan.WNConv1d(16, 8, 3))
    x = torch.empty((2, 16, 100), device="meta")
    assert roofline.count_flops(conv, x) == 2 * 2 * 8 * 16 * 3 * 100


def test_a_share_at_the_least_time_reads_100():
    class Trace:
        def seconds_matching(self, names):
            return 1.0

    class Run:
        trace = Trace()
        segment_work = {"k1": [(494.7e12, 0.0)]}

        @staticmethod
        def kernel_names(family):
            return ["k"]

    assert abs(roofline.share(Run, "k1") - 100.0) < 1e-9
    Run.segment_work = {}
    assert roofline.share(Run, "k1") is None
