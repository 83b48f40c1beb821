"""The yardstick's arithmetic: the card's peaks, a kernel's least time from
the work its call shapes ask for, and a model's FLOP from the plain
reference.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at 700 W, dense.
float32 work is held against the TF32 tensor-core rate, 494.7 TFLOP/s: the
fastest rate at which the card forms a float32-accurate product (split
TF32 takes three TF32 products for one), so a share of it cannot pass 100 %
whatever implements the work.  Work is counted once, from shapes: each
input byte read once, each output byte written once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS_FP32_ACCURATE = 494.7e12   # TF32 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS_FP32_ACCURATE, nbytes / HBM_BYTES_PER_S)


def attention_work(b: int, h: int, n: int, d: int) -> tuple:
    """softmax(q k^T) v over (b, h, n, d) float32: two n x n x d products;
    q, k, v read and o written once."""
    return 4.0 * b * h * n * n * d, 4.0 * b * h * n * d * F32


def snake_conv_work(b: int, c_in: int, t: int, c_out: int, k: int) -> tuple:
    """The activation fused into a k-tap convolution over (b, c_in, t)
    float32: the product's FLOP; x, the weight, the per-channel parameters
    and the bias read once, y written once."""
    flops = 2.0 * b * c_out * c_in * k * t
    nbytes = F32 * (b * c_in * t + c_out * c_in * k + 2 * c_in + c_out
                    + b * c_out * t)
    return flops, nbytes


def count_flops(fn, *args) -> float:
    """FLOP of ``fn(*args)`` (forward, and backward where ``fn`` takes
    gradients) as ``FlopCounterMode`` counts the products; run on the
    ``meta`` device, so nothing is computed."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def meta(module_factory):
    """A module built on the ``meta`` device."""
    with torch.device("meta"):
        return module_factory()


def share(run, family: str):
    """% of a kernel family's roofline in a run's traced segment: the least
    time of the work its calls asked for (counted from their shapes by the
    drivers' hooks) over the device time of the kernels named in
    ``kernels/<family>/``.  Nothing where the segment ran none of them."""
    if run.trace is None:
        return None
    work = run.segment_work.get(family, [])
    measured = run.trace.seconds_matching(run.kernel_names(family))
    if not work or measured <= 0:
        return None
    return 100.0 * sum(least_seconds(f, b) for f, b in work) / measured
