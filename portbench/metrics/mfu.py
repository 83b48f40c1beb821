"""The whole request's or step's share of the float32-accurate peak: the
plain reference's FLOP for every request of the window (counted once in
set-up on the meta device) over the window's wall time times 494.7
TFLOP/s."""

from portbench.roofline import PEAK_FLOPS_FP32_ACCURATE


def read(run):
    flops = sum(r["flops"] for r in run.requests if not r.get("failed"))
    return 100.0 * flops / (run.window_s * PEAK_FLOPS_FP32_ACCURATE)
