"""Profiling and timing helpers — counterpart of
``diffbinaural_tpu/utils/profiling.py``: a ``torch.profiler`` trace that
TensorBoard's profile plugin and ``chrome://tracing`` read, wall-clock
timing that waits for the card, the card's memory statistics, and a FLOP
count of a function."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/prof'): step()`` records the host and, where there
    is a card, the device, and writes ``{log_dir}/trace.json`` (Chrome trace
    format) when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out) -> None:
    """Wait for the card when any tensor of ``out`` lies on one: the host
    returns from a CUDA call before the work is done."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda
           for t in tree_leaves(out)):
        torch.cuda.synchronize()


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 10,
          **kwargs) -> Dict[str, float]:
    """Mean wall-clock seconds per call of ``fn(*args, **kwargs)`` over
    ``iters`` calls after ``warmup`` calls, synchronised with the card when
    the result lies on it; ``{"mean_s", "per_sec"}``."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "per_sec": 1.0 / dt}


def device_memory_stats(device=None) -> Optional[Dict[str, float]]:
    """The card's memory in GB: the caching allocator's bytes in use and
    their peak (``torch.cuda.memory_stats``), and the card's total
    (``torch.cuda.mem_get_info``).  ``device`` defaults to the current card;
    None for a CPU device or where there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / 1e9,
        "peak_bytes_gb": stats.get("allocated_bytes.all.peak", 0) / 1e9,
        "bytes_limit_gb": total / 1e9,
    }


def cost_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)`` by
    ``torch.utils.flop_counter.FlopCounterMode``, run once on CPU tensors
    (so the kernels' plain versions run and are counted, as the JAX
    package counts the interpret-mode trace).

    It counts matrix products, convolutions and attention only: XLA's HLO
    cost analysis, which the JAX ``hlo_cost_flops`` reads, also counts
    elementwise operations, and counts a padded convolution's taps inside
    the input only.  Raises ValueError for a tensor that is not on the
    CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    for leaf in tree_leaves((args, kwargs)):
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            raise ValueError(f"cost_flops runs on CPU tensors, got one on "
                             f"{leaf.device}")
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
