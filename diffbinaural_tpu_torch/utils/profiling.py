"""Profiling helpers — counterpart of
``diffbinaural_tpu/utils/profiling.py``: the program's spans at its layer
boundaries, a ``torch.profiler`` trace that TensorBoard's profile plugin and
``chrome://tracing`` read, and the card's memory statistics.

A span is a ``torch.profiler`` range named ``diffbinaural.<layer>``, opened
only while a profiler records: ranges are stamped on the clock that the
profiler maps the device's activities onto, so a trace shows which layer the
host was in when each kernel was launched and while the device sat idle.
There is no other store of spans; ``trace`` writes them out.

Spans (each opened where the work happens, from any caller):

  * ``pipeline``, ``pipeline.windows``, ``pipeline.stitch`` — a clip
    request through ``infer.pipeline.BinauralPipeline``, its input checks
    and windows, its denormalise / crop / overlap-average;
  * ``sampler.step`` — one step of a sampler in ``diffusion.gaussian``: the
    time condition, the model call and the update;
  * ``unet`` — one call of the denoiser, ``models.unet.AudioVisualModel``;
  * ``generator`` — one forward of ``models.bigvgan.BigVGAN``;
  * ``vocoder``, ``vocoder.pad``, ``vocoder.to_device``, ``vocoder.to_host``
    — a request through ``infer.vocoder.Vocoder`` and its host work;
  * ``stage2.step``, ``stage2.d_phase``, ``stage2.g_phase`` — a stage-2 GAN
    step and its discriminator and generator phases.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch

PREFIX = "diffbinaural."
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("unet"): ...`` — a profiler range ``diffbinaural.<name>``
    while a ``torch.profiler`` session records; otherwise a shared no-op
    context.  Off, it costs one check of the profiler's state: nothing is
    recorded or allocated.  Never synchronises and reads no tensor."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


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
