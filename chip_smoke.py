"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``diffbinaural_tpu_torch/ops/csrc`` with nvcc
and holds each against its plain PyTorch version on the card at the shapes
the two paths give it.  Then it drives both paths at full width, random
weights from a seed:

  * serving — the full-width path through the kernels against the same path
    through the plain versions (float32, two DDIM steps), then the 10 s clip
    in bfloat16 (861 frames, 21 windows in 3 groups of 8, DDIM-25, BigVGAN
    vocoder);
  * serving from checkpoints — the full-width UNet and the production
    generator written as flax msgpack and read back onto the card bit for
    bit (also through the upstream BigVGAN names); DPM-Solver++(2M) through
    the kernels against through the plain versions (float32, three steps);
    then ``cli.generate_binaural`` on 10 s wavs from those checkpoints with
    DDIM-25 and with DPM++-12 (bfloat16), each clip held bit for bit against
    ``BinauralPipeline`` called directly, and the three vocoder CLIs on the
    stitched mels against the modules they drive;
  * stage-1 training — one step's loss and every parameter's gradient
    through the kernels against the same through the plain versions
    (float32, batch 2), then optimiser steps in bfloat16 at batch 16 on a
    batch made by the port's mel frontend from a synthetic stereo signal;
  * the visual conditioning path — the six frame encoders (ViT-B/32 towers
    and ResNet-18, float32) on the card against the same weights on the
    CPU, one live-visual stage-1 step through the kernels against the
    plain versions (float32, batch 2), then optimiser steps with
    ``ClipPos2D`` and the bfloat16 UNet at batch 16 (64 CLIP images per
    step), and a 10 s clip generated from per-window frames through
    ``cli.common.dump_clip_mels``;
  * stage-2 GAN training at the production configuration
    (``configs/bigvgan_binaural_22khz_80band_256x.json``: the full-width
    generator, MPD and sub-band CQTD) — one D+G step through the kernels
    against the same through the plain versions (float32, batch 2), then
    optimiser steps with a bfloat16 generator at batch 16 x 16384 samples;
  * training from files — the train CLIs on synthetic worlds on disk;
  * the mesh (``parallel/``) — on a world-1 NCCL group that the script
    opens (the machine has one card): the stage-1 and stage-2 steps through
    ``make_mesh()``'s mesh bit for bit against the steps without a group,
    the 10 s clip through ``BinauralPipeline(mesh=)`` as one group, and
    ``train_realbinaural`` under ``python -m torch.distributed.run``
    against the same CLI without a launcher;
  * evaluation on a test split — checkpoints written by the port (the
    UNet, ``ClipPos2D`` over ViT-B/32, the production generator), the four
    test CLIs on the stage-1 world's val clips (``test_realbinaural`` bit
    for bit against ``dump_clip_mels``), ``inference_e2e`` on their mels,
    and the two evaluate CLIs on the card against the same on the CPU;
    K1 in float32 at the test CLIs' shapes;
  * fault C4 — one ``test_realbinaural`` clip and one ``inference_e2e`` file
    with PyTorch's TF32 defaults against the same with TF32 off, bit for bit
    (``--fp32-paths-only`` runs the float32 CLI paths alone — the stage-1
    train CLI, the evaluation and this check — e.g. from a copy of this
    script beside an older tree, to compare the two in one process each).

The float32 attention kernels and the float32 K3 (split-TF32 products on
``wgmma``) are timed beside the earlier CUDA-core kernels they replaced
(``cuda_core_ms``, ``ops/csrc_variants/flash_d32_cuda_core.cu`` and
``snake_conv_cuda_core.cu``) and beside two bounds: the split-TF32 floor (3 x
FLOP over the TF32 peak, ``bound_ms``; K3 adds its activation on the CUDA
cores once per output-channel block) and the CUDA cores' floor
(``cuda_core_bound_ms``).

Each path's launch counts are set to 0 before it and checked after it.
Every phase prints one JSON line; any failure exits non-zero.  There is no
CPU fallback: without a CUDA device the script fails before printing a
result.

    python3 chip_smoke.py --trace 10

also traces 10 UNet calls, one vocoder pass, one clip with each sampler, 3
stage-1 steps with features and 3 with the live encoder (and the tower's
forward and the encoder's forward + backward alone), and 3 stage-2 train
steps with ``torch.profiler`` and prints, for each, the wall time, the summed device time, the device's busy share and the
ten kernels with the most device time.

Float32 comparisons run with TF32 switched off for both matmuls and cuDNN
convolutions, so the plain versions are true float32 references.

Kernel times (``ms``) are per call over back-to-back calls between two CUDA
events.  The anti-aliased activation (K2), the fused snake->conv (K3) and
their backward kernels (K2b; K3b and its dz and dW kernels) are faster than
their Python wrappers' host side, so their calls are replayed from a CUDA
graph (``graph_ms``); their case lines also give the kernels alone from
``torch.profiler`` (``kernel_ms``), the eager calls (``eager_ms``) and the
host microseconds per call.  K2b is timed beside its earlier tiled kernel
(``ops/alias_free_act_variants.py``), K3b beside its earlier composition
(K2, cuDNN's convolution gradients, K2b).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

# Published dense peaks of one H100 SXM (NVIDIA data sheet); a card whose
# power limit is below 700 W runs under them.
HBM_BYTES_PER_S = 3.35e12
# "tf32": the dense TF32 tensor-core peak of an H100 SXM (data sheet).  The
# float32 attention kernels take each float32 product as three TF32 products
# (split TF32), so their FLOP floor is three times the FLOP over it.
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32": 494.7e12}
# exp2 results per clock per SM: the special-function unit's 16, plus the
# FMA pipes' 128 float32 lanes over 5 instructions per exp2 in software (a
# range split and a degree-3 polynomial take at least that many, so the rate
# is not understated).  Times the SM count and the card's maximum SM clock,
# both read in phase_device.  Attention at d = 32 takes one exp2 per score
# against 64 tensor-core FLOP per product.
EXP2_PER_CLOCK_PER_SM = 16 + 128 / 5
EXP_PER_S = None  # set by phase_device

CLIP_SECONDS, SR, HOP, WINDOW, UNET_BATCH, DDIM_STEPS = 10.0, 22050, 256, 80, 8, 25
BF16_UNET_TOL = 5e-2  # of the output's scale, see phase_main_path_check
TRAIN_BATCH, TRAIN_STEPS = 16, 5
ATTN_PER_STEP = 4  # Attention layers with n >= 1024: two at 6400, two at 1600
GAN_CONFIG = "configs/bigvgan_binaural_22khz_80band_256x.json"
GAN_BATCH, GAN_SEGMENT, GAN_STEPS = 16, 16384, 5
# a generator pass: 109 anti-aliased activations, 12 of them (C = 768,
# k <= 7) fused into the next convolution; each K3b recomputes the
# activation with K2 and runs K2b
ACT_PER_PASS, FUSED_PER_PASS = 97, 12


def launches(**nonzero) -> dict:
    """Launch counts of every wrapper, 0 where not named."""
    from diffbinaural_tpu_torch import ops

    return {name: nonzero.get(name, 0) for name in ops.WRAPPERS}


# which path gives a kernel its launch count in the `kernels` line
SERVING_KERNELS = ("flash_sdpa", "fused_alias_free_snake", "fused_snake_conv")
TRAINING_KERNELS = ("flash_sdpa_with_lse", "flash_sdpa_backward")
GAN_KERNELS = ("fused_alias_free_snake_backward", "fused_snake_conv_backward",
               "snake_conv_dgrad", "snake_conv_wgrad")
SOURCES = {
    "flash_sdpa": ("diffbinaural_tpu_torch/ops/csrc/flash_d32.cu",
                   "diffbinaural_tpu/ops/flash_d32.py:175"),
    "flash_sdpa_with_lse": ("diffbinaural_tpu_torch/ops/csrc/flash_d32.cu",
                            "diffbinaural_tpu/ops/flash_d32.py:184"),
    "flash_sdpa_backward": ("diffbinaural_tpu_torch/ops/csrc/flash_d32_bwd.cu",
                            "diffbinaural_tpu/ops/flash_d32.py:245"),
    "fused_alias_free_snake": (
        "diffbinaural_tpu_torch/ops/csrc/alias_free_act.cu",
        "diffbinaural_tpu/ops/alias_free_act.py:607"),
    "fused_snake_conv": ("diffbinaural_tpu_torch/ops/csrc/snake_conv.cu",
                         "diffbinaural_tpu/ops/snake_conv.py:166"),
    "fused_alias_free_snake_backward": (
        "diffbinaural_tpu_torch/ops/csrc/alias_free_act_bwd.cu",
        "diffbinaural_tpu/ops/alias_free_act.py:673"),
    # K3b: K2 + the dz kernel + K2b + the dW kernel (no kernel file of its
    # own, as the TPU code has no pallas_call of its own there); dz and dW
    # replace the XLA convolution's VJP inside _core_bwd
    "fused_snake_conv_backward": (
        "diffbinaural_tpu_torch/ops/snake_conv.py",
        "diffbinaural_tpu/ops/snake_conv.py:204"),
    "snake_conv_dgrad": ("diffbinaural_tpu_torch/ops/csrc/snake_conv.cu",
                         "diffbinaural_tpu/ops/snake_conv.py:204"),
    "snake_conv_wgrad": ("diffbinaural_tpu_torch/ops/csrc/snake_conv_wgrad.cu",
                         "diffbinaural_tpu/ops/snake_conv.py:204"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Per-call time of ``iters`` back-to-back calls between two CUDA events,
    after ``warmup`` calls.  The host enqueues ahead, so a kernel that runs
    longer than its wrapper's host side is timed on the device alone (a
    single launch between two events would carry the host side as well)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20) -> float:
    """Per-call time of ``calls`` back-to-back calls captured in one CUDA
    graph and replayed between two CUDA events: the device time of
    everything ``fn`` launches (parameter preparation included) with no
    host side in between — for wrappers whose host side (~0.1 ms in Python)
    outlasts their kernels, where back-to-back eager calls time the host."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / calls


def _device_rows(fn, calls: int) -> list:
    """(kernel name, device ms per call) of every kernel ``fn`` launches,
    from ``torch.profiler`` over ``calls`` calls, the longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def kernel_ms(fn, kernel: str, calls: int = 20) -> float:
    """Device time per call of the kernels whose name contains ``kernel``,
    from ``torch.profiler`` over ``calls`` calls: the kernel alone, without
    the wrapper's parameter preparation."""
    total = sum(ms for key, ms in _device_rows(fn, calls) if kernel in key)
    if total <= 0:
        fail(f"kernel_ms: no device time for {kernel}")
    return total


def kernel_split(fn, calls: int = 20) -> list:
    """Every kernel of ``fn`` with its device ms per call (names cut to 90
    characters), the longest first."""
    return [[key[:90], ms] for key, ms in _device_rows(fn, calls)]


def time_run_ms(fn, calls: int, repeats: int = 3) -> float:
    """Per-call time of ``calls`` back-to-back calls between two CUDA events
    (the host enqueues ahead, as it does in the pipeline); median of
    ``repeats`` such runs after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def rand(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def dt_name(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


# ---------------------------------------------------------------- phases


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    global EXP_PER_S
    smi = _smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_sm_mhz = float(_smi("clocks.max.sm").split()[0])
    EXP_PER_S = EXP2_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6
    from diffbinaural_tpu_torch.ops import _build

    nvcc_out = subprocess.run([_build._nvcc(), "--version"],
                              capture_output=True, text=True, check=True).stdout
    nvcc = next((ln.strip() for ln in nvcc_out.splitlines() if "release" in ln),
                nvcc_out.strip())
    info = {"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "sms": sms,
            "max_sm_clock_mhz": max_sm_mhz, "exp2_per_s": EXP_PER_S}
    emit(info)
    return info


TILED_K2B = None  # the earlier tiled K2b, built by phase_build (K2b's yardstick)
# the earlier float32 attention kernels and float32 K3 on the CUDA cores,
# built by phase_build: the yardsticks of the split-TF32 kernels
# (``cuda_core_ms``)
CUDA_CORE_F32 = None
CUDA_CORE_K3 = None


def phase_build() -> None:
    global TILED_K2B, CUDA_CORE_F32, CUDA_CORE_K3
    from diffbinaural_tpu_torch.ops import _build
    from diffbinaural_tpu_torch.ops import alias_free_act_variants as afv
    from diffbinaural_tpu_torch.ops import flash_d32_variants as fv
    from diffbinaural_tpu_torch.ops import snake_conv_variants as scv

    t0 = time.time()
    variants = afv.start(["tiled"])
    cuda_core = fv.start_cuda_core()
    cuda_core_k3 = scv.start_cuda_core()
    logs = _build.build_all(verbose=True)
    for name in _build.KERNELS:
        _build.load(name)
    TILED_K2B = afv.finish(variants)["tiled"]
    CUDA_CORE_F32 = fv.finish(cuda_core)[0][("cuda_core", "cuda_core")]
    CUDA_CORE_K3 = scv.finish(cuda_core_k3)[0][("cuda_core", "snake_conv_f32")]
    ptxas = {name: [ln for ln in log.splitlines() if "registers" in ln
                    or "spill" in ln][:8] for name, log in logs.items()}
    # the float32 K3's 192-channel block holds 2 x 96 accumulator registers
    # of its 255: a spill there is a register plan that no longer fits
    if re.search(r"[1-9]\d* bytes spill", logs.get("snake_conv_f32", "")):
        fail("build: ptxas spills in snake_conv_f32: "
             + "; ".join(ptxas["snake_conv_f32"]))
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "libraries": sorted(p.name for p in _build.BUILD_DIR.glob("*.so")),
          "ptxas": ptxas})


def _compare(name, case, got, want, tol, relative, rms_tol=None):
    """Max abs error of ``got`` against ``want``; fails above ``tol`` (times
    max|want| when ``relative``).  With ``rms_tol`` the root-mean-square
    error must also stay under ``rms_tol`` times the rms of ``want``."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name} {case}: shape/dtype {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name} {case}: non-finite output")
    err = (g - w).abs().max().item()
    scale = w.abs().max().item() if relative else 1.0
    if err > tol * scale:
        fail(f"{name} {case}: max_abs_err {err:.3e} > {tol:g} x {scale:.3g}")
    if rms_tol is not None:
        rel_rms = _rel_rms(g, w)
        if rel_rms > rms_tol:
            fail(f"{name} {case}: rms error {rel_rms:.3e} of the output's "
                 f"rms > {rms_tol:g}")
    return err


def _rel_rms(got, want) -> float:
    g, w = got.float(), want.float()
    return ((g - w).square().mean().sqrt() / w.square().mean().sqrt()).item()


def k1_cases():
    return [(8, 4, 6400, 32), (8, 4, 1600, 32), (2, 4, 1000, 32)]


def check_k1(gen, results):
    """flash_sdpa vs its plain version.  float32: 2e-4 absolute (sums of N
    terms in another order, exp2f vs exp).  bfloat16 runs another kernel
    (tensor cores) and is held relative to the output, whose values are
    small (an average of unit normals over ~N/3 keys): max error 2e-2 of
    max|want| and rms error 1e-2 of the output's rms (both sides round the
    probabilities and the output to bfloat16, the plain version also q)."""
    from diffbinaural_tpu_torch.ops import flash_sdpa, sdpa_plain

    for shape in k1_cases():
        for dtype, tol, rel, rms_tol in ((torch.float32, 2e-4, False, None),
                                         (torch.bfloat16, 2e-2, True, 1e-2)):
            q, k, v = (rand(gen, shape, dtype) for _ in range(3))
            scale = shape[-1] ** -0.5
            got = flash_sdpa(q, k, v, scale)
            want = sdpa_plain(q, k, v, scale)
            err = _compare("flash_sdpa", (shape, dt_name(dtype)), got, want,
                           tol, rel, rms_tol)
            case = {"kernel": "flash_sdpa", "shape": list(shape),
                    "dtype": dt_name(dtype), "max_err": err, "tol": tol,
                    "tol_relative_to_output_scale": rel,
                    "output_scale": want.float().abs().max().item(),
                    "rms_err_of_output_rms": _rel_rms(got, want),
                    "rms_tol": rms_tol,
                    "bit_identical_repeat": _same_bits_twice(
                        "flash_sdpa", (shape, dt_name(dtype)), got,
                        lambda: flash_sdpa(q, k, v, scale))}
            if shape[2] >= 1600:
                b, h, n, d = shape
                case["ms"] = time_ms(lambda: flash_sdpa(q, k, v, scale))
                if dtype == torch.float32:
                    case["cuda_core_ms"] = cuda_core_ms(
                        lambda: flash_sdpa(q, k, v, scale))
                case["plain_ms"] = time_ms(lambda: sdpa_plain(q, k, v, scale),
                                           warmup=1, iters=10)
                case["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
                flops = 4.0 * b * h * n * n * d
                nbytes = 4.0 * b * h * n * d * q.element_size()
                _bound(case, flops, nbytes, dt_name(dtype),
                       exps=float(b * h * n * n),
                       split_tf32=dtype == torch.float32)
                case["host_us_per_call"] = _host_us_per_call(
                    lambda: flash_sdpa(q, k, v, scale))
            del got, want
            results.append(case)


def _bound(case, flops, nbytes, dtype_name, exps=None, split_tf32=False,
           cuda_core_flops=0.0):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the card's peak for them.  The
    operations' floor is the FLOP over the peak of their type and, where the
    work takes exponentials, the larger of that and their count over the
    exp2 rate of the special-function unit and the FMA pipes together (they
    run beside the tensor cores).  ``split_tf32``: float32 products taken
    as three TF32 products on the tensor cores, the float32 attention
    kernels' route: the FLOP floor is 3 x FLOP over the TF32 peak, and the
    floor on the CUDA cores (FLOP over the float32 peak) is kept beside it
    as ``cuda_core_bound_ms``.  ``cuda_core_flops``: work of a split-TF32
    function that the CUDA cores do beside its products (K3's activation,
    counted once): its own floor over the float32 peak, which may overlap
    the tensor cores' as the exponentials do."""
    floors = {"flop": (3.0 * flops / PEAK_FLOPS["tf32"] if split_tf32
                       else flops / PEAK_FLOPS[dtype_name]) * 1e3,
              "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    if exps is not None:
        floors["exp2"] = exps / EXP_PER_S * 1e3
    if cuda_core_flops:
        floors["cuda_cores"] = cuda_core_flops / PEAK_FLOPS["fp32"] * 1e3
    t_ops = max(floors["flop"], floors.get("exp2", 0.0),
                floors.get("cuda_cores", 0.0))
    case["bound_ms"] = max(t_ops, floors["bytes"])
    case["bound_by"] = "operations" if t_ops >= floors["bytes"] else "bytes"
    case["bound_floors_ms"] = floors
    if split_tf32:
        case["cuda_core_bound_ms"] = max(flops / PEAK_FLOPS["fp32"] * 1e3,
                                         floors.get("exp2", 0.0),
                                         floors["bytes"])


def cuda_core_ms(fn, **kwargs) -> float:
    """``time_ms`` of ``fn`` with the float32 attention wrappers launching
    the earlier CUDA-core kernels in place of the split-TF32 ones."""
    from diffbinaural_tpu_torch.ops import _build
    from diffbinaural_tpu_torch.ops.flash_d32_variants import F32_LIBS

    with _build.in_place(F32_LIBS, CUDA_CORE_F32):
        return time_ms(fn, **kwargs)


def k3_cuda_core(fn):
    """``fn`` called with the float32 K3 wrapper launching the earlier
    CUDA-core kernel in place of the split-TF32 one."""
    from diffbinaural_tpu_torch.ops import _build

    with _build.in_place("snake_conv_f32", CUDA_CORE_K3):
        return fn()


def _same_bits_twice(name, case, first, again) -> bool:
    """A second call gives ``first``'s bits (tensors or tuples of tensors):
    the attention kernels and K3 own their outputs (no atomics).  Fails
    otherwise; returns True for the case's record."""
    firsts = first if isinstance(first, tuple) else (first,)
    second = again()
    seconds = second if isinstance(second, tuple) else (second,)
    if not all(torch.equal(a, b) for a, b in zip(firsts, seconds)):
        fail(f"{name} {case}: two runs on the same inputs differ")
    return True


def _host_us_per_call(fn, calls: int = 50) -> float:
    """Host microseconds per call of ``fn`` issued back to back with no
    synchronisation (the card runs behind): the wrapper's whole host side —
    checks, ctypes, a bfloat16 launch's tensor maps, the launch itself."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _in_batch_chunks(fn, chunk, *tensors):
    """``fn`` on slices of ``chunk`` samples, outputs joined along the batch
    (the plain versions hold N x N tensors: at batch 16 and N = 6400 they do
    not fit at once)."""
    parts = [fn(*(a[i:i + chunk] for a in tensors))
             for i in range(0, tensors[0].shape[0], chunk)]
    return tuple(torch.cat(column) for column in zip(*parts))


def _worst(name, case, pairs, tol, relative, rms_tol):
    """``_compare`` over (label, got, want) pairs; the worst max error, the
    worst max error as a share of max|want|, and the worst relative rms."""
    worst, worst_share, worst_rms = 0.0, 0.0, 0.0
    for label, got, want in pairs:
        err = _compare(name, (*case, label), got, want, tol, relative, rms_tol)
        worst = max(worst, err)
        worst_share = max(worst_share, err / want.float().abs().max().item())
        worst_rms = max(worst_rms, _rel_rms(got, want))
    return worst, worst_share, worst_rms


def check_k1_training(gen, results):
    """The training forward (``flash_sdpa_with_lse``: o and lse) and the
    backward (``flash_sdpa_backward``: dq, dk, dv) against their plain
    versions, at the training path's two shapes (batch 16; the plain
    versions run in batch chunks of 2 at N = 6400) and on a ragged N = 1000.
    float32: o and the gradients 2e-4 absolute, lse 2e-5 (sums of N terms in
    another order, exp2f against exp).  bfloat16: o and the gradients 2e-2
    of max|want| and 1e-2 of the rms, as the residual-free forward (both
    sides round p — the backward also ds — and the results to bfloat16; the
    plain version also rounds the scaled q); lse 2e-2 absolute (the kernel
    scales in float32, the plain version rounds q * scale to bfloat16
    first).  The path's shapes are also timed: kernel, plain version, and
    the library — one ``F.scaled_dot_product_attention`` forward, and its
    autograd backward alone."""
    from diffbinaural_tpu_torch.ops import (flash_sdpa, flash_sdpa_backward,
                                            flash_sdpa_with_lse,
                                            sdpa_backward_plain,
                                            sdpa_plain_with_lse)

    scale = 32 ** -0.5

    def plain_fwd(*a):
        return sdpa_plain_with_lse(*a, scale)

    def plain_bwd(*a):
        return sdpa_backward_plain(*a, scale)

    for shape in ((TRAIN_BATCH, 4, 6400, 32), (TRAIN_BATCH, 4, 1600, 32),
                  (2, 4, 1000, 32)):
        b, h, n, d = shape
        chunk = 2 if n > 1600 else b
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            tol, rel, rms_tol = (2e-2, True, 1e-2) if bf16 else (2e-4, False, None)
            lse_tol = 2e-2 if bf16 else 2e-5
            name = dt_name(dtype)
            q, k, v, do = (rand(gen, shape, dtype) for _ in range(4))
            o, lse = flash_sdpa_with_lse(q, k, v, scale)
            o_p, lse_p = _in_batch_chunks(plain_fwd, chunk, q, k, v)
            fwd_err, fwd_share, fwd_rms = _worst(
                "flash_sdpa_with_lse", (shape, name), [("o", o, o_p)], tol, rel,
                rms_tol)
            lse_err = _compare("flash_sdpa_with_lse", (shape, name, "lse"),
                               lse, lse_p, lse_tol, False)
            # the two forwards are one kernel: the outputs are the same bits
            if not torch.equal(o, flash_sdpa(q, k, v, scale)):
                fail(f"flash_sdpa_with_lse {shape} {name}: output differs "
                     f"from the residual-free forward's")
            grads = flash_sdpa_backward(q, k, v, o, lse, do, scale)
            # no atomics: the same bits in every run
            fwd_repeat = _same_bits_twice(
                "flash_sdpa_with_lse", (shape, name), (o, lse),
                lambda: flash_sdpa_with_lse(q, k, v, scale))
            bwd_repeat = _same_bits_twice(
                "flash_sdpa_backward", (shape, name), grads,
                lambda: flash_sdpa_backward(q, k, v, o, lse, do, scale))
            grads_p = _in_batch_chunks(plain_bwd, chunk, q, k, v, o_p, lse_p, do)
            bwd_err, bwd_share, bwd_rms = _worst(
                "flash_sdpa_backward", (shape, name),
                list(zip(("dq", "dk", "dv"), grads, grads_p)), tol, rel, rms_tol)
            del o_p, lse_p, grads, grads_p
            common = {"shape": list(shape), "dtype": name, "tol": tol,
                      "tol_relative_to_output_scale": rel, "rms_tol": rms_tol}
            fwd = {"kernel": "flash_sdpa_with_lse", **common,
                   "max_err": fwd_err, "max_err_of_output_scale": fwd_share,
                   "rms_err_of_output_rms": fwd_rms, "lse_max_err": lse_err,
                   "lse_tol": lse_tol, "bit_identical_repeat": fwd_repeat}
            bwd = {"kernel": "flash_sdpa_backward", **common,
                   "max_err": bwd_err, "max_err_of_output_scale": bwd_share,
                   "rms_err_of_output_rms": bwd_rms,
                   "bit_identical_repeat": bwd_repeat}
            if n >= 1600:
                iters = 5 if n > 1600 else 10
                fwd["ms"] = time_ms(
                    lambda: flash_sdpa_with_lse(q, k, v, scale), iters=iters)
                bwd["ms"] = time_ms(
                    lambda: flash_sdpa_backward(q, k, v, o, lse, do, scale),
                    iters=iters)
                if not bf16:
                    fwd["cuda_core_ms"] = cuda_core_ms(
                        lambda: flash_sdpa_with_lse(q, k, v, scale),
                        iters=iters)
                    bwd["cuda_core_ms"] = cuda_core_ms(
                        lambda: flash_sdpa_backward(q, k, v, o, lse, do,
                                                    scale), iters=iters)
                fwd["plain_ms"] = time_ms(
                    lambda: _in_batch_chunks(plain_fwd, chunk, q, k, v),
                    warmup=1, iters=iters)
                bwd["plain_ms"] = time_ms(
                    lambda: _in_batch_chunks(plain_bwd, chunk, q, k, v, o, lse, do),
                    warmup=1, iters=iters)
                fwd["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                    iters=iters)
                leaves = [a.detach().requires_grad_() for a in (q, k, v)]
                out = F.scaled_dot_product_attention(*leaves, scale=scale)
                bwd["library_ms"] = time_ms(
                    lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True),
                    iters=iters)
                del out, leaves
                rows, es = float(b * h * n), q.element_size()
                # forward: q, k, v read, o and one float32 lse per row written;
                # one exp2 per score
                _bound(fwd, 4.0 * rows * n * d, rows * (4 * d * es + 4), name,
                       exps=rows * n, split_tf32=not bf16)
                # backward: five products and one exp2 per score at the
                # least; q, k, v, o, do and lse read, dq, dk, dv written.  The
                # two kernels recompute s, p and dp, so they do 14 N^2 D FLOP
                # where 10 are needed and 2 N^2 exp2 where 1 is.
                _bound(bwd, 10.0 * rows * n * d, rows * (8 * d * es + 4), name,
                       exps=rows * n, split_tf32=not bf16)
                bwd["flop_done_over_flop_needed"] = 1.4
                bwd["exp_done_over_exp_needed"] = 2.0
                fwd["host_us_per_call"] = _host_us_per_call(
                    lambda: flash_sdpa_with_lse(q, k, v, scale))
                bwd["host_us_per_call"] = _host_us_per_call(
                    lambda: flash_sdpa_backward(q, k, v, o, lse, do, scale))
            results += [fwd, bwd]
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()


K2_STAGES = [(768, 3444), (384, 13776), (192, 27552), (96, 55104),
             (48, 110208), (24, 220416)]
# inference_e2e's vocoder pass in float32, one channel at a time (batch 1):
# a 10 s clip's 861 mel frames padded to 896 (the Vocoder's pad multiple of
# 64), upsampled 4x, 4x, then 2x four times
K2_E2E = [(768, 3584), (384, 14336), (192, 28672), (96, 57344),
          (48, 114688), (24, 229376)]
GAN_STAGES = [(768, 256), (384, 1024), (192, 2048), (96, 4096), (48, 8192),
              (24, 16384)]  # the stage-2 step's six (C, T) at batch 16
# per sample: two up-FIR phases (6 mul + 5 add + gain), two snakes (3 mul,
# sine, add), one 12-tap down-FIR (12 mul + 11 add); the sine counts as one
K2_OPS_PER_SAMPLE = 2 * 12 + 2 * 5 + 23


def check_k2(gen, results):
    """fused_alias_free_snake vs its plain version, all samples.  float32:
    1e-5 (same float32 arithmetic, other summation order and another sine);
    bfloat16: both round one float32 result to bfloat16 — 8e-3 of the
    output's scale (two bfloat16 steps).  The serving and stage-2 shapes are
    timed in bfloat16 and float32 (``ms``: graph-replayed calls, see
    ``graph_ms``; ``eager_ms``: back-to-back eager calls, the host's pace
    when it is the slower; ``kernel_ms``: the kernel alone); a ragged clip
    and short rows are compared."""
    from diffbinaural_tpu_torch.ops import (alias_free_snake_plain,
                                            fused_alias_free_snake)

    shapes = ([(2, c, t) for c, t in K2_STAGES]
              + [(GAN_BATCH, c, t) for c, t in GAN_STAGES]
              + [(1, c, t) for c, t in K2_E2E]
              + [(2, 48, 1001), (3, 5, 7), (2, 3, 1)])
    for b, c, t in shapes:
        for dtype, tol, rel in ((torch.float32, 1e-5, False),
                                (torch.bfloat16, 8e-3, True)):
            if b == 1 and (c, t) in K2_E2E and dtype != torch.float32:
                continue  # inference_e2e runs the vocoder in float32
            x = rand(gen, (b, c, t), dtype)
            alpha = rand(gen, (c,), torch.float32, 0.3)
            beta = rand(gen, (c,), torch.float32, 0.3)
            got = fused_alias_free_snake(x, alpha, beta, True)
            want = alias_free_snake_plain(x, alpha, beta, True)
            err = _compare("fused_alias_free_snake", (b, c, t, dt_name(dtype)),
                           got, want, tol, rel)
            case = {"kernel": "fused_alias_free_snake", "shape": [b, c, t],
                    "dtype": dt_name(dtype), "max_err": err, "tol": tol,
                    "tol_relative_to_output_scale": rel}
            if (c, t) in K2_STAGES or (c, t) in GAN_STAGES or (
                    b == 1 and (c, t) in K2_E2E):
                def run():
                    return fused_alias_free_snake(x, alpha, beta, True)
                case["ms"] = graph_ms(run)
                case["eager_ms"] = time_ms(run)
                case["kernel_ms"] = kernel_ms(run, "afa_snake_kernel")
                case["host_us_per_call"] = _host_us_per_call(run)
                case["plain_ms"] = time_ms(
                    lambda: alias_free_snake_plain(x, alpha, beta, True))
                case["library_ms"] = None
                n = float(b * c * t)
                _bound(case, K2_OPS_PER_SAMPLE * n,
                       2 * n * x.element_size() + 8 * c, "fp32")
            del got, want
            results.append(case)


def _k3_case(gen, results, b, c, t, k, d, dtype, tol, timed):
    """One fused_snake_conv case against its plain version; timed cases
    add ``ms`` (graph-replayed calls: the kernel, the weight's relayout
    and the parameters' preparation), ``eager_ms``, ``kernel_ms``,
    ``host_us_per_call`` and ``unfused_ms``, the route the fusion replaces
    timed the same way: the port's K2 then ``F.conv1d`` in x's type.
    float32 cases also give the same bits twice, and timed ones add
    ``cuda_core_ms`` (the earlier CUDA-core kernel in the wrapper's place, held
    to the same tolerance) and the split-TF32 bound beside the CUDA cores'
    (``cuda_core_bound_ms``)."""
    from diffbinaural_tpu_torch.ops import (fused_alias_free_snake,
                                            fused_snake_conv, snake_conv_plain)

    x = rand(gen, (b, c, t), dtype)
    alpha = rand(gen, (c,), torch.float32, 0.3)
    beta = rand(gen, (c,), torch.float32, 0.3)
    w = rand(gen, (c, c, k), dtype, 0.02)
    bias = rand(gen, (c,), torch.float32, 0.1)
    got = fused_snake_conv(x, alpha, beta, w, bias, d, True)
    want = snake_conv_plain(x, alpha, beta, w, bias, d, True)
    err = _compare("fused_snake_conv", (b, c, t, k, d, dt_name(dtype)),
                   got, want, tol, relative=True)
    case = {"kernel": "fused_snake_conv", "shape": [b, c, t], "k": k,
            "dilation": d, "dtype": dt_name(dtype), "max_err": err,
            "tol": tol, "tol_relative_to_output_scale": True,
            "err_of_scale": err / want.float().abs().max().item()}
    fp32 = dtype == torch.float32
    if fp32:
        case["bit_identical_repeat"] = _same_bits_twice(
            "fused_snake_conv", (b, c, t, k, d, "fp32"), got,
            lambda: fused_snake_conv(x, alpha, beta, w, bias, d, True))
        if timed:
            case["cuda_core_max_err"] = _compare(
                "fused_snake_conv (CUDA-core yardstick)", (b, c, t, k, d),
                k3_cuda_core(lambda: fused_snake_conv(x, alpha, beta, w, bias,
                                                      d, True)),
                want, tol, relative=True)
    del got, want
    if timed:
        pad = (k - 1) // 2 * d
        bias_x = bias.to(dtype)

        def run():
            return fused_snake_conv(x, alpha, beta, w, bias, d, True)

        def unfused():
            z = fused_alias_free_snake(x, alpha, beta, True)
            return F.conv1d(z, w, bias_x, padding=pad, dilation=d)

        case["ms"] = graph_ms(run)
        case["unfused_ms"] = graph_ms(unfused)
        case["eager_ms"] = time_ms(run)
        case["unfused_eager_ms"] = time_ms(unfused)
        case["kernel_ms"] = kernel_ms(run, "snake_conv")
        case["host_us_per_call"] = _host_us_per_call(run)
        case["plain_ms"] = time_ms(
            lambda: snake_conv_plain(x, alpha, beta, w, bias, d, True))
        case["library_ms"] = None
        conv = 2.0 * b * t * k * c * c
        act = K2_OPS_PER_SAMPLE * b * c * t
        nbytes = (2.0 * b * c * t + k * c * c) * x.element_size() + 12 * c
        if fp32:
            case["cuda_core_ms"] = k3_cuda_core(lambda: graph_ms(run))
            # split TF32: the products on the tensor cores, the activation
            # (once: the kernel's recomputation per output-channel block is
            # its design's cost, not the function's) on the CUDA cores
            _bound(case, conv, nbytes, "fp32", split_tf32=True,
                   cuda_core_flops=act)
            # the CUDA cores' floor as the attention kernels' rows count it:
            # the whole function, the activation once
            case["cuda_core_bound_ms"] = max(
                (conv + act) / PEAK_FLOPS["fp32"] * 1e3,
                case["bound_floors_ms"]["bytes"])
        else:
            _bound(case, conv + act, nbytes, dt_name(dtype))
    results.append(case)


# K3 at the eligible shapes that the gate (C >= 768, k <= 7) leaves to the
# unfused route: (C, T at batch 2, k), each at d = 1 and 5, bfloat16
K3_UNGATED = [(384, 13776, 3), (384, 13776, 7), (384, 13776, 11),
              (768, 3444, 11)]
# K3 in float32 as inference_e2e runs it: one channel per generator pass
# (batch 1), a 10 s clip's 861 mel frames padded to 896 (the Vocoder's pad
# multiple of 64) and upsampled 4x into the C = 768 stage
K3_E2E = (1, 896 * 4)


def check_k3(gen, results):
    """fused_snake_conv vs its plain version (plain activation +
    ``F.conv1d``).  float32: 2e-4 of the output's scale (sums of 768*k terms
    in another order, each product as three TF32 products: the dropped
    a_lo b_lo terms are ~2^-21 of a product), the same bits in two runs;
    bfloat16: 2e-2 of the output's scale (both round the activation to
    bfloat16; the products' sums in another order).  The serving and
    stage-2 shapes are timed in both types (bfloat16 against the unfused
    route too), a 40-sample clip and a ragged T are compared, the ungated
    shapes are compared and timed in bfloat16, and the six float32 shapes
    of ``inference_e2e`` (K3_E2E) are timed beside the unfused route with
    TF32 off; every timed float32 shape also beside the earlier CUDA-core
    kernel (``cuda_core_ms``)."""
    c = 768
    cases = [(b, t, k, d) for b, t in ((2, 3444), (GAN_BATCH, 256))
             for k in (3, 7) for d in (1, 3, 5)]
    for b, t, k, d in cases:
        _k3_case(gen, results, b, c, t, k, d, torch.float32, 2e-4, True)
        _k3_case(gen, results, b, c, t, k, d, torch.bfloat16, 2e-2, True)
    # float32 at inference_e2e's shapes, timed beside the unfused route
    b, t = K3_E2E
    for k in (3, 7):
        for d in (1, 3, 5):
            _k3_case(gen, results, b, c, t, k, d, torch.float32, 2e-4, True)
    # one tile that crosses both clip edges; a ragged T of several tiles
    for b, t, k, d in ((1, 40, 7, 5), (2, 1001, 3, 3)):
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            _k3_case(gen, results, b, c, t, k, d, dtype, tol, False)
    for cc, t, k in K3_UNGATED:
        for d in (1, 5):
            _k3_case(gen, results, 2, cc, t, k, d, torch.bfloat16, 2e-2, True)
        torch.cuda.empty_cache()


# per sample: two up-FIR phases recomputed (12 each), two adjoint down-FIR
# phases (12 each), two snake derivatives (~10 each, sincos as one), one
# adjoint up-FIR (24)
K2B_OPS_PER_SAMPLE = 2 * 12 + 2 * 12 + 2 * 10 + 24


def _grad_case(name, case, got, want, labels, tol):
    """Compare gradient tuples: each against ``tol`` of its own scale (an
    absolute floor of 1e-6 of the largest keeps tiny sums from failing on
    rounding).  Returns the worst error as a share of its gradient's
    scale."""
    top = max(w.float().abs().max().item() for w in want)
    worst = 0.0
    for label, g, w in zip(labels, got, want):
        scale = w.float().abs().max().item()
        err = _compare(name, (*case, label), g, w, tol + 1e-6 * top / max(
            scale, 1e-30), relative=True)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def check_k2b(gen, results):
    """fused_alias_free_snake_backward (K2b) vs its plain version, dx, d alpha
    and d beta on every sample, edges included.  float32: 2e-5 of each
    gradient's scale (same float32 arithmetic, other order; sincos against
    sin); bfloat16: dx 8e-3 of its scale (both round one float32 result to
    bfloat16), d alpha / d beta 2e-5 (float32 sums of the same products).
    Two runs on the same inputs must give the same bits (no atomics).  The
    six stage-2 shapes are timed as K2 is (``ms`` by graph replay,
    ``kernel_ms`` the kernel alone, host µs), with the earlier tiled kernel
    beside it (``tiled_ms``, ``tiled_kernel_ms``); ragged shapes — T = 7 (shorter than the
    filters' reach), 40 (one run of each kind at both edges), 1001 (T not a
    multiple of 8: every run on the edge path) at narrow and wide C — are
    compared."""
    from diffbinaural_tpu_torch.ops import (alias_free_snake_backward_plain,
                                            fused_alias_free_snake_backward)
    from diffbinaural_tpu_torch.ops import alias_free_act_variants as afv

    ragged = [(2, c, t) for c in (24, 768) for t in (7, 40, 1001)]
    for shape in [(GAN_BATCH, c, t) for c, t in GAN_STAGES] + ragged:
        b, c, t = shape
        for dtype in (torch.float32, torch.bfloat16):
            x, dz = rand(gen, shape, dtype), rand(gen, shape, dtype)
            alpha = rand(gen, (c,), torch.float32, 0.3)
            beta = rand(gen, (c,), torch.float32, 0.3)
            got = fused_alias_free_snake_backward(x, dz, alpha, beta, True)
            again = fused_alias_free_snake_backward(x, dz, alpha, beta, True)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                fail(f"fused_alias_free_snake_backward {shape}: two runs on "
                     f"the same inputs differ")
            del again
            want = alias_free_snake_backward_plain(x, dz, alpha, beta, True)
            tol_dx = 8e-3 if dtype == torch.bfloat16 else 2e-5
            worst = _grad_case("fused_alias_free_snake_backward",
                               (shape, dt_name(dtype)), got[:1], want[:1],
                               ("dx",), tol_dx)
            worst_p = _grad_case("fused_alias_free_snake_backward",
                                 (shape, dt_name(dtype)), got[1:], want[1:],
                                 ("dalpha", "dbeta"), 2e-5)
            case = {"kernel": "fused_alias_free_snake_backward",
                    "shape": list(shape), "dtype": dt_name(dtype),
                    "max_err": max((g.float() - w.float()).abs().max().item()
                                   for g, w in zip(got, want)),
                    "dx_err_of_scale": worst, "dx_tol_of_scale": tol_dx,
                    "dparam_err_of_scale": worst_p, "dparam_tol_of_scale": 2e-5}
            if b == GAN_BATCH:
                def run():
                    return fused_alias_free_snake_backward(x, dz, alpha, beta,
                                                           True)
                case["ms"] = graph_ms(run)
                case["eager_ms"] = time_ms(run)
                case["kernel_ms"] = kernel_ms(run, "afa_snake_bwd")
                case["host_us_per_call"] = _host_us_per_call(run)

                def tiled():
                    return afv.backward(TILED_K2B, "tiled", x, dz, alpha,
                                        beta, True)
                case["tiled_ms"] = graph_ms(tiled)
                case["tiled_kernel_ms"] = kernel_ms(tiled, "afa_snake_bwd")
                case["plain_ms"] = time_ms(
                    lambda: alias_free_snake_backward_plain(x, dz, alpha, beta,
                                                            True))
                case["library_ms"] = None
                n = float(b * c * t)
                # x and dz read, dx written; alpha, beta read and the
                # per-channel gradients written in float32
                _bound(case, K2B_OPS_PER_SAMPLE * n,
                       3 * n * x.element_size() + 16 * c, "fp32")
            del got, want
            results.append(case)


def _conv_grad_cases(results, x, dy, alpha, beta, w, d, timed):
    """The dz kernel (``snake_conv_dgrad``) and the dW kernel
    (``snake_conv_wgrad``, on K2's z) against their plain versions, float32
    ``conv1d_input`` / ``conv1d_weight`` on the same bfloat16 inputs.  dz:
    1e-2 of its scale (both round one float32 sum of exact bfloat16
    products to bfloat16); dW (float32): 1e-4 of its scale (sums of B*T
    exact products in another order).  Timed: ``ms`` by graph replay,
    ``kernel_ms``, and ``library_ms``, the same gradient from one
    ``torch.nn.grad`` call in bfloat16 (cuDNN)."""
    from diffbinaural_tpu_torch.ops import (fused_alias_free_snake,
                                            snake_conv_dgrad,
                                            snake_conv_dgrad_plain,
                                            snake_conv_wgrad,
                                            snake_conv_wgrad_plain)

    b, c, t = x.shape
    k = w.shape[2]
    pad = (k - 1) // 2 * d
    z = fused_alias_free_snake(x, alpha, beta, True)
    runs = {
        "snake_conv_dgrad": (
            lambda: snake_conv_dgrad(dy, w, d),
            lambda: snake_conv_dgrad_plain(dy, w, d),
            lambda: torch.nn.grad.conv1d_input(dy.shape, w, dy, padding=pad,
                                               dilation=d),
            1e-2, "snake_conv_dgrad_kernel",
            # dy and W read, dz written, in bfloat16
            2.0 * (2 * b * c * t + k * c * c)),
        "snake_conv_wgrad": (
            lambda: snake_conv_wgrad(z, dy, k, d),
            lambda: snake_conv_wgrad_plain(z, dy, k, d),
            lambda: torch.nn.grad.conv1d_weight(z, w.shape, dy, padding=pad,
                                                dilation=d),
            1e-4, "snake_conv_wgrad",
            # z and dy read in bfloat16, dW written in float32
            2.0 * 2 * b * c * t + 4.0 * k * c * c),
    }
    for name, (run, plain, library, tol, kname, nbytes) in runs.items():
        got, want = run(), plain()
        if not torch.equal(got, run()):
            fail(f"{name} {(b, c, t, k, d)}: two runs on the same inputs differ")
        err = _compare(name, (b, c, t, k, d), got, want, tol, relative=True)
        case = {"kernel": name, "shape": [b, c, t], "k": k, "dilation": d,
                "dtype": "bf16", "max_err": err, "tol": tol,
                "tol_relative_to_output_scale": True,
                "err_of_scale": err / want.float().abs().max().item()}
        if timed:
            case["ms"] = graph_ms(run)
            case["kernel_ms"] = kernel_ms(run, kname)
            case["host_us_per_call"] = _host_us_per_call(run)
            case["plain_ms"] = time_ms(plain)
            case["library_ms"] = graph_ms(library)
            _bound(case, 2.0 * b * t * k * c * c, nbytes, "bf16")
        results.append(case)
        del got, want


# K3b's timed shapes: the stage-2 step's (B, C, T) at each (k, d) of its two
# fused AMP blocks, and the C = 384 stage at d = 5 (the shapes a re-gate of
# K3 would add), each (B, C, T, k, d)
K3B_TIMED = ([(GAN_BATCH, 768, 256, k, d) for k in (3, 7) for d in (1, 3, 5)]
             + [(2, 384, 13776, k, 5) for k in (3, 7, 11)])


def check_k3b(gen, results):
    """fused_snake_conv_backward (K3b) vs its plain version (autograd through
    ``snake_conv_plain``): dx, d alpha, d beta, dW, db.  float32 (the
    composition: K2, the library's convolution gradients, K2b): 1e-4 of
    each gradient's scale (sums of C*k or B*T terms in another order);
    bfloat16 (K2, the dz kernel, K2b, the dW kernel): 3e-2 (the plain
    version rounds the activation to bfloat16 before the convolution and its
    gradients; dW sums B*T bfloat16 products), and two runs on the same
    inputs must give the same bits.  The timed shapes (``K3B_TIMED``) are
    compared and timed in bfloat16 (``ms`` by graph replay, ``kernel_ms``
    the device time of all it launches, ``parts``: each kernel's device ms
    per call, ``composed_ms``: the composition timed the same way), the
    C = 768 ones also compared in float32; a 40-sample clip (one tile, both
    edges) is compared.  At every bfloat16 shape the dz and dW kernels are
    also held against their plain versions (``_conv_grad_cases``)."""
    from diffbinaural_tpu_torch.ops import (fused_snake_conv_backward,
                                            fused_snake_conv_backward_composed,
                                            snake_conv_backward_plain)

    cases = [(*shape, dtype) for shape in K3B_TIMED
             for dtype in (torch.float32, torch.bfloat16)
             if dtype == torch.bfloat16 or shape[1] == 768]
    cases += [(2, 768, 40, 7, 5, dtype)
              for dtype in (torch.float32, torch.bfloat16)]
    labels = ("dx", "dalpha", "dbeta", "dW", "db")
    for b, c, t, k, d, dtype in cases:
        bf16 = dtype == torch.bfloat16
        tol = 3e-2 if bf16 else 1e-4
        x, dy = rand(gen, (b, c, t), dtype), rand(gen, (b, c, t), dtype)
        alpha = rand(gen, (c,), torch.float32, 0.3)
        beta = rand(gen, (c,), torch.float32, 0.3)
        w = rand(gen, (c, c, k), dtype, 0.02)
        bias = rand(gen, (c,), torch.float32, 0.1)
        args = (x, dy, alpha, beta, w, bias, d, True)
        got = fused_snake_conv_backward(*args)
        if bf16:
            again = fused_snake_conv_backward(*args)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                fail(f"fused_snake_conv_backward {(b, c, t, k, d)}: two runs "
                     f"on the same inputs differ")
            del again
        want = snake_conv_backward_plain(*args)
        worst = _grad_case("fused_snake_conv_backward",
                           (b, c, t, k, d, dt_name(dtype)), got, want, labels,
                           tol)
        case = {"kernel": "fused_snake_conv_backward", "shape": [b, c, t],
                "k": k, "dilation": d, "dtype": dt_name(dtype),
                "max_err": max((g.float() - v.float()).abs().max().item()
                               for g, v in zip(got, want)),
                "worst_err_of_scale": worst, "tol_of_scale": tol}
        del got, want
        timed = (b, c, t, k, d) in K3B_TIMED and bf16
        if timed:
            def run():
                return fused_snake_conv_backward(*args)
            case["ms"] = graph_ms(run)
            case["composed_ms"] = graph_ms(
                lambda: fused_snake_conv_backward_composed(*args))
            case["eager_ms"] = time_ms(run)
            case["kernel_ms"] = kernel_ms(run, "")
            case["parts"] = kernel_split(run)
            case["host_us_per_call"] = _host_us_per_call(run)
            case["plain_ms"] = time_ms(
                lambda: snake_conv_backward_plain(*args))
            case["library_ms"] = None
            n = float(b * c * t)
            # dz and dW: two products of 2 B T k C^2; K2 and K2b around
            flops = (4.0 * b * t * k * c * c
                     + (K2_OPS_PER_SAMPLE + K2B_OPS_PER_SAMPLE) * n)
            # x, dy, W read; dx, dW written; the per-channel vectors
            nbytes = (3 * n + 2 * k * c * c) * x.element_size() + 28 * c
            _bound(case, flops, nbytes, dt_name(dtype))
        results.append(case)
        if bf16:
            _conv_grad_cases(results, x, dy, alpha, beta, w, d, timed)
        del x, dy, w
        torch.cuda.empty_cache()


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: list = []
    check_k2(gen, results)
    check_k2b(gen, results)
    check_k3(gen, results)
    check_k3b(gen, results)
    check_k1(gen, results)
    torch.cuda.empty_cache()
    check_k1_training(gen, results)
    emit({"phase": "kernels", "cases": results})
    return results


# ------------------------------------------------------------- main path


@contextlib.contextmanager
def plain_versions():
    """Route the model code to the plain PyTorch versions of the three ops
    (a comparison aid of this script only: the package has no such switch)."""
    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.models import attention, bigvgan

    saved = (attention.flash_sdpa, bigvgan.fused_alias_free_snake,
             bigvgan.fused_snake_conv)
    attention.flash_sdpa = ops.sdpa_plain
    bigvgan.fused_alias_free_snake = ops.alias_free_snake_plain
    bigvgan.fused_snake_conv = ops.snake_conv_plain
    try:
        yield
    finally:
        (attention.flash_sdpa, bigvgan.fused_alias_free_snake,
         bigvgan.fused_snake_conv) = saved


def build_unet(dtype, seed):
    from diffbinaural_tpu_torch import models

    return models.build_unet(dtype=dtype, seed=seed)


def build_models(dtype):
    from diffbinaural_tpu_torch.models import build_vocoder

    return build_unet(dtype, seed=0), build_vocoder(dtype=dtype, seed=1)


def phase_main_path_check() -> None:
    """Full-width UNet + vocoder in float32 (TF32 off): the path through the
    kernels against the same path through the plain versions.  One UNet call
    and 2 DDIM steps on one group of 8 windows, and the vocoder on a 2 s
    stereo mel.  Tolerances: one UNet call 2e-4 of the output's scale (~40
    layers, attention sums in another order); stage-1 output 2e-3 absolute
    on values in [-1, 1] (two UNet calls whose random-weight output is ~100
    times the clip range, so differences are amplified before the clip);
    waveform 1e-3 of the output's scale (six upsampling stages, 768*k-term
    sums in another order; random weights give a waveform far below 1, so
    an absolute tolerance would say nothing).

    Then the same UNet call in bfloat16, as the 10 s clip runs it, so that
    the tensor-core attention kernel is held inside the model too: through
    the kernels against through the plain versions, BF16_UNET_TOL of the
    output's scale (every layer rounds to bfloat16, so a last-bit difference
    in one attention output is carried and re-rounded through the rest of
    the ~40 layers).  Each bfloat16 output's distance from the float32 one
    is printed beside it: the kernels must not move the model further from
    float32 than bfloat16 itself does."""
    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
    unet, voc = build_models(torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(3)
    diffusion = GaussianDiffusion(image_size=WINDOW, timesteps=1000,
                                  sampling_timesteps=2)
    mono = torch.rand((UNET_BATCH, 1, WINDOW, WINDOW), generator=gen,
                      device="cuda") * 2 - 1
    feats = torch.randn((UNET_BATCH, 512), generator=gen, device="cuda")
    noise = torch.randn((UNET_BATCH, 2, WINDOW, WINDOW), generator=gen,
                        device="cuda")
    mel = torch.randn((2, 80, 172), generator=gen, device="cuda") - 6.0

    step = torch.full((UNET_BATCH,), 500, device="cuda", dtype=torch.int32)
    ops.reset_launch_counts()
    with torch.inference_mode():
        raw_k = unet(noise, step, (mono, feats, None))
        wav_k = voc(mel)
    pred_k = diffusion.ddim_sample(unet, (mono, feats), noise=noise)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    with plain_versions():
        with torch.inference_mode():
            raw_p = unet(noise, step, (mono, feats, None))
            wav_p = voc(mel)
        pred_p = diffusion.ddim_sample(unet, (mono, feats), noise=noise)
    torch.cuda.synchronize()
    if ops.launch_counts() != counts:
        fail("plain_versions() launched a kernel")
    if counts != launches(flash_sdpa=12, fused_alias_free_snake=97,
                          fused_snake_conv=12):
        fail(f"main_path_check launch counts {counts}")
    err_raw = _compare("main_path_check", "unet", raw_k, raw_p, 2e-4, True)
    err_pred = _compare("main_path_check", "stage1", pred_k, pred_p, 2e-3, False)
    err_wav = _compare("main_path_check", "vocoder", wav_k, wav_p, 1e-3, True)

    unet16 = build_unet(dtype=torch.bfloat16, seed=0)  # the same weights
    ops.reset_launch_counts()
    with torch.inference_mode():
        raw16_k = unet16(noise, step, (mono, feats, None))
        torch.cuda.synchronize()
        counts16 = ops.launch_counts()
        with plain_versions():
            raw16_p = unet16(noise, step, (mono, feats, None))
    if counts16["flash_sdpa"] != 4:
        fail(f"main_path_check bf16 launch counts {counts16}")
    err16 = _compare("main_path_check", "unet bf16", raw16_k, raw16_p,
                     BF16_UNET_TOL, True)
    k_vs_fp32 = _rel_rms(raw16_k, raw_p)
    p_vs_fp32 = _rel_rms(raw16_p, raw_p)
    if k_vs_fp32 > 1.5 * p_vs_fp32:
        fail(f"main_path_check unet bf16: through the kernels {k_vs_fp32:.3e} "
             f"of float32's rms away from float32, through the plain "
             f"versions {p_vs_fp32:.3e}")
    emit({"phase": "main_path_check", "dtype": "fp32", "tf32": False,
          "unet_max_err": err_raw, "unet_scale": raw_p.abs().max().item(),
          "unet_tol_of_scale": 2e-4,
          "stage1_max_err": err_pred, "stage1_tol": 2e-3,
          "vocoder_max_err": err_wav,
          "vocoder_scale": wav_p.abs().max().item(),
          "vocoder_tol_of_scale": 1e-3, "launches": counts,
          "unet_bf16_max_err": err16,
          "unet_bf16_scale": raw16_p.float().abs().max().item(),
          "unet_bf16_tol_of_scale": BF16_UNET_TOL,
          "unet_bf16_rms_err_of_rms": _rel_rms(raw16_k, raw16_p),
          "unet_bf16_kernels_vs_fp32_rms": k_vs_fp32,
          "unet_bf16_plain_vs_fp32_rms": p_vs_fp32})
    del unet, voc, unet16
    torch.cuda.empty_cache()


def trace(part: str, fn, calls: int) -> dict:
    """Device time by kernel over ``calls`` calls of ``fn``, from
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernels only: the host-side operator rows, and the
    # device-side copy of a host annotation (the optimiser's step), carry the
    # same device time once more
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        fail("trace: the profiler reported no device time")
    rows.sort(key=lambda r: -r[1])
    return {
        "phase": "trace", "part": part, "calls": calls,
        "wall_ms_per_call": wall_ms / calls,
        "device_ms_per_call": device_ms / calls,
        "device_busy_share": device_ms / wall_ms,
        "device_kernels_per_call": sum(r[2] for r in rows) / calls,
        "top": [{"kernel": k[:80], "ms_per_call": ms / calls,
                 "launches_per_call": n / calls} for k, ms, n in rows[:10]],
    }


def phase_main_path(trace_steps: int = 0) -> dict:
    """The 10 s clip at full width in bfloat16, through the entry point a
    user calls (``BinauralPipeline``).  With ``trace_steps`` > 0 that many
    UNet calls and one vocoder pass are also traced."""
    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.infer.pipeline import BinauralPipeline

    total_frames = int(CLIP_SECONDS * SR) // HOP  # 861
    unet, voc = build_models(torch.bfloat16)
    pipe = BinauralPipeline(unet, voc, total_frames, unet_batch=UNET_BATCH,
                            sampling_timesteps=DDIM_STEPS)
    rng = np.random.default_rng(0)

    def fresh_clip():
        mono = rng.standard_normal((1, 80, total_frames)).astype(np.float32) - 6.0
        feats = rng.standard_normal((pipe.n_windows, 512)).astype(np.float32)
        return mono, feats

    gen = torch.Generator(device="cuda").manual_seed(13)
    wav = pipe(*fresh_clip(), generator=gen)  # warm-up clip
    torch.cuda.synchronize()

    def timed_clip():
        mono, feats = fresh_clip()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(mono, feats, generator=gen)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ops.reset_launch_counts()
    wav, first = timed_clip()
    counts = ops.launch_counts()
    runs = [first] + [timed_clip()[1] for _ in range(2)]
    seconds = statistics.median(runs)

    if tuple(wav.shape) != (2, total_frames * HOP):
        fail(f"main_path: output shape {tuple(wav.shape)}")
    if not torch.isfinite(wav).all():
        fail("main_path: non-finite waveform")
    if wav.abs().max().item() > 1.0:
        fail("main_path: waveform outside [-1, 1]")
    expected = launches(flash_sdpa=300, fused_alias_free_snake=97,
                        fused_snake_conv=12)
    if counts != expected:
        fail(f"main_path: launch counts {counts} != {expected}")

    # the split: one UNet call on a group of 8, one vocoder pass on the clip
    x = torch.randn((UNET_BATCH, 2, WINDOW, WINDOW), device="cuda")
    cond = (torch.rand((UNET_BATCH, 1, WINDOW, WINDOW), device="cuda"),
            torch.randn((UNET_BATCH, 512), device="cuda"), None)
    tt = torch.full((UNET_BATCH,), 500, device="cuda", dtype=torch.int32)
    mel = torch.randn((2, 80, total_frames), device="cuda") - 6.0
    with torch.inference_mode():
        unet_ms = time_run_ms(lambda: unet(x, tt, cond), calls=10)
        voc_ms = time_run_ms(lambda: voc(mel), calls=3)
    out = {"phase": "main_path", "dtype": "bf16", "frames": total_frames,
           "windows": pipe.n_windows, "groups": pipe.n_batches,
           "ddim_steps": DDIM_STEPS, "output_shape": list(wav.shape),
           "abs_max": wav.abs().max().item(),
           "seconds_per_clip": seconds, "seconds_per_clip_runs": runs,
           "sync": "synchronize + host clock, median of 3 clips; steps: "
                   "CUDA events around back-to-back calls",
           "unet_step_ms": unet_ms, "unet_steps_per_clip":
               pipe.n_batches * DDIM_STEPS, "vocoder_pass_ms": voc_ms,
           "launches": counts}
    emit(out)
    if trace_steps > 0:
        with torch.inference_mode():
            emit(trace("unet_step", lambda: unet(x, tt, cond), trace_steps))
            emit(trace("vocoder_pass", lambda: voc(mel), 1))
    return out


# ------------------------------------------------- serving from checkpoints

SERVE_BUCKET, DPM_STEPS, SERVE_CLIPS = 64, 12, 4  # CLI default bucket; 1 + 3
SERVE_SAMPLERS = (("ddim", DDIM_STEPS), ("dpm++", DPM_STEPS))


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_tensors(name, got, want) -> int:
    """Every tensor of ``got``'s state dict bit for bit that of ``want``."""
    a, b = got.state_dict(), want.state_dict()
    if a.keys() != b.keys():
        fail(f"{name}: state dict keys differ")
    bad = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    if bad:
        fail(f"{name}: {len(bad)} tensors differ after the round trip, e.g. "
             f"{bad[:3]}")
    return len(a)


def phase_checkpoint_roundtrip(workdir: str) -> dict:
    """The full-width serving UNet (dim 64) and the generator of
    ``GAN_CONFIG``, random from seeds, written as the JAX trainers write
    them (``tree_to_flax`` -> ``save_checkpoint``: ``unet_best.pth`` = the
    UNet's variables, ``voc/g_00000001`` = ``{"generator": variables}``,
    the config copied beside it) and loaded back onto the card into models
    built from other seeds: every tensor bit for bit.  The generator also
    goes through the upstream BigVGAN names (``export_bigvgan_to_torch`` ->
    ``torch.save`` -> ``from_pretrained``'s torch branch), again bit for
    bit.  Seconds: save = card -> flax tree -> file; load = file -> tree;
    to_card = tree -> ``state_dict`` -> ``load_state_dict`` on the card;
    build = a model with random weights on the card, as the CLI builds it
    before loading."""
    import os
    import shutil

    from diffbinaural_tpu_torch import models
    from diffbinaural_tpu_torch.convert import (bigvgan_params_from_flax,
                                                tree_to_flax,
                                                unet_params_from_flax)
    from diffbinaural_tpu_torch.core import checkpoint
    from diffbinaural_tpu_torch.core.config import (VocoderConfig,
                                                    load_hparams_from_json)

    cfg = VocoderConfig.from_attrdict(load_hparams_from_json(GAN_CONFIG))
    unet, unet_build_s = _timed(lambda: models.build_unet(seed=0))
    voc, voc_build_s = _timed(lambda: models.build_vocoder(cfg, seed=1))
    os.makedirs(os.path.join(workdir, "voc"))
    shutil.copy(GAN_CONFIG, os.path.join(workdir, "voc", "config.json"))
    paths = {"unet": os.path.join(workdir, "unet_best.pth"),
             "generator": os.path.join(workdir, "voc", "g_00000001")}
    out = {"phase": "checkpoint_roundtrip",
           "build_s": {"unet": unet_build_s, "generator": voc_build_s}}
    for name, model, wrap, to_sd, build in (
            ("unet", unet, lambda tree: {"params": tree},
             unet_params_from_flax, lambda: models.build_unet(seed=7)),
            ("generator", voc, lambda tree: {"generator": {"params": tree}},
             bigvgan_params_from_flax,
             lambda: models.build_vocoder(cfg, seed=7))):
        _, save_s = _timed(lambda: checkpoint.save_checkpoint(
            paths[name], wrap(tree_to_flax(model.state_dict()))))
        state, load_s = _timed(lambda: checkpoint.load_checkpoint(paths[name]))
        if name == "generator":
            state = state["generator"]
        back = build()
        _, to_card_s = _timed(lambda: back.load_state_dict(to_sd(state),
                                                           strict=True))
        n = _same_tensors(f"checkpoint_roundtrip {name}", back, model)
        out[name] = {"bytes": os.path.getsize(paths[name]), "tensors": n,
                     "save_s": save_s, "load_s": load_s,
                     "to_card_s": to_card_s, "bit_for_bit": True}
        del back, state

    # the upstream names: a torch state dict in a pretrained directory
    pre = os.path.join(workdir, "pretrained")
    os.makedirs(pre)
    shutil.copy(GAN_CONFIG, os.path.join(pre, "config.json"))
    sd = checkpoint.export_bigvgan_to_torch(tree_to_flax(voc.state_dict()), cfg)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()},
               os.path.join(pre, "bigvgan_generator.pt"))
    (params, _), load_s = _timed(lambda: checkpoint.from_pretrained(pre))
    back = models.build_vocoder(cfg, seed=8)
    back.load_state_dict(bigvgan_params_from_flax(params), strict=True)
    n = _same_tensors("checkpoint_roundtrip upstream names", back, voc)
    out["generator_upstream_names"] = {
        "bytes": os.path.getsize(os.path.join(pre, "bigvgan_generator.pt")),
        "state_dict_keys": len(sd), "tensors": n, "load_s": load_s,
        "bit_for_bit": True}
    del back, params, sd
    emit(out)
    torch.cuda.empty_cache()
    return {"paths": paths, "unet": unet, "voc": voc, "config": cfg}


def phase_dpm_check() -> None:
    """DPM-Solver++(2M), 3 steps, on one group of 8 full-width windows in
    float32 (TF32 off): the path through the kernels against the same path
    through the plain versions, under main_path_check's stage-1 tolerance
    (2e-3 absolute on the clipped output)."""
    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.diffusion import GaussianDiffusion

    unet = build_unet(torch.float32, seed=0)
    diffusion = GaussianDiffusion(image_size=WINDOW, timesteps=1000,
                                  sampling_timesteps=3)
    gen = torch.Generator(device="cuda").manual_seed(4)
    mono = torch.rand((UNET_BATCH, 1, WINDOW, WINDOW), generator=gen,
                      device="cuda") * 2 - 1
    feats = torch.randn((UNET_BATCH, 512), generator=gen, device="cuda")
    noise = torch.randn((UNET_BATCH, 2, WINDOW, WINDOW), generator=gen,
                        device="cuda")
    ops.reset_launch_counts()
    pred_k = diffusion.dpm_sample(unet, (mono, feats), noise=noise)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    with plain_versions():
        pred_p = diffusion.dpm_sample(unet, (mono, feats), noise=noise)
    torch.cuda.synchronize()
    if ops.launch_counts() != counts:
        fail("plain_versions() launched a kernel")
    if counts != launches(flash_sdpa=3 * ATTN_PER_STEP):
        fail(f"dpm_check launch counts {counts}")
    err = _compare("dpm_check", "stage1", pred_k, pred_p, 2e-3, False)
    emit({"phase": "dpm_check", "dtype": "fp32", "tf32": False, "steps": 3,
          "time_pairs": diffusion._dpm_time_pairs(3).tolist(),
          "stage1_max_err": err, "stage1_tol": 2e-3, "launches": counts})
    del unet
    torch.cuda.empty_cache()


@contextlib.contextmanager
def captured_writes(module):
    """Record each waveform a CLI module hands to ``save_wav`` (a copy, the
    host clock and the launch counts at that moment) and silence its
    printing: a comparison aid of this script, the write itself goes on."""
    import io

    from diffbinaural_tpu_torch import ops

    records, write = [], module.save_wav

    def recording(path, audio, sr):
        records.append({"wav": np.array(audio), "t": time.perf_counter(),
                        "counts": ops.launch_counts()})
        write(path, audio, sr)

    module.save_wav = recording
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            yield records
    finally:
        module.save_wav = write


def synthetic_clip(seed: int) -> np.ndarray:
    """A 10 s, 22.05 kHz mono signal: three tones with a slow envelope plus
    a little noise, from ``seed``."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(CLIP_SECONDS * SR)) / SR
    y = sum(a * np.sin(2 * np.pi * f * tt + p) for a, f, p in zip(
        rng.uniform(0.05, 0.2, 3), rng.uniform(100, 4000, 3),
        rng.uniform(0, 2 * np.pi, 3)))
    y = y * (0.6 + 0.4 * np.sin(2 * np.pi * 0.3 * tt))
    return (y + 0.01 * rng.standard_normal(tt.shape)).astype(np.float32)


def _bit_for_bit(name, got, want) -> None:
    if got.shape != want.shape:
        fail(f"{name}: shape {got.shape} vs {want.shape}")
    err = float(np.abs(got.astype(np.float64) - want).max())
    if err != 0.0:
        fail(f"{name}: not bit for bit, max_abs_err {err:.3e}")


def phase_serve_cli(ck: dict, workdir: str, trace_steps: int = 0) -> dict:
    """``cli.generate_binaural.main([... "--bf16"])`` from the checkpoints of
    ``checkpoint_roundtrip`` on SERVE_CLIPS seeded 10 s clips (861 frames,
    padded to an 896-frame bucket: 22 windows, 3 groups of 8), first with
    DDIM-25, then with ``--sampler dpm++ --ddim_steps 12``, under
    ``deterministic_algorithms()``.  Per clip: the wav is (2, 861 * 256),
    finite and not silent; K1 / K2 / K3 launch (300 | 144, 97, 12) times.
    The first clip's waveform equals ``BinauralPipeline`` called directly on
    the in-memory models (bfloat16 compute, the checkpoint's weights) with
    the same padded mel and seed 13, bit for bit.  Seconds per clip: the
    host clock between consecutive clips' writes, median of the 3 after the
    first (which also loads the checkpoints and builds the models).  Then
    the three vocoder CLIs on the first clip's stitched mels (as .npy):
    ``inference_e2e`` against ``Vocoder.vocode_binaural``,
    ``inference_binaural`` and ``inference_diffbinaural_mels`` against
    ``BinauralBigVGAN``, each on the in-memory float32 generator, bit for
    bit.  With ``trace_steps`` > 0 one clip of each sampler is also
    traced (``BinauralPipeline`` on the padded mel)."""
    import math
    import os

    from diffbinaural_tpu_torch import models, ops
    from diffbinaural_tpu_torch.cli import (generate_binaural,
                                            inference_binaural,
                                            inference_diffbinaural_mels,
                                            inference_e2e)
    from diffbinaural_tpu_torch.data.audio_io import load_wav, save_wav
    from diffbinaural_tpu_torch.infer.pipeline import BinauralPipeline
    from diffbinaural_tpu_torch.infer.vocoder import Vocoder
    from diffbinaural_tpu_torch.models import BinauralBigVGAN
    from diffbinaural_tpu_torch.signal.stft import mel_spectrogram

    in_dir = os.path.join(workdir, "clips")
    for i in range(SERVE_CLIPS):
        save_wav(os.path.join(in_dir, f"clip{i}.wav"), synthetic_clip(10 + i),
                 SR)
    audio, _ = load_wav(os.path.join(in_dir, "clip0.wav"))
    frames = len(audio) // HOP
    bucket = -(-frames // SERVE_BUCKET) * SERVE_BUCKET
    with torch.inference_mode():
        mel = mel_spectrogram(torch.from_numpy(audio[None, : frames * HOP])
                              .cuda(), 1024, 80, SR, HOP, 1024, 0.0, None)
        mel = F.pad(mel[..., :frames], (0, bucket - frames),
                    value=math.log(1e-5))
    unet16 = models.build_unet(dtype=torch.bfloat16, seed=99)
    unet16.load_state_dict(ck["unet"].state_dict())
    voc16 = models.build_vocoder(ck["config"], dtype=torch.bfloat16, seed=99)
    voc16.load_state_dict(ck["voc"].state_dict())
    feats = np.zeros((512,), np.float32)

    out = {"phase": "serve_cli", "clip_frames": frames, "bucket": bucket,
           "clips": SERVE_CLIPS, "dtype": "bf16",
           "deterministic_algorithms": True}
    for sampler, steps in SERVE_SAMPLERS:
        args = ["--input_wav", in_dir,
                "--output_dir", os.path.join(workdir, "out_" + sampler),
                "--weights_unet", ck["paths"]["unet"],
                "--vocoder_checkpoint", ck["paths"]["generator"],
                "--ddim_steps", str(steps), "--sampler", sampler, "--bf16"]
        with deterministic_algorithms(), captured_writes(
                generate_binaural) as records:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            generate_binaural.main(args)
            pipe = BinauralPipeline(unet16, voc16, bucket,
                                    unet_batch=UNET_BATCH,
                                    sampling_timesteps=steps, sampler=sampler)
            direct = pipe(mel, feats)[:, : frames * HOP].float().cpu().numpy()
        if len(records) != SERVE_CLIPS:
            fail(f"serve_cli {sampler}: {len(records)} wavs written")
        expected = launches(flash_sdpa=pipe.n_batches * steps * ATTN_PER_STEP,
                            fused_alias_free_snake=ACT_PER_PASS,
                            fused_snake_conv=FUSED_PER_PASS)
        before = launches()
        for i, r in enumerate(records):
            wav = r["wav"]
            per_clip = {k: r["counts"][k] - before[k] for k in before}
            before = r["counts"]
            if wav.shape != (2, frames * HOP) or not np.isfinite(wav).all():
                fail(f"serve_cli {sampler} clip {i}: shape {wav.shape} or "
                     "non-finite samples")
            if np.abs(wav).max() < 2 / 32767:  # below 2 steps of the int16 file
                fail(f"serve_cli {sampler} clip {i}: silent")
            if per_clip != expected:
                fail(f"serve_cli {sampler} clip {i}: launch counts {per_clip} "
                     f"!= {expected}")
        _bit_for_bit(f"serve_cli {sampler}: CLI against BinauralPipeline",
                     records[0]["wav"], direct)
        runs = [records[i]["t"] - records[i - 1]["t"]
                for i in range(1, SERVE_CLIPS)]
        out[sampler] = {
            "steps": steps, "windows": pipe.n_windows, "groups": pipe.n_batches,
            "first_clip_s": records[0]["t"] - t0,
            "seconds_per_clip": statistics.median(runs),
            "seconds_per_clip_runs": runs,
            "launches_per_clip": {k: v for k, v in expected.items() if v},
            "abs_max": float(np.abs(records[0]["wav"]).max()),
            "equals_pipeline": "bit for bit"}
        if trace_steps > 0:
            emit(trace(f"clip_{sampler}", lambda: pipe(mel, feats), 1))
        if sampler == "ddim":
            stitched = pipe.stitched_mel(mel, feats)[..., :frames]
    del unet16, voc16

    # the three vocoder CLIs on the DDIM clip's stitched mels, each against
    # the module it drives on the in-memory float32 generator
    left, right = (stitched[i].float().cpu().numpy() for i in range(2))
    mels = {side: os.path.join(workdir, "mels", side)
            for side in ("left", "right", "pairs")}
    for side, m in (("left", left), ("right", right)):
        os.makedirs(mels[side])
        np.save(os.path.join(mels[side], "clip0.npy"), m)
        os.makedirs(mels["pairs"], exist_ok=True)
        np.save(os.path.join(mels["pairs"], f"clip0_{side}.npy"), m)
    binaural = BinauralBigVGAN(ck["config"])
    binaural.generator = ck["voc"]
    binaural.eval()

    def binaural_wav():
        with torch.inference_mode():
            y = binaural(torch.from_numpy(left[None]).cuda(),
                         torch.from_numpy(right[None]).cuda())
        return y[0].float().cpu().numpy()

    lr_dirs = ["--input_mels_left_dir", mels["left"],
               "--input_mels_right_dir", mels["right"]]
    vocoder_clis = (  # name, module, its inputs, the module it drives, passes
        ("inference_e2e", inference_e2e, lr_dirs,
         lambda: Vocoder(ck["config"], model=ck["voc"]).vocode_binaural(
             left, right), 2),
        ("inference_binaural", inference_binaural,
         ["--input_mels_dir", mels["pairs"]], binaural_wav, 1),
        ("inference_diffbinaural_mels", inference_diffbinaural_mels, lr_dirs,
         lambda: np.clip(binaural_wav(), -1.0, 1.0), 1),
    )
    for name, module, inputs, direct_fn, passes in vocoder_clis:
        args = inputs + ["--checkpoint_file", ck["paths"]["generator"],
                         "--output_dir", os.path.join(workdir, "out_" + name),
                         "--use_cuda_kernel"]
        with deterministic_algorithms(), captured_writes(module) as records:
            ops.reset_launch_counts()
            _, seconds = _timed(lambda: module.main(args))
            counts = ops.launch_counts()
            want = direct_fn()
        if len(records) != 1:
            fail(f"serve_cli {name}: {len(records)} wavs written")
        _bit_for_bit(f"serve_cli {name} against the module it drives",
                     records[0]["wav"], want)
        if counts != launches(fused_alias_free_snake=passes * ACT_PER_PASS,
                              fused_snake_conv=passes * FUSED_PER_PASS):
            fail(f"serve_cli {name} launch counts {counts}")
        out[name] = {"seconds": seconds, "dtype": "fp32",
                     "launches": {k: v for k, v in counts.items() if v},
                     "equals_module": "bit for bit"}
    del binaural
    emit(out)
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------- training path


def phase_grad_flow() -> None:
    """On the card every differentiable wrapper — ``flash_sdpa``,
    ``fused_alias_free_snake``, ``fused_snake_conv`` — returns an output with
    a grad_fn when its inputs require grad and none under ``no_grad``, and a
    finite, non-zero gradient reaches every input."""
    from diffbinaural_tpu_torch import ops

    c = 768
    x = torch.randn((1, c, 64), device="cuda")
    alpha = torch.randn(c, device="cuda") * 0.3
    w = torch.randn((c, c, 3), device="cuda") * 0.02
    q = torch.randn((1, 4, 1600, 32), device="cuda")
    calls = {
        "flash_sdpa": (lambda a, b, v: ops.flash_sdpa(a, b, v, 32 ** -0.5),
                       (q, q.flip(2), q.flip(3))),
        "fused_alias_free_snake": (ops.fused_alias_free_snake,
                                   (x, alpha, alpha.flip(0))),
        "fused_snake_conv": (ops.fused_snake_conv,
                             (x, alpha, alpha.flip(0), w, alpha * 0.1)),
    }
    grad_fns = {}
    for name, (fn, inputs) in calls.items():
        leaves = [a.clone().requires_grad_() for a in inputs]
        out = fn(*leaves)
        if out.grad_fn is None:
            fail(f"grad_flow: {name}'s output has no grad_fn")
        grad_fns[name] = type(out.grad_fn).__name__
        grads = torch.autograd.grad(out.square().sum(), leaves)
        torch.cuda.synchronize()
        for i, g in enumerate(grads):
            if not torch.isfinite(g).all() or not g.abs().max() > 0:
                fail(f"grad_flow: no finite non-zero gradient reached input "
                     f"{i} of {name}")
        with torch.no_grad():
            if fn(*leaves).grad_fn is not None:
                fail(f"grad_flow: {name} under no_grad has a grad_fn")
    emit({"phase": "grad_flow", "grad_fn": grad_fns})


def synthetic_batch(batch: int, seed: int) -> dict:
    """A stage-1 batch from a seeded synthetic stereo signal: drifting tones
    and noise, the right channel delayed and attenuated against the left;
    ln-mels of the two channels and of their mean by the port's own mel
    frontend on the card, cut into ``batch`` windows of 80 frames; visual
    features from the seed."""
    from diffbinaural_tpu_torch.signal import mel_spectrogram, num_frames

    n = batch * WINDOW * HOP
    rng = np.random.default_rng(seed)
    time_s = np.arange(n) / SR
    left = np.zeros(n)
    for f0 in (220.0, 523.0, 1370.0, 4100.0):
        drift = 1.0 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.05, 0.3) * time_s)
        left += rng.uniform(0.05, 0.25) * np.sin(2 * np.pi * f0 * drift * time_s)
    left += 0.02 * rng.standard_normal(n)
    right = 0.7 * np.roll(left, 14) + 0.02 * rng.standard_normal(n)
    stereo = torch.from_numpy(np.stack([left, right]).astype(np.float32)).cuda()
    frames = num_frames(n)
    if frames != batch * WINDOW:
        fail(f"train_path: {frames} mel frames from {n} samples")
    binaural = mel_spectrogram(stereo)                            # (2, 80, T)
    mono = mel_spectrogram(stereo.mean(dim=0, keepdim=True))      # (1, 80, T)

    def windows(mel):  # (C, 80, batch * 80) -> (batch, C, 80, 80)
        c = mel.shape[0]
        return mel.reshape(c, 80, batch, WINDOW).permute(2, 0, 1, 3).contiguous()

    feat = torch.from_numpy(
        rng.standard_normal((batch, 512)).astype(np.float32)).cuda()
    return {"mono_mel": windows(mono), "binaural_mel": windows(binaural),
            "feat": feat}


# one gradient against its plain-path twin: this share of the gradient's own
# scale, plus this share of the largest gradient's scale (some gradients are
# zero up to rounding: cross-attention's q/k and norm3)
TRAIN_CHECK_TOL, TRAIN_CHECK_FLOOR = 2e-3, 1e-6


def step_against_plain(phase: str, run, expected: dict):
    """One train step through the kernels against the same through the
    plain versions: ``run()`` -> (loss, pre-clip norm, {name: gradient})
    is called once each way; the kernels' launches must be ``expected``,
    the loss within 1e-5, the norm within 1e-4 and every gradient within
    ``TRAIN_CHECK_TOL`` of its own scale plus ``TRAIN_CHECK_FLOOR`` of the
    largest.  Returns (the fields of the phase's line, the plain
    gradients)."""
    from diffbinaural_tpu_torch import ops

    ops.reset_launch_counts()
    loss_k, norm_k, grads_k = run()
    counts = ops.launch_counts()
    with plain_versions():
        loss_p, norm_p, grads_p = run()
    if ops.launch_counts() != counts:
        fail(f"{phase}: plain_versions() launched a kernel")
    if counts != expected:
        fail(f"{phase}: launch counts {counts} != {expected}")
    if not (np.isfinite(loss_k) and np.isfinite(norm_k)):
        fail(f"{phase}: loss {loss_k}, grad_norm {norm_k}")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        fail(f"{phase}: loss {loss_k} vs {loss_p} through the plain versions")
    if abs(norm_k - norm_p) > 1e-4 * norm_p:
        fail(f"{phase}: grad_norm {norm_k} vs {norm_p}")
    top = max(g.abs().max().item() for g in grads_p.values())
    worst, worst_name, n_zero = 0.0, "", 0
    for name, want in grads_p.items():
        got = grads_k[name]
        if not torch.isfinite(got).all():
            fail(f"{phase}: non-finite gradient of {name}")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if err > TRAIN_CHECK_TOL * scale + TRAIN_CHECK_FLOOR * top:
            fail(f"{phase}: gradient of {name}: max error {err:.3e} at "
                 f"scale {scale:.3e} (largest gradient {top:.3e})")
        n_zero += scale <= 1e-5 * top
        if scale > 1e-5 * top and err / scale > worst:
            worst, worst_name = err / scale, name
    return {"loss": loss_k, "loss_plain": loss_p, "loss_rel_diff":
                abs(loss_k - loss_p) / abs(loss_p), "loss_tol": 1e-5,
            "grad_norm": norm_k, "grad_norm_plain": norm_p,
            "parameters": len(grads_p),
            "worst_grad_err_of_own_scale": worst, "worst_grad": worst_name,
            "grad_tol_of_own_scale": TRAIN_CHECK_TOL,
            "grad_floor_of_largest_scale": TRAIN_CHECK_FLOOR,
            "largest_grad_scale": top,
            "grads_below_1e-5_of_largest": int(n_zero),
            "launches": counts}, grads_p


def phase_train_check() -> None:
    """One stage-1 train step at full width in float32 (TF32 off), batch 2,
    one injected (t, noise, drop): loss, pre-clip gradient norm and every
    parameter's gradient through the kernels against the same through the
    plain versions.  The step runs with ``lr_scale`` 0 and no norm clip, so
    the parameters stay and the gradients are left as autograd made them."""
    from diffbinaural_tpu_torch.train import make_stage1_train_step

    b = 2
    unet = build_unet(torch.float32, seed=0)
    init_fn, step_fn = make_stage1_train_step(unet, clip_norm=float("inf"))
    state = init_fn()
    state.lr_scale = 0.0
    batch = synthetic_batch(b, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    draws = dict(
        t=torch.tensor([37, 811], device="cuda"),
        noise=torch.randn((b, 2, WINDOW, WINDOW), generator=gen, device="cuda"),
        drop=torch.tensor([False, True], device="cuda"))

    def run():
        _, metrics = step_fn(state, batch, **draws)
        torch.cuda.synchronize()
        grads = {k: p.grad.clone() for k, p in unet.named_parameters()}
        return metrics["loss"].item(), metrics["grad_norm"].item(), grads

    fields, _ = step_against_plain(
        "train_check", run, launches(flash_sdpa_with_lse=ATTN_PER_STEP,
                                     flash_sdpa_backward=ATTN_PER_STEP))
    emit({"phase": "train_check", "dtype": "fp32", "tf32": False, "batch": b,
          **fields})
    del unet, state
    torch.cuda.empty_cache()


def train_draws(b: int, seed: int):
    """A generator from ``seed`` and one (t, noise, drop) drawn from it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = dict(
        t=torch.randint(0, 1000, (b,), generator=gen, device="cuda"),
        noise=torch.randn((b, 2, WINDOW, WINDOW), generator=gen, device="cuda"),
        drop=torch.rand((b,), generator=gen, device="cuda") < 0.1)
    return gen, draws


def train_steps(phase: str, step_fn, state, batch, gen, draws):
    """One warm-up step with draws from ``gen``, then ``TRAIN_STEPS`` timed
    steps with one fixed (t, noise, drop), so that the losses are those of
    one objective and must fall; K1r / K1b ``ATTN_PER_STEP`` launches per
    step.  Returns (state, the fields of the phase's line)."""
    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.train import TrainingStabilizer

    stabilizer = TrainingStabilizer()
    torch.cuda.reset_peak_memory_stats()
    try:
        state, _ = step_fn(state, batch, generator=gen)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        losses, norms, seconds = [], [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch, **draws)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            stabilizer.training_step(losses[-1], norms[-1])
    except torch.cuda.OutOfMemoryError as exc:
        fail(f"{phase}: the batch does not fit the card's memory: {exc}")
    counts = ops.launch_counts()
    memory = stabilizer.memory_report()

    if state.step != TRAIN_STEPS + 1:
        fail(f"{phase}: state.step {state.step}")
    if not all(np.isfinite(x) for x in losses + norms):
        fail(f"{phase}: losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: the loss did not fall: {losses}")
    expected = launches(flash_sdpa_with_lse=ATTN_PER_STEP * TRAIN_STEPS,
                        flash_sdpa_backward=ATTN_PER_STEP * TRAIN_STEPS)
    if counts != expected:
        fail(f"{phase}: launch counts {counts} != {expected}")
    return state, {
        "steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
        "seconds_per_step": statistics.median(seconds),
        "seconds_per_step_runs": seconds,
        "sync": "synchronize + host clock around each step, median",
        "max_memory_allocated_bytes": memory["peak_allocated_bytes"],
        "launches": counts,
        "launches_per_step": {k: v // TRAIN_STEPS for k, v in counts.items()}}


def phase_train_path(trace_steps: int = 0) -> dict:
    """Optimiser steps of the stage-1 trainer at full width in bfloat16,
    batch 16, through the entry point a user calls
    (``make_stage1_train_step``), as ``train_steps`` runs them."""
    from diffbinaural_tpu_torch.train import make_stage1_train_step

    b = TRAIN_BATCH
    unet = build_unet(torch.bfloat16, seed=0)
    init_fn, step_fn = make_stage1_train_step(unet)
    batch = synthetic_batch(b, seed=7)
    gen, draws = train_draws(b, seed=8)
    state, fields = train_steps("train_path", step_fn, init_fn(), batch, gen,
                                draws)
    if not all(torch.isfinite(p).all() for p in unet.parameters()):
        fail("train_path: a parameter is not finite after the steps")
    out = {"phase": "train_path", "dtype": "bf16", "batch": b, **fields}
    emit(out)
    if trace_steps > 0:
        emit(trace("train_step", lambda: step_fn(state, batch, **draws),
                   min(trace_steps, 3)))
    return out


# ------------------------------------------------ visual conditioning path

# --num_frames 1 and --max_sources 4 (the JAX CLI's defaults), 224 x 224
FRAMES, N_SOURCES, IMAGE = 1, 4, 224
# an encoder on the card against the same weights on the CPU, float32 with
# TF32 off: max error of the output's scale, rms error of its rms
VISUAL_TOL, VISUAL_RMS_TOL = 1e-4, 1e-5


def visual_inputs(b: int, seed: int):
    """Frames (b, 3, 1, 4, 224, 224), 2-D and 3-D positions in [-1, 1) and
    a mask (True = invalid) with the last source of every frame padded; on
    the CPU, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    frames = torch.randn((b, 3, FRAMES, N_SOURCES, IMAGE, IMAGE),
                         generator=gen)
    pos2 = torch.rand((b, FRAMES, N_SOURCES, 2), generator=gen) * 2 - 1
    pos3 = torch.rand((b, FRAMES, N_SOURCES, 3), generator=gen) * 2 - 1
    mask = torch.zeros((b, FRAMES, N_SOURCES), dtype=torch.bool)
    mask[..., -1] = True
    return frames, pos2, mask, pos3


def clip_tower_flops(config, images: int) -> float:
    """Multiply-adds x 2 of ``images`` passes of the ViT image tower: patch
    convolution, per layer the four projections, scores and weighted sum,
    and the 4x MLP, and the final projection (LayerNorms and softmax
    left out)."""
    c = config
    grid = (c.image_size // c.patch_size) ** 2
    n, w = grid + 1, c.width
    conv = grid * w * 3 * c.patch_size ** 2
    layer = 4 * n * w * w + 2 * n * n * w + 2 * n * w * 4 * w
    return 2.0 * images * (conv + c.layers * layer + w * c.output_dim)


def phase_visual_check() -> None:
    """The encoders at full width in float32 (TF32 off), seeded random
    weights: ``ClipPos2D`` at B = 2 and each of the six registry entries at
    B = 1 on the card against the same weights on the CPU; then one
    live-visual stage-1 train step at batch 2 (``ClipPos2D`` + the float32
    UNet) with one injected (t, noise, drop), the loss, pre-clip norm and
    every UNet and frame-head gradient through the kernels against the same
    through the plain versions (as ``train_check``), every tower gradient
    exactly zero; and a second step at ``lr_scale`` 1, after which every
    tower leaf must equal (1 - lr * wd) * w: Adam's update of a zero
    gradient is zero and the decay reaches the frozen leaves, as in the JAX
    chain."""
    from diffbinaural_tpu_torch.models.visual import (ENCODER_REGISTRY,
                                                      apply_visual,
                                                      build_visual)
    from diffbinaural_tpu_torch.train import make_stage1_train_step

    frames, pos2, mask, pos3 = visual_inputs(2, seed=11)
    encoders = {}
    for arch, b in [("clip_pos2d", 2)] + [(a, 1) for a in ENCODER_REGISTRY]:
        cpu = build_visual(arch, seed=1, device="cpu")
        card = copy.deepcopy(cpu).cuda()
        args = [a[:b] for a in (frames, pos2, mask, pos3)]
        with torch.no_grad():
            want = apply_visual(cpu, *args).cuda()
            got = apply_visual(card, *(a.cuda() for a in args))
        if got.shape != (b, 512):
            fail(f"visual_check {arch}: output shape {tuple(got.shape)}")
        err = _compare("visual_check", f"{arch} B={b}", got, want,
                       VISUAL_TOL, True, rms_tol=VISUAL_RMS_TOL)
        encoders[f"{arch}_b{b}"] = {
            "max_err": err, "scale": want.abs().max().item(),
            "rms_err_of_rms": _rel_rms(got, want),
            "parameters": sum(p.numel() for p in cpu.parameters())}
        del cpu, card

    b = 2
    unet = build_unet(torch.float32, seed=0)
    visual = build_visual("clip_pos2d", seed=1)
    init_fn, step_fn = make_stage1_train_step(unet, visual=visual,
                                              clip_norm=float("inf"))
    state = init_fn()
    state.lr_scale = 0.0
    batch = synthetic_batch(b, seed=5)
    del batch["feat"]
    frames, pos2, mask, _ = visual_inputs(b, seed=12)
    batch.update(frames=frames.cuda(), pos=pos2.cuda(), mask=mask.cuda())
    gen = torch.Generator(device="cuda").manual_seed(6)
    draws = dict(
        t=torch.tensor([37, 811], device="cuda"),
        noise=torch.randn((b, 2, WINDOW, WINDOW), generator=gen, device="cuda"),
        drop=torch.tensor([False, False], device="cuda"))
    tower = dict(visual.clip.named_parameters())
    trained = {f"unet.{k}": p for k, p in unet.named_parameters()}
    trained.update({f"frame.{k}": p for k, p in visual.named_parameters()
                    if not k.startswith("clip.")})

    def run():
        _, metrics = step_fn(state, batch, **draws)
        torch.cuda.synchronize()
        nonzero = [k for k, p in tower.items() if p.grad.count_nonzero()]
        if nonzero:
            fail(f"visual_check: tower gradients not zero: {nonzero[:5]}")
        grads = {k: p.grad.clone() for k, p in trained.items()}
        return metrics["loss"].item(), metrics["grad_norm"].item(), grads

    fields, grads_p = step_against_plain(
        "visual_check", run, launches(flash_sdpa_with_lse=ATTN_PER_STEP,
                                      flash_sdpa_backward=ATTN_PER_STEP))
    head_scale = max(g.abs().max().item() for k, g in grads_p.items()
                     if k.startswith("frame."))
    if not head_scale > 0:
        fail("visual_check: the frame head got no gradient")

    before = {k: p.detach().clone() for k, p in tower.items()}
    group = state.optimizer.param_groups[1]
    state.lr_scale = 1.0
    step_fn(state, batch, **draws)
    torch.cuda.synchronize()
    factor = 1.0 - group["base_lr"] * group["weight_decay"]
    decay_err = max((p.detach() - before[k] * factor).abs().max().item()
                    for k, p in tower.items())
    if decay_err != 0.0:
        fail(f"visual_check: a tower leaf is not (1 - lr * wd) * w after a "
             f"step: max error {decay_err:.3e}")
    moved = max((p.detach() - before[k]).abs().max().item()
                for k, p in tower.items())
    emit({"phase": "visual_check", "dtype": "fp32", "tf32": False,
          "encoders_card_vs_cpu": encoders, "tol_of_scale": VISUAL_TOL,
          "rms_tol": VISUAL_RMS_TOL, "batch": b, "frames": list(frames.shape),
          "tower_tensors": len(tower), "head_grad_scale": head_scale,
          "tower_decay_factor": factor, "tower_decay_max_err": decay_err,
          "tower_max_change": moved, **fields})
    del unet, visual, state, grads_p, before
    torch.cuda.empty_cache()


def phase_visual_train_path(trace_steps: int = 0) -> dict:
    """Optimiser steps of the stage-1 trainer with the live encoder: the
    serving UNet in bfloat16, ``ClipPos2D`` (ViT-B/32) in float32, batch 16
    of frames (16, 3, 1, 4, 224, 224) = 64 CLIP images per step, through
    ``make_stage1_train_step(unet, visual=...)``: one warm-up step, then
    ``TRAIN_STEPS`` timed steps on one (t, noise, drop).  Also the tower's
    forward on the 64 images and the encoder's forward alone, by CUDA
    events, beside the tower's FLOP bound."""
    from diffbinaural_tpu_torch.models.visual import apply_visual, build_visual
    from diffbinaural_tpu_torch.train import make_stage1_train_step

    b = TRAIN_BATCH
    unet = build_unet(torch.bfloat16, seed=0)
    visual = build_visual("clip_pos2d", seed=1)
    init_fn, step_fn = make_stage1_train_step(unet, visual=visual)
    batch = synthetic_batch(b, seed=7)
    del batch["feat"]
    frames, pos2, mask, _ = (a.cuda() for a in visual_inputs(b, seed=13))
    batch.update(frames=frames, pos=pos2, mask=mask)
    gen, draws = train_draws(b, seed=8)
    state, fields = train_steps("visual_train_path", step_fn, init_fn(),
                                batch, gen, draws)
    if not all(torch.isfinite(p).all() for p in visual.parameters()):
        fail("visual_train_path: an encoder parameter is not finite")

    images = b * FRAMES * N_SOURCES
    flat = frames.permute(0, 2, 3, 1, 4, 5).reshape(images, 3, IMAGE, IMAGE)
    with torch.no_grad():
        tower_ms = time_ms(lambda: visual.clip(flat), warmup=1, iters=5)
        encoder_ms = time_ms(lambda: apply_visual(visual, frames, pos2, mask),
                             warmup=1, iters=5)
    flops = clip_tower_flops(visual.clip.config, images)
    out = {"phase": "visual_train_path", "unet_dtype": "bf16",
           "encoder_dtype": "fp32", "tf32": False, "batch": b,
           "frames": list(frames.shape), "clip_images_per_step": images,
           **fields, "tower_fwd_ms": tower_ms, "tower_gflop": flops / 1e9,
           "tower_bound_ms": flops / PEAK_FLOPS["fp32"] * 1e3,
           "tower_bound_by": "operations (fp32, 67 TFLOP/s)",
           "encoder_fwd_ms": encoder_ms,
           "timing_of_tower_and_encoder": "CUDA events over 5 calls"}
    emit(out)
    if trace_steps > 0:
        def encoder_fwd_bwd():
            apply_visual(visual, frames, pos2, mask).sum().backward()

        with torch.no_grad():
            tower = trace("visual_tower_fwd", lambda: visual.clip(flat), 3)
        encoder = trace("visual_encoder_fwd_bwd", encoder_fwd_bwd, 3)
        step = trace("visual_train_step",
                     lambda: step_fn(state, batch, **draws), 3)
        for row in (tower, encoder, step):
            emit(row)
        emit({"phase": "visual_split", "device_ms_per_step": {
            "tower": tower["device_ms_per_call"],
            "head_fwd_bwd": encoder["device_ms_per_call"]
            - tower["device_ms_per_call"],
            "unet_and_optimiser": step["device_ms_per_call"]
            - encoder["device_ms_per_call"]}})
    del state, unet, visual, batch
    torch.cuda.empty_cache()
    return out


class SyntheticVisualClip:
    """What ``cli.common.dump_clip_mels`` reads of a dataset: the ln-mel of
    a seeded synthetic 10 s clip by the port's frontend, its 21 window
    starts, its row, and per window the frames (3, 1, 4, 224, 224), 2-D
    positions and mask on the card."""

    def __init__(self, seed: int):
        from diffbinaural_tpu_torch.infer.stage1 import window_starts
        from diffbinaural_tpu_torch.signal import mel_spectrogram

        wav = torch.from_numpy(synthetic_clip(seed)).cuda()
        self.full_mel = mel_spectrogram(wav[None])[0].cpu().numpy()
        self.starts = window_starts(self.full_mel.shape[-1])
        self.rows = [{"video_id": f"synthetic{seed}"}]
        self.frames, self.pos, self.mask, _ = (
            a.cuda() for a in visual_inputs(len(self.starts), seed))

    def __len__(self):
        return len(self.starts)

    def __getitem__(self, i):
        return {"frames": self.frames[i], "2d_pos_data": self.pos[i],
                "mask": self.mask[i]}


def phase_visual_serve() -> dict:
    """A clip generated from frames: per-window features by ``ClipPos2D``
    (float32) through ``cli.common.visual_apply_fn``, then
    ``cli.common.dump_clip_mels`` with DDIM-25 over the bfloat16 UNet in
    groups of 8, into the L/R ``.npy`` pair.  One warm-up clip, then 3
    timed clips; the encoder's seconds are summed per clip between
    synchronisations."""
    from argparse import Namespace

    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.cli.common import (dump_clip_mels,
                                                   visual_apply_fn)
    from diffbinaural_tpu_torch.infer.stage1 import Stage1Sampler
    from diffbinaural_tpu_torch.models.visual import build_visual

    clip = SyntheticVisualClip(seed=21)
    total = clip.full_mel.shape[-1]
    if (total, len(clip)) != (861, 21):
        fail(f"visual_serve: {total} frames, {len(clip)} windows")
    unet = build_unet(torch.bfloat16, seed=0)
    apply = visual_apply_fn(build_visual("clip_pos2d", seed=1), "clip_pos2d")
    sampler = Stage1Sampler(unet, sampling_timesteps=DDIM_STEPS)
    encoder_s = []

    def features(item):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat = apply(item["frames"][None], item["2d_pos_data"][None],
                     item["mask"][None])[0]
        torch.cuda.synchronize()
        encoder_s.append(time.perf_counter() - t0)
        return feat

    with tempfile.TemporaryDirectory() as workdir:
        left, right = f"{workdir}/left", f"{workdir}/right"

        def one_clip():
            encoder_s.clear()
            gen = torch.Generator(device="cuda").manual_seed(13)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mel = dump_clip_mels(Namespace(crop_frames=8), sampler, clip,
                                 left, right, features_fn=features,
                                 generator=gen, max_batch=UNET_BATCH)
            seconds = time.perf_counter() - t0
            return mel, seconds, sum(encoder_s)

        one_clip()  # warm-up
        ops.reset_launch_counts()
        mel, first, first_enc = one_clip()
        counts = ops.launch_counts()
        runs = [(first, first_enc)] + [one_clip()[1:] for _ in range(2)]
        saved = [np.load(f"{d}/synthetic21.npy") for d in (left, right)]
    expected = launches(flash_sdpa=ATTN_PER_STEP * DDIM_STEPS * 3)
    if counts != expected:
        fail(f"visual_serve: launch counts {counts} != {expected}")
    if mel.shape != (2, 80, total) or not np.isfinite(mel).all():
        fail(f"visual_serve: mel {mel.shape}, finite {np.isfinite(mel).all()}")
    if not all(np.array_equal(s, m) for s, m in zip(saved, mel)):
        fail("visual_serve: the saved .npy pair differs from the clip's mels")
    seconds = statistics.median(r[0] for r in runs)
    out = {"phase": "visual_serve", "unet_dtype": "bf16",
           "encoder_dtype": "fp32", "tf32": False, "frames": total,
           "windows": len(clip), "groups": 3, "ddim_steps": DDIM_STEPS,
           "window_frames": [1, 3, FRAMES, N_SOURCES, IMAGE, IMAGE],
           "seconds_per_clip": seconds,
           "seconds_per_clip_runs": [r[0] for r in runs],
           "encoder_seconds_runs": [r[1] for r in runs],
           "encoder_share": statistics.median(r[1] / r[0] for r in runs),
           "sync": "synchronize + host clock around dump_clip_mels, median "
                   "of 3 clips after a warm-up; encoder: synchronize around "
                   "each window's call",
           "mel_range": [float(mel.min()), float(mel.max())],
           "launches": counts}
    emit(out)
    del unet, apply, sampler, clip
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- stage-2 GAN path


def build_gan(gen_dtype, seed: int):
    """The production configuration's generator (compute type
    ``gen_dtype``, float32 parameters) and discriminators (float32)."""
    from diffbinaural_tpu_torch.core.config import (VocoderConfig,
                                                    load_hparams_from_json)
    from diffbinaural_tpu_torch.models import (build_discriminators,
                                               build_vocoder)

    h = load_hparams_from_json(GAN_CONFIG)
    gen = build_vocoder(VocoderConfig.from_attrdict(h), dtype=gen_dtype,
                        seed=seed)
    mpd, mrd = build_discriminators(h, seed=seed + 1)
    return h, gen, mpd, mrd


def make_gan_step(h, gen, mpd, mrd, remat=False, mesh=None):
    """``make_stage2_train_step`` wired as the JAX package's GAN trainer
    wires it from the config (``cli/gan_common.py``), ``remat`` and
    ``mesh`` as given."""
    from diffbinaural_tpu_torch.losses import MultiScaleMelSpectrogramLoss
    from diffbinaural_tpu_torch.signal import mel_spectrogram
    from diffbinaural_tpu_torch.train import make_stage2_train_step

    def mel_fn(wav):
        return mel_spectrogram(wav, h["n_fft"], h["num_mels"],
                               h["sampling_rate"], h["hop_size"], h["win_size"],
                               h["fmin"], h.get("fmax_for_loss"))

    return make_stage2_train_step(
        gen, mpd, mrd, mel_fn,
        MultiScaleMelSpectrogramLoss(h["sampling_rate"]),
        learning_rate=h["learning_rate"], adam_b1=h["adam_b1"],
        adam_b2=h["adam_b2"], lr_decay=h["lr_decay"],
        clip_grad_norm=h.get("clip_grad_norm", 1000.0),
        lambda_melloss=h.get("lambda_melloss", 45.0), freeze_step=0,
        use_multiscale_melloss=h.get("use_multiscale_melloss", False),
        silence_threshold_db=h.get("silence_threshold_db", -50.0),
        remat=remat, mesh=mesh)


def gan_batch(h, batch: int, seed: int) -> dict:
    """``batch`` segments of ``GAN_SEGMENT`` samples of a seeded synthetic
    signal (drifting tones, noise, a silent stretch in some segments), with
    their ln-mels (64 frames) from the port's own mel frontend."""
    from diffbinaural_tpu_torch.signal import mel_spectrogram

    rng = np.random.default_rng(seed)
    time_s = np.arange(GAN_SEGMENT) / h["sampling_rate"]
    audio = 0.005 * rng.standard_normal((batch, GAN_SEGMENT))
    for i in range(batch):
        for f0 in rng.uniform(80.0, 6000.0, 4):
            drift = 1.0 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * time_s)
            audio[i] += rng.uniform(0.02, 0.2) * np.sin(
                2 * np.pi * f0 * drift * time_s + rng.uniform(0, 2 * np.pi))
        if i % 4 == 3:
            audio[i, GAN_SEGMENT // 2:] *= 1e-3
    audio = torch.from_numpy(np.clip(audio, -1, 1).astype(np.float32)).cuda()

    def mel(fmax):
        return mel_spectrogram(audio, h["n_fft"], h["num_mels"],
                               h["sampling_rate"], h["hop_size"], h["win_size"],
                               h["fmin"], fmax)

    out = {"mel": mel(h["fmax"]), "audio": audio,
           "mel_loss": mel(h.get("fmax_for_loss"))}
    if out["mel"].shape != (batch, h["num_mels"], GAN_SEGMENT // h["hop_size"]):
        fail(f"gan batch: mel shape {tuple(out['mel'].shape)}")
    return out


def gan_launches(steps: int, bf16: bool) -> dict:
    """A stage-2 step's launches: K3b runs the dz and dW kernels in
    bfloat16 and the composition (library convolution gradients) in
    float32."""
    per_step = dict(fused_alias_free_snake=ACT_PER_PASS + FUSED_PER_PASS,
                    fused_alias_free_snake_backward=ACT_PER_PASS + FUSED_PER_PASS,
                    fused_snake_conv=FUSED_PER_PASS,
                    fused_snake_conv_backward=FUSED_PER_PASS,
                    snake_conv_dgrad=FUSED_PER_PASS if bf16 else 0,
                    snake_conv_wgrad=FUSED_PER_PASS if bf16 else 0)
    return launches(**{k: v * steps for k, v in per_step.items()})


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms without autotuning, and PyTorch's
    deterministic implementation of every op that has one.  An op that has
    none warns instead of raising; the warnings are yielded so the caller
    can report which ops those were."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


GAN_METRICS = ("loss_disc", "loss_gen_all", "loss_mel", "loss_fm",
               "grad_norm_g")
GAN_METRIC_TOL = 1e-4  # relative; float32 sums in another order
# of each gradient's own scale, with deterministic algorithms; on an H100
# kernels vs plain measured 1.6e-5 (generator: K2b's float32 order against
# the plain adjoint's) and 4.6e-7 (discriminators: only the last bits of the
# generator's output differ); the kernel path against itself measured 0.0
STAGE2_GRAD_TOL = {"generator": 1e-4, "discriminators": 1e-5}
STAGE2_REPEAT_TOL = 1e-6


def phase_stage2_check() -> None:
    """One stage-2 D+G step at the production configuration in float32
    (TF32 off), batch 2 x 16384 samples, from one state: through the
    kernels against through the plain versions, with deterministic
    algorithms (``deterministic_algorithms``) so that the kernel path
    repeats.  The six metrics (relative ``GAN_METRIC_TOL``), every
    generator and discriminator gradient (the clipped ones the optimiser
    took: ``STAGE2_GRAD_TOL`` of its own scale, set apart for the generator
    and the discriminators, plus ``TRAIN_CHECK_FLOOR`` of the largest), and
    every updated parameter (within 2 lr: Adam's first
    step moves a parameter by at most about lr, and a gradient that is zero
    up to rounding may point either way).  The path through the kernels
    runs twice; the worst difference between its own two runs is printed
    beside the worst difference from the plain versions, and must be below
    ``STAGE2_REPEAT_TOL``."""
    from diffbinaural_tpu_torch import ops

    b = 2
    h, gen, mpd, mrd = build_gan(torch.float32, seed=21)
    modules = {"generator": gen, "mpd": mpd, "mrd": mrd}
    start = {k: {n: v.clone() for n, v in m.state_dict().items()}
             for k, m in modules.items()}
    batch = gan_batch(h, b, seed=22)

    def run():
        for k, m in modules.items():
            m.load_state_dict(start[k])
        init_fn, step_fn = make_gan_step(h, gen, mpd, mrd)
        state, metrics = step_fn(init_fn(), batch)
        torch.cuda.synchronize()
        grads = {f"{k}.{n}": p.grad.clone() for k, m in modules.items()
                 for n, p in m.named_parameters()}
        params = {f"{k}.{n}": p.detach().clone() for k, m in modules.items()
                  for n, p in m.named_parameters()}
        return {k: float(v) for k, v in metrics.items()}, grads, params

    with deterministic_algorithms() as caught:
        ops.reset_launch_counts()
        m_k, g_k, p_k = run()
        counts = ops.launch_counts()
        _, g_r, _ = run()
        before_plain = ops.launch_counts()
        with plain_versions():
            m_p, g_p, p_p = run()
    nondeterministic = sorted({str(w.message).split(" does not have")[0][:80]
                               for w in caught
                               if "deterministic" in str(w.message)})
    if ops.launch_counts() != before_plain:
        fail("stage2_check: plain_versions() launched a kernel")
    if counts != gan_launches(1, bf16=False):
        fail(f"stage2_check: launch counts {counts} != "
             f"{gan_launches(1, bf16=False)}")
    rel = {}
    for name in GAN_METRICS:
        if not np.isfinite(m_k[name]):
            fail(f"stage2_check: {name} = {m_k[name]}")
        rel[name] = abs(m_k[name] - m_p[name]) / max(abs(m_p[name]), 1e-30)
        if rel[name] > GAN_METRIC_TOL:
            fail(f"stage2_check: {name} {m_k[name]} through the kernels, "
                 f"{m_p[name]} through the plain versions")
    top = max(g.abs().max().item() for g in g_p.values())
    worst = {"generator": (0.0, ""), "discriminators": (0.0, "")}
    repeat, n_small = 0.0, 0
    for name, want in g_p.items():
        got = g_k[name]
        if not torch.isfinite(got).all():
            fail(f"stage2_check: non-finite gradient of {name}")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        part = "generator" if name.startswith("generator.") else "discriminators"
        if err > STAGE2_GRAD_TOL[part] * scale + TRAIN_CHECK_FLOOR * top:
            fail(f"stage2_check: gradient of {name}: max error {err:.3e} at "
                 f"scale {scale:.3e} (largest gradient {top:.3e})")
        if scale <= 1e-5 * top:
            n_small += 1
            continue
        worst[part] = max(worst[part], (err / scale, name))
        repeat = max(repeat, (g_r[name] - got).abs().max().item() / scale)
    if repeat > STAGE2_REPEAT_TOL:
        fail(f"stage2_check: the kernel path does not repeat: {repeat:.3e} of "
             f"a gradient's scale (limit {STAGE2_REPEAT_TOL:.0e})")
    lr = m_k["lr"]
    param_err = max((p_k[n] - p_p[n]).abs().max().item() for n in p_p)
    if param_err > 2 * lr * 1.001:
        fail(f"stage2_check: updated parameters differ by {param_err:.3e} "
             f"(limit 2 lr = {2 * lr:.3e})")
    emit({"phase": "stage2_check", "dtype": "fp32", "tf32": False, "batch": b,
          "segment": GAN_SEGMENT, "config": GAN_CONFIG,
          "deterministic_algorithms": True,
          "ops_without_deterministic_version": nondeterministic,
          "metrics": m_k, "metrics_plain": m_p, "metric_rel_diff": rel,
          "metric_tol": GAN_METRIC_TOL, "parameters": len(g_p),
          "worst_generator_grad_err_of_own_scale": worst["generator"][0],
          "worst_generator_grad": worst["generator"][1],
          "worst_discriminator_grad_err_of_own_scale":
              worst["discriminators"][0],
          "worst_discriminator_grad": worst["discriminators"][1],
          "kernel_repeat_worst_grad_diff_of_own_scale": repeat,
          "repeat_tol_of_own_scale": STAGE2_REPEAT_TOL,
          "grad_tol_of_own_scale": STAGE2_GRAD_TOL,
          "grad_floor_of_largest_scale": TRAIN_CHECK_FLOOR,
          "largest_grad_scale": top,
          "grads_below_1e-5_of_largest": n_small,
          "updated_param_max_diff": param_err, "updated_param_tol": 2 * lr,
          "launches": counts})
    del gen, mpd, mrd, modules, start, g_k, g_r, g_p, p_k, p_p
    torch.cuda.empty_cache()


def phase_stage2_path(trace_steps: int = 0) -> dict:
    """Optimiser steps of the stage-2 GAN trainer at the production
    configuration through the entry point a user calls
    (``make_stage2_train_step``): bfloat16 generator (float32 parameters),
    float32 discriminators, batch 16 x 16384 samples; one warm-up step, then
    ``GAN_STEPS`` timed steps on one batch."""
    from diffbinaural_tpu_torch import ops

    h, gen, mpd, mrd = build_gan(torch.bfloat16, seed=21)
    init_fn, step_fn = make_gan_step(h, gen, mpd, mrd)
    state = init_fn()
    batch = gan_batch(h, GAN_BATCH, seed=23)
    torch.cuda.reset_peak_memory_stats()
    rows, seconds = [], []
    try:
        state, _ = step_fn(state, batch)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for _ in range(GAN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            rows.append({k: float(metrics[k]) for k in GAN_METRICS})
    except torch.cuda.OutOfMemoryError as exc:
        fail(f"stage2_path: batch {GAN_BATCH} does not fit the card: {exc}")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    if state.step != GAN_STEPS + 1:
        fail(f"stage2_path: state.step {state.step}")
    if not all(np.isfinite(v) for r in rows for v in r.values()):
        fail(f"stage2_path: metrics {rows}")
    if counts != gan_launches(GAN_STEPS, bf16=True):
        fail(f"stage2_path: launch counts {counts} != "
             f"{gan_launches(GAN_STEPS, bf16=True)}")
    for m in (gen, mpd, mrd):
        if not all(torch.isfinite(p).all() for p in m.parameters()):
            fail("stage2_path: a parameter is not finite after the steps")
    out = {"phase": "stage2_path", "generator_dtype": "bf16",
           "discriminator_dtype": "fp32", "config": GAN_CONFIG,
           "batch": GAN_BATCH, "segment": GAN_SEGMENT, "steps": GAN_STEPS,
           "metrics": rows, "seconds_per_step": statistics.median(seconds),
           "seconds_per_step_runs": seconds,
           "sync": "synchronize + host clock around each step, median",
           "max_memory_allocated_bytes": peak, "launches": counts,
           "launches_per_step": {k: v // GAN_STEPS for k, v in counts.items()}}
    emit(out)
    if trace_steps > 0:
        emit(trace("stage2_train_step", lambda: step_fn(state, batch),
                   min(trace_steps, 3)))
    del state, gen, mpd, mrd
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- training from data on disk

# the synthetic RealBinaural world of train_cli_stage1: 32 train + 16 val
# videos of CLIP_SECONDS, 4 sources detected every 0.5 s, JPEG frames of
# FRAME_W x FRAME_H at 2 fps (when Pillow is present)
WORLD_TRAIN, WORLD_VAL, WORLD_SOURCES = 32, 16, 4
FRAME_W, FRAME_H, FRAME_FPS = 640, 360, 2
# the stage-2 world of train_cli_stage2: 48 stereo clips of CLIP_SECONDS
# with predicted-mel pairs (80 x 861), 16 of them also in the val dirs
GAN_WORLD_CLIPS, GAN_WORLD_VAL = 48, 16
# a stage-2 step with remat: the generator's forward runs twice (once more
# in the backward pass); K3b recomputes its activation with K2
REMAT_GAN_PER_STEP = dict(
    fused_alias_free_snake=2 * ACT_PER_PASS + FUSED_PER_PASS,
    fused_snake_conv=2 * FUSED_PER_PASS,
    fused_alias_free_snake_backward=ACT_PER_PASS + FUSED_PER_PASS,
    fused_snake_conv_backward=FUSED_PER_PASS,
    snake_conv_dgrad=FUSED_PER_PASS, snake_conv_wgrad=FUSED_PER_PASS)
# one validation item: a bfloat16 generator pass
GAN_VAL_PER_ITEM = dict(fused_alias_free_snake=ACT_PER_PASS,
                        fused_snake_conv=FUSED_PER_PASS)
GAN_VAL_ITEMS = 10  # GanTrainer.validate's max_samples


def _have_pillow() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def _world_audio(seed: int) -> tuple:
    """(mono, binaural (2, T)) of CLIP_SECONDS: ``synthetic_clip`` and its
    two ears, the right one delayed and attenuated."""
    mono = synthetic_clip(seed)
    rng = np.random.default_rng(seed + 1)
    left = 0.9 * mono + 0.005 * rng.standard_normal(mono.shape)
    right = 0.6 * np.roll(mono, 11) + 0.005 * rng.standard_normal(mono.shape)
    return mono, np.clip(np.stack([left, right]), -1, 1).astype(np.float32)


def write_stage1_world(root: str, seed: int) -> dict:
    """The RealBinaural layout under ``root``: ``processed/{mono,binaural}_
    audios_22050Hz/{vid}.wav`` (16-bit, 22.05 kHz), the split lists, the
    detection CSV and, with Pillow, ``processed/frames/{vid}/%03d.jpg``."""
    import csv

    from diffbinaural_tpu_torch.data.audio_io import save_wav

    t0 = time.perf_counter()
    pillow = _have_pillow()
    for sub in ("processed/mono_audios_22050Hz",
                "processed/binaural_audios_22050Hz", "splits",
                "action_detection_results"):
        os.makedirs(os.path.join(root, sub))
    rng = np.random.default_rng(seed)
    vids = [f"vid{i:03d}" for i in range(WORLD_TRAIN + WORLD_VAL)]
    det_rows, frames = [], 0
    for i, vid in enumerate(vids):
        mono, binaural = _world_audio(seed + 17 * i)
        save_wav(os.path.join(root, "processed/mono_audios_22050Hz",
                              vid + ".wav"), mono, SR)
        save_wav(os.path.join(root, "processed/binaural_audios_22050Hz",
                              vid + ".wav"), binaural, SR)
        boxes = []
        for s in range(WORLD_SOURCES):
            x1, y1 = rng.uniform(0.0, 0.7), rng.uniform(0.0, 0.6)
            boxes.append((x1, y1, x1 + rng.uniform(0.1, 0.3),
                          y1 + rng.uniform(0.2, 0.4)))
        for k in range(int(CLIP_SECONDS * 2)):
            for s, (x1, y1, x2, y2) in enumerate(boxes):
                dx = 0.01 * k
                det_rows.append([vid, f"{0.5 * k:.2f}", s, f"{x1 + dx:.4f}",
                                 f"{y1:.4f}", f"{min(x2 + dx, 1.0):.4f}",
                                 f"{y2:.4f}"])
        if pillow:
            from PIL import Image

            d = os.path.join(root, "processed/frames", vid)
            os.makedirs(d)
            base = rng.integers(0, 256, (FRAME_H // 8, FRAME_W // 8, 3),
                                dtype=np.uint8)
            base = np.repeat(np.repeat(base, 8, 0), 8, 1)
            for k in range(int(CLIP_SECONDS * FRAME_FPS)):
                Image.fromarray(np.roll(base, 4 * k, axis=1)).save(
                    os.path.join(d, f"{k:03d}.jpg"), quality=90)
                frames += 1
    for name, part in (("train", vids[:WORLD_TRAIN]),
                       ("val", vids[WORLD_TRAIN:])):
        with open(os.path.join(root, "splits", name + ".csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["video_id", "start_time", "end_time", "action_label"])
            w.writerows([v, "0.0", f"{CLIP_SECONDS:.1f}", "synthetic"]
                        for v in part)
    with open(os.path.join(root, "action_detection_results",
                           "detection_results.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "time", "source", "x1", "y1", "x2", "y2"])
        w.writerows(det_rows)
    return {"videos": len(vids), "train": WORLD_TRAIN, "val": WORLD_VAL,
            "seconds_each": CLIP_SECONDS, "detections": len(det_rows),
            "jpeg_frames": frames, "frame_size": [FRAME_W, FRAME_H],
            "pillow": pillow, "write_s": time.perf_counter() - t0}


def write_stage2_world(root: str, seed: int) -> dict:
    """48 stereo 16-bit wavs of CLIP_SECONDS in ``audio/`` and their
    predicted-mel pairs (80 x 861: the port's ln-mel of each ear plus a
    seeded perturbation, as a stage-1 model's output would differ) in
    ``pred_{left,right}_train/``; the first 16 also in
    ``pred_{left,right}_val/``."""
    from diffbinaural_tpu_torch.data.audio_io import save_wav
    from diffbinaural_tpu_torch.signal import mel_spectrogram

    t0 = time.perf_counter()
    dirs = {k: os.path.join(root, k) for k in (
        "audio", "pred_left_train", "pred_right_train", "pred_left_val",
        "pred_right_val")}
    for d in dirs.values():
        os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(GAN_WORLD_CLIPS):
        vid = f"clip{i:03d}"
        _, binaural = _world_audio(seed + 31 * i)
        save_wav(os.path.join(dirs["audio"], vid + ".wav"), binaural, SR)
        mels = mel_spectrogram(torch.from_numpy(binaural).cuda()).cpu().numpy()
        for side, mel in zip(("left", "right"), mels):
            pred = (mel + 0.3 * rng.standard_normal(mel.shape)).astype(
                np.float32)
            np.save(os.path.join(dirs[f"pred_{side}_train"], vid + ".npy"),
                    pred)
            if i < GAN_WORLD_VAL:
                np.save(os.path.join(dirs[f"pred_{side}_val"], vid + ".npy"),
                        pred)
    return {"clips": GAN_WORLD_CLIPS, "val_mel_pairs": GAN_WORLD_VAL,
            "seconds_each": CLIP_SECONDS, "mel_shape": list(mels.shape[1:]),
            "write_s": time.perf_counter() - t0, **dirs}


def phase_data_check(world: str, workdir: str, prebuilt: bool) -> dict:
    """The data layer on this machine: the native WAV decoder is built here
    and decodes seeded 16-bit and float WAVs exactly as scipy does (through
    ``load_wav``); a ``DataLoader`` batch of the RealBinaural val split with
    ``shuffle=False`` equals ``default_collate`` of the dataset's items in
    order; every frame slot with a valid detection is non-zero (Pillow).
    ``prebuilt``: the decoder's library was there before this run (an
    earlier phase's ``load_wav`` builds it otherwise)."""
    from scipy.io import wavfile

    from diffbinaural_tpu_torch import native
    from diffbinaural_tpu_torch.data import (DataLoader, RealBinauralDataset,
                                             default_collate)
    from diffbinaural_tpu_torch.data.audio_io import load_wav, save_wav

    if not native.available():
        fail(f"data_check: the native WAV decoder did not build: "
             f"{native.build_error()}")
    mono, binaural = _world_audio(41)
    files = {"pcm16_stereo.wav": None, "float_mono.wav": None}
    save_wav(os.path.join(workdir, "pcm16_stereo.wav"), binaural, SR)
    wavfile.write(os.path.join(workdir, "float_mono.wav"), SR, mono)
    for name in files:
        path = os.path.join(workdir, name)
        if native.load_wav_native(path) is None:
            fail(f"data_check: the native decoder refused {name}")
        got, sr = load_wav(path)
        _, raw = wavfile.read(path)
        want = (raw.astype(np.float32) / 32768.0 if raw.dtype == np.int16
                else raw.astype(np.float32))
        want = want.T if want.ndim == 2 else want
        if sr != SR or got.shape != want.shape or not np.array_equal(got, want):
            fail(f"data_check: load_wav of {name} differs from scipy's decode")
        files[name] = list(got.shape)

    ds = RealBinauralDataset(
        csv_file=os.path.join(world, "splits", "val.csv"), data_root=world,
        detection_csv=os.path.join(world, "action_detection_results",
                                   "detection_results.csv"),
        split="val", num_frames=FRAMES, max_sources=N_SOURCES)
    loader = DataLoader(ds, batch_size=TRAIN_BATCH, shuffle=False,
                        drop_last=False, num_workers=16)
    t0 = time.perf_counter()
    batch = next(iter(loader))
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = default_collate([ds[i] for i in range(TRAIN_BATCH)])
    serial_s = time.perf_counter() - t0
    for k, v in want.items():
        if not np.array_equal(batch[k], v):
            fail(f"data_check: the loader's batch differs from "
                 f"default_collate of the items at key {k}")
    valid = ~batch["mask"]                                       # (B, T, N)
    slot_max = np.abs(batch["frames"]).max(axis=(1, 4, 5))       # (B, T, N)
    empty = int((valid & (slot_max == 0)).sum())
    if _have_pillow() and (empty or not valid.any()):
        fail(f"data_check: {empty} frame slots with a valid detection are "
             f"zero ({int(valid.sum())} valid)")
    out = {"phase": "data_check", "native_decoder": True,
           "native_library": native.library_path().name,
           "native_built_in_this_run": not prebuilt, "wavs": files,
           "load_wav_equals_scipy": True,
           "batch_shapes": {k: list(v.shape) for k, v in batch.items()},
           "loader_batch_equals_collate": True, "pillow": _have_pillow(),
           "valid_slots": int(valid.sum()), "zero_valid_slots": empty,
           "loader_first_batch_s": batch_s, "serial_batch_s": serial_s,
           "loader_workers": 16, "sync": "host clock"}
    emit(out)
    return out


@contextlib.contextmanager
def recorded_first_step(common):
    """Wrap ``common.make_stage1_train_step`` so that the first step a
    trainer takes is recorded: the parameters before and after it, the
    batch it was given and its generator's state.  A comparison aid of
    this script; the step itself runs unchanged."""
    make, record = common.make_stage1_train_step, {}

    def params(state):
        return {f"{k}.{n}": p.detach().clone()
                for k, m in (("unet", state.unet), ("frame", state.visual))
                for n, p in m.named_parameters()}

    def recording_make(*args, **kwargs):
        init_fn, step_fn = make(*args, **kwargs)
        record.update(args=args, kwargs=kwargs)

        def step(state, batch, generator=None, **draws):
            first = "after" not in record
            if first:
                record.update(before=params(state), batch=batch,
                              generator_state=generator.get_state(),
                              lr_scale=state.lr_scale)
            out = step_fn(state, batch, generator=generator, **draws)
            if first:
                record["after"] = params(out[0])
                record["loss"] = out[1]["loss"].item()
            return out

        return init_fn, step

    common.make_stage1_train_step = recording_make
    try:
        yield record
    finally:
        common.make_stage1_train_step = make


def _cli_quietly(fn, *args, **kwargs):
    """Run a CLI with its per-step printing kept out of this script's
    output (one JSON line per phase)."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _timings(trainers) -> dict:
    step = [s for t in trainers for s in t.timings["step_s"]]
    wait = [s for t in trainers for s in t.timings["wait_s"]]
    return {"seconds_per_step": statistics.median(step),
            "seconds_per_step_runs": step,
            "loader_wait_s_per_step": statistics.median(wait),
            "loader_wait_s_runs": wait,
            "loader_wait_share": sum(wait) / sum(step)}


def _same_modules(name, got: dict, want: dict) -> int:
    """Tensors of two ``{name: tensor}`` maps equal bit for bit."""
    if got.keys() != want.keys():
        fail(f"{name}: parameter names differ")
    for k, v in want.items():
        if not torch.equal(got[k], v):
            err = (got[k].float() - v.float()).abs().max().item()
            fail(f"{name}: {k} differs by {err:.3e} (bit for bit expected)")
    return len(want)


def _named(**modules) -> dict:
    return {f"{k}.{n}": p.detach() for k, m in modules.items()
            for n, p in m.named_parameters()}


def phase_train_cli_stage1(world: str, workdir: str) -> dict:
    """``cli.train_realbinaural.main`` at full width on the synthetic world:
    ``ClipPos2D`` over ViT-B/32, the dim-64 UNet (float32, as the JAX
    trainer builds it), ``--num_frames 1 --max_sources 4``, batch 16, one
    epoch (2 steps) and the DDIM-25 validation of 16 clips; then
    ``--mode eval --num_epoch 2`` on the same ``--ckpt`` (resume at epoch 1
    with the saved parameters bit for bit); then ``--num_epoch 2`` (epoch
    1 trained from the resumed parameters).  All under
    ``deterministic_algorithms()``.  The first CLI step is held bit for bit
    against ``step_fn`` called directly on the same batch, state and seed,
    which is then timed on that batch (the step without the loader)."""
    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.cli import common, train_realbinaural
    from diffbinaural_tpu_torch.models import build_unet as build
    from diffbinaural_tpu_torch.models.visual import build_visual
    from diffbinaural_tpu_torch.train import make_stage1_train_step

    ck = os.path.join(workdir, "ckpt_stage1")
    argv = ["--id", "chip", "--arch_frame", "clip_pos2d", "--ckpt", ck,
            "--list_train", os.path.join(world, "splits", "train.csv"),
            "--list_val", os.path.join(world, "splits", "val.csv"),
            "--data_root", world, "--num_frames", "1", "--max_sources", "4",
            "--batch_size_per_gpu", str(TRAIN_BATCH), "--eval_epoch", "1",
            "--num_val", str(WORLD_VAL)]
    out = {"phase": "train_cli_stage1", "argv": argv,
           "unet_dtype": "fp32", "encoder_dtype": "fp32", "tf32": False,
           "deterministic_algorithms": True}
    with deterministic_algorithms():
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with recorded_first_step(common) as rec:
            t0 = time.perf_counter()
            first = _cli_quietly(train_realbinaural.main,
                                    argv + ["--num_epoch", "1"])
            out["run1_s"] = time.perf_counter() - t0
        counts1 = ops.launch_counts()
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        steps1 = first.state.step
        if steps1 != WORLD_TRAIN // TRAIN_BATCH:
            fail(f"train_cli_stage1: {steps1} steps in epoch 0")
        files = sorted(os.listdir(os.path.join(ck, "chip")))
        for f in ("frame_000000", "unet_000000", "history_000000",
                  "frame_best.pth", "unet_latest.pth"):
            if f not in files:
                fail(f"train_cli_stage1: no {f} after epoch 0 ({files})")
        mel_l2 = first.history["val_mel_l2"]
        if len(mel_l2) != 1 or not np.isfinite(mel_l2[0]):
            fail(f"train_cli_stage1: validation mel L2 {mel_l2}")

        # the first step against step_fn called directly
        kw = rec["kwargs"]
        unet = build(seed=1234)
        visual = build_visual("clip_pos2d", seed=1234)
        fresh = _named(unet=unet, frame=visual)
        _same_modules("train_cli_stage1: the CLI's initial parameters "
                      "against the seeded build functions", rec["before"], fresh)
        init_fn, step_fn = make_stage1_train_step(
            unet, visual, *rec["args"][2:], **kw)
        gen = torch.Generator(device="cuda").manual_seed(1234)
        if not torch.equal(gen.get_state(), rec["generator_state"]):
            fail("train_cli_stage1: the CLI's generator is not seeded by "
                 "--seed")
        state = init_fn()
        state.lr_scale = rec["lr_scale"]
        ops.reset_launch_counts()
        step_fn(state, rec["batch"], generator=gen)
        torch.cuda.synchronize()
        direct_counts = ops.launch_counts()
        n = _same_modules("train_cli_stage1: the first CLI step against "
                          "step_fn", _named(unet=unet, frame=visual),
                          rec["after"])
        seconds = []
        for _ in range(3):
            t0 = time.perf_counter()
            step_fn(state, rec["batch"], generator=gen)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        del unet, visual, state, fresh, rec
        torch.cuda.empty_cache()

        # resume: --mode eval restores and validates, no step
        final = _named(unet=first.net_unet, frame=first.net_frame)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        evaluated = _cli_quietly(
            train_realbinaural.main,
            argv + ["--num_epoch", "2", "--mode", "eval"])
        eval_s = time.perf_counter() - t0
        eval_counts = ops.launch_counts()
        if evaluated.start_epoch != 1 or evaluated.state.step != 0:
            fail(f"train_cli_stage1: resumed at epoch "
                 f"{evaluated.start_epoch}, step {evaluated.state.step}")
        _same_modules("train_cli_stage1: resumed parameters",
                      _named(unet=evaluated.net_unet,
                             frame=evaluated.net_frame), final)
        del evaluated, final
        torch.cuda.empty_cache()
        second = _cli_quietly(train_realbinaural.main,
                                 argv + ["--num_epoch", "2"])
    if second.start_epoch != 1 or second.history["epoch"] != 1:
        fail(f"train_cli_stage1: the second run trained epochs "
             f"{second.start_epoch}..{second.history['epoch']}")
    per_step = {k: v // steps1 for k, v in counts1.items()
                if k in TRAINING_KERNELS}
    if per_step != {"flash_sdpa_with_lse": ATTN_PER_STEP,
                    "flash_sdpa_backward": ATTN_PER_STEP}:
        fail(f"train_cli_stage1: launches {counts1}")
    val_k1 = DDIM_STEPS * ATTN_PER_STEP * -(-WORLD_VAL // TRAIN_BATCH)
    if eval_counts != launches(flash_sdpa=val_k1) or \
            counts1["flash_sdpa"] != val_k1:
        fail(f"train_cli_stage1: validation launches {eval_counts}, "
             f"run 1 {counts1}")
    if direct_counts != launches(flash_sdpa_with_lse=ATTN_PER_STEP,
                                 flash_sdpa_backward=ATTN_PER_STEP):
        fail(f"train_cli_stage1: the direct step launched {direct_counts}")
    out.update(
        steps=steps1 + second.state.step, batch=TRAIN_BATCH,
        clip_images_per_step=TRAIN_BATCH * FRAMES * N_SOURCES,
        **_timings([first, second]),
        direct_step_s=statistics.median(seconds),
        direct_step_s_runs=seconds,
        direct_sync="synchronize + host clock around step_fn on the "
                    "recorded batch, 3 steps after the checked one",
        timing="host clock: wait = from the previous step's end to the "
               "batch in hand; step = wait + copy to the card + step_fn + "
               "the loss read back (a synchronisation)",
        first_step_equals_step_fn=True, parameters_checked=n,
        resume_bit_for_bit=True, resume_epoch=1, eval_run_s=eval_s,
        val_mel_l2=[mel_l2[0], second.history["val_mel_l2"][-1]],
        train_losses=list(second.history["train_loss"]),
        first_run_train_loss=first.history["train_loss"],
        launches=counts1, launches_per_step=per_step,
        launches_per_validation_pass=eval_counts,
        validation_clips=WORLD_VAL, checkpoints=files)
    del first, second
    torch.cuda.empty_cache()
    emit(out)
    return out


# ------------------------------------------------------ the mesh (parallel/)

# the train CLI under torch.distributed.run: deterministic algorithms and
# TF32 off as in this script, the first steps' losses recorded by wrapping
# the trainer's step; then the CLI module runs as __main__
LAUNCHED_CLI = '''\
import json, os, runpy, sys
import torch
import torch.distributed as dist
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True, warn_only=True)
from diffbinaural_tpu_torch.cli import common
make, record = common.make_stage1_train_step, {"losses": []}
def recording_make(*args, **kwargs):
    init_fn, step_fn = make(*args, **kwargs)
    def step(state, batch, generator=None, **draws):
        out = step_fn(state, batch, generator=generator, **draws)
        record["losses"].append(out[1]["loss"].item())
        record.update(backend=dist.get_backend(),
                      world_size=dist.get_world_size(),
                      device=str(out[1]["loss"].device))
        return out
    return init_fn, step
common.make_stage1_train_step = recording_make
out_path = sys.argv.pop(1)
sys.argv[0] = "train_realbinaural"
runpy.run_module("diffbinaural_tpu_torch.cli.train_realbinaural",
                 run_name="__main__", alter_sys=True)
record["group_left"] = not dist.is_initialized()
with open(out_path, "w") as f:
    json.dump(record, f)
'''


def _same_floats(name, got: dict, want: dict) -> None:
    """Python floats of two maps equal bit for bit."""
    if got.keys() != want.keys():
        fail(f"{name}: the keys differ")
    for k, v in want.items():
        if repr(got[k]) != repr(v):
            fail(f"{name}: {k} {got[k]!r} against {v!r} (bit for bit "
                 "expected)")


def _mesh_stage1(mesh, steps: int = 2):
    """``steps`` stage-1 bf16 steps at ``train_path``'s width (B = 16,
    80 x 80, dim 64) from one seed; with ``mesh`` through the data-parallel
    step.  Returns (losses and norms, parameters, seconds per step, the
    UNet's gradients)."""
    from diffbinaural_tpu_torch.train import make_stage1_train_step

    unet = build_unet(torch.bfloat16, seed=0)
    init_fn, step_fn = make_stage1_train_step(unet, mesh=mesh)
    batch = synthetic_batch(TRAIN_BATCH, seed=7)
    state = init_fn()
    gen = torch.Generator(device="cuda").manual_seed(8)
    metrics, seconds = {}, []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, generator=gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics[f"loss_{i}"] = m["loss"].item()
        metrics[f"grad_norm_{i}"] = m["grad_norm"].item()
    params = {n: p.detach().clone() for n, p in unet.named_parameters()}
    return metrics, params, seconds, [p.grad for p in unet.parameters()]


def _mesh_stage2(modules, mesh):
    """One stage-2 step at ``stage2_path``'s configuration (``modules``:
    ``build_gan``'s, bf16 generator; B = 16 x 16384); with ``mesh`` through
    the all-reduced step and the generator through
    ``shard_vocoder_params``.  Returns (metrics, parameters, seconds, the
    generator's gradients)."""
    from diffbinaural_tpu_torch import parallel

    h, gen, mpd, mrd = modules
    if mesh is not None:
        parallel.shard_vocoder_params(gen, mesh)
    init_fn, step_fn = make_gan_step(h, gen, mpd, mrd, mesh=mesh)
    batch = gan_batch(h, GAN_BATCH, seed=23)
    state = init_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    params = {f"{k}.{n}": p.detach().clone()
              for k, m in (("generator", gen), ("mpd", mpd), ("mrd", mrd))
              for n, p in m.named_parameters()}
    return ({k: float(v) for k, v in metrics.items()}, params, seconds,
            [p.grad for p in gen.parameters()])


def _mesh_pipeline(mesh) -> dict:
    """``BinauralPipeline(mesh=)`` on the 10 s clip: one group of 21 slots.
    In bf16 with DDIM-25, bit for bit the unmeshed pipeline at
    ``unet_batch`` 21 (the same batch, so the same kernels and rounding),
    timed beside it and beside the three groups of 8, whose distance is
    printed: a bf16 UNet call at batch 21 and the same windows at batch 8
    differ by ~1.3 % rms (the plain versions too: cuDNN's and cuBLAS's
    bf16 sums), and a random-weight DDIM-25 carries that to ~10 % of the
    mel's rms.  Against the groups of 8 the clip is held in float32 (TF32
    off) at ``main_path_check``'s two DDIM steps and tolerances: the
    normalised stitched mel within 2e-3, the waveform within 1e-3 of its
    scale.  The same per-window x_T everywhere."""
    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.infer.pipeline import BinauralPipeline
    from diffbinaural_tpu_torch.infer.stage1 import normalize_mel

    total_frames = int(CLIP_SECONDS * SR) // HOP  # 861
    rng = np.random.default_rng(31)
    mono = rng.standard_normal((1, 80, total_frames)).astype(np.float32) - 6.0
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {"frames": total_frames}
    for dtype, steps in ((torch.bfloat16, DDIM_STEPS), (torch.float32, 2)):
        unet, voc = build_models(dtype)
        pipes = {
            "groups_of_8": BinauralPipeline(unet, voc, total_frames,
                                            unet_batch=UNET_BATCH,
                                            sampling_timesteps=steps),
            "one_group": BinauralPipeline(unet, voc, total_frames, mesh=mesh,
                                          sampling_timesteps=steps)}
        windows = pipes["groups_of_8"].n_windows
        pipes["unet_batch_21"] = BinauralPipeline(
            unet, voc, total_frames, unet_batch=windows,
            sampling_timesteps=steps)
        if (pipes["one_group"].n_batches, pipes["one_group"].n_slots) != (
                1, windows):
            fail(f"mesh_check pipeline: {pipes['one_group'].n_batches} "
                 f"groups of {pipes['one_group'].n_slots} slots")
        feats = rng.standard_normal((windows, 512)).astype(np.float32)
        grouped = torch.randn((pipes["groups_of_8"].n_batches, UNET_BATCH, 2,
                               80, WINDOW), generator=gen, device="cuda")
        one = grouped.reshape((-1, 2, 80, WINDOW))[:windows][None]
        noise = {"groups_of_8": grouped, "one_group": one,
                 "unet_batch_21": one}
        res = {}
        for name, pipe in pipes.items():
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if dtype == torch.bfloat16:
                wav = pipe(mono, feats, noise=noise[name])
            else:
                with torch.inference_mode():
                    mel = pipe.stitched_mel(mono, feats, noise=noise[name])
                    wav = voc(mel)[:, 0]
            torch.cuda.synchronize()
            res[name] = {"seconds": time.perf_counter() - t0,
                         "launches": ops.launch_counts(), "wav": wav.float(),
                         "mel": None if dtype == torch.bfloat16 else mel}
            if not torch.isfinite(wav).all() or tuple(wav.shape) != (
                    2, total_frames * HOP):
                fail(f"mesh_check pipeline: output {tuple(wav.shape)}")
        want, got = res["groups_of_8"], res["one_group"]
        wav_scale = want["wav"].abs().max().item()
        fields = {"ddim_steps": steps, "windows": windows,
                  "launches_one_group": got["launches"],
                  "wav_scale": wav_scale,
                  "wav_max_err_vs_groups_of_8":
                      (got["wav"] - want["wav"]).abs().max().item(),
                  "wav_rms_err_of_rms_vs_groups_of_8":
                      _rel_rms(got["wav"], want["wav"])}
        if dtype == torch.bfloat16:
            if not torch.equal(got["wav"], res["unet_batch_21"]["wav"]):
                fail("mesh_check pipeline: one group through the mesh is not "
                     "the unmeshed pipeline at unet_batch 21 bit for bit")
            if got["launches"] != launches(
                    flash_sdpa=DDIM_STEPS * ATTN_PER_STEP,
                    fused_alias_free_snake=ACT_PER_PASS,
                    fused_snake_conv=FUSED_PER_PASS):
                fail(f"mesh_check pipeline: launch counts {got['launches']}")
            fields.update({
                "equals_unet_batch_21_bit_for_bit": True,
                **{f"seconds_{k}": v["seconds"] for k, v in res.items()},
                "sync": "synchronize + host clock, one clip each"})
            out["bf16"] = fields
        else:
            mel_err = (normalize_mel(got["mel"]) - normalize_mel(
                want["mel"])).abs().max().item()
            if mel_err > 2e-3 or fields["wav_max_err_vs_groups_of_8"] > \
                    1e-3 * wav_scale:
                fail(f"mesh_check pipeline fp32: one group against groups of "
                     f"8: mel {mel_err:.3e} (tol 2e-3), waveform "
                     f"{fields['wav_max_err_vs_groups_of_8']:.3e} at scale "
                     f"{wav_scale:.3e} (tol 1e-3 of it)")
            fields.update(normalised_mel_max_err=mel_err, mel_tol=2e-3,
                          wav_tol_of_scale=1e-3, tf32=False)
            out["fp32"] = fields
        del unet, voc, pipes, res, want, got
        torch.cuda.empty_cache()
    return out


def phase_mesh_check(workdir: str, cli1: dict) -> dict:
    """``parallel/`` on the one card.  NCCL refuses two ranks on one GPU, so
    this phase opens a world-1 NCCL process group itself (a file store in
    the work directory) and drives, through ``make_mesh()``'s mesh of that
    group: two stage-1 bf16 steps at ``train_path``'s width and one stage-2
    step at ``stage2_path``'s configuration, each bit for bit against the
    same steps without a group (the all-reduce of one rank and the division
    by 1 are exact; both under ``deterministic_algorithms()``); then
    ``BinauralPipeline(mesh=)`` on the 10 s clip as one group of 21 slots
    (``_mesh_pipeline``).  It leaves the group, then runs
    ``python -m torch.distributed.run --nproc_per_node=1`` on
    ``train_realbinaural`` with ``train_cli_stage1``'s flags and one loader
    thread: its first step's loss and every file it writes must equal the
    same CLI's run in this process (without a launcher) bit for bit and
    byte for byte.  The all-reduce's time per step
    over the UNet's and the generator's gradients is timed with CUDA
    events; the steps and clips with the host clock beside their runs
    without the group.  There is no fallback: a group that cannot be made
    fails the run."""
    import torch.distributed as dist

    from diffbinaural_tpu_torch import ops, parallel
    from diffbinaural_tpu_torch.parallel.mesh import all_reduce_mean_

    out = {"phase": "mesh_check",
           "nccl_version": ".".join(map(str, torch.cuda.nccl.version()))}
    seconds, t_phase = {}, time.perf_counter()
    torch.cuda.empty_cache()
    # ---- the references, without a process group
    gan = build_gan(torch.bfloat16, seed=21)
    gan_start = [{n: v.clone() for n, v in m.state_dict().items()}
                 for m in gan[1:]]
    with deterministic_algorithms():
        s1_want, s1_params_want, s1_s_want, _ = _mesh_stage1(None)
        del _
        torch.cuda.empty_cache()
        s2_want, s2_params_want, s2_s_want, _ = _mesh_stage2(gan, None)
        del _
    for m, start in zip(gan[1:], gan_start):
        m.load_state_dict(start)
        m.zero_grad(set_to_none=True)
    del gan_start
    torch.cuda.empty_cache()
    seconds["references"] = time.perf_counter() - t_phase

    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(workdir, 'nccl_store')}",
        world_size=1, rank=0, device_id=torch.device("cuda", 0))
    out["group_init_s"] = time.perf_counter() - t0
    try:
        mesh = parallel.make_mesh()
        if tuple(mesh.shape) != (1, 1) or dist.get_backend() != "nccl":
            fail(f"mesh_check: mesh {tuple(mesh.shape)} over "
                 f"{dist.get_backend()}")
        # ---- 1. stage-1 steps through the group
        with deterministic_algorithms():
            ops.reset_launch_counts()
            s1_got, s1_params, s1_s, grads = _mesh_stage1(mesh)
            s1_counts = ops.launch_counts()
        _same_floats("mesh_check stage1 metrics", s1_got, s1_want)
        n1 = _same_modules("mesh_check stage1 parameters", s1_params,
                           s1_params_want)
        if s1_counts != launches(flash_sdpa_with_lse=2 * ATTN_PER_STEP,
                                 flash_sdpa_backward=2 * ATTN_PER_STEP):
            fail(f"mesh_check stage1: launch counts {s1_counts}")
        unet_ar_ms = time_ms(lambda: all_reduce_mean_(grads, mesh))
        unet_bytes = sum(g.numel() * g.element_size() for g in grads)
        del grads, s1_params, s1_params_want
        torch.cuda.empty_cache()
        # ---- 2. one stage-2 step through the group
        with deterministic_algorithms():
            ops.reset_launch_counts()
            s2_got, s2_params, s2_s, grads = _mesh_stage2(gan, mesh)
            s2_counts = ops.launch_counts()
        _same_floats("mesh_check stage2 metrics", s2_got, s2_want)
        n2 = _same_modules("mesh_check stage2 parameters", s2_params,
                           s2_params_want)
        if s2_counts != gan_launches(1, bf16=True):
            fail(f"mesh_check stage2: launch counts {s2_counts}")
        gen_ar_ms = time_ms(lambda: all_reduce_mean_(grads, mesh))
        gen_bytes = sum(g.numel() * g.element_size() for g in grads)
        del grads, s2_params, s2_params_want, gan
        torch.cuda.empty_cache()
        seconds["steps_through_the_group"] = (time.perf_counter() - t_phase
                                              - seconds["references"])
        # ---- 3. the 10 s clip in one group of 21 slots
        t0 = time.perf_counter()
        pipe_out = _mesh_pipeline(mesh)
        seconds["pipeline"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()

    # ---- 4. the train CLI under the launcher against the same CLI run in
    # this process, on train_cli_stage1's world and flags with one loader
    # thread (several threads draw from the dataset's one random.Random in
    # the order they are scheduled, so their batches differ between runs)
    from diffbinaural_tpu_torch.cli import common, train_realbinaural

    def flags(ck):
        argv = list(cli1["argv"]) + ["--workers", "1", "--num_epoch", "1"]
        argv[argv.index("--ckpt") + 1] = ck
        return argv

    ck_want = os.path.join(workdir, "ckpt_unlaunched")
    with deterministic_algorithms(), recorded_first_step(common) as rec:
        t0 = time.perf_counter()
        _cli_quietly(train_realbinaural.main, flags(ck_want))
        seconds["unlaunched_cli"] = time.perf_counter() - t0
    first_loss = rec["loss"]
    del rec
    torch.cuda.empty_cache()
    ck = os.path.join(workdir, "ckpt_launched")
    script = os.path.join(workdir, "launched_cli.py")
    with open(script, "w") as f:
        f.write(LAUNCHED_CLI)
    record_path = os.path.join(workdir, "launched_cli.json")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", script, record_path] + flags(ck)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail("mesh_check: the launched train CLI did not finish in 300 s")
    seconds["launched_cli"] = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"mesh_check: the launched train CLI exited "
             f"{proc.returncode}: {log[-3000:]}")
    with open(record_path) as f:
        record = json.load(f)
    if (record.get("backend"), record.get("world_size")) != ("nccl", 1) \
            or not record.get("group_left"):
        fail(f"mesh_check: the launched CLI ran {record}")
    if not record["losses"] or repr(record["losses"][0]) != repr(first_loss):
        fail(f"mesh_check: the launched CLI's first loss "
             f"{record['losses'][:1]} against {first_loss!r}")
    files = sorted(os.listdir(os.path.join(ck_want, "chip")))
    if sorted(os.listdir(os.path.join(ck, "chip"))) != files:
        fail(f"mesh_check: the launched CLI wrote "
             f"{sorted(os.listdir(os.path.join(ck, 'chip')))}, not {files}")
    for name in files:
        with open(os.path.join(ck, "chip", name), "rb") as f:
            got_bytes = f.read()
        with open(os.path.join(ck_want, "chip", name), "rb") as f:
            if got_bytes != f.read():
                fail(f"mesh_check: the launched CLI's {name} differs from "
                     "the same CLI's in this process")

    out.update(
        world_size=1, backend="nccl", mesh=[1, 1],
        deterministic_algorithms=True,
        stage1={"dtype": "bf16", "batch": TRAIN_BATCH, "steps": 2,
                "metrics": s1_got, "bit_for_bit_parameters": n1,
                "seconds_per_step_group": s1_s,
                "seconds_per_step_no_group": s1_s_want,
                "launches": s1_counts},
        stage2={"generator_dtype": "bf16", "batch": GAN_BATCH,
                "segment": GAN_SEGMENT, "metrics": s2_got,
                "bit_for_bit_parameters": n2, "seconds_group": s2_s,
                "seconds_no_group": s2_s_want, "launches": s2_counts},
        allreduce_ms_per_step={
            "unet_grads": unet_ar_ms, "unet_grad_bytes": unet_bytes,
            "generator_grads": gen_ar_ms, "generator_grad_bytes": gen_bytes,
            "timing": "CUDA events over 10 back-to-back calls of "
                      "all_reduce_mean_ (concatenate, NCCL all-reduce, "
                      "divide, copy back) on the step's gradients"},
        pipeline=pipe_out,
        seconds={**seconds, "phase": time.perf_counter() - t_phase},
        launched_cli={"command": "python -m torch.distributed.run "
                      "--standalone --nproc_per_node=1 -m "
                      "diffbinaural_tpu_torch.cli.train_realbinaural "
                      "(run as __main__ by a wrapper that records the "
                      "losses under deterministic algorithms)",
                      "flags_added": ["--workers", "1"],
                      "first_step_loss": record["losses"][0],
                      "losses": record["losses"],
                      "device": record["device"],
                      "files_byte_equal": files})
    emit(out)
    return out


def phase_remat_check() -> None:
    """One stage-2 D+G step at the production configuration in float32
    (TF32 off), batch 2 x 16384, with ``remat`` on against off from one
    state, with deterministic algorithms: the metrics, every gradient and
    every updated parameter within ``STAGE2_REPEAT_TOL`` of its own scale
    (the recomputed forward is the same forward)."""
    from diffbinaural_tpu_torch import ops

    b = 2
    h, gen, mpd, mrd = build_gan(torch.float32, seed=51)
    modules = {"generator": gen, "mpd": mpd, "mrd": mrd}
    start = {k: {n: v.clone() for n, v in m.state_dict().items()}
             for k, m in modules.items()}
    batch = gan_batch(h, b, seed=52)

    def run(remat):
        for k, m in modules.items():
            m.load_state_dict(start[k])
        init_fn, step_fn = make_gan_step(h, gen, mpd, mrd, remat=remat)
        ops.reset_launch_counts()
        _, metrics = step_fn(init_fn(), batch)
        torch.cuda.synchronize()
        grads = {f"{k}.{n}": p.grad.clone() for k, m in modules.items()
                 for n, p in m.named_parameters()}
        params = _named(**modules)
        return ({k: float(v) for k, v in metrics.items()}, grads,
                {k: v.clone() for k, v in params.items()},
                ops.launch_counts())

    with deterministic_algorithms():
        m_on, g_on, p_on, c_on = run(True)
        m_off, g_off, p_off, c_off = run(False)
    worst = {"metrics": 0.0, "grads": 0.0, "params": 0.0}
    for k in GAN_METRICS:
        worst["metrics"] = max(worst["metrics"], abs(m_on[k] - m_off[k])
                               / max(abs(m_off[k]), 1e-30))
    for part, on, off in (("grads", g_on, g_off), ("params", p_on, p_off)):
        for k, v in off.items():
            scale = max(v.abs().max().item(), 1e-30)
            worst[part] = max(worst[part],
                              (on[k] - v).abs().max().item() / scale)
    if max(worst.values()) > STAGE2_REPEAT_TOL:
        fail(f"remat_check: remat on against off differs: {worst} "
             f"(limit {STAGE2_REPEAT_TOL:.0e} of the own scale)")
    # float32: K3b's products are the library's, not the dz / dW kernels
    want_on = launches(**dict(REMAT_GAN_PER_STEP, snake_conv_dgrad=0,
                              snake_conv_wgrad=0))
    if c_on != want_on or c_off != gan_launches(1, bf16=False):
        fail(f"remat_check: launches {c_on} (remat) {c_off} (no remat)")
    emit({"phase": "remat_check", "dtype": "fp32", "tf32": False, "batch": b,
          "segment": GAN_SEGMENT, "config": GAN_CONFIG,
          "deterministic_algorithms": True,
          "worst_rel_diff_of_own_scale": worst,
          "tol_of_own_scale": STAGE2_REPEAT_TOL, "metrics_remat": m_on,
          "launches_remat": c_on, "launches_no_remat": c_off})
    del gen, mpd, mrd, modules, start, g_on, g_off, p_on, p_off
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recorded_saves(gan_common):
    """Wrap ``GanTrainer.save`` so that each checkpoint's parameters are
    also kept in memory, and time ``save`` and ``validate`` (host clock, a
    synchronisation before each), keyed by the step: comparison and timing
    aids of this script."""
    trainer = gan_common.GanTrainer
    save, validate = trainer.save, trainer.validate
    record = {"params": {}, "save_s": {}, "validate_s": {}}

    def recording_save(self, epoch):
        record["params"][self.steps] = {k: v.clone() for k, v in _named(
            gen=self.gen, mpd=self.mpd, mrd=self.mrd).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, epoch)
        record["save_s"][self.steps] = time.perf_counter() - t0

    def timed_validate(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = validate(self, *args, **kwargs)
        record["validate_s"][self.steps] = time.perf_counter() - t0
        return out

    trainer.save, trainer.validate = recording_save, timed_validate
    try:
        yield record
    finally:
        trainer.save, trainer.validate = save, validate


def phase_train_cli_stage2(world: dict, workdir: str) -> dict:
    """``cli.train_binaural_both.main`` on the production config as shipped
    (B = 32 x 16384, so ``remat`` is on; bfloat16 generator, float32
    discriminators), one epoch of the 96 items = 3 steps, a checkpoint at
    step 2 and the validation at step 3; ``--evaluate True`` on the same
    directory (resume at step 3 with the step-2 parameters bit for bit);
    then ``cli.train_binaural_mel.main`` for one step (16 mel pairs = 32
    items) from there."""
    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.cli import (gan_common, train_binaural_both,
                                            train_binaural_mel)
    from diffbinaural_tpu_torch.core.config import load_hparams_from_json

    h = load_hparams_from_json(GAN_CONFIG)
    ck = os.path.join(workdir, "ckpt_stage2")
    common_argv = ["--config", GAN_CONFIG, "--checkpoint_path", ck,
                   "--audio_dir", world["audio"], "--stdout_interval", "1",
                   "--summary_interval", "1000", "--checkpoint_interval", "2",
                   "--validation_interval", "3", "--training_epochs", "1"]
    both_argv = common_argv + [
        "--mel_pred_left_train_dir", world["pred_left_train"],
        "--mel_pred_right_train_dir", world["pred_right_train"],
        "--mel_pred_left_val_dir", world["pred_left_val"],
        "--mel_pred_right_val_dir", world["pred_right_val"]]
    mel_argv = common_argv + [
        "--mel_left_train_dir", world["pred_left_val"],
        "--mel_right_train_dir", world["pred_right_val"],
        "--mel_left_val_dir", world["pred_left_val"],
        "--mel_right_val_dir", world["pred_right_val"]]
    steps = 2 * GAN_WORLD_CLIPS // h["batch_size"]
    out = {"phase": "train_cli_stage2", "config": GAN_CONFIG,
           "batch": h["batch_size"], "segment": h["segment_size"],
           "generator_dtype": "bf16", "discriminator_dtype": "fp32",
           "tf32": False}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with recorded_saves(gan_common) as saved:
        t0 = time.perf_counter()
        try:
            both = _cli_quietly(train_binaural_both.main, both_argv)
        except torch.cuda.OutOfMemoryError as exc:
            fail(f"train_cli_stage2: batch {h['batch_size']} with remat "
                 f"does not fit the card: {exc}")
        out["run1_s"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    if not both.remat or both.steps != steps:
        fail(f"train_cli_stage2: remat {both.remat}, {both.steps} steps")
    files = sorted(os.listdir(ck))
    for f in ("config.json", "g_00000002", "do_00000002"):
        if f not in files:
            fail(f"train_cli_stage2: no {f} ({files})")
    validations = steps // 3  # --validation_interval 3
    predicted = {k: steps * REMAT_GAN_PER_STEP.get(k, 0)
                 + validations * GAN_VAL_ITEMS * GAN_VAL_PER_ITEM.get(k, 0)
                 for k in GAN_KERNELS + ("fused_alias_free_snake",
                                         "fused_snake_conv")}
    never = [k for k in predicted if counts[k] < 1]
    if never:
        fail(f"train_cli_stage2: kernels never launched: {never}")
    timings = _timings([both])
    extra = [saved["save_s"].get(i, 0.0) + saved["validate_s"].get(i, 0.0)
             for i in range(1, steps + 1)]
    bare = [t - x for t, x in zip(both.timings["step_s"], extra)]
    del both
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    evaluated = _cli_quietly(train_binaural_both.main,
                                both_argv + ["--evaluate", "True"])
    val_counts = ops.launch_counts()
    if evaluated.steps != 3 or evaluated.last_epoch != 0:
        fail(f"train_cli_stage2: resumed at step {evaluated.steps}, epoch "
             f"{evaluated.last_epoch}")
    n = _same_modules("train_cli_stage2: resumed parameters",
                      _named(gen=evaluated.gen, mpd=evaluated.mpd,
                             mrd=evaluated.mrd), saved["params"][2])
    del evaluated
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    mel = _cli_quietly(train_binaural_mel.main, mel_argv)
    mel_counts = ops.launch_counts()
    if mel.steps != 4 or len(mel.timings["step_s"]) != 1:
        fail(f"train_cli_stage2: train_binaural_mel ended at step "
             f"{mel.steps} after {len(mel.timings['step_s'])} steps")
    if "g_00000004" not in os.listdir(ck):
        fail("train_cli_stage2: train_binaural_mel wrote no g_00000004")
    timings_mel = _timings([mel])
    del mel
    torch.cuda.empty_cache()
    out.update(
        steps=steps, remat=True, **timings,
        seconds_per_step_without_save_and_validation=statistics.median(bare),
        seconds_per_step_without_save_and_validation_runs=bare,
        save_s=saved["save_s"], validate_s=saved["validate_s"],
        train_binaural_mel_step_s=timings_mel["seconds_per_step"],
        train_binaural_mel_wait_s=timings_mel["loader_wait_s_per_step"],
        timing="host clock: wait = from the previous step's end to the "
               "batch in hand; step = wait + copy to the card + step_fn + "
               "the metrics printed (a synchronisation) + any checkpoint "
               "or validation that step triggers",
        resume_bit_for_bit=True, parameters_checked=n,
        launches=counts, launches_predicted=predicted,
        launches_match_prediction=all(counts[k] == v
                                      for k, v in predicted.items()),
        launches_per_step_predicted={k: v for k, v in
                                     REMAT_GAN_PER_STEP.items()},
        launches_per_validation=val_counts,
        launches_train_binaural_mel_step=mel_counts, checkpoints=files)
    emit(out)
    return out


# ------------------------------------------- evaluation on a test split

# the test split: the first EVAL_CLIPS val videos of the stage-1 world; a
# 10 s clip is 861 frames = 21 windows, one sampler group (max_batch 32)
EVAL_CLIPS, CLI_WINDOWS = 4, 21
POS_SECONDS, POS_STEPS = 3.0, 50  # test_pos: one 3 s clip, DDIM-50
FEW_FILES, FEW_WINDOWS = 2, 3
K1_FP32_TOL = 2e-4  # absolute, as check_k1's float32 cases
# card against CPU in one process: the CPU tests' tolerances
EVAL_TOLS = {"sar": 1e-8, "sir": 1e-8, "sdr": 1e-8, "pesq_mos": 1e-9}
EVAL_REL = 1e-10


def check_k1_fp32_test_cli(gen) -> list:
    """K1 in float32 at the test CLIs' shapes, (21, 4, 6400 | 1600, 32): one
    group of a 10 s clip's 21 windows through the float32 UNet.  Against
    its plain version in batch chunks of 3 (2e-4 absolute, as check_k1's
    float32 cases), a second run bit for bit, timed beside the earlier
    CUDA-core kernel (``cuda_core_ms``), its split-TF32 and CUDA-core bounds
    and one ``F.scaled_dot_product_attention`` in float32 (TF32 off)."""
    from diffbinaural_tpu_torch.ops import flash_sdpa, sdpa_plain

    cases = []
    for n in (6400, 1600):
        shape = (CLI_WINDOWS, 4, n, 32)
        q, k, v = (rand(gen, shape, torch.float32) for _ in range(3))
        scale = shape[-1] ** -0.5

        def plain():
            return _in_batch_chunks(lambda *a: (sdpa_plain(*a, scale),), 3,
                                    q, k, v)[0]

        got = flash_sdpa(q, k, v, scale)
        want = plain()
        err = _compare("flash_sdpa", (shape, "fp32"), got, want, K1_FP32_TOL,
                       False)
        case = {"kernel": "flash_sdpa", "shape": list(shape), "dtype": "fp32",
                "max_err": err, "tol": K1_FP32_TOL,
                "output_scale": want.abs().max().item(),
                "bit_identical_repeat": _same_bits_twice(
                    "flash_sdpa", (shape, "fp32"), got,
                    lambda: flash_sdpa(q, k, v, scale)),
                "ms": time_ms(lambda: flash_sdpa(q, k, v, scale)),
                "cuda_core_ms": cuda_core_ms(
                    lambda: flash_sdpa(q, k, v, scale)),
                "plain_ms": time_ms(plain, warmup=1, iters=3),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale)),
                "library": "F.scaled_dot_product_attention, fp32, TF32 off"}
        b, h, _, d = shape
        _bound(case, 4.0 * b * h * n * n * d, 4.0 * b * h * n * d * 4, "fp32",
               exps=float(b * h * n * n), split_tf32=True)
        del got, want, q, k, v
        cases.append(case)
    emit({"phase": "k1_fp32_test_cli", "cases": cases})
    torch.cuda.empty_cache()
    return cases


class RecordedClip:
    """What ``cli.common.dump_clip_mels`` reads of a dataset, replayed from
    the items the CLI's features function was given (no JPEG is decoded a
    second time)."""

    def __init__(self, dataset, items):
        self.full_mel, self.starts = dataset.full_mel, dataset.starts
        self.rows, self.items = dataset.rows, items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@contextlib.contextmanager
def recorded_clips(module):
    """Wrap ``module.dump_clip_mels`` (a test CLI's) so that each clip is
    recorded: the dataset and the items its features function was given,
    the encoder's seconds (synchronised around each window's call), the
    seconds of the whole call (windows, encoder, sampler, files), the
    launch counts it made and the mels it returned.  A comparison aid of
    this script; the call itself runs unchanged."""
    from diffbinaural_tpu_torch import ops

    dump, records = module.dump_clip_mels, []

    def recording(args, sampler, dataset, out_left, out_right,
                  features_fn=None, **kw):
        rec = {"items": [], "encoder_s": 0.0, "dataset": dataset}

        def features(item):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feat = features_fn(item)
            torch.cuda.synchronize()
            rec["encoder_s"] += time.perf_counter() - t0
            rec["items"].append(item)
            return feat

        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = dump(args, sampler, dataset, out_left, out_right,
                   features_fn=features if features_fn else None, **kw)
        rec["seconds"] = time.perf_counter() - t0  # the mels are on the host
        after = ops.launch_counts()
        rec.update(mel=mel, launches={k: after[k] - before[k] for k in after})
        records.append(rec)
        return mel

    module.dump_clip_mels = recording
    try:
        yield records
    finally:
        module.dump_clip_mels = dump


def write_eval_checkpoints(ck: str) -> dict:
    """The test CLIs' and ``inference_e2e``'s checkpoints, written as the
    JAX trainers write them (``module_tree`` -> ``save_checkpoint``): the
    dim-64 UNet (seed 71) as ``unet_best.pth`` and as the numbered
    ``unet_000001.pth`` that ``test_pos`` scans for, ``ClipPos2D`` over
    ViT-B/32 (seed 72) as ``frame_best.pth``, and the generator of
    GAN_CONFIG (seed 73) as ``voc/g_00000001`` beside its config.  Returns
    the in-memory models and the paths."""
    import shutil

    from diffbinaural_tpu_torch import models
    from diffbinaural_tpu_torch.cli.common import module_tree
    from diffbinaural_tpu_torch.core import checkpoint
    from diffbinaural_tpu_torch.core.config import (VocoderConfig,
                                                    load_hparams_from_json)
    from diffbinaural_tpu_torch.models.visual import build_visual

    t0 = time.perf_counter()
    unet = models.build_unet(seed=71)
    visual = build_visual("clip_pos2d", seed=72)
    cfg = VocoderConfig.from_attrdict(load_hparams_from_json(GAN_CONFIG))
    voc = models.build_vocoder(cfg, seed=73)
    exp = os.path.join(ck, "eval")
    os.makedirs(os.path.join(ck, "voc"))
    paths = {"unet": os.path.join(exp, "unet_best.pth"),
             "numbered": os.path.join(exp, "unet_000001.pth"),
             "frame": os.path.join(exp, "frame_best.pth"),
             "generator": os.path.join(ck, "voc", "g_00000001")}
    unet_tree = module_tree(unet)
    checkpoint.save_checkpoint(paths["unet"], unet_tree)
    checkpoint.save_checkpoint(paths["numbered"], unet_tree)
    checkpoint.save_checkpoint(paths["frame"], module_tree(visual))
    checkpoint.save_checkpoint(paths["generator"],
                               {"generator": module_tree(voc)})
    shutil.copy(GAN_CONFIG, os.path.join(ck, "voc", "config.json"))
    return {"unet": unet, "visual": visual, "paths": paths,
            "write_s": time.perf_counter() - t0,
            "bytes": {k: os.path.getsize(p) for k, p in paths.items()}}


def _split(path: str, vids) -> str:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "start_time", "end_time", "action_label"])
        w.writerows([v, "0.0", f"{CLIP_SECONDS:.1f}", "synthetic"]
                    for v in vids)
    return path


def _read_csv(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def _csvs_agree(name: str, got_path: str, want_path: str) -> dict:
    """The card's CSV against the CPU's: the same columns, rows and names,
    each value within its metric's tolerance (EVAL_TOLS absolute, else
    EVAL_REL relative).  Returns the worst deviation by column."""
    got, want = _read_csv(got_path), _read_csv(want_path)
    if got[0] != want[0] or len(got) != len(want) or len(got) < 2:
        fail(f"{name}: columns / rows {got[0]} x {len(got)} vs "
             f"{want[0]} x {len(want)}")
    worst = {}
    for g_row, w_row in zip(got[1:], want[1:]):
        for col, g, w in zip(got[0], g_row, w_row):
            try:
                gv, wv = float(g), float(w)
            except ValueError:
                if g != w:
                    fail(f"{name}: {col} {g!r} vs {w!r}")
                continue
            if not np.isfinite(gv) or not np.isfinite(wv):
                if g != w:
                    fail(f"{name}: {col} {g} vs {w}")
                continue
            err = abs(gv - wv)
            tol = EVAL_TOLS.get(col, EVAL_TOLS.get(g_row[0]))
            limit = tol if tol is not None else EVAL_REL * abs(wv) + 1e-15
            if err > limit:
                fail(f"{name}: {g_row[0]} {col}: card {gv!r} vs cpu {wv!r}")
            key = g_row[0] if col in ("mean", "std") else col
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def phase_eval_cli(world: str, workdir: str) -> dict:
    """A trained model judged on a test split, through the CLIs a user
    calls: ``test_realbinaural`` (the dim-64 float32 UNet, DDIM-25, one
    group of 21 windows per 10 s clip, ``ClipPos2D`` over ViT-B/32 on each
    window's 5 frames x 4 sources) on EVAL_CLIPS val videos of the stage-1
    world under ``deterministic_algorithms()``, each clip bit for bit
    against ``dump_clip_mels`` on the in-memory models; ``test_fairplay``
    on one of them (bit for bit its ``test_realbinaural`` mels: the same
    windows under another key); ``test_pos`` on one 3 s clip (6 windows x
    DDIM-50, the legacy log1p normalisation); ``test_realbinaural_few``
    (2 files x 3 windows, Pillow figures); ``inference_e2e`` on the dumped
    mels with the production generator (float32); then
    ``evaluate_binaural_22050 --pesq`` (BSS on) and
    ``evaluate_mel_spectrogram_rmse`` against the world's binaural wavs,
    on the card and with ``device="cpu"``: the two CSVs agree to the CPU
    tests' tolerances.  Launch counts per clip / file as predicted from
    the code; seconds per clip with the encoder's share, per vocoded file,
    and the battery's seconds per file on the card and on the CPU."""
    from argparse import Namespace

    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.cli import (evaluate_binaural_22050,
                                            evaluate_mel_spectrogram_rmse,
                                            inference_e2e, test_fairplay,
                                            test_pos, test_realbinaural,
                                            test_realbinaural_few)
    from diffbinaural_tpu_torch.cli.common import (dump_clip_mels,
                                                   visual_apply_fn)
    from diffbinaural_tpu_torch.data.audio_io import load_wav, save_wav
    from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
    from diffbinaural_tpu_torch.evaluation.runner import (
        TRIM_SAMPLES, evaluate_binaural_pair)
    from diffbinaural_tpu_torch.infer.stage1 import (Stage1Sampler,
                                                     window_starts)
    from diffbinaural_tpu_torch.utils import device_memory_stats

    frames = int(CLIP_SECONDS * SR) // HOP
    windows = len(window_starts(frames))
    out = {"phase": "eval_cli", "unet_dtype": "fp32", "encoder_dtype": "fp32",
           "generator_dtype": "fp32", "tf32": False}
    ck = os.path.join(workdir, "ckpt_eval")
    models = write_eval_checkpoints(ck)
    out["checkpoints"] = {"write_s": models["write_s"],
                          "bytes": models["bytes"]}
    vids = [f"vid{WORLD_TRAIN + i:03d}" for i in range(EVAL_CLIPS)]
    test_csv = _split(os.path.join(workdir, "test.csv"), vids)
    mels = {s: os.path.join(workdir, "eval_mels", s) for s in ("left", "right")}

    def test_argv(split, out):
        return ["--data_root", world, "--list_test", split, "--ckpt", ck,
                "--id", "eval", "--arch_frame", "clip_pos2d",
                "--output_dir_left", out["left"],
                "--output_dir_right", out["right"]]

    torch.cuda.reset_peak_memory_stats()
    per_clip_k1 = launches(flash_sdpa=DDIM_STEPS * ATTN_PER_STEP)  # 1 group
    by_path = {}

    # test_realbinaural on the split, each clip against dump_clip_mels
    with deterministic_algorithms() as caught:
        with recorded_clips(test_realbinaural) as clips:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _cli_quietly(test_realbinaural.main, test_argv(test_csv, mels))
            cli_s = time.perf_counter() - t0
            by_path["test_realbinaural"] = ops.launch_counts()
        if len(clips) != EVAL_CLIPS:
            fail(f"eval_cli: test_realbinaural dumped {len(clips)} clips")
        unet, visual = models["unet"], models["visual"]
        apply = visual_apply_fn(visual, "clip_pos2d")
        sampler = Stage1Sampler(unet, GaussianDiffusion(
            image_size=80, timesteps=1000, sampling_timesteps=DDIM_STEPS,
            beta_schedule="cosine", auto_normalize=False))

        def features(item):
            with torch.inference_mode():
                return apply(*(torch.from_numpy(np.ascontiguousarray(
                    item[k]))[None].cuda() for k in ("frames", "2d_pos_data",
                                                     "mask")))[0]

        for i, rec in enumerate(clips):
            mel = rec["mel"]
            if (len(rec["items"]) != windows or mel.shape != (2, 80, frames)
                    or not np.isfinite(mel).all()):
                fail(f"eval_cli: clip {i}: {len(rec['items'])} windows, mel "
                     f"{mel.shape}, finite {np.isfinite(mel).all()}")
            if rec["launches"] != per_clip_k1:
                fail(f"eval_cli: clip {i} launches {rec['launches']} != "
                     f"{per_clip_k1}")
            base = rec["dataset"].rows[0]["video_id"]
            for side, m in zip(("left", "right"), mel):
                _bit_for_bit(f"eval_cli: clip {i} {side} .npy",
                             np.load(os.path.join(mels[side], base + ".npy")),
                             m.astype(np.float64))
            direct = dump_clip_mels(
                Namespace(crop_frames=8), sampler,
                RecordedClip(rec["dataset"], rec["items"]),
                os.path.join(workdir, "direct_l"),
                os.path.join(workdir, "direct_r"), features_fn=features)
            _bit_for_bit(f"eval_cli: clip {i} CLI against dump_clip_mels",
                         mel, direct.astype(np.float64))
    seconds = [r["seconds"] for r in clips]
    out["test_realbinaural"] = {
        "clips": EVAL_CLIPS, "frames_per_clip": frames,
        "windows_per_clip": windows, "groups": 1,
        "ddim_steps": DDIM_STEPS, "frames_per_window": [5, 4],
        "cli_s": cli_s, "seconds_per_clip": statistics.median(seconds[1:]),
        "seconds_per_clip_runs": seconds,
        "encoder_s_runs": [r["encoder_s"] for r in clips],
        "encoder_share": statistics.median(r["encoder_s"] / r["seconds"]
                                           for r in clips[1:]),
        "timing": "synchronize + host clock around dump_clip_mels (the "
                  "windows' items, the encoder, the sampler, the .npy "
                  "files); median of the clips after the first",
        "launches_per_clip": {k: v for k, v in per_clip_k1.items() if v},
        "equals_dump_clip_mels": "bit for bit",
        "deterministic_warnings": sorted({str(w.message)[:80]
                                          for w in caught})}
    first_mels = clips[0]["mel"]
    del clips, sampler, apply
    torch.cuda.empty_cache()

    # test_fairplay on the first clip: the same windows, key mix_mel
    one_csv = _split(os.path.join(workdir, "test_one.csv"), vids[:1])
    fair = {s: os.path.join(workdir, "fair_mels", s) for s in mels}
    with deterministic_algorithms():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _cli_quietly(test_fairplay.main, test_argv(one_csv, fair))
        fair_s = time.perf_counter() - t0
        by_path["test_fairplay"] = ops.launch_counts()
    if by_path["test_fairplay"] != per_clip_k1:
        fail(f"eval_cli: test_fairplay launches {by_path['test_fairplay']}")
    for side, m in zip(("left", "right"), first_mels):
        _bit_for_bit(f"eval_cli: test_fairplay {side} against "
                     "test_realbinaural",
                     np.load(os.path.join(fair[side], vids[0] + ".npy")),
                     m.astype(np.float64))
    out["test_fairplay"] = {"clips": 1, "cli_s": fair_s,
                            "equals_test_realbinaural": "bit for bit"}

    # test_pos: one 3 s clip, every window from x_T of seed 13
    pos_wav = os.path.join(workdir, "pos", "pos0.wav")
    save_wav(pos_wav, synthetic_clip(81)[: int(POS_SECONDS * SR)], SR)
    pos_csv = _split(os.path.join(workdir, "test_pos.csv"), [pos_wav])
    pos_frames = int(POS_SECONDS * SR) // HOP
    pos_windows = len(window_starts(pos_frames))
    pos_out = {s: os.path.join(workdir, "pos_mels", s) for s in mels}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _cli_quietly(test_pos.main, [
        "--list_test", pos_csv, "--ckpt", ck, "--id", "eval",
        "--output_dir_left", pos_out["left"],
        "--output_dir_right", pos_out["right"]])
    torch.cuda.synchronize()
    pos_s = time.perf_counter() - t0
    by_path["test_pos"] = ops.launch_counts()
    expected = launches(flash_sdpa=pos_windows * POS_STEPS * ATTN_PER_STEP)
    if by_path["test_pos"] != expected:
        fail(f"eval_cli: test_pos {pos_windows} windows, launches "
             f"{by_path['test_pos']} != {expected}")
    pos_mel = np.load(os.path.join(pos_out["left"], "pos0.npy"))
    if (pos_mel.shape != (80, pos_frames) or not np.isfinite(pos_mel).all()
            or pos_mel.min() < 0):
        fail(f"eval_cli: test_pos mel {pos_mel.shape}, range "
             f"{pos_mel.min()}..{pos_mel.max()}")
    out["test_pos"] = {"seconds": POS_SECONDS, "windows": pos_windows,
                       "ddim_steps": POS_STEPS, "cli_s": pos_s,
                       "checkpoint": "unet_000001.pth (scan)",
                       "mel_range": [float(pos_mel.min()),
                                     float(pos_mel.max())]}

    # test_realbinaural_few: the mono wavs at the data root's top level
    few_dir = os.path.join(workdir, "few")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _cli_quietly(test_realbinaural_few.main, [
        "--data_root", os.path.join(world, "processed/mono_audios_22050Hz"),
        "--list_test", test_csv, "--ckpt", ck, "--id", "eval",
        "--arch_frame", "clip_pos2d", "--max_files", str(FEW_FILES),
        "--max_windows", str(FEW_WINDOWS), "--output_dir", few_dir])
    few_s = time.perf_counter() - t0
    by_path["test_realbinaural_few"] = ops.launch_counts()
    expected = launches(
        flash_sdpa=FEW_FILES * FEW_WINDOWS * DDIM_STEPS * ATTN_PER_STEP)
    want_files = sorted([f"{v}.txt" for v in vids[:FEW_FILES]]
                        + [f"{v}_w{w}.png" for v in vids[:FEW_FILES]
                           for w in range(FEW_WINDOWS)])
    if (by_path["test_realbinaural_few"] != expected
            or sorted(os.listdir(few_dir)) != want_files):
        fail(f"eval_cli: test_realbinaural_few launches "
             f"{by_path['test_realbinaural_few']}, files "
             f"{sorted(os.listdir(few_dir))}")
    summary = open(os.path.join(few_dir, vids[0] + ".txt")).read()
    out["test_realbinaural_few"] = {"files": FEW_FILES,
                                    "windows": FEW_WINDOWS, "cli_s": few_s,
                                    "summary": summary.splitlines()}
    del models
    torch.cuda.empty_cache()

    # the vocoder over the dumped mels
    gen_dir = os.path.join(workdir, "generated")
    with captured_writes(inference_e2e) as writes:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        inference_e2e.main([
            "--input_mels_left_dir", mels["left"],
            "--input_mels_right_dir", mels["right"],
            "--checkpoint_file", os.path.join(ck, "voc", "g_00000001"),
            "--output_dir", gen_dir])
        e2e_s = time.perf_counter() - t0
        by_path["inference_e2e"] = ops.launch_counts()
    per_file = launches(fused_alias_free_snake=2 * ACT_PER_PASS,
                        fused_snake_conv=2 * FUSED_PER_PASS)  # L, R apart
    before = launches()
    for i, w in enumerate(writes):
        got = {k: w["counts"][k] - before[k] for k in before}
        before = w["counts"]
        if got != per_file or w["wav"].shape != (2, frames * HOP) or \
                not np.isfinite(w["wav"]).all():
            fail(f"eval_cli: inference_e2e file {i}: launches {got}, wav "
                 f"{w['wav'].shape}")
    if len(writes) != EVAL_CLIPS:
        fail(f"eval_cli: inference_e2e wrote {len(writes)} wavs")
    vocoder_s = [writes[i]["t"] - writes[i - 1]["t"]
                 for i in range(1, EVAL_CLIPS)]
    out["inference_e2e"] = {
        "files": EVAL_CLIPS, "cli_s": e2e_s,
        "seconds_per_file": statistics.median(vocoder_s),
        "seconds_per_file_runs": vocoder_s,
        "timing": "host clock between consecutive files' wav writes",
        "launches_per_file": {k: v for k, v in per_file.items() if v}}

    # the evaluation battery, on the card and on the CPU in this process
    gt_dir = os.path.join(world, "processed/binaural_audios_22050Hz")
    battery = {}
    for dev in ("cuda", "cpu"):
        csv_path = os.path.join(workdir, f"binaural_{dev}.csv")
        mel_csv = os.path.join(workdir, f"mel_{dev}.csv")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _cli_quietly(evaluate_binaural_22050.main, [
            "--generated_dir", gen_dir, "--gt_dir", gt_dir, "--pesq",
            "--output_csv", csv_path], device=dev)
        t1 = time.perf_counter()
        _cli_quietly(evaluate_mel_spectrogram_rmse.main, [
            "--pred_left_dir", mels["left"], "--pred_right_dir",
            mels["right"], "--gt_audio_dir", gt_dir, "--output_csv",
            mel_csv], device=dev)
        battery[dev] = {"evaluate_binaural_22050_s": t1 - t0,
                        "evaluate_mel_spectrogram_rmse_s":
                            time.perf_counter() - t1,
                        "launches": sum(ops.launch_counts().values())}
    if battery["cuda"]["launches"] or battery["cpu"]["launches"]:
        fail(f"eval_cli: the evaluation launched a kernel: {battery}")
    worst = {
        "binaural": _csvs_agree("evaluate_binaural_22050",
                                os.path.join(workdir, "binaural_cuda.csv"),
                                os.path.join(workdir, "binaural_cpu.csv")),
        "binaural_summary": _csvs_agree(
            "evaluate_binaural_22050 summary",
            os.path.join(workdir, "binaural_cuda_summary.csv"),
            os.path.join(workdir, "binaural_cpu_summary.csv")),
        "mel": _csvs_agree("evaluate_mel_spectrogram_rmse",
                           os.path.join(workdir, "mel_cuda.csv"),
                           os.path.join(workdir, "mel_cpu.csv"))}
    rows = _read_csv(os.path.join(workdir, "binaural_cuda.csv"))
    # one file's battery alone: seconds per file, card against CPU
    pred, _ = load_wav(os.path.join(gen_dir, vids[0]
                                    + "_binaural_generated.wav"))
    gt, _ = load_wav(os.path.join(gt_dir, vids[0] + ".wav"))
    pair = [a[:, TRIM_SAMPLES: a.shape[1] - TRIM_SAMPLES] for a in (pred, gt)]
    per_file_s = {}
    for dev, iters in (("cuda", 3), ("cpu", 1)):
        p, g = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in pair)
        secs = [_timed(lambda: evaluate_binaural_pair(
            p, g, SR, True, True))[1] for _ in range(1 + iters)]
        per_file_s[dev] = statistics.mean(secs[1:])  # the first warms up
    out["evaluation"] = {
        "files": len(rows) - 1, "columns": rows[0],
        "card_vs_cpu": battery, "battery_s_per_file": per_file_s,
        "battery_timing": "mean synchronised wall of evaluate_binaural_pair "
                          "(BSS and PESQ) on one trimmed 10 s pair: card 3 "
                          "calls, CPU 1, after a warm-up",
        "worst_card_vs_cpu": worst,
        "tolerances": {"relative": EVAL_REL, **EVAL_TOLS},
        "first_row": dict(zip(rows[0], rows[1]))}
    out["device_memory"] = device_memory_stats()
    out["launches"] = {k: {n: v for n, v in c.items() if v}
                       for k, c in by_path.items()}
    emit(out)
    torch.cuda.empty_cache()
    return {"by_path": by_path, "ckpt": ck, **out}


def phase_tf32_defaults(world: str, workdir: str, ck: str) -> dict:
    """Fault C4's check on the card.  A user's process starts with
    PyTorch's TF32 defaults (cuDNN convolutions in TF32, cuBLAS matmuls in
    float32); this script runs with TF32 off.  One ``test_realbinaural``
    clip (the float32 UNet and ``ClipPos2D`` from ``ck``) and one
    ``inference_e2e`` file (the float32 generator, on that clip's TF32-off
    mels in both runs) are run under each setting inside
    ``deterministic_algorithms()`` and held bit for bit: the float32 entry
    points pin float32 themselves (``core/precision.py``).  The largest
    deviation is reported either way."""
    from diffbinaural_tpu_torch.cli import inference_e2e, test_realbinaural

    vid = f"vid{WORLD_TRAIN:03d}"
    split = _split(os.path.join(workdir, "tf32_one.csv"), [vid])
    runs = {}
    for label, cudnn_tf32 in (("tf32_off", False), ("pytorch_defaults", True)):
        root = os.path.join(workdir, f"tf32_{label}")
        mels = {s: os.path.join(root, s) for s in ("left", "right")}
        voc_in = runs["tf32_off"]["mels"] if runs else mels
        torch.backends.cudnn.allow_tf32 = cudnn_tf32  # PyTorch's default: on
        torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
        try:
            with deterministic_algorithms():
                t0 = time.perf_counter()
                _cli_quietly(test_realbinaural.main, [
                    "--data_root", world, "--list_test", split, "--ckpt", ck,
                    "--id", "eval", "--arch_frame", "clip_pos2d",
                    "--output_dir_left", mels["left"],
                    "--output_dir_right", mels["right"]])
                clip_s = time.perf_counter() - t0
                with captured_writes(inference_e2e) as writes:
                    inference_e2e.main([
                        "--input_mels_left_dir", voc_in["left"],
                        "--input_mels_right_dir", voc_in["right"],
                        "--checkpoint_file",
                        os.path.join(ck, "voc", "g_00000001"),
                        "--output_dir", os.path.join(root, "wav")])
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if len(writes) != 1:
            fail(f"tf32_defaults: inference_e2e wrote {len(writes)} wavs")
        runs[label] = {"mels": mels, "wav": writes[0]["wav"], "cli_s": clip_s,
                       "mel": np.stack([np.load(os.path.join(mels[s],
                                                             vid + ".npy"))
                                        for s in ("left", "right")])}
    off, on = runs["tf32_off"], runs["pytorch_defaults"]
    out = {"phase": "tf32_defaults", "clip": vid,
           "pytorch_defaults": "cudnn.allow_tf32 True, "
                               "cuda.matmul.allow_tf32 False",
           "test_realbinaural_mel_max_abs_dev":
               float(np.abs(on["mel"] - off["mel"]).max()),
           "mel_scale": float(np.abs(off["mel"]).max()),
           "inference_e2e_wav_max_abs_dev":
               float(np.abs(on["wav"] - off["wav"]).max()),
           "wav_scale": float(np.abs(off["wav"]).max()),
           "test_realbinaural_cli_s": {k: r["cli_s"] for k, r in runs.items()}}
    emit(out)
    if (out["test_realbinaural_mel_max_abs_dev"]
            or out["inference_e2e_wav_max_abs_dev"]):
        fail("tf32_defaults: the float32 CLIs' output moves with PyTorch's "
             "TF32 defaults")
    return out


def kernels_line(cases, counts, by_path) -> dict:
    """One entry per kernel, at its heaviest shape on its path (bfloat16,
    as both paths run it); ``launches`` from the path that gives the kernel
    its count, ``launches_by_path`` from every path that launched it."""
    pick = {
        "flash_sdpa": lambda c: c["shape"] == [8, 4, 6400, 32],
        "flash_sdpa_with_lse": lambda c: c["shape"] == [TRAIN_BATCH, 4, 6400, 32],
        "flash_sdpa_backward": lambda c: c["shape"] == [TRAIN_BATCH, 4, 6400, 32],
        "fused_alias_free_snake": lambda c: c["shape"] == [2, 768, 3444],
        "fused_snake_conv": lambda c: c.get("k") == 7 and c.get("dilation") == 5
        and c["shape"] == [2, 768, 3444],
        "fused_alias_free_snake_backward":
            lambda c: c["shape"] == [GAN_BATCH, 24, 16384],
        "fused_snake_conv_backward": lambda c: c.get("k") == 7
        and c.get("dilation") == 5 and c["shape"] == [GAN_BATCH, 768, 256],
        "snake_conv_dgrad": lambda c: c.get("k") == 7
        and c.get("dilation") == 5 and c["shape"] == [GAN_BATCH, 768, 256],
        "snake_conv_wgrad": lambda c: c.get("k") == 7
        and c.get("dilation") == 5 and c["shape"] == [GAN_BATCH, 768, 256],
    }
    rows = []
    for name, (source, replaces) in SOURCES.items():
        case = next(c for c in cases if c["kernel"] == name
                    and c["dtype"] == "bf16" and pick[name](c))
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": case["max_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "shape": case["shape"], "dtype": case["dtype"],
            "launches_by_path": {path: c[name] for path, c in by_path.items()
                                 if c.get(name)},
        })
    return {"kernels": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=int, default=0, metavar="STEPS",
                    help="also trace STEPS UNet calls, one vocoder pass, one "
                         "clip with each sampler and up to 3 steps of each "
                         "trainer (the live-visual one split into tower, "
                         "head and UNet) with torch.profiler")
    ap.add_argument("--fp32-paths-only", action="store_true",
                    help="run only the float32 CLI paths on the stage-1 "
                         "world: train_cli_stage1, eval_cli and "
                         "tf32_defaults (fault C4's check); a copy of this "
                         "script beside an older tree of the port times "
                         "that tree's paths and measures its deviation")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures on the card only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.fp32_paths_only:
        info = phase_device()
        with tempfile.TemporaryDirectory() as workdir:
            world = os.path.join(workdir, "world1")
            write_stage1_world(world, seed=61)
            phase_train_cli_stage1(world, workdir)
            ev = phase_eval_cli(world, workdir)
            phase_tf32_defaults(world, workdir, ev["ckpt"])
        print(info["nvidia_smi"], flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                     "count": info["count"]}})
        return

    t_start = time.time()
    from diffbinaural_tpu_torch import native

    native_prebuilt = native.library_path().exists()
    info = phase_device()
    phase_build()
    cases = phase_kernels()
    phase_main_path_check()
    main_out = phase_main_path(args.trace)
    with tempfile.TemporaryDirectory() as workdir:
        ck = phase_checkpoint_roundtrip(workdir)
        phase_dpm_check()
        phase_serve_cli(ck, workdir, args.trace)
        del ck
    torch.cuda.empty_cache()
    phase_grad_flow()
    phase_train_check()
    train_out = phase_train_path(args.trace)
    phase_visual_check()
    visual_out = phase_visual_train_path(args.trace)
    phase_visual_serve()
    phase_stage2_check()
    gan_out = phase_stage2_path(args.trace)
    with tempfile.TemporaryDirectory() as workdir:
        world1 = write_stage1_world(os.path.join(workdir, "world1"), seed=61)
        world2 = write_stage2_world(os.path.join(workdir, "world2"), seed=62)
        emit({"phase": "worlds", "stage1": world1,
              "stage2": {k: v for k, v in world2.items() if "/" not in str(v)}})
        phase_data_check(os.path.join(workdir, "world1"), workdir,
                         native_prebuilt)
        cli1 = phase_train_cli_stage1(os.path.join(workdir, "world1"), workdir)
        phase_mesh_check(workdir, cli1)
        phase_remat_check()
        cli2 = phase_train_cli_stage2(world2, workdir)
        k1_fp32 = check_k1_fp32_test_cli(
            torch.Generator(device="cuda").manual_seed(91))
        ev = phase_eval_cli(os.path.join(workdir, "world1"), workdir)
        phase_tf32_defaults(os.path.join(workdir, "world1"), workdir,
                            ev["ckpt"])
    emit({"phase": "train_cli_beside_the_paths",
          "stage1_cli_step_s": cli1["seconds_per_step"],
          "stage1_cli_loader_wait_s": cli1["loader_wait_s_per_step"],
          "stage1_direct_step_s_fp32": cli1["direct_step_s"],
          "visual_train_path_step_s_bf16_unet": visual_out["seconds_per_step"],
          "stage2_cli_step_s_b32_remat": cli2["seconds_per_step"],
          "stage2_cli_loader_wait_s": cli2["loader_wait_s_per_step"],
          "stage2_path_step_s_b16": gan_out["seconds_per_step"],
          "note": "same call; the CLI steps include the loader's wait, the "
                  "copy to the card and the loss read back"})
    # each kernel's count comes from the run of its own path
    counts = {k: main_out["launches"][k] for k in SERVING_KERNELS}
    counts.update({k: train_out["launches"][k] for k in TRAINING_KERNELS})
    counts.update({k: gan_out["launches"][k] for k in GAN_KERNELS})
    never = [k for k, v in counts.items() if v < 1]
    if never:
        fail(f"kernels never launched on their path: {never}")
    line = kernels_line(cases, counts, {
        "main_path": main_out["launches"], "train_path": train_out["launches"],
        "stage2_path": gan_out["launches"],
        "train_cli_stage1": cli1["launches"],
        "train_cli_stage2": cli2["launches"],
        **{f"eval_{k}": v for k, v in ev["by_path"].items()}})
    # the float32 attention kernels, as the test CLIs and the float32
    # stage-1 step run them, beside the bfloat16 rows
    fp32_keys = ("shape", "ms", "cuda_core_ms", "bound_ms",
                 "cuda_core_bound_ms", "library_ms", "max_err",
                 "bit_identical_repeat")
    rows = {r["name"]: r for r in line["kernels"]}
    rows["fused_snake_conv"]["fp32_inference_e2e"] = [
        {"source": "diffbinaural_tpu_torch/ops/csrc/snake_conv_f32.cu",
         **{k: c[k] for k in ("shape", "k", "dilation", "ms", "unfused_ms",
                              "cuda_core_ms", "kernel_ms", "bound_ms",
                              "bound_by", "cuda_core_bound_ms", "plain_ms",
                              "max_err", "err_of_scale",
                              "bit_identical_repeat")}}
        for c in cases if c["kernel"] == "fused_snake_conv"
        and c["dtype"] == "fp32" and c["shape"] == [K3_E2E[0], 768, K3_E2E[1]]]
    rows["fused_alias_free_snake"]["fp32_inference_e2e"] = [
        {k: c[k] for k in ("shape", "ms", "kernel_ms", "bound_ms", "bound_by",
                           "plain_ms", "max_err")}
        for c in cases if c["kernel"] == "fused_alias_free_snake"
        and c["dtype"] == "fp32" and c["shape"][0] == 1
        and tuple(c["shape"][1:]) in K2_E2E]
    rows["flash_sdpa"]["fp32"] = {k: k1_fp32[0][k] for k in fp32_keys}
    rows["flash_sdpa"]["fp32_test_cli"] = [{k: c[k] for k in fp32_keys}
                                           for c in k1_fp32]
    for name in ("flash_sdpa_with_lse", "flash_sdpa_backward"):
        case = next(c for c in cases if c["kernel"] == name
                    and c["dtype"] == "fp32"
                    and c["shape"] == [TRAIN_BATCH, 4, 6400, 32])
        rows[name]["fp32"] = {k: case[k] for k in fp32_keys}
    emit(line)
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
