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
  * stage-1 training — one step's loss and every parameter's gradient
    through the kernels against the same through the plain versions
    (float32, batch 2), then optimiser steps in bfloat16 at batch 16 on a
    batch made by the port's mel frontend from a synthetic stereo signal;
  * stage-2 GAN training at the production configuration
    (``configs/bigvgan_binaural_22khz_80band_256x.json``: the full-width
    generator, MPD and sub-band CQTD) — one D+G step through the kernels
    against the same through the plain versions (float32, batch 2), then
    optimiser steps with a bfloat16 generator at batch 16 x 16384 samples.

Each path's launch counts are set to 0 before it and checked after it.
Every phase prints one JSON line; any failure exits non-zero.  There is no
CPU fallback: without a CUDA device the script fails before printing a
result.

    python3 chip_smoke.py --trace 10

also traces 10 UNet calls, one vocoder pass, 3 stage-1 and 3 stage-2 train
steps with ``torch.profiler`` and prints, for each, the wall time, the summed device
time, the device's busy share and the ten kernels with the most device time.

Float32 comparisons run with TF32 switched off for both matmuls and cuDNN
convolutions, so the plain versions are true float32 references.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

# Published dense peaks of one H100 SXM (NVIDIA data sheet); a card whose
# power limit is below 700 W runs under them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

CLIP_SECONDS, SR, HOP, WINDOW, UNET_BATCH, DDIM_STEPS = 10.0, 22050, 256, 80, 8, 25
BF16_UNET_TOL = 5e-2  # of the output's scale, see phase_main_path_check
TRAIN_BATCH, TRAIN_STEPS = 16, 5
ATTN_PER_STEP = 4  # Attention layers with n >= 1024: two at 6400, two at 1600
GAN_CONFIG = "configs/bigvgan_binaural_22khz_80band_256x.json"
GAN_BATCH, GAN_SEGMENT, GAN_STEPS = 16, 16384, 5
# a generator pass: 109 anti-aliased activations, 12 of them (C = 768,
# k <= 7) fused into the next convolution; each K3b recomputes the
# activation with K2 and ends in K2b
ACT_PER_PASS, FUSED_PER_PASS = 97, 12


def launches(**nonzero) -> dict:
    """Launch counts of every wrapper, 0 where not named."""
    from diffbinaural_tpu_torch import ops

    return {name: nonzero.get(name, 0) for name in ops.WRAPPERS}


# which path gives a kernel its launch count in the `kernels` line
SERVING_KERNELS = ("flash_sdpa", "fused_alias_free_snake", "fused_snake_conv")
TRAINING_KERNELS = ("flash_sdpa_with_lse", "flash_sdpa_backward")
GAN_KERNELS = ("fused_alias_free_snake_backward", "fused_snake_conv_backward")
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
    # K3b: K2 + the convolution's gradients + K2b (no kernel file of its own,
    # as the TPU code has no pallas_call of its own there)
    "fused_snake_conv_backward": (
        "diffbinaural_tpu_torch/ops/snake_conv.py",
        "diffbinaural_tpu/ops/snake_conv.py:204"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Median over ``iters`` single calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from diffbinaural_tpu_torch.ops import _build

    nvcc_out = subprocess.run([_build._nvcc(), "--version"],
                              capture_output=True, text=True, check=True).stdout
    nvcc = next((ln.strip() for ln in nvcc_out.splitlines() if "release" in ln),
                nvcc_out.strip())
    info = {"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    emit(info)
    return info


def phase_build() -> None:
    from diffbinaural_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build_all(verbose=True)
    for name in _build.KERNELS:
        _build.load(name)
    ptxas = {name: [ln for ln in log.splitlines() if "registers" in ln
                    or "spill" in ln][:8] for name, log in logs.items()}
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
                    "rms_tol": rms_tol}
            if shape[2] >= 1600:
                b, h, n, d = shape
                case["ms"] = time_ms(lambda: flash_sdpa(q, k, v, scale))
                case["plain_ms"] = time_ms(lambda: sdpa_plain(q, k, v, scale),
                                           warmup=1, iters=10)
                case["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
                flops = 4.0 * b * h * n * n * d
                nbytes = 4.0 * b * h * n * d * q.element_size()
                _bound(case, flops, nbytes, dt_name(dtype))
            del got, want
            results.append(case)


def _bound(case, flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    case["bound_ms"] = max(t_ops, t_bytes)
    case["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"


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
                   "lse_tol": lse_tol}
            bwd = {"kernel": "flash_sdpa_backward", **common,
                   "max_err": bwd_err, "max_err_of_output_scale": bwd_share,
                   "rms_err_of_output_rms": bwd_rms}
            if n >= 1600:
                iters = 5 if n > 1600 else 10
                fwd["ms"] = time_ms(
                    lambda: flash_sdpa_with_lse(q, k, v, scale), iters=iters)
                bwd["ms"] = time_ms(
                    lambda: flash_sdpa_backward(q, k, v, o, lse, do, scale),
                    iters=iters)
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
                # forward: q, k, v read, o and one float32 lse per row written
                _bound(fwd, 4.0 * rows * n * d, rows * (4 * d * es + 4), name)
                # backward: five products at the least; q, k, v, o, do and
                # lse read, dq, dk, dv written.  The two kernels recompute s
                # and dp, so they do 14 N^2 D where 10 are needed.
                _bound(bwd, 10.0 * rows * n * d, rows * (8 * d * es + 4), name)
                bwd["flop_done_over_flop_needed"] = 1.4
            results += [fwd, bwd]
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()


K2_STAGES = [(768, 3444), (384, 13776), (192, 27552), (96, 55104),
             (48, 110208), (24, 220416)]
GAN_STAGES = [(768, 256), (384, 1024), (192, 2048), (96, 4096), (48, 8192),
              (24, 16384)]  # the stage-2 step's six (C, T) at batch 16
# per sample: two up-FIR phases (6 mul + 5 add + gain), two snakes (3 mul,
# sine, add), one 12-tap down-FIR (12 mul + 11 add); the sine counts as one
K2_OPS_PER_SAMPLE = 2 * 12 + 2 * 5 + 23


def check_k2(gen, results):
    """fused_alias_free_snake vs its plain version, all samples.  float32:
    1e-5 (same float32 arithmetic, other summation order and another sine);
    bfloat16: both round one float32 result to bfloat16 — 8e-3 of the
    output's scale (two bfloat16 steps).  The serving shapes are timed; the
    stage-2 shapes (T = 256 is shorter than one tile) and a ragged clip are
    compared."""
    from diffbinaural_tpu_torch.ops import (alias_free_snake_plain,
                                            fused_alias_free_snake)

    shapes = ([(2, c, t) for c, t in K2_STAGES]
              + [(GAN_BATCH, c, t) for c, t in GAN_STAGES] + [(2, 48, 1001)])
    for b, c, t in shapes:
        for dtype, tol, rel in ((torch.float32, 1e-5, False),
                                (torch.bfloat16, 8e-3, True)):
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
            if (c, t) in K2_STAGES:
                case["ms"] = time_ms(
                    lambda: fused_alias_free_snake(x, alpha, beta, True))
                case["plain_ms"] = time_ms(
                    lambda: alias_free_snake_plain(x, alpha, beta, True))
                case["library_ms"] = None
                n = float(b * c * t)
                _bound(case, K2_OPS_PER_SAMPLE * n,
                       2 * n * x.element_size() + 8 * c, "fp32")
            del got, want
            results.append(case)


def check_k3(gen, results):
    """fused_snake_conv vs its plain version (plain activation +
    ``F.conv1d``).  float32: 2e-4 of the output's scale (sums of 768*k terms
    in another order); bfloat16: 2e-2 of the output's scale (the plain
    version rounds the activation to bfloat16 before the convolution, the
    kernel keeps it in float32).  The serving shapes are timed; the stage-2
    shapes and a 40-sample clip are compared."""
    from diffbinaural_tpu_torch.ops import fused_snake_conv, snake_conv_plain

    c = 768
    cases = [(b, t, k, d) for b, t in ((2, 3444), (GAN_BATCH, 256))
             for k in (3, 7) for d in (1, 3, 5)]
    cases.append((1, 40, 7, 5))  # one tile that crosses both clip edges
    for b, t, k, d in cases:
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
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
                    "tol": tol, "tol_relative_to_output_scale": True}
            if t == 3444:
                case["ms"] = time_ms(
                    lambda: fused_snake_conv(x, alpha, beta, w, bias, d, True))
                case["plain_ms"] = time_ms(
                    lambda: snake_conv_plain(x, alpha, beta, w, bias, d, True))
                case["library_ms"] = None
                flops = 2.0 * b * t * k * c * c + K2_OPS_PER_SAMPLE * b * c * t
                nbytes = (2.0 * b * c * t + k * c * c) * x.element_size() + 12 * c
                _bound(case, flops, nbytes, dt_name(dtype))
            del got, want
            results.append(case)


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
    The six stage-2 shapes are timed; ragged shapes — T = 7 (shorter than
    the filters' reach), 40 (one tile holding both edges), 1001 (several
    tiles) at narrow and wide C — are compared."""
    from diffbinaural_tpu_torch.ops import (alias_free_snake_backward_plain,
                                            fused_alias_free_snake_backward)

    ragged = [(2, c, t) for c in (24, 768) for t in (7, 40, 1001)]
    for shape in [(GAN_BATCH, c, t) for c, t in GAN_STAGES] + ragged:
        b, c, t = shape
        for dtype in (torch.float32, torch.bfloat16):
            x, dz = rand(gen, shape, dtype), rand(gen, shape, dtype)
            alpha = rand(gen, (c,), torch.float32, 0.3)
            beta = rand(gen, (c,), torch.float32, 0.3)
            got = fused_alias_free_snake_backward(x, dz, alpha, beta, True)
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
                case["ms"] = time_ms(lambda: fused_alias_free_snake_backward(
                    x, dz, alpha, beta, True))
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


def check_k3b(gen, results):
    """fused_snake_conv_backward (K3b: K2, the convolution's gradients, K2b)
    vs its plain version (autograd through ``snake_conv_plain``): dx,
    d alpha, d beta, dW, db.  float32: 1e-4 of each gradient's scale (sums
    of 768*k or B*T terms in another order); bfloat16: 3e-2 (the plain
    version rounds the activation to bfloat16 before the convolution and its
    gradients; dW sums B*T = 4096 bfloat16 products).  The stage-2 shapes
    are timed; a 40-sample clip (one tile, both edges) is compared."""
    from diffbinaural_tpu_torch.ops import (fused_snake_conv_backward,
                                            snake_conv_backward_plain)

    c = 768
    cases = [(GAN_BATCH, 256, k, d) for k in (3, 7) for d in (1, 3, 5)]
    cases.append((2, 40, 7, 5))
    labels = ("dx", "dalpha", "dbeta", "dW", "db")
    for b, t, k, d in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            x, dy = rand(gen, (b, c, t), dtype), rand(gen, (b, c, t), dtype)
            alpha = rand(gen, (c,), torch.float32, 0.3)
            beta = rand(gen, (c,), torch.float32, 0.3)
            w = rand(gen, (c, c, k), dtype, 0.02)
            bias = rand(gen, (c,), torch.float32, 0.1)
            args = (x, dy, alpha, beta, w, bias, d, True)
            got = fused_snake_conv_backward(*args)
            want = snake_conv_backward_plain(*args)
            worst = _grad_case("fused_snake_conv_backward",
                               (b, c, t, k, d, dt_name(dtype)), got, want,
                               labels, tol)
            case = {"kernel": "fused_snake_conv_backward", "shape": [b, c, t],
                    "k": k, "dilation": d, "dtype": dt_name(dtype),
                    "max_err": max((g.float() - v.float()).abs().max().item()
                                   for g, v in zip(got, want)),
                    "worst_err_of_scale": worst, "tol_of_scale": tol}
            if b == GAN_BATCH:
                case["ms"] = time_ms(lambda: fused_snake_conv_backward(*args))
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
            del got, want
            results.append(case)


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


def phase_train_check() -> None:
    """One stage-1 train step at full width in float32 (TF32 off), batch 2,
    one injected (t, noise, drop): loss, pre-clip gradient norm and every
    parameter's gradient through the kernels against the same through the
    plain versions.  The step runs with ``lr_scale`` 0 and no norm clip, so
    the parameters stay and the gradients are left as autograd made them."""
    from diffbinaural_tpu_torch import ops
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

    ops.reset_launch_counts()
    loss_k, norm_k, grads_k = run()
    counts = ops.launch_counts()
    with plain_versions():
        loss_p, norm_p, grads_p = run()
    if ops.launch_counts() != counts:
        fail("train_check: plain_versions() launched a kernel")
    expected = launches(flash_sdpa_with_lse=ATTN_PER_STEP,
                        flash_sdpa_backward=ATTN_PER_STEP)
    if counts != expected:
        fail(f"train_check: launch counts {counts} != {expected}")
    if not (np.isfinite(loss_k) and np.isfinite(norm_k)):
        fail(f"train_check: loss {loss_k}, grad_norm {norm_k}")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        fail(f"train_check: loss {loss_k} vs {loss_p} through the plain versions")
    if abs(norm_k - norm_p) > 1e-4 * norm_p:
        fail(f"train_check: grad_norm {norm_k} vs {norm_p}")
    top = max(g.abs().max().item() for g in grads_p.values())
    worst, worst_name, n_zero = 0.0, "", 0
    for name, want in grads_p.items():
        got = grads_k[name]
        if not torch.isfinite(got).all():
            fail(f"train_check: non-finite gradient of {name}")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if err > TRAIN_CHECK_TOL * scale + TRAIN_CHECK_FLOOR * top:
            fail(f"train_check: gradient of {name}: max error {err:.3e} at "
                 f"scale {scale:.3e} (largest gradient {top:.3e})")
        n_zero += scale <= 1e-5 * top
        if scale > 1e-5 * top and err / scale > worst:
            worst, worst_name = err / scale, name
    emit({"phase": "train_check", "dtype": "fp32", "tf32": False, "batch": b,
          "loss": loss_k, "loss_plain": loss_p, "loss_rel_diff":
              abs(loss_k - loss_p) / abs(loss_p), "loss_tol": 1e-5,
          "grad_norm": norm_k, "grad_norm_plain": norm_p,
          "parameters": len(grads_p),
          "worst_grad_err_of_own_scale": worst, "worst_grad": worst_name,
          "grad_tol_of_own_scale": TRAIN_CHECK_TOL,
          "grad_floor_of_largest_scale": TRAIN_CHECK_FLOOR,
          "largest_grad_scale": top,
          "grads_below_1e-5_of_largest": int(n_zero), "launches": counts})
    del unet, state, grads_k, grads_p
    torch.cuda.empty_cache()


def phase_train_path(trace_steps: int = 0) -> dict:
    """Optimiser steps of the stage-1 trainer at full width in bfloat16,
    batch 16, through the entry point a user calls
    (``make_stage1_train_step``): one warm-up step with draws from the
    generator, then ``TRAIN_STEPS`` timed steps with one fixed (t, noise,
    drop), so that the losses are those of one objective and must fall."""
    from diffbinaural_tpu_torch import ops
    from diffbinaural_tpu_torch.train import (TrainingStabilizer,
                                              make_stage1_train_step)

    b = TRAIN_BATCH
    unet = build_unet(torch.bfloat16, seed=0)
    init_fn, step_fn = make_stage1_train_step(unet)
    state = init_fn()
    batch = synthetic_batch(b, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(8)
    draws = dict(
        t=torch.randint(0, 1000, (b,), generator=gen, device="cuda"),
        noise=torch.randn((b, 2, WINDOW, WINDOW), generator=gen, device="cuda"),
        drop=torch.rand((b,), generator=gen, device="cuda") < 0.1)
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
        fail(f"train_path: batch {b} does not fit the card's memory: {exc}")
    counts = ops.launch_counts()
    memory = stabilizer.memory_report()

    if state.step != TRAIN_STEPS + 1:
        fail(f"train_path: state.step {state.step}")
    if not all(np.isfinite(x) for x in losses + norms):
        fail(f"train_path: losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        fail(f"train_path: the loss did not fall: {losses}")
    expected = launches(flash_sdpa_with_lse=ATTN_PER_STEP * TRAIN_STEPS,
                        flash_sdpa_backward=ATTN_PER_STEP * TRAIN_STEPS)
    if counts != expected:
        fail(f"train_path: launch counts {counts} != {expected}")
    if not all(torch.isfinite(p).all() for p in unet.parameters()):
        fail("train_path: a parameter is not finite after the steps")
    out = {"phase": "train_path", "dtype": "bf16", "batch": b,
           "steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
           "seconds_per_step": statistics.median(seconds),
           "seconds_per_step_runs": seconds,
           "sync": "synchronize + host clock around each step, median",
           "max_memory_allocated_bytes": memory["peak_allocated_bytes"],
           "launches": counts,
           "launches_per_step": {k: v // TRAIN_STEPS for k, v in counts.items()}}
    emit(out)
    if trace_steps > 0:
        emit(trace("train_step", lambda: step_fn(state, batch, **draws),
                   min(trace_steps, 3)))
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


def make_gan_step(h, gen, mpd, mrd):
    """``make_stage2_train_step`` wired as the JAX package's GAN trainer
    wires it from the config (``cli/gan_common.py``)."""
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
        silence_threshold_db=h.get("silence_threshold_db", -50.0))


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


def gan_launches(steps: int) -> dict:
    per_step = dict(fused_alias_free_snake=ACT_PER_PASS + FUSED_PER_PASS,
                    fused_alias_free_snake_backward=ACT_PER_PASS + FUSED_PER_PASS,
                    fused_snake_conv=FUSED_PER_PASS,
                    fused_snake_conv_backward=FUSED_PER_PASS)
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
    if counts != gan_launches(1):
        fail(f"stage2_check: launch counts {counts} != {gan_launches(1)}")
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
    if counts != gan_launches(GAN_STEPS):
        fail(f"stage2_path: launch counts {counts} != "
             f"{gan_launches(GAN_STEPS)}")
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


def kernels_line(cases, counts) -> dict:
    """One entry per kernel, at its heaviest shape on its path (bfloat16,
    as both paths run it)."""
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
        })
    return {"kernels": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=int, default=0, metavar="STEPS",
                    help="also trace STEPS UNet calls, one vocoder pass and "
                         "up to 3 steps of each trainer with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures on the card only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.time()
    info = phase_device()
    phase_build()
    cases = phase_kernels()
    phase_main_path_check()
    main_out = phase_main_path(args.trace)
    phase_grad_flow()
    phase_train_check()
    train_out = phase_train_path(args.trace)
    phase_stage2_check()
    gan_out = phase_stage2_path(args.trace)
    # each kernel's count comes from the run of its own path
    counts = {k: main_out["launches"][k] for k in SERVING_KERNELS}
    counts.update({k: train_out["launches"][k] for k in TRAINING_KERNELS})
    counts.update({k: gan_out["launches"][k] for k in GAN_KERNELS})
    never = [k for k, v in counts.items() if v < 1]
    if never:
        fail(f"kernels never launched on their path: {never}")
    emit(kernels_line(cases, counts))
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
