"""Variants of K2b, the alias-free snake's backward, built beside the
shipped kernel and timed in turns on one card.

  * ``tiled``: the design K2b had before it was register-blocked — one block
    per 512-sample tile of a row, x and dz staged in shared memory, exact
    ``sincosf``, a block reduction for d alpha / d beta — kept as the
    yardstick of the shipped kernel (``csrc_variants/
    alias_free_act_bwd_tiled.cu``; the port never calls it);
  * the shipped kernel (runs of 8 dx outputs per thread, registers capped
    so that four blocks of 256 threads share an SM) with runs of 8, 16 or
    32 and no cap (two blocks per SM), or runs of 16 capped for three.

Every line a variant replaces must still be in the shipped source
(``tests/test_torch_snake_conv_tiling.py`` checks that on the CPU).  On a
machine with a card and ``nvcc``:

    python3 -m diffbinaural_tpu_torch.ops.alias_free_act_variants [--rounds 3]

builds every variant (one ``nvcc`` each, all started together, under
``diffbinaural_tpu_torch/build/variants_afb/``) and prints one JSON line per
stage-2 shape: each build's kernel time from ``torch.profiler`` over 20
back-to-back launches (bfloat16), the median over the rounds, the builds
taking turns in reversed order every other round.  ``chip_smoke.py`` times
``tiled`` beside the shipped kernel through :func:`backward`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from . import _build
from .alias_free_act import _chain_logscale, _effective, aligned

SHIPPED = "alias_free_act_bwd.cu"
TILED_SOURCE = Path(__file__).resolve().parent / "csrc_variants" / \
    "alias_free_act_bwd_tiled.cu"
TILE = 512  # samples per block of the tiled kernel

# variant -> dx outputs per thread (None: the tiled kernel's tiles),
# [(line, replacement)]
CAP = "__global__ void __launch_bounds__(AFB_THREADS, 4)"
VARIANTS = {
    "tiled": (None, []),
    "runs_of_8_two_blocks": (8, [
        (CAP, "__global__ void __launch_bounds__(AFB_THREADS)")]),
    "runs_of_16_two_blocks": (16, [
        ("constexpr int AFB_RUN = 8;", "constexpr int AFB_RUN = 16;"),
        (CAP, "__global__ void __launch_bounds__(AFB_THREADS)")]),
    "runs_of_16_three_blocks": (16, [
        ("constexpr int AFB_RUN = 8;", "constexpr int AFB_RUN = 16;"),
        (CAP, "__global__ void __launch_bounds__(AFB_THREADS, 3)")]),
    "runs_of_32_two_blocks": (32, [
        ("constexpr int AFB_RUN = 8;", "constexpr int AFB_RUN = 32;"),
        (CAP, "__global__ void __launch_bounds__(AFB_THREADS)")]),
}
STAGE2_SHAPES = [(16, 768, 256), (16, 384, 1024), (16, 192, 2048),
                 (16, 96, 4096), (16, 48, 8192), (16, 24, 16384)]


def source(name: str) -> str:
    """The CUDA source of variant ``name``; raises if a line it replaces is
    no longer in the shipped kernel."""
    if name == "tiled":
        return TILED_SOURCE.read_text()
    text = (_build.CSRC / SHIPPED).read_text()
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise ValueError(f"{name}: {SHIPPED} no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def start(names) -> dict:
    """Start one nvcc per variant, all at once; {name: (Popen, library)}."""
    _build.write_taps_header()
    root = _build.BUILD_DIR / "variants_afb"
    shutil.rmtree(root, ignore_errors=True)
    started = {}
    for name in names:
        src_dir = root / name
        src_dir.mkdir(parents=True)
        src = src_dir / SHIPPED
        src.write_text(source(name))
        out = src_dir / "libvariant.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-I", str(_build.BUILD_DIR), "-o", str(out), str(src)]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out)
    return started


def finish(started) -> dict:
    """Wait for :func:`start`'s compiles; {name: loaded CDLL}."""
    loaded = {}
    argtypes = _build.KERNELS["alias_free_act_bwd"][1]["afa_snake_backward"]
    for name, (proc, out) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for K2b variant {name}:\n{log}")
        cdll = ctypes.CDLL(str(out))
        cdll.afa_snake_backward.argtypes = argtypes
        cdll.afa_snake_backward.restype = ctypes.c_int
        loaded[name] = cdll
    return loaded


def backward(cdll, name: str, x, dz, alpha, beta, logscale: bool = True):
    """``fused_alias_free_snake_backward`` through variant ``name``'s
    library: the same arguments and results."""
    a, inv_b = _effective(alpha, beta, logscale)
    b, c, t = x.shape
    x, dz = aligned(x), aligned(dz)
    run = VARIANTS[name][0]
    if run is None:  # one partial per (batch, tile, channel)
        n = -(-t // TILE)
        part = torch.empty((2, b, n, c), dtype=torch.float32, device=x.device)
        dims = (0, 1)
    else:            # slots per (channel, batch, warp)
        n = -(-(-(-t // run)) // 32) + 1  # ceil(ceil(T / run) / 32) + 1
        part = torch.zeros((2, c, b, n), dtype=torch.float32, device=x.device)
        dims = (1, 2)
    dx = torch.empty_like(x)
    code = cdll.afa_snake_backward(
        x.data_ptr(), dz.data_ptr(), a.data_ptr(), inv_b.data_ptr(),
        dx.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), b, c, t, n,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(f"K2b variant {name}", code)
    da, db = _chain_logscale(part[0].sum(dim=dims), part[1].sum(dim=dims),
                             alpha, beta, logscale)
    return dx, da, db


def _kernel_ms(fn, calls: int = 20) -> float:
    """Device time per call of K2b alone, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "afa_snake_bwd" in e.key) / 1e3 / calls


def main() -> None:
    from .alias_free_act import fused_alias_free_snake_backward

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    libs = finish(start(VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for shape in STAGE2_SHAPES:
        x, dz = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        alpha, beta = (0.3 * torch.randn(shape[1], generator=gen,
                                         device="cuda") for _ in range(2))
        fns = {"shipped": lambda: fused_alias_free_snake_backward(
            x, dz, alpha, beta, True)}
        for name, lib in libs.items():
            fns[name] = (lambda lib=lib, name=name: backward(
                lib, name, x, dz, alpha, beta, True))
        times = {n: [] for n in fns}
        order = list(fns)
        for r in range(args.rounds):
            for n in (order if r % 2 == 0 else order[::-1]):
                times[n].append(_kernel_ms(fns[n]))
        print(json.dumps({"kernel": "fused_alias_free_snake_backward",
                          "shape": list(shape), "dtype": "bf16", "gpu": smi,
                          "kernel_ms": {n: statistics.median(v)
                                        for n, v in times.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
