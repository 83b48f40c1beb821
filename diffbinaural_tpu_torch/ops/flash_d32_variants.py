"""Variants of the attention kernels, built side by side and timed in turns
on one card: the measurement behind the shipped kernels' tile sizes,
warpgroup counts, ring depth, turn-taking and rescale.

Each variant is the shipped source with a few lines replaced.  bfloat16: two
consumer warpgroups instead of three, 64-key tiles instead of 128, two ring
stages instead of four, no turns between the consumer warpgroups, or the
output rescaled at every tile instead of only where a row max of the warp
moved.  float32 (split-TF32 on ``wgmma``): two consumer warpgroups of the
forward instead of three, two ring stages instead of four, no turns.  Every
line a variant replaces must still be in the sources, so a variant that no
longer applies fails before anything is built
(``tests/test_torch_flash_d32_tiling.py`` checks that on the CPU).  Beside
them, ``cuda_core`` is the float32 kernels' earlier design
(``csrc_variants/flash_d32_cuda_core.cu``: one thread per row on the CUDA
cores), the float32 kernels' yardstick: it exports the float32 libraries'
functions, and ``_build.in_place(F32_LIBS, ...)`` puts it in their place,
so that the wrappers time it (``chip_smoke.py``'s ``cuda_core_ms``).  On a machine
with a card and ``nvcc``:

    python3 -m diffbinaural_tpu_torch.ops.flash_d32_variants [--rounds 12]

builds the shipped sources, every variant and ``cuda_core`` (one ``nvcc``
each, all started together, under ``diffbinaural_tpu_torch/build/variants/``),
then prints one JSON line per kernel and shape: each build's ms per launch as
quartiles over the rounds (CUDA events around 5 back-to-back launches; the
builds take turns, in reversed order every other round), the largest
difference of its outputs from the shipped build's (0.0: the same bits),
and ptxas's lines on spills or serialised ``wgmma``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from . import _build

HEADER, FWD_SRC = "flash_hopper.cuh", "flash_d32.cu"
F32_HEADER, F32_FWD_SRC = "flash_f32_hopper.cuh", "flash_d32_f32.cu"
CUDA_CORE_SOURCE = (Path(__file__).resolve().parent / "csrc_variants"
                    / "flash_d32_cuda_core.cu")
F32_LIBS = ("flash_d32_f32", "flash_d32_f32_bwd")

# variant -> (library it rebuilds, [(file, line(s) replaced, replacement)])
VARIANTS = {
    "fwd_two_warpgroups": ("flash_d32", [
        (HEADER, "constexpr int FWD_CONSUMERS = 3;",
         "constexpr int FWD_CONSUMERS = 2;"),
        (HEADER, "constexpr int FWD_CONSUMER_REGS = 160;",
         "constexpr int FWD_CONSUMER_REGS = 232;"),
    ]),
    "fwd_64_key_tiles": ("flash_d32", [
        (HEADER, "constexpr int FWD_BLOCK_N = 128;",
         "constexpr int FWD_BLOCK_N = 64;"),
        (FWD_SRC, "wgmma_m64n128k16_ss_first(s, q_desc, k_desc);",
         "wgmma_m64n64k16_ss_first(s, q_desc, k_desc);"),
        (FWD_SRC, "wgmma_m64n128k16_ss(s, q_desc + DESC_K16_KMAJOR",
         "wgmma_m64n64k16_ss(s, q_desc + DESC_K16_KMAJOR"),
    ]),
    "fwd_two_stages": ("flash_d32", [
        (HEADER, "constexpr int FWD_STAGES = 4;", "constexpr int FWD_STAGES = 2;"),
    ]),
    "fwd_no_turns": ("flash_d32", [
        (FWD_SRC, "named_sync(", "(void)("),
        (FWD_SRC, "named_arrive(", "(void)("),
    ]),
    "fwd_rescale_always": ("flash_d32", [
        (FWD_SRC,
         "if (__any_sync(0xffffffffu, c_lo != 1.0f || c_hi != 1.0f)) {",
         "{"),
    ]),
    "bwd_two_warpgroups": ("flash_d32_bwd", [
        (HEADER, "constexpr int BWD_CONSUMERS = 3;",
         "constexpr int BWD_CONSUMERS = 2;"),
        (HEADER, "constexpr int BWD_CONSUMER_REGS = 160;",
         "constexpr int BWD_CONSUMER_REGS = 232;"),
    ]),
    "f32_fwd_two_warpgroups": ("flash_d32_f32", [
        (F32_HEADER, "constexpr int F32_FWD_CONSUMERS = 3;",
         "constexpr int F32_FWD_CONSUMERS = 2;"),
        (F32_HEADER, "constexpr int F32_FWD_CONSUMER_REGS = 160;",
         "constexpr int F32_FWD_CONSUMER_REGS = 232;"),
    ]),
    "f32_fwd_two_stages": ("flash_d32_f32", [
        (F32_HEADER, "constexpr int F32_FWD_STAGES = 4;",
         "constexpr int F32_FWD_STAGES = 2;"),
    ]),
    "f32_fwd_no_turns": ("flash_d32_f32", [
        (F32_FWD_SRC, "named_sync(", "(void)("),
        (F32_FWD_SRC, "named_arrive(", "(void)("),
    ]),
}

FORWARD_SHAPES = [(8, 4, 6400), (8, 4, 1600), (16, 4, 6400)]
BACKWARD_SHAPES = [(16, 4, 6400), (16, 4, 1600)]
# float32: the test CLIs' K1 (21 windows), the stage-1 step's K1r and K1b
F32_FORWARD_SHAPES = [(21, 4, 6400), (21, 4, 1600), (16, 4, 6400)]


def patched_sources(name: str) -> dict[str, str]:
    """The text of every source file of ``csrc/`` with variant ``name``'s
    replacements made ("shipped": none); raises if a replaced line is no
    longer there."""
    texts = {p.name: p.read_text() for p in sorted(_build.CSRC.iterdir())}
    for file, old, new in VARIANTS.get(name, (None, []))[1]:
        if old not in texts[file]:
            raise ValueError(f"{name}: {file} no longer holds {old!r}")
        texts[file] = texts[file].replace(old, new)
    return texts


def _nvcc_cmd(src, out, include):
    return [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
            str(include), "-o", str(out), str(src)]


def _start_builds(names):
    """One nvcc per build, all started together: {(name, lib): (Popen, lib
    path)}; ``cuda_core`` builds its own source against the shipped
    headers."""
    root = _build.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    started = {}
    for name in names:
        src_dir = root / name
        src_dir.mkdir(parents=True)
        if name == "cuda_core":
            out = src_dir / "libcuda_core.so"
            started[(name, "cuda_core")] = (subprocess.Popen(
                _nvcc_cmd(CUDA_CORE_SOURCE, out, _build.CSRC),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                out)
            continue
        for file, text in patched_sources(name).items():
            (src_dir / file).write_text(text)
        libs = ([VARIANTS[name][0]] if name in VARIANTS
                else ["flash_d32", "flash_d32_bwd", *F32_LIBS])
        for lib in libs:
            out = src_dir / f"lib{lib}.so"
            cmd = _nvcc_cmd(src_dir / _build.KERNELS[lib][0], out, src_dir)
            started[(name, lib)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    return started


def _load(lib: str, path) -> ctypes.CDLL:
    cdll = ctypes.CDLL(str(path))
    if lib == "cuda_core":  # it stands in for both float32 libraries
        for name in F32_LIBS:
            _build.bind(cdll, name)
        return cdll
    return _build.bind(cdll, lib)


def start_cuda_core():
    """Start building the float32 yardstick alone; for :func:`finish`."""
    return _start_builds(["cuda_core"])


def finish(started) -> dict:
    """Wait for :func:`_start_builds`' compiles: ({(name, lib): CDLL},
    {name: ptxas lines on spills or serialised wgmma})."""
    loaded, warnings = {}, {}
    for (name, lib), (proc, path) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({lib}):\n{out}")
        loaded[(name, lib)] = _load(lib, path)
        warnings[name] = warnings.get(name, []) + [
            line.strip() for line in out.splitlines()
            if re.search(r"[1-9]\d* bytes spill|C75\d\d", line)]
    return loaded, warnings


def _time_in_turns(builds, call, rounds: int) -> dict[str, list[float]]:
    """ms per launch of ``call`` for each build: the quartiles over
    ``rounds`` turns.  In its turn a build's library is put in the wrapper's
    place and timed over 5 back-to-back launches between two CUDA events,
    after one warm-up."""
    times = {name: [] for name in builds}
    for r in range(rounds):
        order = list(builds) if r % 2 == 0 else list(reversed(builds))
        for name in order:
            lib, cdll = builds[name]
            with _build.in_place(lib, cdll):
                call()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    call()
                end.record()
                end.synchronize()
            times[name].append(start.elapsed_time(end) / 5)
    return {name: statistics.quantiles(t, n=4) for name, t in times.items()}


def _max_diff(builds, call) -> dict[str, float]:
    """Largest |difference| of each build's outputs from the shipped
    build's, on the same inputs."""
    outs = {}
    for name, (lib, cdll) in builds.items():
        with _build.in_place(lib, cdll):
            outs[name] = call()
    ref = outs["shipped"]
    return {name: max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(out, ref))
            for name, out in outs.items() if name != "shipped"}


def main() -> None:
    from .flash_d32 import (flash_sdpa, flash_sdpa_backward,
                            flash_sdpa_with_lse)

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=12)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_d32_variants: needs a CUDA card")

    started = _start_builds(["shipped", *VARIANTS, "cuda_core"])
    loaded, warnings = finish(started)
    cuda_core = loaded.pop(("cuda_core", "cuda_core"))
    for lib in F32_LIBS:  # the yardstick takes turns in both libraries
        loaded[("cuda_core", lib)] = cuda_core
    print(json.dumps({"ptxas_warnings": warnings}), flush=True)

    def builds_of(lib):
        return {name: (lib, cdll) for (name, l), cdll in loaded.items()
                if l == lib}

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    scale = 32 ** -0.5
    bf16, f32 = torch.bfloat16, torch.float32
    with torch.no_grad():
        for kernel, shapes, lib, dtype in (
                ("K1", FORWARD_SHAPES[:2], "flash_d32", bf16),
                ("K1r", FORWARD_SHAPES[2:], "flash_d32", bf16),
                ("K1b", BACKWARD_SHAPES, "flash_d32_bwd", bf16),
                ("K1", F32_FORWARD_SHAPES[:2], "flash_d32_f32", f32),
                ("K1r", F32_FORWARD_SHAPES[2:], "flash_d32_f32", f32),
                ("K1b", BACKWARD_SHAPES, "flash_d32_f32_bwd", f32)):
            builds = builds_of(lib)
            fwd_lib = "flash_d32" if dtype == bf16 else "flash_d32_f32"
            for b, h, n in shapes:
                q, k, v, do = (torch.randn((b, h, n, 32), generator=gen,
                                           device="cuda").to(dtype)
                               for _ in range(4))
                if kernel == "K1":
                    def call():
                        return (flash_sdpa(q, k, v, scale),)
                elif kernel == "K1r":
                    def call():
                        return flash_sdpa_with_lse(q, k, v, scale)
                else:  # the backward's inputs from the shipped forward
                    with _build.in_place(fwd_lib, loaded[("shipped", fwd_lib)]):
                        o, lse = flash_sdpa_with_lse(q, k, v, scale)

                    def call():
                        return flash_sdpa_backward(q, k, v, o, lse, do, scale)
                ms = _time_in_turns(builds, call, args.rounds)
                print(json.dumps({"kernel": kernel, "dtype": str(dtype),
                                  "shape": [b, h, n, 32],
                                  "ms_quartiles": ms, "max_diff_vs_shipped":
                                  _max_diff(builds, call)}), flush=True)
                del q, k, v, do
                torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
