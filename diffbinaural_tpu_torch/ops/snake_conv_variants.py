"""Variants of the vocoder's kernels, built side by side and timed in turns
on one card: the measurement behind the bfloat16 K3's split of time between
the activation and the product, its ring depth and its output-channel
block, behind K2's run length, and behind the dW kernel's tile and ring.

Each variant is the shipped source with a few lines replaced: K3 without
its activation or without its product (each leaves the other's time), with
two or three ring stages, with each stage refilled one step later (thread
0 then waits on the other warps one step less often), or with two
output-channel groups of 384 at every grid (the dz kernel, K3's block
without the activation, is timed beside the forward, and with its copy of dy
issuing 1 or 8 units' loads ahead of their stores instead of 24); K2 with runs of 8 or 32 outputs per thread, or 128-thread blocks; the
dW kernel with three ring stages, or with tiles of 64 input channels (one
consumer warpgroup); and the shipped dW kernel without its K split.
The float32 K3 (split-TF32 products on ``wgmma``) is timed with blocks of
192 output channels (shipped at C = 768) against 128, with chunks of 32
input channels against 64, with its activation's runs of 4 or 16 rows
against 8, with 4 ring stages against 8, without its activation, with one
set of A registers (each step waits for the one before: no spill, no
overlap), with the earlier epilogue (a pointer per output-channel group,
which spilled 32 bytes at 192 channels), and beside
``cuda_core``, its earlier design (``csrc_variants/snake_conv_cuda_core.cu``:
the first kernel, on the CUDA cores), which exports the float32 library's
function; ``_build.in_place`` puts it in that library's place, so
that the wrapper times it (``chip_smoke.py``'s ``cuda_core_ms``).
Every line a variant replaces must still be in the sources, so a variant
that no longer applies fails before anything is built
(``tests/test_torch_snake_conv_tiling.py`` checks that on the CPU).  On a
machine with a card and ``nvcc``:

    python3 -m diffbinaural_tpu_torch.ops.snake_conv_variants [--rounds 3]

builds the shipped sources and every variant (one ``nvcc`` each, all
started together, under ``diffbinaural_tpu_torch/build/variants_sc/``), then
prints ptxas's lines on spills of every build, and one JSON line per kernel
and shape: each build's kernel time from
``torch.profiler`` over 20 back-to-back launches, the median over the rounds
(the builds take turns, in reversed order every other round).  The variants
that drop work give wrong outputs by design; none is compared.
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

K3, K2, KW = "snake_conv.cu", "alias_free_act.cu", "snake_conv_wgrad.cu"
K3F = "snake_conv_f32.cu"
CUDA_CORE_SOURCE = (Path(__file__).resolve().parent / "csrc_variants"
                    / "snake_conv_cuda_core.cu")

# variant -> (library it rebuilds, [(file, line replaced, replacement)])
VARIANTS = {
    "k3_no_activation": ("snake_conv", [
        (K3, "  sch_activate<Cfg::WARPS>(", "  if (0) sch_activate<Cfg::WARPS>("),
    ]),
    "k3_no_product": ("snake_conv", [
        (K3, "  for (int s = 1; s < n_steps - 1; s += 2) {",
         "  for (int s = 1; s < 1; s += 2) {"),
        (K3, "  sch_next<N>(st, n_steps - 1, acc, a1, a0);",
         "  sch_next<N>(st, 1, acc, a1, a0);"),
    ]),
    "k3_two_stages": ("snake_conv", [
        (K3, "  if (p->stages > SCH_MAX_STAGES) p->stages = SCH_MAX_STAGES;",
         "  if (p->stages > 2) p->stages = 2;"),
    ]),
    "k3_three_stages": ("snake_conv", [
        (K3, "  if (p->stages > SCH_MAX_STAGES) p->stages = SCH_MAX_STAGES;",
         "  if (p->stages > 3) p->stages = 3;"),
    ]),
    "k3_refill_lag2": ("snake_conv", [
        (K3, "  if (threadIdx.x == 0) sch_load(st, s - 1 + st.stages);",
         "  if (threadIdx.x == 0 && s >= 2) sch_load(st, s - 2 + st.stages);"),
    ]),
    "dz_batch_1": ("snake_conv", [
        (K3, "constexpr int SCH_DY_BATCH = 24;", "constexpr int SCH_DY_BATCH = 1;"),
    ]),
    "dz_batch_8": ("snake_conv", [
        (K3, "constexpr int SCH_DY_BATCH = 24;", "constexpr int SCH_DY_BATCH = 8;"),
    ]),
    "k3_groups_of_384": ("snake_conv", [
        (K3, "  if (C % 768 == 0 && 2 * tiles * (C / 768) >= sms) return 768;",
         "  (void)tiles;"),
    ]),
    "k3f_blocks_of_128": ("snake_conv_f32", [
        (K3F, "static int scf_co_block(int C) { return C % 192 == 0 ? 192 : 128; }",
         "static int scf_co_block(int C) { return 128; }"),
    ]),
    "k3f_no_activation": ("snake_conv_f32", [
        (K3F, "    scf_activate(xb,", "    if (0) scf_activate(xb,"),
    ]),
    "k3f_chunks_of_32": ("snake_conv_f32", [
        (K3F, "constexpr int SCF_CH = 64; ", "constexpr int SCF_CH = 32; "),
    ]),
    "k3f_runs_of_4": ("snake_conv_f32", [
        (K3F, "constexpr int SCF_RUN = 8; ", "constexpr int SCF_RUN = 4; "),
    ]),
    "k3f_runs_of_16": ("snake_conv_f32", [
        (K3F, "constexpr int SCF_RUN = 8; ", "constexpr int SCF_RUN = 16; "),
    ]),
    "k3f_four_stages": ("snake_conv_f32", [
        (K3F, "  if (p->stages > SCF_MAX_STAGES) p->stages = SCF_MAX_STAGES;",
         "  if (p->stages > 4) p->stages = 4;"),
    ]),
    "k3f_one_a_set": ("snake_conv_f32", [
        (K3F, """    for (int r = 1; r < per_chunk - 1; r += 2) {
      scf_next<N>(st, s0 + r, r, acc, a1, a0);
      scf_next<N>(st, s0 + r + 1, r + 1, acc, a0, a1);
    }
    scf_next<N>(st, s0 + per_chunk - 1, per_chunk - 1, acc, a1, a0);
    wgmma_wait<0>();
    fence_regs<N / 2>(acc);
    fence_regs<8>(a1);""", """    for (int r = 1; r < per_chunk; ++r) {
      wgmma_wait<0>();
      fence_regs<8>(a0);
      scf_release(st, s0 + r - 1);
      scf_load_a(st, r, a0);
      scf_issue<N, false>(st, s0 + r, acc, a0);
    }
    wgmma_wait<0>();
    fence_regs<N / 2>(acc);
    fence_regs<8>(a0);"""),
    ]),
    "k3f_epilogue_indexed": ("snake_conv_f32", [
        (K3F, """  const float* bp = bias + grp * N + 2 * t4;
  float* r0 = out + ((size_t)b * C + grp * N + 2 * t4) * T_len + t_row;
#pragma unroll
  for (int i = 0; i < N / 8; ++i, r0 += 8 * (size_t)T_len) {
    const float b0 = bp[8 * i], b1 = bp[8 * i + 1];
    if (t_row < T_len) {
      r0[0] = sum[4 * i] + b0;
      r0[T_len] = sum[4 * i + 1] + b1;
    }
    if (t_row + 8 < T_len) {
      r0[8] = sum[4 * i + 2] + b0;
      r0[T_len + 8] = sum[4 * i + 3] + b1;
    }
  }""",
         """  const int co0 = grp * N;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int co = co0 + 8 * i + 2 * t4;
    const float b0 = bias[co], b1 = bias[co + 1];
    float* r0 = out + ((size_t)b * C + co) * T_len;
    float* r1 = r0 + T_len;
    if (t_row < T_len) {
      r0[t_row] = sum[4 * i] + b0;
      r1[t_row] = sum[4 * i + 1] + b1;
    }
    if (t_row + 8 < T_len) {
      r0[t_row + 8] = sum[4 * i + 2] + b0;
      r1[t_row + 8] = sum[4 * i + 3] + b1;
    }
  }"""),
    ]),
    "k2_runs_of_8": ("alias_free_act", [
        (K2, "constexpr int AFA_RUN = 16;", "constexpr int AFA_RUN = 8;"),
    ]),
    "k2_runs_of_32": ("alias_free_act", [
        (K2, "constexpr int AFA_RUN = 16;", "constexpr int AFA_RUN = 32;"),
    ]),
    "k2_128_threads": ("alias_free_act", [
        (K2, "constexpr int AFA_THREADS = 256;", "constexpr int AFA_THREADS = 128;"),
    ]),
    "wgrad_three_stages": ("snake_conv_wgrad", [
        (KW, "constexpr int SCW_STAGES = 4;", "constexpr int SCW_STAGES = 3;"),
    ]),
    "wgrad_bm64": ("snake_conv_wgrad", [
        (KW, "constexpr int SCW_BM = 128; ", "constexpr int SCW_BM = 64; "),
        (KW, "constexpr int SCW_CONSUMERS = 2; ",
         "constexpr int SCW_CONSUMERS = 1; "),
    ]),
}

# (B, C, T, k, dilation): the serving and stage-2 shapes of K3
K3_SHAPES = [(2, 768, 3444, 3, 1), (2, 768, 3444, 7, 1), (2, 768, 3444, 7, 5),
             (16, 768, 256, 3, 1), (16, 768, 256, 7, 1)]
K2_SHAPES = [(2, 768, 3444), (2, 384, 13776), (2, 24, 220416), (16, 768, 256),
             (16, 384, 1024)]
# (B, C, T, k, dilation): the float32 K3 at inference_e2e's six shapes
K3F_SHAPES = [(1, 768, 3584, k, d) for k in (3, 7) for d in (1, 3, 5)]
# (B, C, T, k, dilation): the dz kernel's stage-2 and C = 384 shapes, and
# the variants of K3's block that apply to it
KD_SHAPES = [(16, 768, 256, 3, 1), (16, 768, 256, 7, 5), (2, 384, 13776, 7, 5)]
DGRAD_VARIANTS = ("k3_two_stages", "k3_three_stages", "k3_refill_lag2",
                  "dz_batch_1", "dz_batch_8")
# (B, C, T, k, dilation): the dW kernel's stage-2 and C = 384 shapes
KW_SHAPES = [(16, 768, 256, 3, 1), (16, 768, 256, 7, 1), (16, 768, 256, 7, 5),
             (2, 384, 13776, 7, 5)]


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


def _start_builds(names, root_name: str = "variants_sc"):
    """One nvcc per (build, library), all started together: {(name, lib):
    (Popen, library path)}; ``cuda_core`` builds its own source against the
    shipped headers, as the float32 library ``snake_conv_f32``."""
    _build.write_taps_header()
    root = _build.BUILD_DIR / root_name
    shutil.rmtree(root, ignore_errors=True)
    started = {}
    for name in names:
        src_dir = root / name
        src_dir.mkdir(parents=True)
        if name == "cuda_core":
            jobs = [("snake_conv_f32", CUDA_CORE_SOURCE, _build.CSRC)]
        else:
            for file, text in patched_sources(name).items():
                (src_dir / file).write_text(text)
            libs = ([VARIANTS[name][0]] if name in VARIANTS
                    else ["snake_conv", "snake_conv_f32", "alias_free_act",
                          "snake_conv_wgrad"])
            jobs = [(lib, src_dir / _build.KERNELS[lib][0], src_dir)
                    for lib in libs]
        for lib, src, include in jobs:
            out = src_dir / f"lib{lib}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   str(include), "-I", str(_build.BUILD_DIR), "-o", str(out),
                   str(src)]
            started[(name, lib)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    return started


def finish(started) -> tuple[dict, dict]:
    """Wait for :func:`_start_builds`' compiles: ({(name, lib): CDLL},
    {"name/lib": ptxas lines on spills})."""
    loaded, spills = {}, {}
    for (name, lib), (proc, out) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{lib}:\n{log}")
        loaded[(name, lib)] = _build.bind(ctypes.CDLL(str(out)), lib)
        lines = [ln.strip() for ln in log.splitlines()
                 if re.search(r"[1-9]\d* bytes spill", ln)]
        if lines:
            spills[f"{name}/{lib}"] = lines
    return loaded, spills


def start_cuda_core():
    """Start building the float32 K3's yardstick alone; for :func:`finish`."""
    return _start_builds(["cuda_core"], "variants_sc_cuda_core")


def _kernel_ms(launch, calls: int = 20) -> float:
    """Device time per launch from torch.profiler over back-to-back
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            launch()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def _kernel_rows(launch, calls: int = 20) -> dict:
    """Device ms per launch of each kernel ``launch`` runs (torch.profiler,
    names cut to 60 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            launch()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _k3_launcher(cdll, b, c, t, k, d, gen):
    from .alias_free_act import _effective
    from .snake_conv import blocked_weight, co_block

    x = torch.randn((b, c, t), generator=gen, device="cuda").bfloat16()
    alpha, beta = (0.3 * torch.randn(c, generator=gen, device="cuda")
                   for _ in range(2))
    w = (0.02 * torch.randn((c, c, k), generator=gen, device="cuda")).bfloat16()
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    a, ib = _effective(alpha, beta, True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty_like(x)

    def launch(blk=None):
        wb = blocked_weight(w, blk=blk or co_block(c, b, t, sms))
        stream = torch.cuda.current_stream().cuda_stream
        return lambda: _build.check_launch("variant", cdll.snake_conv_forward(
            x.data_ptr(), a.data_ptr(), ib.data_ptr(), wb.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, c, t, k, d, stream))
    return launch


def _kw_launcher(cdll, name, b, c, t, k, d, gen):
    """One dW launch of build ``name`` on random (B, C, T) bfloat16 operands;
    its K split from the wrapper's rule at that build's tile (none for
    ``no_split``)."""
    from .snake_conv import WGRAD_BM, wgrad_splits

    hz = (k - 1) // 2 * d
    z, dy = (torch.randn((b, c, t), generator=gen, device="cuda").bfloat16()
             for _ in range(2))
    zt = torch.empty((b, t + 2 * hz, c), dtype=torch.bfloat16, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bm = 64 if name == "wgrad_bm64" else WGRAD_BM
    split = 1 if name == "no_split" else wgrad_splits(c, k, b, t, sms, bm)
    part = torch.empty((split, k, c, c), dtype=torch.float32, device="cuda")
    return lambda: _build.check_launch("variant", cdll.snake_conv_wgrad(
        z.data_ptr(), zt.data_ptr(), dy.data_ptr(), part.data_ptr(), b, c, t,
        k, d, split, torch.cuda.current_stream().cuda_stream))


def _dgrad_launcher(cdll, b, c, t, k, d, gen):
    """One dz launch (K3's block with Z = dy) of a build on random
    operands."""
    from .snake_conv import co_block, dgrad_blocked_weight

    dy = torch.randn((b, c, t), generator=gen, device="cuda").bfloat16()
    w = (0.02 * torch.randn((c, c, k), generator=gen, device="cuda")).bfloat16()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wb = dgrad_blocked_weight(w, blk=co_block(c, b, t, sms))
    out = torch.empty_like(dy)
    return lambda: _build.check_launch("variant", cdll.snake_conv_dgrad(
        dy.data_ptr(), wb.data_ptr(), out.data_ptr(), b, c, t, k, d,
        torch.cuda.current_stream().cuda_stream))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    names = ["shipped", *VARIANTS]
    loaded, spills = finish(_start_builds([*names, "cuda_core"]))
    print(json.dumps({"ptxas_spills": spills}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for shape in K3_SHAPES:
        builds = [n for n in names if n == "shipped" or (
            VARIANTS[n][0] == "snake_conv" and not n.startswith("dz_"))]
        launchers = {n: _k3_launcher(loaded[(n, "snake_conv")], *shape, gen)
                     for n in builds}
        fns = {n: launchers[n](384 if n == "k3_groups_of_384" else None)
               for n in builds}
        times = {n: [] for n in builds}
        for r in range(args.rounds):
            for n in (builds if r % 2 == 0 else builds[::-1]):
                times[n].append(_kernel_ms(fns[n]))
        print(json.dumps({"kernel": "fused_snake_conv", "shape": list(shape),
                          "gpu": smi, "ms": {n: statistics.median(v)
                                             for n, v in times.items()}}),
              flush=True)
    for b, c, t, k, d in K3F_SHAPES:
        from .snake_conv import fused_snake_conv

        builds = ["shipped", "cuda_core"] + [
            n for n in names if n in VARIANTS
            and VARIANTS[n][0] == "snake_conv_f32"]
        x = torch.randn((b, c, t), generator=gen, device="cuda")
        alpha, beta = (0.3 * torch.randn(c, generator=gen, device="cuda")
                       for _ in range(2))
        w = 0.02 * torch.randn((c, c, k), generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        fns = {}
        for n in builds:
            def fn(lib=loaded[(n, "snake_conv_f32")]):
                with _build.in_place("snake_conv_f32", lib):
                    fused_snake_conv(x, alpha, beta, w, bias, d)
            fns[n] = fn
        times = {n: [] for n in builds}
        for r in range(args.rounds):
            for n in (builds if r % 2 == 0 else builds[::-1]):
                times[n].append(_kernel_ms(fns[n]))
        parts = _kernel_rows(fns["shipped"])
        print(json.dumps({"kernel": "fused_snake_conv", "dtype": "fp32",
                          "shape": [b, c, t, k, d], "gpu": smi,
                          "ms": {n: statistics.median(v)
                                 for n, v in times.items()},
                          "shipped_by_kernel": parts}), flush=True)
    for shape in KD_SHAPES:
        builds = [n for n in names if n == "shipped"
                  or (VARIANTS[n][0] == "snake_conv" and n in DGRAD_VARIANTS)]
        fns = {n: _dgrad_launcher(loaded[(n, "snake_conv")], *shape, gen)
               for n in builds}
        times = {n: [] for n in builds}
        for r in range(args.rounds):
            for n in (builds if r % 2 == 0 else builds[::-1]):
                times[n].append(_kernel_ms(fns[n]))
        print(json.dumps({"kernel": "snake_conv_dgrad", "shape": list(shape),
                          "gpu": smi, "ms": {n: statistics.median(v)
                                             for n, v in times.items()}}),
              flush=True)
    for b, c, t in K2_SHAPES:
        from .alias_free_act import _effective

        builds = [n for n in names
                  if n == "shipped" or VARIANTS[n][0] == "alias_free_act"]
        x = torch.randn((b, c, t), generator=gen, device="cuda").bfloat16()
        alpha, beta = (0.3 * torch.randn(c, generator=gen, device="cuda")
                       for _ in range(2))
        a, ib = _effective(alpha, beta, True)
        out = torch.empty_like(x)
        fns = {n: (lambda lib=loaded[(n, "alias_free_act")]: _build.check_launch(
            "variant", lib.afa_snake_forward(
                x.data_ptr(), a.data_ptr(), ib.data_ptr(), out.data_ptr(),
                b, c, t, 1, torch.cuda.current_stream().cuda_stream)))
            for n in builds}
        times = {n: [] for n in builds}
        for r in range(args.rounds):
            for n in (builds if r % 2 == 0 else builds[::-1]):
                times[n].append(_kernel_ms(fns[n]))
        print(json.dumps({"kernel": "fused_alias_free_snake",
                          "shape": [b, c, t], "gpu": smi,
                          "ms": {n: statistics.median(v)
                                 for n, v in times.items()}}), flush=True)
    for shape in KW_SHAPES:
        builds = ["shipped", "no_split"] + [
            n for n in names if n in VARIANTS
            and VARIANTS[n][0] == "snake_conv_wgrad"]
        fns = {n: _kw_launcher(loaded[("shipped" if n == "no_split" else n,
                                       "snake_conv_wgrad")], n, *shape, gen)
               for n in builds}
        times = {n: [] for n in builds}
        for r in range(args.rounds):
            for n in (builds if r % 2 == 0 else builds[::-1]):
                times[n].append(_kernel_ms(fns[n]))
        print(json.dumps({"kernel": "snake_conv_wgrad", "shape": list(shape),
                          "gpu": smi, "ms": {n: statistics.median(v)
                                             for n, v in times.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
