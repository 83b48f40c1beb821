"""The float32 K3 on ``wgmma`` (``ops/csrc/snake_conv_f32.cu``: split-TF32
products), checked on the CPU.

The kernel runs only on the card.  Its constants are read from the sources,
and (a) its shared-memory plan (Z hi and lo per chunk of input channels, the
weight ring, the barriers), its register plan and the activation's runs
are recomputed and held to the card's limits at every (C, k, d) that the
model's gate admits and at every block the dispatcher may pick; (b) a torch
transcription of its loop — the weight's pre-pass into hi / lo stages (tf32
round to nearest, ties away, on the float32 bits), Z of each chunk split the
same way, the three products a_lo b_hi + a_hi b_lo + a_hi b_hi of every step
at the tap's row offset, a fresh accumulator per chunk added in float32,
rows outside the clip zero, the bias — is held against ``snake_conv_plain``
within a tenth of the card check's 2e-4 of the output's scale; (c) one TF32
product in place of three misses that check; (d) a wrong tap offset or chunk order
shows; (e) ldmatrix's lanes give the tf32 A fragment; (f) one small case
runs against the JAX package's ``fused_snake_conv``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.ops.snake_conv import fused_snake_conv as jax_fused
from diffbinaural_tpu_torch.models.bigvgan import _snake_conv_fusable
from diffbinaural_tpu_torch.ops import alias_free_snake_plain, snake_conv_plain
from diffbinaural_tpu_torch.ops._build import CSRC, KERNELS
from diffbinaural_tpu_torch.ops.snake_conv import (f32_co_block,
                                                   snake_conv_plannable)

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 2e-4  # chip_smoke.py's float32 K3 check, of the output's scale


def _constants(*names: str) -> dict:
    """Integer constants (``constexpr int NAME = expr;``) of the sources, in
    order; an expression may use numbers and the constants before it."""
    out: dict = {}
    for name in names:
        text = (CSRC / name).read_text()
        for key, expr in re.findall(r"constexpr int (\w+) = ([\w\s*+()/]+);",
                                    text):
            tokens = re.findall(r"\w+|[*+()/]", expr)
            if all(t.isdigit() or t in out or t in "*+()/" for t in tokens):
                out[key] = int(eval(" ".join(
                    str(out.get(t, t)) for t in tokens).replace("/", "//")))
    return out


C = _constants("flash_common.cuh", "flash_hopper.cuh", "snake_conv_common.cuh",
               "flash_f32_hopper.cuh", "snake_conv_f32.cu")
SOURCE = (CSRC / "snake_conv_f32.cu").read_text()
TM, CH, KC, Z_ROW = C["SCF_TM"], C["SCF_CH"], C["SCF_KC"], C["SCF_Z_ROW"]
ALIGN = C["TILE_ALIGN"]
BLOCKS = (192, 128)  # the two instances of snake_conv_f32_kernel<N>
# the shapes K3 takes in float32: inference_e2e's six, main_path_check's,
# the stage-2 check's, a clip across both edges, a ragged one
SHAPES = ([(1, 768, 3584, k, d) for k in (3, 7) for d in (1, 3, 5)]
          + [(2, 768, 3444, k, d) for k in (3, 7) for d in (1, 3, 5)]
          + [(16, 768, 256, k, d) for k in (3, 7) for d in (1, 3, 5)]
          + [(1, 768, 40, 7, 5), (2, 768, 1001, 3, 3)])


def _round_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def scf_plan(k: int, dil: int, n: int) -> dict:
    """``scf_plan`` of snake_conv_f32.cu: Z hi | Z lo | x windows | ring |
    barriers."""
    zr = TM + 2 * ((k - 1) // 2 * dil)
    z_bytes = _round_up(2 * zr * Z_ROW, ALIGN)
    xs_row = _round_up(zr + C["SCF_RUN"] + 10, 32) + 1
    xs_bytes = _round_up(CH * xs_row * 4, ALIGN)
    stage = n * KC * 8
    avail = (C["MAX_DYNAMIC_SMEM"] - ALIGN - z_bytes - xs_bytes
             - C["SCF_BAR_BYTES"])
    stages = min(int(avail / stage), C["SCF_MAX_STAGES"])  # C's truncation
    return {"zr": zr, "z_bytes": z_bytes, "xs_row": xs_row,
            "xs_bytes": xs_bytes, "stage_bytes": stage, "stages": stages,
            "bytes": z_bytes + xs_bytes + stages * stage + C["SCF_BAR_BYTES"],
            "fits": stages >= 2}


def test_plan_transcription_matches_the_kernel():
    body = re.search(r"static bool scf_plan\(int k, int dil, int stage_bytes, "
                     r"ScfPlan\* p\) \{(.*?)\n\}", SOURCE, re.S).group(1)
    for line in (
            "p->zr = SCF_TM + 2 * hz;",
            "p->z_bytes = round_up(2 * p->zr * SCF_Z_ROW, TILE_ALIGN);",
            "p->xs_row = round_up(p->zr + SCF_RUN + 10, 32) + 1;",
            "p->xs_bytes = round_up(SCF_CH * p->xs_row * 4, TILE_ALIGN);",
            "p->stages = avail / stage_bytes;",
            "if (p->stages > SCF_MAX_STAGES) p->stages = SCF_MAX_STAGES;",
            "return p->stages >= 2;"):
        assert line in body, line
    assert "constexpr int STAGE_BYTES = N * SCF_KC * 8;" in SOURCE
    assert "scf_plan(k, dil, STAGE_BYTES, &plan)" in SOURCE
    assert C["SCF_THREADS"] == 2 * C["WG_THREADS"] == 2 * 64 * 2
    assert TM == 64 * C["SCF_THREADS"] // C["WG_THREADS"]
    assert Z_ROW == 4 * CH + C["SCF_ZPAD"] and CH % 32 == 0
    # the dispatcher: 192 output channels where C allows, else 128
    assert "static int scf_co_block(int C) { return C % 192 == 0 ? 192 : 128; }" \
        in SOURCE
    for c in range(128, 4097, 128):
        assert f32_co_block(c) == (192 if c % 192 == 0 else 128)
    for n in BLOCKS:
        assert re.search(rf"return scf_launch<{n}>\(", SOURCE)


def _check_fits(c: int, k: int, d: int, n: int) -> None:
    p = scf_plan(k, d, n)
    assert p["fits"], (c, k, d, n, p)
    assert p["bytes"] + ALIGN <= C["MAX_DYNAMIC_SMEM"]
    assert c % n == 0 and c % CH == 0 and (k * CH // KC) % 2 == 0
    # ring stages on 1024-byte boundaries; a bulk copy's source and size in
    # whole 16 bytes
    assert p["stage_bytes"] % ALIGN == 0 and p["z_bytes"] % ALIGN == 0
    # the serving shapes keep seven stages or more
    if k <= 7 and d <= 5:
        assert p["stages"] >= 7
    # the x windows: every run's reads inside its channel's row, lanes on
    # distinct banks
    run = C["SCF_RUN"]
    assert (p["zr"] - 1) // run * run + run + 10 <= p["xs_row"]
    assert p["xs_row"] % 32 == 1


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_fits_at_the_float32_shapes(shape):
    b, c, t, k, d = shape
    for n in BLOCKS:  # the shipped block and the variants bench's
        _check_fits(c, k, d, n)
    assert f32_co_block(c) == 192


def test_plan_fits_at_every_gated_config_convolution():
    """Every AMP convolution of ``configs/*.json`` that the gate fuses."""
    seen = 0
    for path in sorted(Path(__file__).resolve().parents[1].glob("configs/*.json")):
        h = json.loads(path.read_text())
        c0 = h["upsample_initial_channel"]
        for i in range(len(h["upsample_rates"])):
            c = c0 // 2 ** (i + 1)
            for k, dils in zip(h["resblock_kernel_sizes"],
                               h["resblock_dilation_sizes"]):
                for d in (*dils, 1):
                    if _snake_conv_fusable(c, k, d):
                        _check_fits(c, k, d, f32_co_block(c))
                        seen += 1
    assert seen > 0


def test_the_gate_stays_honest():
    """Fault C1's lesson: whenever the gate's plan check admits (C, k, d),
    the float32 plan places it too, at the block the dispatcher picks (the
    gate itself is not changed)."""
    admitted = 0
    for c in range(128, 2049, 128):
        for k in (1, 3, 5, 7, 9, 11, 13):
            for d in (1, 2, 3, 5, 7, 9):
                if snake_conv_plannable(c, k, d):
                    admitted += 1
                    _check_fits(c, k, d, f32_co_block(c))
                    _check_fits(c, k, d, 128)
    assert admitted > 100


def test_register_plan_fits():
    """Two warpgroups, 256 threads: 255 registers each.  The register
    arrays alone — the fresh accumulator and the running sum (N / 2 each),
    two sets of A's hi and lo (16) — leave room at every block; a third
    warpgroup would not.  That is a lower bound: whether the rest fits is
    ptxas's answer, which chip_smoke.py's build phase holds to no spill."""
    assert 65536 // C["SCF_THREADS"] >= 255
    assert "float sum[N / 2], acc[N / 2];" in SOURCE
    assert "uint32_t a0[8], a1[8];" in SOURCE
    for n in BLOCKS:
        assert n // 2 * 2 + 2 * 8 < 255
    # a third warpgroup would cap each thread at 168 registers, short of the
    # 192-channel block's arrays alone
    assert 192 // 2 * 2 + 2 * 8 > 65536 // (C["SCF_THREADS"] + 128) // 8 * 8
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert '"snake_conv_f32"' in smoke and "bytes spill" in smoke


@pytest.mark.parametrize("zr", [130, 134, 142, 148, 158, 182])
def test_activation_runs_cover_z_once(zr):
    """scf_activate's items: item it is channel it % SCF_CH, rows
    SCF_RUN (it / SCF_CH) ... + SCF_RUN - 1 below zr; every (row, channel)
    of the chunk is written once, and a warp's 32 lanes store to one row,
    32 consecutive words, and read their x windows at one offset of 32 rows
    of xs_row = 1 (mod 32) floats (no bank conflict either way)."""
    for line in ("const int items = (zr + SCF_RUN - 1) / SCF_RUN * SCF_CH;",
                 "for (int it = threadIdx.x; it < items; it += SCF_THREADS) {",
                 "const int cl = it % SCF_CH, r0 = it / SCF_CH * SCF_RUN;",
                 "for (int p = 0; p < SCF_RUN + 10; ++p) xw[p] = xs[cl * xs_row + r0 + p];",
                 "uint8_t* at = zp + r0 * SCF_Z_ROW + 4 * cl;"):
        assert line in SOURCE, line
    xs_row = scf_plan(3, (zr - TM) // 2, 192)["xs_row"]
    for r0 in range(0, zr, C["SCF_RUN"]):
        for cl0 in range(0, CH, 32):
            banks = {((cl0 + lane) * xs_row + r0) % 32 for lane in range(32)}
            assert len(banks) == 32
    run = C["SCF_RUN"]
    items = -(-zr // run) * CH
    written = np.zeros((zr, CH), dtype=int)
    for it in range(items):
        cl, r0 = it % CH, it // CH * run
        for i in range(run):
            if r0 + i < zr:
                written[r0 + i, cl] += 1
    assert (written == 1).all()
    for warp0 in range(0, items, 32):
        lanes = range(warp0, min(warp0 + 32, items))
        assert len({it // CH for it in lanes}) == 1
        assert sorted((4 * (it % CH)) // 4 % 32 for it in lanes) == list(range(len(lanes)))


def test_ldmatrix_rows_are_conflict_free():
    for r0 in range(8):
        banks = sorted(((r0 + r) * Z_ROW) % 128 for r in range(8))
        assert banks == list(range(0, 128, 16))
    # a step's 8 channels, both 16-byte halves, stay inside the chunk's row
    per_row = (CH // KC - 1) * KC * 4 + 16 + 16
    assert per_row <= 4 * CH


# ------------------------------------------------ (e) ldmatrix -> A fragment

def test_ldmatrix_gives_the_tf32_a_fragment():
    """ldmatrix.x4 (b16): lane l gives the row address of matrix l / 8 (row
    l % 8); lane L receives, of each matrix i, the 32-bit word L % 4 of row
    L / 4 in register i.  With the kernel's lane addresses every register
    holds the tf32 A fragment's element: a0 (g, t), a1 (g + 8, t),
    a2 (g, t + 4), a3 (g + 8, t + 4), g = L / 4, t = L % 4."""
    addr = ("base + (64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) "
            "* SCF_Z_ROW +\n      16 * (lane >> 4);")
    assert addr in SOURCE
    for warp in range(4):
        # (row, word) of Z that lane l points matrix l // 8's row l % 8 at
        start = {}
        for lane in range(32):
            row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)
            start[(lane // 8, lane % 8)] = (row, 16 * (lane >> 4) // 4)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            want = [(16 * warp + g, t), (16 * warp + g + 8, t),
                    (16 * warp + g, t + 4), (16 * warp + g + 8, t + 4)]
            for i in range(4):
                row, word0 = start[(i, lane // 4)]
                assert (row, word0 + lane % 4) == want[i], (warp, lane, i)


# ------------------------------------------------ (b) the loop in torch

def tf32(x: torch.Tensor) -> torch.Tensor:
    """tf32_bits of flash_f32_hopper.cuh: round to nearest, ties away, on
    the float32 bits (the low 13 bits cleared)."""
    text = (CSRC / "flash_f32_hopper.cuh").read_text()
    assert "return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;" in text
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def split_weight(weight: torch.Tensor, n: int) -> torch.Tensor:
    """snake_conv_f32_split_kernel: (C, C, k) -> (C/N * n_steps, 2, N * 8)
    float32 values of tf32 bits, one row per stage, hi then lo."""
    for line in ("const int q = e & 3, row = (e >> 2) & 7, half = (e >> 5) & 1, n8 = e >> 6;",
                 "const int co = grp * n + 8 * n8 + row;",
                 "const int ci = chunk * SCF_CH + SCF_KC * kk + 4 * half + q;",
                 "const int j = r / (SCF_CH / SCF_KC), kk = r % (SCF_CH / SCF_KC);",
                 "const size_t o = (size_t)stage * 2 * tile + e;",
                 "wb[o + tile] = lo;"):
        assert line in SOURCE, line
    c, _, k = weight.shape
    tile = n * KC
    per_chunk = k * (CH // KC)
    n_steps = c // CH * per_chunk
    i = torch.arange(k * c * c)
    e, stage = i % tile, i // tile
    grp, s = stage // n_steps, stage % n_steps
    chunk, r = s // per_chunk, s % per_chunk
    j, kk = r // (CH // KC), r % (CH // KC)
    q, row, half, n8 = e & 3, (e >> 2) & 7, (e >> 5) & 1, e >> 6
    co = grp * n + 8 * n8 + row
    ci = chunk * CH + KC * kk + 4 * half + q
    hi, lo = split(weight[co, ci, j])
    out = torch.empty(k * c * c // tile, 2, tile)
    out[stage, 0, e] = hi
    out[stage, 1, e] = lo
    return out


def b_tile(flat: torch.Tensor, n: int) -> torch.Tensor:
    """One hi (or lo) tile as wgmma reads it through sch_desc's no-swizzle
    K-major descriptor: element (row n, k column kc) at byte (n / 8) * SBO +
    (kc / 4) * LBO + (n % 8) * 16 + (kc % 4) * 4.  Returns B^T (N x 8)."""
    text = (CSRC / "snake_conv_common.cuh").read_text()
    lbo, sbo = (int(v) for v in re.search(
        r"\(\(uint64_t\)\((\d+) >> 4\) << 16\) \|\s+\(\(uint64_t\)\((\d+) >> 4\) << 32\)",
        text).groups())
    nn = torch.arange(n)[:, None]
    kc = torch.arange(KC)[None, :]
    byte = (nn // 8) * sbo + (kc // 4) * lbo + (nn % 8) * 16 + (kc % 4) * 4
    return flat[..., byte // 4]


def z_tiles(x, alpha, beta, t_len: int, hz: int, zr: int) -> torch.Tensor:
    """Z of every time tile (tiles, zr, C): the activation at rows
    t_lo + r, t_lo = tb - hz, zero outside [0, T).  The activation's own
    arithmetic is the bfloat16 block's (test_torch_snake_conv_tiling.py
    transcribes it); here it is the plain version's."""
    z = alias_free_snake_plain(x, alpha, beta, True)[0].float()  # (C, T)
    out = []
    for tb in range(0, t_len, TM):
        t = tb - hz + torch.arange(zr)
        inside = (t >= 0) & (t < t_len)
        out.append(torch.where(inside[:, None], z[:, t.clamp(0, t_len - 1)].T,
                               torch.zeros(())))
    return torch.stack(out)


def snake_conv_f32_transcribed(x, alpha, beta, weight, bias, dil, n=None,
                               one_pass=False, tap_row=None, chunk_z=None):
    """The kernel's loop: per (batch, time tile, output block), per chunk of
    CH input channels, Z split into hi / lo, then k * CH / 8 steps of the
    three products into a fresh accumulator (exact products summed in
    float64, rounded once: the tensor cores' sum), added to the running sum
    in float32; bias; rows beyond T dropped.  ``one_pass``: a_hi b_hi
    alone.  ``tap_row(j)`` and ``chunk_z(c)`` replace the tap's row offset
    and the chunk whose Z columns a chunk's weight meets (mutations)."""
    b_sz, c, t_len = x.shape
    k = weight.shape[2]
    n = n or f32_co_block(c)
    hz = (k - 1) // 2 * dil
    zr = TM + 2 * hz
    tap_row = tap_row or (lambda j: j * dil)
    chunk_z = chunk_z or (lambda ch: ch)
    per_chunk = k * (CH // KC)
    n_steps = c // CH * per_chunk
    stages = split_weight(weight.float(), n)
    out = torch.empty(b_sz, c, t_len)
    for bi in range(b_sz):
        z_hi, z_lo = split(z_tiles(x[bi:bi + 1], alpha, beta, t_len, hz, zr))
        tiles = z_hi.shape[0]
        for grp in range(c // n):
            total = torch.zeros(tiles, TM, n)
            for ch in range(c // CH):
                fresh = torch.zeros(tiles, TM, n, dtype=torch.float64)
                for r in range(per_chunk):
                    j, kk = divmod(r, CH // KC)
                    rows = tap_row(j) + torch.arange(TM)
                    cols = chunk_z(ch) * CH + KC * kk + torch.arange(KC)
                    a_hi = z_hi[:, rows][:, :, cols].double()
                    a_lo = z_lo[:, rows][:, :, cols].double()
                    stage = stages[grp * n_steps + ch * per_chunk + r]
                    b_hi = b_tile(stage[0], n).double().T   # (8, N)
                    b_lo = b_tile(stage[1], n).double().T
                    if one_pass:
                        fresh += a_hi @ b_hi
                    else:
                        fresh += a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
                total = total + fresh.float()
            res = (total + bias[grp * n:(grp + 1) * n].float())  # (tiles, TM, N)
            res = res.reshape(tiles * TM, n)[:t_len].T
            out[bi, grp * n:(grp + 1) * n] = res
    return out


def _world(c, t_len, k, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, c, t_len)).astype(np.float32))
    alpha = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.3)
    beta = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.3)
    w = torch.from_numpy((rng.standard_normal((c, c, k)) * 0.02).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)
    return x, alpha, beta, w, bias


def _err_of_scale(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("k,dil", [(7, 5), (3, 1)])
@pytest.mark.parametrize("c,t_len", [(128, 40), (128, 1001), (256, 40),
                                     (256, 1001), (384, 200)])
def test_loop_matches_plain(c, t_len, k, dil):
    """C = 128 / 256 take blocks of 128, C = 384 blocks of 192."""
    world = _world(c, t_len, k, seed=c + t_len + k)
    got = snake_conv_f32_transcribed(*world, dil)
    want = snake_conv_plain(*world, dil, True)
    assert got.shape == want.shape
    assert _err_of_scale(got, want) <= TOL / 10


def test_one_tf32_product_misses_the_float32_check():
    world = _world(128, 500, 7, seed=3)
    want = snake_conv_plain(*world, 5, True)
    one = _err_of_scale(snake_conv_f32_transcribed(*world, 5, one_pass=True), want)
    three = _err_of_scale(snake_conv_f32_transcribed(*world, 5), want)
    assert one > TOL > 10 * three, (one, three)


@pytest.mark.parametrize("mutation", ["tap_row", "chunk_z"])
def test_a_wrong_tap_offset_or_chunk_order_shows(mutation):
    world = _world(128, 200, 7, seed=11)
    want = snake_conv_plain(*world, 3, True)
    bad = ({"tap_row": lambda j: j * 3 - (j == 6)} if mutation == "tap_row"
           else {"chunk_z": lambda ch: ch ^ 1})
    got = snake_conv_f32_transcribed(*world, 3, **bad)
    assert _err_of_scale(got, want) > 100 * TOL


def test_library_and_source_are_registered():
    src, fns = KERNELS["snake_conv_f32"]
    assert src == "snake_conv_f32.cu" and "snake_conv_f32_forward" in fns
    yardstick = (CSRC.parent / "csrc_variants" / "snake_conv_cuda_core.cu").read_text()
    assert 'extern "C" int snake_conv_f32_forward(' in yardstick
    assert "snake_conv_kernel" not in (CSRC / "snake_conv.cu").read_text()


# ------------------------------------------------ (f) against the JAX package

def test_loop_matches_the_jax_kernel_on_the_interior():
    """The transcription against the JAX package's ``fused_snake_conv`` as
    its own CPU tests run it (the interpreted Pallas kernel), on the interior
    (the TPU kernel's edges are its own)."""
    k, d, c, t_len = 7, 5, 128, 192
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, t_len, c)).astype(np.float32)
    alpha = rng.standard_normal(c).astype(np.float32) * 0.1
    beta = rng.standard_normal(c).astype(np.float32) * 0.1
    kernel = (rng.standard_normal((k, c, c)) * 0.02).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32) * 0.1
    want = np.asarray(jax_fused(*(jnp.asarray(a) for a in (x, alpha, beta, kernel, bias)),
                                dilation=d))[0].T                # (C, T)
    got = snake_conv_f32_transcribed(
        torch.from_numpy(x).permute(0, 2, 1).contiguous(), torch.from_numpy(alpha),
        torch.from_numpy(beta), torch.from_numpy(kernel).permute(2, 1, 0).contiguous(),
        torch.from_numpy(bias), d)[0].numpy()
    m = (k - 1) // 2 * d + 8  # the activation's edge samples, spread by the conv
    np.testing.assert_allclose(got[:, m:-m], want[:, m:-m], rtol=2e-4, atol=2e-4)
