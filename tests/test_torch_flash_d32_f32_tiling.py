"""The float32 attention kernels on ``wgmma`` (``ops/csrc/flash_f32_hopper.cuh``,
``flash_d32_f32.cu``, ``flash_d32_f32_bwd.cu``), checked on the CPU.

The kernels run only on the card.  Their tile constants are read from the
headers, and (a) their shared-memory layouts are recomputed and held to the
card's limit and to whole 1024-byte atoms of the 128-byte swizzle; (b) a
torch transcription of their arithmetic — every product as three TF32
products on operands split by tf32 rounding of the float32 bits, the
accumulator read as the tf32 A fragment in the kernels' register order
against B tiles whose keys lie in KEY_PERM order, fresh per-tile products
added in float32, the forward's online softmax over key tiles with masking
on the ragged tile, the backward's dk/dv pass over query tiles and dq pass
over key tiles — is held against the plain versions ``sdpa_plain_with_lse``
and ``sdpa_backward_plain``.  The same transcription with one TF32 product
in place of three misses the float32 checks: that is why the kernels split.
"""

from __future__ import annotations

import functools
import math
import re

import numpy as np
import pytest
import torch

from diffbinaural_tpu_torch.ops import (flash_d32, sdpa_backward_plain,
                                        sdpa_plain_with_lse)
from diffbinaural_tpu_torch.ops._build import CSRC

HEADERS = ("flash_common.cuh", "flash_hopper.cuh", "flash_f32_hopper.cuh")
MAX_DYNAMIC_SMEM = 232448   # bytes a block may use on an H100
SW128_ATOM = 1024           # 8 rows of 128 bytes
ROW_BYTES = 128             # 32 float32 values
LOG2E = 1.0 / math.log(2.0)
SCALE = 32 ** -0.5
TOL = 1e-5                  # split-TF32 transcription against the plain versions
K1_TOL, LSE_TOL = 2e-4, 2e-5  # chip_smoke.py's float32 checks


def _constants() -> dict:
    """The headers' integer constants, in order; a constant may be a
    product or sum of numbers and the constants before it."""
    text = "".join((CSRC / h).read_text() for h in HEADERS)
    out: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([\w\s*+()]+);",
                                 text):
        tokens = re.findall(r"\w+|[*+()]", expr)
        if all(t.isdigit() or t in out or t in "*+()" for t in tokens):
            out[name] = int(eval(" ".join(str(out.get(t, t)) for t in tokens)))
    return out


C = _constants()


def _round_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def _layouts() -> dict:
    """Each kernel's tiles as (name, byte offset, bytes), in the order of the
    header's layout structs, and the end of its barriers."""
    align = C["TILE_ALIGN"]

    def tile(rows):
        return rows * ROW_BYTES

    def ring(start, n_stages, parts):
        stage_bytes = _round_up(sum(size for _, size in parts), align)
        tiles = []
        for s in range(n_stages):
            at = start + s * stage_bytes
            for name, size in parts:
                tiles.append((f"{name}[{s}]", at, size))
                at += size
        return tiles, start + n_stages * stage_bytes

    def own(names, rows):
        return [(n, i * tile(rows), tile(rows)) for i, n in enumerate(names)]

    out = {}
    bm, bn, fs = C["F32_FWD_BLOCK_M"], C["F32_FWD_BLOCK_N"], C["F32_FWD_STAGES"]
    fixed = own(["q_hi", "q_lo"], bm)
    ring_tiles, end = ring(_round_up(2 * tile(bm), align), fs,
                           [(n, tile(bn)) for n in ("k_hi", "k_lo", "vt_hi",
                                                     "vt_lo")])
    out["forward"] = (fixed + ring_tiles, end + 8 * (2 * fs + 1))

    bs = C["F32_BWD_STAGES"]
    kn, km = C["F32_BWD_KV_BLOCK_N"], C["F32_BWD_KV_BLOCK_M"]
    fixed = own(["k_hi", "k_lo", "v_hi", "v_lo"], kn)
    parts = [(n, tile(km)) for n in ("q_hi", "q_lo", "do_hi", "do_lo",
                                     "qt_hi", "qt_lo", "dot_hi", "dot_lo")]
    ring_tiles, end = ring(_round_up(4 * tile(kn), align), bs,
                           parts + [("lse", 4 * km), ("di", 4 * km)])
    out["dk/dv"] = (fixed + ring_tiles, end + 8 * (2 * bs + 1))

    qm, qn = C["F32_BWD_Q_BLOCK_M"], C["F32_BWD_Q_BLOCK_N"]
    fixed = own(["q_hi", "q_lo", "do_hi", "do_lo"], qm)
    ring_tiles, end = ring(_round_up(4 * tile(qm), align), bs,
                           [(n, tile(qn)) for n in ("k_hi", "k_lo", "v_hi",
                                                     "v_lo", "kt_hi", "kt_lo")])
    out["dq"] = (fixed + ring_tiles, end + 8 * (2 * bs + 1))
    return out


@pytest.mark.parametrize("kernel", ["forward", "dk/dv", "dq"])
def test_tiles_fit_shared_memory_in_whole_128_byte_swizzle_atoms(kernel):
    tiles, end = _layouts()[kernel]
    # the launch asks for TILE_ALIGN more, to align the base itself
    assert end + C["TILE_ALIGN"] <= MAX_DYNAMIC_SMEM
    assert C["TILE_ALIGN"] % SW128_ATOM == 0
    assert C["SW128_ATOM"] == SW128_ATOM and C["F32_ROW_BYTES"] == ROW_BYTES
    for name, at, size in tiles:
        if name.startswith(("lse", "di")):  # float32 vectors, read as such
            assert at % 16 == 0
            continue
        assert size % SW128_ATOM == 0, name
        assert at % SW128_ATOM == 0, name
        # a TMA box: 128-byte rows (the 128-byte swizzle's limit), <= 256 rows
        assert size // ROW_BYTES <= 256, name
    ends = sorted((at, at + size) for _, at, size in tiles)
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:])), "tiles overlap"


def test_warpgroups_registers_and_padding():
    for kernel, rows in (("F32_FWD", "F32_FWD_BLOCK_M"),
                         ("F32_BWD", "F32_BWD_KV_BLOCK_N"),
                         ("F32_BWD", "F32_BWD_Q_BLOCK_M")):
        consumers = C[f"{kernel}_CONSUMERS"]
        assert C[rows] == 64 * consumers
        threads = 128 * (consumers + 1)
        assert C[f"{kernel}_THREADS"] == threads
        # what the consumers take, the producer must give back out of the
        # block's allocation at launch (or setmaxnreg.inc waits for ever)
        at_launch = 65536 // threads // 8 * 8 * threads
        assert 128 * (C[f"{kernel}_PRODUCER_REGS"]
                      + consumers * C[f"{kernel}_CONSUMER_REGS"]) <= at_launch
    # key / query tiles: whole k-steps of 8 and whole transposed blocks
    for name in ("F32_FWD_BLOCK_N", "F32_BWD_KV_BLOCK_M", "F32_BWD_Q_BLOCK_N"):
        assert C[name] % C["TBLK"] == 0 and C["F32_PAD"] % C[name] == 0
    assert flash_d32.F32_PAD == C["F32_PAD"]


@pytest.mark.parametrize("backward", [False, True])
def test_scratch_holds_what_the_launch_takes(backward):
    """The wrapper's scratch against the launch's carving (take_rows /
    take_transposed in the order of the C code)."""
    q = torch.empty((2, 3, 200, 32))
    bh, n = 6, 200
    n_pad = _round_up(n, C["F32_PAD"])
    rows, transposed = (4, 3) if backward else (2, 1)
    floats = rows * 2 * bh * n * 32 + transposed * 2 * bh * n_pad * 32
    assert flash_d32._scratch(q, backward).numel() == floats
    src = (CSRC / ("flash_d32_f32_bwd.cu" if backward
                   else "flash_d32_f32.cu")).read_text()
    def taken(what):  # calls, a loop's count times its one call
        loops = re.findall(rf"i < (\d+); \+\+i\) {{\s*r\[i\] = {what}", src)
        return (len(re.findall(rf"{what}\(at, BH, N\)", src)) - len(loops)
                + sum(int(x) for x in loops))

    assert taken("take_rows") == rows
    assert taken("take_transposed") == transposed


# ------------------------------------------- the arithmetic, in torch

def tf32(x: torch.Tensor) -> torch.Tensor:
    """tf32_bits of the header: round to nearest, ties away, on the float32
    bits (the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def product(a: torch.Tensor, b: torch.Tensor, one_pass: bool = False):
    """a @ b as the kernels take it: a_lo b_hi + a_hi b_lo + a_hi b_hi on
    tf32 halves (exact products, float64 sums, one float32 rounding); with
    ``one_pass`` one TF32 product a_hi b_hi."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    d = lambda x, y: x.double() @ y.double()  # noqa: E731
    if one_pass:
        return d(a_hi, b_hi).float()
    return (d(a_lo, b_hi) + d(a_hi, b_lo) + d(a_hi, b_hi)).float()


def key_perm() -> list:
    """KEY_PERM as split_transposed_kernel computes it (the expression is
    read from the header, so that the transcription follows the code)."""
    text = (CSRC / "flash_f32_hopper.cuh").read_text()
    expr = "c - cg + (cg < 4 ? 2 * cg : 2 * (cg - 4) + 1)"
    assert expr in text
    return [c - c % 8 + (2 * (c % 8) if c % 8 < 4 else 2 * (c % 8 - 4) + 1)
            for c in range(8)]


@functools.lru_cache(maxsize=None)
def _a_source(k: int):
    """For each element (row, column) of the tf32 A operand (64 x k) that
    the kernels hand to wgmma, the accumulator element it is taken from.
    Thread (g, t) of warp w holds accumulator values 4c ... 4c + 3 = (r,
    8c + 2t), (r, 8c + 2t + 1), (r + 8, 8c + 2t), (r + 8, 8c + 2t + 1) with
    r = 16 w + g; split_a_frags passes them in the order 0, 2, 1, 3 as the
    A fragment (r, 8c + t), (r + 8, 8c + t), (r, 8c + t + 4),
    (r + 8, 8c + t + 4)."""
    text = (CSRC / "flash_f32_hopper.cuh").read_text()
    order = []
    for j in range(4):  # hi[4 c + j] = acc[4 c + order[j]] in the header
        to = f"hi\\[4 \\* c \\+ {j}\\]" if j else "hi\\[4 \\* c\\]"
        m = re.search(rf"split_tf32\(acc\[4 \* c(?: \+ (\d))?\], {to},",
                      text)
        order.append(int(m.group(1) or 0))
    assert order == [0, 2, 1, 3]
    rows = torch.empty((64, k), dtype=torch.long)
    cols = torch.empty((64, k), dtype=torch.long)
    for w in range(4):
        for g in range(8):
            for t in range(4):
                r = 16 * w + g
                for c in range(k // 8):
                    acc = [(r, 8 * c + 2 * t), (r, 8 * c + 2 * t + 1),
                           (r + 8, 8 * c + 2 * t), (r + 8, 8 * c + 2 * t + 1)]
                    frag = [(r, 8 * c + t), (r + 8, 8 * c + t),
                            (r, 8 * c + t + 4), (r + 8, 8 * c + t + 4)]
                    for j, (ar, ac) in enumerate(frag):
                        rows[ar, ac], cols[ar, ac] = acc[order[j]]
    return rows, cols


def a_operand(acc: torch.Tensor) -> torch.Tensor:
    """A float32 accumulator tile (..., 64, K) as the tf32 A operand."""
    rows, cols = _a_source(acc.shape[-1])
    return acc[..., rows, cols]


def b_transposed(x: torch.Tensor) -> torch.Tensor:
    """A (..., K keys, 32) tile as the transposed form puts it before the
    tensor cores: column c of the B operand (K x 32, K-major) holds key
    8 (c / 8) + KEY_PERM[c % 8]."""
    perm = key_perm()
    idx = [c - c % 8 + perm[c % 8] for c in range(x.shape[-2])]
    return x[..., idx, :]


def tiled_product(acc_tile, rhs_tile, one_pass=False):
    """acc_tile (an accumulator, 64 rows x K) @ rhs_tile (K x 32) through
    the kernels' operand layouts."""
    rows = acc_tile.shape[-2]
    parts = [product(a_operand(acc_tile[..., r:r + 64, :]),
                     b_transposed(rhs_tile), one_pass)
             for r in range(0, rows, 64)]
    return torch.cat(parts, dim=-2)


def _pad(x, rows):
    n = x.shape[-2]
    return torch.nn.functional.pad(x, (0, 0, 0, _round_up(n, rows) - n))


def forward_tiled(q, k, v, scale, one_pass=False):
    """o and lse as flash_d32_f32_kernel computes them ((BH, N, 32))."""
    bm, bn = C["F32_FWD_BLOCK_M"], C["F32_FWD_BLOCK_N"]
    n = q.shape[1]
    c = scale * LOG2E
    qp, kp, vp = _pad(q, bm), _pad(k, bn), _pad(v, bn)
    o_tiles, lse_tiles = [], []
    for q0 in range(0, n, bm):
        qt = qp[:, q0:q0 + bm]
        m = torch.full(qt.shape[:2], -math.inf)
        l = torch.zeros(qt.shape[:2])
        acc = torch.zeros_like(qt)
        pending = None  # the previous tile's P V, issued under this softmax
        for k0 in range(0, n, bn):
            s = product(qt, kp[:, k0:k0 + bn].transpose(1, 2), one_pass)
            s[:, :, torch.arange(bn) >= n - k0] = -math.inf  # keys beyond N
            m_new = torch.maximum(m, s.amax(dim=-1) * c)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(torch.addcmul(-m_new[..., None], s, torch.tensor(c)))
            l = l * corr + p.sum(dim=-1)
            if pending is not None:  # a fresh tile's product, then added
                acc = acc + pending
            acc = acc * corr[..., None]
            pending = tiled_product(p, vp[:, k0:k0 + bn], one_pass)
            m = m_new
        acc = acc + pending
        o_tiles.append(acc / l[..., None])
        lse_tiles.append((m + torch.log2(l)) * math.log(2.0))
    return torch.cat(o_tiles, 1)[:, :n], torch.cat(lse_tiles, 1)[:, :n]


def backward_tiled(q, k, v, o, lse, do, scale):
    """dq, dk, dv as the float32 dk/dv and dq kernels compute them."""
    n = q.shape[1]
    c = scale * LOG2E
    di = (o * do).sum(dim=-1)
    # dk/dv: a block per key tile, query tiles streamed with lse (base 2,
    # +inf beyond N) and di (0 beyond N)
    bk, bq = C["F32_BWD_KV_BLOCK_N"], C["F32_BWD_KV_BLOCK_M"]
    qp, dop = _pad(q, bq), _pad(do, bq)
    pad = qp.shape[1] - n
    lse2 = torch.nn.functional.pad(lse * LOG2E, (0, pad), value=math.inf)
    dip = torch.nn.functional.pad(di, (0, pad))
    kp, vp = _pad(k, bk), _pad(v, bk)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for k0 in range(0, n, bk):
        kt, vt = kp[:, k0:k0 + bk], vp[:, k0:k0 + bk]
        for q0 in range(0, n, bq):
            qt, dot = qp[:, q0:q0 + bq], dop[:, q0:q0 + bq]
            st = product(kt, qt.transpose(1, 2))
            dpt = product(vt, dot.transpose(1, 2))
            pt = torch.exp2(torch.addcmul(-lse2[:, None, q0:q0 + bq], st,
                                          torch.tensor(c)))
            dst = pt * (dpt - dip[:, None, q0:q0 + bq])
            dv[:, k0:k0 + bk] += tiled_product(pt, dot)
            dk[:, k0:k0 + bk] += tiled_product(dst, qt)
    # dq: a block per query tile, key tiles streamed; keys beyond N masked
    bm, bn = C["F32_BWD_Q_BLOCK_M"], C["F32_BWD_Q_BLOCK_N"]
    qp, dop = _pad(q, bm), _pad(do, bm)
    rows = torch.arange(qp.shape[1]).clamp(max=n - 1)  # clamped row reads
    l_rows, i_rows = (lse * LOG2E)[:, rows], di[:, rows]
    kp, vp = _pad(k, bn), _pad(v, bn)
    dq = torch.zeros_like(qp)
    for q0 in range(0, n, bm):
        qt, dot = qp[:, q0:q0 + bm], dop[:, q0:q0 + bm]
        lt, it = l_rows[:, q0:q0 + bm, None], i_rows[:, q0:q0 + bm, None]
        for k0 in range(0, n, bn):
            kt, vt = kp[:, k0:k0 + bn], vp[:, k0:k0 + bn]
            p = torch.exp2(torch.addcmul(-lt, product(qt, kt.transpose(1, 2)),
                                         torch.tensor(c)))
            p[:, :, torch.arange(bn) >= n - k0] = 0.0
            ds = p * (product(dot, vt.transpose(1, 2)) - it)
            dq[:, q0:q0 + bm] += tiled_product(ds, kt)
    return dq[:, :n] * scale, dk[:, :n] * scale, dv[:, :n]


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((2, n, 32)).astype(np.float32))
            for _ in range(4)]


def test_tf32_rounding_and_split():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.14159265, -2.71828183e-3])
    hi, lo = split(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    # ties go away from zero, on the magnitude
    assert hi[1].item() == 1.0 + 2 ** -10 and hi[3].item() == -(1.0 + 2 ** -10)
    assert hi[2].item() == 1.0 + 2 ** -9
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert err.max().item() < 2 ** -21


@pytest.mark.parametrize("n", [200, 320])
def test_forward_transcription_matches_the_plain_version(n):
    q, k, v, _ = _inputs(n, seed=n)
    o, lse = forward_tiled(q, k, v, SCALE)
    o_p, lse_p = sdpa_plain_with_lse(q, k, v, SCALE)
    torch.testing.assert_close(o, o_p, rtol=0, atol=TOL)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [200, 320])
def test_backward_transcription_matches_the_plain_version(n):
    q, k, v, do = _inputs(n, seed=n + 1)
    o, lse = sdpa_plain_with_lse(q, k, v, SCALE)
    got = backward_tiled(q, k, v, o, lse, do, SCALE)
    want = sdpa_backward_plain(q, k, v, o, lse, do, SCALE)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL, msg=label)


def test_a_wrong_key_order_shows():
    """The operand maps are what the check rests on: with the B tile's keys
    in plain order instead of KEY_PERM, P V is wrong."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.random((1, 64, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 64, 32)).astype(np.float32))
    good = tiled_product(p, v)
    torch.testing.assert_close(good, p @ v, rtol=0, atol=1e-5)
    plain_order = product(a_operand(p), v)
    assert (plain_order - p @ v).abs().max().item() > 0.1


def test_one_tf32_product_misses_the_float32_checks():
    """One TF32 product per float32 product (the route without the split)
    lands outside chip_smoke.py's float32 lse check; the split lands well
    inside it."""
    q, k, v, _ = _inputs(320, seed=7)
    _, lse_p = sdpa_plain_with_lse(q, k, v, SCALE)
    _, lse_one = forward_tiled(q, k, v, SCALE, one_pass=True)
    _, lse_split = forward_tiled(q, k, v, SCALE)
    one = (lse_one - lse_p).abs().max().item()
    three = (lse_split - lse_p).abs().max().item()
    assert one > LSE_TOL > 10 * three, (one, three)
