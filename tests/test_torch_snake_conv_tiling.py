"""The tiling of the forward kernels K3 (bfloat16, ``ops/csrc/snake_conv.cu``)
and K2 (``ops/csrc/alias_free_act.cu``), checked on the CPU.

The kernels themselves run only on the card.  Their constants are read from
the sources, and (a) K3's shared-memory plan (Z, the weight ring, the
activation's scratch in the ring, the epilogue's staging over both) is
recomputed and held to the card's limit at every eligible tap count and
dilation for C = 768 and 384, and its register plan to the launch's
budget; (b) a torch
transcription of K3's loop — Z rows addressed with the tap shift, Z rounded
to bfloat16, the halo zeroed outside the clip, the weight read from the
wrapper's blocked layout step by step, the output-channel blocks — runs
against ``snake_conv_plain`` over ragged T; (c) a transcription of K2's
register-blocked runs, interior and edge, and of its sine's range reduction
runs against ``alias_free_snake_plain``.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffbinaural_tpu_torch.ops import alias_free_snake_plain, snake_conv_plain
from diffbinaural_tpu_torch.ops._build import CSRC
from diffbinaural_tpu_torch.ops.alias_free_act import _effective, _taps
from diffbinaural_tpu_torch.ops.snake_conv import (blocked_weight, co_block,
                                                   sch_plan)
from diffbinaural_tpu_torch.ops import alias_free_act_variants as afb_variants
from diffbinaural_tpu_torch.ops.snake_conv_variants import (VARIANTS,
                                                            patched_sources)

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)


def _constants(*names: str) -> dict:
    """Integer constants (``constexpr int NAME = expr;``) of the sources, in
    order; an expression may use numbers and the constants before it."""
    out: dict = {}
    for name in names:
        text = (CSRC / name).read_text()
        for key, expr in re.findall(r"constexpr int (\w+) = ([\w\s*+()]+);",
                                    text):
            tokens = re.findall(r"\w+|[*+()]", expr)
            if all(t.isdigit() or t in out or t in "*+()" for t in tokens):
                out[key] = int(eval(" ".join(str(out.get(t, t))
                                             for t in tokens)))
    return out


C = _constants("flash_common.cuh", "flash_hopper.cuh", "snake_conv.cu",
               "alias_free_act.cu")
SOURCE = (CSRC / "snake_conv.cu").read_text()
TM, KC = C["SCH_TM"], C["SCH_KC"]


def _cfg(c: int, blk: int = 0) -> dict:
    """The kernel's block (N, NCONS) for C by ``sch_co_block`` (its widest
    unless ``blk`` is given) and the ``switch`` in ``snake_conv_forward``."""
    blk = blk or co_block(c)
    n, ncons = {768: (256, 3), 384: (128, 3), 128: (128, 1)}[blk]
    threads = ncons * C["WG_THREADS"]
    return {"blk": blk, "n": n, "ncons": ncons, "threads": threads,
            "warps": threads // 32, "stage_bytes": blk * KC * 2}


def _round_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def _plan(c: int, k: int, dil: int, blk: int = 0) -> dict:
    """``sch_plan`` of snake_conv.cu for the forward (the package's
    transcription, which the model's gate asks): Z | ring stages |
    barriers, the activation's scratch in the ring's last stages."""
    return sch_plan(c, k, dil, blk or co_block(c))


def test_plan_transcription_matches_the_kernel():
    """The package's constants and ``sch_plan`` against the source text."""
    from diffbinaural_tpu_torch.ops import snake_conv as sc

    for name in ("SCH_TM", "SCH_KC", "SCH_ZPAD", "SCH_MAX_STAGES",
                 "SCH_XW_MAX", "SCH_RUN_SLACK", "SCH_OUT_ROW",
                 "SCH_BAR_BYTES", "TILE_ALIGN", "MAX_DYNAMIC_SMEM",
                 "WG_THREADS"):
        assert getattr(sc, name) == C[name], name
    body = re.search(r"static bool sch_plan\(int C, int k, int dil, int warps, "
                     r"int stage_bytes,\s+bool act, SchPlan\* p\) \{(.*?)\n\}",
                     SOURCE, re.S).group(1)
    for line in (
            "const int zr = SCH_TM + 2 * hz;",
            "p->z_bytes = round_up(zr * (2 * C + SCH_ZPAD), TILE_ALIGN);",
            "const int avail = MAX_DYNAMIC_SMEM - TILE_ALIGN - p->z_bytes - SCH_BAR_BYTES;",
            "p->stages = avail / stage_bytes;",
            "if (p->stages > SCH_MAX_STAGES) p->stages = SCH_MAX_STAGES;",
            "const int scratch = act ? warps * sch_scratch_floats(zr) * 4 : 0;",
            "p->pre_stages = p->stages - scratch_stages;",
            "return (!act || zr + 10 <= SCH_XW_MAX) && p->stages >= 2 &&"):
        assert line in body, line
    assert "return (zr + 10) + 2 * (zr + 5) + 3 * SCH_RUN_SLACK;" in SOURCE
    assert re.search(r"sch_plan\(C, k, dil, Cfg::WARPS, Cfg::STAGE_BYTES, ACT, &plan\)",
                     SOURCE)
    for blk, (n, ncons) in sc.SCH_BLOCKS.items():
        assert _cfg(blk)["n"] == n and _cfg(blk)["ncons"] == ncons


def test_gate_admits_only_plannable_shapes():
    """Fault C1: every (C, k, d) that the model's gate sends to the fused
    kernels fits the forward's and the dz kernel's plans at every block the
    kernels may pick; C = 1536 is refused at every k <= 7."""
    from diffbinaural_tpu_torch.models.bigvgan import _snake_conv_fusable

    admitted = 0
    for c in range(128, 2049, 128):
        for k in (3, 5, 7, 11):
            for d in (1, 3, 5):
                if not _snake_conv_fusable(c, k, d):
                    continue
                admitted += 1
                blocks = {co_block(c, b, t, 132)
                          for b, t in ((1, 1), (64, 4096))}
                for blk in blocks:
                    for act in (True, False):
                        p = sch_plan(c, k, d, blk, act)
                        assert p["fits"], (c, k, d, blk, act)
                        assert p["bytes"] + C["TILE_ALIGN"] <= C["MAX_DYNAMIC_SMEM"]
    assert admitted > 0
    assert not any(_snake_conv_fusable(1536, k, d)
                   for k in (3, 5, 7) for d in (1, 3, 5))
    assert not _snake_conv_fusable(1152, 7, 5)
    assert not _snake_conv_fusable(1280, 7, 5)


def test_gate_keeps_the_configs_choice():
    """At every AMP convolution of the shipped configs the gate chooses as
    the JAX package's gate (C >= 768, k <= 7): the plan check changes
    nothing there."""
    import json
    from pathlib import Path

    from diffbinaural_tpu_torch.models.bigvgan import _snake_conv_fusable

    seen = 0
    for path in sorted(Path(__file__).resolve().parents[1].glob("configs/*.json")):
        h = json.loads(path.read_text())
        c0 = h["upsample_initial_channel"]
        for i in range(len(h["upsample_rates"])):
            c = c0 // 2 ** (i + 1)
            for k, dils in zip(h["resblock_kernel_sizes"],
                               h["resblock_dilation_sizes"]):
                for d in (*dils, 1):
                    want = c >= 768 and k <= 7 and c % 128 == 0
                    assert _snake_conv_fusable(c, k, d) == want, (path, c, k, d)
                    seen += 1
    assert seen > 0


def test_co_block_matches_the_kernel():
    body = re.search(r"static int sch_co_block\(int C, int B, int T_len, int sms\) \{(.*?)\n\}",
                     SOURCE, re.S).group(1)
    assert "tiles = B * ((T_len + SCH_TM - 1) / SCH_TM)" in body
    assert "if (C % 768 == 0 && 2 * tiles * (C / 768) >= sms) return 768;" in body
    assert "if (C % 384 == 0) return 384;" in body and "return 128;" in body
    for c in range(128, 4096, 128):
        for b, t in ((2, 3444), (16, 256), (1, 40), (2, 1001)):
            tiles = b * -(-t // TM)
            want = (768 if c % 768 == 0 and 2 * tiles * (c // 768) >= 132
                    else 384 if c % 384 == 0 else 128)
            assert co_block(c, b, t, 132) == want, (c, b, t)
    # serving keeps one block per time tile; the stage-2 step's 64 tiles
    # take two groups of 384
    assert co_block(768, 2, 3444, 132) == 768
    assert co_block(768, 16, 256, 132) == 384
    for blk, (n, ncons) in {768: (256, 3), 384: (128, 3), 128: (128, 1)}.items():
        assert re.search(rf"case {blk}:\n\s+return sch_launch<{n}, {ncons}, ACT>",
                         SOURCE) or (blk == 128 and re.search(
                             rf"default:\n\s+return sch_launch<{n}, {ncons}, ACT>",
                             SOURCE))


@pytest.mark.parametrize("c,blk", [(768, 768), (768, 384), (384, 384)])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11])
@pytest.mark.parametrize("dil", [1, 3, 5])
def test_shared_memory_plan_fits(c, blk, k, dil):
    p = _plan(c, k, dil, blk)
    assert p["zr"] + 10 <= C["SCH_XW_MAX"]
    assert p["bytes"] + C["TILE_ALIGN"] <= C["MAX_DYNAMIC_SMEM"]
    assert p["stages"] >= 2 and p["pre_stages"] >= 1
    # the scratch fits the ring stages it borrows until the product starts
    assert p["scratch_off"] + p["scratch"] \
        <= p["z_bytes"] + p["stages"] * p["stage_bytes"]
    # the epilogue's [co][t] rows fit over Z and the ring
    assert p["blk"] * C["SCH_OUT_ROW"] <= p["bytes"] - C["SCH_BAR_BYTES"]
    assert C["SCH_OUT_ROW"] >= 2 * TM and C["SCH_OUT_ROW"] % 4 == 0
    # every tile on a 1024-byte boundary; Z's rows conflict-free for
    # ldmatrix (eight rows 16 bytes apart modulo 128)
    assert p["z_bytes"] % C["TILE_ALIGN"] == 0
    assert p["stage_bytes"] % C["TILE_ALIGN"] == 0
    stride = 2 * c + C["SCH_ZPAD"]
    assert sorted((r * stride) % 128 for r in range(8)) == list(range(0, 128, 16))
    # the serving shapes keep three or more stages in flight
    if c == 768 and blk == 768 and k <= 7:
        assert p["stages"] >= 3


def test_register_plan_fits():
    """Three warpgroups and no producer warpgroup: 384 threads leave each
    168 registers (a fourth warpgroup would cap them at 128, fewer than the
    64 x 256 float32 accumulator's 128 plus its operands)."""
    for blk in (768, 384, 128):
        cfg = _cfg(blk)
        assert cfg["threads"] == cfg["ncons"] * C["WG_THREADS"]
        regs = min(65536 // cfg["threads"] // 8 * 8, 255)
        # the accumulator (64 x N float32 over 128 threads), two A fragments
        # of 4 registers, and room for addresses and barriers
        assert cfg["n"] // 2 + 2 * 4 + 16 <= regs
        assert cfg["n"] // 2 + 2 * 4 + 16 > 65536 // (cfg["threads"] + 128) \
            or blk != 768


# ------------------------------------------------------ K3 transcription

H = _taps().float()   # the 12 taps


def _up(p, odd: bool):
    """2 * the up-FIR of six consecutive x values (last axis)."""
    taps = H[[10, 8, 6, 4, 2, 0]] if odd else H[[11, 9, 7, 5, 3, 1]]
    return 2.0 * (p * taps).sum(-1)


def _snake(y, a, ib):
    return y + ib * torch.sin(a * y) ** 2


def _down(me, mo, i):
    """z at local index i (a tensor of indices) from the two phases."""
    out = 0.0
    for r in range(6):
        out = out + H[2 * r + 1] * me[..., i + r] + H[2 * r] * mo[..., i + r]
    return out


def _activate_tile(xrow, a, ib, t_lo: int, zr: int):
    """``sch_activate`` for one block: Z (zr, C) float32 of bfloat16 values.
    xrow: (C, T) float32.  The window x[t_lo - 5 ...] (unclamped in an
    interior tile: an index outside the row would raise), the lattice from
    it, and in an edge tile the points outside [0, 2T) replaced by mid[0]
    and mid[2T-1], themselves taken from the window."""
    c, t_len = xrow.shape
    nq, xw = zr + 5, zr + 10
    assert xw <= C["SCH_XW_MAX"]
    interior = t_lo >= 5 and t_lo + zr + 5 <= t_len
    t = t_lo - 5 + torch.arange(xw)
    if interior:
        assert t.min() >= 0 and t.max() < t_len
    xs = xrow[:, t.clamp(0, t_len - 1)]                    # (C, xw)
    q = torch.arange(nq)
    win = xs[:, q[:, None] + torch.arange(6)]              # (C, nq, 6)
    me = _snake(_up(win, False), a[:, None], ib[:, None])
    mo = _snake(_up(win, True), a[:, None], ib[:, None])
    if not interior:
        if t_lo <= 2:
            mid0 = _snake(_up(xs[:, 2 - t_lo:8 - t_lo], False), a, ib)
            me = torch.where(t_lo - 2 + q < 0, mid0[:, None], me)
            mo = torch.where(t_lo - 3 + q < 0, mid0[:, None], mo)
        if t_lo + zr + 2 >= t_len:
            i0 = t_len + 2 - t_lo
            mid_last = _snake(_up(xs[:, i0:i0 + 6], True), a, ib)
            me = torch.where(t_lo - 2 + q >= t_len, mid_last[:, None], me)
            mo = torch.where(t_lo - 3 + q >= t_len, mid_last[:, None], mo)
    r = torch.arange(zr)
    z = _down(me, mo, r)                                   # (C, zr)
    tt = t_lo + r
    z = torch.where((tt >= 0) & (tt < t_len), z, torch.zeros(()))
    return z.to(torch.bfloat16).float().T                  # (zr, C)


def _snake_conv_transcribed(x, alpha, beta, weight, bias, dil, blk, n):
    """The bfloat16 kernel's loop at CO_BLK = blk, N = n per warpgroup: per
    (batch, time tile, output block) Z once, then k * C/16 tap-major steps
    of A = Z[16 w + j dil ...] against the step's tile of the blocked
    weight; float32 sums, bias, bfloat16 out."""
    b_sz, c, t_len = x.shape
    k = weight.shape[2]
    hz = (k - 1) // 2 * dil
    zr = TM + 2 * hz
    a, ib = _effective(alpha, beta, True)
    wb = blocked_weight(weight, torch.bfloat16, blk).float()
    c16 = c // KC
    out = torch.zeros(b_sz, c, t_len)
    for bi in range(b_sz):
        xrow = x[bi].float()
        for tb in range(0, t_len, TM):
            z = _activate_tile(xrow, a, ib, tb - hz, zr)
            for grp in range(c // blk):
                for cons in range(blk // n):
                    acc = torch.zeros(TM, n)
                    for s in range(k * c16):
                        j, cc = divmod(s, c16)         # tap-major steps
                        tile = wb[grp, j, cc]          # (blk/8, 2, 8, 8)
                        # B^T[n, kk]: row n of 8-row group n//8, k-half kk//8
                        bt = tile.permute(0, 2, 1, 3).reshape(blk, KC)
                        bt = bt[cons * n:(cons + 1) * n]
                        acc += z[j * dil:j * dil + TM, cc * KC:(cc + 1) * KC] @ bt.T
                    co0 = grp * blk + cons * n
                    res = acc + bias[co0:co0 + n].float()
                    keep = min(TM, t_len - tb)
                    out[bi, co0:co0 + n, tb:tb + keep] = res[:keep].T
    return out


@pytest.mark.parametrize("t_len", [40, 1001, 3444])
@pytest.mark.parametrize("k,dil", [(7, 5), (3, 1)])
def test_snake_conv_loop_matches_plain(t_len, k, dil):
    # small C in two output blocks of two warpgroups each (the split the
    # kernel makes at C = 768 * m), so that the step tiles, the warpgroups'
    # rows and the blocks are all addressed
    c, blk, n = 32, 16, 8
    rng = np.random.default_rng(t_len * 10 + k)
    x = torch.from_numpy(rng.standard_normal((2, c, t_len)).astype(np.float32)
                         ).to(torch.bfloat16)
    alpha = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.3)
    beta = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.3)
    weight = torch.from_numpy((rng.standard_normal((c, c, k)) * 0.1
                               ).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)
    got = _snake_conv_transcribed(x, alpha, beta, weight, bias, dil, blk, n)
    # float32 reference with the activation rounded to bfloat16, as the
    # kernel and the plain version round it: sums in another order, and a
    # rare Z element on the other side of a bfloat16 rounding
    z = alias_free_snake_plain(x, alpha, beta, True).float()
    pad = (k - 1) // 2 * dil
    want32 = F.conv1d(z, weight.float(), bias, padding=pad, dilation=dil)
    scale = want32.abs().max().item()
    assert (got - want32).abs().max().item() <= 1e-3 * scale
    # and the plain version itself, at the card's limit for K3 in bfloat16
    plain = snake_conv_plain(x, alpha, beta, weight, bias, dil, True).float()
    assert (got.to(torch.bfloat16).float() - plain).abs().max().item() \
        <= 2e-2 * plain.abs().max().item()


def test_blocked_weight_tiles_are_contiguous_steps():
    c, k, blk = 768, 3, co_block(768)
    w = torch.arange(c * c * k, dtype=torch.float32).reshape(c, c, k)
    wb = blocked_weight(w, torch.float32)
    assert wb.is_contiguous() and wb.shape == (1, k, c // KC, blk // 8, 2, 8, 8)
    # step 2 C/16 + 5 (tap 2, chunk 5): row n, column kk is w[n, 16*5 + kk, 2]
    tile = wb[0, 2, 5].permute(0, 2, 1, 3).reshape(blk, KC)
    assert torch.equal(tile, w[:, 80:96, 2])
    # the descriptor's offsets: k-halves 128 bytes apart, 8-row groups 256
    assert wb.stride()[4] * 2 == 128 and wb.stride()[3] * 2 == 256


# ------------------------------------------------------ K2 transcription

R = C["AFA_RUN"]


def _afa_runs_transcribed(x, alpha, beta):
    """K2's threads: run i owns flat outputs [R i, R (i+1)); interior runs
    from the unclamped window x[start-5 ...] (read as the kernel's four
    8-value vectors from start-8), edge runs per row touched, with the
    window clamped to that row and the lattice clamp by selection."""
    b_sz, c, t_len = x.shape
    a, ib = _effective(alpha, beta, True)
    flat = x.float().reshape(-1)
    total = flat.numel()
    out = torch.full((total,), float("nan"))
    starts = torch.arange(0, total, R)
    row = starts // t_len
    t0 = starts - row * t_len
    interior = (t0 >= 5) & (t0 + R + 5 <= t_len) & (starts + R + 8 <= total)
    q6 = torch.arange(6)

    def run(xw, t0v, ch, edge, mid0=None, mid_last=None):
        """afa_run<R, edge> on windows xw (n, R + 10); an edge run takes
        mid[0] and mid[2T-1] of its row."""
        av, ibv = a[ch][:, None], ib[ch][:, None]
        qq = torch.arange(R + 5)
        win = xw[:, qq[:, None] + q6]                      # (n, R+5, 6)
        me = _snake(_up(win, False), av, ibv)
        mo = _snake(_up(win, True), av, ibv)
        if edge:
            for i in range(len(t0v)):
                t0i = int(t0v[i])
                m_e, m_o = t0i - 2 + qq, t0i - 3 + qq
                me[i] = torch.where(m_e < 0, mid0, torch.where(
                    m_e >= t_len, mid_last, me[i]))
                mo[i] = torch.where(m_o < 0, mid0, torch.where(
                    m_o >= t_len, mid_last, mo[i]))
        return _down(me, mo, torch.arange(R))              # (n, R)

    s_in = starts[interior]
    if len(s_in):
        vec = flat[(s_in - 8)[:, None] + torch.arange(R + 16)]
        z = run(vec[:, 3:3 + R + 10], t0[interior], row[interior] % c, False)
        out[s_in[:, None] + torch.arange(R)] = z
    for s in starts[~interior].tolist():
        end = min(s + R, total)
        r = s // t_len
        while r * t_len < end:
            rt0 = s - r * t_len
            idx = (rt0 - 5 + torch.arange(R + 10)).clamp(0, t_len - 1)
            xw = flat[r * t_len + idx][None]
            # afa_mid_row<true> at n = 0 and 2T - 1
            first = flat[r * t_len + (torch.arange(6) - 3).clamp(0, t_len - 1)]
            last = flat[r * t_len + (t_len - 3 + torch.arange(6)).clamp(
                0, t_len - 1)]
            ch = r % c
            mid0 = _snake(_up(first, False), a[ch], ib[ch])
            mid_last = _snake(_up(last, True), a[ch], ib[ch])
            z = run(xw, torch.tensor([rt0]), torch.tensor([ch]), True, mid0,
                    mid_last)[0]
            for i in range(R):
                if 0 <= rt0 + i < t_len and s + i < end:
                    out[s + i] = z[i]
            r += 1
    return out.reshape(b_sz, c, t_len)


@pytest.mark.parametrize("t_len", [1, 5, 256, 1001, 13776])
def test_alias_free_runs_match_plain(t_len):
    rng = np.random.default_rng(t_len)
    shape = (2, 3, t_len)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    alpha = torch.from_numpy(rng.standard_normal(3).astype(np.float32) * 0.3)
    beta = torch.from_numpy(rng.standard_normal(3).astype(np.float32) * 0.3)
    got = _afa_runs_transcribed(x, alpha, beta)
    want = alias_free_snake_plain(x, alpha, beta, True)
    assert torch.isfinite(got).all()    # every output written exactly once
    # the card's float32 limit for K2, on every sample
    assert (got - want).abs().max().item() <= 1e-5


def test_alias_free_runs_cover_edges_and_interior():
    # T = 1001 rows are not a multiple of the run: runs straddle rows, and
    # both paths are taken
    t_len, total = 1001, 2 * 3 * 1001
    starts = np.arange(0, total, R)
    t0 = starts % t_len
    interior = (t0 >= 5) & (t0 + R + 5 <= t_len) & (starts + R + 8 <= total)
    straddle = (starts // t_len) != ((np.minimum(starts + R, total) - 1) // t_len)
    assert interior.mean() > 0.9 and straddle.any() and not (interior & straddle).any()


def test_sine_range_reduction():
    """afa_reduce_pi's reduction (K2's sin^2, K2b's sincos) in float32
    (numpy's sine standing in for the hardware one on [-pi/2, pi/2])
    against float64 sin^2 for |u| <= 200."""
    text = (CSRC / "afa_common.cuh").read_text()
    body = text[text.index("float afa_reduce_pi"):]
    inv_pi, pi_a, pi_b = (np.float32(v) for v in re.findall(
        r"(-?\d+\.\d+(?:e-?\d+)?)f", body)[:3])
    u = np.linspace(-200, 200, 400_001, dtype=np.float32)
    kk = np.rint(u * inv_pi).astype(np.float32)
    # each fmaf: the exact product and sum (float64 here), rounded once
    r = (u.astype(np.float64) - kk.astype(np.float64) * np.float64(pi_a)
         ).astype(np.float32)
    r = (r.astype(np.float64) - kk.astype(np.float64) * np.float64(pi_b)
         ).astype(np.float32)
    assert np.abs(r).max() <= np.pi / 2 + 1e-5
    got = np.sin(r.astype(np.float64)) ** 2
    want = np.sin(u.astype(np.float64)) ** 2
    assert np.abs(got - want).max() <= 2e-6


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_applies(name):
    """Every variant of ``ops/snake_conv_variants.py`` still finds the lines
    it replaces, and changes only the library it rebuilds."""
    texts = patched_sources(name)
    shipped = patched_sources("shipped")
    lib = VARIANTS[name][0]
    changed = {f for f in texts if texts[f] != shipped[f]}
    from diffbinaural_tpu_torch.ops._build import KERNELS
    assert changed == {KERNELS[lib][0]}


@pytest.mark.parametrize("name", sorted(afb_variants.VARIANTS))
def test_k2b_variant_applies(name):
    """Every K2b variant of ``ops/alias_free_act_variants.py`` still finds
    the lines it replaces (``tiled``: its own source, kept whole)."""
    text = afb_variants.source(name)
    assert "extern \"C\" int afa_snake_backward(" in text
    assert (text != (CSRC / "alias_free_act_bwd.cu").read_text()) == (
        bool(afb_variants.VARIANTS[name][1]) or name == "tiled")
