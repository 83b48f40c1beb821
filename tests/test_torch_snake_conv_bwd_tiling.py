"""The stage-2 backward kernels' index arithmetic, checked on the CPU: K2b
(``ops/csrc/alias_free_act_bwd.cu``), the dz kernel (``snake_conv.cu``'s
tensor-core block with Z = dy) and the dW kernel (``snake_conv_wgrad.cu``).

The kernels run only on the card.  Their constants are read from the
sources and torch transcriptions of their loops run here: (a) K2b's
register runs — windows, interior vector reads, edge clamps and scatters,
which run owns each lattice point of the d alpha / d beta sums, the warps'
segmented sums into the wrapper's slots — against
``alias_free_snake_backward_plain``; (b) the dz kernel's Z fill (dy, rows
outside the clip zeroed) and its steps over ``blocked_weight`` of the
flipped, transposed kernel against ``conv1d_input``; (c) the dW kernel's
operands (z transposed between zero rows, dy padded), tensor-map boxes
(zero fill outside the tensor), tap shifts as row coordinates, tiles, K
splits and the fixed-order sum against ``conv1d_weight``; (d) the backward
composed of those pieces and K2b's plain version against ``jax.vjp`` of the
JAX package's ``_unfused`` (what ``_core_bwd`` differentiates).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import diffbinaural_tpu.ops.alias_free_act as jax_afa
from diffbinaural_tpu.models.bigvgan import (downsample2_nhc, snake,
                                             upsample2_nhc)
from diffbinaural_tpu.ops.snake_conv import _unfused
from diffbinaural_tpu_torch.ops import alias_free_snake_backward_plain
from diffbinaural_tpu_torch.ops._build import CSRC
from diffbinaural_tpu_torch.ops.alias_free_act import (BWD_RUN, _effective,
                                                       _taps, bwd_pieces)
from diffbinaural_tpu_torch.ops.snake_conv import (SCH_KC, SCH_TM,
                                                   WGRAD_BK, WGRAD_BM,
                                                   WGRAD_BN, blocked_weight,
                                                   co_block,
                                                   dgrad_blocked_weight,
                                                   wgrad_splits)

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

K2B = (CSRC / "alias_free_act_bwd.cu").read_text()
WGRAD = (CSRC / "snake_conv_wgrad.cu").read_text()
H = _taps().float()


def _const(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_constants_match_the_sources():
    assert _const(K2B, "AFB_RUN") == BWD_RUN
    assert (_const(WGRAD, "SCW_BM"), _const(WGRAD, "SCW_BN"),
            _const(WGRAD, "SCW_BK")) == (WGRAD_BM, WGRAD_BN, WGRAD_BK)
    assert "n_pieces != (runs_per_row + 31) / 32 + 1" in K2B


# ------------------------------------------------------------------- K2b

R = BWD_RUN
HE = H[[11, 9, 7, 5, 3, 1]]   # afb_even6
HO = H[[10, 8, 6, 4, 2, 0]]   # afb_odd6


def _k2b_runs(x, dz, alpha, beta):
    """K2b's threads on (B, C, T) float32, raw log-scale parameters.
    Returns dx, d alpha, d beta (raw), and per (row, lattice point) how
    many runs counted it in the sums (each phase)."""
    b, c, t = x.shape
    a, ib = _effective(alpha, beta, True)
    rows = b * c
    X, D = x.reshape(rows, t).float(), dz.reshape(rows, t).float()
    rpr = -(-t // R)
    g = torch.arange(rows * rpr)
    row = g // rpr
    t0 = (g - row * rpr) * R
    interior = (t % 8 == 0) & (t0 >= 6) & (t0 + R + 6 <= t)
    # windows [t0 - 6, t0 + R + 6): the interior from its aligned vectors
    # [t0 - 8, t0 + R + 8) at offset 2, unclamped; the edge clamped (x) or
    # zero outside the row (dz)
    vec = t0[:, None] - 8 + torch.arange(R + 16)
    if interior.any():
        assert vec[interior].min() >= 0 and vec[interior].max() < t
        assert ((row * t + t0 - 8)[interior] % 8 == 0).all()
    p = vec[:, 2:2 + R + 12]
    inside = (p >= 0) & (p < t)
    xw = X[row[:, None], p.clamp(0, t - 1)]
    dw = torch.where(inside, D[row[:, None], p.clamp(0, t - 1)], 0.0)
    av, ibv = a[row % c][:, None], ib[row % c][:, None]

    q = torch.arange(R + 6)
    m = t0[:, None] - 3 + q
    valid = interior[:, None] | ((m >= 0) & (m < t))
    own = (q >= 3) & (q < R + 3) & valid
    six = torch.arange(6)
    ye = 2.0 * (xw[:, q[:, None] + six] * HE).sum(-1)
    dme = (dw[:, q[:, None] + six] * HE).sum(-1)
    yo = 2.0 * (xw[:, q[:, None] + 1 + six] * HO).sum(-1)
    dmo = (dw[:, q[:, None] + 1 + six] * HO).sum(-1)

    def at(i):  # dz[row, i], zero outside the row
        return D[row, i] if 0 <= i < t else torch.zeros(len(row))

    scat_lo = (H[:5].sum() * at(0) + H[:3].sum() * at(1) + H[0] * at(2))
    scat_hi = (H[7:].sum() * at(t - 1) + H[9:].sum() * at(t - 2)
               + H[11] * at(t - 3))
    edge = ~interior[:, None]
    dme = dme + torch.where(edge & (m == 0), scat_lo[:, None], 0.0)
    dmo = dmo + torch.where(edge & (m == t - 1), scat_hi[:, None], 0.0)

    def point(y, dm):  # afb_point: d y, d alpha and d beta terms
        s, co = torch.sin(av * y), torch.cos(av * y)
        s2 = 2.0 * s * co
        return dm * (1.0 + av * ibv * s2), dm * y * s2 * ibv, -dm * ibv * ibv * s * s

    de, pae, pbe = point(ye, dme)
    do, pao, pbo = point(yo, dmo)
    E = torch.where(valid & (q >= 1), de, 0.0)
    O = torch.where(valid & (q <= R + 4), do, 0.0)
    pa = torch.where(own, pae + pao, 0.0).sum(-1)
    pb = torch.where(own, pbe + pbo, 0.0).sum(-1)

    u = torch.arange(R)
    dx = 2.0 * sum(H[11 - 2 * i] * E[:, u + 6 - i] + H[10 - 2 * i] * O[:, u + 5 - i]
                   for i in range(6))
    lo = 2.0 * ((H[7] + H[9] + H[11]) * E[:, 3] + (H[9] + H[11]) * E[:, 4]
                + H[11] * E[:, 5] + (H[8] + H[10]) * O[:, 3] + H[10] * O[:, 4])
    k_hi = t - 1 - m
    ce = torch.where(k_hi == 0, H[3] + H[1], torch.where(k_hi == 1, H[1], 0.0))
    co = torch.where(k_hi == 0, H[4] + H[2] + H[0], torch.where(
        k_hi == 1, H[2] + H[0], torch.where(k_hi == 2, H[0], 0.0)))
    hi = 2.0 * (ce * E + co * O).sum(-1)
    is_edge = ~interior
    dx[:, 0] += torch.where(is_edge & (t0 == 0), lo, 0.0)
    dx += torch.where(is_edge[:, None] & (t0[:, None] + u == t - 1),
                      hi[:, None], 0.0)

    out = torch.full((rows, t), float("nan"))
    tt = t0[:, None] + u
    keep = tt < t
    assert torch.isnan(out[row[:, None].expand_as(tt)[keep], tt[keep]]).all()
    out[row[:, None].expand_as(tt)[keep], tt[keep]] = dx[keep]

    # the warps' segmented sums: a row's lanes in warp w land in slot
    # w - (the warp of the row's first run)
    pieces = bwd_pieces(t)
    slot = g // 32 - (row * rpr) // 32
    assert slot.min() >= 0 and slot.max() < pieces
    # channel-major: slot (c, b, piece)
    flat_slot = ((row % c) * b + row // c) * pieces + slot
    part = torch.zeros(2, c * b * pieces)
    part[0].index_put_((flat_slot,), pa, accumulate=True)
    part[1].index_put_((flat_slot,), pb, accumulate=True)
    da = part[0].view(c, b * pieces).sum(dim=1) * torch.exp(alpha)
    db = part[1].view(c, b * pieces).sum(dim=1) * torch.exp(beta)
    counted = torch.zeros(rows, t, dtype=torch.long)
    mm = m[own]
    counted.index_put_((row[:, None].expand_as(m)[own], mm),
                       torch.ones_like(mm), accumulate=True)
    return out.view(b, c, t), da, db, counted


@pytest.mark.parametrize("t", [7, 40, 256, 1001])
def test_k2b_runs_match_plain(t):
    rng = np.random.default_rng(t)
    shape = (2, 3, t)
    x, dz = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for _ in range(2))
    alpha, beta = (torch.from_numpy(0.3 * rng.standard_normal(3).astype(
        np.float32)) for _ in range(2))
    dx, da, db, counted = _k2b_runs(x, dz, alpha, beta)
    assert torch.isfinite(dx).all()           # every dx written once
    assert (counted == 1).all()               # each lattice point summed once
    want = alias_free_snake_backward_plain(x, dz, alpha, beta, True)
    # the card's float32 limits for K2b: 2e-5 of each gradient's scale
    for got, ref in zip((dx, da, db), want):
        assert (got - ref).abs().max() <= 2e-5 * ref.abs().max()


def _warp_segmented_sums(rows, vals):
    """K2b's reduction over one warp as the kernel runs it: five rounds of
    ``__shfl_down_sync`` (lane i reads lane i + d as it stood before the
    round) adding where the rows agree; then the lanes that start a row
    (lane 0, or a row unlike the lane before) hold their row's sum."""
    v = list(vals)
    for d in (1, 2, 4, 8, 16):
        v = [v[i] + (v[i + d] if i + d < 32 and rows[i + d] == rows[i] else 0)
             for i in range(32)]
    return {rows[i]: v[i] for i in range(32)
            if i == 0 or rows[i - 1] != rows[i]}


def test_k2b_warp_sums_follow_the_rows():
    rng = np.random.default_rng(3)
    for rpr in (1, 3, 16, 32, 40):
        runs = np.arange(64 * 32)
        for w in range(len(runs) // 32):
            g = runs[32 * w:32 * w + 32]
            rows = list(g // rpr)
            vals = rng.integers(-50, 50, 32).tolist()
            heads = _warp_segmented_sums(rows, vals)
            assert set(heads) == set(rows)
            for r, total in heads.items():
                assert total == sum(v for rr, v in zip(rows, vals) if rr == r)
    # an idle tail of lanes carries a row of its own and changes no sum
    rows = [5] * 20 + [2 ** 31 - 1] * 12
    heads = _warp_segmented_sums(rows, list(range(20)) + [0] * 12)
    assert heads[5] == sum(range(20))


def test_k2b_interior_and_edge_runs():
    """At the stage-2 step's T (multiples of 256) most runs are interior;
    a ragged T takes the edge path everywhere; a row of fewer than 32 runs
    shares its warp with the next row."""
    for t, share in ((256, 0.875), (16384, 0.99)):
        t0 = np.arange(0, t, R)
        interior = (t0 >= 6) & (t0 + R + 6 <= t)
        assert interior.mean() >= share
    assert (1001 % 8) and bwd_pieces(256) == 2 and bwd_pieces(16384) == 65


# ------------------------------------------------------------ dz kernel

def _dgrad_transcribed(dy, weight, dil, blk, n):
    """The dz kernel's loop at CO_BLK = blk, N = n per warpgroup: per
    (batch, time tile, group) Z = dy rows [tb - hz, tb + 64 + hz) with the
    rows outside the clip zeroed, then k * C/16 tap-major steps of
    Z[16 w + j dil ...] against the weight tile of step (k-1-j, chunk) of
    ``dgrad_blocked_weight`` (W with channels swapped, taps read in reverse
    order); float32 sums, no bias."""
    b_sz, c, t_len = dy.shape
    k = weight.shape[2]
    hz = (k - 1) // 2 * dil
    zr = SCH_TM + 2 * hz
    wb = dgrad_blocked_weight(weight, torch.float32, blk)
    c16 = c // SCH_KC
    out = torch.zeros(b_sz, c, t_len)
    for bi in range(b_sz):
        for tb in range(0, t_len, SCH_TM):
            rows = tb - hz + torch.arange(zr)
            inside = (rows >= 0) & (rows < t_len)
            z = torch.where(inside[:, None],
                            dy[bi][:, rows.clamp(0, t_len - 1)].T, 0.0)
            for grp in range(c // blk):
                for cons in range(blk // n):
                    acc = torch.zeros(SCH_TM, n)
                    for s in range(k * c16):
                        j, cc = divmod(s, c16)
                        w_step = s + (k - 1 - 2 * j) * c16   # SchStep::w_step
                        tile = wb[grp].reshape(k * c16, *wb.shape[3:])[w_step]
                        tile = tile.permute(0, 2, 1, 3).reshape(blk, SCH_KC)
                        bt = tile[cons * n:(cons + 1) * n]
                        acc += z[j * dil:j * dil + SCH_TM,
                                 cc * SCH_KC:(cc + 1) * SCH_KC] @ bt.T
                    co0 = grp * blk + cons * n
                    keep = min(SCH_TM, t_len - tb)
                    out[bi, co0:co0 + n, tb:tb + keep] = acc[:keep].T
    return out


@pytest.mark.parametrize("t_len", [40, 150])
@pytest.mark.parametrize("k,dil", [(7, 5), (3, 1), (11, 5)])
def test_dgrad_loop_matches_conv1d_input(t_len, k, dil):
    c, blk, n = 32, 16, 8
    rng = np.random.default_rng(t_len + k)
    dy = torch.from_numpy(rng.standard_normal((2, c, t_len)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((c, c, k))).astype(np.float32))
    got = _dgrad_transcribed(dy, w, dil, blk, n)
    want = torch.nn.grad.conv1d_input(dy.shape, w, dy, padding=(k - 1) // 2 * dil,
                                      dilation=dil)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # the identity the kernel rests on: a convolution with channels swapped
    # and taps reversed; and its weight layout is blocked_weight's of W^T
    flipped = F.conv1d(dy, w.transpose(0, 1).flip(2),
                       padding=(k - 1) // 2 * dil, dilation=dil)
    assert (flipped - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(dgrad_blocked_weight(w, torch.float32, blk),
                       blocked_weight(w.transpose(0, 1).contiguous(),
                                      torch.float32, blk))


# ------------------------------------------------------------ dW kernel

def _box(a, inner, row, bi, width, rows):
    """One TMA box of a (B, R, W) tensor map: (rows, width) from row ``row``
    and column ``inner`` of batch bi, zeros outside the tensor."""
    _, r_len, w_len = a.shape
    rr = row + torch.arange(rows)
    ww = inner + torch.arange(width)
    ok = ((rr >= 0) & (rr < r_len))[:, None] & ((ww >= 0) & (ww < w_len))[None]
    return torch.where(ok, a[bi][rr.clamp(0, r_len - 1)][:, ww.clamp(0, w_len - 1)],
                       0.0)


def _wgrad_transcribed(z, dy, k, dil, split, bm=WGRAD_BM, bn=WGRAD_BN,
                       bk=WGRAD_BK):
    """The dW kernel's grid at tiles (bm, bn, bk): its operands — z
    transposed to (B, hz + T + hz, C) between zero rows (the transpose
    kernel), dy padded to a multiple of 8 (the wrapper) — then per block (split, tap, ci tile, co tile) the sum
    over its K steps of A^T (the zt box at row t + j dil: times t + (j -
    (k-1)/2) dil) times B^T (the dy box at time t), stored where co < C;
    the partials summed over the splits in order."""
    b_sz, c, t = z.shape
    hz = (k - 1) // 2 * dil
    zt = torch.zeros(b_sz, t + 2 * hz, c)
    zt[:, hz:hz + t] = z.transpose(1, 2)
    t8 = -(-t // 8) * 8
    dy = F.pad(dy, (0, t8 - t))
    n_tt = -(-t8 // bk)
    n_kt = b_sz * n_tt
    per = -(-n_kt // split)
    assert (split - 1) * per < n_kt            # no split is empty
    part = torch.full((split, k, c, c), float("nan"))
    for s in range(split):
        for j in range(k):
            for ci0 in range(0, c, bm):
                for co0 in range(0, -(-c // bn) * bn, bn):
                    acc = torch.zeros(bm, bn)
                    for kt in range(s * per, min((s + 1) * per, n_kt)):
                        bi, tt = divmod(kt, n_tt)
                        a = _box(zt, ci0, tt * bk + j * dil, bi, bm, bk)
                        bt = _box(dy, tt * bk, co0, bi, bk, bn)
                        acc += a.T @ bt.T
                    cols = min(bn, c - co0)
                    part[s, j, ci0:ci0 + bm, co0:co0 + cols] = acc[:, :cols]
    assert torch.isfinite(part).all()
    dw = part[0] if split == 1 else part.sum(dim=0)
    return dw.permute(2, 1, 0)


@pytest.mark.parametrize("t_len,split", [(40, 1), (150, 2), (150, 5), (37, 3)])
@pytest.mark.parametrize("k,dil", [(7, 5), (3, 1)])
def test_wgrad_tiles_match_conv1d_weight(t_len, split, k, dil):
    # small tiles, a co tile that runs past C, T not a multiple of 8, and
    # uneven K splits
    c = 48
    rng = np.random.default_rng(t_len * split + k)
    z, dy = (torch.from_numpy(rng.standard_normal((2, c, t_len)).astype(
        np.float32)) for _ in range(2))
    got = _wgrad_transcribed(z, dy, k, dil, split, bm=16, bn=32, bk=16)
    want = torch.nn.grad.conv1d_weight(z, (c, c, k), dy,
                                       padding=(k - 1) // 2 * dil, dilation=dil)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_wgrad_splits():
    # the stage-2 step's C = 768 at k = 3: 54 tiles, two splits fill 108
    # SMs; at k = 7 the 126 tiles need none; C = 384, T = 13776: 18 tiles
    assert wgrad_splits(768, 3, 16, 256, 132) == 2
    assert wgrad_splits(768, 7, 16, 256, 132) == 1
    assert wgrad_splits(384, 7, 2, 13776, 132) == 3
    for c, k, b, t in ((128, 3, 2, 40), (384, 11, 2, 13776), (768, 5, 1, 64)):
        split = wgrad_splits(c, k, b, t, 132)
        n_kt = b * -(-t // WGRAD_BK)
        per = -(-n_kt // split)
        assert 1 <= split <= n_kt and (split - 1) * per < n_kt


# ------------------------------------------- the composition vs the JAX VJP

def _cpu_core(x, alpha_eff, beta_eff):
    """The JAX package's CPU composition of the activation (which the port
    equals on every sample; the Pallas kernels' edge differences are
    recorded in test_torch_alias_free_act_grad.py)."""
    return downsample2_nhc(snake(upsample2_nhc(x), alpha_eff, beta_eff))


@pytest.mark.parametrize("d", [1, 5])
@pytest.mark.parametrize("k", [3, 7])
def test_composed_backward_matches_jax_core_bwd(k, d, monkeypatch):
    """dz from the dz kernel's transcription, dx / d alpha / d beta from
    K2b's plain version, dW from the dW kernel's transcription, db = sum of
    dy: against jax.vjp of ``_unfused`` (float32, CPU), 2e-5 of each
    gradient's scale (sums of C*k or B*T float32 terms in another order)."""
    c, t = 128, 40
    rng = np.random.default_rng(10 * k + d)
    x, dy = (rng.standard_normal((2, c, t)).astype(np.float32) for _ in range(2))
    alpha, beta = (np.exp(0.3 * rng.standard_normal(c)).astype(np.float32)
                   for _ in range(2))
    w = (0.05 * rng.standard_normal((c, c, k))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    tx, tdy, ta, tb, tw = (torch.from_numpy(a) for a in (x, dy, alpha, beta, w))

    from diffbinaural_tpu_torch.ops import alias_free_snake_plain
    z = alias_free_snake_plain(tx, ta, tb, False)
    blk = co_block(c)
    dz = _dgrad_transcribed(tdy, tw, d, blk, blk)
    dx, da, db = alias_free_snake_backward_plain(tx, dz, ta, tb, False)
    dw = _wgrad_transcribed(z, tdy, k, d, wgrad_splits(c, k, 2, t, 132))
    got = (dx, da, db, dw, tdy.sum(dim=(0, 2)))

    monkeypatch.setattr(jax_afa, "_core", _cpu_core)
    args = (x.transpose(0, 2, 1), alpha, beta, w.transpose(2, 1, 0), bias)
    _, vjp = jax.vjp(lambda *a: _unfused(*a, d), *(jnp.asarray(a) for a in args))
    gx, ga, gb, gw, gbias = (np.asarray(g) for g in
                             vjp(jnp.asarray(dy.transpose(0, 2, 1))))
    want = (gx.transpose(0, 2, 1), ga, gb, gw.transpose(2, 1, 0), gbias)
    for name, g, ref in zip(("dx", "dalpha", "dbeta", "dW", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max(), err_msg=name)
