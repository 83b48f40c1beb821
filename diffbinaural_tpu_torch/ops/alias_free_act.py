"""Fused anti-aliased snake activation on (B, C, T):

    2x kaiser-sinc up-FIR -> snake(beta) -> 2x kaiser-sinc down-FIR

Replaces the TPU kernels of ``diffbinaural_tpu/ops/alias_free_act.py`` by
two CUDA kernels that serve every channel count:

  * K2, the forward (``fused_alias_free_snake`` -> ``_fused_forward`` ->
    ``_fwd_kernel_mxu`` / ``_fwd_kernel``): ``csrc/alias_free_act.cu``;
  * K2b, the backward (``_core_bwd`` -> ``_fused_backward`` ->
    ``_bwd_kernel_mxu`` / ``_bwd_kernel``): ``csrc/alias_free_act_bwd.cu``,
    dx and per-(batch, time tile, channel) partial sums of d alpha and
    d beta, summed here (no atomics).

``fused_alias_free_snake`` ties them together behind a
``torch.autograd.Function`` on the effective parameters; the exp of a
log-scale parameter stays outside it in autograd, as in the JAX wrapper.
Only x and the parameters are saved: the backward recomputes the
activation.

On this card both are bound by bytes — K2 reads x and writes z, K2b reads
x and dz and writes dx, against a few dozen FMAs and one or two sines per
sample — so both keep the 2x-rate intermediate in shared memory and move
each element once; time is the contiguous axis, which makes every load and
store coalesced.

Edges: the kernels and the plain versions have the semantics of the
unfused composition — x is replicate-padded, and the down-FIR's replicate
padding acts on the 2x-rate signal (a clamped lattice index) — and the
backward is its exact adjoint, every pad position's gradient added onto the
first / last sample.  The TPU kernels instead continue the FIR over the
replicated input and drop that scatter in the backward, which differs on
the outer few samples; here the port equals the JAX package's CPU path on
every sample.  The sine is the exact ``sinf`` (no polynomial stand-in).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..signal.filters import kaiser_sinc_filter1d
from . import _build

RATIO = 2
KSIZE = 12
BWD_TILE = 512  # samples per block of K2b (csrc/alias_free_act_bwd.cu)


@functools.lru_cache(maxsize=1)
def _taps() -> torch.Tensor:
    return torch.from_numpy(
        kaiser_sinc_filter1d(0.5 / RATIO, 0.6 / RATIO, KSIZE)
    )


def _effective(alpha, beta, logscale: bool):
    """Raw per-channel parameters -> float32 (alpha, 1 / (beta + 1e-9))."""
    alpha = alpha.float()
    beta = beta.float()
    if logscale:
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    return alpha.contiguous(), (1.0 / (beta + 1e-9)).contiguous()


def alias_free_snake_plain(x, alpha, beta, logscale: bool = True):
    """Plain PyTorch version: replicate pad + depthwise transposed conv,
    snake, replicate pad + strided depthwise conv, all in float32; the
    result is cast back to ``x.dtype``."""
    c = x.shape[1]
    a, inv_b = _effective(alpha, beta, logscale)
    taps = _taps().to(x.device).view(1, 1, KSIZE).expand(c, 1, KSIZE)
    x32 = x.float()
    pad = KSIZE // RATIO - 1
    crop_l = pad * RATIO + (KSIZE - RATIO) // 2
    crop_r = pad * RATIO + (KSIZE - RATIO + 1) // 2
    up = RATIO * F.conv_transpose1d(
        F.pad(x32, (pad, pad), mode="replicate"), taps, stride=RATIO, groups=c
    )
    up = up[..., crop_l: up.shape[-1] - crop_r]
    mid = up + inv_b[None, :, None] * torch.sin(up * a[None, :, None]) ** 2
    mid = F.pad(mid, (KSIZE // 2 - 1, KSIZE // 2), mode="replicate")
    return F.conv1d(mid, taps, stride=RATIO, groups=c).to(x.dtype)


def check_act_inputs(name, x, alpha, beta):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, C, T), got {tuple(x.shape)}")
    c = x.shape[1]
    if alpha.shape != (c,) or beta.shape != (c,):
        raise ValueError(
            f"{name}: alpha/beta must be ({c},), got {tuple(alpha.shape)} "
            f"and {tuple(beta.shape)}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if alpha.device != x.device or beta.device != x.device:
        raise ValueError(f"{name}: alpha/beta must lie on x's device")
    if x.shape[0] == 0 or x.shape[2] == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")


def _check_device(name: str, x) -> bool:
    """True for a tensor on the CPU (plain version); False for a contiguous
    CUDA tensor (kernel); raises for anything else."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    return False


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


def _exp_if(a, logscale: bool):
    """The effective snake parameter, in autograd: the exp of a log-scale
    parameter stays outside the autograd Functions, as in the JAX wrapper."""
    return torch.exp(a) if logscale else a


def _forward(x, alpha, beta, logscale: bool):
    """The forward without autograd: the plain version on the CPU, the
    kernel on a card."""
    if _check_device("fused_alias_free_snake", x):
        return alias_free_snake_plain(x, alpha, beta, logscale)
    a, inv_b = _effective(alpha, beta, logscale)
    out = torch.empty_like(x)
    b, c, t = x.shape
    with torch.cuda.device(x.device):
        lib = _build.load("alias_free_act")
        code = lib.afa_snake_forward(
            x.data_ptr(), a.data_ptr(), inv_b.data_ptr(), out.data_ptr(),
            b, c, t, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("fused_alias_free_snake", code)
    fused_alias_free_snake.launches += 1
    return out


class _AliasFreeSnakeFunction(torch.autograd.Function):
    """K2 forward and K2b backward as one differentiable op on the
    EFFECTIVE parameters (alpha, beta).  Only x and the two parameters are
    saved; the backward recomputes the activation, as the JAX custom VJP."""

    @staticmethod
    def forward(ctx, x, alpha, beta):
        ctx.save_for_backward(x, alpha, beta)
        return _forward(x, alpha, beta, False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        x, alpha, beta = ctx.saved_tensors
        dx, da, db = fused_alias_free_snake_backward(
            x, dz.contiguous(), alpha, beta, False)
        return dx, da.to(alpha.dtype), db.to(beta.dtype)


def fused_alias_free_snake(x, alpha, beta, logscale: bool = True):
    """x: (B, C, T) float32 or bfloat16, contiguous; alpha/beta: (C,) raw
    snake parameters (log-space when ``logscale``).  Returns (B, C, T) in
    x's type, differentiable with respect to x, alpha and beta.  A CUDA
    tensor launches the kernels (K2 forward; K2b in the backward pass) or
    raises; the plain versions are taken only for a tensor that lies on the
    CPU."""
    check_act_inputs("fused_alias_free_snake", x, alpha, beta)
    _check_device("fused_alias_free_snake", x)
    if _needs_grad(x, alpha, beta):
        return _AliasFreeSnakeFunction.apply(
            x, _exp_if(alpha, logscale), _exp_if(beta, logscale))
    return _forward(x, alpha, beta, logscale)


def _chain_logscale(da, db, alpha, beta, logscale: bool):
    """Gradients with respect to the effective parameters -> with respect
    to the raw ones (d exp(r) / dr = exp(r))."""
    if logscale:
        return da * torch.exp(alpha.float()), db * torch.exp(beta.float())
    return da, db


def alias_free_snake_backward_plain(x, dz, alpha, beta, logscale: bool = True):
    """Plain version of the backward, the adjoint of
    :func:`alias_free_snake_plain` written out operator by operator in
    float32 (not autograd).  Returns ``(dx, dalpha, dbeta)``: dx in x's
    type, the parameter gradients (C,) float32 with respect to the raw
    parameters given.  The replicate pads' adjoints add every pad
    position's gradient onto the first / last sample (of x) and lattice
    point (of the 2x-rate signal)."""
    c, t = x.shape[1], x.shape[2]
    a, inv_b = _effective(alpha, beta, logscale)
    a, inv_b = a[None, :, None], inv_b[None, :, None]
    taps = _taps().to(x.device).view(1, 1, KSIZE).expand(c, 1, KSIZE)
    pad = KSIZE // RATIO - 1
    crop = pad * RATIO + (KSIZE - RATIO) // 2  # both sides: 15
    dl, dr = KSIZE // 2 - 1, KSIZE // 2         # down-FIR's pad: 5, 6

    # recompute the 2x-rate signal
    up = RATIO * F.conv_transpose1d(
        F.pad(x.float(), (pad, pad), mode="replicate"), taps, stride=RATIO,
        groups=c)
    up = up[..., crop: up.shape[-1] - crop]
    # adjoint of the strided down-FIR, then of its replicate pad
    dmid_p = F.conv_transpose1d(dz.float(), taps, stride=RATIO, groups=c,
                                output_padding=1)      # (B, C, 2T + 11)
    dmid = dmid_p[..., dl: dl + 2 * t].clone()
    dmid[..., 0] += dmid_p[..., :dl].sum(-1)
    dmid[..., -1] += dmid_p[..., dl + 2 * t:].sum(-1)
    # snake: mid = up + inv_b * sin^2(a * up)
    s = torch.sin(a * up)
    s2 = torch.sin(2.0 * a * up)
    dup = dmid * (1.0 + a * s2 * inv_b)
    da = (dmid * up * s2 * inv_b).sum(dim=(0, 2))
    db = (-dmid * s * s * inv_b * inv_b).sum(dim=(0, 2))
    # adjoint of the crop and the transposed up-FIR (x RATIO), then of the
    # replicate pad of x
    dxp = RATIO * F.conv1d(F.pad(dup, (crop, crop)), taps, stride=RATIO,
                           groups=c)                   # (B, C, T + 10)
    dx = dxp[..., pad: pad + t].clone()
    dx[..., 0] += dxp[..., :pad].sum(-1)
    dx[..., -1] += dxp[..., pad + t:].sum(-1)
    da, db = _chain_logscale(da, db, alpha, beta, logscale)
    return dx.to(x.dtype), da, db


def fused_alias_free_snake_backward(x, dz, alpha, beta, logscale: bool = True):
    """The backward alone.  x, dz: (B, C, T) of one type, contiguous;
    alpha/beta: (C,) raw parameters (log-space when ``logscale``).  Returns
    ``(dx, dalpha, dbeta)`` as :func:`alias_free_snake_backward_plain`.  A
    CUDA tensor launches K2b (or raises): one float32 partial per (batch,
    time tile, channel), summed here in a fixed order; the plain version
    is taken only for tensors that lie on the CPU."""
    name = "fused_alias_free_snake_backward"
    check_act_inputs(name, x, alpha, beta)
    if dz.shape != x.shape or dz.dtype != x.dtype or dz.device != x.device:
        raise ValueError(
            f"{name}: dz must match x's shape, type and device, got "
            f"{tuple(dz.shape)} {dz.dtype} on {dz.device}")
    if _check_device(name, x):
        return alias_free_snake_backward_plain(x, dz, alpha, beta, logscale)
    if not dz.is_contiguous():
        raise ValueError(f"{name}: dz must be contiguous")
    a, inv_b = _effective(alpha, beta, logscale)
    b, c, t = x.shape
    n_tiles = -(-t // BWD_TILE)
    dx = torch.empty_like(x)
    da_p = torch.empty((b, n_tiles, c), dtype=torch.float32, device=x.device)
    db_p = torch.empty_like(da_p)
    with torch.cuda.device(x.device):
        lib = _build.load("alias_free_act_bwd")
        code = lib.afa_snake_backward(
            x.data_ptr(), dz.data_ptr(), a.data_ptr(), inv_b.data_ptr(),
            dx.data_ptr(), da_p.data_ptr(), db_p.data_ptr(), b, c, t, n_tiles,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(name, code)
    fused_alias_free_snake_backward.launches += 1
    da, db = _chain_logscale(da_p.sum(dim=(0, 1)), db_p.sum(dim=(0, 1)),
                             alpha, beta, logscale)
    return dx, da, db


fused_alias_free_snake.launches = 0
fused_alias_free_snake_backward.launches = 0
