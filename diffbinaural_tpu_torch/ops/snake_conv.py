"""Fused anti-aliased snake -> k-tap dilated Conv1d on (B, C, T):

    conv1d_{k, dilation}(down2(snake(up2(x)))) + bias

Replaces the TPU code of ``diffbinaural_tpu/ops/snake_conv.py``:

  * K3, the forward (``fused_snake_conv`` -> ``_fused_forward`` ->
    ``_kernel``): the CUDA kernels in ``csrc/snake_conv.cu`` (bfloat16) and
    ``csrc/snake_conv_f32.cu`` (float32);
  * K3b, the backward (``_core_bwd``, which has no kernel of its own on
    the TPU: it differentiates the activation core and an XLA
    convolution): in bfloat16, recompute the activation with K2, dz by the
    dz kernel (K3's tensor-core block with Z = dy, ``csrc/snake_conv.cu``),
    dx, d alpha, d beta by K2b (``ops/alias_free_act.py``), dW by the dW
    kernel (``csrc/snake_conv_wgrad.cu``) and db = sum of dy; in float32,
    the same with the library's convolution gradients in place of the two
    products (:func:`fused_snake_conv_backward_composed`).

``fused_snake_conv`` ties them together behind a ``torch.autograd.Function``
on the effective snake parameters and the weight-normed kernel; the
weight-norm chain to (v, g) and the exp of the log-scale stay in autograd
outside it.

On this card the forward is bound by operations (2*B*T*k*C^2 FLOP); the
point of the fusion is that the activated tensor never goes to device
memory.  In bfloat16 the kernel is an implicit GEMM on the tensor cores
(``wgmma``): a block activates its 64 time steps plus the convolution's
halo over all input channels once into shared memory, rounded to bfloat16
as the plain version rounds it, and multiplies the k shifted row windows of
it by the weight, streamed in the layout of :func:`blocked_weight`.  In
float32 the same implicit GEMM takes every product as three TF32 products
(split TF32: one TF32 product alone would not meet the float32 checks) over
chunks of 64 input channels, each chunk activated into shared memory as tf32
hi / lo halves and summed in a fresh accumulator; the weight's split is a
pre-pass into a scratch of 2 k C^2 floats.  Rows outside the clip are zeroed
before the taps, so the convolution's zero padding is exact.  Edge semantics of the activation are
those of ``ops.alias_free_act`` (the unfused composition's, on every
sample).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .alias_free_act import (_check_device, _effective, _exp_if, _forward
                             as _act_forward, _needs_grad, aligned,
                             alias_free_snake_plain, check_act_inputs,
                             fused_alias_free_snake_backward)

LANE = 128  # channel counts must be a multiple of this


def snake_conv_eligible(c_in: int, c_out: int, kernel_size: int,
                        stride: int = 1) -> bool:
    """The fused kernel handles square channel counts that are a multiple
    of 128, odd taps, unit stride (the AMP-block configuration)."""
    return (
        c_in == c_out
        and c_in % LANE == 0
        and kernel_size % 2 == 1
        and stride == 1
    )


def snake_conv_plain(x, alpha, beta, weight, bias, dilation: int = 1,
                     logscale: bool = True):
    """Plain PyTorch version: the plain activation, then ``F.conv1d`` with
    zero padding, in x's type."""
    z = alias_free_snake_plain(x, alpha, beta, logscale)
    pad = (weight.shape[2] - 1) // 2 * dilation
    return F.conv1d(z, weight.to(x.dtype), bias.to(x.dtype), padding=pad,
                    dilation=dilation)


def _check_conv(name, x, alpha, beta, weight, bias, dilation) -> int:
    if weight.dim() != 3:
        raise ValueError(f"{name}: weight must be (C, C, k), got "
                         f"{tuple(weight.shape)}")
    c_out, c_in, k = weight.shape
    if (not snake_conv_eligible(c_in, c_out, k) or x.dim() != 3
            or x.shape[1] != c_in):
        # an ineligible shape would silently compute the wrong conv
        raise ValueError(
            f"{name}: ineligible shapes x={tuple(x.shape)} "
            f"weight={tuple(weight.shape)}; check snake_conv_eligible() first"
        )
    check_act_inputs(name, x, alpha, beta)
    if bias.shape != (c_out,):
        raise ValueError(f"{name}: bias must be ({c_out},)")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"{name}: weight/bias must lie on x's device")
    dilation = int(dilation)
    if dilation < 1:
        raise ValueError(f"{name}: dilation must be >= 1")
    _check_device(name, x)
    return dilation


def f32_co_block(c: int) -> int:
    """Output channels per block of the float32 kernel
    (``csrc/snake_conv_f32.cu:scf_co_block``): 192 where C allows, else
    128."""
    return 192 if c % 192 == 0 else LANE


def co_block(c: int, b: int = 0, t: int = 0, sms: int = 0) -> int:
    """Output channels per block of the bfloat16 kernel on (b, c, t) and a
    card of ``sms`` SMs (``csrc/snake_conv.cu:sch_co_block``): all 768 at
    C = 768, so that no output-channel tile recomputes the activation, while
    the grid of 64-step tiles fills at least half the SMs; else 384."""
    tiles = b * -(-t // 64)
    if c % 768 == 0 and 2 * tiles * (c // 768) >= sms:
        return 768
    return 384 if c % 384 == 0 else LANE


# Constants of the bfloat16 kernels' shared-memory plan (csrc/snake_conv.cu,
# csrc/flash_hopper.cuh); tests/test_torch_snake_conv_tiling.py holds them and
# sch_plan below against the sources.
SCH_TM, SCH_KC, SCH_ZPAD, SCH_MAX_STAGES, SCH_XW_MAX = 64, 16, 16, 8, 128
SCH_RUN_SLACK = 3 + 5
SCH_OUT_ROW = 2 * SCH_TM + 4
SCH_BAR_BYTES = 16 * SCH_MAX_STAGES
TILE_ALIGN, MAX_DYNAMIC_SMEM, WG_THREADS = 1024, 232448, 128
# CO_BLK -> (N, NCONS): output channels per warpgroup, warpgroups per block
SCH_BLOCKS = {768: (256, 3), 384: (128, 3), 128: (128, 1)}


def sch_plan(c: int, k: int, dil: int, blk: int, act: bool = True) -> dict:
    """``sch_plan`` of csrc/snake_conv.cu for CO_BLK = ``blk``: Z | ring
    stages | barriers, and whether it fits the card (``fits``).  ``act``:
    the forward, whose activation borrows the ring's last stages as scratch
    and reads an x window of at most SCH_XW_MAX; else the dz kernel, which
    copies dy into Z and needs neither."""
    n, ncons = SCH_BLOCKS[blk]
    warps = ncons * WG_THREADS // 32
    stage = blk * SCH_KC * 2
    zr = SCH_TM + 2 * ((k - 1) // 2 * dil)
    z_bytes = -(-zr * (2 * c + SCH_ZPAD) // TILE_ALIGN) * TILE_ALIGN
    avail = MAX_DYNAMIC_SMEM - TILE_ALIGN - z_bytes - SCH_BAR_BYTES
    stages = min(max(avail, 0) // stage, SCH_MAX_STAGES)
    scratch = (warps * ((zr + 10) + 2 * (zr + 5) + 3 * SCH_RUN_SLACK) * 4
               if act else 0)
    pre = stages - -(-scratch // stage)
    fits = ((not act or zr + 10 <= SCH_XW_MAX) and stages >= 2 and pre >= 1
            and blk * SCH_OUT_ROW <= z_bytes + stages * stage)
    return {"zr": zr, "z_bytes": z_bytes, "stages": stages,
            "pre_stages": pre, "scratch": scratch,
            "scratch_off": z_bytes + pre * stage, "stage_bytes": stage,
            "bytes": z_bytes + stages * stage + SCH_BAR_BYTES, "blk": blk,
            "n": n, "ncons": ncons, "warps": warps, "fits": fits}


def snake_conv_plannable(c: int, k: int, dil: int) -> bool:
    """True when the bfloat16 forward (K3) and dz kernel (K3b) can place
    (C, k, dilation) at every CO_BLK that :func:`co_block` may pick for C
    (it depends on the grid, which is known only at the call)."""
    blocks = {co_block(c, 0, 0, 0), co_block(c, 0, 0, 1)}
    return all(sch_plan(c, k, dil, blk, act)["fits"]
               for blk in blocks for act in (True, False))


def blocked_weight(weight, dtype=torch.bfloat16, blk=None):
    """The (C_out, C_in, k) kernel in the bfloat16 kernel's layout: one
    contiguous tile per (output-channel block, tap, 16 input channels) — the
    kernel's steps in order — each in wgmma's K-major core-matrix order:
    (C/CO_BLK, k, C/16, CO_BLK/8, 2, 8, 8) over (block, tap, chunk, 8-row
    group, k-half, row, column); CO_BLK = ``blk`` or :func:`co_block`."""
    c_out, c_in, k = weight.shape
    blk = blk or co_block(c_out)
    w = weight.reshape(c_out // blk, blk // 8, 8, c_in // 16, 2, 8, k)
    return _copied(w.permute(0, 6, 3, 1, 4, 2, 5), dtype)


def dgrad_blocked_weight(weight, dtype=torch.bfloat16, blk=None):
    """The dz kernel's weight: :func:`blocked_weight`'s layout of
    W^T[ci, co, j] = W[co, ci, j] (the dz kernel reads its taps in reverse
    order, which makes it W~[ci, co, j] = W[co, ci, k-1-j]), from W in one
    copy."""
    c, _, k = weight.shape
    blk = blk or co_block(c)
    w = weight.reshape(c // 16, 2, 8, c // blk, blk // 8, 8, k)
    return _copied(w.permute(3, 6, 0, 4, 1, 5, 2), dtype)


def _copied(view, dtype):
    """A contiguous copy of ``view`` in ``dtype``: one kernel for the cast
    and the relayout."""
    return torch.empty(view.shape, dtype=dtype, device=view.device).copy_(view)


def _forward(x, alpha, beta, weight, bias, dilation: int, logscale: bool):
    """The forward without autograd: the plain version on the CPU, K3 on a
    card (both types on the tensor cores: bfloat16 products, or float32 ones
    as split-TF32 products)."""
    if x.device.type == "cpu":
        return snake_conv_plain(x, alpha, beta, weight, bias, dilation, logscale)
    a, inv_b = _effective(alpha, beta, logscale)
    b, c, t = x.shape
    k = weight.shape[2]
    x = aligned(x)
    bias32 = bias.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:
            sms = torch.cuda.get_device_properties(x.device).multi_processor_count
            w = blocked_weight(weight, blk=co_block(c, b, t, sms))
            code = _build.load("snake_conv").snake_conv_forward(
                x.data_ptr(), a.data_ptr(), inv_b.data_ptr(), w.data_ptr(),
                bias32.data_ptr(), out.data_ptr(), b, c, t, k, dilation, stream)
        else:
            w = weight.float().contiguous()
            # the weight's tf32 hi / lo stages, written by the kernel's pre-pass
            w_split = torch.empty(2 * k * c * c, dtype=torch.float32,
                                  device=x.device)
            code = _build.load("snake_conv_f32").snake_conv_f32_forward(
                x.data_ptr(), a.data_ptr(), inv_b.data_ptr(), w.data_ptr(),
                w_split.data_ptr(), bias32.data_ptr(), out.data_ptr(), b, c, t,
                k, dilation, stream)
    _build.check_launch("fused_snake_conv", code)
    fused_snake_conv.launches += 1
    return out


class _SnakeConvFunction(torch.autograd.Function):
    """K3 forward and K3b backward as one differentiable op on the
    effective snake parameters, the (already weight-normed) kernel and the
    bias.  x, the parameters, the kernel and the bias are saved; the
    activation is recomputed in the backward, as the JAX custom VJP."""

    @staticmethod
    def forward(ctx, x, alpha, beta, weight, bias, dilation):
        ctx.save_for_backward(x, alpha, beta, weight, bias)
        ctx.dilation = dilation
        return _forward(x, alpha, beta, weight, bias, dilation, False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, alpha, beta, weight, bias = ctx.saved_tensors
        grads = fused_snake_conv_backward(x, dy.contiguous(), alpha, beta,
                                          weight, bias, ctx.dilation, False)
        return (*grads, None)


def fused_snake_conv(x, alpha, beta, weight, bias, dilation: int = 1,
                     logscale: bool = True):
    """x: (B, C, T) float32 or bfloat16, contiguous; alpha/beta: (C,) raw
    snake parameters (log-space when ``logscale``); weight: (C, C, k), the
    ``F.conv1d`` layout (out, in, tap), already weight-normed; bias: (C,).
    Returns (B, C, T) in x's type, differentiable with respect to x, alpha,
    beta, weight and bias.  Check :func:`snake_conv_eligible` first:
    anything else raises.  A CUDA tensor launches the kernels (K3; K3b in
    the backward pass) or raises; the plain versions are taken only for a
    tensor on the CPU."""
    dilation = _check_conv("fused_snake_conv", x, alpha, beta, weight, bias,
                           dilation)
    if _needs_grad(x, alpha, beta, weight, bias):
        return _SnakeConvFunction.apply(
            x, _exp_if(alpha, logscale), _exp_if(beta, logscale), weight,
            bias, dilation)
    return _forward(x, alpha, beta, weight, bias, dilation, logscale)


def snake_conv_backward_plain(x, dy, alpha, beta, weight, bias,
                              dilation: int = 1, logscale: bool = True):
    """Plain version of the backward: autograd through
    :func:`snake_conv_plain`.  Returns ``(dx, dalpha, dbeta, dweight,
    dbias)``, each in its input's type."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in
                  (x, alpha, beta, weight, bias)]
        y = snake_conv_plain(*leaves, dilation, logscale)
        return torch.autograd.grad(y, leaves, dy)


def _conv_pad(k: int, dilation: int) -> int:
    return (k - 1) // 2 * dilation


def _check_grad_operands(name, a, *others):
    """(B, C, T) bfloat16 operands of one shape on one card, C a multiple of
    128, contiguous; returns them on 16-byte boundaries."""
    if a.dim() != 3 or a.shape[1] % LANE != 0:
        raise ValueError(f"{name}: expected (B, C, T) with C % {LANE} == 0, "
                         f"got {tuple(a.shape)}")
    if any(o.shape != a.shape or o.dtype != a.dtype or o.device != a.device
           for o in others):
        raise ValueError(f"{name}: the operands must match in shape, type "
                         f"and device")
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {a.dtype}")
    if not all(o.is_contiguous() for o in (a, *others)):
        raise ValueError(f"{name}: operands must be contiguous")
    return [aligned(o) for o in (a, *others)]


def snake_conv_dgrad_plain(dy, weight, dilation: int = 1):
    """Plain version of dz: ``torch.nn.grad.conv1d_input`` in float32, in
    dy's type."""
    return torch.nn.grad.conv1d_input(
        dy.shape, weight.float(), dy.float(),
        padding=_conv_pad(weight.shape[2], dilation),
        dilation=dilation).to(dy.dtype)


def snake_conv_dgrad(dy, weight, dilation: int = 1):
    """dz, the gradient with respect to z of ``conv1d(z, weight)`` (zero
    padding (k-1)/2 * dilation) for the output gradient dy: (B, C, T)
    bfloat16 -> (B, C, T) bfloat16.  On a card K3's tensor-core kernel with
    Z = dy (no activation, no bias) and the weight W~[ci, co, j] = W[co, ci,
    k-1-j] (the gradient of a stride-1 convolution with respect to its input
    is the convolution with channels swapped and taps reversed), laid out by
    :func:`dgrad_blocked_weight`; the plain version only for a tensor on the
    CPU."""
    if dy.device.type == "cpu":
        return snake_conv_dgrad_plain(dy, weight, dilation)
    dy, = _check_grad_operands("snake_conv_dgrad", dy)
    b, c, t = dy.shape
    k = weight.shape[2]
    if weight.shape != (c, c, k) or weight.device != dy.device:
        raise ValueError(f"snake_conv_dgrad: weight must be ({c}, {c}, k) on "
                         f"dy's device, got {tuple(weight.shape)}")
    sms = torch.cuda.get_device_properties(dy.device).multi_processor_count
    w = dgrad_blocked_weight(weight, blk=co_block(c, b, t, sms))
    dz = torch.empty_like(dy)
    with torch.cuda.device(dy.device):
        code = _build.load("snake_conv").snake_conv_dgrad(
            dy.data_ptr(), w.data_ptr(), dz.data_ptr(), b, c, t, k, dilation,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("snake_conv_dgrad", code)
    snake_conv_dgrad.launches += 1
    return dz


WGRAD_BM, WGRAD_BN, WGRAD_BK = 128, 256, 64  # csrc/snake_conv_wgrad.cu


def wgrad_splits(c: int, k: int, b: int, t: int, sms: int,
                 bm: int = WGRAD_BM) -> int:
    """How many slices the dW kernel (tiles of ``bm`` input channels) cuts
    the K = B*T axis into: one where the (tap, ci tile, co tile) tiles fill
    half the SMs or more, else as many as keep the grid within one wave; no
    slice empty."""
    tiles = k * (c // bm) * -(-c // WGRAD_BN)
    n_kt = b * -(-t // WGRAD_BK)
    split = 1 if 2 * tiles >= sms else min(max(1, sms // tiles), n_kt)
    per = -(-n_kt // split)
    return -(-n_kt // per)


def snake_conv_wgrad_plain(z, dy, k: int, dilation: int = 1):
    """Plain version of dW: ``torch.nn.grad.conv1d_weight`` in float32."""
    c = z.shape[1]
    return torch.nn.grad.conv1d_weight(
        z.float(), (c, c, k), dy.float(), padding=_conv_pad(k, dilation),
        dilation=dilation)


def snake_conv_wgrad(z, dy, k: int, dilation: int = 1):
    """dW, the gradient with respect to the (C, C, k) weight of
    ``conv1d(z, weight)`` (zero padding (k-1)/2 * dilation) for the output
    gradient dy: z, dy (B, C, T) bfloat16 -> (C, C, k) float32.  On a card
    the kernels of ``csrc/snake_conv_wgrad.cu`` — z transposed to (B, T, C)
    between (k-1)/2 * dilation zero rows at each end (the product's tap
    shift is then a row coordinate of a tensor map), then the wgmma
    product — with dy's T padded with zeros to a multiple of 8 (its map's
    row stride); the K-split partials are summed here in a fixed order.
    The plain version only for tensors on the CPU."""
    if z.device.type == "cpu":
        return snake_conv_wgrad_plain(z, dy, k, dilation)
    if k % 2 != 1:
        raise ValueError(f"snake_conv_wgrad: odd k only, got {k}")
    z, dy = _check_grad_operands("snake_conv_wgrad", z, dy)
    b, c, t = z.shape
    # scratch for z transposed between (k-1)/2 * dilation zero rows
    zt = z.new_empty((b, t + 2 * _conv_pad(k, dilation), c))
    t8 = -(-t // 8) * 8
    if t8 != t:
        dy = F.pad(dy, (0, t8 - t))
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    split = wgrad_splits(c, k, b, t8, sms)
    part = torch.empty((split, k, c, c), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        code = _build.load("snake_conv_wgrad").snake_conv_wgrad(
            z.data_ptr(), zt.data_ptr(), dy.data_ptr(), part.data_ptr(), b, c,
            t, k, dilation, split, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("snake_conv_wgrad", code)
    snake_conv_wgrad.launches += 1
    dw = part[0] if split == 1 else part.sum(dim=0)   # (k, ci, co)
    return dw.permute(2, 1, 0)


def _check_backward(name, x, dy, alpha, beta, weight, bias, dilation) -> int:
    dilation = _check_conv(name, x, alpha, beta, weight, bias, dilation)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"{name}: dy must match x's shape, type and device")
    if x.device.type != "cpu" and not dy.is_contiguous():
        raise ValueError(f"{name}: dy must be contiguous")
    return dilation


def fused_snake_conv_backward_composed(x, dy, alpha, beta, weight, bias,
                                       dilation: int = 1,
                                       logscale: bool = True):
    """K3b composed of library calls around K2 and K2b: the activation
    recomputed by K2, dz and dW
    by the library's convolution gradients (in x's type with float32
    accumulation), db = sum of dy in float32, and dx, d alpha, d beta by
    K2b.  The float32 route of :func:`fused_snake_conv_backward` on a card
    (on the TPU these gradients are XLA's VJP outside any Pallas kernel,
    ``diffbinaural_tpu/ops/snake_conv.py:_core_bwd``)."""
    dilation = _check_backward("fused_snake_conv_backward_composed", x, dy,
                               alpha, beta, weight, bias, dilation)
    z = _act_forward(x, alpha, beta, logscale)
    w = weight.to(x.dtype)
    pad = _conv_pad(weight.shape[2], dilation)
    dz = torch.nn.grad.conv1d_input(z.shape, w, dy, padding=pad,
                                    dilation=dilation)
    dw = torch.nn.grad.conv1d_weight(z, w.shape, dy, padding=pad,
                                     dilation=dilation)
    dbias = dy.float().sum(dim=(0, 2))
    dx, da, db = fused_alias_free_snake_backward(x, dz.contiguous(), alpha,
                                                 beta, logscale)
    return (dx, da.to(alpha.dtype), db.to(beta.dtype), dw.to(weight.dtype),
            dbias.to(bias.dtype))


def fused_snake_conv_backward(x, dy, alpha, beta, weight, bias,
                              dilation: int = 1, logscale: bool = True):
    """The backward alone: ``(dx, dalpha, dbeta, dweight, dbias)`` for
    ``fused_snake_conv(x, alpha, beta, weight, bias, dilation, logscale)``
    and the output gradient dy ((B, C, T), x's type).  On a card, in
    bfloat16: the activation z recomputed by K2, dz by the dz kernel
    (:func:`snake_conv_dgrad`), dx, d alpha, d beta by K2b, dW by the dW
    kernel (:func:`snake_conv_wgrad`) and db = sum of dy in float32; in
    float32, :func:`fused_snake_conv_backward_composed`.  One call counts
    as one launch of K3b (the kernels it runs count in their own
    wrappers).  The plain version is taken only for tensors that lie on the
    CPU."""
    name = "fused_snake_conv_backward"
    dilation = _check_backward(name, x, dy, alpha, beta, weight, bias,
                               dilation)
    if x.device.type == "cpu":
        return snake_conv_backward_plain(x, dy, alpha, beta, weight, bias,
                                         dilation, logscale)
    if x.dtype != torch.bfloat16:
        grads = fused_snake_conv_backward_composed(
            x, dy, alpha, beta, weight, bias, dilation, logscale)
        fused_snake_conv_backward.launches += 1
        return grads
    z = _act_forward(x, alpha, beta, logscale)
    dz = snake_conv_dgrad(dy, weight, dilation)
    dx, da, db = fused_alias_free_snake_backward(x, dz, alpha, beta, logscale)
    dw = snake_conv_wgrad(z, dy, weight.shape[2], dilation)
    dbias = dy.sum(dim=2, dtype=torch.float32).sum(dim=0)
    fused_snake_conv_backward.launches += 1
    return (dx, da.to(alpha.dtype), db.to(beta.dtype), dw.to(weight.dtype),
            dbias.to(bias.dtype))


fused_snake_conv.launches = 0
fused_snake_conv_backward.launches = 0
snake_conv_dgrad.launches = 0
snake_conv_wgrad.launches = 0
