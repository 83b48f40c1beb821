"""Fused anti-aliased snake -> k-tap dilated Conv1d on (B, C, T):

    conv1d_{k, dilation}(down2(snake(up2(x)))) + bias

Replaces the TPU code of ``diffbinaural_tpu/ops/snake_conv.py``:

  * K3, the forward (``fused_snake_conv`` -> ``_fused_forward`` ->
    ``_kernel``): the CUDA kernel in ``csrc/snake_conv.cu``;
  * K3b, the backward (``_core_bwd``, which has no kernel of its own on
    the TPU): recompute the activation with K2, take dz and dW from the
    convolution's gradients (library calls, as the JAX code leaves that
    convolution to XLA), db = sum of dy, and dx, d alpha, d beta from K2b
    (``ops/alias_free_act.py``).

``fused_snake_conv`` ties them together behind a ``torch.autograd.Function``
on the effective snake parameters and the weight-normed kernel; the
weight-norm chain to (v, g) and the exp of the log-scale stay in autograd
outside it.

On this card the forward is bound by operations (2*B*T*k*C^2 FLOP); the
point of the fusion is that the activated tensor never goes to device
memory: each block activates its time tile (plus the convolution's halo)
for 16 input channels at a time into shared memory and accumulates the k
shifted products from there.  Rows outside the clip are zeroed before the
taps, so the convolution's zero padding is exact.  Edge semantics of the
activation are those of ``ops.alias_free_act`` (the unfused composition's,
on every sample).  This first version computes on the CUDA cores in
float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .alias_free_act import (_check_device, _effective, _exp_if, _forward
                             as _act_forward, _needs_grad,
                             alias_free_snake_plain, check_act_inputs,
                             fused_alias_free_snake_backward)

LANE = 128  # output channels per block of the kernel


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


def _forward(x, alpha, beta, weight, bias, dilation: int, logscale: bool):
    """The forward without autograd: the plain version on the CPU, K3 on a
    card."""
    if x.device.type == "cpu":
        return snake_conv_plain(x, alpha, beta, weight, bias, dilation, logscale)
    a, inv_b = _effective(alpha, beta, logscale)
    # the kernel reads the weight tap-major, (k, C_in, C_out), in x's type
    w = weight.to(x.dtype).permute(2, 1, 0).contiguous()
    bias32 = bias.float().contiguous()
    out = torch.empty_like(x)
    b, c, t = x.shape
    k = weight.shape[2]
    with torch.cuda.device(x.device):
        lib = _build.load("snake_conv")
        code = lib.snake_conv_forward(
            x.data_ptr(), a.data_ptr(), inv_b.data_ptr(), w.data_ptr(),
            bias32.data_ptr(), out.data_ptr(), b, c, t, k, dilation,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
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


def fused_snake_conv_backward(x, dy, alpha, beta, weight, bias,
                              dilation: int = 1, logscale: bool = True):
    """The backward alone: ``(dx, dalpha, dbeta, dweight, dbias)`` for
    ``fused_snake_conv(x, alpha, beta, weight, bias, dilation, logscale)``
    and the output gradient dy ((B, C, T), x's type).  On a card: the
    activation recomputed by K2, dz and dW by the convolution's gradients
    (library calls, in x's type with float32 accumulation), db = sum of dy
    in float32, and dx, d alpha, d beta by K2b; one call counts as one
    launch of K3b (its K2 and K2b launches count in their own wrappers).
    The plain version is taken only for tensors that lie on the CPU."""
    name = "fused_snake_conv_backward"
    dilation = _check_conv(name, x, alpha, beta, weight, bias, dilation)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"{name}: dy must match x's shape, type and device")
    if x.device.type == "cpu":
        return snake_conv_backward_plain(x, dy, alpha, beta, weight, bias,
                                         dilation, logscale)
    if not dy.is_contiguous():
        raise ValueError(f"{name}: dy must be contiguous")
    z = _act_forward(x, alpha, beta, logscale)
    w = weight.to(x.dtype)
    pad = (weight.shape[2] - 1) // 2 * dilation
    dz = torch.nn.grad.conv1d_input(z.shape, w, dy, padding=pad,
                                    dilation=dilation)
    dw = torch.nn.grad.conv1d_weight(z, w.shape, dy, padding=pad,
                                     dilation=dilation)
    dbias = dy.float().sum(dim=(0, 2))
    dx, da, db = fused_alias_free_snake_backward(x, dz.contiguous(), alpha,
                                                 beta, logscale)
    fused_snake_conv_backward.launches += 1
    return (dx, da.to(alpha.dtype), db.to(beta.dtype), dw.to(weight.dtype),
            dbias.to(bias.dtype))


fused_snake_conv.launches = 0
fused_snake_conv_backward.launches = 0
