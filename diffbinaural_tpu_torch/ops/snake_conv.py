"""Fused anti-aliased snake -> k-tap dilated Conv1d on (B, C, T):

    conv1d_{k, dilation}(down2(snake(up2(x)))) + bias

Replaces the TPU kernel of ``diffbinaural_tpu/ops/snake_conv.py``
(``fused_snake_conv`` -> ``_fused_forward`` -> ``_kernel``) by the CUDA
kernel in ``csrc/snake_conv.cu``.

On this card the op is bound by operations (2*B*T*k*C^2 FLOP); the point of
the fusion is that the activated tensor never goes to device memory: each
block activates its time tile (plus the convolution's halo) for 16 input
channels at a time into shared memory and accumulates the k shifted
products from there.  Rows outside the clip are zeroed before the taps, so
the convolution's zero padding is exact.  Edge semantics of the activation
are those of ``ops.alias_free_act`` (the unfused composition's, on every
sample).  This first version computes on the CUDA cores in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .alias_free_act import (_effective, alias_free_snake_plain,
                             check_act_inputs, refuse_gradient)

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


def fused_snake_conv(x, alpha, beta, weight, bias, dilation: int = 1,
                     logscale: bool = True):
    """x: (B, C, T) float32 or bfloat16, contiguous; alpha/beta: (C,) raw
    snake parameters (log-space when ``logscale``); weight: (C, C, k), the
    ``F.conv1d`` layout (out, in, tap), already weight-normed; bias: (C,).
    Returns (B, C, T) in x's type.  Check :func:`snake_conv_eligible`
    first: anything else raises.  A CUDA tensor launches the kernel (or
    raises); the plain version is taken only for a tensor on the CPU.
    Forward only: on a card it raises when grad is enabled and x or a
    parameter requires grad (the plain version on the CPU is
    differentiable)."""
    if weight.dim() != 3:
        raise ValueError(f"fused_snake_conv: weight must be (C, C, k), got "
                         f"{tuple(weight.shape)}")
    c_out, c_in, k = weight.shape
    if (not snake_conv_eligible(c_in, c_out, k) or x.dim() != 3
            or x.shape[1] != c_in):
        # an ineligible shape would silently compute the wrong conv
        raise ValueError(
            f"fused_snake_conv: ineligible shapes x={tuple(x.shape)} "
            f"weight={tuple(weight.shape)}; check snake_conv_eligible() first"
        )
    check_act_inputs("fused_snake_conv", x, alpha, beta)
    if bias.shape != (c_out,):
        raise ValueError(f"fused_snake_conv: bias must be ({c_out},)")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("fused_snake_conv: weight/bias must lie on x's device")
    dilation = int(dilation)
    if dilation < 1:
        raise ValueError("fused_snake_conv: dilation must be >= 1")
    if x.device.type == "cpu":
        return snake_conv_plain(x, alpha, beta, weight, bias, dilation, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_snake_conv: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_snake_conv: x must be contiguous")
    refuse_gradient("fused_snake_conv", "B6", x, alpha, beta, weight, bias)
    a, inv_b = _effective(alpha, beta, logscale)
    # the kernel reads the weight tap-major, (k, C_in, C_out), in x's type
    w = weight.to(x.dtype).permute(2, 1, 0).contiguous()
    bias32 = bias.float().contiguous()
    out = torch.empty_like(x)
    b, c, t = x.shape
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


fused_snake_conv.launches = 0
