"""Fused anti-aliased snake activation on (B, C, T):

    2x kaiser-sinc up-FIR -> snake(beta) -> 2x kaiser-sinc down-FIR

Replaces the TPU kernels of ``diffbinaural_tpu/ops/alias_free_act.py``
(``fused_alias_free_snake`` -> ``_fused_forward`` -> ``_fwd_kernel_mxu`` /
``_fwd_kernel``) by ONE CUDA kernel for every channel count
(``csrc/alias_free_act.cu``).

On this card the op is bound by bytes — one read of x, one write of z
against a few dozen FMAs and two sines per sample — so the design keeps the
2x-rate intermediate in shared memory and moves each element once; time is
the contiguous axis, which makes every load and store coalesced.

Edges: the kernel and the plain version both have the semantics of the
unfused composition — x is replicate-padded, and the down-FIR's replicate
padding acts on the 2x-rate signal (a clamped lattice index).  The TPU
kernel instead continues the FIR over the replicated input, which differs
on the outer <= 3 samples; that was a convenience of its tiling, and here
the port equals the JAX package's CPU path on every sample.  The sine is
the exact ``sinf`` (no polynomial stand-in).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..signal.filters import kaiser_sinc_filter1d
from . import _build

RATIO = 2
KSIZE = 12


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


def refuse_gradient(name: str, roadmap_item: str, *tensors) -> None:
    """The kernel has no backward yet: raise when a gradient would have to
    flow through it, instead of returning an output that is cut out of the
    autograd graph.  Serving runs under ``torch.inference_mode()`` and never
    gets here."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in tensors):
        raise RuntimeError(
            f"{name}: a CUDA input or parameter requires grad, and the "
            f"backward kernel is still to be ported (ROADMAP {roadmap_item}); "
            f"call it under torch.inference_mode() or torch.no_grad(), or "
            f"detach the inputs"
        )


def fused_alias_free_snake(x, alpha, beta, logscale: bool = True):
    """x: (B, C, T) float32 or bfloat16, contiguous; alpha/beta: (C,) raw
    snake parameters (log-space when ``logscale``).  Returns (B, C, T) in
    x's type.  A CUDA tensor launches the kernel (or raises); the plain
    version is taken only for a tensor that lies on the CPU.  Forward only:
    on a card it raises when grad is enabled and x, alpha or beta requires
    grad (the plain version on the CPU is differentiable)."""
    check_act_inputs("fused_alias_free_snake", x, alpha, beta)
    if x.device.type == "cpu":
        return alias_free_snake_plain(x, alpha, beta, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_alias_free_snake: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_alias_free_snake: x must be contiguous")
    refuse_gradient("fused_alias_free_snake", "B4", x, alpha, beta)
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


fused_alias_free_snake.launches = 0
