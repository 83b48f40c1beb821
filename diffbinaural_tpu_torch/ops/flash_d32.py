"""Flash attention for the UNet's d_head = 32 self-attention on (B, H, N, D):
softmax(q k^T * sm_scale) v, non-causal, no mask, without materialising the
N x N scores — forward, training forward and backward.

Replaces the TPU kernels of ``diffbinaural_tpu/ops/flash_d32.py`` by CUDA
kernels written for this card:

  * ``flash_sdpa`` without a gradient — ``_attn_core`` primal ->
    ``_fwd(save_residuals=False, exp2=True)`` — ``csrc/flash_d32.cu``,
    ``flash_d32_forward`` (float32: ``csrc/flash_d32_f32.cu``);
  * the training forward — ``_attn_core_fwd`` -> ``_fwd(save_residuals=True)``
    — the same kernels with one more output (``flash_d32_forward_lse``):
    ONE float32 per query row, ``lse = m + log(l)`` in base e of the scaled
    scores, in place of the TPU's lane-broadcast ``(l, m)`` pair;
  * the backward — ``_attn_core_bwd`` and the two stock TPU kernels it calls
    — ``csrc/flash_d32_bwd.cu`` (float32: ``csrc/flash_d32_f32_bwd.cu``): a
    row-sum kernel for ``di``, a dk/dv kernel (a block per key tile, looping
    over query tiles) and a dq kernel (a block per query tile, looping over
    key tiles).  No atomics, so the same sums
    in every run.

``flash_sdpa`` ties them together behind a ``torch.autograd.Function``: on a
CUDA tensor it launches the residual-free forward when no gradient is asked
for and the training forward otherwise, and its backward launches the
backward kernels.  The TPU code scales q outside its custom-VJP core; here
``sm_scale`` is applied inside the kernels on the unscaled q, in float32, so
dq and dk each carry one factor of it.

On this card all three are bound by operations: at d = 32 a score costs
64 tensor-core FLOP per product and one ``exp2``, which the kernels take on
the special-function unit, where it is the slower of the two (the two-kernel
backward recomputes s, p and dp: 14 N^2 D FLOP and 2 N^2 exp2 where 10 and
1 are needed).  A block cannot hold a whole K/V panel in shared memory, so
tiles stream through it; scores and statistics are float32; the exponential
is ``exp2`` with ``log2(e)`` folded into the scale.  bfloat16 inputs — what the serving and
training paths run — go through warp-specialised Hopper kernels: a producer
warp keeps a ring of tiles in flight with TMA, three consumer warpgroups
multiply with ``wgmma`` (the probabilities and ``ds`` rounded to bfloat16 for
the second products).  float32 inputs — what the test and stage-1 train CLIs
run, as the JAX CLIs build their UNet in float32 — go through kernels of the
same shape in ``csrc/flash_d32_f32.cu`` and ``csrc/flash_d32_f32_bwd.cu``:
every product is three TF32 products on ``wgmma`` (x = hi + lo, a.b ~
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi: float32 accuracy, where one TF32 product
would not pass the float32 checks), on operands split by a pre-pass into a
scratch that the wrapper allocates (``_scratch``).

Beside each kernel stands its plain PyTorch version (``sdpa_plain``,
``sdpa_plain_with_lse``, ``sdpa_backward_plain``), with dense N x N tensors.
On the CPU ``flash_sdpa`` is ``sdpa_plain`` under autograd.
"""

from __future__ import annotations

import torch

from . import _build

HEAD_DIM = 32


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 inputs (gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def sdpa_plain(q, k, v, sm_scale: float):
    """Plain PyTorch version: softmax((q * scale) k^T, float32) v, with the
    probabilities cast to v's type for the second product."""
    acc = _acc_dtype(q)
    sim = torch.matmul((q * sm_scale).to(acc), k.to(acc).transpose(-1, -2))
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def sdpa_plain_with_lse(q, k, v, sm_scale: float):
    """Plain version of the training forward: ``(o, lse)`` with ``lse`` the
    log-sum-exp (base e) of the scaled scores per query row, (B, H, N),
    float32."""
    acc = _acc_dtype(q)
    sim = torch.matmul((q * sm_scale).to(acc), k.to(acc).transpose(-1, -2))
    lse = torch.logsumexp(sim, dim=-1)
    attn = torch.exp(sim - lse[..., None]).to(v.dtype)
    return torch.matmul(attn, v), lse


def sdpa_backward_plain(q, k, v, o, lse, do, sm_scale: float):
    """Plain version of the backward, written out from the formulas with
    dense N x N tensors (no autograd): ``(dq, dk, dv)`` in q's type, float32
    arithmetic."""
    acc = _acc_dtype(q)
    qf, kf, vf, dof = (a.to(acc) for a in (q, k, v, do))
    p = torch.exp(sm_scale * torch.matmul(qf, kf.transpose(-1, -2))
                  - lse.to(acc)[..., None])
    di = (o.to(acc) * dof).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - di)
    dk = sm_scale * torch.matmul(ds.transpose(-1, -2), qf)
    dq = sm_scale * torch.matmul(ds, kf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(name, q, others):
    """Shape, type and device checks shared by the three wrappers; returns
    True when the tensors lie on the CPU (plain version), False on a card."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, N, D), got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: float32 or bfloat16 only, got {q.dtype}")
    for label, a in others:
        if a.shape != q.shape:
            raise ValueError(
                f"{name}: {label} must have q's shape {tuple(q.shape)}, got "
                f"{tuple(a.shape)}")
        if a.dtype != q.dtype:
            raise TypeError(f"{name}: {label} must have q's dtype {q.dtype}")
        if a.device != q.device:
            raise ValueError(f"{name}: {label} must lie on q's device")
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, h, n, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head dim must be {HEAD_DIM}, got {d}")
    if n == 0 or b * h == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}")
    for label, a in [("q", q), *others]:
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(
                f"{name}: {label} must be contiguous and 16-byte aligned")
    return False


def _check_lse(name, q, lse):
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be float32 {tuple(q.shape[:3])}")
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be contiguous on q's device")


def _stream():
    return torch.cuda.current_stream().cuda_stream


# keys per block of the float32 kernels' transposed operands, rounded up to
# (csrc/flash_f32_hopper.cuh: F32_PAD)
F32_PAD = 64


def _scratch(q, backward: bool):
    """The float32 kernels' scratch on q's device: the hi and lo halves of
    the inputs as rows (q, k; the backward also v, do) and transposed, with
    N padded to F32_PAD (v; the backward q, do, k)."""
    b, h, n, d = q.shape
    n_pad = -(-n // F32_PAD) * F32_PAD
    rows, transposed = (4, 3) if backward else (2, 1)
    floats = 2 * b * h * d * (rows * n + transposed * n_pad)
    return torch.empty(floats, dtype=torch.float32, device=q.device)


def _forward(q, k, v, sm_scale: float, with_lse: bool):
    """One launch of the forward on checked CUDA tensors: ``(o, lse)``, lse
    None without ``with_lse``.  bfloat16 runs ``flash_d32.cu``, float32
    ``flash_d32_f32.cu`` (split-TF32 products) with a scratch for the split
    inputs."""
    b, h, n, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if with_lse:
        args.append(lse.data_ptr())
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            lib = _build.load("flash_d32")
            fn = (lib.flash_d32_forward_lse if with_lse
                  else lib.flash_d32_forward)
        else:
            lib = _build.load("flash_d32_f32")
            scratch = _scratch(q, backward=False)
            args.append(scratch.data_ptr())
            fn = (lib.flash_d32_f32_forward_lse if with_lse
                  else lib.flash_d32_f32_forward)
        code = fn(*args, b * h, n, float(sm_scale), _stream())
    return out, lse, code


def _forward_no_lse(q, k, v, sm_scale: float):
    """The residual-free forward on checked CUDA tensors."""
    out, _, code = _forward(q, k, v, sm_scale, with_lse=False)
    _build.check_launch("flash_sdpa", code)
    flash_sdpa.launches += 1
    return out


def flash_sdpa_with_lse(q, k, v, sm_scale: float):
    """The training forward.  q, k, v: (B, H, N, 32), float32 or bfloat16,
    contiguous.  Returns ``(o, lse)``: o in their type, lse (B, H, N) float32,
    the log-sum-exp (base e) of the scaled scores.  Carries no gradient by
    itself: :func:`flash_sdpa` is the differentiable entry.  A CUDA tensor
    launches the kernel (or raises); the plain version is taken only for
    tensors that lie on the CPU."""
    if _check("flash_sdpa_with_lse", q, [("k", k), ("v", v)]):
        o, lse = sdpa_plain_with_lse(q, k, v, sm_scale)
        return o, lse.float()
    out, lse, code = _forward(q, k, v, sm_scale, with_lse=True)
    _build.check_launch("flash_sdpa_with_lse", code)
    flash_sdpa_with_lse.launches += 1
    return out, lse


def flash_sdpa_backward(q, k, v, o, lse, do, sm_scale: float):
    """The backward.  q, k, v, o, do: (B, H, N, 32) of one type, contiguous;
    lse: (B, H, N) float32 from :func:`flash_sdpa_with_lse`.  Returns
    ``(dq, dk, dv)`` in their type.  One call launches the row-sum, dk/dv
    and dq kernels and counts as one launch.  A CUDA tensor launches the
    kernels (or raises); the plain version is taken only for tensors that
    lie on the CPU."""
    on_cpu = _check("flash_sdpa_backward", q,
                    [("k", k), ("v", v), ("o", o), ("do", do)])
    _check_lse("flash_sdpa_backward", q, lse)
    if on_cpu:
        return sdpa_backward_plain(q, k, v, o, lse, do, sm_scale)
    b, h, n, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    di = torch.empty_like(lse)  # scratch of the kernels: rowsum(o * do)
    ptrs = [a.data_ptr() for a in (q, k, v, o, do, lse, di)]
    grads = [a.data_ptr() for a in (dq, dk, dv)]
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            lib = _build.load("flash_d32_bwd")
            code = lib.flash_d32_backward(*ptrs, *grads, b * h, n,
                                          float(sm_scale), _stream())
        else:
            lib = _build.load("flash_d32_f32_bwd")
            scratch = _scratch(q, backward=True)
            code = lib.flash_d32_f32_backward(
                *ptrs, scratch.data_ptr(), *grads, b * h, n, float(sm_scale),
                _stream())
    _build.check_launch("flash_sdpa_backward", code)
    flash_sdpa_backward.launches += 1
    return dq, dk, dv


class _FlashSdpaFunction(torch.autograd.Function):
    """Training forward and backward kernels as one differentiable op (CUDA
    tensors only).  ``sm_scale`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_sdpa_with_lse(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # do arrives as a transposed view where the heads were merged
        dq, dk, dv = flash_sdpa_backward(q, k, v, o, lse, do.contiguous(),
                                         ctx.sm_scale)
        return dq, dk, dv, None


def flash_sdpa(q, k, v, sm_scale: float):
    """q, k, v: (B, H, N, 32), float32 or bfloat16 (all the same),
    contiguous.  Returns (B, H, N, 32) in their type, differentiable with
    respect to q, k and v.  A CUDA tensor launches the kernels (or raises):
    the residual-free forward when no gradient is asked for, the training
    forward — and, in the backward pass, the backward kernels — otherwise.
    The plain version is taken only for tensors that lie on the CPU."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_sdpa: q, k, v must share one (B, H, N, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if _check("flash_sdpa", q, [("k", k), ("v", v)]):
        return sdpa_plain(q, k, v, sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashSdpaFunction.apply(q, k, v, sm_scale)
    return _forward_no_lse(q, k, v, sm_scale)


flash_sdpa.launches = 0            # residual-free forward launches
flash_sdpa_with_lse.launches = 0   # training forward launches
flash_sdpa_backward.launches = 0   # backward launches (three kernels each)
