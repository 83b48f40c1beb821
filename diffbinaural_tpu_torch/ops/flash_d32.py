"""Flash attention forward for the UNet's d_head = 32 self-attention on
(B, H, N, D):  softmax(q k^T * sm_scale) v, non-causal, no mask, without
materialising the N x N scores.

Replaces the TPU kernel of ``diffbinaural_tpu/ops/flash_d32.py``
(``flash_sdpa`` -> ``_attn_core`` primal -> ``_fwd(save_residuals=False,
exp2=True)`` -> ``_fwd_kernel``) by the CUDA kernel in
``csrc/flash_d32.cu``.

On this card the op is bound by operations (4*B*H*N^2*D FLOP against
4*B*H*N*D elements moved).  A block cannot hold a whole K/V panel in shared
memory, so K/V tiles stream through it with a running max and sum; scores
and statistics are float32; ``sm_scale * log2(e)`` is applied in float32
inside the kernel (the TPU code scales q in q's own type, which rounds a
bfloat16 q once more) and the exponential is ``exp2f``; the output, not the
scores, is normalised.  bfloat16 inputs — what the serving path runs — go
through the tensor cores (``mma.sync``: one warp per 16 query rows, the
probabilities rounded to bfloat16 for the second product); float32 inputs
run on the CUDA cores, one thread per query row.
"""

from __future__ import annotations

import torch

from . import _build

HEAD_DIM = 32


def sdpa_plain(q, k, v, sm_scale: float):
    """Plain PyTorch version: softmax((q * scale) k^T, float32) v, with the
    probabilities cast to v's type for the second product."""
    sim = torch.matmul((q * sm_scale).float(), k.float().transpose(-1, -2))
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def flash_sdpa(q, k, v, sm_scale: float):
    """q, k, v: (B, H, N, 32), float32 or bfloat16 (all the same),
    contiguous.  Returns (B, H, N, 32) in their type.  A CUDA tensor
    launches the kernel (or raises); the plain version is taken only for
    tensors that lie on the CPU."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_sdpa: q, k, v must share one (B, H, N, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_sdpa: float32 or bfloat16 only, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_sdpa: q, k, v must have one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_sdpa: q, k, v must lie on one device")
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_sdpa: unsupported device {q.device}")
    b, h, n, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_sdpa: head dim must be {HEAD_DIM}, got {d}")
    if n == 0 or b * h == 0:
        raise ValueError(f"flash_sdpa: empty input {tuple(q.shape)}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(
                f"flash_sdpa: {name} must be contiguous and 16-byte aligned"
            )
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        lib = _build.load("flash_d32")
        code = lib.flash_d32_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, n, float(sm_scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("flash_sdpa", code)
    flash_sdpa.launches += 1
    return out


flash_sdpa.launches = 0
