"""Attention stack of the stage-1 UNet on channels-last (B, H, W, C)
feature maps — counterpart of ``diffbinaural_tpu/models/attention.py``;
``MaskedAttention`` is the token attention of the visual encoders.

Sub-modules carry the flax names, so converted weights load by a mechanical
walk of the parameter tree.  Parameters are float32; ``dtype`` selects the
compute type; softmax and normalisation statistics stay float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_d32 import HEAD_DIM, flash_sdpa
from .layers import Dense, GroupNormNHWC
from .norms import ChannelLayerNorm

FLASH_MIN_TOKENS = 1024


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H*D) -> (B, H, N, D), head-major channel layout."""
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H*D), head-major."""
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


class TimeFiLM(nn.Module):
    """SiLU -> Linear(time_dim -> dim*2) scale/shift on channels:
    x * (scale + 1) + shift."""

    def __init__(self, dim: int, time_dim: int, dtype=torch.float32):
        super().__init__()
        self.to_scale_shift = Dense(time_dim, dim * 2, dtype=dtype)

    def forward(self, x, time_emb):
        emb = self.to_scale_shift(F.silu(time_emb))
        scale, shift = emb.chunk(2, dim=-1)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (-1,)
        return x * (scale.reshape(shape) + 1.0) + shift.reshape(shape)


def _sdpa(q, k, v, scale: float):
    """Scaled dot-product attention over (B, H, N, D) tokens.

    Sequences of ``FLASH_MIN_TOKENS`` or more with a head dimension of
    ``HEAD_DIM`` (32, the only one the kernels take) go to
    ``ops.flash_sdpa`` (the hand-written kernels on the card, forward and
    backward; the N x N scores are never materialised): bfloat16 passes
    straight through, anything else runs in float32.  Shorter ones, and
    every other head dimension (as the JAX package off the TPU), are the
    dense product with a float32 softmax, differentiated by autograd."""
    if q.shape[2] >= FLASH_MIN_TOKENS and q.shape[3] == HEAD_DIM:
        dt = torch.bfloat16 if v.dtype == torch.bfloat16 else torch.float32
        out = flash_sdpa(
            q.to(dt).contiguous(), k.to(dt).contiguous(),
            v.to(dt).contiguous(), scale,
        )
        return out.to(v.dtype)
    sim = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


class Attention(nn.Module):
    """Full softmax self-attention over the spatial tokens."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 use_time_film: bool = False, time_dim: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        hidden = heads * dim_head
        if use_time_film:
            self.time_film = TimeFiLM(dim, time_dim, dtype=dtype)
        else:
            self.time_film = None
        self.to_qkv = Dense(dim, hidden * 3, bias=False, dtype=dtype)
        self.to_out = Dense(hidden, dim, dtype=dtype)

    def forward(self, x, time_emb=None):
        b, h, w, c = x.shape
        if self.time_film is not None and time_emb is not None:
            x = self.time_film(x, time_emb)
        q, k, v = self.to_qkv(x.reshape(b, h * w, c)).chunk(3, dim=-1)
        q, k, v = (_split_heads(a, self.heads) for a in (q, k, v))
        out = _merge_heads(_sdpa(q, k, v, self.dim_head**-0.5))
        return self.to_out(out).reshape(b, h, w, self.dim)


class LinearAttention(nn.Module):
    """Windowed linear attention.  ``f_window`` batches the last spatial
    axis into blocks of that size, ``t_window`` the first.  Inside a window:
    q softmaxed over the feature axis, k over the token axis, v scaled by
    1/n_tokens, q by d^-1/2; out = (k^T v)^T q."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 f_window: Optional[int] = None,
                 t_window: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.f_window, self.t_window = f_window, t_window
        hidden = heads * dim_head
        self.to_qkv = Dense(dim, hidden * 3, dtype=dtype)
        self.to_out = Dense(hidden, dim, dtype=dtype)
        self.out_norm = ChannelLayerNorm(dim, dtype=dtype)

    def forward(self, x, time_emb=None):
        b0, t, f, c = x.shape
        if self.f_window:
            nw = f // self.f_window
            # (B, T, nw, win, C) -> (B*nw, T, win, C)
            x = x.reshape(b0, t, nw, self.f_window, c)
            x = x.permute(0, 2, 1, 3, 4).reshape(b0 * nw, t, self.f_window, c)
        elif self.t_window:
            nw = t // self.t_window
            x = x.reshape(b0 * nw, self.t_window, f, c)

        b, hh, ww, _ = x.shape
        n = hh * ww
        q, k, v = self.to_qkv(x.reshape(b, n, c)).chunk(3, dim=-1)
        q, k, v = (_split_heads(a, self.heads) for a in (q, k, v))

        q = torch.softmax(q.float(), dim=-1).to(v.dtype)
        k = torch.softmax(k.float(), dim=-2).to(v.dtype)
        q = q * (self.dim_head**-0.5)
        v = v / n

        context = torch.matmul(k.transpose(-1, -2), v)  # (b, h, d, e)
        out = torch.matmul(q, context)                  # (b, h, n, e)
        out = self.out_norm(self.to_out(_merge_heads(out)))
        out = out.reshape(b, hh, ww, self.dim)

        if self.f_window:
            out = out.reshape(b0, nw, t, self.f_window, self.dim)
            out = out.permute(0, 2, 1, 3, 4).reshape(b0, t, f, self.dim)
        elif self.t_window:
            out = out.reshape(b0, t, f, self.dim)
        return out


class LinearAttentionBlock(nn.Module):
    """f-axis + t-axis linear attention, concatenated, then 1x1."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 resolution: int = 4, dtype=torch.float32):
        super().__init__()
        self.f_attn = LinearAttention(dim, heads, dim_head,
                                      f_window=resolution, dtype=dtype)
        self.t_attn = LinearAttention(dim, heads, dim_head,
                                      t_window=resolution, dtype=dtype)
        self.conv_out = Dense(dim * 2, dim, dtype=dtype)

    def forward(self, x):
        return self.conv_out(torch.cat([self.f_attn(x), self.t_attn(x)], dim=-1))


class CrossAttention(nn.Module):
    """Cross-attention to context tokens (B, N_ctx, C_ctx).  The UNet passes
    the single (B, 512) visual feature as ONE token: the softmax over one key
    is 1, so the output is the value projection of that token."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, dtype=torch.float32):
        super().__init__()
        self.query_dim, self.heads, self.dim_head = query_dim, heads, dim_head
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.to_q = Dense(query_dim, inner, dtype=dtype)
        self.to_k = Dense(context_dim, inner, dtype=dtype)
        self.to_v = Dense(context_dim, inner, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x, context=None, mask=None):
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        if context is None:
            context = tokens
        q = _split_heads(self.to_q(tokens), self.heads) * (self.dim_head**-0.5)
        k = _split_heads(self.to_k(context), self.heads)
        v = _split_heads(self.to_v(context), self.heads)

        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if mask is not None:  # (B, N_ctx), True = keep
            sim = sim.masked_fill(~mask[:, None, None, :],
                                  torch.finfo(torch.float32).min)
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = _merge_heads(torch.matmul(attn, v))
        return self.to_out(out).reshape(b, h, w, self.query_dim)


class MaskedAttention(nn.Module):
    """Token self-attention with a key-padding mask, float32: x (B, N, C),
    mask (B, N) with True = a VALID key.  Masked keys get float32's lowest
    value, not -inf, so a row with no valid key softmaxes to uniform
    weights."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.1):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(query_dim, inner, bias=False)
        self.to_v = Dense(query_dim, inner, bias=False)
        self.to_out = Dense(inner, query_dim)
        self.out_drop = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        q = _split_heads(self.to_q(x), self.heads) * (self.dim_head**-0.5)
        k = _split_heads(self.to_k(x), self.heads)
        v = _split_heads(self.to_v(x), self.heads)
        sim = torch.matmul(q, k.transpose(-1, -2))
        if mask is not None:
            sim = sim.masked_fill(~mask[:, None, None, :],
                                  torch.finfo(torch.float32).min)
        out = torch.matmul(torch.softmax(sim, dim=-1), v)
        return self.out_drop(self.to_out(_merge_heads(out)))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2, dtype=dtype)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """1x1 MLP, gated by default.  The GELU is the tanh approximation."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = True,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        inner = int(dim * mult)
        self.glu = glu
        if glu:
            self.geglu = GEGLU(dim, inner, dtype=dtype)
        else:
            self.proj_in = Dense(dim, inner, dtype=dtype)
        self.drop = nn.Dropout(dropout)
        self.proj_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x):
        if self.glu:
            h = self.geglu(x)
        else:
            h = F.gelu(self.proj_in(x), approximate="tanh")
        return self.proj_out(self.drop(h))


class UnifiedAttention(nn.Module):
    """self -> windowed-linear -> cross -> FF, each a pre-LayerNorm
    residual."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 context_dim: Optional[int] = None, resolution: int = 4,
                 dropout: float = 0.0, time_dim: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim, dtype=dtype)
        self.self_attn = Attention(dim, heads, dim_head, use_time_film=True,
                                   time_dim=time_dim, dtype=dtype)
        self.norm2 = ChannelLayerNorm(dim, dtype=dtype)
        self.linear_attn = LinearAttentionBlock(dim, heads, dim_head,
                                                resolution=resolution,
                                                dtype=dtype)
        self.norm3 = ChannelLayerNorm(dim, dtype=dtype)
        self.cross_attn = CrossAttention(dim, context_dim=context_dim,
                                         heads=heads, dim_head=dim_head,
                                         dtype=dtype)
        self.norm4 = ChannelLayerNorm(dim, dtype=dtype)
        self.ff = FeedForward(dim, glu=True, dropout=dropout, dtype=dtype)

    def forward(self, x, context=None, time_emb=None):
        x = self.self_attn(self.norm1(x), time_emb) + x
        x = self.linear_attn(self.norm2(x)) + x
        x = self.cross_attn(self.norm3(x), context=context) + x
        x = self.ff(self.norm4(x)) + x
        return x


class AttentionBlock(nn.Module):
    """GroupNorm -> 1x1 -> UnifiedAttention -> 1x1, plus the residual."""

    def __init__(self, in_channels: int, heads: int = 4, dim_head: int = 32,
                 context_dim: Optional[int] = None, groups: int = 8,
                 dropout: float = 0.0, time_dim: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.gnorm = GroupNormNHWC(groups, in_channels, dtype=dtype)
        self.proj_in = Dense(in_channels, in_channels, dtype=dtype)
        self.transformer = UnifiedAttention(
            in_channels, heads, dim_head, context_dim=context_dim,
            dropout=dropout, time_dim=time_dim, dtype=dtype,
        )
        self.proj_out = Dense(in_channels, in_channels, dtype=dtype)

    def forward(self, x, context=None, time_emb=None):
        x_in = x
        x = self.proj_in(self.gnorm(x))
        # context (B, C_ctx) -> one token (B, 1, C_ctx)
        if context is not None and context.dim() == 2:
            context = context[:, None, :]
        x = self.transformer(x, context=context, time_emb=time_emb)
        return self.proj_out(x) + x_in


class MiddleUnifiedAttention(nn.Module):
    """two self-attentions + FF, no cross-attention."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dropout: float = 0.0, time_dim: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim, dtype=dtype)
        self.self_attn1 = Attention(dim, heads, dim_head, use_time_film=True,
                                    time_dim=time_dim, dtype=dtype)
        self.norm2 = ChannelLayerNorm(dim, dtype=dtype)
        self.self_attn2 = Attention(dim, heads, dim_head, dtype=dtype)
        self.norm3 = ChannelLayerNorm(dim, dtype=dtype)
        self.ff = FeedForward(dim, glu=True, dropout=dropout, dtype=dtype)

    def forward(self, x, time_emb=None):
        x = self.self_attn1(self.norm1(x), time_emb) + x
        x = self.self_attn2(self.norm2(x)) + x
        x = self.ff(self.norm3(x)) + x
        return x


class MiddleAttentionBlock(nn.Module):
    def __init__(self, in_channels: int, heads: int = 4, dim_head: int = 32,
                 groups: int = 8, dropout: float = 0.0,
                 time_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.gnorm = GroupNormNHWC(groups, in_channels, dtype=dtype)
        self.proj_in = Dense(in_channels, in_channels, dtype=dtype)
        self.transformer = MiddleUnifiedAttention(
            in_channels, heads, dim_head, dropout=dropout, time_dim=time_dim,
            dtype=dtype,
        )
        self.proj_out = Dense(in_channels, in_channels, dtype=dtype)

    def forward(self, x, time_emb=None):
        x_in = x
        x = self.proj_in(self.gnorm(x))
        x = self.transformer(x, time_emb=time_emb)
        return self.proj_out(x) + x_in
