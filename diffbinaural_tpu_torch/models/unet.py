"""Conditional 2D UNet for binaural mel diffusion — counterpart of
``diffbinaural_tpu/models/unet.py``.

  * init 1x1 on cat(self_cond, x) — 3 input channels
  * dims [64, 64, 128, 256] via dim_mults (1, 2, 4)
  * sinusoidal time embedding -> Linear(64->256) -> GELU(tanh) ->
    Linear(256->256)
  * per resolution: [ResnetBlock, AttentionBlock, Downsample]; Downsample is
    2x2 space-to-depth + 1x1, the last stage a 3x3 stride-1 conv instead
  * middle ResnetBlock + MiddleAttentionBlock + ResnetBlock
  * symmetric up path with skip concat; Upsample is nearest x2 + 3x3
  * final ResnetBlock on cat(x, r) + 1x1 out
  * ``mix_t`` is accepted for the call contract and never read.

The public ``forward`` takes (B, C, H, W) and returns (B, out_dim, H, W) in
float32; inside, feature maps are channels-last (B, H, W, C), which is what
the attention stack reshapes to tokens and what a bfloat16 convolution on
the card prefers.  Sub-modules carry the flax names.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import span
from .attention import AttentionBlock, MiddleAttentionBlock
from .layers import Conv2dNHWC, Dense, GroupNormNHWC


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        half = dim // 2
        freqs = torch.exp(
            torch.arange(half, dtype=torch.float64)
            * -(math.log(10000.0) / (half - 1))
        ).float()
        self.register_buffer("freqs", freqs, persistent=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        args = t.float()[..., None] * self.freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class WeightStandardizedConv(Conv2dNHWC):
    """3x3 conv whose kernel is standardised over (in, kh, kw) per output
    channel (eps 1e-5, biased variance), in float32, before the cast to the
    compute type."""

    def kernel(self) -> torch.Tensor:
        w = self.weight
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
        return (w - mean) * torch.rsqrt(var + 1e-5)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> WSConv -> GN, FiLM(time), SiLU -> Dropout -> WSConv,
    plus the (1x1 when the widths differ) residual."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 dropout: float = 0.1, time_emb_dim: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.norm_in = GroupNormNHWC(groups, dim_in, dtype=dtype)
        self.conv1 = WeightStandardizedConv(dim_in, dim_out, dtype=dtype)
        self.norm_mid = GroupNormNHWC(groups, dim_out, dtype=dtype)
        self.emb_proj = (
            Dense(time_emb_dim, dim_out * 2, dtype=dtype)
            if time_emb_dim is not None else None
        )
        self.drop = nn.Dropout(dropout)
        self.conv2 = WeightStandardizedConv(dim_out, dim_out, dtype=dtype)
        self.res_conv = (
            Dense(dim_in, dim_out, dtype=dtype) if dim_in != dim_out else None
        )

    def forward(self, x, time_emb=None):
        h = self.conv1(F.silu(self.norm_in(x)))
        h = self.norm_mid(h)
        if self.emb_proj is not None and time_emb is not None:
            emb = self.emb_proj(F.silu(time_emb))
            scale, shift = emb.chunk(2, dim=-1)
            h = h * (scale[:, None, None, :] + 1.0) + shift[:, None, None, :]
        h = self.conv2(self.drop(F.silu(h)))
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 2h, 2w, C) -> (B, h, w, 4C) with the channel order (c p1 p2)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (b, h/2, w/2, c, p1, p2)
    return x.reshape(b, h // 2, w // 2, c * 4)


class Downsample(nn.Module):
    """space-to-depth + 1x1."""

    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim_in * 4, dim_out, dtype=dtype)

    def forward(self, x):
        return self.proj(space_to_depth(x))


class Upsample(nn.Module):
    """nearest x2 + 3x3 conv."""

    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2dNHWC(dim_in, dim_out, 3, dtype=dtype)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)


class Unet(nn.Module):
    """The stage-1 denoiser."""

    def __init__(self, dim: int = 64, out_dim: int = 2, channels: int = 2,
                 dim_mults: Sequence[int] = (1, 2, 4),
                 self_condition: bool = True, resnet_block_groups: int = 8,
                 attn_heads: int = 4, attn_dim_head: int = 32,
                 context_dim: int = 512, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.self_condition = self_condition
        time_dim = dim * 4
        groups = resnet_block_groups
        in_ch = channels + (1 if self_condition else 0)

        self.sinu_pos_emb = SinusoidalPosEmb(dim)
        self.time_mlp_1 = Dense(dim, time_dim, dtype=dtype)
        self.time_mlp_2 = Dense(time_dim, time_dim, dtype=dtype)
        self.init_conv = Dense(in_ch, dim, dtype=dtype)

        dims = [dim] + [dim * m for m in dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        n_res = len(self.in_out)

        def res(d_in, d_out):
            return ResnetBlock(d_in, d_out, groups=groups, dropout=dropout,
                               time_emb_dim=time_dim, dtype=dtype)

        def attn(d):
            return AttentionBlock(d, heads=attn_heads, dim_head=attn_dim_head,
                                  context_dim=context_dim, groups=groups,
                                  time_dim=time_dim, dtype=dtype)

        for i, (d_in, d_out) in enumerate(self.in_out):
            setattr(self, f"down_{i}_res", res(d_in, d_in))
            setattr(self, f"down_{i}_attn", attn(d_in))
            down = (Downsample(d_in, d_out, dtype=dtype) if i < n_res - 1
                    else Conv2dNHWC(d_in, d_out, 3, dtype=dtype))
            setattr(self, f"down_{i}_down", down)

        mid = dims[-1]
        self.mid_res1 = res(mid, mid)
        self.mid_attn = MiddleAttentionBlock(
            mid, heads=attn_heads, dim_head=attn_dim_head, groups=groups,
            time_dim=time_dim, dtype=dtype)
        self.mid_res2 = res(mid, mid)

        for i, (d_in, d_out) in enumerate(reversed(self.in_out)):
            setattr(self, f"up_{i}_res", res(d_out + d_in, d_out))
            setattr(self, f"up_{i}_attn", attn(d_out))
            up = (Upsample(d_out, d_in, dtype=dtype) if i < n_res - 1
                  else Conv2dNHWC(d_out, d_in, 3, dtype=dtype))
            setattr(self, f"up_{i}_up", up)

        self.final_res = res(dim * 2, dim)
        self.final_conv = Dense(dim, out_dim, dtype=dtype)

    def forward(self, x, time, x_self_cond=None, mix_t=None, visual_feat=None):
        """x: (B, C, H, W); time: (B,); x_self_cond: (B, 1, H, W) mono mel;
        visual_feat: (B, context_dim).  Returns (B, out_dim, H, W) float32."""
        del mix_t
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x[:, :1])
            x = torch.cat([x_self_cond.to(x.dtype), x], dim=1)
        x = x.permute(0, 2, 3, 1).to(self.dtype)

        t = self.time_mlp_1(self.sinu_pos_emb(time))
        t = self.time_mlp_2(F.gelu(t, approximate="tanh"))

        x = self.init_conv(x)
        r = x
        hs = []
        for i in range(len(self.in_out)):
            x = getattr(self, f"down_{i}_res")(x, t)
            x = getattr(self, f"down_{i}_attn")(x, context=visual_feat,
                                                time_emb=t)
            hs.append(x)
            x = getattr(self, f"down_{i}_down")(x)

        x = self.mid_res1(x, t)
        x = self.mid_attn(x, time_emb=t)
        x = self.mid_res2(x, t)

        for i in range(len(self.in_out)):
            x = torch.cat([x, hs.pop()], dim=-1)
            x = getattr(self, f"up_{i}_res")(x, t)
            x = getattr(self, f"up_{i}_attn")(x, context=visual_feat,
                                              time_emb=t)
            x = getattr(self, f"up_{i}_up")(x)

        x = torch.cat([x, r], dim=-1)
        x = self.final_res(x, t)
        x = self.final_conv(x)
        return x.permute(0, 3, 1, 2).float()


class AudioVisualModel(nn.Module):
    """``model(x, t, condition)`` with condition = (mix, visual_feature,
    mix_t): the call contract the diffusion engine uses."""

    def __init__(self, dim: int = 64, input_nc: int = 2, output_nc: int = 2,
                 dropout: float = 0.1, dtype=torch.float32, **unet_kwargs):
        super().__init__()
        self.net_unet = Unet(dim=dim, out_dim=output_nc, channels=input_nc,
                             self_condition=True, dropout=dropout, dtype=dtype,
                             **unet_kwargs)

    def forward(self, x, t, condition):
        mix, visual_feature, mix_t = condition
        with span("unet"):
            return self.net_unet(x, t, x_self_cond=mix, mix_t=mix_t,
                                 visual_feat=visual_feature)
