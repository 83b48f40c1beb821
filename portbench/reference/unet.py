"""Plain float32 PyTorch reference of the DiffBinaural stage-1 denoiser.

A frozen copy of the architecture the port serves: the conditional 2-D UNet
(dim 64, dim_mults (1, 2, 4), GroupNorm 8, weight-standardised 3x3 convs,
FiLM from the sinusoidal time embedding) with its attention stack (full
softmax self-attention with a time FiLM, windowed linear attention on both
spatial axes, cross-attention to the one visual token, a GEGLU feed-forward).
Feature maps are channels-last (B, H, W, C); parameter names follow the
port's modules so that one state dict loads into both.  Every attention is
the dense product with a float32 softmax: no kernel, no cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Module):
    def __init__(self, dim_in, dim_out, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in))
        self.bias = nn.Parameter(torch.zeros(dim_out)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv2dNHWC(nn.Module):
    def __init__(self, dim_in, dim_out, kernel_size=3):
        super().__init__()
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(
            torch.empty(dim_out, dim_in, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(dim_out))

    def kernel(self):
        return self.weight

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel(), self.bias,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


class WeightStandardizedConv(Conv2dNHWC):
    def kernel(self):
        w = self.weight
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        return (w - mean) * torch.rsqrt(var + 1e-5)


class GroupNormNHWC(nn.Module):
    def __init__(self, groups, dim, eps=1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        b, c = x.shape[0], x.shape[-1]
        xf = x.reshape(b, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
        out = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return out * self.weight + self.bias


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.layer_norm(x, self.g.shape, self.g, None, self.eps)


def split_heads(x, heads):
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).permute(0, 2, 1, 3)


def merge_heads(x):
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


def attention(q, k, v, scale):
    """softmax((q * scale) k^T) v, the N x N scores materialised."""
    return torch.matmul(torch.softmax(torch.matmul(q * scale,
                                                   k.transpose(-1, -2)),
                                      dim=-1), v)


class TimeFiLM(nn.Module):
    def __init__(self, dim, time_dim):
        super().__init__()
        self.to_scale_shift = Dense(time_dim, dim * 2)

    def forward(self, x, time_emb):
        scale, shift = self.to_scale_shift(F.silu(time_emb)).chunk(2, dim=-1)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (-1,)
        return x * (scale.reshape(shape) + 1.0) + shift.reshape(shape)


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, use_time_film=False,
                 time_dim=None):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        hidden = heads * dim_head
        self.time_film = TimeFiLM(dim, time_dim) if use_time_film else None
        self.to_qkv = Dense(dim, hidden * 3, bias=False)
        self.to_out = Dense(hidden, dim)

    def forward(self, x, time_emb=None):
        b, h, w, c = x.shape
        if self.time_film is not None and time_emb is not None:
            x = self.time_film(x, time_emb)
        q, k, v = self.to_qkv(x.reshape(b, h * w, c)).chunk(3, dim=-1)
        q, k, v = (split_heads(a, self.heads) for a in (q, k, v))
        out = merge_heads(attention(q, k, v, self.dim_head ** -0.5))
        return self.to_out(out).reshape(b, h, w, self.dim)


class LinearAttention(nn.Module):
    def __init__(self, dim, heads, dim_head, f_window=None, t_window=None):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.f_window, self.t_window = f_window, t_window
        hidden = heads * dim_head
        self.to_qkv = Dense(dim, hidden * 3)
        self.to_out = Dense(hidden, dim)
        self.out_norm = ChannelLayerNorm(dim)

    def forward(self, x):
        b0, t, f, c = x.shape
        if self.f_window:
            nw = f // self.f_window
            x = x.reshape(b0, t, nw, self.f_window, c)
            x = x.permute(0, 2, 1, 3, 4).reshape(b0 * nw, t, self.f_window, c)
        elif self.t_window:
            nw = t // self.t_window
            x = x.reshape(b0 * nw, self.t_window, f, c)
        b, hh, ww, _ = x.shape
        n = hh * ww
        q, k, v = self.to_qkv(x.reshape(b, n, c)).chunk(3, dim=-1)
        q, k, v = (split_heads(a, self.heads) for a in (q, k, v))
        q = torch.softmax(q, dim=-1) * (self.dim_head ** -0.5)
        k = torch.softmax(k, dim=-2)
        context = torch.matmul(k.transpose(-1, -2), v / n)
        out = self.out_norm(self.to_out(merge_heads(torch.matmul(q, context))))
        out = out.reshape(b, hh, ww, self.dim)
        if self.f_window:
            out = out.reshape(b0, nw, t, self.f_window, self.dim)
            out = out.permute(0, 2, 1, 3, 4).reshape(b0, t, f, self.dim)
        elif self.t_window:
            out = out.reshape(b0, t, f, self.dim)
        return out


class LinearAttentionBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, resolution=4):
        super().__init__()
        self.f_attn = LinearAttention(dim, heads, dim_head, f_window=resolution)
        self.t_attn = LinearAttention(dim, heads, dim_head, t_window=resolution)
        self.conv_out = Dense(dim * 2, dim)

    def forward(self, x):
        return self.conv_out(torch.cat([self.f_attn(x), self.t_attn(x)], -1))


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, heads, dim_head):
        super().__init__()
        self.query_dim, self.heads, self.dim_head = query_dim, heads, dim_head
        inner = heads * dim_head
        self.to_q = Dense(query_dim, inner)
        self.to_k = Dense(context_dim, inner)
        self.to_v = Dense(context_dim, inner)
        self.to_out = Dense(inner, query_dim)

    def forward(self, x, context):
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        q = split_heads(self.to_q(tokens), self.heads)
        k = split_heads(self.to_k(context), self.heads)
        v = split_heads(self.to_v(context), self.heads)
        out = merge_heads(attention(q, k, v, self.dim_head ** -0.5))
        return self.to_out(out).reshape(b, h, w, self.query_dim)


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.geglu = GEGLU(dim, dim * mult)
        self.proj_out = Dense(dim * mult, dim)

    def forward(self, x):
        return self.proj_out(self.geglu(x))


class UnifiedAttention(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim, time_dim):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.self_attn = Attention(dim, heads, dim_head, True, time_dim)
        self.norm2 = ChannelLayerNorm(dim)
        self.linear_attn = LinearAttentionBlock(dim, heads, dim_head)
        self.norm3 = ChannelLayerNorm(dim)
        self.cross_attn = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm4 = ChannelLayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, time_emb):
        x = self.self_attn(self.norm1(x), time_emb) + x
        x = self.linear_attn(self.norm2(x)) + x
        x = self.cross_attn(self.norm3(x), context) + x
        return self.ff(self.norm4(x)) + x


class AttentionBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim, groups, time_dim):
        super().__init__()
        self.gnorm = GroupNormNHWC(groups, dim)
        self.proj_in = Dense(dim, dim)
        self.transformer = UnifiedAttention(dim, heads, dim_head, context_dim,
                                            time_dim)
        self.proj_out = Dense(dim, dim)

    def forward(self, x, context, time_emb):
        h = self.transformer(self.proj_in(self.gnorm(x)),
                             context[:, None, :], time_emb)
        return self.proj_out(h) + x


class MiddleUnifiedAttention(nn.Module):
    def __init__(self, dim, heads, dim_head, time_dim):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.self_attn1 = Attention(dim, heads, dim_head, True, time_dim)
        self.norm2 = ChannelLayerNorm(dim)
        self.self_attn2 = Attention(dim, heads, dim_head)
        self.norm3 = ChannelLayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, time_emb):
        x = self.self_attn1(self.norm1(x), time_emb) + x
        x = self.self_attn2(self.norm2(x)) + x
        return self.ff(self.norm3(x)) + x


class MiddleAttentionBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, groups, time_dim):
        super().__init__()
        self.gnorm = GroupNormNHWC(groups, dim)
        self.proj_in = Dense(dim, dim)
        self.transformer = MiddleUnifiedAttention(dim, heads, dim_head,
                                                  time_dim)
        self.proj_out = Dense(dim, dim)

    def forward(self, x, time_emb):
        h = self.transformer(self.proj_in(self.gnorm(x)), time_emb)
        return self.proj_out(h) + x


class ResnetBlock(nn.Module):
    def __init__(self, dim_in, dim_out, groups, time_emb_dim):
        super().__init__()
        self.norm_in = GroupNormNHWC(groups, dim_in)
        self.conv1 = WeightStandardizedConv(dim_in, dim_out)
        self.norm_mid = GroupNormNHWC(groups, dim_out)
        self.emb_proj = Dense(time_emb_dim, dim_out * 2)
        self.conv2 = WeightStandardizedConv(dim_out, dim_out)
        self.res_conv = Dense(dim_in, dim_out) if dim_in != dim_out else None

    def forward(self, x, time_emb):
        h = self.norm_mid(self.conv1(F.silu(self.norm_in(x))))
        scale, shift = self.emb_proj(F.silu(time_emb)).chunk(2, dim=-1)
        h = h * (scale[:, None, None, :] + 1.0) + shift[:, None, None, :]
        h = self.conv2(F.silu(h))
        return h + (x if self.res_conv is None else self.res_conv(x))


def space_to_depth(x):
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


class Downsample(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = Dense(dim_in * 4, dim_out)

    def forward(self, x):
        return self.proj(space_to_depth(x))


class Upsample(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.conv = Conv2dNHWC(dim_in, dim_out, 3)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, 1).repeat_interleave(2, 2))


class Unet(nn.Module):
    def __init__(self, dim=64, out_dim=2, channels=2, dim_mults=(1, 2, 4),
                 groups=8, heads=4, dim_head=32, context_dim=512):
        super().__init__()
        time_dim = dim * 4
        half = dim // 2
        self.register_buffer("freqs", torch.exp(
            torch.arange(half, dtype=torch.float64)
            * -(math.log(10000.0) / (half - 1))).float(), persistent=False)
        self.time_mlp_1 = Dense(dim, time_dim)
        self.time_mlp_2 = Dense(time_dim, time_dim)
        self.init_conv = Dense(channels + 1, dim)
        dims = [dim] + [dim * m for m in dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        n = len(self.in_out)

        def res(a, b):
            return ResnetBlock(a, b, groups, time_dim)

        def attn(d):
            return AttentionBlock(d, heads, dim_head, context_dim, groups,
                                  time_dim)

        for i, (d_in, d_out) in enumerate(self.in_out):
            setattr(self, f"down_{i}_res", res(d_in, d_in))
            setattr(self, f"down_{i}_attn", attn(d_in))
            setattr(self, f"down_{i}_down", Downsample(d_in, d_out)
                    if i < n - 1 else Conv2dNHWC(d_in, d_out, 3))
        mid = dims[-1]
        self.mid_res1 = res(mid, mid)
        self.mid_attn = MiddleAttentionBlock(mid, heads, dim_head, groups,
                                             time_dim)
        self.mid_res2 = res(mid, mid)
        for i, (d_in, d_out) in enumerate(reversed(self.in_out)):
            setattr(self, f"up_{i}_res", res(d_out + d_in, d_out))
            setattr(self, f"up_{i}_attn", attn(d_out))
            setattr(self, f"up_{i}_up", Upsample(d_out, d_in)
                    if i < n - 1 else Conv2dNHWC(d_out, d_in, 3))
        self.final_res = res(dim * 2, dim)
        self.final_conv = Dense(dim, out_dim)

    def forward(self, x, time, x_self_cond, visual_feat):
        x = torch.cat([x_self_cond, x], dim=1).permute(0, 2, 3, 1)
        args = time.float()[:, None] * self.freqs[None, :]
        t = self.time_mlp_1(torch.cat([torch.sin(args), torch.cos(args)], -1))
        t = self.time_mlp_2(F.gelu(t, approximate="tanh"))
        x = self.init_conv(x)
        r, hs = x, []
        for i in range(len(self.in_out)):
            x = getattr(self, f"down_{i}_res")(x, t)
            x = getattr(self, f"down_{i}_attn")(x, visual_feat, t)
            hs.append(x)
            x = getattr(self, f"down_{i}_down")(x)
        x = self.mid_res2(self.mid_attn(self.mid_res1(x, t), t), t)
        for i in range(len(self.in_out)):
            x = getattr(self, f"up_{i}_res")(torch.cat([x, hs.pop()], -1), t)
            x = getattr(self, f"up_{i}_attn")(x, visual_feat, t)
            x = getattr(self, f"up_{i}_up")(x)
        x = self.final_res(torch.cat([x, r], dim=-1), t)
        return self.final_conv(x).permute(0, 3, 1, 2)


class AudioVisualModel(nn.Module):
    """``model(x, t, (mix, visual_feature))``: the denoiser's call."""

    def __init__(self, dim=64, dim_mults=(1, 2, 4), groups=8, heads=4,
                 dim_head=32, context_dim=512):
        super().__init__()
        self.net_unet = Unet(dim, 2, 2, dim_mults, groups, heads, dim_head,
                             context_dim)

    def forward(self, x, t, mix, visual_feature):
        return self.net_unet(x, t, mix, visual_feature)
