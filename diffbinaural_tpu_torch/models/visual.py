"""Visual conditioning encoders — counterpart of
``diffbinaural_tpu/models/visual.py``.

Every encoder takes per-frame (and per-source) images plus, where it uses
them, source positions and a source mask, and returns the (B, 512) feature
that the UNet's cross-attention reads:

  * ``CLIPVisionTransformer`` — the ViT-B/32 image tower; frozen: it runs
    under ``torch.no_grad()`` inside every encoder (the JAX package's
    ``stop_gradient``), so its parameters get no gradient;
  * ``ClipEncoder`` — CLIP per frame, a transformer encoder layer, mean over
    time;
  * ``ClipPos`` — 3-D (distance, elevation, azimuth) sinusoidal FiLM;
  * ``ClipPos2D`` — the default encoder: elevation / azimuth sinusoidal
    embeddings -> scale / shift FiLM, masked source attention + FF, max over
    ALL sources (padded ones included, as the reference does), temporal
    encoder layer, mean over time;
  * ``ClipPos2DConcat`` — (elevation, azimuth) concatenated, 514 -> 512;
  * ``ClipPos2DEnhanced`` — 514-token projection, source transformer, set
    aggregation, temporal transformer with a sinusoidal time encoding,
    masked mean or attentive pool, final projection and normalisation;
  * ``ResnetEncoder`` — frozen ResNet-18 trunk (BatchNorm as a frozen
    affine map) + a torch-style transformer encoder and decoder layer;
  * ``CLIPTextTransformer`` and ``CLIPModel`` — CLIP's text tower and both
    towers under one tree.

Masks: True = an INVALID (padded) source.  Everything computes in float32;
LayerNorm epsilon is 1e-5 throughout; every ``gelu`` is the tanh
approximation (flax's ``nn.gelu``), ``quick_gelu`` is CLIP's own.
Sub-modules carry the flax names, so ``convert.visual_params_from_flax``
loads a JAX tree by one walk.  Dropout follows the module's mode: the
models come out of ``build_visual`` in ``eval()``, and the stage-1 train
step applies them with dropout off, as the JAX step does.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import CLIPConfig, CLIPTextConfig
from ..core.device import resolve_device
from .attention import MaskedAttention, _merge_heads, _split_heads
from .layers import Dense, lecun_normal_
from .unet import SinusoidalPosEmb

NEG = torch.finfo(torch.float32).min
gelu = partial(F.gelu, approximate="tanh")


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


# ---------------------------------------------------------------------------
# torch-style transformer encoder layer
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``'s arithmetic with separate
    ``q_proj`` / ``k_proj`` / ``v_proj`` / ``out_proj`` (the flax names);
    ``key_padding_mask`` True = PAD, ``attn_mask`` an additive (N_q, N_k)
    float mask.  A row whose keys are all padded gets uniform weights, not
    NaN (callers overwrite such rows)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q_proj = Dense(dim, dim)
        self.k_proj = Dense(dim, dim)
        self.v_proj = Dense(dim, dim)
        self.out_proj = Dense(dim, dim)
        self.attn_drop = nn.Dropout(dropout)

    def forward(self, q, k, v, key_padding_mask=None, attn_mask=None):
        d = self.dim // self.num_heads
        qh = _split_heads(self.q_proj(q), self.num_heads)
        kh = _split_heads(self.k_proj(k), self.num_heads)
        vh = _split_heads(self.v_proj(v), self.num_heads)
        sim = torch.matmul(qh * d**-0.5, kh.transpose(-1, -2))
        if attn_mask is not None:
            sim = sim + attn_mask
        if key_padding_mask is not None:
            sim = sim.masked_fill(key_padding_mask[:, None, None, :], NEG)
            all_pad = key_padding_mask.all(dim=-1)[:, None, None, None]
            sim = sim.masked_fill(all_pad, 0.0)
        attn = self.attn_drop(torch.softmax(sim, dim=-1))
        return self.out_proj(_merge_heads(torch.matmul(attn, vh)))


class TransformerEncoderLayer(nn.Module):
    """``torch.nn.TransformerEncoderLayer``: attention + MLP, post-norm, or
    pre-norm when ``norm_first`` (the Enhanced encoder)."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_dim: int = 2048,
                 dropout: float = 0.1, norm_first: bool = False,
                 activation: str = "relu"):
        super().__init__()
        self.norm_first = norm_first
        self.act = F.relu if activation == "relu" else gelu
        self.self_attn = MultiHeadAttention(dim, num_heads, dropout)
        self.norm1 = _layer_norm(dim)
        self.norm2 = _layer_norm(dim)
        self.linear1 = Dense(dim, ffn_dim)
        self.linear2 = Dense(ffn_dim, dim)
        self.drop1 = nn.Dropout(dropout)
        self.drop2 = nn.Dropout(dropout)
        self.ff_drop = nn.Dropout(dropout)

    def _ff(self, h):
        return self.linear2(self.ff_drop(self.act(self.linear1(h))))

    def forward(self, x, key_padding_mask=None):
        if self.norm_first:
            h = self.norm1(x)
            x = x + self.drop1(self.self_attn(h, h, h, key_padding_mask))
            return x + self.drop2(self._ff(self.norm2(x)))
        x = self.norm1(x + self.drop1(self.self_attn(x, x, x,
                                                     key_padding_mask)))
        return self.norm2(x + self.drop2(self._ff(x)))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, dim: int, num_heads: int = 8,
                 ffn_dim: int = 2048, dropout: float = 0.1,
                 norm_first: bool = False):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer_{i}", TransformerEncoderLayer(
                dim, num_heads, ffn_dim, dropout, norm_first))

    def forward(self, x, key_padding_mask=None):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_padding_mask)
        return x


# ---------------------------------------------------------------------------
# CLIP ViT-B/32 towers
# ---------------------------------------------------------------------------


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = _layer_norm(width)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = _layer_norm(width)
        self.mlp_c_fc = Dense(width, width * 4)
        self.mlp_c_proj = Dense(width * 4, width)

    def forward(self, x, attn_mask=None):
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, attn_mask=attn_mask)
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))


class CLIPVisionTransformer(nn.Module):
    """CLIP's ``encode_image``: (B, 3, H, W) CLIP-preprocessed -> (B,
    output_dim).  Patch convolution (stride = patch, no padding), class
    token + learned position embedding, pre / post LayerNorm, QuickGELU
    MLPs, ``x @ proj`` at the class token."""

    def __init__(self, config: CLIPConfig = CLIPConfig()):
        super().__init__()
        c = self.config = config
        grid = (c.image_size // c.patch_size) ** 2
        self.conv1 = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c.width))
        self.positional_embedding = nn.Parameter(torch.empty(grid + 1, c.width))
        self.ln_pre = _layer_norm(c.width)
        for i in range(c.layers):
            setattr(self, f"resblock_{i}", CLIPResidualBlock(c.width, c.heads))
        self.ln_post = _layer_norm(c.width)
        self.proj = nn.Parameter(torch.empty(c.width, c.output_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.conv1(images.float()).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        for i in range(self.config.layers):
            x = getattr(self, f"resblock_{i}")(x)
        return self.ln_post(x[:, 0]) @ self.proj


class CLIPTextTransformer(nn.Module):
    """CLIP's ``encode_text``: token ids (B, n) -> (B, output_dim).  Causal
    mask of float32's lowest value above the diagonal; the feature is read
    at each row's end-of-text token, the row's largest id."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        c = self.config = config
        self.token_embedding = nn.Parameter(torch.empty(c.vocab_size, c.width))
        self.positional_embedding = nn.Parameter(
            torch.empty(c.context_length, c.width))
        for i in range(c.layers):
            setattr(self, f"resblock_{i}", CLIPResidualBlock(c.width, c.heads))
        self.ln_final = _layer_norm(c.width)
        self.text_projection = nn.Parameter(torch.empty(c.width, c.output_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        n = tokens.shape[1]
        x = self.token_embedding[tokens] + self.positional_embedding[:n]
        causal = torch.full((n, n), NEG, device=x.device).triu(1)
        for i in range(self.config.layers):
            x = getattr(self, f"resblock_{i}")(x, attn_mask=causal)
        x = self.ln_final(x)
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection


class CLIPModel(nn.Module):
    """Both towers under one tree (``visual``, ``text``, ``logit_scale``):
    ``encode_image``, ``encode_text``, and the scaled cosine logits."""

    def __init__(self, vision: CLIPConfig = CLIPConfig(),
                 text: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.visual = CLIPVisionTransformer(vision)
        self.text = CLIPTextTransformer(text)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def encode_image(self, images):
        return self.visual(images)

    def encode_text(self, tokens):
        return self.text(tokens)

    def forward(self, images, tokens):
        """-> (logits_per_image, logits_per_text)."""
        im = self.encode_image(images)
        tx = self.encode_text(tokens)
        im = im / im.norm(dim=-1, keepdim=True)
        tx = tx / tx.norm(dim=-1, keepdim=True)
        logits = self.logit_scale.exp() * im @ tx.T
        return logits, logits.T


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


class PositionwiseFeedForward(nn.Module):
    """Linear -> ReLU -> Dropout -> Linear."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.1):
        super().__init__()
        self.w_1 = Dense(d_model, d_ff)
        self.drop = nn.Dropout(dropout)
        self.w_2 = Dense(d_ff, d_model)

    def forward(self, x):
        return self.w_2(self.drop(F.relu(self.w_1(x))))


def sinusoidal_position_encoding(length: int, dim: int) -> np.ndarray:
    """Interleaved sin / cos time encoding, (length, dim) float32."""
    pe = np.zeros((length, dim), dtype=np.float32)
    position = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class SetTransformerAggregation(nn.Module):
    """Order-invariant N -> 1 aggregation: a learned seed cross-attends to
    the valid sources; a frame with no valid source returns the learned
    ``null_embed``.  mask: True = INVALID."""

    def __init__(self, emb_dim: int = 512, num_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.seed = nn.Parameter(torch.empty(1, 1, emb_dim))
        self.null_embed = nn.Parameter(torch.empty(1, emb_dim))
        self.cross_attention = MultiHeadAttention(emb_dim, num_heads, dropout)
        self.drop = nn.Dropout(dropout)
        self.layer_norm1 = _layer_norm(emb_dim)
        self.ffn_1 = Dense(emb_dim, emb_dim * 2)
        self.ffn_drop = nn.Dropout(dropout)
        self.ffn_2 = Dense(emb_dim * 2, emb_dim)
        self.layer_norm2 = _layer_norm(emb_dim)

    def forward(self, x, mask):
        seeds = self.seed.expand(x.shape[0], 1, -1)
        attn = self.cross_attention(seeds, x, x, key_padding_mask=mask)
        h = self.layer_norm1(seeds + self.drop(attn))
        ffn = self.ffn_2(self.ffn_drop(gelu(self.ffn_1(h))))
        h = self.layer_norm2(h + self.drop(ffn))
        return torch.where(mask.all(dim=1, keepdim=True), self.null_embed,
                           h[:, 0])


class AttentiveTemporalPool(nn.Module):
    """Masked learned attention pooling over time; a row with no valid step
    pools to zeros."""

    def __init__(self, emb_dim: int = 512):
        super().__init__()
        self.query = nn.Parameter(torch.empty(1, 1, emb_dim))

    def forward(self, seq, mask_invalid):
        scores = (seq * self.query).sum(dim=-1)
        attn = torch.softmax(scores.masked_fill(mask_invalid, -math.inf), -1)
        attn = torch.where(torch.isnan(attn), 0.0, attn)
        return (seq * attn[..., None]).sum(dim=1)


# ---------------------------------------------------------------------------
# the encoder family
# ---------------------------------------------------------------------------


def _frozen(tower: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """The frozen trunk: no gradient reaches it (``stop_gradient``)."""
    with torch.no_grad():
        return tower(images)


def _encode_frames(tower: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, N, H, W) -> (B, T, N, 512) through the frozen tower."""
    b, c, t, n, h, w = x.shape
    flat = x.permute(0, 2, 3, 1, 4, 5).reshape(b * t * n, c, h, w)
    return _frozen(tower, flat).reshape(b, t, n, -1)


def _temporal_layer() -> TransformerEncoderLayer:
    return TransformerEncoderLayer(512, 8, 2048)


class ClipEncoder(nn.Module):
    """CLIP per frame + encoder layer + mean over T; frames have no source
    axis: x (B, C, T, H, W) -> (B, 512)."""

    def __init__(self, clip: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.clip = CLIPVisionTransformer(clip)
        self.temporal_transformer_encoder = _temporal_layer()

    def forward(self, x):
        b, c, t, h, w = x.shape
        flat = x.transpose(1, 2).reshape(b * t, c, h, w)
        feats = _frozen(self.clip, flat).reshape(b, t, -1)
        return self.temporal_transformer_encoder(feats).mean(dim=1)


class _PosAttnStack(nn.Module):
    """MaskedAttention + FF residual refinement over the sources, shared by
    the Pos encoders; ``valid_mask`` True = a valid source."""

    def __init__(self, emb_dim: int = 512, dropout: float = 0.1):
        super().__init__()
        self.pos_dropout = nn.Dropout(dropout)
        self.pos_attention = MaskedAttention(emb_dim, heads=8, dim_head=64)
        self.pos_layer1 = _layer_norm(emb_dim)
        self.pos_ff = PositionwiseFeedForward(emb_dim, emb_dim * 4, dropout)
        self.pos_layer2 = _layer_norm(emb_dim)

    def forward(self, x, valid_mask):
        x = x + self.pos_dropout(self.pos_attention(x, mask=valid_mask))
        x = self.pos_layer1(x)
        x = x + self.pos_dropout(self.pos_ff(x))
        return self.pos_layer2(x)


class _SourcesThenTime(nn.Module):
    """The tail of the Pos encoders: the source stack, max over all N
    sources, the temporal layer, mean over T."""

    def __init__(self):
        super().__init__()
        self.pos_stack = _PosAttnStack()
        self.temporal_transformer_encoder = _temporal_layer()

    def pool(self, feats, mask):
        """feats (B, T, N, 512), mask (B, T, N) True = invalid -> (B, 512)."""
        b, t, n, e = feats.shape
        feats = self.pos_stack(feats.reshape(b * t, n, e),
                               ~mask.reshape(b * t, n))
        feats = feats.amax(dim=1).reshape(b, t, e)
        return self.temporal_transformer_encoder(feats).mean(dim=1)


class ClipPos(_SourcesThenTime):
    """3-D position FiLM: x (B, C, T, N, H, W), pos (B, T, N, 3), mask
    (B, T, N) True = invalid -> (B, 512)."""

    def __init__(self, clip: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.clip = CLIPVisionTransformer(clip)
        self.pos_emb = SinusoidalPosEmb(64)
        self.pos_emb_mlp = Dense(192, 1024)

    def forward(self, x, pos, mask):
        b, c, t, n, h, w = x.shape
        feats = _encode_frames(self.clip, x)
        emb = self.pos_emb(pos.reshape(-1)).reshape(b, t, n, 192)
        scale, shift = gelu(self.pos_emb_mlp(emb)).chunk(2, dim=-1)
        return self.pool(feats * (scale + 1.0) + shift, mask)


class ClipPos2D(_SourcesThenTime):
    """The default encoder: x (B, C, T, N, H, W), pos (B, T, N, 2) as
    (elevation, azimuth), mask (B, T, N) True = invalid -> (B, 512)."""

    def __init__(self, pos_emb_dim: int = 64, clip: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.clip = CLIPVisionTransformer(clip)
        self.pos_emb_ele = SinusoidalPosEmb(pos_emb_dim)
        self.pos_emb_azi = SinusoidalPosEmb(pos_emb_dim)
        for name in ("mlp_scale", "mlp_shift"):
            setattr(self, f"{name}_1", Dense(pos_emb_dim, 512))
            setattr(self, f"{name}_2", Dense(512, 512))

    def forward(self, x, pos, mask):
        feats = _encode_frames(self.clip, x)
        scale = self.mlp_scale_2(gelu(self.mlp_scale_1(
            self.pos_emb_ele(pos[..., 0]))))
        shift = self.mlp_shift_2(gelu(self.mlp_shift_1(
            self.pos_emb_azi(pos[..., 1]))))
        return self.pool(feats * (scale + 1.0) + shift, mask)


class ClipPos2DConcat(_SourcesThenTime):
    """(elevation, azimuth) concatenated to the CLIP feature, 514 -> 512."""

    def __init__(self, clip: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.clip = CLIPVisionTransformer(clip)
        self.pos_projection = Dense(514, 512)
        self.proj_drop = nn.Dropout(0.1)

    def forward(self, x, pos, mask):
        feats = _encode_frames(self.clip, x)
        feats = self.pos_projection(torch.cat([feats, pos.float()], dim=-1))
        return self.pool(self.proj_drop(gelu(feats)), mask)


def _l2_normalise(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class ClipPos2DEnhanced(nn.Module):
    """Pixel-coordinate tokens with set aggregation: x (B, C, T, N, H, W),
    pos_xy (B, T, N, 2) in [-1, 1], mask (B, T, N) True = invalid ->
    (B, 512).  Frames with no valid source enter the set aggregation as
    zeros (it returns ``null_embed`` for them), and a clip with no valid
    frame returns ``null_temporal`` before the final projection."""

    def __init__(self, num_heads: int = 8, num_source_layers: int = 2,
                 num_temporal_layers: int = 2, temporal_pool: str = "mean",
                 use_time_pe: bool = True, normalize_clip: bool = True,
                 dropout: float = 0.1, clip: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.temporal_pool = temporal_pool
        self.use_time_pe = use_time_pe
        self.normalize_clip = normalize_clip
        self.clip = CLIPVisionTransformer(clip)
        self.token_proj_1 = Dense(514, 512)
        self.token_drop = nn.Dropout(dropout)
        self.token_proj_ln = _layer_norm(512)
        self.source_encoder = TransformerEncoder(
            num_source_layers, 512, num_heads, 2048, dropout, norm_first=True)
        self.set_aggregator = SetTransformerAggregation(512, num_heads, dropout)
        self.temporal_encoder = TransformerEncoder(
            num_temporal_layers, 512, num_heads, 2048, dropout,
            norm_first=True)
        if temporal_pool == "attn":
            self.pooler = AttentiveTemporalPool(512)
        self.null_temporal = nn.Parameter(torch.empty(1, 512))
        self.final_projection_1 = Dense(512, 512)
        self.final_projection_ln = _layer_norm(512)

    def forward(self, x, pos_xy, mask):
        b, c, t, n, h, w = x.shape
        mask = mask.bool()
        feats = _encode_frames(self.clip, x)
        if self.normalize_clip:
            feats = _l2_normalise(feats)
        tokens = self.token_proj_1(torch.cat([feats, pos_xy.float()], dim=-1))
        tokens = self.token_proj_ln(self.token_drop(gelu(tokens)))

        src_kpm = mask.reshape(b * t, n)  # True = PAD
        src = self.source_encoder(tokens.reshape(b * t, n, 512),
                                  key_padding_mask=src_kpm)
        src = torch.where(src_kpm.all(dim=1)[:, None, None], 0.0, src)
        agg = self.set_aggregator(src, src_kpm).reshape(b, t, 512)

        frame_valid = (~mask).any(dim=2)  # (B, T)
        if self.use_time_pe:
            agg = agg + torch.from_numpy(
                sinusoidal_position_encoding(t, 512)).to(agg.device)
        enc = self.temporal_encoder(agg, key_padding_mask=~frame_valid)
        if self.temporal_pool == "attn":
            pooled = self.pooler(enc, ~frame_valid)
        else:
            wts = frame_valid.float()[..., None]
            pooled = (enc * wts).sum(dim=1) / wts.sum(dim=1).clamp_min(1.0)
        out = torch.where(frame_valid.any(dim=1, keepdim=True), pooled,
                          self.null_temporal)
        out = self.final_projection_ln(gelu(self.final_projection_1(out)))
        return _l2_normalise(out) if self.normalize_clip else out


# ---------------------------------------------------------------------------
# ResNet-18 trunk variant
# ---------------------------------------------------------------------------


class FrozenBN(nn.Module):
    """BatchNorm in frozen eval mode, an affine map of (B, C, H, W).  Its
    running statistics are parameters, as in the JAX package: the optimiser
    decays them like every other frozen leaf."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.var + 1e-5) * self.weight
        return ((x - self.mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None])


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, padding=1,
                               bias=False)
        self.bn1 = FrozenBN(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = FrozenBN(features)
        self.downsample = stride != 1 or in_features != features
        if self.downsample:
            self.down_conv = nn.Conv2d(in_features, features, 1, stride,
                                       bias=False)
            self.down_bn = FrozenBN(features)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(h + identity)


RESNET18_PLAN = [(64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                 (512, 2), (512, 1)]


class ResNet18Trunk(nn.Module):
    """torchvision's resnet18 without its fc head: (B, 3, H, W) -> (B, 512)
    after the global mean."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        in_features = 64
        for i, (f, s) in enumerate(RESNET18_PLAN):
            setattr(self, f"block_{i}", BasicBlock(in_features, f, s))
            in_features = f

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x.float())))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(len(RESNET18_PLAN)):
            x = getattr(self, f"block_{i}")(x)
        return x.mean(dim=(2, 3))


class ResnetEncoder(nn.Module):
    """Frozen ResNet-18 + a torch-style transformer over time (3 encoder
    layers, one decoder layer; d_model 512, feed-forward 512): x (B, 3, T,
    H, W) -> (B, 512)."""

    def __init__(self):
        super().__init__()
        self.features = ResNet18Trunk()
        self.encoder = TransformerEncoder(3, 512, 8, 512, dropout=0.1)
        self.dec_self_attn = MultiHeadAttention(512, 8)
        self.dec_cross_attn = MultiHeadAttention(512, 8)
        self.dec_norm1 = _layer_norm(512)
        self.dec_norm2 = _layer_norm(512)
        self.dec_norm3 = _layer_norm(512)
        self.dec_linear1 = Dense(512, 512)
        self.dec_linear2 = Dense(512, 512)

    def forward(self, x):
        b, c, t, h, w = x.shape
        flat = x.transpose(1, 2).reshape(b * t, c, h, w)
        feats = _frozen(self.features, flat).reshape(b, t, 512)
        enc = self.encoder(feats)
        h = self.dec_norm1(feats + self.dec_self_attn(feats, feats, feats))
        h = self.dec_norm2(h + self.dec_cross_attn(h, enc, enc))
        h = self.dec_norm3(h + self.dec_linear2(F.relu(self.dec_linear1(h))))
        return h.mean(dim=1)


ENCODER_REGISTRY = {
    "clip": ClipEncoder,
    "clip_pos": ClipPos,
    "clip_pos2d": ClipPos2D,
    "clip_pos2d_concat": ClipPos2DConcat,
    "clip_pos2d_enhanced": ClipPos2DEnhanced,
    "resnet18": ResnetEncoder,
}


def apply_visual(net: nn.Module, frames, pos2d, mask, pos3d=None):
    """Call an encoder of the registry on a batch, routed by its family as
    the JAX package's ``cli/common.py:visual_apply_fn`` routes it: frames
    (B, 3, T, N, H, W); ``ResnetEncoder`` and ``ClipEncoder`` take the mean
    over the N sources, ``ClipPos`` the 3-D positions, the rest the 2-D
    ones.  ``ClipPos`` takes ``pos2d`` when ``pos3d`` is not given: the JAX
    trainer hands every family its positions as that argument
    (``cli/common.py:188-190``)."""
    if isinstance(net, (ResnetEncoder, ClipEncoder)):
        return net(frames.mean(dim=3))
    if isinstance(net, ClipPos):
        return net(frames, pos2d if pos3d is None else pos3d, mask)
    return net(frames, pos2d, mask)


@torch.no_grad()
def init_visual_parameters(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from ``seed``, by the JAX initialisers' distributions:
    truncated normal with variance 1/fan_in for dense and conv kernels,
    biases zero, norm gains one; the raw CLIP parameters N(0, width^-1)
    (the text tower's embeddings N(0, 0.02^2) / N(0, 0.01^2)); the set
    seed and the attentive query N(0, 1); the null embeddings
    N(0, 0.02^2); FrozenBN's statistics (0, 1) and ``logit_scale``
    ln(1/0.07) as constructed."""
    gen = torch.Generator().manual_seed(seed)

    def normal(p, std):
        p.normal_(0.0, std, generator=gen)

    for m in module.modules():
        if isinstance(m, Dense):
            lecun_normal_(m.weight, m.weight.shape[1], gen)
        elif isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, CLIPVisionTransformer):
            for p in (m.class_embedding, m.positional_embedding, m.proj):
                normal(p, m.config.width**-0.5)
        elif isinstance(m, CLIPTextTransformer):
            normal(m.token_embedding, 0.02)
            normal(m.positional_embedding, 0.01)
            normal(m.text_projection, m.config.width**-0.5)
        elif isinstance(m, SetTransformerAggregation):
            normal(m.seed, 1.0)
            normal(m.null_embed, 0.02)
        elif isinstance(m, AttentiveTemporalPool):
            normal(m.query, 1.0)
        elif isinstance(m, ClipPos2DEnhanced):
            normal(m.null_temporal, 0.02)
    return module


def build_visual(arch_frame: str = "clip_pos2d", *, seed: int = 0,
                 device=None, **kwargs) -> nn.Module:
    """The encoder ``arch_frame`` of the registry (``kwargs`` go to its
    constructor, e.g. ``clip=CLIPConfig(...)``), float32, random weights
    from ``seed``, on the card unless ``device="cpu"``, in ``eval()``
    mode."""
    if arch_frame not in ENCODER_REGISTRY:
        raise ValueError(f"unknown arch_frame {arch_frame!r}")
    device = resolve_device(device)
    net = init_visual_parameters(ENCODER_REGISTRY[arch_frame](**kwargs), seed)
    return net.to(device).eval()
