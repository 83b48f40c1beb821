"""Position conversions and binaural-cue approximations (numpy), and the
learned 2-D position embedding (torch) — counterpart of
``diffbinaural_tpu/data/position_utils.py``: 3-D -> 2-D conversions, the
Woodworth ITD / sine ILD approximations and a binaural spectral weighting,
position normalisation, and ``Position2DEmbedding``, whose parameters
carry the flax names (``proj_1``, ``proj_2``; ``convert.py:
position_embedding_params_from_flax`` maps a flax tree onto it).  No
shipped path calls it; it serves the datasets' position data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

SPEED_OF_SOUND = 343.0


# ---------------------------------------------------------------------------
# converters (numpy; loaders run on the host)
# ---------------------------------------------------------------------------


def angle_to_2d(angle_degrees) -> np.ndarray:
    """degrees → (sin, cos) unit position."""
    rad = np.radians(np.asarray(angle_degrees, dtype=np.float64))
    return np.stack([np.sin(rad), np.cos(rad)], axis=-1).astype(np.float32)


def cartesian_3d_to_2d(pos_3d) -> np.ndarray:
    """XZ-plane projection, unit-normalised."""
    pos_3d = np.asarray(pos_3d, dtype=np.float64)
    x, z = pos_3d[..., 0], pos_3d[..., 2]
    norm = np.sqrt(x**2 + z**2 + 1e-8)
    return np.stack([x / norm, z / norm], axis=-1).astype(np.float32)


def spherical_to_2d(azimuth, elevation=None) -> np.ndarray:
    """(azimuth, elevation) degrees → cos(el)-weighted horizontal
    position."""
    if elevation is None:
        return angle_to_2d(azimuth)
    az = np.radians(np.asarray(azimuth, dtype=np.float64))
    el = np.radians(np.asarray(elevation, dtype=np.float64))
    cos_el = np.cos(el)
    return np.stack(
        [np.sin(az) * cos_el, np.cos(az) * cos_el], axis=-1
    ).astype(np.float32)


def normalize_position_data(pos, method: str = "unit_circle") -> np.ndarray:
    """Unit-circle or min-max (over the second-last axis) normalisation;
    any other ``method`` returns ``pos`` as float32."""
    pos = np.asarray(pos, dtype=np.float32)
    if method == "unit_circle":
        norm = np.sqrt(np.sum(pos**2, axis=-1, keepdims=True))
        return pos / (norm + 1e-8)
    if method == "minmax":
        lo = pos.min(axis=-2, keepdims=True)
        hi = pos.max(axis=-2, keepdims=True)
        return 2 * (pos - lo) / (hi - lo + 1e-8) - 1
    return pos


def convert_existing_pos_to_2d(pos_3d) -> np.ndarray:
    return cartesian_3d_to_2d(pos_3d)


# ---------------------------------------------------------------------------
# binaural cue approximations
# ---------------------------------------------------------------------------


def compute_itd_factor(pos_2d, head_radius: float = 0.0875) -> np.ndarray:
    """Woodworth-approximate ITD seconds."""
    pos_2d = np.asarray(pos_2d)
    angle = np.arctan2(pos_2d[..., 0], pos_2d[..., 1])
    return (np.sin(angle) * head_radius / SPEED_OF_SOUND).astype(np.float32)


def compute_ild_factor(pos_2d) -> np.ndarray:
    """sin(azimuth)·0.5 ∈ [-0.5, 0.5]."""
    pos_2d = np.asarray(pos_2d)
    angle = np.arctan2(pos_2d[..., 0], pos_2d[..., 1])
    return (np.sin(angle) * 0.5).astype(np.float32)


def apply_binaural_weighting(
    mono_spec: np.ndarray, pos_2d: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """mono (B, F, T) × position → (left, right) specs."""
    ild = compute_ild_factor(pos_2d)[..., None, None]
    return mono_spec * (1.0 + ild), mono_spec * (1.0 - ild)


# ---------------------------------------------------------------------------
# learned embedding
# ---------------------------------------------------------------------------


class Position2DEmbedding(nn.Module):
    """(..., 2) positions -> (..., embed_dim): sin / cos of each coordinate
    at ``embed_dim // 4`` log-spaced frequencies up to ``max_freq``, then
    Linear -> SiLU -> Linear.  float32."""

    def __init__(self, embed_dim: int = 64, max_freq: float = 10.0):
        super().__init__()
        self.embed_dim = embed_dim
        freqs = np.exp(
            np.linspace(0, np.log(max_freq), embed_dim // 4)
        ).astype(np.float32)
        self.register_buffer("freqs", torch.from_numpy(freqs),
                             persistent=False)
        self.proj_1 = nn.Linear(4 * (embed_dim // 4), embed_dim // 2)
        self.proj_2 = nn.Linear(embed_dim // 2, embed_dim)

    def forward(self, pos_2d: torch.Tensor) -> torch.Tensor:
        x = pos_2d[..., 0:1] * self.freqs
        y = pos_2d[..., 1:2] * self.freqs
        emb = torch.cat([torch.sin(x), torch.cos(x), torch.sin(y),
                         torch.cos(y)], dim=-1)
        return self.proj_2(F.silu(self.proj_1(emb)))
