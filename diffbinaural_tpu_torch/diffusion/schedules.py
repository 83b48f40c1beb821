"""Diffusion beta/alpha schedules and their precomputed constants.

Counterpart of ``diffbinaural_tpu/diffusion/schedules.py``: computed in
numpy float64 and stored as float32 tensors on the caller's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000 / timesteps
    return np.linspace(scale * 1e-6, scale * 0.006, timesteps, dtype=np.float64)


def linear_alpha_schedule(timesteps: int, clip_min: float = 1e-9) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    alphas_cumprod = np.clip(1 - t, clip_min, 1.0)
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """The schedule the serving configuration uses."""
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = 0, end: float = 3, tau: float = 1,
) -> np.ndarray:
    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start = sigmoid(start / tau)
    v_end = sigmoid(end / tau)
    alphas_cumprod = (-sigmoid((t * (end - start) + start) / tau) + v_end) / (
        v_end - v_start
    )
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


_SCHEDULES = {
    "linear": linear_beta_schedule,
    "linear_alpha": linear_alpha_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


@dataclass(frozen=True)
class DiffusionSchedule:
    """The 12 schedule constants plus the p2 reweighting, float32 tensors."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    p2_loss_weight: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(
    beta_schedule: str = "cosine",
    timesteps: int = 1000,
    p2_loss_weight_gamma: float = 0.0,
    p2_loss_weight_k: float = 1.0,
    device="cpu",
    **schedule_kwargs,
) -> DiffusionSchedule:
    betas = _SCHEDULES[beta_schedule](timesteps, **schedule_kwargs)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])

    posterior_variance = (
        betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    )

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.clip(posterior_variance, 1e-20, None))
        ),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        p2_loss_weight=f32(
            (p2_loss_weight_k + alphas_cumprod / (1 - alphas_cumprod))
            ** -p2_loss_weight_gamma
        ),
    )
