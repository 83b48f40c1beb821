"""DDIM sampling engine — the inference half of
``diffbinaural_tpu/diffusion/gaussian.py``.

The model is passed as a callable ``model_fn(x, t, condition) -> prediction``
with condition = (mix, visual_feat, mix_t).  Sampling is a Python loop under
``torch.inference_mode()``; randomness comes from an explicit
``torch.Generator`` or from a ``noise=`` tensor handed in by the caller (the
tests inject the JAX package's noise that way).

Not ported yet: the training loss, the ancestral sampler, DPM-Solver++ and
the non-uniform time grids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from .schedules import DiffusionSchedule, make_schedule


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-batch schedule constants and right-pad dims for broadcast."""
    out = a[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def normalize_to_neg_one_to_one(x):
    return x * 2 - 1


def unnormalize_to_zero_to_one(x):
    return (x + 1) * 0.5


def identity(x, *args, **kwargs):
    return x


class GaussianDiffusion:
    """Stateless diffusion math over an externally-managed model function.
    The schedule constants live on ``device`` (the card unless told
    otherwise)."""

    def __init__(
        self,
        *,
        image_size: int = 80,
        timesteps: int = 1000,
        sampling_timesteps: Optional[int] = None,
        objective: str = "pred_noise",
        beta_schedule: str = "cosine",
        schedule_fn_kwargs: Optional[dict] = None,
        ddim_sampling_eta: float = 0.0,
        auto_normalize: bool = False,
        device=None,
    ):
        if objective not in {"pred_noise", "pred_x0", "pred_v"}:
            raise ValueError(f"unknown objective {objective!r}")
        self.device = resolve_device(device)
        self.image_size = image_size
        self.objective = objective
        self.ddim_sampling_eta = ddim_sampling_eta

        self.schedule: DiffusionSchedule = make_schedule(
            beta_schedule, timesteps, device=self.device,
            **(schedule_fn_kwargs or {}),
        )
        self.num_timesteps = self.schedule.num_timesteps
        self.sampling_timesteps = (
            sampling_timesteps if sampling_timesteps is not None else timesteps
        )
        if self.sampling_timesteps > timesteps:
            raise ValueError("sampling_timesteps exceeds timesteps")
        self.is_ddim_sampling = self.sampling_timesteps < timesteps

        self.normalize = normalize_to_neg_one_to_one if auto_normalize else identity
        self.unnormalize = unnormalize_to_zero_to_one if auto_normalize else identity

    # ------------------------------------------------------------------ q/p math

    def q_sample(self, x_start, t, noise, scale: float = 1.0):
        s = self.schedule
        return (
            _extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * scale * x_start
            + _extract(s.sqrt_one_minus_alphas_cumprod, t,
                       max(x_start.ndim, noise.ndim)) * noise
        )

    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        return (
            _extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise
        )

    def predict_noise_from_start(self, x_t, t, x0):
        s = self.schedule
        return (
            _extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0
        ) / _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)

    def predict_v(self, x_start, t, noise):
        s = self.schedule
        return (
            _extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * noise
            - _extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * x_start
        )

    def predict_start_from_v(self, x_t, t, v):
        s = self.schedule
        return (
            _extract(s.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
            - _extract(s.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v
        )

    # ------------------------------------------------------------------ model io

    def model_predictions(
        self, model_fn, x, t, condition, clip_x_start: bool = True
    ) -> ModelPrediction:
        model_output = model_fn(x, t, condition)
        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else identity

        if self.objective == "pred_noise":
            pred_noise = model_output
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
        elif self.objective == "pred_x0":
            x_start = clip(model_output)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:  # pred_v
            x_start = clip(self.predict_start_from_v(x, t, model_output))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return ModelPrediction(pred_noise, x_start)

    # ------------------------------------------------------------------ sampling

    def _ddim_time_pairs(self, sampling_timesteps: int) -> np.ndarray:
        # the truncating astype(int) of the strided grid is part of the recipe
        times = np.linspace(-1, self.num_timesteps - 1, sampling_timesteps + 1)
        times = list(reversed(times.astype(int).tolist()))
        return np.asarray(list(zip(times[:-1], times[1:])), dtype=np.int32)

    @torch.inference_mode()
    def ddim_sample(
        self,
        model_fn,
        condition: Sequence[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        return_all_timesteps: bool = False,
        sampling_timesteps: Optional[int] = None,
    ):
        """DDIM sampling on the uniform strided grid.

        condition = (mix, visual_feature) with mix (B, 1, H, W).  The state
        ``img`` and the noised-mix condition ``mix_t`` are both (B, 2, H, W)
        and carried together; the model's condition[0] stays the ORIGINAL
        1-channel mix at every step.  ``noise`` is the initial x_T
        (B, 2, H, W); when absent it is drawn from ``generator``.  On the
        last step ``img`` becomes the predicted x_0 and ``mix_t`` is left
        untouched."""
        if sampling_timesteps is None:
            sampling_timesteps = self.sampling_timesteps
        eta = self.ddim_sampling_eta
        ac = self.schedule.alphas_cumprod

        mono_mix = condition[0].detach()
        mix = mono_mix.repeat(1, 2, 1, 1)
        visual_feature = condition[1]
        batch = mix.shape[0]

        def draw():
            return torch.randn(mix.shape, generator=generator, dtype=mix.dtype,
                               device=mix.device)

        img = draw() if noise is None else noise.to(mix)
        if img.shape != mix.shape:
            raise ValueError(f"noise must be {tuple(mix.shape)}, got "
                             f"{tuple(img.shape)}")
        mix_t = img + mix
        imgs = [img]

        for time, time_next in self._ddim_time_pairs(sampling_timesteps).tolist():
            time_cond = torch.full((batch,), time, dtype=torch.int32,
                                   device=mix.device)
            pred_noise, x_start = self.model_predictions(
                model_fn, img, time_cond, (mono_mix, visual_feature, mix_t),
                clip_x_start=True,
            )
            if time_next < 0:
                img = x_start
            else:
                alpha, alpha_next = ac[time], ac[time_next]
                sigma = eta * torch.sqrt(
                    (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha)
                )
                c = torch.sqrt(1 - alpha_next - sigma**2)
                step = c * pred_noise
                if eta > 0:
                    step = step + sigma * draw()
                img = x_start * torch.sqrt(alpha_next) + step
                mix_t = mix * torch.sqrt(alpha_next) + step
            if return_all_timesteps:
                imgs.append(img)

        if return_all_timesteps:
            # (B, steps+1, C, H, W) with the initial noise first
            return self.unnormalize(torch.stack(imgs, dim=1))
        return self.unnormalize(img)
