"""DDPM/DDIM engine — counterpart of
``diffbinaural_tpu/diffusion/gaussian.py``: the training loss ``p_losses``
(with the noised-mix condition, CFG dropout and the p2 weight), the DDIM
sampler on the uniform or a DPM time grid, DPM-Solver++(2M)
(``dpm_sample``), the ancestral sampler ``p_sample_loop`` and
``interpolate``.

The model is passed as a callable ``model_fn(x, t, condition) -> prediction``
with condition = (mix, visual_feat, mix_t).  Sampling is a Python loop under
``torch.inference_mode()``; the loss is differentiable.  Randomness comes
from an explicit ``torch.Generator`` or from tensors handed in by the caller
(``t=``, ``noise=``, ``drop=``, ``noises=``): the two frameworks' generators
cannot agree, so the tests inject the JAX package's draws that way.

The samplers' state (x_t, the noised mix, x0 predictions) stays float32
whatever the model computes in; the time grids and DPM coefficients are
numpy, computed as the JAX package computes them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils.profiling import span
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
        loss_type: str = "l1",
        objective: str = "pred_noise",
        beta_schedule: str = "cosine",
        schedule_fn_kwargs: Optional[dict] = None,
        p2_loss_weight_gamma: float = 0.0,
        p2_loss_weight_k: float = 1.0,
        ddim_sampling_eta: float = 0.0,
        auto_normalize: bool = False,
        min_snr_loss_weight: bool = False,
        min_snr_gamma: float = 5.0,
        device=None,
    ):
        if objective not in {"pred_noise", "pred_x0", "pred_v"}:
            raise ValueError(f"unknown objective {objective!r}")
        if loss_type not in {"l1", "l2"}:
            raise ValueError(f"invalid loss type {loss_type!r}")
        self.device = resolve_device(device)
        self.image_size = image_size
        self.objective = objective
        self.loss_type = loss_type
        self.ddim_sampling_eta = ddim_sampling_eta

        self.schedule: DiffusionSchedule = make_schedule(
            beta_schedule, timesteps,
            p2_loss_weight_gamma=p2_loss_weight_gamma,
            p2_loss_weight_k=p2_loss_weight_k, device=self.device,
            **(schedule_fn_kwargs or {}),
        )
        self.num_timesteps = self.schedule.num_timesteps
        self.sampling_timesteps = (
            sampling_timesteps if sampling_timesteps is not None else timesteps
        )
        if self.sampling_timesteps > timesteps:
            raise ValueError("sampling_timesteps exceeds timesteps")
        self.is_ddim_sampling = self.sampling_timesteps < timesteps

        # snr-derived loss weight: kept beside the schedule as the JAX
        # package keeps it; ``p_losses`` weights by ``p2_loss_weight`` only
        ac = self.schedule.alphas_cumprod
        snr = ac / (1 - ac)
        maybe_clipped = snr.clamp(max=min_snr_gamma) if min_snr_loss_weight else snr
        if objective == "pred_noise":
            self.loss_weight = maybe_clipped / snr
        elif objective == "pred_x0":
            self.loss_weight = maybe_clipped
        else:
            self.loss_weight = maybe_clipped / (snr + 1)

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

    def q_posterior(self, x_start, x_t, t):
        s = self.schedule
        mean = (
            _extract(s.posterior_mean_coef1, t, x_t.ndim) * x_start
            + _extract(s.posterior_mean_coef2, t, x_t.ndim) * x_t
        )
        var = _extract(s.posterior_variance, t, x_t.ndim)
        log_var = _extract(s.posterior_log_variance_clipped, t, x_t.ndim)
        return mean, var, log_var

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

    def process_xstart(self, x, dynamic_threshold: bool = False,
                       percentile: float = 0.95):
        """Clip a predicted x_0 to [0, 1], or to [0, s] with s the per-sample
        ``percentile`` of |x| (at least 0.9)."""
        if dynamic_threshold:
            flat = x.reshape(x.shape[0], -1).abs()
            s = torch.quantile(flat, percentile, dim=-1).clamp(min=0.9)
            s = s.reshape((-1,) + (1,) * (x.ndim - 1))
            return torch.minimum(x.clamp(min=0.0), s)
        return x.clamp(0.0, 1.0)

    # ------------------------------------------------------------------ training

    def p_losses(
        self,
        model_fn,
        x_start: torch.Tensor,
        condition: Sequence[torch.Tensor],
        t: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        drop: Optional[torch.Tensor] = None,
        weight=None,  # accepted and ignored, as in the JAX package
        cfg: bool = False,
        threshold: float = 0.1,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Training loss.  condition = (mix, visual_feature); ``mix_t`` is
        derived here.  ``t`` (B,) integer steps, ``noise`` like ``x_start``
        and — with ``cfg`` — ``drop`` (B,) bool are drawn from ``generator``
        when absent.

        ``mix_t`` is the (B, 1, H, W) mix noised with the SAME noise as the
        target, which broadcasts it to two channels.  The CFG mask zeroes
        ``mix`` and ``visual_feature`` per sample but leaves ``mix_t`` as it
        is.  The loss is the per-sample mean of |.| or (.)^2, times
        ``p2_loss_weight[t]``, then the batch mean."""
        del weight
        b = x_start.shape[0]
        dev = x_start.device
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,), generator=generator,
                              device=dev)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                dtype=x_start.dtype, device=dev)

        x = self.q_sample(x_start, t, noise)
        mix, visual_feature = condition[0], condition[1]
        mix_t = self.q_sample(mix, t, noise)

        if cfg:
            if drop is None:
                drop = torch.rand((b,), generator=generator, device=dev) < threshold
            drop = drop.to(dev)
            mix = mix.masked_fill(
                drop.reshape((-1,) + (1,) * (mix.ndim - 1)), 0.0)
            visual_feature = visual_feature.masked_fill(
                drop.reshape((-1,) + (1,) * (visual_feature.ndim - 1)), 0.0)

        model_out = model_fn(x, t, (mix, visual_feature, mix_t))

        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:
            target = self.predict_v(x_start, t, noise)

        if self.loss_type == "l1":
            loss = (model_out - target).abs()
        else:
            loss = (model_out - target) ** 2
        loss = loss.reshape(b, -1).mean(dim=-1)
        loss = loss * self.schedule.p2_loss_weight[t.long()]
        return loss.mean()

    def __call__(self, model_fn, img, condition, **kwargs):
        """Train-mode forward: check the size, normalise, loss."""
        h, w = img.shape[-2], img.shape[-1]
        if h != self.image_size or w != self.image_size:
            raise ValueError(
                f"height and width of image must be {self.image_size}")
        return self.p_losses(model_fn, self.normalize(img), condition, **kwargs)

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
        time_grid: str = "uniform",
    ):
        """DDIM sampling.

        condition = (mix, visual_feature) with mix (B, 1, H, W).  The state
        ``img`` and the noised-mix condition ``mix_t`` are both (B, 2, H, W)
        and carried together; the model's condition[0] stays the ORIGINAL
        1-channel mix at every step.  ``noise`` is the initial x_T
        (B, 2, H, W); when absent it is drawn from ``generator``.  On the
        last step ``img`` becomes the predicted x_0 and ``mix_t`` is left
        untouched.

        ``time_grid="uniform"`` is the reference's strided grid (last model
        call at t ~ T/steps); any :meth:`_dpm_time_pairs` grid name
        (``"power2.5"``, ``"lambda"``, ``"karras7"`` ...) runs the same
        update on that grid, whose last model call is at t = 0."""
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

        if time_grid == "uniform":
            pairs = self._ddim_time_pairs(sampling_timesteps)
        else:
            pairs = self._dpm_time_pairs(sampling_timesteps, time_grid)
        for time, time_next in pairs.tolist():
            with span("sampler.step"):
                time_cond = torch.full((batch,), time, dtype=torch.int32,
                                       device=mix.device)
                pred_noise, x_start = self.model_predictions(
                    model_fn, img, time_cond,
                    (mono_mix, visual_feature, mix_t), clip_x_start=True,
                )
                if time_next < 0:
                    img = x_start
                else:
                    alpha, alpha_next = ac[time], ac[time_next]
                    sigma = eta * torch.sqrt(
                        (1 - alpha / alpha_next) * (1 - alpha_next)
                        / (1 - alpha)
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

    def _dpm_time_pairs(self, sampling_timesteps: int,
                        time_grid: str = "power2.5") -> np.ndarray:
        """``sampling_timesteps`` model-call times from T-1 down to 0, then
        the terminal (0 -> -1) pair, as (steps, 2) int32 pairs.

        Grids, each rounded to a strictly decreasing integer grid:
          * ``"power{p}"``: t_i = (T-1)(1-s_i)^p, s uniform on [0, 1]
            (p = 2.5 when omitted; ``"power1"`` is uniform in t);
          * ``"lambda"``: uniform in lambda = log(alpha/sigma), nearest t;
          * ``"karras{rho}"``: uniform in sigma^(1/rho), sigma =
            sqrt((1 - abar)/abar), nearest t (rho = 7 when omitted)."""
        if not 1 <= sampling_timesteps <= self.num_timesteps:
            raise ValueError(f"sampling_timesteps {sampling_timesteps} not in "
                             f"[1, {self.num_timesteps}]")
        T = self.num_timesteps
        if sampling_timesteps == 1:
            times = [T - 1]
        else:
            s = np.linspace(0.0, 1.0, sampling_timesteps)
            ac = self.schedule.alphas_cumprod.detach().cpu().numpy().astype(
                np.float64)
            if time_grid.startswith("power"):
                p = float(time_grid[len("power"):] or 2.5)
                ts_f = (T - 1) * (1.0 - s) ** p
            elif time_grid == "lambda":
                lam = 0.5 * np.log(ac / (1.0 - ac))
                lam_grid = lam[T - 1] + s * (lam[0] - lam[T - 1])
                ts_f = np.array([np.abs(lam - g).argmin() for g in lam_grid],
                                float)
            elif time_grid.startswith("karras"):
                rho = float(time_grid[len("karras"):] or 7.0)
                sig = np.sqrt((1.0 - ac) / ac)
                sig_grid = (
                    sig[T - 1] ** (1 / rho)
                    + s * (sig[0] ** (1 / rho) - sig[T - 1] ** (1 / rho))
                ) ** rho
                ts_f = np.array([np.abs(sig - g).argmin() for g in sig_grid],
                                float)
            else:
                raise ValueError(f"unknown time_grid {time_grid!r}")
            times = np.round(ts_f).astype(int).tolist()
            # strictly decreasing: clamp forward, then push entries that
            # rounded together near t = 0 back up from the end
            for i in range(1, len(times)):
                times[i] = min(times[i], times[i - 1] - 1)
            times[-1] = max(times[-1], 0)
            for i in range(len(times) - 2, -1, -1):
                times[i] = max(times[i], times[i + 1] + 1)
            if times[0] > T - 1:
                raise ValueError("sampling_timesteps too large for schedule")
        times = times + [-1]
        return np.asarray(list(zip(times[:-1], times[1:])), dtype=np.int32)

    def _dpm_coeffs(self, time_pairs: np.ndarray) -> np.ndarray:
        """Per-step coefficients of DPM-Solver++(2M), (steps, 6) float32
        (computed in float64).  Row i is (k_x, k_D, c_prev, m_a, m_s, last):

            x_{i+1}    = k_x * x_i + k_D * D_i
            D_i        = (1 - c_prev) * x0_i + c_prev * x0_{i-1}
            mix_t_next = m_a * mix + m_s * eps_i       (unless last)

        with h_i = lambda(t_next) - lambda(t_cur), k_x = sigma_next /
        sigma_cur, k_D = -alpha_next * expm1(-h_i), c_prev = -h_i /
        (2 h_{i-1}) (0 on the first step).  The terminal row (t_next < 0)
        is (0, 1, 0, 0, 0, 1): x <- x0, as DDIM's last step."""
        ac = self.schedule.alphas_cumprod.detach().cpu().numpy().astype(
            np.float64)
        alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
        lam = np.log(alpha / sigma)
        rows = np.zeros((len(time_pairs), 6), np.float64)
        h_prev = None
        for i, (tc, tn) in enumerate(time_pairs):
            if tn < 0:
                rows[i] = (0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
                continue
            h = lam[tn] - lam[tc]
            c_prev = 0.0 if h_prev is None else -h / (2.0 * h_prev)
            rows[i] = (sigma[tn] / sigma[tc], -alpha[tn] * np.expm1(-h),
                       c_prev, alpha[tn], sigma[tn], 0.0)
            h_prev = h
        return rows.astype(np.float32)

    @torch.inference_mode()
    def dpm_sample(
        self,
        model_fn,
        condition: Sequence[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        return_all_timesteps: bool = False,
        sampling_timesteps: Optional[int] = None,
        time_grid: str = "power2.5",
    ):
        """DPM-Solver++(2M): the second-order multistep solver (data
        prediction) of the probability-flow ODE that eta = 0 DDIM
        integrates, on a :meth:`_dpm_time_pairs` grid.  Deterministic.

        The condition contract is :meth:`ddim_sample`'s: the model's
        condition[0] stays the 1-channel mix, and the noised mix is
        refreshed every step but the last to the next noise level with the
        current noise prediction.  ``noise`` / ``generator`` give the
        initial x_T as in :meth:`ddim_sample` (the JAX package draws the
        same x_T in both samplers for one key)."""
        if sampling_timesteps is None:
            sampling_timesteps = self.sampling_timesteps

        mono_mix = condition[0].detach()
        mix = mono_mix.repeat(1, 2, 1, 1)
        visual_feature = condition[1]
        batch = mix.shape[0]

        img = (torch.randn(mix.shape, generator=generator, dtype=mix.dtype,
                           device=mix.device)
               if noise is None else noise.to(mix))
        if img.shape != mix.shape:
            raise ValueError(f"noise must be {tuple(mix.shape)}, got "
                             f"{tuple(img.shape)}")
        mix_t = img + mix
        prev_x0 = torch.zeros_like(img)
        imgs = [img]

        pairs = self._dpm_time_pairs(sampling_timesteps, time_grid)
        coeffs = self._dpm_coeffs(pairs)
        one = np.float32(1.0)
        for (time, _), row in zip(pairs.tolist(), coeffs):
            with span("sampler.step"):
                # float32 coefficients as Python floats (exact): 1 - c_prev is
                # formed in float32, as the JAX step forms it
                k_x, k_d, c_prev, m_a, m_s, last = (float(v) for v in row)
                keep = float(one - row[2])
                time_cond = torch.full((batch,), time, dtype=torch.int32,
                                       device=mix.device)
                pred_noise, x_start = self.model_predictions(
                    model_fn, img, time_cond,
                    (mono_mix, visual_feature, mix_t), clip_x_start=True,
                )
                d = keep * x_start + c_prev * prev_x0
                img = k_x * img + k_d * d
                if not last:
                    mix_t = m_a * mix + m_s * pred_noise
                prev_x0 = x_start
            if return_all_timesteps:
                imgs.append(img)

        if return_all_timesteps:
            return self.unnormalize(torch.stack(imgs, dim=1))
        return self.unnormalize(img)

    def _ancestral_steps(self, model_fn, img, condition, first_t: int,
                         generator, noises, keep_all: bool):
        """Ancestral steps t = first_t .. 0 from ``img``; ``noises[i]`` is
        the i-th step's noise (the last step, t = 0, adds none)."""
        batch = img.shape[0]
        imgs = []
        for i, step in enumerate(range(first_t, -1, -1)):
            with span("sampler.step"):
                t_b = torch.full((batch,), step, dtype=torch.int32,
                                 device=img.device)
                _, x_start = self.model_predictions(
                    model_fn, img, t_b, condition, clip_x_start=True)
                x_start = x_start.clamp(0.0, 1.0)
                mean, _, log_var = self.q_posterior(x_start, img, t_b)
                if step > 0:
                    z = (torch.randn(img.shape, generator=generator,
                                     dtype=img.dtype, device=img.device)
                         if noises is None else noises[i].to(img))
                    img = mean + torch.exp(0.5 * log_var) * z
                else:
                    img = mean
            if keep_all:
                imgs.append(img)
        return img, imgs

    @torch.inference_mode()
    def p_sample_loop(
        self,
        model_fn,
        condition: Sequence[torch.Tensor],
        shape: tuple,
        generator: Optional[torch.Generator] = None,
        noises: Optional[torch.Tensor] = None,
        return_all_timesteps: bool = False,
    ):
        """Ancestral sampler over all T steps.  ``noises`` (T + 1, *shape),
        when given, holds the initial x_T first and then one noise per
        step; else both are drawn from ``generator``."""
        if noises is None:
            img0 = torch.randn(shape, generator=generator, device=self.device)
            steps = None
        else:
            img0, steps = noises[0].to(self.device), noises[1:]
        img, imgs = self._ancestral_steps(
            model_fn, img0, condition, self.num_timesteps - 1, generator,
            steps, return_all_timesteps)
        if return_all_timesteps:
            return self.unnormalize(torch.stack([img0] + imgs, dim=1))
        return self.unnormalize(img)

    @torch.inference_mode()
    def interpolate(self, model_fn, x1, x2, t: Optional[int] = None,
                    lam: float = 0.5,
                    generator: Optional[torch.Generator] = None,
                    noises: Optional[torch.Tensor] = None):
        """Noise x1 and x2 to step ``t``, mix them with weight ``lam`` and
        denoise ancestrally from step t - 1 with no condition.  ``noises``
        (t + 2, *x1.shape), when given, holds the two q-sample noises first
        and then one noise per step."""
        if t is None:
            t = self.num_timesteps - 1
        t_b = torch.full((x1.shape[0],), t, dtype=torch.int32, device=x1.device)

        def draw(like):
            return torch.randn(like.shape, generator=generator,
                               dtype=like.dtype, device=like.device)

        n1, n2 = (draw(x1), draw(x2)) if noises is None else (noises[0], noises[1])
        img = ((1 - lam) * self.q_sample(x1, t_b, n1.to(x1))
               + lam * self.q_sample(x2, t_b, n2.to(x2)))
        img, _ = self._ancestral_steps(
            model_fn, img, None, t - 1, generator,
            None if noises is None else noises[2:], False)
        return img
