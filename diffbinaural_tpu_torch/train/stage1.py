"""Stage-1 diffusion training: one optimiser step on the card — counterpart
of ``diffbinaural_tpu/train/stage1.py``.

  * joint (frame-encoder, UNet) AdamW with two LR groups — ``lr_unet`` for
    the denoiser, ``lr_frame`` for the conditioning head
  * a host-fed multiplicative ``lr_scale`` carried in the train state, so the
    trainer's LR decay never rebuilds the optimiser
  * global-norm gradient clip inside the step, with the PRE-clip norm
    returned for the stabiliser; an optional clip by value after it
  * diffusion loss with CFG dropout p = 0.1 and the noised-mix condition
    (``diffusion.gaussian.p_losses``)

The update is the JAX package's optax chain: clip by global norm -> clip by
value -> Adam moments (eps outside the root, bias-corrected) -> + wd * p on
every parameter -> x -lr_group * lr_scale.  ``torch.optim.AdamW`` computes
the same expression for the last three; the clip is written out here,
because ``clip_grad_norm_`` divides by ``norm + 1e-6`` where optax divides by
the norm itself.

The JAX train step applies the UNet with dropout off, and so does this one,
whatever the module's ``train()``/``eval()`` flag says.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..diffusion import GaussianDiffusion
from ..infer.stage1 import normalize_mel


@dataclass
class Stage1TrainState:
    step: int
    unet: nn.Module
    visual: Optional[nn.Module]
    optimizer: torch.optim.Optimizer
    lr_scale: float = 1.0  # host-updated multiplicative LR factor


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: gradients are left alone
    when their global norm is below ``max_norm`` and become
    ``g / norm * max_norm`` otherwise.  Returns the pre-clip norm.  No host
    synchronisation: the choice is a ``torch.where`` on the device."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)).float())
    below = norm < max_norm
    divisor = torch.where(below, torch.ones_like(norm), norm)
    factor = torch.where(below, torch.ones_like(norm),
                         torch.full_like(norm, max_norm))
    torch._foreach_div_(grads, divisor)
    torch._foreach_mul_(grads, factor)
    return norm


def apply_update_(optimizer: torch.optim.Optimizer, lr_scale: float,
                  clip_norm: float, clip_value: Optional[float]) -> torch.Tensor:
    """One optimiser update from the gradients that lie in ``.grad``: clip by
    global norm, optional clip by value, AdamW at ``base_lr * lr_scale`` per
    group.  Returns the pre-clip global norm."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        # optax updates every leaf (weight decay included); AdamW would skip
        # a parameter that the loss did not reach
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    grad_norm = clip_by_global_norm_(grads, clip_norm)
    if clip_value is not None:
        torch._foreach_clamp_min_(grads, -clip_value)
        torch._foreach_clamp_max_(grads, clip_value)
    for group in optimizer.param_groups:
        group["lr"] = group["base_lr"] * lr_scale
    optimizer.step()
    return grad_norm


def make_stage1_train_step(
    unet: nn.Module,
    visual: Optional[nn.Module] = None,
    diffusion: Optional[GaussianDiffusion] = None,
    lr_unet: float = 1e-4,
    lr_frame: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    weight_decay: float = 1e-2,
    clip_norm: float = 1.0,
    clip_value: Optional[float] = None,
    cfg: bool = True,
    device=None,
) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn, step_fn)``.

    ``init_fn()`` -> :class:`Stage1TrainState` around ``unet`` (and
    ``visual``), which are moved to ``device`` (the card unless
    ``device="cpu"``) and trained in place.

    ``step_fn(state, batch, generator=None, t=None, noise=None, drop=None)``
    -> ``(state, {"loss", "grad_norm"})``, both 0-d tensors on the device;
    batch keys: ``'mono_mel'`` (B, 1, H, W) and ``'binaural_mel'``
    (B, 2, H, W) in RAW ln-mel range, plus either precomputed ``'feat'``
    (B, 512) or (``'frames'``, ``'pos'``, ``'mask'``) for the live
    visual-encoder path.  ``t``, ``noise`` and ``drop`` are the diffusion
    step, the noise and the CFG drop mask; what is absent is drawn from
    ``generator``.
    """
    device = resolve_device(device)
    diffusion = diffusion or GaussianDiffusion(
        image_size=80, timesteps=1000, sampling_timesteps=25,
        loss_type="l1", objective="pred_noise", beta_schedule="cosine",
        auto_normalize=False, device=device,
    )
    modules = {"unet": unet, "frame": visual}
    group_lr = {"unet": lr_unet, "frame": lr_frame}

    def init_fn() -> Stage1TrainState:
        groups = []
        for name, module in modules.items():
            if module is not None:
                module.to(device)
                groups.append({"params": list(module.parameters()),
                               "lr": group_lr[name], "base_lr": group_lr[name]})
        optimizer = torch.optim.AdamW(groups, betas=(b1, b2), eps=1e-8,
                                      weight_decay=weight_decay)
        return Stage1TrainState(step=0, unet=unet, visual=visual,
                                optimizer=optimizer)

    def loss_fn(state, batch, generator, t, noise, drop):
        def on_device(a):
            return torch.as_tensor(a).to(device)

        mono = normalize_mel(on_device(batch["mono_mel"]).float())
        target = normalize_mel(on_device(batch["binaural_mel"]).float())
        if "feat" in batch:
            feat = on_device(batch["feat"]).float()
        elif state.visual is None:
            raise ValueError(
                "the batch has no 'feat' and the train step was made without "
                "a visual encoder")
        else:
            feat = state.visual(on_device(batch["frames"]),
                                on_device(batch["pos"]),
                                on_device(batch["mask"]))
        t, noise, drop = (None if a is None else on_device(a)
                          for a in (t, noise, drop))
        return diffusion.p_losses(
            state.unet, target, (mono, feat), t=t, noise=noise, drop=drop,
            cfg=cfg, generator=generator)

    def step_fn(state: Stage1TrainState, batch: Dict,
                generator: Optional[torch.Generator] = None, t=None,
                noise=None, drop=None):
        optimizer = state.optimizer
        optimizer.zero_grad(set_to_none=True)
        # dropout stays off in training, as in the JAX train step
        was_training = state.unet.training
        state.unet.eval()
        try:
            loss = loss_fn(state, batch, generator, t, noise, drop)
        finally:
            state.unet.train(was_training)
        loss.backward()

        grad_norm = apply_update_(optimizer, state.lr_scale, clip_norm,
                                  clip_value)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return init_fn, step_fn
