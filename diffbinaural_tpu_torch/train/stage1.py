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

The JAX train step applies the UNet and the frame encoder with dropout off,
and so does this one, whatever the modules' ``train()``/``eval()`` flags
say; it leaves every flag as it found it.

Made with a ``mesh`` (``parallel.make_mesh``), the step is data-parallel
over its ``data`` axis, as the JAX step is over its mesh: each rank is given
its block of the global batch (``parallel.shard_batch``), draws t, noise and
the CFG mask at the GLOBAL batch's shapes from a generator seeded alike on
every rank and keeps its rows (so the draws do not depend on the number of
ranks), and averages the gradients and the loss over ``data`` with one flat
all-reduce before the clip.  The loss is a batch mean, so over equal blocks
the mean of the ranks' gradients is the gradient of the global loss.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.precision import full_precision
from ..diffusion import GaussianDiffusion
from ..infer.stage1 import normalize_mel
from ..models.visual import apply_visual
from ..parallel.mesh import DATA, all_reduce_mean_, axis_size, data_rows


_CFG_DROP = 0.1  # p_losses' CFG drop probability (its ``threshold``)


@dataclass
class Stage1TrainState:
    step: int
    unet: nn.Module
    visual: Optional[nn.Module]
    optimizer: torch.optim.Optimizer
    lr_scale: float = 1.0  # host-updated multiplicative LR factor


@contextlib.contextmanager
def _dropout_off(*modules: Optional[nn.Module]):
    """Every sub-module of ``modules`` (None entries skipped) in ``eval()``
    mode inside the block, each one's own flag restored after it."""
    flags = [(m, m.training) for module in modules if module is not None
             for m in module.modules()]
    try:
        for m, _ in flags:
            m.training = False
        yield
    finally:
        for m, flag in flags:
            m.training = flag


def clip_by_global_norm_(grads, max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: gradients are left alone
    when their global norm is below ``max_norm`` and become
    ``g / norm * max_norm`` otherwise.  Returns the pre-clip norm, computed
    here unless given.  No host synchronisation: the choice is a
    ``torch.where`` on the device."""
    if norm is None:
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
                  clip_norm: float, clip_value: Optional[float],
                  mesh=None, averaged=()) -> torch.Tensor:
    """One optimiser update from the gradients that lie in ``.grad``: with a
    ``mesh``, their mean over its ``data`` axis (``averaged``, e.g. the
    loss, rides along in the same all-reduce); then clip by global norm,
    optional clip by value, AdamW at ``base_lr * lr_scale`` per group.
    Returns the pre-clip global norm."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        # optax updates every leaf (weight decay included); AdamW would skip
        # a parameter that the loss did not reach
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if mesh is not None:
        all_reduce_mean_(grads + list(averaged), mesh)
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
    mesh=None,
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
    visual-encoder path: frames (B, 3, T, N, H, W), the positions the
    encoder's family takes (3-D for ``ClipPos``, 2-D otherwise; unread by
    ``ResnetEncoder`` and ``ClipEncoder``, which take the mean over the N
    sources), mask (B, T, N) True = invalid.  ``t``, ``noise`` and
    ``drop`` are the diffusion step, the noise and the CFG drop mask; what
    is absent is drawn from ``generator``.

    With ``mesh``, ``batch`` is this rank's block of a global batch of
    ``B * data size`` rows, the draws are made at the global shapes, and
    the returned ``loss`` and ``grad_norm`` are the global values.
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
            feat = apply_visual(state.visual, on_device(batch["frames"]),
                                on_device(batch["pos"]),
                                on_device(batch["mask"]))
        t, noise, drop = (None if a is None else on_device(a)
                          for a in (t, noise, drop))
        if mesh is not None:
            t, noise, drop = global_draws(target, generator, t, noise, drop)
        return diffusion.p_losses(
            state.unet, target, (mono, feat), t=t, noise=noise, drop=drop,
            cfg=cfg, generator=generator)

    def global_draws(target, generator, t, noise, drop):
        """What ``p_losses`` would draw, in its order, at the global batch's
        shapes; this rank keeps its rows."""
        b = target.shape[0] * axis_size(mesh, DATA)
        rows, dev = data_rows(b, mesh), target.device
        if t is None:
            t = torch.randint(0, diffusion.num_timesteps, (b,),
                              generator=generator, device=dev)[rows]
        if noise is None:
            noise = torch.randn((b,) + tuple(target.shape[1:]),
                                generator=generator, dtype=target.dtype,
                                device=dev)[rows]
        if cfg and drop is None:
            drop = (torch.rand((b,), generator=generator, device=dev)
                    < _CFG_DROP)[rows]
        return t, noise, drop

    def step_fn(state: Stage1TrainState, batch: Dict,
                generator: Optional[torch.Generator] = None, t=None,
                noise=None, drop=None):
        optimizer = state.optimizer
        optimizer.zero_grad(set_to_none=True)
        # dropout stays off in training, as in the JAX train step
        with full_precision(), _dropout_off(state.unet, state.visual):
            loss = loss_fn(state, batch, generator, t, noise, drop)
            loss.backward()

        loss = loss.detach()
        grad_norm = apply_update_(optimizer, state.lr_scale, clip_norm,
                                  clip_value, mesh, averaged=(loss,))
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return init_fn, step_fn
