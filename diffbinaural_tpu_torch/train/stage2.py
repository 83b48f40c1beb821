"""Stage-2 GAN vocoder training: one D step and one G step on the card —
counterpart of ``diffbinaural_tpu/train/stage2.py``.

  * AdamW for the generator and for the chained (MPD + MRD/CQTD)
    discriminators, betas (adam_b1, adam_b2), eps 1e-8, weight decay 1e-2
  * a per-step exponential learning rate, ``learning_rate * lr_decay**step``
  * the D step on the detached generator output, its gradients clipped by
    global norm; frozen for the first ``freeze_step`` steps (then nothing of
    D runs, its parameters and moments stay, and the G loss is the mel term
    alone)
  * the G step against the UPDATED discriminators: lambda x mel (multi-scale
    on the waveforms, or one mel scale + 0.2 lambda silence-aware) + feature
    matching + LS-GAN for both discriminator families

The generator runs forward ONCE per step: its output is used detached by
the D phase and live by the G phase (the JAX step writes the forward twice
and leaves XLA to share it; the values are the same).  Gradients are taken
with ``torch.autograd.grad`` on explicit parameter lists, so the G backward
writes nothing into the discriminators' gradients.  The real branch of the
G phase's feature matching runs without a gradient (the JAX step's
``stop_gradient``).

The update is optax's chain: clip by global norm -> Adam moments (eps
outside the root, bias-corrected) -> + 1e-2 * p on every parameter ->
x -lr.  ``torch.optim.AdamW`` computes the last three; the clip is
``train.stage1.clip_by_global_norm_``, which divides by the norm itself as
optax does.  Every parameter is updated, with a zero gradient where the
loss did not reach it, as optax does.

The modules are trained in place (what buffer donation buys the JAX step).
The step runs float32 convolutions and matmuls at full precision, as the
JAX package pins them for the discriminators and the spectral frontends:
it turns TF32 off for cuDNN and cuBLAS while it runs (PyTorch's cuDNN
default is on) and restores the caller's setting after.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..losses import (discriminator_loss, feature_loss, generator_loss,
                      simple_silence_aware_mel_loss)
from .stage1 import clip_by_global_norm_


@dataclass
class Stage2TrainState:
    step: int
    generator: nn.Module
    mpd: nn.Module
    mrd: nn.Module            # the MRD, MBD or sub-band CQTD
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer


@contextlib.contextmanager
def _full_precision():
    """float32 cuDNN convolutions and cuBLAS matmuls without TF32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _params(*modules):
    return [p for m in modules for p in m.parameters()]


def _adamw_step_(optimizer, params, grads, lr: float, clip: float):
    """Clip ``grads`` by global norm in place, hand them to ``params``
    (``.grad`` keeps them until the next step replaces them) and take one
    AdamW step at ``lr``.  Returns the pre-clip norm."""
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    norm = clip_by_global_norm_(grads, clip)
    for p, g in zip(params, grads):
        p.grad = g
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return norm


def make_stage2_train_step(
    generator: nn.Module,
    mpd: nn.Module,
    mrd: nn.Module,
    mel_fn: Callable,
    multiscale_mel_loss: Optional[Callable] = None,
    learning_rate: float = 5e-5,
    adam_b1: float = 0.8,
    adam_b2: float = 0.99,
    lr_decay: float = 0.9999996,
    clip_grad_norm: float = 500.0,
    lambda_melloss: float = 60.0,
    freeze_step: int = 0,
    use_multiscale_melloss: bool = True,
    silence_threshold_db: float = -50.0,
    remat: bool = False,
    device=None,
) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn, step_fn)``.

    ``generator``: mel (B, M, T) -> (B, 1, T * hop); ``mpd`` / ``mrd``:
    ``(y, y_hat) -> (real_logits, fake_logits, real_fmaps, fake_fmaps)``
    with ``single(x) -> (logits, fmaps)`` (``models.discriminators``);
    ``mel_fn``: waveform (B, T) -> mel (B, M, frames), differentiable.
    ``remat`` recomputes the generator's and the discriminators' forwards in
    the backward pass (``torch.utils.checkpoint``, non-reentrant) to trade
    time for memory.

    ``init_fn()`` -> :class:`Stage2TrainState` around the three modules,
    moved to ``device`` (the card unless ``device="cpu"``).

    ``step_fn(state, batch)`` -> ``(state, metrics)``; batch keys ``'mel'``
    (B, M, T) input mels, ``'audio'`` (B, T * hop) target waveforms,
    ``'mel_loss'`` (B, M, T) loss-target mels (used when
    ``use_multiscale_melloss`` is off).  Metrics: ``loss_disc``,
    ``loss_gen_all``, ``loss_mel`` (divided by lambda), ``loss_fm``,
    ``grad_norm_g`` (pre-clip), 0-d tensors on the device, and ``lr``.
    """
    device = resolve_device(device)
    if use_multiscale_melloss and multiscale_mel_loss is None:
        raise ValueError("use_multiscale_melloss needs multiscale_mel_loss")

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def init_fn() -> Stage2TrainState:
        for m in (generator, mpd, mrd):
            m.to(device)

        def adamw(params):
            return torch.optim.AdamW(params, lr=learning_rate,
                                     betas=(adam_b1, adam_b2), eps=1e-8,
                                     weight_decay=1e-2)

        return Stage2TrainState(
            step=0, generator=generator, mpd=mpd, mrd=mrd,
            gen_opt=adamw(_params(generator)),
            disc_opt=adamw(_params(mpd, mrd)))

    def d_loss_fn(state, y, y_hat_sg):
        rs_f, gs_f, _, _ = run(state.mpd, y, y_hat_sg)
        loss_f, _, _ = discriminator_loss(rs_f, gs_f)
        rs_s, gs_s, _, _ = run(state.mrd, y, y_hat_sg)
        loss_s, _, _ = discriminator_loss(rs_s, gs_s)
        return loss_f + loss_s

    def mel_loss_fn(batch, y, y_g_hat):
        if use_multiscale_melloss:
            return multiscale_mel_loss(y, y_g_hat) * lambda_melloss
        y_mel = batch["mel_loss"]
        y_g_hat_mel = mel_fn(y_g_hat[:, 0, :])
        base = torch.mean(torch.abs(y_mel - y_g_hat_mel)) * lambda_melloss
        silence = simple_silence_aware_mel_loss(
            y_mel, y_g_hat_mel, silence_threshold_db, 2.0)
        return base + silence * (lambda_melloss * 0.2)

    def adv_fn(state, y, y_g_hat):
        loss_gen, loss_fm = 0.0, 0.0
        for disc in (state.mpd, state.mrd):
            with torch.no_grad():
                _, fm_r = disc.single(y)
            logits_g, fm_g = run(disc.single, y_g_hat)
            loss_fm = loss_fm + feature_loss(fm_r, fm_g)
            loss_gen = loss_gen + generator_loss(logits_g)[0]
        return loss_gen + loss_fm, loss_gen, loss_fm

    def step_fn(state: Stage2TrainState, batch: Dict):
        with _full_precision():
            return _step(state, batch)

    def _step(state: Stage2TrainState, batch: Dict):
        def on_device(a):
            return torch.as_tensor(a).to(device).float()

        batch = {k: on_device(v) for k, v in batch.items()}
        frozen = state.step < freeze_step
        lr = learning_rate * lr_decay ** state.step
        y = batch["audio"][:, None, :]
        zero = torch.zeros((), device=device)

        y_g_hat = run(state.generator, batch["mel"])   # (B, 1, T * hop)

        # ---- D phase on the detached generator output
        if frozen:
            d_loss = zero
        else:
            d_params = _params(state.mpd, state.mrd)
            d_loss = d_loss_fn(state, y, y_g_hat.detach())
            d_grads = torch.autograd.grad(d_loss, d_params, allow_unused=True)
            _adamw_step_(state.disc_opt, d_params, d_grads, lr, clip_grad_norm)

        # ---- G phase against the updated discriminators
        loss_mel = mel_loss_fn(batch, y, y_g_hat)
        if frozen:
            adv, loss_gen, loss_fm = zero, zero, zero
        else:
            adv, loss_gen, loss_fm = adv_fn(state, y, y_g_hat)
        g_loss = adv + loss_mel
        g_params = _params(state.generator)
        g_grads = torch.autograd.grad(g_loss, g_params, allow_unused=True)
        grad_norm = _adamw_step_(state.gen_opt, g_params, g_grads, lr,
                                 clip_grad_norm)

        state.step += 1
        metrics = {
            "loss_disc": d_loss.detach(),
            "loss_gen_all": g_loss.detach(),
            "loss_mel": loss_mel.detach() / lambda_melloss,
            "loss_fm": loss_fm.detach(),
            "grad_norm_g": grad_norm,
            "lr": lr,
        }
        return state, metrics

    return init_fn, step_fn
