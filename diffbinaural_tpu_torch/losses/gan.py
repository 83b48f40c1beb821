"""LS-GAN and feature-matching losses — counterpart of
``diffbinaural_tpu/losses/gan.py``.  Logits and feature maps are upcast to
float32 before every reduction (they arrive in bfloat16 when the
discriminators compute in bfloat16)."""

from __future__ import annotations

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 x the sum of mean |fr - fg| over every feature map of every
    sub-discriminator.  The caller passes the real maps without a gradient
    (the JAX step's ``stop_gradient``)."""
    total = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            total = total + torch.mean(torch.abs(rl.float() - gl.float()))
    return 2.0 * total


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LS-GAN D loss: mean (1 - D(y))^2 + mean D(y_hat)^2 per
    sub-discriminator.  Returns (sum, real losses, generated losses)."""
    losses, r_losses, g_losses = 0.0, [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1.0 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        losses = losses + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return losses, r_losses, g_losses


def generator_loss(disc_outputs):
    """LS-GAN G loss: mean (1 - D(y_hat))^2 per sub-discriminator.  Returns
    (sum, per-sub-discriminator losses)."""
    gen_losses = [torch.mean((1.0 - dg.float()) ** 2) for dg in disc_outputs]
    return sum(gen_losses), gen_losses
