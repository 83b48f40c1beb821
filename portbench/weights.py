"""Seeded random weights, drawn on the device in one call per module.

The benchmark makes every weight itself: a parameter's distribution follows
from its name and shape (the port and the plain reference name their leaves
alike), and every leaf is a slice of ONE normal draw N from a
``torch.Generator`` seeded with the run's seed, so the port and the
reference, filled on the same device from the same seed, hold the same
numbers.  Leaves are taken in sorted name order.  No leaf starts as an
identity (a zero bias, a unit gain, alpha = beta = 1, g = ||v||), so a path
that leaves out a bias, a gain, a snake parameter or the weight norm gives
another answer than the reference's from the first call on:

  * 2-D dense kernels: N(0, 1 / fan_in); 4-D convolution kernels of the
    UNet likewise; its output projection ``final_conv`` N(0, 2 / fan_in)
  * weight-normed 1-D kernels ``v`` of the generator: N(0, 0.25 / fan_in),
    which keeps the waveform inside (-1, 1) with both the mel and the
    biases moving it (at 1 / fan_in it saturates; at BigVGAN's own 0.01
    the biases drown the mel); the discriminators' 4-D ``v``:
    N(0, 2 / fan_in); every gain ``g`` beside a ``v`` is
    ||v|| (1 + N(0, 0.1^2)) per output row
  * biases N(0, 0.1^2); snake parameters (log scale) N(0, 0.1^2); norm
    gains 1 + N(0, 0.1^2)
"""

from __future__ import annotations

import math

import torch

SPREAD = 0.1


def _rule(name: str, shape) -> tuple:
    """(mean, std, name of the ``v`` whose row norms scale the leaf or
    None): the leaf is (mean + std N) * ||v||."""
    leaf = name.rsplit(".", 1)[-1]
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    if leaf == "v":
        if len(shape) == 4:
            return (0.0, math.sqrt(2.0 / fan_in), None)
        return (0.0, 0.5 * math.sqrt(1.0 / fan_in), None)
    if leaf in ("b", "bias", "alpha", "beta"):
        return (0.0, SPREAD, None)
    if leaf == "weight" and len(shape) >= 2:
        if name.endswith("final_conv.weight"):
            return (0.0, math.sqrt(2.0 / fan_in), None)
        return (0.0, math.sqrt(1.0 / fan_in), None)
    if leaf == "g" and len(shape) == 1:
        return (1.0, SPREAD, name[:-1] + "v")
    return (1.0, SPREAD, None)


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Write seeded weights into every parameter of ``module`` in place, on
    the device the module lies on."""
    params = dict(sorted(module.named_parameters()))
    rules = {n: _rule(n, tuple(p.shape)) for n, p in params.items()}
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(p.numel() for p in params.values())
    draw = torch.randn(total, generator=gen, device=device)
    at = 0
    for n, p in params.items():
        mean, std, _ = rules[n]
        p.copy_(draw[at: at + p.numel()].view_as(p) * std + mean)
        at += p.numel()
    del draw
    for n, (_, _, v_name) in rules.items():
        if v_name in params:
            v = params[v_name]
            params[n].mul_(torch.sqrt((v * v).sum(dim=tuple(range(1,
                                                                 v.dim())))))
    return module
