"""What the drivers share: seeded streams, synthetic audio made on the
device, and the hooks that count work for the kernels' rooflines."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..roofline import attention_work, snake_conv_work


def derive(seed: int, k: int) -> int:
    """The ``k``-th seed derived from a run's seed."""
    return (seed * 1_000_003 + k) % (1 << 62)


def stream(seed: int, k: int, device) -> torch.Generator:
    """The ``k``-th independent generator of a run's seed."""
    return torch.Generator(device=device).manual_seed(derive(seed, k))


def synthetic_audio(gen, batch: int, n: int, sr: int, device) -> torch.Tensor:
    """(batch, n) float32 in [-1, 1]: four drifting tones (80 Hz - 6 kHz)
    under a slow envelope, a little noise, and every fourth row's second
    half 60 dB down."""
    def draw(lo, hi):
        return lo + (hi - lo) * torch.rand((batch, 4, 1), generator=gen,
                                           device=device)

    t = torch.arange(n, device=device, dtype=torch.float32) / sr
    amp, f0 = draw(0.02, 0.2), draw(80.0, 6000.0)
    rate, phase = draw(0.5, 3.0), draw(0.0, 2 * math.pi)
    drift = 1.0 + 0.1 * torch.sin(2 * math.pi * rate * t)
    y = (amp * torch.sin(2 * math.pi * f0 * drift * t + phase)).sum(1)
    y = y * (0.6 + 0.4 * torch.sin(2 * math.pi * 0.3 * t))
    y = y + 0.005 * torch.randn((batch, n), generator=gen, device=device)
    y[3::4, n // 2:] *= 1e-3
    return y.clamp(-1.0, 1.0)


def pick(seed: int, done: list, count: int, must=()) -> list:
    """``count`` indices of ``done`` drawn from the seed, ``must`` first."""
    rng = np.random.default_rng(seed)
    rest = [i for i in range(len(done)) if i not in must]
    rng.shuffle(rest)
    return sorted(list(must) + rest[: max(0, count - len(must))])


def hook_attention_work(unet, spans, min_tokens: int = 1024, d: int = 32):
    """Record the work of every full self-attention that runs on the
    attention kernel (n >= ``min_tokens`` tokens, head size ``d``) while
    the spans annotate: family ``k1``."""
    def pre(mod, args):
        if spans.annotate:
            b, h, w, _ = args[0].shape
            if h * w >= min_tokens and mod.dim_head == d:
                spans.work["k1"].append(
                    attention_work(b, mod.heads, h * w, mod.dim_head))

    return [m.register_forward_pre_hook(pre) for m in unet.modules()
            if type(m).__name__ == "Attention"]


def hook_snake_conv_work(generator, spans):
    """Record the work of every convolution that takes its activation fused
    (called with ``snake=``) while the spans annotate: family ``k3``."""
    def pre(mod, args, kwargs):
        if spans.annotate and kwargs.get("snake") is not None:
            b, c_in, t = args[0].shape
            c_out, _, k = mod.v.shape
            spans.work["k3"].append(snake_conv_work(b, c_in, t, c_out, k))

    return [m.register_forward_pre_hook(pre, with_kwargs=True)
            for m in generator.modules() if type(m).__name__ == "WNConv1d"]


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Widest gap of ``got`` from ``want``, over ``want``'s largest value."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products at full precision, or, for the control, in TF32
    (cuBLAS and cuDNN), the step below float32 on this card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
