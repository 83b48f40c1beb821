"""float32 that stays float32 on the card.

PyTorch runs float32 cuDNN convolutions in TF32 by default (about three
decimal digits), while the JAX package, the oracle of the port, computes in
float32 where it relies on float32.  :func:`full_precision` switches TF32 off
for cuDNN (convolutions and RNNs) and cuBLAS matmuls while it is entered,
and restores the caller's settings on exit, also after an exception.  It
touches float32 operations only: bfloat16 ones run as before.

PyTorch has two APIs for these settings, and they interlock: once a caller
has set cuDNN's convolutions and RNNs apart through the per-backend
``fp32_precision`` attributes, reading the legacy
``torch.backends.cudnn.allow_tf32`` raises ``RuntimeError``.  So the
caller's settings are read through ``fp32_precision`` alone, which never
raises.  Inside, TF32 is switched off through the legacy setters, which
leave both APIs agreeing (a legacy read inside gives False).  On exit the
legacy setters put back what the caller's ``fp32_precision`` values imply
(TF32 on where conv and RNN are both "tf32", and for cuBLAS where matmul
is), and any ``fp32_precision`` value that still differs is set back
through that API: the caller gets its own values, and a caller of the
legacy API its legacy flags.
"""

from __future__ import annotations

import contextlib

import torch


def _backends():
    """The three settings that decide TF32 for float32 work on the card."""
    b = torch.backends
    return (b.cudnn.conv, b.cudnn.rnn, b.cuda.matmul)


def precision_state() -> tuple:
    """``(cudnn conv, cudnn rnn, cuda matmul)`` ``fp32_precision`` values:
    "ieee" is float32, "tf32" TF32, "none" the inherited default."""
    return tuple(b.fp32_precision for b in _backends())


@contextlib.contextmanager
def full_precision():
    """float32 cuDNN convolutions and RNNs and cuBLAS matmuls without TF32."""
    saved = precision_state()
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
    finally:
        conv, rnn, matmul = saved
        torch.backends.cudnn.allow_tf32 = conv == rnn == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = matmul == "tf32"
        for b, value in zip(_backends(), saved):
            if b.fp32_precision != value:
                b.fp32_precision = value
