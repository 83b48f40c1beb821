"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raises when there is none (an entry point
    never falls back to the CPU on its own).  Pass ``"cpu"`` explicitly to
    run the plain PyTorch versions, as the CPU tests do.  Under a launcher
    (``python -m torch.distributed.run``) the card is ``cuda:LOCAL_RANK``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        if "LOCAL_RANK" in os.environ:
            return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        return torch.device("cuda")
    return torch.device(device)
