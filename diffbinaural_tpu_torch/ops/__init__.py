"""The port's hand-written kernels, each beside its plain PyTorch version."""

from .alias_free_act import (
    alias_free_snake_backward_plain,
    alias_free_snake_plain,
    fused_alias_free_snake,
    fused_alias_free_snake_backward,
)
from .flash_d32 import (
    flash_sdpa,
    flash_sdpa_backward,
    flash_sdpa_with_lse,
    sdpa_backward_plain,
    sdpa_plain,
    sdpa_plain_with_lse,
)
from .snake_conv import (
    fused_snake_conv,
    fused_snake_conv_backward,
    fused_snake_conv_backward_composed,
    snake_conv_backward_plain,
    snake_conv_dgrad,
    snake_conv_dgrad_plain,
    snake_conv_eligible,
    snake_conv_plain,
    snake_conv_wgrad,
    snake_conv_wgrad_plain,
)

WRAPPERS = {
    "flash_sdpa": flash_sdpa,
    "flash_sdpa_with_lse": flash_sdpa_with_lse,
    "flash_sdpa_backward": flash_sdpa_backward,
    "fused_alias_free_snake": fused_alias_free_snake,
    "fused_alias_free_snake_backward": fused_alias_free_snake_backward,
    "fused_snake_conv": fused_snake_conv,
    "fused_snake_conv_backward": fused_snake_conv_backward,
    "snake_conv_dgrad": snake_conv_dgrad,
    "snake_conv_wgrad": snake_conv_wgrad,
}


def launch_counts() -> dict:
    """Kernel launches made by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "alias_free_snake_backward_plain", "alias_free_snake_plain",
    "fused_alias_free_snake", "fused_alias_free_snake_backward", "flash_sdpa",
    "flash_sdpa_backward", "flash_sdpa_with_lse", "sdpa_backward_plain",
    "sdpa_plain", "sdpa_plain_with_lse", "fused_snake_conv",
    "fused_snake_conv_backward", "fused_snake_conv_backward_composed",
    "snake_conv_backward_plain", "snake_conv_dgrad", "snake_conv_dgrad_plain",
    "snake_conv_eligible", "snake_conv_plain", "snake_conv_wgrad",
    "snake_conv_wgrad_plain", "launch_counts", "reset_launch_counts",
]
