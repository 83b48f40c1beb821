"""Stage-2 losses — counterparts of ``diffbinaural_tpu/losses``."""

from .binaural_enhanced import BinauralEnhancedLoss, enhanced_l1_loss
from .gan import discriminator_loss, feature_loss, generator_loss
from .multiscale_mel import MultiScaleMelSpectrogramLoss
from .silence import (
    adaptive_loss_weighting,
    detect_silence_regions,
    energy_regularization_loss,
    silence_aware_loss,
    simple_silence_aware_mel_loss,
    spectral_consistency_loss,
)

__all__ = [
    "BinauralEnhancedLoss", "MultiScaleMelSpectrogramLoss",
    "adaptive_loss_weighting", "detect_silence_regions",
    "discriminator_loss", "energy_regularization_loss", "enhanced_l1_loss",
    "feature_loss", "generator_loss", "silence_aware_loss",
    "simple_silence_aware_mel_loss", "spectral_consistency_loss",
]
