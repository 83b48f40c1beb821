from .helpers import (
    AverageMeter,
    warpgrid,
    istft_reconstruction,
    makedirs,
    plot_spectrogram,
    plot_spectrogram_fixed,
    magnitude2heatmap,
    normalize_audio_pair,
    rms_normalize,
)
from .summary import SummaryLogger
from .profiling import trace, span, device_memory_stats
