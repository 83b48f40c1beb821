from .filters import (
    DownSample1d,
    LowPassFilter1d,
    UpSample1d,
    kaiser_sinc_filter1d,
)
from .stft import (
    dynamic_range_compression,
    dynamic_range_decompression,
    hann_window,
    mel_filterbank,
    mel_spectrogram,
    num_frames,
    stft_complex,
    stft_magnitude,
)
from .cqt import cqt, cqt_kernels
