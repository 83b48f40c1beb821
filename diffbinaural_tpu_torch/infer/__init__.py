from .pipeline import BinauralPipeline
from .stage1 import (
    MEL_MAX,
    MEL_MIN,
    Stage1Sampler,
    crop_spans,
    denormalize_mel,
    generate_clip,
    normalize_mel,
    window_starts,
)
from .vocoder import (
    Vocoder,
    detect_and_exclude_zero_frames,
    reconstruct_audio_with_silence,
)
