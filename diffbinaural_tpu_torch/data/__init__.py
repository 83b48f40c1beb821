from .audio_io import load_wav, save_wav, resample, normalize_audio
from .meldataset import MelDataset, get_dataset_filelist
from .binaural import BinauralMelSpectrogramDataset, BinauralCombinedDataset
from .loader import DataLoader, default_collate
from .stage1 import (
    FairPlayPosLeftDataset,
    RealBinauralDataset,
    FairPlayPosDataset,
    FairPlayPosRightDataset,
    GenAudioRealBinauralDataset,
    GenAudioFairPlayDataset,
    GenAudioPosDataset,
)
from . import position_utils
from .clip_tokenizer import SimpleTokenizer
