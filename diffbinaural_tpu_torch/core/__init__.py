from .config import (
    AttrDict,
    AudioConfig,
    CLIPConfig,
    CLIPTextConfig,
    DiffusionConfig,
    UnetConfig,
    VocoderConfig,
    load_hparams_from_json,
)
from .device import resolve_device
