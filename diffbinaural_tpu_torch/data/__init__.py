from .audio_io import load_wav, normalize_audio, resample, save_wav
