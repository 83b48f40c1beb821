"""Command-line entry points — counterparts of the JAX package's scripts in
``diffbinaural_tpu/cli/``, with the same flags:

  * ``generate_binaural``: mono wav -> binaural wav, from a stage-1 UNet
    checkpoint and a generator checkpoint;
  * ``inference_e2e``: paired left / right mel directories -> stereo wavs
    through ``infer.vocoder.Vocoder`` (zero-frame silence handling);
  * ``inference_binaural``: ``BinauralBigVGAN`` on a mel pair, a directory
    of ``*_left.npy`` / ``*_right.npy`` pairs, or stereo wavs;
  * ``inference_diffbinaural_mels``: ``BinauralBigVGAN`` over two mel
    directories, clip-protected output;
  * ``test_realbinaural`` / ``test_fairplay`` / ``test_pos`` /
    ``test_realbinaural_few``: stage 1 over a test split (the L/R mels of
    every clip; the few-sample check's figures);
  * ``evaluate_binaural_22050`` / ``evaluate_mel_spectrogram_rmse``: the
    metric battery over generated wavs, the mel RMSE of predicted mels.

The training CLIs (``train_*``) are the JAX trainers' as well.

Each has ``main(argv=None, *, device=None)``: the card unless the caller
passes ``device="cpu"``; without a card and without that argument it
raises.  Checkpoints are the JAX trainers' flax-msgpack files
(``core/checkpoint.py``), with ``config.json`` beside the generator's.
"""

from __future__ import annotations

import os

import torch

from ..convert import bigvgan_params_from_flax
from ..core import checkpoint
from ..core.config import AttrDict, VocoderConfig, load_hparams_from_json
from ..models import BigVGAN, build_vocoder


def vocoder_hparams(checkpoint_file: str) -> AttrDict:
    """The ``config.json`` beside a generator checkpoint."""
    return load_hparams_from_json(
        os.path.join(os.path.dirname(checkpoint_file), "config.json"))


def load_generator(checkpoint_file: str, config: VocoderConfig,
                   dtype=torch.float32, device=None) -> BigVGAN:
    """The BigVGAN generator of a checkpoint holding ``{"generator":
    params}`` (a trainer's ``g_%08d``) or the generator's tree alone, on
    ``device``; ``dtype`` is the compute type (parameters stay float32)."""
    state = checkpoint.load_checkpoint(checkpoint_file)
    if isinstance(state, dict) and "generator" in state:
        state = state["generator"]
    model = build_vocoder(config, dtype=dtype, device=device)
    model.load_state_dict(bigvgan_params_from_flax(state), strict=True)
    return model
