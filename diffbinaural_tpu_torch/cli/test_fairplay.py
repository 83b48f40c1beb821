"""Stage 1 over a FairPlay test split — counterpart of
``diffbinaural_tpu/cli/test_fairplay.py``: ``test_realbinaural``'s clip
loop over ``GenAudioFairPlayDataset`` (key ``mix_mel``), same flags.

Run: python -m diffbinaural_tpu_torch.cli.test_fairplay --list_test ...

``main(argv, device="cpu")`` runs it on the CPU; by default it runs on the
card and raises without one.
"""

from __future__ import annotations

from ..core.device import resolve_device
from ..data import GenAudioFairPlayDataset
from .arguments import ArgParser
from .test_realbinaural import run


def main(argv=None, *, device=None):
    args = ArgParser().parse_test_arguments(argv)
    run(args, GenAudioFairPlayDataset, mel_key="mix_mel",
        device=resolve_device(device))


if __name__ == "__main__":
    main()
