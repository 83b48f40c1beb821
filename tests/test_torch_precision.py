"""float32 stays float32: every float32 entry point of the port switches TF32
off for cuDNN and cuBLAS while it runs, and restores the caller's settings.

PyTorch runs float32 cuDNN convolutions in TF32 by default; the JAX package
computes them in float32.  The settings are read from inside monkeypatched
``F.conv1d``, ``F.conv2d`` and ``torch.matmul`` while each entry point runs
on tiny inputs on the CPU (the flags are process state: the CPU shows what
the card would be told).  The models are toys where the entry point takes
any callable, tiny real ones where it needs a registry encoder."""

import types

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from _torch_port_util import TINY_VOCODER, one_torch_thread  # noqa: F401
from diffbinaural_tpu_torch.cli import common as cli_common
from diffbinaural_tpu_torch.cli import gan_common, inference_binaural
from diffbinaural_tpu_torch.cli import inference_diffbinaural_mels, test_pos
from diffbinaural_tpu_torch.core.config import CLIPConfig, VocoderConfig
from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
from diffbinaural_tpu_torch.infer.pipeline import BinauralPipeline
from diffbinaural_tpu_torch.infer.stage1 import Stage1Sampler
from diffbinaural_tpu_torch.infer.vocoder import Vocoder
from diffbinaural_tpu_torch.models import BinauralBigVGAN, build_vocoder
from diffbinaural_tpu_torch.models.visual import build_visual
from diffbinaural_tpu_torch.train import make_stage1_train_step

TINY_CLIP = dict(image_size=32, patch_size=16, width=64, layers=2, heads=2)


def settings():
    """The TF32 settings as code sees them: the ``fp32_precision`` values of
    cuDNN conv, cuDNN RNN and cuBLAS matmul, then the legacy
    ``cudnn.allow_tf32`` and ``cuda.matmul.allow_tf32`` reads ("raises"
    where PyTorch refuses the read: the two APIs were mixed)."""
    b = torch.backends

    def legacy(backend):
        try:
            return backend.allow_tf32
        except RuntimeError:
            return "raises"

    return ((b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision,
             b.cuda.matmul.fp32_precision), legacy(b.cudnn),
            legacy(b.cuda.matmul))


def float32(state) -> bool:
    """TF32 off for cuDNN and cuBLAS, read through both APIs."""
    values, cudnn, matmul = state
    return "tf32" not in values and cudnn is False and matmul is False


def pytorch_defaults():
    """What a process starts with: TF32 on for cuDNN, off for cuBLAS."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.fp32_precision = "none"


@pytest.fixture
def seen(monkeypatch):
    """The settings inside every F.conv1d / F.conv2d / torch.matmul call,
    with PyTorch's defaults around the test."""
    pytorch_defaults()
    assert settings() == (("tf32", "tf32", "none"), True, False)
    calls = []
    for owner, name in ((F, "conv1d"), (F, "conv2d"), (torch, "matmul")):
        real = getattr(owner, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls.append((_name, settings()))
            return _real(*args, **kwargs)

        monkeypatch.setattr(owner, name, spy)
    yield calls
    pytorch_defaults()


def assert_float32_inside(calls, caller=(("tf32", "tf32", "none"), True,
                                         False)):
    assert calls, "the entry point reached no convolution or matmul"
    inside = sorted({state for _, state in calls}, key=str)
    assert all(float32(state) for state in inside), \
        f"settings inside the entry point: {inside}"
    assert settings() == caller, "the caller's settings were not restored"


class ToyDenoiser(nn.Module):
    """model(x, t, (mix, feat)) -> a (B, 2, H, W) prediction through one
    float32 convolution."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 2, 3, padding=1)

    def forward(self, x, t, cond):
        return self.conv(torch.cat([x, cond[0]], dim=1))


class ToyVocoder(nn.Module):
    """(B, M, T) mel -> (B, 1, T * 4) through one float32 convolution."""

    def __init__(self, mels=4):
        super().__init__()
        self.conv = nn.Conv1d(mels, 4, 3, padding=1)

    def forward(self, mel):
        y = self.conv(mel)
        return y.transpose(1, 2).reshape(mel.shape[0], 1, -1)


def _diffusion(size=16):
    return GaussianDiffusion(image_size=size, timesteps=50,
                             sampling_timesteps=2, device="cpu")


def test_stage1_step(seen):
    init_fn, step_fn = make_stage1_train_step(
        ToyDenoiser(), diffusion=_diffusion(), device="cpu")
    batch = {"mono_mel": np.zeros((2, 1, 16, 16), np.float32),
             "binaural_mel": np.zeros((2, 2, 16, 16), np.float32),
             "feat": np.zeros((2, 512), np.float32)}
    step_fn(init_fn(), batch, generator=torch.Generator().manual_seed(0))
    assert_float32_inside(seen)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_stage1_sampler(seen, sampler):
    s = Stage1Sampler(ToyDenoiser(), _diffusion(80), sampler=sampler,
                      device="cpu")
    with torch.no_grad():
        out = s.sample(np.zeros((1, 1, 80, 80), np.float32),
                       np.zeros((1, 512), np.float32))
    assert out.shape == (1, 2, 80, 80)
    assert_float32_inside(seen)


def test_visual_apply_fn(seen):
    net = build_visual("clip_pos2d", device="cpu",
                       clip=CLIPConfig(**TINY_CLIP))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (1, 3, 1, 2, 32, 32)).astype(np.float32))
    pos = torch.zeros((1, 1, 2, 2))
    mask = torch.zeros((1, 1, 2), dtype=torch.bool)
    with torch.no_grad():
        apply = cli_common.visual_apply_fn(net, "clip_pos2d")
        feat = apply(frames, pos, mask)
    assert feat.shape == (1, 512)
    assert_float32_inside(seen)


def test_dump_clip_mels(seen, tmp_path):
    """The features function runs inside ``dump_clip_mels`` (the encoders'
    calls), then the sampler."""
    conv = nn.Conv1d(1, 1, 1)

    def features(item):
        return conv(torch.ones((1, 1, 512)))[0, 0]

    class Clip:
        full_mel = np.zeros((80, 100), np.float32)
        starts, rows = [0, 20], [{"video_id": "v"}]

        def __len__(self):
            return 2

        def __getitem__(self, i):
            return {}

    s = Stage1Sampler(ToyDenoiser(), _diffusion(80), device="cpu")
    mel = cli_common.dump_clip_mels(types.SimpleNamespace(crop_frames=8), s,
                                    Clip(), str(tmp_path / "l"),
                                    str(tmp_path / "r"), features_fn=features)
    assert mel.shape == (2, 80, 100)
    assert_float32_inside(seen)


def test_vocoder(seen):
    voc = Vocoder(VocoderConfig(**TINY_VOCODER), hop_size=8, pad_multiple=4,
                  device="cpu")
    wav = voc(np.zeros((1, 8, 6), np.float32))
    assert wav.shape == (1, 48)
    assert_float32_inside(seen)


def test_pipeline(seen):
    pipe = BinauralPipeline(ToyDenoiser(), ToyVocoder(), 100, num_mels=4,
                            unet_batch=2, sampling_timesteps=2, device="cpu")
    wav = pipe(np.zeros((1, 4, 100), np.float32), np.zeros((512,), np.float32))
    assert wav.shape[0] == 2 and torch.isfinite(wav).all()
    assert_float32_inside(seen)


def test_test_pos_legacy_sampler(seen):
    class OneWindow:
        total_time_frame, n_mels = 16, 16

        def __len__(self):
            return 1

        def __getitem__(self, i):
            return {"mono_mel": np.ones((1, 16, 16), np.float32),
                    "start_time_frame": 0}

    s = Stage1Sampler(ToyDenoiser(), _diffusion(16), device="cpu")
    mel = test_pos.generate_legacy(s, OneWindow())
    assert mel.shape == (2, 16, 16)
    assert_float32_inside(seen)


def _tiny_binaural(*args, **kwargs):
    model = BinauralBigVGAN(VocoderConfig(**TINY_VOCODER))
    model.generator = build_vocoder(VocoderConfig(**TINY_VOCODER),
                                    device="cpu")
    return model.eval()


@pytest.mark.parametrize("cli", ["inference_binaural",
                                 "inference_diffbinaural_mels"])
def test_binaural_vocoder_clis(seen, monkeypatch, tmp_path, cli):
    hparams = {"sampling_rate": 22050, "hop_size": 8, "num_mels": 8,
               **TINY_VOCODER}
    for mod in (inference_binaural, inference_diffbinaural_mels):
        monkeypatch.setattr(mod, "vocoder_hparams", lambda path: hparams)
        monkeypatch.setattr(mod, "load_binaural", _tiny_binaural)
    mel = np.zeros((8, 6), np.float32)
    for side in ("left", "right"):
        (tmp_path / side).mkdir()
        np.save(tmp_path / side / "a.npy", mel)
    if cli == "inference_binaural":
        inference_binaural.main([
            "--input_left_mel", str(tmp_path / "left" / "a.npy"),
            "--input_right_mel", str(tmp_path / "right" / "a.npy"),
            "--checkpoint_file", "unused", "--output_dir",
            str(tmp_path / "out")], device="cpu")
    else:
        inference_diffbinaural_mels.main([
            "--input_mels_left_dir", str(tmp_path / "left"),
            "--input_mels_right_dir", str(tmp_path / "right"),
            "--checkpoint_file", "unused", "--output_dir",
            str(tmp_path / "out")], device="cpu")
    assert len(list((tmp_path / "out").iterdir())) == 1
    assert_float32_inside(seen)


def test_gan_validation(seen):
    trainer = types.SimpleNamespace(
        gen=ToyVocoder(8), device="cpu", steps=0, h={"sampling_rate": 22050},
        mel_fn=lambda y: F.conv1d(y[:, None], torch.ones((8, 1, 4)), stride=4),
        writer=types.SimpleNamespace(mel_figure=lambda *a, **k: None,
                                     audio=lambda *a, **k: None,
                                     scalar=lambda *a, **k: None))
    batch = {"mel": np.zeros((1, 8, 6), np.float32),
             "mel_loss": np.zeros((1, 8, 6), np.float32)}
    err = gan_common.GanTrainer.validate(trainer, [batch])
    assert np.isfinite(err)
    assert_float32_inside(seen)


def test_restored_after_an_exception(seen):
    class Broken(ToyVocoder):
        def forward(self, mel):
            super().forward(mel)
            raise RuntimeError("inside the vocoder")

    voc = Vocoder(VocoderConfig(**TINY_VOCODER), model=Broken(8), device="cpu")
    with pytest.raises(RuntimeError, match="inside the vocoder"):
        voc(np.zeros((1, 8, 4), np.float32))
    assert_float32_inside(seen)


def test_a_caller_of_the_new_api_is_served_and_restored(seen):
    """A caller that set cuDNN's convolutions and RNNs apart through the
    ``fp32_precision`` API (reading the legacy cuDNN flag then raises) gets
    no RuntimeError, float32 inside, and its own settings back."""
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    torch.backends.cudnn.rnn.fp32_precision = "tf32"
    caller = settings()
    assert caller == (("ieee", "tf32", "none"), "raises", False)
    voc = Vocoder(VocoderConfig(**TINY_VOCODER), model=ToyVocoder(8),
                  device="cpu")
    voc(np.zeros((1, 8, 4), np.float32))
    assert_float32_inside(seen, caller=caller)


@pytest.mark.parametrize("caller", ["legacy_tf32_on", "legacy_tf32_off",
                                    "matmul_tf32_by_the_new_api"])
def test_other_callers_get_their_settings_back(seen, caller):
    """A caller of the legacy API (TF32 on for both, or off for both) and
    one that turned cuBLAS TF32 on through ``fp32_precision``."""
    b = torch.backends
    if caller == "legacy_tf32_on":
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = True
    elif caller == "legacy_tf32_off":
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    else:
        b.cuda.matmul.fp32_precision = "tf32"
    before = settings()
    voc = Vocoder(VocoderConfig(**TINY_VOCODER), model=ToyVocoder(8),
                  device="cpu")
    voc(np.zeros((1, 8, 4), np.float32))
    inside = [state for _, state in seen]
    assert inside and all(float32(state) for state in inside), inside
    after = settings()
    # the fp32_precision values come back exactly; the legacy reads too,
    # except where the caller's mix made one raise
    assert after[0] == before[0]
    for was, now in zip(before[1:], after[1:]):
        assert was == now or was == "raises", (before, after)
