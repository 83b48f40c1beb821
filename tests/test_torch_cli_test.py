"""The port's four test CLIs (``main(argv, device="cpu")``) against the JAX
package's on the same checkpoints, written by the JAX package's
``save_checkpoint``, and on the same tiny RealBinaural world (1.2 s clips,
16 mel bands, detections and JPEG frames for one clip).

Tiny: the CLIs' hard-coded dim-64 UNet becomes dim 16 and ViT-B/32 the
tiny CLIP tower of ``test_torch_cli_train.py`` (a test-only monkeypatch of
the constructors the CLIs call, on both sides), and the DDIM runs 3 steps
(25 and 50 in the CLIs).  The port is given the JAX samplers' x_T for seed
13 (``_JaxNoiseDiffusion``); each JAX CLI runs once
per module (one compile of its sampler).  Every ``.npy`` the port writes
equals the JAX CLI's within 1e-4 of the output's scale."""

import csv
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import diffbinaural_tpu.diffusion as jax_diffusion
import diffbinaural_tpu.models as jax_models
import diffbinaural_tpu.cli.common as jax_common
import diffbinaural_tpu.models.visual as jax_visual
from diffbinaural_tpu.cli import test_pos as jax_pos
from diffbinaural_tpu.cli import test_realbinaural as jax_realbinaural
from diffbinaural_tpu.cli import test_realbinaural_few as jax_few
from diffbinaural_tpu.core import checkpoint as jax_ckpt
from diffbinaural_tpu.core.config import CLIPConfig as JaxCLIPConfig
from diffbinaural_tpu.data import GenAudioFairPlayDataset as JaxFairPlay
from diffbinaural_tpu.data import GenAudioRealBinauralDataset as JaxRealBinaural
from diffbinaural_tpu_torch.cli import (test_fairplay, test_pos,
                                        test_realbinaural,
                                        test_realbinaural_few)
from diffbinaural_tpu_torch.core.config import CLIPConfig, UnetConfig
from diffbinaural_tpu_torch.data.audio_io import save_wav
from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
from diffbinaural_tpu_torch.models.visual import build_visual

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import random_params, t

SR, M, STEPS = 22050, 16, 3
SECONDS = 1.2  # 103 frames: windows at 0 and 23, one group
TINY_CLIP = dict(image_size=224, patch_size=112, width=32, layers=1, heads=2)
MEL_TOL = 1e-4  # of the output's scale (max |JAX mel|)
REAL_JAX_AVM = jax_models.AudioVisualModel
REAL_JAX_DIFFUSION = jax_diffusion.GaussianDiffusion
REAL_JAX_BUILD_VISUAL = jax_visual.build_visual
REAL_JAX_VISUAL_APPLY_FN = jax_common.visual_apply_fn


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two 1.2 s mono clips (``a`` with detections of two sources and three
    64x36 JPEG frames, ``b`` without), both under
    ``processed/mono_audios_22050Hz/`` and at the root, the test split, and
    ``ckpt/tiny``: ``unet_best.pth`` / ``frame_best.pth`` and two numbered
    UNets (``unet_000000``, ``unet_000003``, the newer one differing),
    random trees written by the JAX package."""
    root = tmp_path_factory.mktemp("testworld")
    rng = np.random.default_rng(0)
    tt = np.arange(int(SECONDS * SR)) / SR
    for sub in ("processed/mono_audios_22050Hz", "processed/frames/a",
                "action_detection_results", "splits", "ckpt/tiny"):
        (root / sub).mkdir(parents=True)
    for vid, f0 in (("a", 330.0), ("b", 520.0)):
        x = (0.3 * np.sin(2 * np.pi * f0 * tt) * (0.6 + 0.4 * np.sin(
            2 * np.pi * 1.5 * tt)) + 0.02 * rng.standard_normal(len(tt)))
        for d in ("processed/mono_audios_22050Hz", "."):
            save_wav(str(root / d / f"{vid}.wav"), x.astype(np.float32), SR)
    for k in range(3):
        img = rng.integers(0, 256, (36, 64, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / f"processed/frames/a/{k:03d}.jpg")
    with open(root / "action_detection_results/detection_results.csv", "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "time", "source", "x1", "y1", "x2", "y2"])
        for k in range(3):
            w.writerow(["a", f"{0.5 * k:.1f}", 0, "0.1", "0.2", "0.4", "0.7"])
            w.writerow(["a", f"{0.5 * k:.1f}", 1, "0.5", "0.1", "0.9", "0.6"])
    with open(root / "splits/test.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "start_time", "end_time", "action_label"])
        w.writerow(["a", "0.0", f"{SECONDS}", "x"])
        w.writerow(["b", "0.0", f"{SECONDS}", "x"])

    x0 = jnp.zeros((1, 2, M, 80))
    cond0 = (jnp.zeros((1, 1, M, 80)), jnp.zeros((1, 512)), x0)

    up = random_params(REAL_JAX_AVM(dim=16), np.random.default_rng(1), x0,
                       jnp.zeros((1,), jnp.int32), cond0)
    # keep the random UNet's x0 predictions O(1), off the clip at +-1
    up = jax.tree_util.tree_map_with_path(
        lambda path, p: p * 0.01 if "final_conv" in str(path) else p, up)
    ck = root / "ckpt/tiny"
    jax_ckpt.save_checkpoint(str(ck / "unet_best.pth"), up)
    newest = jax.tree_util.tree_map(lambda p: 1.25 * p, up)
    jax_ckpt.save_checkpoint(str(ck / "unet_000003"), newest)
    jax_ckpt.save_checkpoint(str(ck / "unet_000000"), jax.tree_util.tree_map(
        lambda p: 0.8 * p, newest))
    frame = random_params(
        REAL_JAX_BUILD_VISUAL("clip_pos2d", clip=JaxCLIPConfig(**TINY_CLIP)),
        np.random.default_rng(4), jnp.zeros((1, 3, 1, 4, 224, 224)),
        jnp.zeros((1, 1, 4, 2)), jnp.zeros((1, 1, 4), bool))
    jax_ckpt.save_checkpoint(str(ck / "frame_best.pth"), frame)
    return root


def _argv(world, out, *extra):
    return ["--data_root", str(world), "--list_test",
            str(world / "splits/test.csv"), "--ckpt", str(world / "ckpt"),
            "--id", "tiny", "--arch_frame", "clip_pos2d", "--num_mels",
            str(M), "--output_dir_left", str(out / "left"),
            "--output_dir_right", str(out / "right"), *extra]


def _shrink_jax(mp):
    jitted = {}

    def visual_apply_fn(net, arch):
        """The JAX CLI's per-window encoder apply, jitted once per encoder
        (eager flax applies take seconds each on the CPU)."""
        if (id(net), arch) not in jitted:
            jitted[id(net), arch] = jax.jit(REAL_JAX_VISUAL_APPLY_FN(net, arch))
        return jitted[id(net), arch]

    mp.setattr(jax_common, "visual_apply_fn", visual_apply_fn)
    mp.setattr(jax_models, "AudioVisualModel",
               lambda dim: REAL_JAX_AVM(dim=16))
    mp.setattr(jax_diffusion, "GaussianDiffusion", lambda **kw: (
        REAL_JAX_DIFFUSION(**{**kw, "sampling_timesteps": STEPS})))
    mp.setattr(jax_visual, "build_visual", lambda arch: REAL_JAX_BUILD_VISUAL(
        arch, clip=JaxCLIPConfig(**TINY_CLIP)))


def _jax_x_t(shape):
    """The JAX samplers' x_T for their default key: ``split(PRNGKey(13))[0]``,
    normal of ``shape``."""
    return np.array(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(13))[0], shape, jnp.float32))


class _JaxNoiseDiffusion(GaussianDiffusion):
    """DDIM from the JAX samplers' x_T of the batch's shape, whatever the
    generator (``Stage1Sampler.sample`` and ``test_pos`` pass theirs)."""

    def ddim_sample(self, model_fn, condition, generator=None, noise=None,
                    **kw):
        mix = condition[0]
        shape = (mix.shape[0], 2) + tuple(mix.shape[2:])
        return super().ddim_sample(model_fn, condition,
                                   noise=t(_jax_x_t(shape)), **kw)


def _shrink_port(mp, module):
    mp.setattr(module, "UnetConfig", lambda dim: UnetConfig(dim=16))
    mp.setattr(module, "GaussianDiffusion", lambda **kw: _JaxNoiseDiffusion(
        **{**kw, "sampling_timesteps": STEPS}))
    if hasattr(module, "build_visual"):
        mp.setattr(module, "build_visual", lambda arch, device: build_visual(
            arch, device=device, clip=CLIPConfig(**TINY_CLIP)))


@pytest.fixture(scope="module")
def jax_runs(world, tmp_path_factory):
    """Each JAX test CLI once on the world -> {cli: output directory}.
    ``test_fairplay`` runs ``test_realbinaural``'s loop over
    ``GenAudioFairPlayDataset``, which gives the RealBinaural dataset's
    windows under another key (``test_fairplay_dataset_is_realbinaural_s``):
    its output is ``test_realbinaural``'s, without a second compile."""
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        _shrink_jax(mp)
        for name, cli, extra in (
                ("test_realbinaural", jax_realbinaural, ()),
                ("test_pos", jax_pos, ()),
                ("test_realbinaural_few", jax_few, None)):
            out = tmp_path_factory.mktemp("jax_" + name)
            if extra is None:  # the few-sample CLI writes one directory
                extra = ("--output_dir", str(out / "few"), "--max_windows",
                         "2")
            cli.main(_argv(world, out, *extra))
            outs[name] = out
    outs["test_fairplay"] = outs["test_realbinaural"]
    return outs


def _assert_mels_equal(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert names == ["a.npy", "b.npy"] == sorted(os.listdir(got_dir))
    for name in names:
        got, want = np.load(got_dir / name), np.load(want_dir / name)
        assert got.dtype == want.dtype and got.shape == want.shape == (
            M, int(SECONDS * SR) // 256)
        assert np.isfinite(got).all()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("name,cli", [("test_realbinaural", test_realbinaural),
                                      ("test_fairplay", test_fairplay)])
def test_clip_clis_match_jax(world, jax_runs, tmp_path, monkeypatch, name,
                             cli):
    """Windowed DDIM with per-window ClipPos2D features (frames and
    detections of clip ``a``, zero frames and an all-masked window for
    ``b``), crop and overlap-average: the same L/R mels."""
    _shrink_port(monkeypatch, test_realbinaural)
    cli.main(_argv(world, tmp_path), device="cpu")
    for side in ("left", "right"):
        _assert_mels_equal(tmp_path / side, jax_runs[name] / side)
    # the two channels differ: the features and the model reached them
    left, right = (np.load(tmp_path / s / "a.npy") for s in ("left", "right"))
    assert np.abs(left - right).max() > 1e-3


def test_fairplay_dataset_is_realbinaural_s(world):
    """The JAX ``test_fairplay``'s dataset gives ``test_realbinaural``'s
    windows: the same full mel, starts and items, under ``mix_mel``."""
    kw = dict(detection_csv=str(world / "action_detection_results"
                                / "detection_results.csv"),
              data_root=str(world), n_mels=M)
    wav = str(world / "processed/mono_audios_22050Hz/a.wav")
    fair, real = JaxFairPlay(wav, **kw), JaxRealBinaural(wav, **kw)
    np.testing.assert_array_equal(fair.full_mel, real.full_mel)
    assert fair.starts == real.starts and len(fair) == 2
    for i in range(len(fair)):
        f, r = fair[i], real[i]
        np.testing.assert_array_equal(f.pop("mix_mel"), r.pop("mono_mel"))
        assert f.keys() == r.keys()
        for k in f:
            np.testing.assert_array_equal(f[k], r[k])


def test_clip_cli_without_frame_checkpoint_runs_on_zeros(world, jax_runs,
                                                         tmp_path,
                                                         monkeypatch):
    """No frame checkpoint (``--weights_frame`` names a missing file): zero
    conditioning, as the JAX CLI does; the mels differ from the JAX CLI's
    conditioned ones."""
    _shrink_port(monkeypatch, test_realbinaural)
    test_realbinaural.main(
        _argv(world, tmp_path, "--weights_frame",
              str(tmp_path / "missing.pth")), device="cpu")
    zeros = np.load(tmp_path / "left" / "a.npy")
    feats = np.load(jax_runs["test_realbinaural"] / "left" / "a.npy")
    assert np.abs(feats - zeros).max() > 1e-3 * np.abs(feats).max()


def test_test_pos_matches_jax(world, jax_runs, tmp_path, monkeypatch):
    """The legacy tester: log1p·0.167 normalisation without
    ``normalize_mel``, the newest numbered checkpoint, x_T of seed 13 for
    every window, overlap-average without the crop; linear mels out."""
    _shrink_port(monkeypatch, test_pos)
    test_pos.main(_argv(world, tmp_path), device="cpu")
    for side in ("left", "right"):
        _assert_mels_equal(tmp_path / side, jax_runs["test_pos"] / side)
    got = np.load(tmp_path / "left" / "a.npy")
    assert got.min() >= 0.0  # exp(|x| / 0.167) - 1
    # the scan took unet_000003: unet_000000 gives other mels
    test_pos.main(_argv(world, tmp_path / "old", "--weights_unet",
                        str(world / "ckpt/tiny/unet_000000")), device="cpu")
    old = np.load(tmp_path / "old" / "left" / "a.npy")
    assert np.abs(old - got).max() > 1e-3 * np.abs(got).max()


def test_test_pos_legacy_normalisation_inverts():
    mel = np.random.default_rng(0).uniform(0.0, 5.0, (4, 8)).astype(
        np.float32)
    np.testing.assert_allclose(
        test_pos.legacy_denormalize(test_pos.legacy_normalize(mel)), mel,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(test_pos.legacy_normalize(mel),
                                  jax_pos.legacy_normalize(mel))


def test_few_sample_cli_matches_jax(world, jax_runs, tmp_path, monkeypatch):
    """Two windows of each of the two files: the ``.txt`` summaries in the
    JAX CLI's format, line for line, their MSEs within 1e-4 relative of
    the JAX ones (both print 5 decimals of a float32 mean of ~40, so the
    last digit may differ); the comparison images have the JAX CLI's names
    and hold the four panels in 8-bit grey."""
    _shrink_port(monkeypatch, test_realbinaural)
    out = tmp_path / "few"
    test_realbinaural_few.main(
        _argv(world, tmp_path, "--output_dir", str(out), "--max_windows", "2"),
        device="cpu")
    want = jax_runs["test_realbinaural_few"] / "few"
    assert sorted(os.listdir(out)) == sorted(os.listdir(want)) == [
        "a.txt", "a_w0.png", "a_w1.png", "b.txt", "b_w0.png", "b_w1.png"]
    number = re.compile(r"\d+\.\d+")
    for name in ("a.txt", "b.txt"):
        got, ref = ((d / name).read_text() for d in (out, want))
        assert number.sub("#", got) == number.sub("#", ref) == (
            "windows: 2\nwindow 0: mse #\nwindow 1: mse #\nmean mse: #\n")
        np.testing.assert_allclose(
            [float(v) for v in number.findall(got)],
            [float(v) for v in number.findall(ref)], rtol=1e-4)
    img = np.asarray(Image.open(out / "a_w0.png"))
    assert img.shape == (2 * M, 2 * 80) and img.dtype == np.uint8
    assert img.min() < img.max()


def test_comparison_image_maps_the_jax_colour_range():
    low = np.full((M, 80), -20.0)  # clipped to -9: black
    high = np.full((M, 80), 5.0)  # clipped to 1: white
    ramp = np.tile(np.linspace(-9.0, 1.0, M)[:, None], (1, 80))
    img = test_realbinaural_few.comparison_image([low, high, ramp, ramp])
    assert img.shape == (2 * M, 160)
    assert (img[:M, :80] == 0).all() and (img[:M, 80:] == 255).all()
    # band 0 (the lowest) at the bottom row, as matplotlib's origin="lower"
    assert img[-1, 0] == 0 and img[M, 0] == 255
