"""The port's four training CLIs on the CPU (``main(argv, device="cpu")``)
on tiny models and tiny synthetic files: epochs / steps, checkpoints and
resume; the checkpoint files against the JAX package (its
``load_checkpoint`` reads them into trees of the JAX trainers' structure
and shapes, taken from ``random_params`` — no JAX train step is compiled),
the port resuming from files the JAX package wrote, and ``ArgParser``'s
namespaces, the stage-2 parsers' and ``lr_scale_for_epoch`` equal to the
JAX package's.

Tiny: UNet dim 16 on 16 mel bands (the CLIs' 80-frame window), the tiny
CLIP tower of ``test_cli_train.py``, a DDIM of 2 steps over 50 for the
evaluation pass (the JAX CLI test shrinks it the same way), and that test's
tiny vocoder config with one-scale discriminators."""

import csv
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffbinaural_tpu.cli import arguments as jax_arguments
from diffbinaural_tpu.cli import gan_common as jax_gan_common
from diffbinaural_tpu.cli import train_binaural_both as jax_both
from diffbinaural_tpu.cli import train_binaural_mel as jax_mel
from diffbinaural_tpu.cli.common import Stage1Trainer as JaxStage1Trainer
from diffbinaural_tpu.core import checkpoint as jax_ckpt
from diffbinaural_tpu.core.config import CLIPConfig as JaxCLIPConfig
from diffbinaural_tpu.core.config import VocoderConfig as JaxVocoderConfig
from diffbinaural_tpu.models import AudioVisualModel as JaxAudioVisualModel
from diffbinaural_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from diffbinaural_tpu.models.visual import build_visual as jax_build_visual
from diffbinaural_tpu_torch.cli import arguments, common
from diffbinaural_tpu_torch.cli import (train_binaural_both,
                                        train_binaural_mel, train_fairplay,
                                        train_realbinaural)
from diffbinaural_tpu_torch.cli.common import Stage1Trainer, module_tree
from diffbinaural_tpu_torch.cli.gan_common import GanTrainer
from diffbinaural_tpu_torch.core.config import AttrDict, CLIPConfig
from diffbinaural_tpu_torch.data.audio_io import save_wav
from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
from diffbinaural_tpu_torch.utils import SummaryLogger

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import random_params, to_numpy_tree

SR, M = 22050, 16
TINY_CLIP = dict(image_size=224, patch_size=112, width=32, layers=1, heads=2)
H = {
    "num_mels": M, "upsample_rates": [4, 4, 4, 4],
    "upsample_kernel_sizes": [8, 8, 8, 8], "upsample_initial_channel": 16,
    "resblock": "1", "resblock_kernel_sizes": [3],
    "resblock_dilation_sizes": [[1, 3]],
    "sampling_rate": SR, "n_fft": 512, "hop_size": 256, "win_size": 512,
    "fmin": 0, "fmax": None, "fmax_for_loss": None,
    "learning_rate": 2e-4, "adam_b1": 0.8, "adam_b2": 0.99,
    "lr_decay": 0.999, "seed": 0, "batch_size": 2, "segment_size": 4096,
    "mpd_reshapes": [2], "discriminator_channel_mult": 0.125,
    "resolutions": [[128, 32, 128]], "num_workers": 1,
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Stage 1: two 1 s clips as RealBinaural (mono + binaural) and FairPlay
    (stereo) files with split lists.  Stage 2: two stereo clips of 40
    frames with L/R mels of 16 bands, and the tiny vocoder config."""
    root = tmp_path_factory.mktemp("trainworld")
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    for sub in ("processed/mono_audios_22050Hz",
                "processed/binaural_audios_22050Hz", "binaural_audios",
                "splits", "l", "r", "a"):
        (root / sub).mkdir(parents=True)
    for vid in ("a", "b"):
        x = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        save_wav(str(root / f"processed/mono_audios_22050Hz/{vid}.wav"), x, SR)
        for sub in ("processed/binaural_audios_22050Hz", "binaural_audios"):
            save_wav(str(root / f"{sub}/{vid}.wav"), np.stack([x, 0.8 * x]),
                     SR)
        for d in ("l", "r"):
            np.save(root / d / f"{vid}.npy",
                    (rng.standard_normal((M, 40)) - 6).astype(np.float32))
        save_wav(str(root / f"a/{vid}.wav"),
                 0.1 * rng.standard_normal((2, 40 * 256)).astype(np.float32),
                 SR)
    for name in ("train", "val"):
        with open(root / f"splits/{name}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["video_id", "start_time", "end_time", "action_label"])
            w.writerow(["a", "0.0", "1.0", "x"])
            w.writerow(["b", "0.0", "1.0", "x"])
    with open(root / "h.json", "w") as f:
        json.dump(H, f)
    return root


def _shrink_stage1(mp):
    """The CLIs' models shrunk through the JAX trainer's hidden knobs
    (``args.unet_dim``, ``args.clip_config``), and a 2-step DDIM."""
    parse = arguments.ArgParser.parse_train_arguments

    def parse_tiny(self, argv=None):
        args = parse(self, argv)
        args.unet_dim = 16
        args.clip_config = CLIPConfig(**TINY_CLIP)
        return args

    mp.setattr(arguments.ArgParser, "parse_train_arguments", parse_tiny)
    mp.setattr(common, "GaussianDiffusion", lambda **kw: (
        GaussianDiffusion(**{**kw, "timesteps": 50, "sampling_timesteps": 2})))


@pytest.fixture
def tiny_stage1(monkeypatch):
    _shrink_stage1(monkeypatch)


@pytest.fixture(scope="module")
def stage1_run(world, tmp_path_factory):
    """One epoch of ``train_realbinaural`` -> (trainer, checkpoint dir)."""
    ckpt_dir = tmp_path_factory.mktemp("stage1_ckpt")
    with pytest.MonkeyPatch.context() as mp:
        _shrink_stage1(mp)
        trainer = train_realbinaural.main(
            stage1_argv(world, ckpt_dir, "--num_epoch", "1"), device="cpu")
    return trainer, ckpt_dir


def stage1_argv(world, ckpt_dir, *extra):
    return ["--id", "tiny", "--arch_frame", "clip_pos2d", "--ckpt",
            str(ckpt_dir), "--list_train", str(world / "splits/train.csv"),
            "--list_val", str(world / "splits/val.csv"), "--data_root",
            str(world), "--batch_size_per_gpu", "2", "--workers", "1",
            "--num_frames", "1", "--num_mels", str(M), *extra]


@pytest.fixture(scope="module")
def jax_stage1_trees():
    """Parameter trees of the JAX trainer's two modules at the tiny sizes,
    from ``random_params`` (their structure and shapes are what matter)."""
    rng = np.random.default_rng(1)
    x0 = jnp.zeros((1, 2, M, 80))
    unet = random_params(JaxAudioVisualModel(dim=16), rng, x0,
                         jnp.zeros((1,), jnp.int32),
                         (jnp.zeros((1, 1, M, 80)), jnp.zeros((1, 512)), x0))
    frame = random_params(
        jax_build_visual("clip_pos2d", clip=JaxCLIPConfig(**TINY_CLIP)), rng,
        jnp.zeros((1, 3, 1, 4, 224, 224)), jnp.zeros((1, 1, 4, 2)),
        jnp.zeros((1, 1, 4), bool))
    return {"frame": to_numpy_tree(frame), "unet": to_numpy_tree(unet)}


def assert_same_tree(got, want, exact=True):
    """Same structure and leaf shapes; with ``exact`` the same values."""
    got_l, got_s = jax.tree_util.tree_flatten(got)
    want_l, want_s = jax.tree_util.tree_flatten(want)
    assert got_s == want_s
    for g, w in zip(got_l, want_l):
        assert np.shape(g) == np.shape(w)
        if exact:
            assert np.array_equal(np.asarray(g), np.asarray(w))


def test_summary_logger(tmp_path):
    """Events through tensorboardX where it is installed; the audio clip
    skipped where it cannot be encoded; no figure built without a
    writer.  (First in the file: it pays tensorboardX's import.)"""
    logger = SummaryLogger(str(tmp_path / "runs"))
    if logger._w is not None:
        logger.scalar("train/loss", 1.5, 0)
        logger.audio("val/audio", np.zeros(256, np.float32), 0)
        logger.close()
        assert any(f.startswith("events") for f in
                   os.listdir(tmp_path / "runs"))
    logger._w = None
    logger.mel_figure("val/mel", "not an array", 0)  # nothing is plotted


def test_stage1_cli_epoch_and_checkpoints(stage1_run):
    trainer, ckpt_dir = stage1_run
    assert {"frame_latest.pth", "unet_latest.pth", "frame_best.pth",
            "unet_best.pth", "frame_000000", "unet_000000",
            "history_000000"} <= set(os.listdir(ckpt_dir / "tiny"))
    assert trainer.state.step == 1 and len(trainer.timings["step_s"]) == 1
    assert trainer.history["epoch"] == 0
    assert len(trainer.history["val_mel_l2"]) == 1


def test_stage1_cli_writes_the_jax_trainers_files(stage1_run,
                                                  jax_stage1_trees):
    trainer, ckpt_dir = stage1_run
    exp = ckpt_dir / "tiny"
    # the files are the JAX trainer's: its loader reads them into its trees
    trees = jax_stage1_trees
    for name in ("frame", "unet"):
        for f in (f"{name}_000000", f"{name}_latest.pth", f"{name}_best.pth"):
            got = jax_ckpt.load_checkpoint(str(exp / f), target=trees[name])
            assert_same_tree(got, trees[name], exact=False)
            assert_same_tree(got, module_tree(getattr(
                trainer, "net_" + name)))
    assert jax_ckpt.load_history(str(exp / "history_000000"))["epoch"] == 0


def test_stage1_cli_resumes(world, stage1_run, tiny_stage1):
    trainer, ckpt_dir = stage1_run
    # a new trainer resumes at epoch 1 with the saved parameters bit for bit
    args = arguments.ArgParser().parse_train_arguments(
        stage1_argv(world, ckpt_dir, "--num_epoch", "2"))
    again = Stage1Trainer(args, None, None, device="cpu")
    again.init_params()
    again.try_resume()
    assert again.start_epoch == 1 and again.state.step == 0
    for name in ("frame", "unet"):
        assert_same_tree(module_tree(getattr(again, "net_" + name)),
                         module_tree(getattr(trainer, "net_" + name)))

    resumed = train_realbinaural.main(
        stage1_argv(world, ckpt_dir, "--num_epoch", "2"), device="cpu")
    assert resumed.start_epoch == 1 and resumed.history["epoch"] == 1
    assert resumed.state.step == 1  # the optimiser started afresh


def test_fairplay_cli_trains_on_the_mix(world, tmp_path, tiny_stage1):
    trainer = train_fairplay.main(
        stage1_argv(world, tmp_path, "--num_epoch", "1", "--audRate",
                    str(SR)), device="cpu")
    assert trainer.mel_key == "mix_mel" and trainer.state.step == 1
    assert "unet_000000" in os.listdir(tmp_path / "tiny")


def test_stage1_resumes_from_jax_written_files(tmp_path, tiny_stage1,
                                              jax_stage1_trees):
    trees = jax_stage1_trees
    exp = tmp_path / "tiny"
    jax_ckpt.save_checkpoint(str(exp / "frame_000004"), trees["frame"])
    jax_ckpt.save_checkpoint(str(exp / "unet_000004"), trees["unet"])
    jax_ckpt.save_history(str(exp / "history_000004"),
                          {"train_loss": [1.0], "val_mel_l2": [2.0],
                           "epoch": 4})
    args = arguments.ArgParser().parse_train_arguments(
        ["--id", "tiny", "--ckpt", str(tmp_path), "--arch_frame",
         "clip_pos2d"])
    trainer = Stage1Trainer(args, None, None, device="cpu")
    trainer.init_params()
    trainer.try_resume()
    assert trainer.start_epoch == 5
    assert_same_tree(module_tree(trainer.net_frame), trees["frame"])
    assert_same_tree(module_tree(trainer.net_unet), trees["unet"])

    # --weights_unet: a JAX-written UNet loads; a missing file raises
    args.weights_unet = str(exp / "unet_000004")
    warm = Stage1Trainer(args, None, None, device="cpu")
    warm.init_params()
    assert_same_tree(module_tree(warm.net_unet), trees["unet"])
    args.weights_frame = str(tmp_path / "missing.pth")
    with pytest.raises(FileNotFoundError, match="weights_frame"):
        Stage1Trainer(args, None, None, device="cpu").init_params()


def jax_stage2_trees():
    rng = np.random.default_rng(2)
    h = AttrDict(H)
    gen = random_params(JaxBigVGAN(JaxVocoderConfig.from_attrdict(h)), rng,
                        jnp.zeros((1, M, 16)))
    mpd, mrd = jax_gan_common.build_discriminators(h)
    audio = jnp.zeros((1, 1, H["segment_size"]))
    return {"generator": to_numpy_tree(gen),
            "mpd": to_numpy_tree(random_params(mpd, rng, audio, audio)),
            "mrd": to_numpy_tree(random_params(mrd, rng, audio, audio))}


def stage2_argv(world, ckpt_dir, kind, *extra):
    mels = ["--mel_left_train_dir", "--mel_right_train_dir",
            "--mel_left_val_dir", "--mel_right_val_dir"]
    if kind == "both":
        mels = [m.replace("--mel_", "--mel_pred_") for m in mels]
    dirs = [str(world / d) for d in ("l", "r", "l", "r")]
    return ["--config", str(world / "h.json"), "--checkpoint_path",
            str(ckpt_dir), "--audio_dir", str(world / "a"),
            *[x for pair in zip(mels, dirs) for x in pair],
            "--stdout_interval", "1", "--summary_interval", "100",
            "--checkpoint_interval", "2", "--validation_interval", "3",
            *extra]


def test_stage2_clis_steps_checkpoints_resume(world, tmp_path):
    trainer = train_binaural_mel.main(
        stage2_argv(world, tmp_path, "mel", "--training_epochs", "2"),
        device="cpu")
    assert trainer.steps == 4 and not trainer.remat  # 2 epochs x 2 batches
    assert {"config.json", "g_00000002", "do_00000002", "g_00000004",
            "do_00000004"} <= set(os.listdir(tmp_path))
    assert len(trainer.timings["wait_s"]) == 4

    trees = jax_stage2_trees()
    g = jax_ckpt.load_checkpoint(str(tmp_path / "g_00000004"),
                                 {"generator": trees["generator"]})
    assert_same_tree(g["generator"], trees["generator"], exact=False)
    assert_same_tree(g["generator"], module_tree(trainer.gen))
    do = jax_ckpt.load_checkpoint(str(tmp_path / "do_00000004"))
    assert int(do["steps"]) == 4 and int(do["epoch"]) == 1
    for name in ("mpd", "mrd"):
        assert_same_tree(do[name], trees[name], exact=False)
        assert_same_tree(do[name], module_tree(getattr(trainer, name)))

    # resume: the step after the saved one, the saved parameters bit for bit
    a = train_binaural_both.build_parser().parse_args(
        stage2_argv(world, tmp_path, "both"))
    again = GanTrainer(a, AttrDict(H), device="cpu")
    again.init_params(16)
    again.try_resume()
    assert again.steps == again.state.step == 5 and again.last_epoch == 1
    for name in ("gen", "mpd", "mrd"):
        assert_same_tree(module_tree(getattr(again, name)),
                         module_tree(getattr(trainer, name)))

    both = train_binaural_both.main(
        stage2_argv(world, tmp_path, "both", "--training_epochs", "2"),
        device="cpu")
    assert both.steps == 7  # resumed at 5, epoch 1: two batches
    assert "g_00000006" in os.listdir(tmp_path)


def test_stage2_resumes_from_jax_written_files(world, tmp_path):
    trees = jax_stage2_trees()
    h = AttrDict(H)
    s1 = tmp_path / "stage1"
    jax_ckpt.save_checkpoint(str(s1 / "g_00000003"),
                             {"generator": trees["generator"]})
    a = train_binaural_mel.build_parser().parse_args(
        ["--checkpoint_path", str(tmp_path / "s2"),
         "--stage1_checkpoint_path", str(s1)])
    # tier 2: nothing in the stage-2 dir, the stage-1 dir's generator
    warm = GanTrainer(a, h, device="cpu")
    warm.init_params(16)
    warm.try_resume()
    assert warm.steps == 0
    assert_same_tree(module_tree(warm.gen), trees["generator"])

    # tier 1: the stage-2 dir's pair
    jax_ckpt.save_checkpoint(str(tmp_path / "s2/g_00000007"),
                             {"generator": trees["generator"]})
    jax_ckpt.save_checkpoint(str(tmp_path / "s2/do_00000007"),
                             {"mpd": trees["mpd"], "mrd": trees["mrd"],
                              "steps": 7, "epoch": 3})
    trainer = GanTrainer(a, h, device="cpu")
    trainer.init_params(16)
    trainer.try_resume()
    assert trainer.steps == trainer.state.step == 8
    assert trainer.last_epoch == 3
    for name, key in (("gen", "generator"), ("mpd", "mpd"), ("mrd", "mrd")):
        assert_same_tree(module_tree(getattr(trainer, name)), trees[key])


TRAIN_ARGVS = [
    [],
    ["--arch_frame", "clip_pos2d", "--num_frames", "1", "--lr_steps", "3",
     "5", "--decay_factor", "0.5", "--learning_rate_decrease_itr", "2"],
    ["--id", "x", "--batch_size_per_gpu", "16", "--num_val", "16",
     "--weighted_loss", "0", "--vidRate", "2.5", "--mode", "eval",
     "--learning_rate_decrease_itr", "0", "--gpu_ids", "0,1"],
]


@pytest.mark.parametrize("argv", TRAIN_ARGVS)
def test_argparser_and_lr_scale_equal_jax(argv, capsys):
    got = arguments.ArgParser().parse_train_arguments(argv)
    want = jax_arguments.ArgParser().parse_train_arguments(argv)
    assert vars(got) == vars(want)
    for epoch in (0, 1, 2, 3, 4, 5, 6, 39, 40, 41, 60, 99):
        assert Stage1Trainer.lr_scale_for_epoch(
            SimpleNamespace(args=got), epoch) == \
            JaxStage1Trainer.lr_scale_for_epoch(
                SimpleNamespace(args=want), epoch)
    test = ["--list_test", "t.csv"] if argv else []
    assert vars(arguments.ArgParser().parse_test_arguments(test)) == \
        vars(jax_arguments.ArgParser().parse_test_arguments(test))


@pytest.mark.parametrize("argv", [
    [], ["--debug", "False", "--evaluate", "", "--fine_tuning", "0"],
    ["--training_epochs", "3", "--list_input_unseen_wavs_dir", "a", "b"]])
def test_stage2_parsers_equal_jax(argv):
    for got_m, want_m in ((train_binaural_mel, jax_mel),
                          (train_binaural_both, jax_both)):
        if "--list_input_unseen_wavs_dir" in argv and got_m is \
                train_binaural_mel:
            continue
        got = got_m.build_parser().parse_args(argv)
        assert vars(got) == vars(want_m.build_parser().parse_args(argv))
    if argv[:2] == ["--debug", "False"]:
        # the reference's type=bool: any non-empty string is True
        assert got.debug is True and got.evaluate is False
        assert got.fine_tuning is True
