"""The port's four serving CLIs against the JAX package's, on the same tiny
checkpoints written by the JAX package's ``save_checkpoint``: the same wavs
come out (after the int16 write) within the pipeline test's 1e-3."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffbinaural_tpu.cli import generate_binaural as jax_generate
from diffbinaural_tpu.cli import inference_binaural as jax_binaural
from diffbinaural_tpu.cli import inference_diffbinaural_mels as jax_mels
from diffbinaural_tpu.cli import inference_e2e as jax_e2e
from diffbinaural_tpu.core import checkpoint as jax_ckpt
from diffbinaural_tpu.core.config import VocoderConfig as JaxVocoderConfig
from diffbinaural_tpu.models import AudioVisualModel as JaxAudioVisualModel
from diffbinaural_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from diffbinaural_tpu_torch.cli import generate_binaural
from diffbinaural_tpu_torch.cli import inference_binaural
from diffbinaural_tpu_torch.cli import inference_diffbinaural_mels
from diffbinaural_tpu_torch.cli import inference_e2e
from diffbinaural_tpu_torch.data.audio_io import load_wav, save_wav
from diffbinaural_tpu_torch.infer.pipeline import BinauralPipeline

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import random_params

SR, M = 22050, 16
WAV_TOL = 1e-3  # tests/test_torch_pipeline.py's waveform tolerance
H = {
    "num_mels": M, "n_fft": 1024, "hop_size": 256, "win_size": 1024,
    "sampling_rate": SR, "fmin": 0, "fmax": None,
    "upsample_rates": [4, 4, 4, 4], "upsample_kernel_sizes": [8, 8, 8, 8],
    "upsample_initial_channel": 32, "resblock": "1",
    "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A UNet (dim 16) and a generator checkpoint written by the JAX
    package, and a 1 s mono clip (86 frames: one 128-frame bucket, 3
    windows in one group of 4)."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    x0 = jnp.zeros((1, 2, M, 80))
    cond0 = (jnp.zeros((1, 1, M, 80)), jnp.zeros((1, 512)), x0)
    up = random_params(JaxAudioVisualModel(dim=16), rng, x0,
                       jnp.zeros((1,), jnp.int32), cond0)
    # keep the random UNet's x0 predictions O(1), off the clip at +-1
    up = jax.tree_util.tree_map_with_path(
        lambda path, p: p * 0.01 if "final_conv" in str(path) else p, up)
    jax_ckpt.save_checkpoint(str(root / "unet_best.pth"), up)
    vp = random_params(JaxBigVGAN(JaxVocoderConfig.from_attrdict(H)), rng,
                       jnp.zeros((1, M, 16)))
    # and the generator's output off tanh's saturation at +-1, where any two
    # waveforms would agree
    vp = jax.tree_util.tree_map_with_path(
        lambda path, p: p * 0.02 if "conv_post" in str(path) else p, vp)
    jax_ckpt.save_checkpoint(str(root / "voc" / "g_00000001"),
                             {"generator": vp})
    with open(root / "voc" / "config.json", "w") as f:
        json.dump(H, f)

    tt = np.arange(SR) / SR
    tone = (0.3 * np.sin(2 * np.pi * 440.0 * tt)
            + 0.05 * rng.standard_normal(SR)).astype(np.float32)
    save_wav(str(root / "in" / "tone.wav"), tone, SR)

    mels = (rng.standard_normal((2, 2, M, 21)) - 4).astype(np.float32)
    mels[0, 0, :, 3:6] = 0.0  # zero frames: silence on that channel
    os.makedirs(root / "pairs")
    for side, i in (("left", 0), ("right", 1)):
        os.makedirs(root / "mels" / side)
        for c in range(2):
            np.save(root / "mels" / side / f"clip{c}.npy", mels[c, i])
            np.save(root / "pairs" / f"clip{c}_{side}.npy", mels[c, i])
    stereo = np.stack([tone, 0.5 * tone[::-1]])
    save_wav(str(root / "stereo" / "st.wav"), stereo, SR)
    return root


def _jax_noise(n_groups, shape):
    """The JAX pipeline's initial noise of each window group for its
    default key: fold the group index in, split, normal from the first."""
    key = jax.random.PRNGKey(13)
    return np.stack([
        np.asarray(jax.random.normal(
            jax.random.split(jax.random.fold_in(key, i))[0], shape,
            jnp.float32))
        for i in range(n_groups)])


class _JaxNoisePipeline(BinauralPipeline):
    def __call__(self, mono_mel_full, visual_feats, generator=None,
                 noise=None):
        noise = _jax_noise(self.n_batches,
                           (self.unet_batch, 2, self.num_mels, self.window))
        return super().__call__(mono_mel_full, visual_feats, noise=noise)


def _assert_wavs_equal(got_dir, want_dir, names):
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == \
        sorted(names)
    for name in names:
        got, sr_g = load_wav(os.path.join(got_dir, name))
        want, sr_w = load_wav(os.path.join(want_dir, name))
        assert sr_g == sr_w == SR and got.shape == want.shape
        assert got.ndim == 2 and got.shape[0] == 2
        # a waveform, not silence, and not pinned at tanh's +-1
        assert np.abs(want).max() > 0.01 and (np.abs(want) > 0.95).mean() < 0.01
        np.testing.assert_allclose(got, want, rtol=0, atol=WAV_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_generate_binaural_matches_jax(world, tmp_path, monkeypatch, sampler):
    args = ["--input_wav", str(world / "in"),
            "--weights_unet", str(world / "unet_best.pth"),
            "--vocoder_checkpoint", str(world / "voc" / "g_00000001"),
            "--unet_dim", "16", "--ddim_steps", "3", "--unet_batch", "4",
            "--sampler", sampler]
    jax_generate.main(args + ["--output_dir", str(tmp_path / "jax")])
    monkeypatch.setattr(generate_binaural, "BinauralPipeline",
                        _JaxNoisePipeline)
    generate_binaural.main(args + ["--output_dir", str(tmp_path / "port")],
                           device="cpu")
    _assert_wavs_equal(tmp_path / "port", tmp_path / "jax",
                       ["tone_binaural_generated.wav"])
    wav, _ = load_wav(str(tmp_path / "port" / "tone_binaural_generated.wav"))
    assert wav.shape == (2, (SR // 256) * 256)


def test_inference_e2e_matches_jax(world, tmp_path):
    args = ["--input_mels_left_dir", str(world / "mels" / "left"),
            "--input_mels_right_dir", str(world / "mels" / "right"),
            "--checkpoint_file", str(world / "voc" / "g_00000001"),
            "--use_cuda_kernel"]
    jax_e2e.main(args + ["--output_dir", str(tmp_path / "jax")])
    inference_e2e.main(args + ["--output_dir", str(tmp_path / "port")],
                       device="cpu")
    names = [f"clip{c}_binaural_generated.wav" for c in range(2)]
    _assert_wavs_equal(tmp_path / "port", tmp_path / "jax", names)
    wav, _ = load_wav(str(tmp_path / "port" / names[0]))
    assert (wav[0, 3 * 256: 6 * 256] == 0).all()  # the zero frames


@pytest.mark.parametrize("mode", ["pair", "mels_dir", "wavs_dir"])
def test_inference_binaural_matches_jax(world, tmp_path, mode):
    inputs, names = {
        "pair": (["--input_left_mel", str(world / "pairs" / "clip1_left.npy"),
                  "--input_right_mel", str(world / "pairs" / "clip1_right.npy")],
                 ["clip1_generated.wav"]),
        "mels_dir": (["--input_mels_dir", str(world / "pairs")],
                     [f"clip{c}_generated.wav" for c in range(2)]),
        "wavs_dir": (["--input_wavs_dir", str(world / "stereo")],
                     ["st_generated.wav"]),
    }[mode]
    args = inputs + ["--checkpoint_file", str(world / "voc" / "g_00000001")]
    jax_binaural.main(args + ["--output_dir", str(tmp_path / "jax")])
    inference_binaural.main(args + ["--output_dir", str(tmp_path / "port")],
                            device="cpu")
    _assert_wavs_equal(tmp_path / "port", tmp_path / "jax", names)


def test_inference_diffbinaural_mels_matches_jax(world, tmp_path):
    voc = tmp_path / "voc_nmels"
    voc.mkdir()
    h = {k: v for k, v in H.items() if k != "num_mels"}
    h["n_mels"] = M  # the alias the reference's config uses
    (voc / "config.json").write_text(json.dumps(h))
    (voc / "g_00000001").write_bytes(
        (world / "voc" / "g_00000001").read_bytes())
    args = ["--input_mels_left_dir", str(world / "mels" / "left"),
            "--input_mels_right_dir", str(world / "mels" / "right"),
            "--checkpoint_file", str(voc / "g_00000001")]
    jax_mels.main(args + ["--output_dir", str(tmp_path / "jax")])
    inference_diffbinaural_mels.main(
        args + ["--output_dir", str(tmp_path / "port")], device="cpu")
    _assert_wavs_equal(tmp_path / "port", tmp_path / "jax",
                       [f"clip{c}_binaural_generated.wav" for c in range(2)])


def test_sample_rate_mismatch_exits(world, tmp_path):
    save_wav(str(tmp_path / "in" / "x.wav"), np.zeros(16000, np.float32),
             16000)
    with pytest.raises(SystemExit, match="expected 22050 Hz"):
        generate_binaural.main([
            "--input_wav", str(tmp_path / "in" / "x.wav"),
            "--output_dir", str(tmp_path / "out"),
            "--weights_unet", str(world / "unet_best.pth"),
            "--vocoder_checkpoint", str(world / "voc" / "g_00000001"),
            "--unet_dim", "16"], device="cpu")
