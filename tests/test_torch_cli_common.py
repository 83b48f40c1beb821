"""The port's ``cli/common.py`` against the JAX package's: ``dump_clip_mels``
on a tiny clip whose per-window features come from a tiny ``ClipPos2D``
through ``visual_apply_fn``, the toy denoiser on both sides and the JAX
sampler's x_T injected; and ``ModelBuilder``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffbinaural_tpu.cli.common import dump_clip_mels as jax_dump_clip_mels
from diffbinaural_tpu.cli.common import visual_apply_fn as jax_visual_apply_fn
from diffbinaural_tpu.core.config import CLIPConfig as JaxCLIPConfig
from diffbinaural_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diffbinaural_tpu.infer.stage1 import Stage1Sampler as JaxSampler
from diffbinaural_tpu.models.visual import ClipPos2D as JaxClipPos2D
from diffbinaural_tpu_torch.cli.common import (ModelBuilder, dump_clip_mels,
                                               visual_apply_fn)
from diffbinaural_tpu_torch.convert import visual_params_from_flax
from diffbinaural_tpu_torch.core.config import CLIPConfig
from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
from diffbinaural_tpu_torch.infer.stage1 import Stage1Sampler, window_starts
from diffbinaural_tpu_torch.models.unet import AudioVisualModel
from diffbinaural_tpu_torch.models.visual import ClipPos2D

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import random_params, t, to_numpy_tree
from _torch_port_util import toy_jax, toy_torch

M, TOTAL, N_SRC = 16, 150, 2  # 150 frames: windows at 0, 40, 70
TINY = dict(image_size=32, patch_size=16, width=64, layers=2, heads=2)
DIFFUSION = dict(timesteps=100, sampling_timesteps=3, objective="pred_noise",
                 beta_schedule="cosine", auto_normalize=False)


class _Clip:
    """The duck-typed dataset ``dump_clip_mels`` reads: one clip's ln-mel,
    its window starts, its row and one item per window."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.full_mel = (rng.standard_normal((M, TOTAL)) - 5).astype(
            np.float32)
        self.starts = window_starts(TOTAL)
        self.rows = [{"video_id": "clip0"}]
        n = len(self.starts)
        self.frames = rng.standard_normal(
            (n, 3, 1, N_SRC, 32, 32)).astype(np.float32)
        self.pos = rng.uniform(-1, 1, (n, 1, N_SRC, 2)).astype(np.float32)
        self.mask = np.zeros((n, 1, N_SRC), bool)
        self.mask[1, 0, 1] = True

    def __len__(self):
        return len(self.starts)

    def __getitem__(self, i):
        return {"frames": self.frames[i], "2d_pos_data": self.pos[i],
                "mask": self.mask[i]}


class _JaxNoiseSampler(Stage1Sampler):
    """The port's sampler with the JAX sampler's x_T for its default key:
    ``split(PRNGKey(13))[0]``, normal of the group's shape."""

    def sample(self, mono_mel, visual_feat, generator=None, noise=None):
        shape = (mono_mel.shape[0], 2) + tuple(mono_mel.shape[2:])
        x_t = jax.random.normal(jax.random.split(jax.random.PRNGKey(13))[0],
                                shape, jnp.float32)
        return super().sample(mono_mel, visual_feat, noise=t(np.array(x_t)))


class _Args:
    crop_frames = 8


def test_dump_clip_mels_matches_jax(tmp_path):
    """Features per window by the encoder, windowed DDIM, crop and overlap
    average, the ``.npy`` pair: the port's files equal the JAX ones within
    1e-5 of the ln-mel scale."""
    clip = _Clip()
    jv = JaxClipPos2D(clip=JaxCLIPConfig(**TINY))
    item = clip[0]
    tree = random_params(jv, np.random.default_rng(1),
                         jnp.asarray(item["frames"][None]),
                         jnp.asarray(item["2d_pos_data"][None]),
                         jnp.asarray(item["mask"][None]))
    japply = jax.jit(jax_visual_apply_fn(jv, "clip_pos2d"))

    def jax_features(it):
        return japply(tree, *(jnp.asarray(it[k][None]) for k in
                              ("frames", "2d_pos_data", "mask")))[0]

    sampler = JaxSampler(lambda p, x, tt, c: toy_jax(x, tt, c),
                         JaxDiffusion(image_size=80, **DIFFUSION))
    want = jax_dump_clip_mels(_Args(), sampler, {}, clip,
                              str(tmp_path / "jl"), str(tmp_path / "jr"),
                              features_fn=jax_features)

    net = ClipPos2D(clip=CLIPConfig(**TINY))
    net.load_state_dict(visual_params_from_flax(to_numpy_tree(tree)),
                        strict=True)
    apply = visual_apply_fn(net.eval(), "clip_pos2d")

    def features(it):
        return apply(*(t(it[k])[None] for k in
                       ("frames", "2d_pos_data", "mask")))[0]

    port_sampler = _JaxNoiseSampler(
        toy_torch, GaussianDiffusion(image_size=80, device="cpu", **DIFFUSION),
        device="cpu")
    got = dump_clip_mels(_Args(), port_sampler, clip, str(tmp_path / "pl"),
                         str(tmp_path / "pr"), features_fn=features)
    assert got.shape == (2, M, TOTAL)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    for side, i in (("l", 0), ("r", 1)):
        saved = np.load(tmp_path / f"p{side}" / "clip0.npy")
        np.testing.assert_array_equal(saved, got[i])
        np.testing.assert_allclose(
            saved, np.load(tmp_path / f"j{side}" / "clip0.npy"), rtol=0,
            atol=1e-5 * scale)
    # the features reached the sampler: zero conditioning gives other mels
    zero = dump_clip_mels(_Args(), port_sampler, clip, str(tmp_path / "zl"),
                          str(tmp_path / "zr"))
    assert np.abs(zero - got).max() > 1e-3 * scale


def test_model_builder_builds_the_port_models():
    builder = ModelBuilder()
    unet = builder.build_unet(dim=16, device="cpu", seed=2)
    assert isinstance(unet, AudioVisualModel) and not unet.training
    assert unet.net_unet.final_conv.weight.shape == (2, 16)
    net = builder.build_visual(arch_frame="clip_pos2d", device="cpu",
                               clip_config=CLIPConfig(**TINY))
    assert isinstance(net, ClipPos2D) and net.clip.config.width == 64
    with pytest.raises(ValueError, match="arch_frame"):
        builder.build_visual(arch_frame="vgg", device="cpu")
