"""Port's stage-2 GAN train step against the JAX package's: two consecutive
D+G steps of a tiny generator with a two-period MPD and a one-scale CQTD,
from the same converted parameters on the same batch — the six metrics,
every generator and discriminator gradient leaf by leaf (after the
global-norm clip, read on the JAX side from Adam's first moment:
mu_k = b1 mu_{k-1} + (1 - b1) g_k), and the updated parameters.  Then the
port alone: the freeze gate and ``remat``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.core.config import VocoderConfig as JaxVocoderConfig
from diffbinaural_tpu.losses import \
    MultiScaleMelSpectrogramLoss as JaxMelLoss
from diffbinaural_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from diffbinaural_tpu.models import discriminators as jd
from diffbinaural_tpu.signal.stft import mel_spectrogram as jax_mel
from diffbinaural_tpu.train import make_stage2_train_step as jax_make_step
from diffbinaural_tpu_torch.convert import (bigvgan_params_from_flax,
                                            discriminator_params_from_flax,
                                            tree_to_flax)
from diffbinaural_tpu_torch.core.config import VocoderConfig
from diffbinaural_tpu_torch.losses import MultiScaleMelSpectrogramLoss
from diffbinaural_tpu_torch.models import discriminators as td
from diffbinaural_tpu_torch.models.bigvgan import BigVGAN
from diffbinaural_tpu_torch.signal import mel_spectrogram
from diffbinaural_tpu_torch.train import make_stage2_train_step

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import TINY_VOCODER, random_params, to_numpy_tree

B, FRAMES, HOP = 2, 32, 8            # TINY_VOCODER upsamples 4 x 2
LR, B1, CLIP = 5e-5, 0.8, 2.0        # CLIP below both pre-clip norms
MPD = dict(periods=(2, 3), channel_mult=0.125)
CQTD = dict(sampling_rate=22050, hop_lengths=(256,), n_octaves=(9,),
            bins_per_octaves=(2,), filters=8)
MSL = dict(n_mels=(5, 10), window_lengths=(32, 64))
# Gradients of step 1 (the same parameters on both sides): 1e-4 of each
# leaf's scale (measured 1.2e-5).  Step 2 starts from parameters that differ
# by up to 2 lr: Adam's first step moves a parameter by lr g / (|g| + eps),
# so a gradient that is zero up to rounding moves it by +-lr on either side
# (measured: generator 2.4e-5, discriminators 5.3e-3 of the leaf's scale).
GRAD_REL = {1: 1e-4, 2: 2e-2}
METRICS = ("loss_disc", "loss_gen_all", "loss_mel", "loss_fm", "grad_norm_g")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def world():
    """Parameters, batch and two steps of the JAX package's step (compiled
    once for the module)."""
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((B, 8, FRAMES)) - 1.0).astype(np.float32)
    audio = (0.3 * rng.standard_normal((B, FRAMES * HOP))).astype(np.float32)
    batch = {"mel": mel, "audio": audio,
             "mel_loss": np.zeros((B, 8, FRAMES), np.float32)}
    gen = JaxBigVGAN(JaxVocoderConfig(**TINY_VOCODER))
    mpd = jd.MultiPeriodDiscriminator(**MPD)
    mrd = jd.MultiScaleSubbandCQTDiscriminator(**CQTD)
    y = jnp.asarray(audio[:, None, :])
    gen_params = random_params(gen, rng, jnp.asarray(mel))
    disc_params = {"mpd": random_params(mpd, rng, y, y),
                   "mrd": random_params(mrd, rng, y, y)}
    init_fn, step_fn = jax_make_step(
        gen_apply=gen.apply, mpd_apply=mpd.apply, mrd_apply=mrd.apply,
        mel_fn=lambda w: jax_mel(w, 32, 8, 22050, 8, 32),
        multiscale_mel_loss=JaxMelLoss(22050, **MSL), learning_rate=LR,
        adam_b1=B1, clip_grad_norm=CLIP, donate=False)
    states, metrics = [init_fn(gen_params, disc_params)], []
    for _ in range(2):
        state, m = step_fn(states[-1], batch)
        states.append(jax.tree_util.tree_map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(batch=batch, gen_params=to_numpy_tree(gen_params),
                disc_params=to_numpy_tree(disc_params), states=states,
                metrics=metrics)


def _port(world, mel_fn=None, **kwargs):
    gen = BigVGAN(VocoderConfig(**TINY_VOCODER))
    gen.load_state_dict(bigvgan_params_from_flax(world["gen_params"]),
                        strict=True)
    mpd, mrd = td.MultiPeriodDiscriminator(**MPD), \
        td.MultiScaleSubbandCQTDiscriminator(**CQTD)
    for m, key in ((mpd, "mpd"), (mrd, "mrd")):
        m.load_state_dict(discriminator_params_from_flax(
            world["disc_params"][key]), strict=True)
    init_fn, step_fn = make_stage2_train_step(
        gen, mpd, mrd,
        mel_fn or (lambda w: mel_spectrogram(w, 32, 8, 22050, 8, 32)),
        MultiScaleMelSpectrogramLoss(22050, **MSL), learning_rate=LR,
        adam_b1=B1, clip_grad_norm=CLIP, device="cpu", **kwargs)
    return init_fn(), step_fn


def _jax_moments(world, k, which):
    opt = world["states"][k].gen_opt if which == "gen" else \
        world["states"][k].disc_opt
    return opt[1].mu


def _compare_leaves(got, want, what, rel):
    """Each leaf within ``rel`` of its own scale, plus 1e-5 of the largest
    leaf's scale (some gradients are zero up to rounding)."""
    assert set(got) == set(want), what
    top = max(np.abs(w).max() for w in want.values())
    for name in sorted(want):
        w = want[name]
        np.testing.assert_allclose(
            got[name], w, rtol=0,
            atol=rel * np.abs(w).max() + 1e-5 * top, err_msg=f"{what} {name}")


def test_two_steps_match_jax(world):
    state, step_fn = _port(world)
    for k in (1, 2):
        state, metrics = step_fn(state, world["batch"])
        want = world["metrics"][k - 1]
        for name in METRICS:
            np.testing.assert_allclose(float(metrics[name]), want[name],
                                       rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(metrics["lr"], want["lr"], rtol=1e-7)
        assert want["grad_norm_g"] > CLIP  # the clip acted

        # clipped gradients: the port's .grad against the JAX moments
        for which, modules in (("gen", {"": state.generator}),
                               ("disc", {"mpd/": state.mpd,
                                         "mrd/": state.mrd})):
            got = {}
            for prefix, m in modules.items():
                got.update({prefix + "params/" + n: v for n, v in _flat(
                    tree_to_flax({n: p.grad for n, p in
                                  m.named_parameters()})).items()})
            mu = _flat(_jax_moments(world, k, which))
            mu_prev = _flat(_jax_moments(world, k - 1, which)) if k > 1 \
                else {n: 0.0 for n in mu}
            want_g = {n: (mu[n] - B1 * mu_prev[n]) / (1 - B1) for n in mu}
            _compare_leaves(got, want_g, f"step {k} {which} grad",
                            GRAD_REL[k])

        # updated parameters: an Adam step moves each by about lr, and a
        # gradient that is zero up to rounding may flip its sign
        new = world["states"][k]
        for m, tree in ((state.generator, new.gen_params),
                        (state.mpd, new.disc_params["mpd"]),
                        (state.mrd, new.disc_params["mrd"])):
            got = _flat(tree_to_flax(dict(m.named_parameters())))
            want_p = _flat(tree["params"])
            assert set(got) == set(want_p)
            for name in want_p:
                np.testing.assert_allclose(got[name], want_p[name], rtol=0,
                                           atol=2 * LR * 1.001, err_msg=name)
    assert state.step == 2


def test_freeze_step_skips_the_discriminators(world):
    state, step_fn = _port(world, freeze_step=1)
    disc_before = {n: p.detach().clone() for m in (state.mpd, state.mrd)
                   for n, p in m.named_parameters()}
    gen_before = {n: p.detach().clone()
                  for n, p in state.generator.named_parameters()}
    state, metrics = step_fn(state, world["batch"])
    assert float(metrics["loss_disc"]) == 0.0
    assert float(metrics["loss_fm"]) == 0.0
    np.testing.assert_allclose(float(metrics["loss_gen_all"]),
                               60.0 * float(metrics["loss_mel"]), rtol=1e-6)
    assert len(state.disc_opt.state) == 0  # no moments, no step count
    for m in (state.mpd, state.mrd):
        for n, p in m.named_parameters():
            assert torch.equal(p.detach(), disc_before[n]), n
    assert any(not torch.equal(p.detach(), gen_before[n])
               for n, p in state.generator.named_parameters())
    # the freeze is over: the discriminators train
    state, metrics = step_fn(state, world["batch"])
    assert float(metrics["loss_disc"]) > 0 and float(metrics["loss_fm"]) > 0
    assert len(state.disc_opt.state) > 0


def test_remat_gives_the_same_step(world):
    runs = []
    for remat in (False, True):
        state, step_fn = _port(world, remat=remat)
        state, metrics = step_fn(state, world["batch"])
        runs.append((metrics, {n: p.detach().clone() for n, p in
                               state.generator.named_parameters()}))
    (m0, p0), (m1, p1) = runs
    for name in METRICS:
        np.testing.assert_allclose(float(m1[name]), float(m0[name]),
                                   rtol=1e-6, err_msg=name)
    for n in p0:
        torch.testing.assert_close(p1[n], p0[n], rtol=0, atol=1e-7)


def test_single_scale_mel_branch_runs(world):
    """``use_multiscale_melloss=False``: the mel of one scale plus the
    silence-aware term against the batch's loss-target mel."""
    state, step_fn = _port(world, use_multiscale_melloss=False)
    batch = dict(world["batch"])
    batch["mel_loss"] = np.full((B, 8, FRAMES), -3.0, np.float32)
    state, metrics = step_fn(state, batch)
    assert all(np.isfinite(float(metrics[k])) for k in METRICS)
    assert float(metrics["loss_mel"]) > 0


def test_step_runs_without_tf32_and_restores_the_flags(world):
    """The step runs its float32 convolutions and matmuls without TF32, as
    the JAX package pins full precision, whatever the caller's flags (here
    PyTorch's cuDNN default, on), and gives the caller its flags back."""
    seen = []

    def mel_fn(wav):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return mel_spectrogram(wav, 32, 8, 22050, 8, 32)

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        state, step_fn = _port(world, mel_fn=mel_fn,
                               use_multiscale_melloss=False)
        step_fn(state, world["batch"])
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
