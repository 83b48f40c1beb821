"""Port's diffusion schedules and samplers against the JAX package (the
training loss is held in ``test_torch_train_stage1.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diffbinaural_tpu.diffusion.schedules import make_schedule as jax_schedule
from diffbinaural_tpu_torch.diffusion import GaussianDiffusion, make_schedule

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import t, toy_jax as _toy_jax, toy_torch as _toy_torch


@pytest.mark.parametrize("name", ["linear", "linear_alpha", "cosine", "sigmoid"])
def test_schedule_constants(name):
    want = jax_schedule(name, 200)
    got = make_schedule(name, 200)
    fields = [f.name for f in dataclasses.fields(got)]
    assert len(fields) == 13
    for f in fields:
        # both are float64 numpy rounded once to float32
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=0, err_msg=f)
    assert got.num_timesteps == 200


@pytest.mark.parametrize("steps", [1, 4, 25, 1000])
def test_ddim_time_pairs(steps):
    want = JaxDiffusion(timesteps=1000, sampling_timesteps=steps)
    got = GaussianDiffusion(timesteps=1000, sampling_timesteps=steps,
                            device="cpu")
    np.testing.assert_array_equal(got._ddim_time_pairs(steps),
                                  want._ddim_time_pairs(steps))


def _inputs(seed=0, b=3, hw=8):
    rng = np.random.default_rng(seed)
    mix = rng.uniform(-1, 1, (b, 1, hw, hw)).astype(np.float32)
    feat = rng.standard_normal((b, 16)).astype(np.float32)
    return mix, feat


def _jax_initial_noise(key, shape):
    """The draw of the JAX sampler: split the key, normal from the first."""
    rng_init, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(rng_init, shape, jnp.float32))


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
@pytest.mark.parametrize("steps", [1, 5])
def test_ddim_sample_matches_jax(objective, steps):
    mix, feat = _inputs()
    key = jax.random.PRNGKey(7)
    jd = JaxDiffusion(image_size=8, timesteps=100, sampling_timesteps=steps,
                      objective=objective)
    want = np.asarray(jd.ddim_sample(
        _toy_jax, (jnp.asarray(mix), jnp.asarray(feat)), key))
    td = GaussianDiffusion(image_size=8, timesteps=100,
                           sampling_timesteps=steps, objective=objective,
                           device="cpu")
    noise = _jax_initial_noise(key, (3, 2, 8, 8))
    got = td.ddim_sample(_toy_torch, (t(mix), t(feat)), noise=t(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ddim_all_timesteps_matches_jax():
    mix, feat = _inputs(seed=1)
    key = jax.random.PRNGKey(3)
    jd = JaxDiffusion(image_size=8, timesteps=100, sampling_timesteps=4)
    want = np.asarray(jd.ddim_sample(
        _toy_jax, (jnp.asarray(mix), jnp.asarray(feat)), key,
        return_all_timesteps=True))
    td = GaussianDiffusion(image_size=8, timesteps=100, sampling_timesteps=4,
                           device="cpu")
    noise = _jax_initial_noise(key, (3, 2, 8, 8))
    got = td.ddim_sample(_toy_torch, (t(mix), t(feat)), noise=t(noise),
                         return_all_timesteps=True)
    assert got.shape == (3, 5, 2, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_condition_stays_mono_and_last_step_leaves_mix_t():
    mix, feat = _inputs(seed=2)
    seen = []

    def spy(x, tt, cond):
        seen.append((int(tt[0]), cond[0].clone(), cond[2].clone()))
        return _toy_torch(x, tt, cond)

    td = GaussianDiffusion(image_size=8, timesteps=100, sampling_timesteps=3,
                           device="cpu")
    noise = torch.from_numpy(
        np.random.default_rng(5).standard_normal((3, 2, 8, 8)).astype(np.float32))
    out = td.ddim_sample(spy, (t(mix), t(feat)), noise=noise)
    assert [s[0] for s in seen] == [99, 65, 32]  # truncated, not rounded
    for _, cond0, mix_t in seen:
        assert cond0.shape == (3, 1, 8, 8)
        torch.testing.assert_close(cond0, t(mix))
        assert mix_t.shape == (3, 2, 8, 8)
    torch.testing.assert_close(seen[0][2], noise + t(mix).repeat(1, 2, 1, 1))
    # the last step returns the clipped x0 prediction
    assert out.abs().max() <= 1.0
    pred = td.model_predictions(_toy_torch, *_last_state(td, seen, mix, feat))
    torch.testing.assert_close(out, pred.pred_x_start)


def _last_state(td, seen, mix, feat):
    """Replay the first two steps to get the state entering the last one."""
    img = seen[0][2] - t(mix).repeat(1, 2, 1, 1)
    mix2 = t(mix).repeat(1, 2, 1, 1)
    mix_t = seen[0][2]
    ac = td.schedule.alphas_cumprod
    for time, time_next in td._ddim_time_pairs(3).tolist()[:2]:
        tt = torch.full((3,), time, dtype=torch.int32)
        pn, x0 = td.model_predictions(_toy_torch, img, tt,
                                      (t(mix), t(feat), mix_t))
        c = torch.sqrt(1 - ac[time_next])
        img = x0 * torch.sqrt(ac[time_next]) + c * pn
        mix_t = mix2 * torch.sqrt(ac[time_next]) + c * pn
    torch.testing.assert_close(mix_t, seen[2][2])
    return img, torch.full((3,), 32, dtype=torch.int32), (t(mix), t(feat), mix_t)


def test_generator_noise_is_reproducible():
    mix, feat = _inputs(seed=3)
    td = GaussianDiffusion(image_size=8, timesteps=100, sampling_timesteps=2,
                           device="cpu")
    a = td.ddim_sample(_toy_torch, (t(mix), t(feat)),
                       generator=torch.Generator().manual_seed(1))
    b = td.ddim_sample(_toy_torch, (t(mix), t(feat)),
                       generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)


def test_q_sample_and_predictions_match_jax():
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((4, 2, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((4, 2, 8, 8)).astype(np.float32)
    tt = np.array([0, 10, 50, 99], np.int32)
    jd = JaxDiffusion(image_size=8, timesteps=100)
    td = GaussianDiffusion(image_size=8, timesteps=100, device="cpu")
    for name, args in [("q_sample", (x0, tt, noise)),
                       ("predict_start_from_noise", (x0, tt, noise)),
                       ("predict_noise_from_start", (x0, tt, noise)),
                       ("predict_v", (x0, tt, noise)),
                       ("predict_start_from_v", (x0, tt, noise))]:
        want = np.asarray(getattr(jd, name)(*(jnp.asarray(a) for a in args)))
        got = getattr(td, name)(*(t(a) for a in args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def _jax_ancestral_noises(rng_init, rng_steps, shape, steps):
    """The draws of the JAX ancestral loops: x_T from ``rng_init``, then one
    key per step from ``rng_steps``."""
    keys = jax.random.split(rng_steps, steps)
    return np.stack(
        [np.asarray(jax.random.normal(rng_init, shape))]
        + [np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in keys])


def test_p_sample_loop_matches_jax():
    mix, feat = _inputs(seed=6)
    cond = (mix, feat, np.repeat(mix, 2, axis=1))
    key = jax.random.PRNGKey(11)
    jd = JaxDiffusion(image_size=8, timesteps=12)
    want = np.asarray(jd.p_sample_loop(
        _toy_jax, tuple(jnp.asarray(c) for c in cond), (3, 2, 8, 8), key,
        return_all_timesteps=True))
    noises = _jax_ancestral_noises(*jax.random.split(key), (3, 2, 8, 8), 12)
    td = GaussianDiffusion(image_size=8, timesteps=12, device="cpu")
    got = td.p_sample_loop(_toy_torch, tuple(t(c) for c in cond), (3, 2, 8, 8),
                           noises=t(noises), return_all_timesteps=True)
    assert got.shape == (3, 13, 2, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    last = td.p_sample_loop(_toy_torch, tuple(t(c) for c in cond),
                            (3, 2, 8, 8), noises=t(noises))
    np.testing.assert_allclose(last.numpy(), want[:, -1], rtol=1e-5, atol=1e-5)
    drawn = td.p_sample_loop(_toy_torch, tuple(t(c) for c in cond),
                             (3, 2, 8, 8),
                             generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 2, 8, 8) and torch.isfinite(drawn).all()


def test_interpolate_matches_jax():
    rng = np.random.default_rng(8)
    x1, x2 = (rng.uniform(0, 1, (2, 2, 8, 8)).astype(np.float32)
              for _ in range(2))
    key = jax.random.PRNGKey(5)
    toy_j = lambda x, tt, cond: 0.3 * x + jnp.sin(tt * 0.1)[:, None, None, None]  # noqa: E731
    toy_t = lambda x, tt, cond: 0.3 * x + torch.sin(tt * 0.1)[:, None, None, None]  # noqa: E731
    jd = JaxDiffusion(image_size=8, timesteps=20)
    want = np.asarray(jd.interpolate(toy_j, jnp.asarray(x1), jnp.asarray(x2),
                                     key, t=9, lam=0.3))
    rng_n, rng_steps = jax.random.split(key)
    k1, k2 = jax.random.split(rng_n)
    steps = _jax_ancestral_noises(k1, rng_steps, x1.shape, 9)
    noises = np.concatenate(
        [steps[:1], np.asarray(jax.random.normal(k2, x2.shape))[None],
         steps[1:]])
    td = GaussianDiffusion(image_size=8, timesteps=20, device="cpu")
    got = td.interpolate(toy_t, t(x1), t(x2), t=9, lam=0.3, noises=t(noises))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_q_posterior_and_process_xstart_match_jax():
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal((4, 2, 8, 8)).astype(np.float32)
    xt = rng.standard_normal((4, 2, 8, 8)).astype(np.float32)
    tt = np.array([0, 10, 50, 99], np.int32)
    jd = JaxDiffusion(image_size=8, timesteps=100)
    td = GaussianDiffusion(image_size=8, timesteps=100, device="cpu")
    want = jd.q_posterior(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(tt))
    for g, w in zip(td.q_posterior(t(x0), t(xt), t(tt)), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    for dyn in (False, True):
        np.testing.assert_allclose(
            td.process_xstart(t(x0), dynamic_threshold=dyn).numpy(),
            np.asarray(jd.process_xstart(jnp.asarray(x0), dynamic_threshold=dyn)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
@pytest.mark.parametrize("min_snr", [False, True])
def test_loss_weight_matches_jax(objective, min_snr):
    kwargs = dict(timesteps=100, objective=objective,
                  min_snr_loss_weight=min_snr, min_snr_gamma=3.0,
                  p2_loss_weight_gamma=0.5, p2_loss_weight_k=2.0)
    jd, td = JaxDiffusion(**kwargs), GaussianDiffusion(device="cpu", **kwargs)
    np.testing.assert_allclose(td.loss_weight.numpy(), jd.loss_weight,
                               rtol=2e-5)
    np.testing.assert_allclose(td.schedule.p2_loss_weight.numpy(),
                               jd.schedule.p2_loss_weight, rtol=1e-6)


@pytest.mark.parametrize("name", ["DiffusionConfig", "UnetConfig", "VocoderConfig"])
def test_config_dataclasses_equal_jax(name):
    """The port keeps its own copy of the config dataclasses: same fields,
    same defaults."""
    from diffbinaural_tpu.core import config as jax_config
    from diffbinaural_tpu_torch.core import config as port_config

    want = dataclasses.asdict(getattr(jax_config, name)())
    got = dataclasses.asdict(getattr(port_config, name)())
    assert got == want
