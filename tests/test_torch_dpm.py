"""DPM-Solver++(2M) and the DPM time grids of the port against the JAX
package: the grids and coefficients exactly, the samplers with the JAX
draw of x_T injected, and the analytic Gaussian-mixture check of
``tests/test_dpm.py`` (the solver's accuracy against a fine DDIM run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
from diffbinaural_tpu_torch.infer import (Stage1Sampler, denormalize_mel,
                                          normalize_mel)

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import t, toy_jax, toy_torch

GRIDS = ["power2.5", "power1", "lambda", "karras7"]


@pytest.fixture(scope="module")
def engines():
    return (JaxDiffusion(timesteps=1000),
            GaussianDiffusion(timesteps=1000, device="cpu"))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("steps", [1, 2, 5, 12, 25])
def test_time_pairs_and_coeffs_equal_jax(engines, grid, steps):
    jd, td = engines
    want_pairs = jd._dpm_time_pairs(steps, grid)
    got_pairs = td._dpm_time_pairs(steps, grid)
    assert got_pairs.dtype == want_pairs.dtype == np.int32
    np.testing.assert_array_equal(got_pairs, want_pairs)
    assert len(got_pairs) == steps and got_pairs[-1, 1] == -1
    want = jd._dpm_coeffs(want_pairs)
    got = td._dpm_coeffs(got_pairs)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-1], [0, 1, 0, 0, 0, 1])


def test_unknown_time_grid_raises(engines):
    with pytest.raises(ValueError, match="time_grid"):
        engines[1]._dpm_time_pairs(5, "cubic")


def _inputs(seed=0, b=3, hw=8):
    rng = np.random.default_rng(seed)
    mix = rng.uniform(-1, 1, (b, 1, hw, hw)).astype(np.float32)
    feat = rng.standard_normal((b, 16)).astype(np.float32)
    return mix, feat


def _jax_initial_noise(key, shape):
    rng_init, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(rng_init, shape, jnp.float32))


@pytest.mark.parametrize("sampler", ["dpm", "ddim_power2.5"])
@pytest.mark.parametrize("steps", [1, 4])
def test_samplers_on_dpm_grids_match_jax(sampler, steps):
    """The toy denoiser reads mix_t, so a wrong noised-mix refresh (or one
    made on the last step) shows."""
    mix, feat = _inputs()
    key = jax.random.PRNGKey(5)
    jd = JaxDiffusion(image_size=8, timesteps=100, sampling_timesteps=steps)
    td = GaussianDiffusion(image_size=8, timesteps=100,
                           sampling_timesteps=steps, device="cpu")
    cond_j = (jnp.asarray(mix), jnp.asarray(feat))
    cond_t = (t(mix), t(feat))
    noise = t(_jax_initial_noise(key, (3, 2, 8, 8)))
    if sampler == "dpm":
        want = jd.dpm_sample(toy_jax, cond_j, key, return_all_timesteps=True)
        got = td.dpm_sample(toy_torch, cond_t, noise=noise,
                            return_all_timesteps=True)
    else:
        want = jd.ddim_sample(toy_jax, cond_j, key, return_all_timesteps=True,
                              time_grid="power2.5")
        got = td.ddim_sample(toy_torch, cond_t, noise=noise,
                             return_all_timesteps=True, time_grid="power2.5")
    assert got.shape == (3, steps + 1, 2, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_stage1_sampler_takes_the_dpm_sampler():
    mono = np.random.default_rng(3).uniform(-8, 0, (2, 1, 80, 80)).astype(
        np.float32)
    feat = np.zeros((2, 16), np.float32)
    noise = torch.randn(2, 2, 80, 80, generator=torch.Generator().manual_seed(2))
    sampler = Stage1Sampler(toy_torch, sampling_timesteps=3, sampler="dpm++",
                            device="cpu")
    got = sampler.sample(mono, feat, noise=noise)
    want = denormalize_mel(sampler.diffusion.dpm_sample(
        toy_torch, (normalize_mel(t(mono)), t(feat)), noise=noise))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dpm_sample_draws_from_the_generator():
    mix, feat = _inputs(seed=2)
    td = GaussianDiffusion(image_size=8, timesteps=100, sampling_timesteps=3,
                           device="cpu")
    a = td.dpm_sample(toy_torch, (t(mix), t(feat)),
                      generator=torch.Generator().manual_seed(1))
    b = td.dpm_sample(toy_torch, (t(mix), t(feat)),
                      generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise must be"):
        td.dpm_sample(toy_torch, (t(mix), t(feat)),
                      noise=torch.zeros(3, 1, 8, 8))


# ---- the analytic check of tests/test_dpm.py, on the port ------------------


def _gmm_model_fn(diffusion, mus, weights, s=0.25):
    """Exact noise prediction for data ~ sum_k w_k N(mu_k, s^2 I):
    x_t ~ sum_k w_k N(a mu_k, v I), v = a^2 s^2 + sigma^2, so
    eps* = sigma (x - a sum_k gamma_k mu_k) / v with responsibilities
    gamma_k ~ w_k exp(-|x - a mu_k|^2 / (2v))."""
    ac = diffusion.schedule.alphas_cumprod
    mus = t(mus)
    logw = torch.log(torch.as_tensor(weights, dtype=torch.float32))

    def model_fn(x, tt, condition):
        del condition
        a = torch.sqrt(ac[tt.long()]).reshape(-1, 1, 1, 1)
        var = (a * s) ** 2 + (1.0 - ac[tt.long()].reshape(-1, 1, 1, 1))
        diff = x[:, None] - a[:, None] * mus[None]
        sq = (diff ** 2).sum(dim=(2, 3, 4))
        gamma = torch.softmax(logw[None] - sq / (2.0 * var[:, :, 0, 0]), -1)
        mean = torch.einsum("bk,kchw->bchw", gamma, mus)
        return torch.sqrt(var - (a * s) ** 2) * (x - a * mean) / var

    return model_fn


def _gmm_setup(seed):
    diffusion = GaussianDiffusion(image_size=8, timesteps=1000, device="cpu")
    rng = np.random.default_rng(0)
    mus = 0.6 * np.tanh(rng.standard_normal((2, 2, 8, 8))).astype(np.float32)
    model_fn = _gmm_model_fn(diffusion, mus, np.asarray([0.6, 0.4]))
    mix = (0.1 * rng.standard_normal((3, 1, 8, 8))).astype(np.float32)
    cond = (t(mix), torch.zeros(3, 512))
    noise = torch.randn(3, 2, 8, 8, generator=torch.Generator().manual_seed(seed))
    return diffusion, model_fn, cond, noise


def test_dpm_beats_ddim_at_half_the_steps():
    diffusion, model_fn, cond, noise = _gmm_setup(7)
    gt = diffusion.ddim_sample(model_fn, cond, noise=noise,
                               sampling_timesteps=400)

    def err(steps, sample):
        return (sample(model_fn, cond, noise=noise, sampling_timesteps=steps)
                - gt).abs().mean().item()

    e_ddim25 = err(25, diffusion.ddim_sample)
    e_dpm12 = err(12, diffusion.dpm_sample)
    e_dpm25 = err(25, diffusion.dpm_sample)
    assert e_dpm12 <= e_ddim25, (e_dpm12, e_ddim25)
    assert e_dpm25 < 0.7 * e_ddim25, (e_dpm25, e_ddim25)


def test_dpm_converges_with_steps():
    diffusion, model_fn, cond, noise = _gmm_setup(3)
    gt = diffusion.ddim_sample(model_fn, cond, noise=noise,
                               sampling_timesteps=400)
    errs = [(diffusion.dpm_sample(model_fn, cond, noise=noise,
                                  sampling_timesteps=n) - gt).abs().mean().item()
            for n in (6, 12, 25)]
    assert errs[0] > errs[1] > errs[2], errs


def test_dpm_single_step_equals_ddim_single_step():
    """One step of either sampler is x0(x_T) from the same x_T."""
    diffusion, model_fn, cond, noise = _gmm_setup(11)
    a = diffusion.ddim_sample(model_fn, cond, noise=noise, sampling_timesteps=1)
    b = diffusion.dpm_sample(model_fn, cond, noise=noise, sampling_timesteps=1)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_dpm_condition_contract_keeps_mono_mix():
    diffusion, _, cond, noise = _gmm_setup(0)
    seen = []

    def probe_fn(x, tt, condition):
        seen.append(tuple(tuple(c.shape) for c in condition))
        return torch.zeros_like(x)

    diffusion.dpm_sample(probe_fn, cond, noise=noise, sampling_timesteps=3)
    assert len(seen) == 3
    assert seen[0] == ((3, 1, 8, 8), (3, 512), (3, 2, 8, 8))
