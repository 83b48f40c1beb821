"""Port's stage-1 training — the diffusion loss, one train step of the tiny
UNet with converted weights, and the optimiser chain — against the JAX
package, with the JAX draws (t, noise, CFG drop mask) injected."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from diffbinaural_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diffbinaural_tpu.infer.stage1 import normalize_mel as jax_normalize_mel
from diffbinaural_tpu.models import AudioVisualModel as JaxAudioVisualModel
from diffbinaural_tpu.train import TrainingStabilizer as JaxStabilizer
from diffbinaural_tpu.train import make_stage1_train_step as jax_make_step
from diffbinaural_tpu_torch.convert import (unet_params_from_flax,
                                            tree_to_flax)
from diffbinaural_tpu_torch.core.config import UnetConfig
from diffbinaural_tpu_torch.diffusion import GaussianDiffusion
from diffbinaural_tpu_torch.models import build_unet, unet
from diffbinaural_tpu_torch.train import (TrainingStabilizer,
                                          make_stage1_train_step)
from diffbinaural_tpu_torch.train.stage1 import apply_update_

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import random_params, t, to_numpy_tree
from _torch_port_util import toy_jax as _toy_jax, toy_torch as _toy_torch


def _jax_draws(key, b, shape, timesteps, threshold=0.1):
    """t, noise and the CFG drop mask exactly as the JAX ``p_losses`` draws
    them from ``key``."""
    rng_t, rng_noise, rng_cfg = jax.random.split(key, 3)
    tt = jax.random.randint(rng_t, (b,), 0, timesteps)
    noise = jax.random.normal(rng_noise, shape, jnp.float32)
    drop = jax.random.uniform(rng_cfg, (b,)) < threshold
    return np.array(tt), np.array(noise), np.array(drop)


def _key_with_one_drop(b, shape, timesteps, start=0):
    """The first PRNG key whose CFG mask drops some samples and not all."""
    for seed in range(start, start + 500):
        key = jax.random.PRNGKey(seed)
        drop = _jax_draws(key, b, shape, timesteps)[2]
        if drop.any() and not drop.all():
            return key
    raise AssertionError("no key with a mixed drop mask")


def _loss_inputs(seed=0, b=4, hw=8):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (b, 2, hw, hw)).astype(np.float32)
    mix = rng.uniform(-1, 1, (b, 1, hw, hw)).astype(np.float32)
    feat = rng.standard_normal((b, 16)).astype(np.float32)
    return x0, mix, feat


# ------------------------------------------------------------ the loss


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_p_losses_matches_jax(objective, loss_type):
    x0, mix, feat = _loss_inputs()
    kwargs = dict(image_size=8, timesteps=100, objective=objective,
                  loss_type=loss_type, p2_loss_weight_gamma=0.5)
    key = _key_with_one_drop(4, x0.shape, 100)
    jd = JaxDiffusion(**kwargs)
    want = float(jd.p_losses(_toy_jax, key, jnp.asarray(x0),
                             (jnp.asarray(mix), jnp.asarray(feat)), cfg=True))
    tt, noise, drop = _jax_draws(key, 4, x0.shape, 100)
    td = GaussianDiffusion(device="cpu", **kwargs)
    got = td.p_losses(_toy_torch, t(x0), (t(mix), t(feat)), t=t(tt),
                      noise=t(noise), drop=t(drop), cfg=True)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # the train-mode call: size check, normalise, the same loss
    got_call = td(_toy_torch, t(x0), (t(mix), t(feat)), t=t(tt),
                  noise=t(noise), drop=t(drop), cfg=True)
    np.testing.assert_allclose(float(got_call), want, rtol=1e-5)
    with pytest.raises(ValueError, match="height and width"):
        td(_toy_torch, t(x0)[..., :4], (t(mix), t(feat)))


def _spy_losses(td, x0, mix, feat, **kwargs):
    seen = {}

    def spy(x, tt, cond):
        seen["x"], seen["cond"] = x, cond
        return _toy_torch(x, tt, cond)

    loss = td.p_losses(spy, t(x0), (t(mix), t(feat)), **kwargs)
    return loss, seen


def test_mix_t_is_the_mix_noised_with_the_targets_noise():
    x0, mix, feat = _loss_inputs(seed=1)
    rng = np.random.default_rng(2)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    tt = np.array([0, 30, 60, 99], np.int32)
    td = GaussianDiffusion(image_size=8, timesteps=100, device="cpu")
    _, seen = _spy_losses(td, x0, mix, feat, t=t(tt), noise=t(noise))
    s = td.schedule
    a = s.sqrt_alphas_cumprod[t(tt).long()][:, None, None, None]
    b = s.sqrt_one_minus_alphas_cumprod[t(tt).long()][:, None, None, None]
    mix_t = seen["cond"][2]
    assert mix_t.shape == (4, 2, 8, 8)  # (B,1,H,W) mix against (B,2,H,W) noise
    torch.testing.assert_close(mix_t, a * t(mix) + b * t(noise))
    torch.testing.assert_close(seen["x"], a * t(x0) + b * t(noise))


def test_cfg_mask_zeroes_mix_and_feature_but_not_mix_t():
    x0, mix, feat = _loss_inputs(seed=3)
    noise = np.random.default_rng(4).standard_normal(x0.shape).astype(np.float32)
    tt = np.array([5, 30, 60, 99], np.int32)
    drop = np.array([True, False, True, False])
    td = GaussianDiffusion(image_size=8, timesteps=100, device="cpu")
    _, kept = _spy_losses(td, x0, mix, feat, t=t(tt), noise=t(noise))
    _, seen = _spy_losses(td, x0, mix, feat, t=t(tt), noise=t(noise),
                          drop=t(drop), cfg=True)
    got_mix, got_feat, got_mix_t = seen["cond"]
    assert got_mix[0].abs().max() == 0 and got_mix[2].abs().max() == 0
    assert got_feat[0].abs().max() == 0 and got_feat[2].abs().max() == 0
    torch.testing.assert_close(got_mix[1], t(mix)[1])
    torch.testing.assert_close(got_feat[3], t(feat)[3])
    torch.testing.assert_close(got_mix_t, kept["cond"][2], rtol=0, atol=0)
    assert got_mix_t[0].abs().max() > 0


def test_weight_is_ignored_and_loss_is_weighted_per_sample():
    x0, mix, feat = _loss_inputs(seed=5)
    noise = np.random.default_rng(6).standard_normal(x0.shape).astype(np.float32)
    tt = np.array([1, 20, 70, 99], np.int32)
    td = GaussianDiffusion(image_size=8, timesteps=100, device="cpu",
                           p2_loss_weight_gamma=1.0)
    kwargs = dict(t=t(tt), noise=t(noise))
    loss, seen = _spy_losses(td, x0, mix, feat, **kwargs)
    weighted, _ = _spy_losses(td, x0, mix, feat, weight=torch.full((4,), 7.0),
                              **kwargs)
    torch.testing.assert_close(loss, weighted, rtol=0, atol=0)
    out = _toy_torch(seen["x"], t(tt), seen["cond"])
    per_sample = (out - t(noise)).abs().reshape(4, -1).mean(dim=1)
    want = (per_sample * td.schedule.p2_loss_weight[t(tt).long()]).mean()
    torch.testing.assert_close(loss, want)
    assert td.schedule.p2_loss_weight[t(tt).long()].std() > 0


def test_draws_come_from_the_generator():
    x0, mix, feat = _loss_inputs(seed=7)
    td = GaussianDiffusion(image_size=8, timesteps=100, device="cpu")

    def loss(seed):
        return td.p_losses(_toy_torch, t(x0), (t(mix), t(feat)), cfg=True,
                           generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(loss(1), loss(1), rtol=0, atol=0)
    assert loss(1) != loss(2)


def test_unknown_loss_type_is_refused():
    with pytest.raises(ValueError, match="loss type"):
        GaussianDiffusion(loss_type="huber", device="cpu")


# ------------------------------------------------- one step of the tiny UNet

SIZE, B, T = 16, 2, 50


@pytest.fixture(scope="module")
def world():
    """The tiny JAX model with random parameters, a raw ln-mel batch, a PRNG
    key whose drop mask is mixed, and the JAX side's loss, gradients, pre-clip
    norm and updated parameters for one step from it."""
    rng = np.random.default_rng(0)
    batch = {
        "mono_mel": rng.uniform(-13, 3, (B, 1, SIZE, SIZE)).astype(np.float32),
        "binaural_mel": rng.uniform(-13, 3, (B, 2, SIZE, SIZE)).astype(np.float32),
        "feat": rng.standard_normal((B, 512)).astype(np.float32),
    }
    jm = JaxAudioVisualModel(dim=16)
    x = jnp.zeros((B, 2, SIZE, SIZE))
    cond = (jnp.zeros((B, 1, SIZE, SIZE)), jnp.zeros((B, 512)), x)
    params = random_params(jm, rng, x, jnp.zeros((B,), jnp.int32), cond)
    key = _key_with_one_drop(B, (B, 2, SIZE, SIZE), T)
    jd = JaxDiffusion(image_size=SIZE, timesteps=T, auto_normalize=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        model_fn = lambda x_, t_, c: jm.apply(p, x_, t_, c)  # noqa: E731
        return jd.p_losses(
            model_fn, key, jax_normalize_mel(jbatch["binaural_mel"]),
            (jax_normalize_mel(jbatch["mono_mel"]), jbatch["feat"]), cfg=True)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    init_fn, step_fn = jax_make_step(
        unet_apply=lambda p, x_, t_, c: jm.apply(p, x_, t_, c), diffusion=jd,
        lr_unet=1e-3, donate=False)
    new_state, metrics = step_fn(init_fn({"unet": params}), jbatch, key)
    return dict(batch=batch, params=params, key=key, loss=float(loss),
                grads=to_numpy_tree(grads), metrics=metrics,
                new_params=to_numpy_tree(new_state.params["unet"]))


def _port_state(world, **kwargs):
    tm = unet.AudioVisualModel(dim=16)
    tm.load_state_dict(unet_params_from_flax(to_numpy_tree(world["params"])),
                       strict=True)
    td = GaussianDiffusion(image_size=SIZE, timesteps=T, device="cpu")
    init_fn, step_fn = make_stage1_train_step(
        tm, diffusion=td, lr_unet=1e-3, device="cpu", **kwargs)
    return init_fn(), step_fn


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_one_train_step_matches_jax(world):
    """Loss rtol 1e-5, pre-clip gradient norm rtol 1e-4, every parameter's
    gradient atol 1e-5 + rtol 1e-3 (float32 both sides, ~40 layers deep), the
    updated parameters within 2 * lr: at step 1 Adam's update is
    lr * g / (|g| + eps), so a gradient that is zero up to rounding —
    cross-attention's q/k and norm3, whose softmax runs over one key — may
    flip its sign between the frameworks."""
    state, step_fn = _port_state(world)
    tt, noise, drop = _jax_draws(world["key"], B, (B, 2, SIZE, SIZE), T)
    assert drop.any() and not drop.all()
    before = {k: v.detach().clone() for k, v in state.unet.named_parameters()}
    state, metrics = step_fn(state, world["batch"], t=tt, noise=noise, drop=drop)
    assert state.step == 1

    np.testing.assert_allclose(float(metrics["loss"]), world["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(world["metrics"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(world["metrics"]["grad_norm"]), rtol=1e-4)

    # the gradients were clipped in place: undo the clip's factor
    norm = float(metrics["grad_norm"])
    assert norm > 1.0
    got = _flat(tree_to_flax(
        {k: p.grad * norm for k, p in state.unet.named_parameters()}))
    want = _flat(world["grads"]["params"])
    assert set(got) == set(want) and len(got) > 300
    nonzero = 0
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3, atol=1e-5,
                                   err_msg=name)
        nonzero += bool(np.abs(want[name]).max() > 1e-4)
    assert nonzero > 250

    new = _flat(tree_to_flax(dict(state.unet.named_parameters())))
    want_new = _flat(world["new_params"]["params"])
    moved = 0
    for name in sorted(want_new):
        np.testing.assert_allclose(new[name], want_new[name], rtol=0,
                                   atol=2e-3 * 1.001, err_msg=name)
    for k, p in state.unet.named_parameters():
        moved += bool((p.detach() - before[k]).abs().max() > 1e-4)
    assert moved > 300


def test_dropout_stays_off_whatever_the_module_mode(world):
    """The JAX step applies the UNet deterministically; the port's step gives
    one loss for one state and one noise even on a module in train() mode,
    and leaves the mode as it found it."""
    state, step_fn = _port_state(world)
    state.lr_scale = 0.0  # weight decay and Adam both scale with the LR
    state.unet.train()
    assert any(isinstance(m, nn.Dropout) and m.p > 0
               for m in state.unet.modules())
    tt, noise, drop = _jax_draws(world["key"], B, (B, 2, SIZE, SIZE), T)
    losses = []
    for _ in range(2):
        state, m = step_fn(state, world["batch"], t=tt, noise=noise, drop=drop)
        losses.append(float(m["loss"]))
        assert state.unet.training
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], world["loss"], rtol=1e-5)


def test_lr_scale_zero_freezes_the_parameters(world):
    state, step_fn = _port_state(world)
    before = {k: v.detach().clone() for k, v in state.unet.named_parameters()}
    state.lr_scale = 0.0
    state, _ = step_fn(state, world["batch"],
                       generator=torch.Generator().manual_seed(0))
    for k, p in state.unet.named_parameters():
        torch.testing.assert_close(p.detach(), before[k], rtol=0, atol=0)


def test_batch_without_feat_needs_a_visual_encoder(world):
    state, step_fn = _port_state(world)
    batch = {k: v for k, v in world["batch"].items() if k != "feat"}
    with pytest.raises(ValueError, match="visual encoder"):
        step_fn(state, batch, generator=torch.Generator().manual_seed(0))


def test_loss_trends_down_on_a_fixed_batch():
    tm = build_unet(UnetConfig(dim=16), device="cpu", seed=0)
    assert not tm.training and all(p.requires_grad for p in tm.parameters())
    td = GaussianDiffusion(image_size=SIZE, timesteps=T, sampling_timesteps=5,
                           device="cpu")
    init_fn, step_fn = make_stage1_train_step(tm, diffusion=td, lr_unet=1e-3,
                                              device="cpu")
    state = init_fn()
    batch = {"mono_mel": np.zeros((B, 1, SIZE, SIZE), np.float32),
             "binaural_mel": np.zeros((B, 2, SIZE, SIZE), np.float32),
             "feat": np.zeros((B, 512), np.float32)}
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        state, m = step_fn(state, batch, generator=gen)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"]))
    assert state.step == 8
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


# ------------------------------------------------------- the optimiser chain


class _Leaves(nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.leaves = nn.ParameterList(
            [nn.Parameter(torch.from_numpy(a.copy())) for a in arrays])


@pytest.mark.parametrize("clip_value", [None, 0.05])
def test_optimiser_chain_matches_optax(clip_value):
    """The update alone — clip by global norm, clip by value, Adam moments,
    decoupled weight decay on every leaf, per-group LR times ``lr_scale`` —
    fed the same numpy gradients on both sides for 3 steps, ``lr_scale``
    changed at step 2; the first step's gradients are above the norm clip,
    the last step's below it.  Updated parameters to 1e-6."""
    rng = np.random.default_rng(11)
    shapes = {"unet": [(4, 3), (5,), (2, 3, 2)], "frame": [(6,), (3, 3)]}
    params = {g: [rng.standard_normal(s).astype(np.float32) for s in ss]
              for g, ss in shapes.items()}
    grad_scale = [3.0, 1.0, 0.05]
    grads = [{g: [grad_scale[i] * rng.standard_normal(s).astype(np.float32)
                  for s in ss] for g, ss in shapes.items()} for i in range(3)]
    lr = {"unet": 1e-2, "frame": 3e-3}
    lr_scales = [1.0, 0.5, 0.5]

    # the chain of the JAX train step, as it builds it
    tx = optax.chain(
        optax.clip_by_global_norm(1.0),
        *([optax.clip(clip_value)] if clip_value is not None else []),
        optax.scale_by_adam(b1=0.9, b2=0.999),
        optax.add_decayed_weights(1e-2),
    )
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    jnorms = []
    for g, scale in zip(grads, lr_scales):
        g = jax.tree_util.tree_map(jnp.asarray, g)
        jnorms.append(float(optax.global_norm(g)))
        updates, opt_state = tx.update(g, opt_state, jparams)
        updates = {k: jax.tree_util.tree_map(
            lambda u: -lr[k] * jnp.asarray(scale, jnp.float32) * u, updates[k])
            for k in updates}
        jparams = optax.apply_updates(jparams, updates)

    un, fr = _Leaves(params["unet"]), _Leaves(params["frame"])
    init_fn, _ = make_stage1_train_step(
        un, visual=fr, lr_unet=lr["unet"], lr_frame=lr["frame"],
        diffusion=GaussianDiffusion(timesteps=10, device="cpu"), device="cpu")
    state = init_fn()
    norms = []
    for g, scale in zip(grads, lr_scales):
        for module, name in ((un, "unet"), (fr, "frame")):
            for p, a in zip(module.leaves, g[name]):
                p.grad = torch.from_numpy(a.copy())
        state.lr_scale = scale
        norms.append(float(apply_update_(state.optimizer, state.lr_scale, 1.0,
                                         clip_value)))
    np.testing.assert_allclose(norms, jnorms, rtol=1e-6)
    assert norms[0] > 1.0 > norms[2]
    for module, name in ((un, "unet"), (fr, "frame")):
        for p, want, start in zip(module.leaves, jparams[name], params[name]):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)
            assert np.abs(p.detach().numpy() - start).max() > 1e-3


def test_a_parameter_without_gradient_still_decays():
    """optax updates every leaf; the port gives a parameter the loss did not
    reach a zero gradient, so weight decay reaches it too."""
    leaves = _Leaves([np.ones((3,), np.float32), np.ones((2,), np.float32)])
    init_fn, _ = make_stage1_train_step(
        leaves, lr_unet=0.1, weight_decay=0.5,
        diffusion=GaussianDiffusion(timesteps=10, device="cpu"), device="cpu")
    state = init_fn()
    leaves.leaves[0].grad = torch.full((3,), 0.01)
    apply_update_(state.optimizer, 1.0, 1.0, None)
    np.testing.assert_allclose(leaves.leaves[1].detach().numpy(),
                               np.full((2,), 1.0 - 0.1 * 0.5), rtol=1e-6)


# ------------------------------------------------------------- the stabiliser


def test_stabilizer_matches_the_jax_packages():
    rng = np.random.default_rng(12)
    losses = list(rng.uniform(0.5, 1.5, 14)) + [100.0] + list(rng.uniform(0.5, 1.5, 3))
    port, ref = TrainingStabilizer(lr_patience=2), JaxStabilizer(lr_patience=2)
    for i, loss in enumerate(losses):
        if loss == 100.0:
            with pytest.warns(UserWarning, match="Anomalous loss"):
                got = port.training_step(loss, 0.5 + i)
            with pytest.warns(UserWarning):
                want = ref.training_step(loss, 0.5 + i)
            assert got["is_anomaly"]
        else:
            got, want = (s.training_step(loss, 0.5 + i) for s in (port, ref))
        assert got == want
    for val in (1.0, 2.0, 3.0, 0.5, 0.6, 0.7):
        assert port.validation_step(val) == ref.validation_step(val)
    assert port.lr_stab.scale == 0.25


def test_anomaly_check_averages_the_ten_prior_losses():
    stab = TrainingStabilizer()
    for _ in range(10):
        assert not stab.training_step(1.0, 0.1)["is_anomaly"]
    # 10.5 > 10 * mean(ten prior ones) but not > 10 * mean with itself
    with pytest.warns(UserWarning):
        assert stab.training_step(10.5, 0.1)["is_anomaly"]


def test_memory_report_reads_nothing_on_the_cpu():
    assert TrainingStabilizer().memory_report("cpu") == {}
    if not torch.cuda.is_available():
        assert TrainingStabilizer().memory_report() == {}
