"""Port's K2b — the backward of ``ops.fused_alias_free_snake`` — on CPU
tensors: the written-out adjoint (``alias_free_snake_backward_plain``)
against torch autograd of the plain forward and against ``jax.vjp`` of the
JAX package's CPU composition on EVERY sample, the interior against the
interpreted Pallas backward (whose dropped edge scatter is recorded, not
hidden), and the autograd Function's plumbing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.models.bigvgan import (downsample2_nhc, snake,
                                             upsample2_nhc)
from diffbinaural_tpu.ops.alias_free_act import _fused_backward
from diffbinaural_tpu_torch.ops import (alias_free_snake_backward_plain,
                                        alias_free_snake_plain,
                                        fused_alias_free_snake,
                                        fused_alias_free_snake_backward)

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

REL = 1e-5  # of each gradient's scale: float32 both sides, other sum order


def _world(c, t, logscale, seed=0, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, t)).astype(np.float32)
    dz = rng.standard_normal((b, c, t)).astype(np.float32)
    if logscale:
        alpha = (0.3 * rng.standard_normal(c)).astype(np.float32)
        beta = (0.3 * rng.standard_normal(c)).astype(np.float32)
    else:
        alpha = (0.7 + 0.6 * rng.random(c)).astype(np.float32)
        beta = (0.7 + 0.6 * rng.random(c)).astype(np.float32)
    return x, dz, alpha, beta


def _close(got, want, rel=REL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=msg)


def _plain(x, dz, alpha, beta, logscale):
    return [g.numpy() for g in alias_free_snake_backward_plain(
        *(torch.from_numpy(a) for a in (x, dz, alpha, beta)), logscale)]


def _jax_vjp(x, dz, alpha, beta, logscale):
    """jax.vjp of the JAX package's CPU composition, on (B, T, C)."""
    def fn(x_, a_, b_):
        a = jnp.exp(a_) if logscale else a_
        b = jnp.exp(b_) if logscale else b_
        return downsample2_nhc(snake(upsample2_nhc(x_), a, b))

    _, vjp = jax.vjp(fn, jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(alpha),
                     jnp.asarray(beta))
    dx, da, db = vjp(jnp.asarray(dz.transpose(0, 2, 1)))
    return np.asarray(dx).transpose(0, 2, 1), np.asarray(da), np.asarray(db)


@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("t", [7, 40, 1100])
@pytest.mark.parametrize("c", [4, 24, 128])
def test_plain_backward_matches_autograd_and_jax_vjp(c, t, logscale):
    """Every sample, edges included: T = 7 is shorter than the filters'
    reach (both edge scatters act on one tile), T = 1100 spans several of
    the kernel's tiles."""
    x, dz, alpha, beta = _world(c, t, logscale)
    got = _plain(x, dz, alpha, beta, logscale)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, alpha, beta)]
    auto = torch.autograd.grad(alias_free_snake_plain(*leaves, logscale),
                               leaves, torch.from_numpy(dz))
    want = _jax_vjp(x, dz, alpha, beta, logscale)
    for name, g, a, w in zip(("dx", "dalpha", "dbeta"), got, auto, want):
        _close(g, a.numpy(), msg=f"{name} vs autograd")
        _close(g, w, msg=f"{name} vs jax.vjp")


@pytest.mark.parametrize("t", [160, 1200])
def test_interior_matches_interpreted_pallas_backward(t):
    """dx equals the Pallas backward away from the clip's edges.  At the
    edges it does not: the Pallas kernel drops the replicate pads' scatter
    onto the first / last samples, and the per-channel sums inherit that —
    recorded here so that a change on either side shows."""
    edge = 8
    x, dz, alpha, beta = _world(128, t, False, seed=1)
    dx, da, db = _plain(x, dz, alpha, beta, False)
    pdx, pda, pdb = (np.asarray(a) for a in _fused_backward(
        jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(dz.transpose(0, 2, 1)),
        jnp.asarray(alpha), jnp.asarray(beta)))
    pdx = pdx.transpose(0, 2, 1)
    _close(dx[..., edge:-edge], pdx[..., edge:-edge], rel=1e-4)
    scale = np.abs(dx).max()
    assert np.abs(dx[..., :edge] - pdx[..., :edge]).max() > 1e-3 * scale
    assert np.abs(dx[..., -edge:] - pdx[..., -edge:]).max() > 1e-3 * scale
    for got, pallas in ((da, pda), (db, pdb)):
        diff = np.abs(got - pallas).max() / np.abs(got).max()
        assert 1e-6 < diff < 0.2  # the edge terms alone


@pytest.mark.parametrize("logscale", [True, False])
def test_function_on_cpu_tensors_matches_autograd_of_plain(logscale):
    """The autograd Function, whose forward and backward take the plain
    versions for CPU tensors: gradients with respect to the RAW parameters
    (the log-scale's exp chained outside the Function), in the inputs'
    types, and only where they were asked for."""
    x, dz, alpha, beta = _world(24, 300, logscale, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, alpha, beta)]
    out = fused_alias_free_snake(*leaves, logscale)
    assert type(out.grad_fn).__name__ == "_AliasFreeSnakeFunctionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dz))
    ref = [torch.from_numpy(a).requires_grad_() for a in (x, alpha, beta)]
    want = torch.autograd.grad(alias_free_snake_plain(*ref, logscale), ref,
                               torch.from_numpy(dz))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        _close(g.numpy(), w.numpy())
    # alpha alone requires grad: x gets none
    a = torch.from_numpy(alpha).requires_grad_()
    out = fused_alias_free_snake(torch.from_numpy(x), a,
                                 torch.from_numpy(beta), logscale)
    (ga,) = torch.autograd.grad(out, [a], torch.from_numpy(dz))
    _close(ga.numpy(), want[1].numpy())


def test_function_keeps_bfloat16_input_type():
    x, dz, alpha, beta = _world(8, 64, True, seed=3)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    a = torch.from_numpy(alpha).requires_grad_()
    out = fused_alias_free_snake(xb, a, torch.from_numpy(beta))
    assert out.dtype == torch.bfloat16
    gx, ga = torch.autograd.grad(out, [xb, a], torch.from_numpy(dz).bfloat16())
    assert gx.dtype == torch.bfloat16 and ga.dtype == torch.float32
    want = alias_free_snake_backward_plain(
        xb.detach(), torch.from_numpy(dz).bfloat16(), torch.from_numpy(alpha),
        torch.from_numpy(beta))
    torch.testing.assert_close(gx, want[0])
    torch.testing.assert_close(ga, want[1])


def test_no_grad_and_backward_wrapper_take_no_function():
    x, dz, alpha, beta = _world(8, 64, True, seed=4)
    xt = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        assert fused_alias_free_snake(xt, torch.from_numpy(alpha),
                                      torch.from_numpy(beta)).grad_fn is None
    before = fused_alias_free_snake_backward.launches
    got = fused_alias_free_snake_backward(
        *(torch.from_numpy(a) for a in (x, dz, alpha, beta)))
    assert fused_alias_free_snake_backward.launches == before
    for g, w in zip(got, _plain(x, dz, alpha, beta, True)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_backward_rejects_mismatched_dz():
    x = torch.zeros(2, 8, 16)
    a = torch.zeros(8)
    with pytest.raises(ValueError, match="dz must match"):
        fused_alias_free_snake_backward(x, torch.zeros(2, 8, 15), a, a)
    with pytest.raises(ValueError, match="dz must match"):
        fused_alias_free_snake_backward(x, x.bfloat16(), a, a)
