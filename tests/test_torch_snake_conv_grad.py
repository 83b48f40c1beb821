"""Port's K3b — the backward of ``ops.fused_snake_conv`` — on CPU tensors:
the autograd Function (forward and backward routed to the plain versions)
against autograd of ``snake_conv_plain`` and against ``jax.grad`` of the JAX
package's composition (activation, then a zero-padded dilated conv), on
every sample: dx, d alpha, d beta, dW and db."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.models.bigvgan import (downsample2_nhc, snake,
                                             upsample2_nhc)
from diffbinaural_tpu_torch.ops import (fused_snake_conv,
                                        fused_snake_conv_backward,
                                        snake_conv_backward_plain,
                                        snake_conv_plain)

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

REL = 2e-5  # of each gradient's scale: sums of C*k float32 terms, other order
C = 128


def _world(t, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, C, t)).astype(np.float32)
    dy = rng.standard_normal((2, C, t)).astype(np.float32)
    alpha = (0.3 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(C)).astype(np.float32)
    weight = (0.05 * rng.standard_normal((C, C, k))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, dy, alpha, beta, weight, bias


def _close(got, want, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max(), err_msg=msg)


def _jax_grads(x, dy, alpha, beta, weight, bias, d):
    """jax.vjp of the JAX composition on (B, T, C) with a (k, in, out)
    kernel; returned in the port's layouts."""
    def fn(x_, a_, b_, w_, bias_):
        z = downsample2_nhc(snake(upsample2_nhc(x_), jnp.exp(a_), jnp.exp(b_)))
        pad = (w_.shape[0] - 1) // 2 * d
        y = jax.lax.conv_general_dilated(
            z, w_, window_strides=(1,), padding=((pad, pad),),
            rhs_dilation=(d,), dimension_numbers=("NHC", "HIO", "NHC"),
            precision=jax.lax.Precision.HIGHEST)
        return y + bias_

    args = (x.transpose(0, 2, 1), alpha, beta, weight.transpose(2, 1, 0), bias)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    gx, ga, gb, gw, gbias = (np.asarray(g) for g in
                             vjp(jnp.asarray(dy.transpose(0, 2, 1))))
    return gx.transpose(0, 2, 1), ga, gb, gw.transpose(2, 1, 0), gbias


@pytest.mark.parametrize("t", [40, 300])
@pytest.mark.parametrize("d", [1, 5])
@pytest.mark.parametrize("k", [3, 7])
def test_function_matches_autograd_and_jax_grad(k, d, t):
    world = _world(t, k, seed=k + d + t)
    x, dy, *params = world
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, *params)]
    out = fused_snake_conv(*leaves, d)
    assert type(out.grad_fn).__name__ == "_SnakeConvFunctionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    ref = [torch.from_numpy(a).requires_grad_() for a in (x, *params)]
    auto = torch.autograd.grad(snake_conv_plain(*ref, d), ref,
                               torch.from_numpy(dy))
    want = _jax_grads(*world, d)
    for name, g, a, w in zip(("dx", "dalpha", "dbeta", "dW", "db"), got, auto,
                             want):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), a.numpy(), f"{name} vs autograd")
        _close(g.numpy(), w, f"{name} vs jax.grad")


def test_backward_wrapper_on_cpu_is_the_plain_version():
    x, dy, *params = (torch.from_numpy(a) for a in _world(40, 3, seed=9))
    before = fused_snake_conv_backward.launches
    got = fused_snake_conv_backward(x, dy, *params, 3)
    assert fused_snake_conv_backward.launches == before
    for g, w in zip(got, snake_conv_backward_plain(x, dy, *params, 3)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_function_gives_grads_only_where_asked():
    """Only the weight requires grad (the others are plain tensors): the
    Function still runs, and the weight's gradient is autograd's."""
    x, dy, alpha, beta, weight, bias = (torch.from_numpy(a)
                                        for a in _world(40, 7, seed=10))
    w = weight.clone().requires_grad_()
    out = fused_snake_conv(x, alpha, beta, w, bias, 5)
    (gw,) = torch.autograd.grad(out, [w], dy)
    want = snake_conv_backward_plain(x, dy, alpha, beta, weight, bias, 5)[3]
    _close(gw.numpy(), want.numpy(), "dW")
