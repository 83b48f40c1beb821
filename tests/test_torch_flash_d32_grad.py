"""The plain versions of the attention's training forward and backward
(``sdpa_plain_with_lse``, ``sdpa_backward_plain``) against the JAX package's
residual-emitting kernel (interpreted), against autograd through the dense
attention, and against ``jax.grad`` of the JAX dense attention.  The CUDA
kernels are held against these plain versions on the card by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.models.attention import _sdpa as jax_dense_sdpa
from diffbinaural_tpu.ops.flash_d32 import _fwd as jax_flash_fwd
from diffbinaural_tpu_torch.ops import (flash_sdpa, flash_sdpa_backward,
                                        flash_sdpa_with_lse,
                                        sdpa_backward_plain, sdpa_plain,
                                        sdpa_plain_with_lse)

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

SCALE = 32**-0.5


def _tensors(n, seed=0, b=1, h=2, d=32, count=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(dtype)
            for _ in range(count)]


@pytest.mark.parametrize("n", [256, 400])
def test_forward_and_lse_match_jax_residual_kernel(n):
    """o to 2e-5 and lse = m + log l to 1e-5 (same float32 arithmetic in
    another summation order).  The JAX kernel takes the PRE-scaled q."""
    q, k, v = _tensors(n, count=3)
    o_j, l_j, m_j = jax_flash_fwd(jnp.asarray(q) * SCALE, jnp.asarray(k),
                                  jnp.asarray(v), save_residuals=True)
    o, lse = sdpa_plain_with_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                                 SCALE)
    assert lse.shape == (1, 2, n) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(m_j + jnp.log(l_j)),
                               rtol=1e-5, atol=1e-5)


def test_forward_with_lse_agrees_with_the_residual_free_forward():
    q, k, v = (torch.from_numpy(a) for a in _tensors(200, seed=1, count=3))
    o, _ = sdpa_plain_with_lse(q, k, v, SCALE)
    torch.testing.assert_close(o, sdpa_plain(q, k, v, SCALE),
                               rtol=2e-6, atol=2e-6)


def _autograd_grads(q, k, v, do):
    q, k, v = (a.clone().requires_grad_() for a in (q, k, v))
    return torch.autograd.grad(sdpa_plain(q, k, v, SCALE), (q, k, v), do)


@pytest.mark.parametrize("n,dtype,tol", [
    (256, np.float32, 2e-4), (400, np.float32, 2e-4), (1600, np.float32, 2e-4),
    (256, np.float64, 1e-10),
])
def test_backward_formulas_match_autograd(n, dtype, tol):
    """The written-out backward against autograd through the dense
    attention: float32 2e-4 (sums of N terms in another order), float64
    1e-10."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _tensors(n, seed=2, dtype=dtype))
    o, lse = sdpa_plain_with_lse(q, k, v, SCALE)
    got = sdpa_backward_plain(q, k, v, o, lse, do, SCALE)
    for g, w in zip(got, _autograd_grads(q, k, v, do)):
        assert g.dtype == q.dtype
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [256, 400])
def test_backward_formulas_match_jax_grad(n):
    """Against ``jax.grad`` of the JAX dense attention (the stock TPU
    backward kernels do not lower on the CPU, so the dense path is the JAX
    oracle), 2e-4."""
    q, k, v, do = _tensors(n, seed=3)

    def scalar(q_, k_, v_):
        return jnp.sum(jax_dense_sdpa(q_, k_, v_, SCALE) * jnp.asarray(do))

    want = jax.grad(scalar, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                 for a in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = sdpa_plain_with_lse(tq, tk, tv, SCALE)
    got = sdpa_backward_plain(tq, tk, tv, o, lse, tdo, SCALE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def test_scale_is_applied_once_to_dq_and_dk():
    """The scale trap: with scale s the gradients of q and k are s times
    those of unit-scale attention on (s*q, k) and (q, s*k)."""
    q, k, v, do = (torch.from_numpy(a) for a in _tensors(64, seed=4))
    o, lse = sdpa_plain_with_lse(q, k, v, SCALE)
    dq, dk, dv = sdpa_backward_plain(q, k, v, o, lse, do, SCALE)
    o1, lse1 = sdpa_plain_with_lse(q * SCALE, k, v, 1.0)
    dq1, dk1, dv1 = sdpa_backward_plain(q * SCALE, k, v, o1, lse1, do, 1.0)
    torch.testing.assert_close(dq, dq1 * SCALE, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dk, dk1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv, dv1, rtol=1e-5, atol=1e-6)


def test_gradcheck_of_the_cpu_path_in_float64():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _tensors(16, seed=5, count=3, dtype=np.float64))
    assert torch.autograd.gradcheck(
        lambda a, b, c: sdpa_plain(a, b, c, SCALE), (q, k, v),
        eps=1e-6, atol=1e-6, rtol=1e-4)


def test_flash_sdpa_is_differentiable_on_the_cpu():
    """On the CPU ``flash_sdpa`` is the plain version under autograd: the
    output carries a grad_fn and the gradients are autograd's."""
    q, k, v, do = (torch.from_numpy(a) for a in _tensors(48, seed=6))
    qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))
    out = flash_sdpa(qg, kg, vg, SCALE)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    for g, w in zip(got, _autograd_grads(q, k, v, do)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_training_wrappers_take_the_plain_versions_on_the_cpu():
    q, k, v, do = (torch.from_numpy(a) for a in _tensors(40, seed=7))
    before = (flash_sdpa_with_lse.launches, flash_sdpa_backward.launches)
    o, lse = flash_sdpa_with_lse(q, k, v, SCALE)
    grads = flash_sdpa_backward(q, k, v, o, lse, do, SCALE)
    assert (flash_sdpa_with_lse.launches,
            flash_sdpa_backward.launches) == before
    o_p, lse_p = sdpa_plain_with_lse(q, k, v, SCALE)
    torch.testing.assert_close(o, o_p, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=0)
    for g, w in zip(grads, sdpa_backward_plain(q, k, v, o, lse, do, SCALE)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_bfloat16_backward_keeps_type():
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _tensors(32, seed=8))
    o, lse = flash_sdpa_with_lse(q, k, v, SCALE)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    for g in flash_sdpa_backward(q, k, v, o, lse, do, SCALE):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape


@pytest.mark.parametrize("bad", ["lse_shape", "do_shape", "dtype", "device"])
def test_backward_rejects_bad_inputs(bad):
    q, k, v, do = (torch.from_numpy(a) for a in _tensors(16, seed=9))
    o, lse = flash_sdpa_with_lse(q, k, v, SCALE)
    if bad == "lse_shape":
        lse = lse[..., :8]
    elif bad == "do_shape":
        do = do[:, :, :8]
    elif bad == "dtype":
        do = do.bfloat16()
    else:
        q, k, v, o, lse, do = (a.to("meta") for a in (q, k, v, o, lse, do))
    with pytest.raises((ValueError, TypeError)):
        flash_sdpa_backward(q, k, v, o, lse, do, SCALE)
