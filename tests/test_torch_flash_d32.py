"""Port's ``ops.flash_sdpa`` (plain version, CPU tensors) against the JAX
package's interpreted flash kernel and its dense attention."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.models.attention import _sdpa as jax_dense_sdpa
from diffbinaural_tpu.ops.flash_d32 import flash_sdpa as jax_flash_sdpa
from diffbinaural_tpu_torch.ops import flash_sdpa, sdpa_plain

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

# same float32 arithmetic in another summation order
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(n, seed=0, b=2, h=2, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("n", [256, 400])
def test_matches_jax_flash_kernel(n):
    q, k, v = _qkv(n)
    scale = 32**-0.5
    want = np.asarray(jax_flash_sdpa(*(jnp.asarray(a) for a in (q, k, v)), scale))
    got = flash_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [256, 400])
def test_matches_jax_dense_attention(n):
    q, k, v = _qkv(n, seed=1)
    scale = 32**-0.5
    want = np.asarray(jax_dense_sdpa(*(jnp.asarray(a) for a in (q, k, v)), scale))
    got = flash_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(64, seed=2))
    before = flash_sdpa.launches
    got = flash_sdpa(q, k, v, 0.2)
    assert flash_sdpa.launches == before
    torch.testing.assert_close(got, sdpa_plain(q, k, v, 0.2))


def test_bfloat16_keeps_type():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(64, seed=3))
    assert flash_sdpa(q, k, v, 0.2).dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["shape", "dtype", "rank"])
def test_rejects_bad_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(16))
    if bad == "shape":
        k = k[:, :, :8]
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    else:
        q, k, v = q[0], k[0], v[0]
    with pytest.raises((ValueError, TypeError)):
        flash_sdpa(q, k, v, 0.2)
