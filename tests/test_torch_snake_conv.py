"""Port's ``ops.fused_snake_conv`` (plain version, CPU tensors) against the
JAX package: the unfused activation + zero-padded dilated conv on EVERY
sample, and the interpreted Pallas kernel on the interior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.models.bigvgan import (
    downsample2_nhc,
    snake,
    upsample2_nhc,
)
from diffbinaural_tpu.ops.snake_conv import fused_snake_conv as jax_fused
from diffbinaural_tpu.ops.snake_conv import snake_conv_eligible as jax_eligible
from diffbinaural_tpu_torch.ops import (
    fused_snake_conv,
    snake_conv_eligible,
    snake_conv_plain,
)

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

# sums of C*k float32 terms in another order
TOL = dict(rtol=2e-4, atol=2e-4)


def _world(c, t, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    alpha = rng.standard_normal(c).astype(np.float32) * 0.1
    beta = rng.standard_normal(c).astype(np.float32) * 0.1
    kernel = (rng.standard_normal((k, c, c)) * 0.02).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32) * 0.1
    return x, alpha, beta, kernel, bias


def _jax_composition(x, alpha, beta, kernel, bias, dilation):
    z = downsample2_nhc(snake(upsample2_nhc(jnp.asarray(x)),
                              jnp.exp(alpha), jnp.exp(beta)))
    pad = (kernel.shape[0] - 1) // 2 * dilation
    y = jax.lax.conv_general_dilated(
        z, jnp.asarray(kernel), window_strides=(1,), padding=((pad, pad),),
        rhs_dilation=(dilation,), dimension_numbers=("NHC", "HIO", "NHC"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return np.asarray(y + bias)


def _port(x, alpha, beta, kernel, bias, dilation):
    """(B, T, C) / (k, in, out) in, as the JAX side; the port's op takes
    (B, C, T) and the ``F.conv1d`` weight layout (out, in, k)."""
    got = fused_snake_conv(
        torch.from_numpy(x).permute(0, 2, 1).contiguous(),
        torch.from_numpy(alpha), torch.from_numpy(beta),
        torch.from_numpy(kernel).permute(2, 1, 0).contiguous(),
        torch.from_numpy(bias), dilation)
    return got.permute(0, 2, 1).numpy()


@pytest.mark.parametrize("d", [1, 5])
@pytest.mark.parametrize("k", [3, 7])
def test_matches_jax_composition_on_all_samples(k, d):
    world = _world(128, 200, k)
    want = _jax_composition(*world, d)
    got = _port(*world, d)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d", [1, 5])
@pytest.mark.parametrize("k", [3, 7])
def test_matches_interpreted_pallas_kernel_on_interior(k, d):
    world = _world(128, 192, k, seed=1)
    want = np.asarray(jax_fused(*(jnp.asarray(a) for a in world), dilation=d))
    got = _port(*world, d)
    m = (k - 1) // 2 * d + 8  # the act's edge samples, spread by the conv
    np.testing.assert_allclose(got[:, m:-m], want[:, m:-m], **TOL)


@pytest.mark.parametrize("shape", [(128, 128, 3), (768, 768, 7), (128, 256, 3),
                                   (96, 96, 3), (128, 128, 4)])
def test_eligibility_equals_jax(shape):
    assert snake_conv_eligible(*shape) == jax_eligible(*shape)
    assert snake_conv_eligible(*shape, stride=2) == jax_eligible(*shape, stride=2)


@pytest.mark.parametrize("c,k", [(96, 3), (128, 4)])
def test_ineligible_shape_raises(c, k):
    x = torch.zeros(1, c, 32)
    with pytest.raises(ValueError, match="ineligible"):
        fused_snake_conv(x, torch.zeros(c), torch.zeros(c),
                         torch.zeros(c, c, k), torch.zeros(c))


def test_non_square_weight_raises():
    with pytest.raises(ValueError, match="ineligible"):
        fused_snake_conv(torch.zeros(1, 128, 32), torch.zeros(128),
                         torch.zeros(128), torch.zeros(256, 128, 3),
                         torch.zeros(256))


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x, alpha, beta, kernel, bias = _world(128, 40, 3, seed=2)
    args = (torch.from_numpy(x).permute(0, 2, 1).contiguous(),
            torch.from_numpy(alpha), torch.from_numpy(beta),
            torch.from_numpy(kernel).permute(2, 1, 0).contiguous(),
            torch.from_numpy(bias), 3)
    before = fused_snake_conv.launches
    got = fused_snake_conv(*args)
    assert fused_snake_conv.launches == before
    torch.testing.assert_close(got, snake_conv_plain(*args))
