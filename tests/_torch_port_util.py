"""Helpers shared by the tests of the PyTorch port: the same numpy data goes
to the JAX package and to ``diffbinaural_tpu_torch``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TINY_VOCODER = dict(
    num_mels=8,
    upsample_rates=(4, 2),
    upsample_kernel_sizes=(8, 4),
    upsample_initial_channel=32,
    resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3), (1, 3)),
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tests run several worker processes on small tensors: one intra-op
    thread each, instead of one per core in every worker, keeps them from
    fighting over the cores.  A test module takes this by importing it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_params(module, rng, *args, **kwargs):
    """A parameter tree for a flax ``module`` called on ``args``, with every
    leaf random (so a mixed-up or dropped parameter shows): shapes from an
    abstract trace of ``init`` — running or compiling the real init takes up
    to a minute on the CPU — and values by the leaf's name: kernels and
    weight-norm directions ~ N(0, 1/fan_in), gains ~ 1, the rest small."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name in ("kernel", "v"):
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("scale", "g"):
            z = 1.0 + 0.1 * z
        else:  # bias, b, alpha, beta
            z = 0.1 * z
        return jnp.asarray(z)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


# toy denoiser, the same arithmetic in both frameworks: reads x, t, the mono
# mix (condition[0]), the visual feature and — unlike the real UNet — mix_t,
# so that a wrong mix_t carry shows
def toy_jax(x, tt, cond):
    mix, feat, mix_t = cond
    assert mix.shape[1] == 1 and mix_t.shape[1] == 2
    s = jnp.sin(tt.astype(jnp.float32) * 0.01)[:, None, None, None]
    f = jnp.tanh(feat.mean(axis=1))[:, None, None, None]
    return 0.5 * x + 0.2 * mix + 0.1 * mix_t * s + 0.05 * f


def toy_torch(x, tt, cond):
    mix, feat, mix_t = cond
    assert mix.shape[1] == 1 and mix_t.shape[1] == 2
    s = torch.sin(tt.float() * 0.01)[:, None, None, None]
    f = torch.tanh(feat.mean(dim=1))[:, None, None, None]
    return 0.5 * x + 0.2 * mix + 0.1 * mix_t * s + 0.05 * f
