"""The port's ``parallel/`` in one process: ``shard_batch``'s blocks against
the JAX ``shard_batch``'s addressable shards on the conftest's 8 CPU
devices, the vocoder's shard rule against the JAX ``_vocoder_spec`` on the
production generator, and the world-1 paths — a mesh of one device and no
process group — bit for bit the paths without a mesh.  The paths across
processes are ``test_torch_parallel_dist.py``'s."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from diffbinaural_tpu.core.config import VocoderConfig as JaxVocoderConfig
from diffbinaural_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from diffbinaural_tpu.parallel import make_mesh as jax_make_mesh
from diffbinaural_tpu.parallel import mesh as jax_mesh
from diffbinaural_tpu.parallel import shard_batch as jax_shard_batch
from diffbinaural_tpu_torch import parallel
from diffbinaural_tpu_torch.core.config import VocoderConfig
from diffbinaural_tpu_torch.infer import BinauralPipeline
from diffbinaural_tpu_torch.models.bigvgan import BigVGAN
from diffbinaural_tpu_torch.parallel.mesh import _vocoder_spec

import _torch_parallel_worker as worker
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)


def _rank_view(n_data, n_model, rank):
    """The port's (n_data x n_model) mesh as rank ``rank`` sees it, without
    a process group (``shard_batch`` runs no collective)."""
    mesh = DeviceMesh("cpu", torch.arange(n_data * n_model).reshape(
        n_data, n_model), mesh_dim_names=("data", "model"),
        _init_backend=False, _rank=rank)
    mesh._without_group = True
    return mesh


@pytest.mark.parametrize("n_data", [2, 4])
def test_shard_batch_blocks_equal_the_jax_shards(n_data):
    """Rank r's block of every leaf is what ``jax.device_put`` under the
    JAX ``shard_batch`` gives the device at r's place in the mesh; numpy
    leaves stay numpy, tensors stay tensors."""
    n_model = 8 // n_data
    jmesh = jax_make_mesh(8, model_parallel=n_model,
                          devices=jax.devices("cpu"))
    rng = np.random.default_rng(n_data)
    batch = {"x": rng.standard_normal((8, 3)).astype(np.float32),
             "nested": {"y": rng.standard_normal((16, 2, 2)).astype(
                 np.float32)}}
    want = jax_shard_batch(batch, jmesh)
    for rank in range(8):
        device = jmesh.devices.reshape(-1)[rank]
        got = parallel.shard_batch(batch, _rank_view(n_data, n_model, rank))
        as_tensors = parallel.shard_batch(
            {"x": torch.from_numpy(batch["x"])},
            _rank_view(n_data, n_model, rank))
        for leaf, block in ((want["x"], got["x"]),
                            (want["nested"]["y"], got["nested"]["y"])):
            shard = next(s for s in leaf.addressable_shards
                         if s.device == device)
            assert isinstance(block, np.ndarray)
            np.testing.assert_array_equal(block, np.asarray(shard.data))
        assert isinstance(as_tensors["x"], torch.Tensor)
        np.testing.assert_array_equal(as_tensors["x"].numpy(), got["x"])


def test_one_device_mesh_and_the_replicated_leaves():
    """Without a process group and a launcher: a (1 x 1) mesh, the world
    (1, 0), no group along either axis.  A leaf that does not divide is
    replicated with the JAX warning's text; a scalar without a warning."""
    mesh = parallel.make_mesh(devices="cpu")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh.device_type == "cpu"
    assert parallel.initialize_multihost() == (1, 0)
    assert parallel.mesh.axis_group(mesh, "data") is None
    with pytest.raises(ValueError, match="model_parallel=2"):
        parallel.make_mesh(model_parallel=2, devices="cpu")
    from torch.distributed.tensor import Replicate, Shard
    assert parallel.data_sharding(mesh, 3) == (Shard(0), Replicate())
    assert parallel.replicate(mesh) == (Replicate(), Replicate())

    jmesh = jax_make_mesh(8, model_parallel=2, devices=jax.devices("cpu"))
    batch = {"odd": np.ones((3, 2), np.float32), "scalar": np.float32(2.0)}
    texts = []
    for shard in (lambda b: jax_shard_batch(b, jmesh),
                  lambda b: parallel.shard_batch(b, _rank_view(4, 2, 5))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = shard(batch)
        texts.append([str(w.message) for w in caught])
        np.testing.assert_array_equal(np.asarray(out["odd"]), batch["odd"])
        assert float(out["scalar"]) == 2.0
    assert texts[0] == texts[1] and len(texts[1]) == 1
    assert "leading axis 3 does not divide the data-axis size 4" in texts[1][0]


@pytest.fixture(scope="module")
def production_generator_shapes():
    """The JAX production generator's parameter shapes (an abstract trace)
    and the port's (on the meta device)."""
    shapes = jax.eval_shape(JaxBigVGAN(JaxVocoderConfig()).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 80, 8)))
    with torch.device("meta"):
        port = BigVGAN(VocoderConfig())
    return shapes, {n: tuple(p.shape) for n, p in port.named_parameters()}


@pytest.mark.parametrize("model_size", [2, 4])
def test_vocoder_shard_rule_picks_the_jax_leaves(production_generator_shapes,
                                                 model_size):
    """On the production generator's parameters: the leaves that the port's
    rule shards, and their axes, are those of the JAX ``_vocoder_spec``
    (the JAX axis 2 of a 3-D kernel is the port's axis 0)."""
    shapes, port = production_generator_shapes
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [str(getattr(p, "key", p)) for p in path]
        assert names[0] == "params"
        spec = jax_mesh._vocoder_spec(leaf, model_size)
        axis = {(None, None, "model"): 2, ("model",): 0}.get(tuple(spec))
        want[".".join(names[1:])] = (axis, leaf.shape)
    got = {n: (_vocoder_spec(shape, model_size), shape)
           for n, shape in port.items()}
    assert got.keys() == want.keys()
    sharded = {n for n, (axis, _) in want.items() if axis is not None}
    assert sharded == {n for n, (axis, _) in got.items() if axis is not None}
    assert len(sharded) > len(want) // 2
    for n in sharded:
        jax_axis, jax_shape = want[n]
        assert got[n][0] == 0
        assert got[n][1][0] == jax_shape[jax_axis]


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_one_device_mesh_steps_equal_the_steps_without_one(stage):
    """A train step made with ``make_mesh()``'s one-device mesh (the global
    draws, the averaging, the shard rule at model size 1) is the step made
    without a mesh, bit for bit."""
    run = {"stage1": worker.stage1_steps, "stage2": worker.stage2_step}[stage]
    plain, meshed = run(), run(parallel.make_mesh(devices="cpu"))
    for key in ("loss", "grad_norm", "metrics"):
        if key in plain:
            assert plain[key] == meshed[key], key
    for key in ("grads", "params"):
        assert plain[key].keys() == meshed[key].keys()
        for name, value in plain[key].items():
            assert torch.equal(meshed[key][name], value), (key, name)


def test_pipeline_groups_with_and_without_a_mesh():
    """Without ``mesh=`` the windows keep their groups of ``unet_batch``;
    with the one-device mesh they run as one group of ``n_windows`` slots,
    bit for bit the unmeshed pipeline at ``unet_batch = n_windows``, and
    the default x_T is drawn from seed 13 at the global shape."""
    net, voc = worker.pipeline_modules(8, dict(worker.TINY_VOCODER,
                                               num_mels=16))
    geometry = dict(num_mels=16, window=16, stride=8, crop_frames=2,
                    sampling_timesteps=2, device="cpu")
    rng = np.random.default_rng(3)
    mono = (rng.standard_normal((1, 16, 48)) * 2 - 5).astype(np.float32)
    feats = rng.standard_normal((5, 512)).astype(np.float32)

    grouped = BinauralPipeline(net, voc, 48, unet_batch=2, **geometry)
    assert (grouped.n_windows, grouped.n_batches, grouped.n_slots,
            grouped.unet_batch) == (5, 3, 6, 2)
    meshed = BinauralPipeline(net, voc, 48, unet_batch=2,
                              mesh=parallel.make_mesh(devices="cpu"),
                              **geometry)
    assert (meshed.n_batches, meshed.n_slots, meshed.unet_batch) == (1, 5, 5)
    one_group = BinauralPipeline(net, voc, 48, unet_batch=5, **geometry)
    noise = torch.from_numpy(rng.standard_normal((1, 5, 2, 16, 16)).astype(
        np.float32))
    assert torch.equal(meshed(mono, feats, noise=noise),
                       one_group(mono, feats, noise=noise))
    assert torch.equal(meshed(mono, feats), one_group(mono, feats))
