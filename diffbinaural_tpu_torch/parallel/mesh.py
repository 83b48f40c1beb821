"""The (data x model) mesh over ``torch.distributed`` — counterpart of
``diffbinaural_tpu/parallel/mesh.py``.

The JAX package replaces the reference's two parallelism schemes (one-process
``nn.DataParallel`` for stage 1, ``mp.spawn`` + DDP over NCCL for stage 2) by
one mesh with a ``data`` axis (batch split, parameters replicated, gradients
averaged) and a ``model`` axis (the vocoder's wide convolutions split by
output channel).  Here the mesh is a ``DeviceMesh`` of one process per card,
and what XLA inserts on the TPU is written out:

  * ``shard_batch`` keeps this rank's contiguous block of rows of every leaf
    (the block that ``jax.device_put`` with ``P("data")`` gives device r);
  * the train steps average their gradients over ``data`` with one flat
    all-reduce (``all_reduce_mean_``) before the clip — no
    ``DistributedDataParallel``: the stage-2 step takes its gradients with
    ``torch.autograd.grad``, which DDP's reducer never sees;
  * ``shard_vocoder_params`` keeps each rank's block of a sharded leaf as the
    parameter and gathers the whole leaf where the module reads it (a
    ``torch.nn.utils.parametrize`` parametrization over an autograd-aware
    all-gather), so the kernels receive ordinary full tensors and the output
    is the unsharded generator's.

Without a process group and without a launcher's environment, ``make_mesh``
gives a mesh of one device and no collective runs anywhere: the world-1 paths
are the single-device ones.  Under ``python -m torch.distributed.run`` it
joins the launcher's group (``initialize_multihost``).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.utils import parametrize

from ..core.device import resolve_device

DATA, MODEL = "data", "model"

# the non-deprecated name where this torch has it
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _device_type(devices) -> str:
    """``None`` is the card (raises without one); ``"cpu"``, a device or a
    sequence of devices of one type name it."""
    if devices is None:
        return resolve_device(None).type
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices).type
    types = {torch.device(d).type for d in devices}
    if len(types) != 1:
        raise ValueError(f"devices of several types: {sorted(types)}")
    return types.pop()


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device_type: str = "cuda"):
    """Join the job's process group: NCCL on the card, gloo for
    ``device_type="cpu"``.  The arguments default to the launcher's
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR:MASTER_PORT``, as
    ``torch.distributed.run`` sets them); on the card each process takes
    ``cuda:LOCAL_RANK``.  Without arguments and without a launcher nothing
    is initialised.  Returns ``(num_shards, shard_index)`` = (world size,
    rank), ``data.DataLoader``'s shard coordinates."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    env = os.environ
    if num_processes is None and "WORLD_SIZE" not in env:
        return 1, 0
    world = int(num_processes if num_processes is not None
                else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    kwargs = {}
    if device_type == "cuda":
        local = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        kwargs["device_id"] = local   # NCCL's communicator made here, now
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank,
                            **kwargs)
    return world, rank


def shutdown() -> None:
    """Leave the job's process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices=None) -> DeviceMesh:
    """(data x model) mesh over the job's first ``n_devices`` processes (all
    by default), rank r at (r // model_parallel, r % model_parallel).

    ``devices``: None for the card, ``"cpu"`` (or a CPU device) for a gloo
    job.  Without a process group the launcher's environment, where set, is
    joined first; without either the mesh has one device and no process
    group (every collective of this module is then skipped)."""
    device_type = _device_type(devices)
    if not dist.is_initialized():
        initialize_multihost(device_type=device_type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} with a world of {world}")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} devices do not divide into model_parallel="
                         f"{model_parallel}")
    grid = torch.arange(n).reshape(n // model_parallel, model_parallel)
    if dist.is_initialized():
        return DeviceMesh(device_type, grid, mesh_dim_names=(DATA, MODEL))
    mesh = DeviceMesh(device_type, grid, mesh_dim_names=(DATA, MODEL),
                      _init_backend=False, _rank=0)
    mesh._without_group = True  # read by axis_group
    return mesh


def data_sharding(mesh: DeviceMesh, ndim: int):
    """The placements of ``P("data", None, ...)``: the leading axis over
    ``data``, replicated over ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 1:
        raise ValueError("a scalar has no axis to shard")
    return (Shard(0), Replicate())


def replicate(mesh: DeviceMesh):
    """The placements of ``P()``."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


# ---------------------------------------------------------------- mesh facts


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not part of the mesh")
    return coord[mesh.mesh_dim_names.index(axis)]


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group along ``axis``; None for a mesh without one."""
    if getattr(mesh, "_without_group", False):
        return None
    return mesh.get_group(axis)


def is_main_process() -> bool:
    """Rank 0 of the job (or no job): the process that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def data_rows(n: int, mesh: DeviceMesh) -> slice:
    """This rank's contiguous block of ``n`` rows split over ``data``."""
    size = axis_size(mesh, DATA)
    if n % size:
        raise ValueError(f"{n} rows do not divide over {size} data ranks")
    k = n // size
    i = axis_index(mesh, DATA)
    return slice(i * k, (i + 1) * k)


# ---------------------------------------------------------------- the batch


def _leading(x):
    shape = tuple(x.shape) if hasattr(x, "shape") else ()
    return shape[0] if shape else None


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """This rank's block of rows of every leaf whose leading axis divides the
    ``data`` size; other leaves are replicated (kept whole) — with a warning
    for non-scalar leaves, since a mis-shaped training batch that silently
    trains replicated instead of sharded loses the mesh's throughput.
    Nested dicts, lists and tuples of numpy arrays or tensors; each leaf
    keeps its type and device."""
    n_data = axis_size(mesh, DATA)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        n = _leading(x)
        if n is None:
            return x
        if n % n_data == 0:
            return x[data_rows(n, mesh)]
        warnings.warn(
            f"shard_batch: leaf with leading axis {n} does "
            f"not divide the data-axis size {n_data}; REPLICATING it "
            "(expected for tiny val batches, a throughput bug for "
            "training batches)",
            stacklevel=3,
        )
        return x

    return put(batch)


# ---------------------------------------------------------------- collectives


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     mesh: DeviceMesh) -> None:
    """Average ``tensors`` in place over ``data``: one all-reduce of their
    concatenation per dtype (one in all for float32 gradients), then a
    division by the axis size.  Nothing runs on a mesh without a process
    group."""
    group = axis_group(mesh, DATA)
    if group is None:
        return
    size = axis_size(mesh, DATA)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        torch._foreach_copy_(same, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in same]), same)])


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh,
                    axis: str = DATA) -> torch.Tensor:
    """Every rank's ``x`` stacked along the leading axis in ``axis`` order
    (the inverse of ``data_rows``)."""
    group = axis_group(mesh, axis)
    if group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((axis_size(mesh, axis) * x.shape[0],) + x.shape[1:])
    _all_gather(out, x, group=group)
    return out


# ---------------------------------------------------------------- the vocoder


def _vocoder_spec(shape, model_size: int) -> Optional[int]:
    """Channel-sharding rule for BigVGAN parameters on ``model``: the axis to
    shard, or None to replicate.  The JAX rule's out-channel axis of a 3-D
    kernel (its axis 2) is the port's axis 0 (``convert.py`` reverses the
    three axes); per-channel vectors (biases, snake alpha / beta, weight-norm
    ``g``) shard on their only axis.  An axis is sharded when the model
    size divides it."""
    shape = tuple(shape)
    if len(shape) in (1, 3) and shape[0] % model_size == 0 \
            and shape[0] >= model_size:
        return 0
    return None


class _GatherRows(torch.autograd.Function):
    """All-gather of blocks along axis 0 over ``group``; the backward hands
    each rank the mean of every rank's gradient of its block (every model
    rank computed the same loss, so their sum would count it ``size``
    times)."""

    @staticmethod
    def forward(ctx, shard, group, size):
        ctx.group, ctx.size = group, size
        shard = shard.contiguous()
        out = shard.new_empty((size * shard.shape[0],) + shard.shape[1:])
        _all_gather(out, shard, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        shard = grad.new_empty((grad.shape[0] // ctx.size,) + grad.shape[1:])
        _reduce_scatter(shard, grad, group=ctx.group)
        return shard.div_(ctx.size), None, None


class _GatheredLeaf(nn.Module):
    """Parametrization: the parameter holds this rank's block of rows; the
    module reads the whole leaf, gathered over the ``model`` group."""

    def __init__(self, group, size: int, index: int):
        super().__init__()
        self.group, self.size, self.index = group, size, index

    def forward(self, shard):
        return _GatherRows.apply(shard, self.group, self.size)

    def right_inverse(self, full):
        return full.chunk(self.size)[self.index].clone()


def shard_vocoder_params(vocoder: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Split the BigVGAN generator's parameters by channel over ``model``, in
    place (``_vocoder_spec`` picks the leaves).  Each sharded leaf keeps
    this rank's block as its parameter and is gathered where the module
    reads it; its gradient comes back as the block's.  With
    ``model_parallel`` 1 this is a plain replicate: nothing changes.
    Returns ``vocoder``.  Save and load a sharded module through
    ``gathered_state_dict`` / ``load_gathered_state_dict``."""
    size = axis_size(mesh, MODEL)
    if size == 1:
        return vocoder
    group, index = axis_group(mesh, MODEL), axis_index(mesh, MODEL)
    for module in list(vocoder.modules()):
        names = [n for n, p in module._parameters.items() if p is not None]
        sharded = [n for n in names
                   if _vocoder_spec(module._parameters[n].shape, size) == 0]
        if not sharded:
            continue
        module._unsharded_order = tuple(names)
        for name in sharded:
            parametrize.register_parametrization(
                module, name, _GatheredLeaf(group, size, index), unsafe=True)
    return vocoder


def _gathered(module: nn.Module, name: str) -> bool:
    return (parametrize.is_parametrized(module, name) and isinstance(
        module.parametrizations[name][0], _GatheredLeaf))


def sharded_parameters(module: nn.Module) -> List[nn.Parameter]:
    """The parameters that hold a block of a leaf sharded over ``model``."""
    return [m.parametrizations[n].original for m in module.modules()
            if parametrize.is_parametrized(m) for n in m.parametrizations
            if _gathered(m, n)]


def _plain_modules(module: nn.Module):
    """``named_modules`` without the parametrizations' own modules."""
    for name, m in module.named_modules():
        if "parametrizations" not in name.split("."):
            yield name, m


def gathered_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded leaf gathered whole, under
    its own name and in the unsharded module's order; a collective over
    ``model`` for a sharded module (every rank calls it), the plain state
    dict otherwise."""
    if not sharded_parameters(module):
        return module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for prefix, m in _plain_modules(module):
        pre = f"{prefix}." if prefix else ""
        names = getattr(m, "_unsharded_order", None) or [
            n for n, p in m._parameters.items() if p is not None]
        for n in names:
            out[pre + n] = getattr(m, n).detach()
        for n, b in m._buffers.items():
            if b is not None and n not in m._non_persistent_buffers_set:
                out[pre + n] = b.detach()
    return out


@torch.no_grad()
def load_gathered_state_dict(module: nn.Module,
                             state_dict: Dict[str, torch.Tensor]) -> None:
    """``load_state_dict(strict=True)`` of whole leaves into a module that
    may be sharded: each sharded leaf keeps this rank's block."""
    if not sharded_parameters(module):
        module.load_state_dict(state_dict, strict=True)
        return
    want = set(gathered_state_dict(module))
    if set(state_dict) != want:
        raise RuntimeError(
            f"state dict keys differ: missing {sorted(want - set(state_dict))}"
            f", unexpected {sorted(set(state_dict) - want)}")
    modules = dict(_plain_modules(module))
    for key, value in state_dict.items():
        owner, _, name = key.rpartition(".")
        m = modules[owner]
        if _gathered(m, name):
            original = m.parametrizations[name].original
            block = m.parametrizations[name][0].right_inverse(value)
            original.copy_(block)
        else:
            getattr(m, name).copy_(value)
