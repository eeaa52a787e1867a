"""The device mesh on torch.distributed (reference: mettagrid_tpu/parallel/mesh.py).

Layout: a 2-D ("data", "model") mesh over the ranks of the process group,
rank r at data index r // model_parallel and model index r % model_parallel.
Env state and rollout tensors split their leading env axis over "data";
ranks that share a data index hold the same rows, and every learner tensor
is replicated, as the reference's ``replicate`` puts every leaf at P().

The reference places the shards of one global array on the devices of its
mesh. Here each rank is a process that holds its own rows on its own
device, and what crosses ranks goes through a collective: ``replicate``
broadcasts, ``gather_batch`` gathers and the sharded train step
(parallel/train.py) all-reduces.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mettagrid_tpu_torch.engine.state import resolve_device


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, device=None) -> DeviceMesh:
    """A ("data", "model") mesh of shape (n // model_parallel, model_parallel)
    over an initialised process group of world size n (n_devices, or the
    world size). ``device`` defaults to CUDA and raises when there is none;
    pass "cpu" for a mesh of CPU ranks. On CUDA each rank takes
    cuda:{rank % cards}: its own card, or cuda:0 where the ranks share one."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a process group of {n} ranks, not {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel), mesh_dim_names=("data", "model"))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def data_rows(mesh: DeviceMesh, n: int) -> slice:
    """This rank's rows of a leading axis of n split over "data"; raises
    when n does not divide by the data size."""
    size, index = mesh.size(0), mesh.get_local_rank("data")
    if n % size:
        raise ValueError(f"a leading axis of {n} does not split over {size} data ranks")
    k = n // size
    return slice(index * k, (index + 1) * k)


def _map(fn: Callable[[Any], Any], tree):
    """``fn`` on every tensor or numpy array of a tree of NamedTuples,
    tuples, lists and dicts; None stays None."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    raise TypeError(f"cannot place a {type(tree).__name__} on the mesh")


def _tensor(x, device: torch.device) -> torch.Tensor:
    return (torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x).to(device)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collectives carry it: bools as their bytes (a view)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def shard_batch(tree, mesh: DeviceMesh):
    """This rank's rows of the leading (env-batch) axis of every leaf, on its
    device. ``tree`` is the full batch, held alike by every rank; ranks that
    share a data index get the same rows."""
    device = rank_device(mesh)
    return _map(lambda x: _tensor(x[data_rows(mesh, x.shape[0])], device).clone(), tree)


def replicate(module_or_tree, mesh: DeviceMesh):
    """Every parameter and buffer of a module (in place; the module is
    returned), or every leaf of a tree (on this rank's device), broadcast
    from the mesh's first rank, so that all ranks hold the same bits."""
    src = int(mesh.mesh.flatten()[0])
    if isinstance(module_or_tree, nn.Module):
        with torch.no_grad():
            for t in list(module_or_tree.parameters()) + list(module_or_tree.buffers()):
                dist.broadcast(_wire(t.data), src)
        return module_or_tree
    device = rank_device(mesh)

    def put(x):
        t = _tensor(x, device).clone()
        dist.broadcast(_wire(t), src)
        return t

    return _map(put, module_or_tree)


def gather_batch(tree, mesh: DeviceMesh):
    """The inverse of ``shard_batch`` over "data": every leaf's rows from each
    data index, in order, on this rank's device (the twin of the reference
    rig's ``process_allgather(..., tiled=True)``)."""
    group, size, device = mesh.get_group("data"), mesh.size(0), rank_device(mesh)

    def get(x):
        t = _tensor(x, device).contiguous()
        parts = [torch.empty_like(_wire(t)) for _ in range(size)]
        dist.all_gather(parts, _wire(t), group=group)
        return torch.cat(parts).view(t.dtype)

    return _map(get, tree)
