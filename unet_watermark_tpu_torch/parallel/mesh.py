"""The mesh and the data-parallel placement (parallel/mesh.py in the JAX
package) on torch.distributed.

A Mesh here is a grid of ranks, one process and one card each, with named
axes; the data axis splits every batch into equal contiguous shards, one
a rank, and the parameters are the same on every rank (`replicated`
broadcasts rank 0's). The gradient all-reduce that XLA inserts under jit
is explicit in training/train.py. JAX's default mesh spans every device
of the process; the port's spans the torchrun world (one card a rank).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .distributed import in_group, rank_and_world


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks on a grid: `devices` holds the rank at each position (as
    JAX's Mesh holds devices), `axis_names` names the grid's axes."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The position of `rank` (default: this process) on each axis."""
        if rank is None:
            rank = rank_and_world()[0]
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not on the mesh {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def neighbour(self, axis: str, step: int,
                  rank: Optional[int] = None) -> Optional[int]:
        """The rank `step` places along `axis` from `rank`, None past the
        mesh's edge."""
        pos = self.coords(rank)
        pos[axis] += step
        if not 0 <= pos[axis] < self.shape[axis]:
            return None
        return int(self.devices[tuple(pos[a] for a in self.axis_names)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.devices.ravel().tolist()})"


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over `devices` (ranks; default every rank of the group, a
    world of one without a group), all on the first axis by default. A
    shape whose product is not the number of ranks raises ValueError, as
    JAX's reshape does."""
    devices = list(devices if devices is not None
                   else range(rank_and_world()[1]))
    if mesh_shape is None:
        mesh_shape = [len(devices)] + [1] * (len(axis_names) - 1)
    arr = np.asarray(devices).reshape(tuple(mesh_shape))
    return Mesh(arr, tuple(axis_names))


def mesh_from_config(cfg) -> Mesh:
    """PARALLEL.MESH_SHAPE (None: the whole world on the first axis) and
    PARALLEL.MESH_AXES."""
    return make_mesh(cfg.PARALLEL.MESH_SHAPE, tuple(cfg.PARALLEL.MESH_AXES))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Where a batch's rows (and, with a spatial axis, its H) go: the
    placement descriptor that shard_batch reads (JAX's NamedSharding of
    P(data_axis, spatial_axis, None, None))."""
    mesh: Mesh
    data_axis: str = "data"
    spatial_axis: Optional[str] = None


def batch_sharding(mesh: Mesh, data_axis: str = "data",
                   spatial_axis: Optional[str] = None) -> BatchSharding:
    """NHWC batches sharded on the data axis (and H on spatial_axis)."""
    return BatchSharding(mesh, data_axis, spatial_axis)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _shard(x, axis: int, parts: int, index: int):
    size = x.shape[axis]
    if size % parts:
        raise ValueError(f"dimension {axis} of size {size} not divisible "
                         f"into {parts} shards")
    n = size // parts
    return x[(slice(None),) * axis + (slice(index * n, (index + 1) * n),)]


def shard_batch(batch, mesh, data_axis: str = "data", device=None):
    """This rank's share of a pytree (dict, list, tuple) of (N, ...) numpy
    arrays or tensors: rows on the data axis (and H on the spatial axis of
    a BatchSharding), as tensors on `device` (default: where they are, the
    CPU for numpy)."""
    sharding = mesh if isinstance(mesh, BatchSharding) else \
        BatchSharding(mesh, data_axis)
    pos = sharding.mesh.coords()
    shape = sharding.mesh.shape

    def put(x):
        t = torch.as_tensor(x)
        t = _shard(t, 0, shape[sharding.data_axis], pos[sharding.data_axis])
        if sharding.spatial_axis is not None:
            t = _shard(t, 1, shape[sharding.spatial_axis],
                       pos[sharding.spatial_axis])
        return t.to(device) if device is not None else t
    return _tree_map(put, batch)


def _state_tensors(obj) -> list:
    """Every tensor of a module, a TrainState (model, optimizer state,
    step) or a pytree of tensors."""
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if hasattr(obj, "model") and hasattr(obj, "opt"):
        opt = obj.opt
        return (_state_tensors(obj.model) + opt.mu + opt.nu + opt.trace
                + [opt.count, opt.lr, obj.step])
    return [t for t in _leaves(obj) if isinstance(t, torch.Tensor)]


@torch.no_grad()
def replicated(obj, mesh: Optional[Mesh] = None, src: int = 0) -> Any:
    """Rank `src`'s values of every tensor of `obj` (a module, a
    TrainState, a pytree of tensors) broadcast in place to every rank;
    returns `obj`. Nothing to do without a group."""
    if not in_group():
        return obj
    for t in _state_tensors(obj):
        dist.broadcast(t.data, src)
    return obj


def pad_batch_to(batch, n: int):
    """Pad the leading dim of a pytree of numpy arrays to n with zeros.

    Returns (padded_batch, valid_mask) where valid_mask is (n,) float32,
    1 for real samples, 0 for the pad; losses and metrics weight by it."""
    def pad(x):
        b = x.shape[0]
        if b == n:
            return x
        widths = [(0, n - b)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths)

    b = _leaves(batch)[0].shape[0]
    mask = np.zeros((n,), np.float32)
    mask[:b] = 1.0
    return _tree_map(pad, batch), mask


def local_batch_size(global_batch: int, mesh: Mesh,
                     data_axis: str = "data") -> int:
    n = mesh.shape[data_axis]
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by data-parallel "
            f"size {n}")
    return global_batch // n
