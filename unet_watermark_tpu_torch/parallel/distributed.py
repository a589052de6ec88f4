"""The process group (parallel/distributed.py in the JAX package) on
torch.distributed: one process a card, NCCL between cards, gloo on the
CPU.

    torchrun --nproc-per-node N -m unet_watermark_tpu_torch.cli train ...

torchrun names the group through the environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT, GROUP_RANK); a caller may name it
by arguments instead (an address "host:port" or a "tcp://" or "file://"
URL, the number of processes and this one's index). A process that names
no group stays a world of one and forms none.

Where a named group cannot form, initialize raises. The JAX package logs
and carries on as one process (parallel/distributed.py:36-43); here that
would leave N copies training alone and writing the same checkpoints.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the env:// rendezvous of torchrun and of torch.distributed.launch
_ENV_KEYS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def in_group() -> bool:
    """Whether the default process group is formed (any world size)."""
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout_s: float = 600.0) -> Tuple[int, int]:
    """Form the default group and return (rank, world size).

    The group is named by the arguments or, without them, by torchrun's
    environment; naming none is a world of one (nothing is formed). The
    backend is NCCL where `device` is a card, with this process on
    cuda:LOCAL_RANK, else gloo. A named group that does not form within
    `timeout_s` raises RuntimeError."""
    if in_group():
        return rank_and_world()
    env = all(k in os.environ for k in _ENV_KEYS)
    if not (coordinator_address or num_processes or env):
        return 0, 1
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank() if dev.index is None
                              else dev.index)
    kw = {}  # what the arguments name; the environment gives the rest
    if coordinator_address:
        kw["init_method"] = _init_method(coordinator_address)
    if num_processes:
        kw.update(world_size=int(num_processes), rank=int(process_id or 0))
    try:
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    except Exception as e:  # noqa: BLE001 — re-raised with the group named
        raise RuntimeError(
            f"the process group ({backend}, {kw or 'torchrun environment'}) "
            f"did not form: {e}") from e
    rank, world = rank_and_world()
    logger.info("process %d/%d on %s (%s)", rank, world,
                f"cuda:{torch.cuda.current_device()}"
                if dev.type == "cuda" else "cpu", backend)
    return rank, world


class _AllReduceSum(torch.autograd.Function):
    """dist.all_reduce(SUM) whose gradient is the all-reduced gradient
    (torch.distributed.nn.functional.all_reduce's rule; that module is
    deprecated in favour of one without autograd)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the group, differentiable; `x` itself outside
    a group."""
    return _AllReduceSum.apply(x) if in_group() else x


def shutdown() -> None:
    """Destroy the default group, if one was formed."""
    if in_group():
        dist.destroy_process_group()


def barrier() -> None:
    if in_group():
        dist.barrier()


def make_slice_aware_mesh(axis_names: Sequence[str] = ("data",)):
    """A mesh over every rank, ordered by (node, local rank), so that the
    ranks of one machine (one NVLink domain) are contiguous on the data
    axis."""
    from .mesh import Mesh

    rank, world = rank_and_world()
    key = (int(os.environ.get("GROUP_RANK", 0)), local_rank(), rank)
    keys = [key]
    if world > 1:
        keys = [None] * world
        dist.all_gather_object(keys, key)
    order = [k[2] for k in sorted(keys)]
    shape = [world] + [1] * (len(axis_names) - 1)
    return Mesh(np.asarray(order).reshape(shape), tuple(axis_names))


def process_batch_slice(global_batch: int) -> Tuple[int, int, int]:
    """(local_batch, start_index, end_index) of this process's share of a
    global batch, for per-process data loading."""
    rank, n = rank_and_world()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count "
            f"{n}")
    local = global_batch // n
    start = rank * local
    return local, start, start + local
