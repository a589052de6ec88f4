"""Spatial sharding with halo exchange (parallel/spatial.py in the JAX
package) on torch.distributed: an image's rows split over the ranks of a
mesh axis, each rank holding its contiguous shard.

  halo_exchange   each rank's (N, H/n, W, C) shard with `halo` rows of
                  each neighbour's edge attached (dist.batch_isend_irecv;
                  zero rows at the image's top and bottom, and both halos
                  zero in a world of one, as JAX's jnp.where gives)
  sharded_conv2d  the exact SAME conv of the whole image, shard by shard:
                  exchange a kh // 2 halo, conv VALID in H and SAME in W,
                  which leaves the local rows
  shard_spatial   this rank's rows of a whole image
  gather_spatial  the whole image on every rank, from the shards

Tensors are NHWC and kernels HWIO, as the JAX functions take them. Every
rank of the axis calls these together.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .distributed import in_group, rank_and_world
from .mesh import Mesh, _shard


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh,
                  axis_name: Optional[str] = None) -> torch.Tensor:
    """This rank's (N, h, W, C) shard → (N, halo + h + halo, W, C), the
    rows of the shard above and below attached."""
    axis = axis_name or mesh.axis_names[0]
    above = mesh.neighbour(axis, -1)
    below = mesh.neighbour(axis, +1)
    top = x[:, :halo].contiguous()       # rows this shard sends up
    bottom = x[:, -halo:].contiguous()   # rows this shard sends down
    from_above = torch.zeros_like(top)
    from_below = torch.zeros_like(bottom)
    ops = []
    if above is not None:
        ops += [dist.P2POp(dist.isend, top, above),
                dist.P2POp(dist.irecv, from_above, above)]
    if below is not None:
        ops += [dist.P2POp(dist.isend, bottom, below),
                dist.P2POp(dist.irecv, from_below, below)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_above, x, from_below], dim=1)


def sharded_conv2d(x: torch.Tensor, kernel, mesh: Mesh,
                   axis_name: Optional[str] = None) -> torch.Tensor:
    """The SAME conv (stride 1, odd kernel) of the H-sharded NHWC image
    whose shard `x` is, with HWIO `kernel`; returns this rank's rows of
    the result."""
    k = torch.as_tensor(kernel, device=x.device, dtype=x.dtype)
    kh, kw = k.shape[0], k.shape[1]
    padded = halo_exchange(x, kh // 2, mesh, axis_name) if kh // 2 else x
    y = F.conv2d(padded.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                 padding=(0, kw // 2))
    return y.permute(0, 2, 3, 1)


def shard_spatial(x, mesh: Mesh, axis_name: Optional[str] = None
                  ) -> torch.Tensor:
    """This rank's rows of the (N, H, W, C) image `x` (a tensor, or numpy
    on the CPU), H split over the mesh axis."""
    axis = axis_name or mesh.axis_names[0]
    return _shard(torch.as_tensor(x), 1, mesh.shape[axis],
                  mesh.coords()[axis])


def gather_spatial(x: torch.Tensor, mesh: Mesh,
                   axis_name: Optional[str] = None) -> torch.Tensor:
    """The whole (N, H, W, C) image on every rank, from each rank's rows
    (a one-axis mesh over the group)."""
    if not in_group():
        return x
    parts = [torch.empty_like(x) for _ in range(rank_and_world()[1])]
    dist.all_gather(parts, x.contiguous())
    axis = axis_name or mesh.axis_names[0]
    order = [mesh.coords(r)[axis] for r in range(len(parts))]
    return torch.cat([p for _, p in sorted(zip(order, parts),
                                           key=lambda a: a[0])], dim=1)
