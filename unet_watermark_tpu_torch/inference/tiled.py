"""Tiled sliding-window inference with Hann-window blending
(inference/tiled.py in the JAX package), on tensors.

An image larger than the model's input is cut into overlapping square
tiles (the last ones clamped to the border); the tiles run through the
network `batch` at a time, and their logits are blended back at full
resolution with a separable Hann window, so the seams cancel. The blend
adds the tiles in plan order, as the JAX package's scan does, so the sums
are the same float32 sums. The JAX package pads the last chunk of tiles to
`batch` for its compile cache; eager torch runs it as it is.

predict_tiled_sharded spreads the tiles over the ranks of a mesh
(parallel/mesh.py): each rank runs its contiguous share, the logits are
all-gathered, and every rank blends the whole map, as predict_tiled does.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def plan_tiles(h: int, w: int, tile: int, overlap: int
               ) -> List[Tuple[int, int]]:
    """Tile origins (y, x) covering (h, w); the last tiles clamp to the
    border."""
    stride = tile - overlap
    ys = list(range(0, max(h - tile, 0) + 1, stride))
    xs = list(range(0, max(w - tile, 0) + 1, stride))
    if not ys or ys[-1] + tile < h:
        ys.append(max(h - tile, 0))
    if not xs or xs[-1] + tile < w:
        xs.append(max(w - tile, 0))
    return [(y, x) for y in ys for x in xs]


@functools.lru_cache(maxsize=16)
def _hann2d(tile: int) -> np.ndarray:
    wx = np.hanning(tile + 2)[1:-1]
    win = np.outer(wx, wx).astype(np.float32)
    return np.maximum(win, 1e-3)


def predict_tiled(forward: Callable[[torch.Tensor], torch.Tensor],
                  image: torch.Tensor, tile: int = 512, overlap: int = 64,
                  batch: int = 8) -> torch.Tensor:
    """Sliding-window logits of one (H, W, 3) image, H and W >= tile.

    forward maps (N, tile, tile, 3) to (N, tile, tile, 1) logits. Returns
    (H, W, 1) float32 blended logits on the image's device."""
    h, w = image.shape[0], image.shape[1]
    if h < tile or w < tile:
        raise ValueError(f"image {h}x{w} smaller than tile {tile}")
    coords = plan_tiles(h, w, tile, overlap)
    tiles = torch.stack([image[y:y + tile, x:x + tile] for y, x in coords])
    logits = torch.cat([forward(tiles[i:i + batch])
                        for i in range(0, len(coords), batch)])
    return _blend(logits, coords, h, w, tile)


def _blend(logits: torch.Tensor, coords, h: int, w: int, tile: int
           ) -> torch.Tensor:
    """The Hann-weighted mean of the tiles' logits, added in plan order."""
    win = torch.as_tensor(_hann2d(tile), device=logits.device)[:, :, None]
    acc = torch.zeros((h, w, 1), dtype=torch.float32, device=logits.device)
    wacc = torch.zeros_like(acc)
    for (y, x), lg in zip(coords, logits):
        acc[y:y + tile, x:x + tile] += lg.float() * win
        wacc[y:y + tile, x:x + tile] += win
    return acc / torch.clamp(wacc, min=1e-8)


def predict_tiled_sharded(forward: Callable[[torch.Tensor], torch.Tensor],
                          image: torch.Tensor, mesh, tile: int = 512,
                          overlap: int = 64, batch: Optional[int] = None
                          ) -> torch.Tensor:
    """predict_tiled over the ranks of `mesh`: the tile count is padded to
    a multiple of the mesh's size with zero tiles, as in the JAX package;
    rank r runs the r-th contiguous share (`batch` at a time, or in one
    call where batch is None, as JAX's one sharded forward), the logits
    are all-gathered and every rank returns the whole (H, W, 1) float32
    map. Every rank of the mesh calls it with the same image."""
    import torch.distributed as dist

    from ..parallel.distributed import in_group, rank_and_world

    h, w = image.shape[0], image.shape[1]
    if h < tile or w < tile:
        raise ValueError(f"image {h}x{w} smaller than tile {tile}")
    coords = plan_tiles(h, w, tile, overlap)
    n, ndev = len(coords), mesh.size
    per = -(-n // ndev)
    ranks = mesh.devices.ravel().tolist()  # the share order
    share = ranks.index(rank_and_world()[0])
    mine = coords[share * per:(share + 1) * per]
    tiles = torch.zeros((per, tile, tile) + tuple(image.shape[2:]),
                        dtype=image.dtype, device=image.device)
    for i, (y, x) in enumerate(mine):
        tiles[i] = image[y:y + tile, x:x + tile]
    step = batch or per
    logits = torch.cat([forward(tiles[i:i + step])
                        for i in range(0, per, step)]).float()
    if in_group():
        parts = [torch.empty_like(logits) for _ in range(ndev)]
        dist.all_gather(parts, logits.contiguous())
        logits = torch.cat([parts[r] for r in ranks])
    return _blend(logits[:n], coords, h, w, tile)


@functools.lru_cache(maxsize=64)
def _pad_index(n: int, total: int, reflect: bool) -> np.ndarray:
    """Source index of each of `total` positions of a dimension of `n`
    padded at its end: np.pad's "reflect" (the edge not repeated) or
    "edge"."""
    idx = np.arange(total)
    tail = idx >= n
    idx[tail] = 2 * (n - 1) - idx[tail] if reflect else n - 1
    return idx


def pad_to_multiple(image: torch.Tensor, multiple: int = 32,
                    min_size: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Pad (H, W) or (H, W, C) at the bottom and right so H and W are
    multiples of `multiple` and at least min_size; returns (padded,
    original (h, w)). Reflect padding, or edge padding where a pad is not
    smaller than its dimension (np.pad's reflect needs that), as the JAX
    function pads with np.pad."""
    h, w = image.shape[:2]
    th = max(-(-h // multiple) * multiple, min_size or 0)
    tw = max(-(-w // multiple) * multiple, min_size or 0)
    if th == h and tw == w:
        return image, (h, w)
    reflect = th - h < h and tw - w < w
    iy = torch.as_tensor(_pad_index(h, th, reflect), device=image.device)
    ix = torch.as_tensor(_pad_index(w, tw, reflect), device=image.device)
    return image.index_select(0, iy).index_select(1, ix), (h, w)
