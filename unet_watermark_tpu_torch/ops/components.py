"""Connected components on the device (ops/components.py in the JAX
package), in plain PyTorch; there is no TPU kernel here.

Labels are the linear pixel index + 1 of the component's least pixel, 0 for
background. Every function takes (H, W) or a batch (N, H, W) and treats each
image on its own: a batch iterates until every image is at its fixpoint,
and a further round leaves an image at its fixpoint unchanged, so the
labels equal those of one image at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _neighbor_min(labels: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Min positive label over the 3x3 (8-conn) or cross (4-conn) window;
    background stays 0. labels: (N, H, W) int64, exact at any size: the
    min is taken over shifted views, with a sentinel above every label
    beyond the border and on background."""
    h, w = labels.shape[-2:]
    big = h * w + 1
    x = F.pad(torch.where(labels > 0, labels, big), (1, 1, 1, 1), value=big)
    row = torch.minimum(torch.minimum(x[:, :, :-2], x[:, :, 1:-1]),
                        x[:, :, 2:])  # (N, H+2, W): min over dx
    if connectivity == 8:
        y = torch.minimum(torch.minimum(row[:, :-2], row[:, 1:-1]), row[:, 2:])
    else:
        y = torch.minimum(torch.minimum(row[:, 1:-1], x[:, :-2, 1:-1]),
                          x[:, 2:, 1:-1])
    return torch.where(labels > 0, y, 0)


def _pointer_jump(labels: torch.Tensor, hops: int) -> torch.Tensor:
    """label <- label[label - 1], `hops` times, within each image."""
    n = labels.shape[0]
    flat = labels.reshape(n, -1)
    for _ in range(hops):
        parent = torch.where(flat > 0, flat - 1, 0)
        flat = torch.where(flat > 0, torch.gather(flat, 1, parent), 0)
    return flat.reshape(labels.shape)


def _batched(mask: torch.Tensor):
    if mask.ndim == 2:
        return mask[None], lambda y: y[0]
    if mask.ndim == 3:
        return mask, lambda y: y
    raise ValueError(f"expected (H, W) or (N, H, W), got {tuple(mask.shape)}")


def label_components(mask: torch.Tensor, connectivity: int = 8,
                     jump_hops: int = 2, max_rounds: int = 0) -> torch.Tensor:
    """Neighbour-min then `jump_hops` pointer jumps, to a fixpoint (or
    max_rounds, default H*W). int64 labels of mask's shape."""
    m, unbatch = _batched(mask)
    h, w = m.shape[-2:]
    max_rounds = max_rounds if max_rounds > 0 else h * w
    idx = torch.arange(1, h * w + 1, device=m.device).reshape(h, w)
    labels = torch.where(m > 0.5, idx, 0)
    for _ in range(max_rounds):
        nl = _pointer_jump(_neighbor_min(labels, connectivity), jump_hops)
        if torch.equal(nl, labels):
            break
        labels = nl
    return unbatch(labels)


def _segment_areas(labels: torch.Tensor) -> torch.Tensor:
    """(N, H*W+1) pixel count of each label id; slot 0 (background) is 0."""
    n = labels.shape[0]
    size = labels[0].numel() + 1
    flat = labels.reshape(n, -1)
    offs = torch.arange(n, device=labels.device)[:, None] * size
    counts = torch.bincount((flat + offs).reshape(-1),
                            minlength=n * size)
    counts = counts.reshape(n, size)
    counts[:, 0] = 0
    return counts


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """Per pixel, the area of its component; 0 on background."""
    lab, unbatch = _batched(labels)
    areas = _segment_areas(lab)
    flat = lab.reshape(lab.shape[0], -1)
    per_pixel = torch.gather(areas, 1, flat).reshape(lab.shape)
    return unbatch(torch.where(lab > 0, per_pixel, 0))


def keep_largest_component(mask: torch.Tensor, connectivity: int = 8,
                           min_keep_area: int = 500,
                           fallback_min_area: int = 200) -> torch.Tensor:
    """Keep the largest component (the first label id on a tie, as
    jnp.argmax); but where it is smaller than min_keep_area, keep every
    component larger than fallback_min_area instead."""
    m, unbatch = _batched(mask)
    labels = label_components(m, connectivity)
    areas = _segment_areas(labels)
    flat = labels.reshape(labels.shape[0], -1)
    area = torch.where(flat > 0, torch.gather(areas, 1, flat), 0)
    largest = torch.argmax(areas, dim=1, keepdim=True)
    is_largest = (flat == largest) & (flat > 0)
    small = areas.max(dim=1, keepdim=True).values < min_keep_area
    out = torch.where(small, area > fallback_min_area, is_largest)
    return unbatch(out.reshape(labels.shape).float())


def filter_components_by_area(mask: torch.Tensor, min_area: int,
                              connectivity: int = 8) -> torch.Tensor:
    """Keep components with area > min_area."""
    labels = label_components(mask, connectivity)
    return (component_areas(labels) > min_area).float()


def component_stats(labels: torch.Tensor) -> dict:
    """Per-label stats over linear-index labels: "area", "width", "height",
    the bounding box's left column "x0" and top row "y0" (int64) and
    "exists" (bool), each (H*W+1,) for (H, W) labels or (N, H*W+1) for a
    batch, indexed by label id; slot 0 is background (0 where no label)."""
    lab, unbatch = _batched(labels)
    n, h, w = lab.shape
    size = h * w + 1
    flat = lab.reshape(n, -1)
    fg = flat > 0
    ys = torch.arange(h, device=lab.device).repeat_interleave(w)
    xs = torch.arange(w, device=lab.device).repeat(h)

    def reduce(values, how, fill):
        out = torch.full((n, size), fill, dtype=torch.int64,
                         device=lab.device)
        vals = torch.where(fg, values.expand(n, -1), fill)
        return out.scatter_reduce_(1, flat, vals, how, include_self=True)

    big = h * w + 1
    area = _segment_areas(lab)
    exists = area > 0
    x0, y0 = reduce(xs, "amin", big), reduce(ys, "amin", big)
    width = reduce(xs, "amax", -1) - x0 + 1
    height = reduce(ys, "amax", -1) - y0 + 1
    stats = {"area": area, "width": width, "height": height, "x0": x0,
             "y0": y0}
    stats = {k: torch.where(exists, v, 0) for k, v in stats.items()}
    stats["exists"] = exists
    return {k: unbatch(v) for k, v in stats.items()}


def count_components(mask: torch.Tensor, connectivity: int = 8
                     ) -> torch.Tensor:
    """Number of components (background excluded), each counted at its
    root pixel, where label == linear index + 1; (N,) for a batch."""
    m, unbatch = _batched(mask)
    labels = label_components(m, connectivity)
    flat = labels.reshape(labels.shape[0], -1)
    idx = torch.arange(1, flat.shape[1] + 1, device=flat.device)
    return unbatch((flat == idx).sum(dim=1))
