"""Push-pull inpainting with Jacobi smoothing (ops/inpaint.py in the JAX
package), in plain PyTorch. Images are NHWC float32.

The pull stage builds a masked 2x2-average pyramid; the push stage fills
each level's holes from the next coarser level; Jacobi iterations then
relax the hole pixels toward the mean of their 8 neighbours, the known
pixels held fixed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _sum2x2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))


def _downsample_masked(img, w):
    """2x2 masked average pool; img is premultiplied by w (N,H,W,1)."""
    wsum = _sum2x2(w)
    isum = _sum2x2(img)
    wclip = torch.clamp(wsum, max=1.0)
    return isum / torch.clamp(wsum, min=1e-8) * wclip, wclip


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def push_pull_fill(image: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
    """image (N,H,W,C), hole (N,H,W,1) with 1 = missing; H, W a power of two
    times at least 4 (as the JAX function requires)."""
    valid = 1.0 - hole
    img, wgt = image * valid, valid
    levels = [(img, wgt)]
    while (min(img.shape[1], img.shape[2]) > 2
           and img.shape[1] % 2 == 0 and img.shape[2] % 2 == 0):
        img, wgt = _downsample_masked(img, wgt)
        levels.append((img, wgt))
    coarse_img, coarse_w = levels[-1]
    filled = coarse_img / torch.clamp(coarse_w, min=1e-8)
    for img, wgt in reversed(levels[:-1]):
        up = _upsample2(filled)
        base = img / torch.clamp(wgt, min=1e-8)
        filled = torch.where(wgt > 0.5, base, up)
    return torch.where(hole > 0.5, filled, image)


def jacobi_smooth(image: torch.Tensor, hole: torch.Tensor,
                  iterations: int = 64) -> torch.Tensor:
    """Replace hole pixels by the mean of their 8 neighbours (zero beyond
    the border), `iterations` times."""
    c = image.shape[-1]
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 1.0]],
                     device=image.device) / 8.0
    k = k.expand(c, 1, 3, 3)
    x = image.permute(0, 3, 1, 2)
    in_hole = (hole > 0.5).permute(0, 3, 1, 2)
    for _ in range(iterations):
        x = torch.where(in_hole, F.conv2d(x, k, padding=1, groups=c), x)
    return x.permute(0, 2, 3, 1)


def inpaint_pushpull(image: torch.Tensor, mask: torch.Tensor,
                     smooth_iterations: int = 64) -> torch.Tensor:
    """image (N,H,W,C) in [0,1]; mask (N,H,W,1) or (N,H,W), 1 = remove.
    Pixels outside the mask are returned unchanged."""
    if mask.ndim == 3:
        mask = mask[..., None]
    hole = (mask > 0.5).float()
    out = push_pull_fill(image.float(), hole)
    if smooth_iterations > 0:
        out = jacobi_smooth(out, hole, smooth_iterations)
    return torch.clamp(out, 0.0, 1.0)
