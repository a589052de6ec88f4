"""Type-aware mask optimization and watermark-type detection
(inference/maskproc.py in the JAX package).

The strategies take one (H, W) mask or a batch (N, H, W) and treat each
image on its own: optimize_watermark_mask and optimize_watermark_mask_tight
(the watermark strategy of the parity and tight modes), optimize_text_mask
and optimize_mixed_mask. optimize_watermark_mask_batch is the counterpart of
optimize_watermark_mask_batch_pallas: kernel K1 (the morphology chain), the
largest-component rule on each image, kernel K2 (smooth + threshold), with
the same output as the plain chain. optimize_mask_batch_partitioned runs one
strategy per image, the watermark strategy of parity mode through K1 and K2.
optimize_mask_by_type and optimize_mask_batch_by_type are the public
per-type helpers: one mask and its type code, a batch and its codes.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops import components as cc
from ..ops import morphology as m
from ..ops.kernels.morph_chain import (K1_MAX_SIZE,
                                       gaussian_smooth_threshold,
                                       morph_chain_watermark)

TYPE_CODES = {"watermark": 0, "text": 1, "mixed": 2}


def optimize_watermark_mask(mask: torch.Tensor) -> torch.Tensor:
    """open(3) → close(7)x3 → close(11)x2 → dilate(9)x2 → largest-component
    rule → Gaussian smooth + re-threshold (the reference's cv2 chain)."""
    x = m.morph_open(mask, m.ellipse_kernel(3, 3), 1)
    x = m.morph_close(x, m.ellipse_kernel(7, 7), 3)
    x = m.morph_close(x, m.ellipse_kernel(11, 11), 2)
    x = m.dilate(x, m.ellipse_kernel(9, 9), 2)
    x = cc.keep_largest_component(x, min_keep_area=500, fallback_min_area=200)
    x = m.gaussian_blur(x, (3, 3), 0.5)
    return m.threshold_binary(x, 0.5)


def optimize_text_mask(mask: torch.Tensor) -> torch.Tensor:
    """open(2) → close(3)x2 → the OR of directional closes (5x1, 1x5) →
    dilate(4) → keep components of area > 50."""
    x = m.morph_open(mask, m.ellipse_kernel(2, 2), 1)
    x = m.morph_close(x, m.ellipse_kernel(3, 3), 2)
    x = torch.maximum(m.morph_close(x, m.rect_kernel(5, 1), 1),
                      m.morph_close(x, m.rect_kernel(1, 5), 1))
    x = m.dilate(x, m.ellipse_kernel(4, 4), 1)
    return cc.filter_components_by_area(x, min_area=50)


def optimize_mixed_mask(mask: torch.Tensor) -> torch.Tensor:
    """open(2) → close(5)x2 → dilate(6) → keep components of area > 100."""
    x = m.morph_open(mask, m.ellipse_kernel(2, 2), 1)
    x = m.morph_close(x, m.ellipse_kernel(5, 5), 2)
    x = m.dilate(x, m.ellipse_kernel(6, 6), 1)
    return cc.filter_components_by_area(x, min_area=100)


def optimize_watermark_mask_tight(mask: torch.Tensor) -> torch.Tensor:
    """open(3) → close(5) → dilate(3) → keep components of area > 64 →
    Gaussian re-threshold (PREDICT.MASK_MODE "tight"). A batch runs one
    labelling loop for all its images."""
    x = m.morph_open(mask, m.ellipse_kernel(3, 3), 1)
    x = m.morph_close(x, m.ellipse_kernel(5, 5), 1)
    x = m.dilate(x, m.ellipse_kernel(3, 3), 1)
    x = cc.filter_components_by_area(x, min_area=64)
    x = m.gaussian_blur(x, (3, 3), 0.5)
    return m.threshold_binary(x, 0.5)


def resolve_mask_mode(mode: str, surface: str) -> str:
    """"auto" is the tight chain for the repair mask (surface "repair") and
    the parity chain for mask artifacts; "parity"/"tight" hold for both."""
    if mode not in ("auto", "parity", "tight"):
        raise ValueError(f"unknown PREDICT.MASK_MODE '{mode}'")
    if mode != "auto":
        return mode
    return "tight" if surface == "repair" else "parity"


def optimize_mask(mask: torch.Tensor, mask_type: str = "watermark",
                  mode: str = "parity") -> torch.Tensor:
    """Threshold at 0.5, then the strategy of `mask_type`; mode "tight"
    swaps only the watermark strategy. Plain ops, no kernel."""
    mask = m.threshold_binary(mask, 0.5)
    if mask_type == "text":
        return optimize_text_mask(mask)
    if mask_type == "mixed":
        return optimize_mixed_mask(mask)
    if mode == "tight":
        return optimize_watermark_mask_tight(mask)
    return optimize_watermark_mask(mask)


def optimize_watermark_mask_batch(masks: torch.Tensor) -> torch.Tensor:
    """(N, S, S) binary masks → the parity chain of each, through K1 →
    keep_largest_component per image → K2."""
    x = morph_chain_watermark(masks.float().contiguous())
    x = cc.keep_largest_component(x, min_keep_area=500, fallback_min_area=200)
    return gaussian_smooth_threshold(x.contiguous())


def optimize_mask_batch_partitioned(masks: torch.Tensor,
                                    codes: Sequence[int],
                                    mode: str = "parity") -> torch.Tensor:
    """One strategy per image, by its type code (0 watermark, 1 text,
    2 mixed): the batch is split by code and each strategy runs once on its
    images. Code 0 runs optimize_watermark_mask_batch (K1 → components →
    K2) in parity mode where the masks are square (the plain chain for
    another shape) and the tight chain in tight mode.

    masks: (N, H, W) float on any device; codes: N ints, known on the host.
    Returns float32 (N, H, W) {0, 1} on the masks' device. The JAX function
    pads each group to a power of two, for XLA's compile cache, and returns
    numpy; neither is needed here."""
    masks = m.threshold_binary(masks, 0.5)
    codes = [int(c) for c in codes]
    if len(codes) != masks.shape[0]:
        raise ValueError(f"{len(codes)} codes for {masks.shape[0]} masks")
    strategies = {
        0: (optimize_watermark_mask_tight if mode == "tight"
            else _watermark_strategy),
        1: optimize_text_mask, 2: optimize_mixed_mask}
    if not set(codes) <= set(strategies):
        raise ValueError(f"type codes must be 0, 1 or 2, got {codes}")
    out = torch.empty_like(masks)
    for code in sorted(set(codes)):
        idx = torch.tensor([i for i, c in enumerate(codes) if c == code],
                           device=masks.device)
        out[idx] = strategies[code](masks[idx])
    return out


def _watermark_strategy(masks: torch.Tensor) -> torch.Tensor:
    """The parity watermark chain of (N, H, W) masks: K1 → components → K2
    where the masks are square and within K1's size, the plain chain for
    any other shape (a route by shape; a kernel's error raises)."""
    _, h, w = masks.shape
    if h == w and h <= K1_MAX_SIZE:
        return optimize_watermark_mask_batch(masks)
    return optimize_watermark_mask(masks)


def optimize_mask_by_type(mask: torch.Tensor, type_code) -> torch.Tensor:
    """One (H, W) mask: threshold at 0.5, then the strategy of its type
    code, 0 watermark (the parity chain: K1 → components → K2 as a batch of
    one where the mask is square), 1 text, 2 mixed."""
    return optimize_mask_batch_by_type(mask[None], [type_code])[0]


def optimize_mask_batch_by_type(masks: torch.Tensor, codes) -> torch.Tensor:
    """(N, H, W) masks and N type codes (a sequence, or a tensor on any
    device, read once on the host) → float32 (N, H, W) {0, 1}: each image
    thresholded at 0.5 and optimized by the strategy of its code, code 0
    through K1 and K2 where the masks are square. JAX's function runs all
    three strategies on every image and selects, three times the work, to
    keep one graph; this is optimize_mask_batch_partitioned in parity mode
    (one strategy per image) and gives the same masks."""
    codes = (codes.reshape(-1).tolist() if torch.is_tensor(codes)
             else list(codes))
    return optimize_mask_batch_partitioned(masks, codes, mode="parity")


# ---------------------------------------------------------------------------
# watermark type detection
# ---------------------------------------------------------------------------

def _band(x, lo, hi, outer_lo, outer_hi, value_in, value_out):
    """value_in on [lo, hi], value_out on [outer_lo, lo) and (hi, outer_hi],
    else 0."""
    inner = (x >= lo) & (x <= hi)
    outer = ((x >= outer_lo) & (x < lo)) | ((x > hi) & (x <= outer_hi))
    return torch.where(inner, value_in, torch.where(outer, value_out, 0.0))


def _analyze_text_features(mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W) masks → (N,) geometric text-likeness in [0, 1]: the share
    of components whose aspect, density and area score above 0.5, plus 0.2
    when there are at least 3 and most of them are text-like."""
    stats = cc.component_stats(cc.label_components(mask))
    area = stats["area"].float()
    width = stats["width"].float()
    height = stats["height"].float()
    exists = stats["exists"] & (area > 0) & (width > 0) & (height > 0)
    aspect = torch.where(exists, torch.maximum(width, height) /
                         torch.clamp(torch.minimum(width, height), min=1.0),
                         0.0)
    density = torch.where(exists, area / torch.clamp(width * height, min=1.0),
                          0.0)
    score = torch.zeros_like(area)
    score = score + _band(aspect, 1, 5, 1, 10, 0.3, 0.1)
    score = score + _band(density, 0.3, 0.8, 0.2, 0.9, 0.3, 0.1)
    score = score + _band(area, 50, 5000, 20, 10000, 0.4, 0.2)
    score = torch.where(exists, score, 0.0)

    total = exists.float().sum(dim=1)
    indicators = ((score > 0.5) & exists).float().sum(dim=1)
    ratio = torch.where(total > 0, indicators / torch.clamp(total, min=1.0),
                        0.0)
    bonus = torch.where((total >= 3) & (ratio > 0.5),
                        torch.clamp(ratio + 0.2, max=1.0), ratio)
    return torch.where(mask.sum(dim=(1, 2)) > 0, bonus, 0.0)


def _sobel(gray: torch.Tensor):
    """(N, H, W) float32 → Sobel (gx, gy) as cross-correlations with zero
    padding ("SAME"), in float32 elementwise ops: no convolution, so no
    TF32 whatever the caller's flags."""
    p = torch.nn.functional.pad(gray, (1, 1, 1, 1))
    smooth_y = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]        # (N, H, W+2)
    smooth_x = p[:, :, :-2] + 2.0 * p[:, :, 1:-1] + p[:, :, 2:]  # (N, H+2, W)
    gx = smooth_y[:, :, 2:] - smooth_y[:, :, :-2]
    gy = smooth_x[:, 2:] - smooth_x[:, :-2]
    return gx, gy


def _analyze_gradient_features(gray: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """(N,) gradient score in [0, 1] from the edge density (Sobel magnitude
    > 100 on the masked gray image) and the variance of the gradient angle
    over the mask."""
    gx, gy = _sobel(gray * mask)
    mag = torch.sqrt(gx * gx + gy * gy)
    edges = (mag > 100.0).float()
    mask_px = mask.sum(dim=(1, 2))
    denom = torch.clamp(mask_px, min=1.0)
    edge_density = torch.where(mask_px > 0,
                               (edges * mask).sum(dim=(1, 2)) / denom, 0.0)
    angles = torch.atan2(gy, gx)
    mean = (angles * mask).sum(dim=(1, 2)) / denom
    var = (((angles - mean[:, None, None]) ** 2) * mask).sum(dim=(1, 2)) / denom
    score = (_band(edge_density, 0.1, 0.4, 0.05, 0.6, 0.5, 0.2)
             + _band(var, 1.0, 3.0, 0.5, 4.0, 0.5, 0.2))
    return torch.clamp(score, max=1.0)


def detect_watermark_type_scores(image_rgb: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Text score 0.6 * geometric + 0.4 * gradient of each image; classify
    with classify_type (0.7 / 0.3 cuts).

    image_rgb: (H, W, 3) or (N, H, W, 3) float in [0, 255]; mask: (H, W) or
    (N, H, W) {0, 1}. Returns a scalar, or (N,), float32 tensor."""
    img = image_rgb.float()
    mk = mask.float()
    batched = mk.ndim == 3
    if not batched:
        img, mk = img[None], mk[None]
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    score = (_analyze_text_features(mk) * 0.6
             + _analyze_gradient_features(gray, mk) * 0.4)
    return score if batched else score[0]


def classify_type(score: float) -> str:
    if score > 0.7:
        return "text"
    if score > 0.3:
        return "mixed"
    return "watermark"


def type_code(name: str) -> int:
    return TYPE_CODES[name]
