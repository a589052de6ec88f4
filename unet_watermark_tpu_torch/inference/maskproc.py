"""Watermark mask optimization (inference/maskproc.py in the JAX package).

optimize_watermark_mask and optimize_watermark_mask_tight are the plain
chains on one (H, W) mask. optimize_watermark_mask_batch is the counterpart
of optimize_watermark_mask_batch_pallas: kernel K1 (the morphology chain),
the largest-component rule on each image, kernel K2 (smooth + threshold),
with the same output as the plain chain.
"""
from __future__ import annotations

import torch

from ..ops import components as cc
from ..ops import morphology as m
from ..ops.kernels.morph_chain import (gaussian_smooth_threshold,
                                       morph_chain_watermark)


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


def optimize_watermark_mask_tight(mask: torch.Tensor) -> torch.Tensor:
    """open(3) → close(5) → dilate(3) → keep components of area > 64 →
    Gaussian re-threshold (PREDICT.MASK_MODE "tight")."""
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


def optimize_watermark_mask_batch(masks: torch.Tensor) -> torch.Tensor:
    """(N, S, S) binary masks → the parity chain of each, through K1 →
    keep_largest_component per image → K2."""
    x = morph_chain_watermark(masks.float().contiguous())
    x = cc.keep_largest_component(x, min_keep_area=500, fallback_min_area=200)
    return gaussian_smooth_threshold(x.contiguous())
