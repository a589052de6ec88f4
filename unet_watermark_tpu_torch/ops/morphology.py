"""Binary morphology and Gaussian blur with cv2 semantics
(ops/morphology.py in the JAX package), in plain PyTorch.

Masks are (..., H, W) float32 in {0, 1}. cv2's conventions hold: elliptical
elements come from cv2's rasterization rule, dilate sees 0 beyond the
border and erode sees 1, MORPH_OPEN with n iterations is erode^n then
dilate^n, and GaussianBlur pads reflect-101.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def ellipse_kernel(width: int, height: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (width, height))."""
    c, r = width // 2, height // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((height, width), np.float32)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(c * math.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            kernel[i, max(c - dx, 0):min(c + dx + 1, width)] = 1.0
    return kernel


@functools.lru_cache(maxsize=64)
def rect_kernel(width: int, height: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_RECT, (width, height))."""
    return np.ones((height, width), np.float32)


def get_structuring_element(shape: str, ksize: Tuple[int, int]
                            ) -> np.ndarray:
    """cv2.getStructuringElement for "ellipse", "rect" and "cross", ksize
    (width, height): an (h, w) float32 0/1 array."""
    w, h = ksize
    if shape == "ellipse":
        return ellipse_kernel(w, h)
    if shape == "rect":
        return rect_kernel(w, h)
    if shape == "cross":
        k = np.zeros((h, w), np.float32)
        k[h // 2, :] = 1.0
        k[:, w // 2] = 1.0
        return k
    raise ValueError(f"unknown structuring element shape '{shape}'")


def _as_nchw(x: torch.Tensor):
    if not 2 <= x.ndim <= 4:
        raise ValueError(f"expected 2-4 dims, got {tuple(x.shape)}")
    shape = x.shape
    return x.reshape((-1, 1) + tuple(shape[-2:])), shape


def _correlate(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Cross-correlation with the element, zero outside, anchored like cv2
    at (w//2, h//2). Sums of 0/1 values are exact in float32."""
    kh, kw = kernel.shape
    k = torch.as_tensor(kernel, dtype=torch.float32,
                        device=x.device)[None, None]
    x = F.pad(x, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2))
    return F.conv2d(x, k)


def dilate(mask: torch.Tensor, kernel: np.ndarray,
           iterations: int = 1) -> torch.Tensor:
    """Binary dilation; the border counts as 0."""
    x, shape = _as_nchw(mask)
    x = (x > 0.5).float()
    for _ in range(iterations):
        x = (_correlate(x, kernel) > 0.5).float()
    return x.reshape(shape)


def erode(mask: torch.Tensor, kernel: np.ndarray,
          iterations: int = 1) -> torch.Tensor:
    """Binary erosion; the border counts as 1: NOT dilate(NOT x)."""
    x, shape = _as_nchw(mask)
    x = (x > 0.5).float()
    for _ in range(iterations):
        x = 1.0 - (_correlate(1.0 - x, kernel) > 0.5).float()
    return x.reshape(shape)


def morph_open(mask, kernel, iterations: int = 1):
    """cv2.morphologyEx(MORPH_OPEN, iterations=n) = erode^n → dilate^n."""
    return dilate(erode(mask, kernel, iterations), kernel, iterations)


def morph_close(mask, kernel, iterations: int = 1):
    """cv2.morphologyEx(MORPH_CLOSE, iterations=n) = dilate^n → erode^n."""
    return erode(dilate(mask, kernel, iterations), kernel, iterations)


def morph_gradient(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2 MORPH_GRADIENT of a binary mask, dilate - erode (the border 0
    for the dilation, 1 for the erosion), as float32 {0, 1}: each (H, W)
    plane through ops/imgproc.morph_gradient on uint8."""
    from .imgproc import morph_gradient as grey_gradient

    x, shape = _as_nchw(mask)
    planes = (x[:, 0] > 0.5).to(torch.uint8)
    out = torch.stack([grey_gradient(p, kernel) for p in planes])
    return out.float().reshape(shape)


@functools.lru_cache(maxsize=64)
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel for sigma > 0 (and cv2's sigma rule for <= 0)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: Tuple[int, int], sigma: float,
                  sigma_y: float = None) -> torch.Tensor:
    """cv2.GaussianBlur, BORDER_REFLECT_101, separable: rows then columns."""
    kw, kh = ksize
    sigma_y = sigma if sigma_y is None else sigma_y
    kx = torch.as_tensor(gaussian_kernel_1d(kw, sigma), device=img.device)
    ky = torch.as_tensor(gaussian_kernel_1d(kh, sigma_y), device=img.device)
    x, shape = _as_nchw(img.float())
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="reflect")
    x = F.conv2d(x, ky.reshape(1, 1, kh, 1))
    x = F.conv2d(x, kx.reshape(1, 1, 1, kw))
    return x.reshape(shape)


def threshold_binary(img: torch.Tensor, thresh: float,
                     maxval: float = 1.0) -> torch.Tensor:
    """cv2.threshold(THRESH_BINARY): > thresh → maxval, else 0."""
    return torch.where(img > thresh, maxval, 0.0).to(torch.float32)
