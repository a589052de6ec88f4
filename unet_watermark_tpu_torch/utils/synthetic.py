"""Synthetic watermarked images, made with numpy from a seed (no PIL/cv2).

Each image is a smooth colour gradient with mild noise, with a
semi-transparent logo blended over it: a thin ring with a bar through it,
white or black, of 12-40 px radius (a watermark's size, whatever the image
size) at a random place. The last `clean` images carry no logo, as a
folder of user images holds some that have none. Used by chip_smoke.py and
the tests.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def watermarked_images(n: int, size: int, seed: int = 0, clean: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(images (n, size, size, 3) float32 in [0, 1], logo masks (n, size,
    size) float32 {0, 1}). The first n - clean images are those of
    clean = 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    images = np.empty((n, size, size, 3), np.float32)
    logos = np.empty((n, size, size), np.float32)
    for i in range(n):
        c0, c1, c2 = rng.random((3, 3)).astype(np.float32)
        base = (c0 + (c1 - c0) * yy[..., None] + (c2 - c0) * xx[..., None]) / 2
        base += rng.normal(0, 0.02, base.shape).astype(np.float32)
        r = rng.uniform(12, min(40, size / 3))
        cy, cx = rng.uniform(r + 2, size - r - 2, 2)
        d = np.hypot(yy * size - cy, xx * size - cx)
        ring = np.abs(d - 0.8 * r) < 0.15 * r
        bar = (np.abs(yy * size - cy) < 0.12 * r) & (d < r)
        logo = (ring | bar) & (i < n - clean)
        ink = np.float32(rng.integers(0, 2))
        alpha = np.float32(rng.uniform(0.45, 0.7))
        img = np.where(logo[..., None], (1 - alpha) * base + alpha * ink, base)
        images[i] = np.clip(img, 0.0, 1.0)
        logos[i] = logo
    return images, logos
