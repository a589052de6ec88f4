"""Mask enhancement (scripts/enhance_masks.py in the JAX package):
enhance_mask widens a thin mask (dilate with an ellipse, Gaussian blur,
re-threshold) on the device through ops/morphology, as JAX jits the same
chain; yolo_to_mask rasterizes YOLO boxes (cv2.rectangle filled, through
ops/imgproc.fill_rect) on the host; enhance_folder reads each mask as
cv2.IMREAD_GRAYSCALE and writes what cv2.imwrite writes for its extension
(PNG, baseline gray JPEG at quality 95, or an 8-bit palette BMP:
utils/image_io.write_image).

CLI (on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.scripts.enhance_masks \\
        --input MASKS --output OUT [--dilate-size 5] [--iterations 2]
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import imgproc
from ..ops import morphology as m
from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


def enhance_mask(mask, dilate_size: int = 5, dilate_iterations: int = 2,
                 blur_size: int = 5, blur_sigma: float = 2.0,
                 rethreshold: float = 0.25, device="cuda") -> np.ndarray:
    """(H, W) uint8 mask (numpy or a tensor) → (H, W) uint8 {0, 255}:
    > 127, dilate, blur with an odd (blur_size | 1) kernel, > rethreshold,
    on `device`."""
    dev = resolve_device(device)
    x = (torch.as_tensor(mask).to(dev) > 127).float()
    x = m.dilate(x, m.ellipse_kernel(dilate_size, dilate_size),
                 dilate_iterations)
    x = m.gaussian_blur(x, (blur_size | 1, blur_size | 1), blur_sigma)
    x = m.threshold_binary(x, rethreshold)
    return (x * 255).to(torch.uint8).cpu().numpy()


def yolo_to_mask(label_path: str, image_shape: Tuple[int, int],
                 class_filter: Optional[int] = None) -> np.ndarray:
    """YOLO txt (class cx cy w h, normalized) → filled-box binary mask."""
    h, w = image_shape
    mask = np.zeros((h, w), np.uint8)
    if not os.path.exists(label_path):
        return mask
    with open(label_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            cls, cx, cy, bw, bh = (float(v) for v in parts[:5])
            if class_filter is not None and int(cls) != class_filter:
                continue
            x1 = max(int((cx - bw / 2) * w), 0)
            y1 = max(int((cy - bh / 2) * h), 0)
            x2 = min(int((cx + bw / 2) * w), w - 1)
            y2 = min(int((cy + bh / 2) * h), h - 1)
            imgproc.fill_rect(mask, x1, y1, x2 - x1, y2 - y1, 255)
    return mask


def enhance_folder(input_dir: str, output_dir: str, device="cuda",
                   **kwargs) -> int:
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for f in sorted(os.listdir(input_dir)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
            continue
        try:
            mask = image_io.read_gray_tensor(os.path.join(input_dir, f), dev)
        except image_io.UNREADABLE:
            continue
        out = enhance_mask(mask, device=dev, **kwargs)
        image_io.write_image(os.path.join(output_dir, f), out)
        count += 1
    logger.info("enhanced %d masks", count)
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description="mask enhancement")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--dilate-size", type=int, default=5)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return enhance_folder(args.input, args.output, device=args.device,
                          dilate_size=args.dilate_size,
                          dilate_iterations=args.iterations)


if __name__ == "__main__":
    main()
