"""Watermark asset extraction (scripts/extract_watermarks.py in the JAX
package): a clean/watermarked pair's difference mask, its blobs clustered
by DBSCAN (eps = eps_ratio × the image diagonal), and per cluster a
transparent RGBA crop with a contrast boost and a sharpen, written as PNG
for data/gen_data.py to composite.

On the device, as cv2 computes them: the resize of a clean image of
another size (INTER_LINEAR on uint8), absdiff, BGR2GRAY, the binary
threshold, and morphologyEx(MORPH_CLOSE, 3 × 3 ellipse, iterations=2),
which cv2 runs as dilate, dilate, erode, erode (the border left out); the
contrast in float32 then the truncating cast to uint8, and filter2D's
sharpen (ops/imgproc.filter2d_u8). On the host: the blobs' stats
(utils/native.py) and DBSCAN over their centres (ops/cluster.dbscan).

CLI (on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.scripts.extract_watermarks \\
        --watermarked W --clean C --output O [--limit N]
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import cluster, imgproc
from ..ops import morphology as m
from ..ops.resize import resize_linear_u8
from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

SHARPEN = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)
CONTRAST = float(np.float32(1.2))


class WatermarkExtractor:
    def __init__(self, diff_threshold: int = 30, min_contour_area: int = 50,
                 eps_ratio: float = 0.25, min_samples: int = 1,
                 device="cuda"):
        self.diff_threshold = diff_threshold
        self.min_contour_area = min_contour_area
        self.eps_ratio = eps_ratio
        self.min_samples = min_samples
        self.device = resolve_device(device)

    def diff_mask(self, watermarked: torch.Tensor,
                  clean: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 RGB pair → (H, W) uint8 {0, 255} on its device."""
        if watermarked.shape != clean.shape:
            clean = resize_linear_u8(clean, tuple(watermarked.shape[:2]))
        diff = (watermarked.to(torch.int16) - clean.to(torch.int16)).abs()
        gray = imgproc.gray_u8(diff.to(torch.uint8), "rgb")
        mask = torch.where(gray > self.diff_threshold, 255, 0).to(
            torch.uint8)
        k = m.ellipse_kernel(3, 3)
        for _ in range(2):
            mask = imgproc.grey_dilate(mask, k)
        for _ in range(2):
            mask = imgproc.grey_erode(mask, k)
        return mask

    def cluster_regions(self, mask) -> List[Tuple[int, int, int, int]]:
        """Blob centres clustered by DBSCAN; each cluster's bounding box
        (x, y, w, h), in the order of the cluster labels."""
        from ..utils import native

        mask = mask.cpu().numpy() if torch.is_tensor(mask) else mask
        num, _labels, stats = native.connected_components_with_stats(mask, 8)
        centers, boxes = [], []
        for x, y, w, h, area in stats[1:num]:  # row 0 = background
            if area < self.min_contour_area:
                continue
            centers.append([x + w / 2, y + h / 2])
            boxes.append((int(x), int(y), int(w), int(h)))
        if not centers:
            return []
        h_img, w_img = mask.shape
        eps = self.eps_ratio * float(np.hypot(h_img, w_img))
        labels = cluster.dbscan(
            torch.tensor(centers, dtype=torch.float64, device=self.device),
            eps, self.min_samples)
        out = []
        for lbl in sorted(set(labels.tolist())):
            if lbl == -1:
                continue
            group = [boxes[i] for i in range(len(boxes)) if labels[i] == lbl]
            x1 = min(b[0] for b in group)
            y1 = min(b[1] for b in group)
            x2 = max(b[0] + b[2] for b in group)
            y2 = max(b[1] + b[3] for b in group)
            out.append((x1, y1, x2 - x1, y2 - y1))
        return out

    def enhance(self, rgba: torch.Tensor) -> torch.Tensor:
        """Contrast boost (float32, truncated to uint8) and sharpen of the
        RGB channels; alpha kept."""
        rgb = rgba[..., :3].float()
        rgb = torch.clamp((rgb - 127.5) * CONTRAST + 127.5, 0, 255)
        rgb = imgproc.filter2d_u8(rgb.to(torch.uint8), SHARPEN)
        return torch.cat([rgb, rgba[..., 3:]], dim=2)

    def extract_from_pair(self, watermarked_path: str, clean_path: str
                          ) -> List[np.ndarray]:
        """The pair's RGBA assets, (h, w, 4) uint8 each."""
        try:
            wm = image_io.read_rgb_tensor(watermarked_path, self.device)
            cl = image_io.read_rgb_tensor(clean_path, self.device)
        except image_io.UNREADABLE:
            return []
        mask = self.diff_mask(wm, cl)
        assets = []
        for (x, y, w, h) in self.cluster_regions(mask):
            pad = max(2, int(0.05 * max(w, h)))
            x1, y1 = max(x - pad, 0), max(y - pad, 0)
            x2 = min(x + w + pad, wm.shape[1])
            y2 = min(y + h + pad, wm.shape[0])
            rgba = torch.cat([wm[y1:y2, x1:x2], mask[y1:y2, x1:x2, None]],
                             dim=2)
            assets.append(self.enhance(rgba).cpu().numpy())
        return assets

    def batch_extract(self, watermarked_dir: str, clean_dir: str,
                      output_dir: str, limit: Optional[int] = None) -> Dict:
        os.makedirs(output_dir, exist_ok=True)
        files = sorted(f for f in os.listdir(watermarked_dir)
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))
        if limit:
            files = files[:limit]
        count = 0
        pairs = 0
        for f in files:
            cp = os.path.join(clean_dir, f)
            if not os.path.exists(cp):
                continue
            pairs += 1
            assets = self.extract_from_pair(
                os.path.join(watermarked_dir, f), cp)
            stem = os.path.splitext(f)[0]
            for i, a in enumerate(assets):
                image_io.write_png(os.path.join(output_dir,
                                                f"{stem}_wm{i}.png"), a)
                count += 1
        logger.info("extracted %d watermark assets from %d pairs", count,
                    pairs)
        return {"pairs": pairs, "assets": count}


def main(argv=None):
    p = argparse.ArgumentParser(description="extract watermark assets")
    p.add_argument("--watermarked", required=True)
    p.add_argument("--clean", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--limit", type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    ex = WatermarkExtractor(device=args.device)
    out = ex.batch_extract(args.watermarked, args.clean, args.output,
                           args.limit)
    print(out)
    return out


if __name__ == "__main__":
    main()
