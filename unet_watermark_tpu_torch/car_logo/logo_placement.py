"""Logo placement onto car images (car_logo/logo_placement.py in the JAX
package), to make watermarked / clean / mask training triads.

The draws are JAX's: random.Random(seed) gives the same uniform, randint
and choice values in the same order. On the device, as cv2 and numpy
compute them: the logo's resize (INTER_LINEAR on uint8 RGBA), the
composite (a float32 blend, truncated to uint8; the mask alpha > 10;
every division by a tensor: CUDA divides by a Python number as a product
with its reciprocal, which is not numpy's quotient), and
the template matching (TM_CCOEFF_NORMED over the four scales as a float64
correlation, cv2's normalization and clipping rules, minMaxLoc's first
maximum). Images are RGB here where JAX holds them BGR; every step is per
channel, so the files are the same. batch_process writes what cv2.imwrite
writes: the watermarked and clean images as quality-95 JPEGs, the masks as
PNGs.

Not ported yet (ROADMAP.md §A.8): the feature-matched homography stage
(cv2's SIFT or ORB, the ratio test, RANSAC findHomography and
warpPerspective). detect_features, and warp_and_place_logo given an
anchor, raise NotImplementedError; batch_process never passes an anchor.

CLI (on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.car_logo.logo_placement \\
        --cars C --logos L --output O [--limit N]
"""
from __future__ import annotations

import argparse
import logging
import os
import random
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_linear_u8
from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

FLT_EPSILON = float(np.finfo(np.float32).eps)
HOMOGRAPHY = ("the feature-matched homography stage (SIFT/ORB, RANSAC, "
              "warpPerspective) is not ported yet (ROADMAP.md §A.8)")


def match_template_ccoeff_normed(image: torch.Tensor, templ: torch.Tensor
                                 ) -> torch.Tensor:
    """cv2.matchTemplate(image, templ, TM_CCOEFF_NORMED) of (H, W) and
    (h, w) uint8 → (H - h + 1, W - w + 1) float32: the correlation with the
    zero-mean template over sqrt(window variance × template variance),
    each term a sum; 0 where the window is flat, ±1 where rounding takes
    the ratio past 1 by less than 1/8, and 1 everywhere for a flat
    template (cv2's rules)."""
    img = image.to(torch.float64)
    t = templ.to(torch.float64)
    h, w = t.shape
    area = h * w
    tmean = t.mean()
    tdev = t - tmean
    tnorm = float(torch.sqrt((tdev ** 2).sum()))
    out_shape = (image.shape[0] - h + 1, image.shape[1] - w + 1)
    if tnorm < np.finfo(np.float64).eps * area ** 0.5:  # its std < DBL_EPSILON
        return torch.ones(out_shape, dtype=torch.float32,
                          device=image.device)
    num = F.conv2d(img[None, None], tdev[None, None])[0, 0]
    ones = torch.ones((1, 1, h, w), dtype=torch.float64, device=img.device)
    s1 = F.conv2d(img[None, None], ones)[0, 0]
    s2 = F.conv2d((img ** 2)[None, None], ones)[0, 0]
    wnd_sum2 = s2
    wnd_mean2 = s1 * s1 / area
    diff2 = torch.clamp(wnd_sum2 - wnd_mean2, min=0)
    flat = diff2 <= torch.clamp(10 * FLT_EPSILON * wnd_sum2, max=0.5)
    denom = torch.sqrt(diff2) * tnorm
    ratio = num / torch.where(flat, torch.ones_like(denom), denom)
    sign = torch.where(num > 0, 1.0, -1.0).to(torch.float64)
    res = torch.where(num.abs() < denom, ratio,
                      torch.where(num.abs() < denom * 1.125, sign,
                                  torch.zeros_like(num)))
    return torch.where(flat, torch.zeros_like(res), res).to(torch.float32)


def _max_loc(res: torch.Tensor) -> Tuple[int, int, float]:
    """minMaxLoc's maximum: (x, y, value), the first in raster order."""
    i = int(torch.argmax(res.flatten()))
    return i % res.shape[1], i // res.shape[1], float(res.flatten()[i])


class LogoPlacer:
    def __init__(self, detector: str = "sift", min_matches: int = 10,
                 seed: int = 42, device="cuda"):
        self.min_matches = min_matches
        self.rng = random.Random(seed)
        self.detector = detector
        self.device = resolve_device(device)

    # ---- stage 1: feature-match homography (not ported) ------------------
    def detect_features(self, target_gray, anchor_gray):
        raise NotImplementedError(HOMOGRAPHY)

    # ---- stage 2: template matching --------------------------------------
    def template_matching_fallback(self, target_gray: torch.Tensor,
                                   anchor_gray: torch.Tensor
                                   ) -> Optional[Tuple[int, int, float]]:
        """(x, y, score) of the best of four scales, or None under 0.3."""
        target_gray = torch.as_tensor(target_gray).to(self.device)
        anchor_gray = torch.as_tensor(anchor_gray).to(self.device)
        th, tw = target_gray.shape
        best = None
        for scale in (0.5, 0.75, 1.0, 1.25):
            ah = int(anchor_gray.shape[0] * scale)
            aw = int(anchor_gray.shape[1] * scale)
            if ah < 8 or aw < 8 or ah >= th or aw >= tw:
                continue
            templ = resize_linear_u8(anchor_gray[..., None], (ah, aw))[..., 0]
            x, y, v = _max_loc(match_template_ccoeff_normed(target_gray,
                                                            templ))
            if best is None or v > best[2]:
                best = (x, y, v)
        if best is None or best[2] < 0.3:
            return None
        return best

    # ---- stage 3: random placement ---------------------------------------
    def random_placement_fallback(self, target_shape: Tuple[int, int],
                                  logo_shape: Tuple[int, int]
                                  ) -> Tuple[int, int]:
        th, tw = target_shape
        lh, lw = logo_shape
        # biased toward the central band (the car body)
        x = self.rng.randint(tw // 6, max(tw - lw - tw // 6, tw // 6 + 1))
        y = self.rng.randint(th // 4, max(th - lh - th // 4, th // 4 + 1))
        return x, y

    # ---- compositing ------------------------------------------------------
    @staticmethod
    def _composite(target: torch.Tensor, logo_rgba: torch.Tensor,
                   x: int, y: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(composited (H, W, 3) uint8, (H, W) uint8 {0, 255} mask)."""
        out = target.clone()
        h, w = logo_rgba.shape[:2]
        th, tw = target.shape[:2]
        x2, y2 = min(x + w, tw), min(y + h, th)
        mask = torch.zeros(target.shape[:2], dtype=torch.uint8,
                           device=target.device)
        if x2 <= x or y2 <= y:
            return out, mask
        crop = logo_rgba[: y2 - y, : x2 - x]
        a = crop[..., 3:4].float()
        alpha = a / torch.full_like(a, 255.0)  # IEEE division, as numpy's
        region = out[y:y2, x:x2].float()
        out[y:y2, x:x2] = (crop[..., :3].float() * alpha
                           + region * (1 - alpha)).to(torch.uint8)
        mask[y:y2, x:x2] = (crop[..., 3] > 10).to(torch.uint8) * 255
        return out, mask

    def warp_and_place_logo(self, target_rgb: torch.Tensor,
                            logo_rgba: torch.Tensor,
                            anchor_rgb: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, str]:
        """(composited RGB, mask, method) on the target's device."""
        th, tw = target_rgb.shape[:2]
        scale = self.rng.uniform(0.08, 0.2)
        lw = max(int(tw * scale), 8)
        lh = max(int(logo_rgba.shape[0] * lw / max(logo_rgba.shape[1], 1)),
                 8)
        if anchor_rgb is not None:
            raise NotImplementedError(HOMOGRAPHY)
        logo = resize_linear_u8(logo_rgba, (lh, lw))
        x, y = self.random_placement_fallback((th, tw), (lh, lw))
        out, mask = self._composite(target_rgb, logo, x, y)
        return out, mask, "random"

    def _read_logo(self, path: str) -> Optional[torch.Tensor]:
        """cv2.imread(path, IMREAD_UNCHANGED) of a PNG logo as RGBA: its
        alpha where it has one, else 255."""
        try:
            with open(path, "rb") as f:
                data = f.read()
            if image_io.sniff(data[:16]) == "png":
                rgba = image_io.decode_png_rgba(data)
                return torch.from_numpy(rgba).to(self.device)
            rgb = image_io.read_rgb_tensor(path, self.device)
        except image_io.UNREADABLE:
            return None
        return torch.cat([rgb, torch.full_like(rgb[..., :1], 255)], dim=2)

    # ---- batch ------------------------------------------------------------
    def batch_process(self, cars_dir: str, logos_dir: str, output_root: str,
                      limit: Optional[int] = None) -> Dict:
        wm_dir = os.path.join(output_root, "watermarked")
        cl_dir = os.path.join(output_root, "clean")
        mk_dir = os.path.join(output_root, "masks")
        for d in (wm_dir, cl_dir, mk_dir):
            os.makedirs(d, exist_ok=True)
        cars = sorted(
            os.path.join(cars_dir, f) for f in os.listdir(cars_dir)
            if f.lower().endswith((".jpg", ".jpeg", ".png")))
        logos = sorted(
            os.path.join(logos_dir, f) for f in os.listdir(logos_dir)
            if f.lower().endswith(".png"))
        if limit:
            cars = cars[:limit]
        stats = {"homography": 0, "template": 0, "random": 0, "failed": 0}
        for cp in cars:
            try:
                car = image_io.read_rgb_tensor(cp, self.device)
            except image_io.UNREADABLE:
                car = None
            if car is None or not logos:
                stats["failed"] += 1
                continue
            logo = self._read_logo(self.rng.choice(logos))
            if logo is None:
                stats["failed"] += 1
                continue
            out, mask, method = self.warp_and_place_logo(car, logo)
            stats[method] += 1
            stem = os.path.splitext(os.path.basename(cp))[0]
            image_io.write_image(os.path.join(wm_dir, f"{stem}.jpg"), out)
            image_io.write_image(os.path.join(cl_dir, f"{stem}.jpg"), car)
            image_io.write_image(os.path.join(mk_dir, f"{stem}.png"), mask)
        return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="car logo placement")
    p.add_argument("--cars", required=True)
    p.add_argument("--logos", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--limit", type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    placer = LogoPlacer(device=args.device)
    out = placer.batch_process(args.cars, args.logos, args.output,
                               args.limit)
    print(out)
    return out


if __name__ == "__main__":
    main()
