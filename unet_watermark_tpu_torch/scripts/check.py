"""The dataset triad validator (scripts/check.py in the JAX package):
cross-checks ROOT/{watermarked,clean,masks}, finds black masks (under 1 %
nonzero), fragmented masks (more than `fragment_limit` components),
missing, orphaned and corrupted files, and detects, deletes or moves the
affected triads.

Reads go through utils/image_io (a watermarked image decoded as
cv2.imread decodes it, on `device`; a mask as IMREAD_GRAYSCALE); a file
that cv2.imread cannot read counts as corrupted. The black-mask share runs
on the device, the component count on the host (utils/native.py, the C
two-pass union-find).

CLI (on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.scripts.check --root D \\
        [--mode detect|delete|move] [--quarantine Q]
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
from typing import Dict, List, Optional

import torch

from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif", ".webp"}


def _read_mask(mask_path: str, device) -> Optional[torch.Tensor]:
    try:
        return image_io.read_gray_tensor(mask_path, device)
    except image_io.UNREADABLE:
        return None


def is_black_mask(mask_path: str, threshold: float = 0.01,
                  device="cuda") -> bool:
    """A mask with under `threshold` of its pixels nonzero (or unreadable)
    is black."""
    mask = _read_mask(mask_path, resolve_device(device))
    if mask is None:
        return True
    return float((mask > 0).double().mean()) < threshold


def _stems(folder: str) -> Dict[str, str]:
    out = {}
    if not os.path.isdir(folder):
        return out
    for f in sorted(os.listdir(folder)):
        stem, ext = os.path.splitext(f)
        if ext.lower() in IMAGE_EXTS:
            out[stem] = os.path.join(folder, f)
    return out


def _mask_component_count(mask_path: str, device="cuda") -> Optional[int]:
    """The mask's 8-connected components (background excluded) through
    utils/native.py, or None where the mask is unreadable."""
    from ..utils import native

    mask = _read_mask(mask_path, resolve_device(device))
    if mask is None:
        return None
    num, _labels, _stats = native.connected_components_with_stats(
        mask.cpu().numpy(), 8)
    return max(int(num) - 1, 0)


def _readable(path: str, device) -> bool:
    try:
        image_io.read_rgb_tensor(path, device)
    except image_io.UNREADABLE:
        return False
    return True


def validate_dataset(root: str, mode: str = "detect",
                     quarantine_dir: Optional[str] = None,
                     black_threshold: float = 0.01,
                     fragment_limit: int = 64, device="cuda") -> Dict:
    """The JAX package's summary dict; mode detect | delete | move."""
    dev = resolve_device(device)
    wm = _stems(os.path.join(root, "watermarked"))
    cl = _stems(os.path.join(root, "clean"))
    mk = _stems(os.path.join(root, "masks"))

    problems: Dict[str, List[str]] = {
        "missing_clean": [], "missing_mask": [], "black_mask": [],
        "fragmented_mask": [],
        "orphan_clean": [], "orphan_mask": [], "corrupted": []}
    component_counts: List[int] = []

    for stem, path in wm.items():
        if not _readable(path, dev):
            problems["corrupted"].append(path)
            continue
        if cl and stem not in cl:
            problems["missing_clean"].append(path)
        if stem not in mk:
            problems["missing_mask"].append(path)
        elif is_black_mask(mk[stem], black_threshold, dev):
            problems["black_mask"].append(mk[stem])
        else:
            n_comp = _mask_component_count(mk[stem], dev)
            if n_comp is not None:
                component_counts.append(n_comp)
                if n_comp > fragment_limit:
                    problems["fragmented_mask"].append(mk[stem])
    for stem, path in cl.items():
        if stem not in wm:
            problems["orphan_clean"].append(path)
    for stem, path in mk.items():
        if stem not in wm:
            problems["orphan_mask"].append(path)

    affected = set()
    for key in ("black_mask", "corrupted", "missing_mask"):
        for p in problems[key]:
            affected.add(os.path.splitext(os.path.basename(p))[0]
                         .removesuffix("_mask"))

    removed = []
    if mode in ("delete", "move"):
        if mode == "move":
            quarantine_dir = quarantine_dir or os.path.join(root,
                                                            "quarantine")
            os.makedirs(quarantine_dir, exist_ok=True)
        for stem in affected:
            for d in (wm, cl, mk):
                if stem in d and os.path.exists(d[stem]):
                    if mode == "delete":
                        os.remove(d[stem])
                    else:
                        shutil.move(d[stem], os.path.join(
                            quarantine_dir, os.path.basename(d[stem])))
                    removed.append(d[stem])

    summary = {
        "total_watermarked": len(wm),
        "total_clean": len(cl),
        "total_masks": len(mk),
        "problems": {k: len(v) for k, v in problems.items()},
        "problem_files": problems,
        "affected_triads": len(affected),
        "handled": removed,
        "mode": mode,
        "mask_stats": {
            "analyzed": len(component_counts),
            "avg_components": (sum(component_counts) / len(component_counts))
            if component_counts else 0.0,
            "max_components": max(component_counts, default=0),
            "fragment_limit": fragment_limit,
        },
    }
    logger.info("validate: %d watermarked, problems=%s", len(wm),
                summary["problems"])
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="dataset triad validator")
    p.add_argument("--root", required=True)
    p.add_argument("--mode", choices=["detect", "delete", "move"],
                   default="detect")
    p.add_argument("--quarantine", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    s = validate_dataset(args.root, args.mode, args.quarantine,
                         device=args.device)
    print({k: v for k, v in s.items() if k != "problem_files"})
    return s


if __name__ == "__main__":
    main()
