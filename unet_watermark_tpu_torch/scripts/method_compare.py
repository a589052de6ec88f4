"""The per-method mask comparison report (scripts/method_compare.py in the
JAX package): five prediction variants of WatermarkPredictor on one image,
each mask saved, a comparison grid, and, given a ground-truth mask, a
metrics table.

  1. standard     predict_mask(type "watermark")
  2. text         text-feature enhancement + the text strategy
  3. mixed        the mixed strategy
  4. multi_scale  MULTI_SCALE_TEST over PREDICT.TEST_SCALES
  5. raw          the threshold alone (POST_PROCESS off)

The scores are ops/metrics.confusion_stats and metrics_from_stats on the
masks as {-1, +1} logits, as JAX's. JAX draws the grid with matplotlib;
the port composes it itself (the card's machine has no matplotlib): the
image and each mask in cells of three columns on white, each under a
title in ops/draw's block font (upper case), written by utils/image_io's
PNG writer. The masks and metrics.txt are JAX's.

CLI (on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.scripts.method_compare \\
        --image img.png --output out/ [--model ckpt] [--gt-mask mask.png]
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

METHODS = ("standard", "text", "mixed", "multi_scale", "raw")
GRID_COLS = 3
TITLE_SCALE = 0.6  # block-font cap height 22 x 0.6 = 13 px
TITLE_H = 24
GAP = 8


def run_methods(predictor, image_path: str) -> Dict[str, np.ndarray]:
    """The five variants; {method: (H, W) uint8 {0, 255} mask}."""
    cfg = predictor.cfg
    out: Dict[str, np.ndarray] = {}
    saved = (cfg.PREDICT.MULTI_SCALE_TEST, cfg.PREDICT.POST_PROCESS)
    try:
        cfg.PREDICT.MULTI_SCALE_TEST = False
        cfg.PREDICT.POST_PROCESS = True
        out["standard"] = predictor.predict_mask(image_path, "watermark")
        out["text"] = predictor.predict_mask(image_path, "text")
        out["mixed"] = predictor.predict_mask(image_path, "mixed")
        cfg.PREDICT.MULTI_SCALE_TEST = True
        out["multi_scale"] = predictor.predict_mask(image_path, "watermark")
        cfg.PREDICT.MULTI_SCALE_TEST = False
        cfg.PREDICT.POST_PROCESS = False
        out["raw"] = predictor.predict_mask(image_path, "watermark")
    finally:
        cfg.PREDICT.MULTI_SCALE_TEST, cfg.PREDICT.POST_PROCESS = saved
    return out


def score_masks(masks: Dict[str, np.ndarray], gt_mask: np.ndarray,
                device="cuda") -> Dict[str, Dict[str, float]]:
    """IoU, F1, precision, recall and coverage of each mask against the
    ground truth (pixels > 127 are the mark), on `device`."""
    from ..ops import metrics as M
    from ..utils.device import resolve_device

    dev = resolve_device(device)

    def binary(mk):
        return torch.from_numpy((np.asarray(mk) > 127).astype(np.float32)
                                ).to(dev)[None, ..., None]

    gt = binary(gt_mask)
    scores = {}
    for name, mk in masks.items():
        pred = binary(mk)
        # confusion_stats takes logits: binary {0, 1} → {-1, +1}
        m = M.metrics_from_stats(M.confusion_stats(pred * 2.0 - 1.0, gt))
        scores[name] = {
            "iou": float(m["iou"]),
            "f1": float(m["f1"]),
            "precision": float(m["precision"]),
            "recall": float(m["recall"]),
            "coverage": float(pred.mean()),
        }
    return scores


def comparison_grid(image: np.ndarray, masks: Dict[str, np.ndarray],
                    scores: Optional[Dict[str, Dict[str, float]]] = None
                    ) -> np.ndarray:
    """(rows, cols) cells on white: the (H, W, 3) uint8 image, then each
    mask as gray, each under its title ("ORIGINAL", the method's name and
    IoU where scored). Returns the (H', W', 3) uint8 grid."""
    from ..ops import draw

    h, w = image.shape[:2]
    cells = [("original", image)]
    for name, mk in masks.items():
        title = name.replace("_", " ")
        if scores and name in scores:
            title += f"  IoU {scores[name]['iou']:.3f}"
        cells.append((title, np.repeat(np.asarray(mk)[..., None], 3, -1)))
    rows = (len(cells) + GRID_COLS - 1) // GRID_COLS
    cell_h, cell_w = TITLE_H + h, w
    grid = torch.full((GAP + rows * (cell_h + GAP),
                       GAP + GRID_COLS * (cell_w + GAP), 3), 255,
                      dtype=torch.uint8)
    for k, (title, px) in enumerate(cells):
        y0 = GAP + (k // GRID_COLS) * (cell_h + GAP)
        x0 = GAP + (k % GRID_COLS) * (cell_w + GAP)
        draw.put_text(grid, title.upper(), (x0, y0 + TITLE_H - 6),
                      TITLE_SCALE, (0, 0, 0), 1)
        grid[y0 + TITLE_H:y0 + cell_h, x0:x0 + cell_w] = torch.from_numpy(
            np.ascontiguousarray(px, dtype=np.uint8))
    return grid.numpy()


def save_report(image_path: str, masks: Dict[str, np.ndarray],
                output_dir: str,
                scores: Optional[Dict[str, Dict[str, float]]] = None) -> str:
    """Write each method's mask, the comparison grid PNG and (with scores)
    metrics.txt; returns the grid's path."""
    from ..utils import image_io

    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(image_path))[0]
    for name, mk in masks.items():
        image_io.write_png(
            os.path.join(output_dir, f"{stem}_{name}_mask.png"),
            np.ascontiguousarray(mk, dtype=np.uint8))
    grid = comparison_grid(image_io.read_rgb(image_path), masks, scores)
    grid_path = os.path.join(output_dir, f"{stem}_method_comparison.png")
    image_io.write_png(grid_path, grid)

    if scores:
        lines = [f"{'method':<12} {'IoU':>7} {'F1':>7} {'prec':>7} "
                 f"{'recall':>7} {'cover':>7}"]
        for name, s in scores.items():
            lines.append(f"{name:<12} {s['iou']:7.4f} {s['f1']:7.4f} "
                         f"{s['precision']:7.4f} {s['recall']:7.4f} "
                         f"{s['coverage']:7.4f}")
        with open(os.path.join(output_dir, f"{stem}_metrics.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        logger.info("\n%s", "\n".join(lines))
    return grid_path


def find_gt_mask(image_path: str) -> Optional[str]:
    """<stem>_mask.png or <stem>.mask.png beside the image, if present."""
    stem = os.path.splitext(image_path)[0]
    for cand in (stem + "_mask.png", stem + ".mask.png"):
        if os.path.exists(cand):
            return cand
    return None


def compare_methods(image_path: str, output_dir: str,
                    model_path: Optional[str] = None,
                    config_path: Optional[str] = None,
                    gt_mask_path: Optional[str] = None,
                    device="cuda", predictor=None) -> Dict:
    """run_methods, score_masks against the ground truth (given, or found
    beside the image; resized by nearest neighbour to the masks' size),
    save_report. `predictor` reuses a WatermarkPredictor; otherwise one is
    made from config_path and model_path on `device`."""
    from ..ops.resize import resize_nearest
    from ..utils import image_io

    if predictor is None:
        from ..configs import get_cfg_defaults, update_config
        from ..inference.predict import WatermarkPredictor

        cfg = get_cfg_defaults()
        if config_path:
            update_config(cfg, config_path)
        predictor = WatermarkPredictor(cfg, weights_path=model_path,
                                       device=device)
    masks = run_methods(predictor, image_path)

    if gt_mask_path is None:
        gt_mask_path = find_gt_mask(image_path)
    scores = None
    if gt_mask_path and os.path.exists(gt_mask_path):
        try:
            gt = image_io.read_gray(gt_mask_path)
        except image_io.UNREADABLE:
            gt = None
        if gt is not None:
            if gt.shape != masks["standard"].shape:
                gt = resize_nearest(torch.from_numpy(gt),
                                    masks["standard"].shape).numpy()
            scores = score_masks(masks, gt, predictor.device)
    grid = save_report(image_path, masks, output_dir, scores)
    return {"masks": dict(masks), "scores": scores, "grid": grid}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(
        description="per-method mask comparison report")
    p.add_argument("--image", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--model", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--gt-mask", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    r = compare_methods(args.image, args.output, args.model, args.config,
                        args.gt_mask, device=args.device)
    print(f"report: {r['grid']}")
    return r


if __name__ == "__main__":
    main()
