"""Watermark triage (scripts/watermark_filter.py in the JAX package): the
segmentation model runs over a folder, batched on the device, and the
images WITHOUT a detected watermark (fewer than RATIO_THRESHOLD of the
pixels above PREDICT.THRESHOLD) are moved (or copied) out.

Each image is decoded as cv2.imread decodes it, resized to the model's
size with cv2's INTER_LINEAR on uint8 (ops/resize.resize_linear_u8) and
scaled to [0, 1]; a short last batch is padded with zero images, as JAX
pads it, and the predictor's _forward_probs gives the probabilities.

CLI (on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.scripts.watermark_filter \\
        --model W.npz --input D --clean-output C [--config Y] [--copy]
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
from typing import Dict, List, Optional

import torch

from ..ops.resize import resize_linear_u8
from ..utils import image_io

logger = logging.getLogger(__name__)

RATIO_THRESHOLD = 0.001  # the JAX package's watermark_filter.py


class WatermarkFilter:
    def __init__(self, model_path: Optional[str] = None, config=None,
                 config_path: Optional[str] = None,
                 threshold: float = RATIO_THRESHOLD, device="cuda",
                 predictor=None):
        """`predictor` reuses a WatermarkPredictor; otherwise one is made
        from config (or config_path) and model_path on `device`."""
        self.threshold = threshold
        if predictor is None:
            from ..configs import get_cfg_defaults, update_config
            from ..inference.predict import WatermarkPredictor

            if config is None:
                config = get_cfg_defaults()
                if config_path and os.path.exists(config_path):
                    update_config(config, config_path)
            predictor = WatermarkPredictor(config, weights_path=model_path,
                                           device=device)
        self.predictor = predictor

    def has_watermark(self, image_path: str) -> bool:
        mask = self.predictor.predict_mask(image_path)
        return (mask > 0).mean() >= self.threshold

    @torch.inference_mode()
    def filter_folder(self, input_dir: str, clean_output_dir: str,
                      move: bool = True, limit: Optional[int] = None
                      ) -> Dict:
        os.makedirs(clean_output_dir, exist_ok=True)
        files = sorted(
            os.path.join(input_dir, f) for f in os.listdir(input_dir)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp",
                                   ".webp")))
        if limit:
            files = files[:limit]
        moved: List[str] = []
        kept = 0
        pred = self.predictor
        s = pred.img_size
        bs = pred.cfg.PREDICT.BATCH_SIZE
        dev = pred.device
        self.ratios: Dict[str, float] = {}
        for i in range(0, len(files), bs):
            imgs, ok = [], []
            for p in files[i:i + bs]:
                try:
                    rgb = image_io.read_rgb_tensor(p, dev)
                except image_io.UNREADABLE:
                    continue
                imgs.append(resize_linear_u8(rgb, (s, s)))
                ok.append(p)
            if not ok:
                continue
            batch = torch.zeros((bs, s, s, 3), dtype=torch.float32,
                                device=dev)
            x = torch.stack(imgs).float()
            batch[:len(ok)] = x / torch.full_like(x, 255.0)  # numpy's quotient
            probs = pred._forward_probs(batch)[:len(ok)]
            ratios = (probs > pred.cfg.PREDICT.THRESHOLD).double().mean(
                (1, 2)).tolist()
            for p, ratio in zip(ok, ratios):
                self.ratios[p] = ratio
                if ratio < self.threshold:
                    dest = os.path.join(clean_output_dir,
                                        os.path.basename(p))
                    if move:
                        shutil.move(p, dest)
                    else:
                        shutil.copy2(p, dest)
                    moved.append(dest)
                else:
                    kept += 1
        summary = {"total": len(files), "with_watermark": kept,
                   "clean_moved": len(moved), "moved_files": moved}
        logger.info("filter: %d total, %d watermarked, %d clean moved",
                    len(files), kept, len(moved))
        return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="watermark triage filter")
    p.add_argument("--model", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--input", required=True)
    p.add_argument("--clean-output", required=True)
    p.add_argument("--copy", action="store_true",
                   help="copy instead of move")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    f = WatermarkFilter(model_path=args.model, config_path=args.config,
                        device=args.device)
    s = f.filter_folder(args.input, args.clean_output, move=not args.copy)
    print({k: v for k, v in s.items() if k != "moved_files"})
    return s


if __name__ == "__main__":
    main()
