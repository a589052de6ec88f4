"""Inpainting hole quality per engine: PSNR in the holes and whole-image
SSIM (scripts/inpaint_quality.py of the JAX package).

Held-out clean images (training/train_inpaint.load_clean_batches, JAX's
numpy draws) get LaMa-recipe random holes (train_inpaint.random_mask_batch),
each engine (inference/engines.get_engine) fills them on `device` ("cuda"
unless the caller asks for the CPU), and ops/metrics scores the fill
against the clean image. The holes come from a torch.Generator seeded with
seed + 1, where JAX draws them with jax.random.PRNGKey(seed + 1): the
recipe and its ranges are JAX's, the draws are not (ROADMAP.md, stated
differences).

    python -m unet_watermark_tpu_torch.scripts.inpaint_quality \\
        --clean-dir D [--img-size 256] [--limit 32] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from ..inference.engines import get_engine, resolve_inpaint_weights
from ..ops import metrics as metrics_lib
from ..training.train_inpaint import load_clean_batches, random_mask_batch
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


def evaluate_engines(clean_dir: str, engines: List[str],
                     img_size: int = 256, batch_size: int = 8,
                     limit: int = 32, seed: int = 0,
                     weights_path: Optional[str] = None,
                     device="cuda") -> Dict:
    """{engine: {"hole_psnr_db", "ssim", "n_images"}, "weights": the
    resolved LaMa weights}, each score the mean over batches, rounded as
    JAX rounds it."""
    device = resolve_device(device)
    batches = load_clean_batches(clean_dir, batch_size, img_size, seed)
    n_batches = max(1, limit // batch_size)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    data = []
    for _ in range(n_batches):
        images = torch.from_numpy(next(batches)).to(device)
        data.append((images, random_mask_batch(gen, batch_size, img_size,
                                               device)))
    results: Dict = {}
    for name in engines:
        engine = get_engine(name, weights_path=weights_path, device=device)
        psnrs, ssims = [], []
        for images, masks in data:
            out = engine(images, masks)
            psnrs.append(metrics_lib.psnr(out, images, mask=masks))
            ssims.append(metrics_lib.ssim(out, images))
        results[name] = {
            "hole_psnr_db": round(float(np.mean(
                torch.stack(psnrs).tolist())), 2),
            "ssim": round(float(np.mean(torch.stack(ssims).tolist())), 4),
            "n_images": n_batches * batch_size,
        }
        logger.info("%s: hole PSNR %.2f dB, SSIM %.4f", name,
                    results[name]["hole_psnr_db"], results[name]["ssim"])
    results["weights"] = resolve_inpaint_weights(weights_path)
    return results


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description="inpaint hole-quality eval")
    p.add_argument("--clean-dir", required=True)
    p.add_argument("--engines", nargs="+", default=["pushpull", "lama"])
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--limit", type=int, default=32)
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--output", type=str, default=None,
                   help="write results JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    r = evaluate_engines(args.clean_dir, args.engines, args.img_size,
                         args.batch_size, args.limit,
                         weights_path=args.weights, device=args.device)
    print(json.dumps(r, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(r, f, indent=2)


if __name__ == "__main__":
    main()
