"""The text-watermark trainer (text/train_text_watermark.py in the JAX
package): training with the text config (configs/unet_text_watermark.yaml:
UNet++ on efficientnet-b3, AdamW with cosine warm restarts, CombinedLoss,
the text_watermark augmentation policy) on text-heavy synthetic data.

    python -m unet_watermark_tpu_torch.text.train_text_watermark \\
        [--config Y] [--data-root D] [--clean-dir C --samples N]
        [--epochs E] [--resume R] [--output-dir O] [--device cpu]

Every step runs on `device`, "cuda" unless the caller asks for the CPU.
The flags are JAX's; --output-dir (JAX's constructor argument, whose
default the JAX CLI always takes) and --device are the port's.
"""
from __future__ import annotations

import copy
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

TEXT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "unet_text_watermark.yaml")
TEXT_RATIOS = {"text": 0.7, "mixed": 0.3, "logo": 0.0, "multi": 0.0}


class TextWatermarkTrainer:
    """The config (TEXT_CONFIG or `config_path`) with DATA.ROOT_DIR and
    TRAIN.OUTPUT_DIR set, and the data, training and evaluation steps on
    `device`."""

    def __init__(self, config_path: Optional[str] = None,
                 data_root: Optional[str] = None,
                 output_dir: str = "logs/text_watermark_output",
                 device="cuda"):
        from ..configs import get_cfg_defaults, update_config
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.cfg = get_cfg_defaults()
        update_config(self.cfg, config_path or TEXT_CONFIG)
        if data_root:
            self.cfg.DATA.ROOT_DIR = data_root
        self.cfg.TRAIN.OUTPUT_DIR = output_dir

    def generate_training_data(self, clean_dir: str, count: int = 500,
                               seed: int = 42) -> Dict:
        """Text-heavy synthetic data (text 0.7 / mixed 0.3) under
        DATA.ROOT_DIR, by data/gen_data.generate_dataset."""
        from ..data.gen_data import generate_dataset

        return generate_dataset(clean_dir, self.cfg.DATA.ROOT_DIR,
                                logos_dir=None, count=count,
                                ratios=dict(TEXT_RATIOS), seed=seed,
                                device=self.device)

    def train(self, resume_from: Optional[str] = None,
              epochs: Optional[int] = None,
              max_steps_per_epoch: Optional[int] = None) -> Dict:
        """training.train on a copy of the config (TRAIN.EPOCHS from
        `epochs` where given)."""
        from ..training.train import train

        cfg = copy.deepcopy(self.cfg)
        if epochs is not None:
            cfg.TRAIN.EPOCHS = epochs
        return train(cfg, resume_from=resume_from,
                     max_steps_per_epoch=max_steps_per_epoch,
                     device=self.device)

    def evaluate_methods(self, image_path: str, output_dir: str,
                         model_path: Optional[str] = None) -> Dict:
        """The watermark, text and mixed masks of one image
        (WatermarkPredictor.predict_mask with the weights at model_path),
        each written as mask_<method>.png with its coverage and its number
        of 8-connected components (cv2.connectedComponents' count less the
        background in JAX), and the image beside the three masks as
        comparison_grid.png. The PNGs hold JAX's pixels in the port's
        encoding (utils/image_io)."""
        from ..inference.predict import WatermarkPredictor
        from ..ops.components import count_components
        from ..ops.resize import resize_linear_u8
        from ..utils import image_io

        os.makedirs(output_dir, exist_ok=True)
        predictor = WatermarkPredictor(self.cfg, weights_path=model_path,
                                       device=self.device)
        results: Dict = {}
        masks = {}
        for method in ("watermark", "text", "mixed"):
            mask = predictor.predict_mask(image_path, mask_type=method)
            p = os.path.join(output_dir, f"mask_{method}.png")
            image_io.write_png(p, mask)
            masks[method] = mask
            results[method] = {
                "mask_path": p,
                "coverage": float((mask > 0).mean()),
                "components": int(count_components(
                    torch.from_numpy(mask > 0))),
            }
        img = torch.from_numpy(image_io.read_rgb(image_path))
        h, w = img.shape[:2]
        row = [img] + [torch.from_numpy(m)[..., None].expand(-1, -1, 3)
                       for m in masks.values()]
        grid = torch.cat([resize_linear_u8(r.contiguous(), (h, w))
                          for r in row], dim=1)
        grid_path = os.path.join(output_dir, "comparison_grid.png")
        image_io.write_png(grid_path, np.ascontiguousarray(grid.numpy()))
        results["grid"] = grid_path
        return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="text watermark trainer")
    p.add_argument("--config", default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--clean-dir", default=None,
                   help="generate text training data from these images")
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--output-dir", default="logs/text_watermark_output")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    trainer = TextWatermarkTrainer(config_path=args.config,
                                   data_root=args.data_root,
                                   output_dir=args.output_dir,
                                   device=args.device)
    if args.clean_dir:
        print(trainer.generate_training_data(args.clean_dir, args.samples))
    result = trainer.train(resume_from=args.resume, epochs=args.epochs)
    print({"best_val_loss": result["best_val_loss"],
           "epochs_run": result["epochs_run"]})
    return result


if __name__ == "__main__":
    main()
