"""Model selection over many checkpoints (scripts/model_selector.py of the
JAX package): every checkpoint scores the same sampled images, and the one
with the highest detection rate wins.

The checkpoints are the port's training directories (tree.npz and
meta.json, training/checkpoint.py) and .pth files (models/torch_import.py:
the config's model, drawn by init_model, takes the file's tensors by name
and shape, as JAX's selector imports them; an orbax directory raises,
ROADMAP.md §A.7). Checkpoints of one architecture are evaluated in one
forward on `device`: their parameters and buffers are stacked on a leading
axis and
the model runs under torch.func.vmap of torch.func.functional_call, in eval
mode; others run one forward each. The images are read as cv2.imread
reads them and resized to IMG_SIZE by cv2's INTER_LINEAR on uint8
(ops/resize.resize_linear_u8); each probability map goes back to the
image's size by cv2's INTER_LINEAR on float32 (resize_linear_f32). The
per-image metrics (watermark_ratio, components, the largest one's area;
ops/components, 8-connected as cv2.connectedComponentsWithStats), the
mask PNGs and model_evaluation_results.json are JAX's.
"""
from __future__ import annotations

import json
import logging
import os
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import get_cfg_defaults, update_config
from ..models.convert import load_flax_weights
from ..models.factory import (create_model_from_config, init_model,
                              torch_dtype)
from ..models.torch_import import import_pth
from ..ops import components
from ..ops.augment import IMAGENET_MEAN, IMAGENET_STD
from ..ops.resize import resize_linear_f32, resize_linear_u8
from ..training.checkpoint import read_weights
from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

DETECTION_THRESHOLD = 0.001  # watermark_ratio above this counts as detected


def calculate_watermark_metrics(mask: torch.Tensor,
                                image_shape: Tuple[int, int]) -> Dict:
    """Per-mask metrics of an (H, W) uint8 mask: its share of the image,
    its component count and largest component (8-connected)."""
    total = image_shape[0] * image_shape[1]
    fg = mask > 0
    px = int(fg.sum())
    ncomp, max_area = 0, 0
    if px:
        labels = components.label_components(fg.to(torch.float32), 8)
        areas = components.segment_areas(labels[None])[0]
        areas = areas[areas > 0]
        ncomp, max_area = int(areas.numel()), int(areas.max())
    return {
        "watermark_ratio": px / total,
        "watermark_pixels": px,
        "total_pixels": total,
        "num_components": ncomp,
        "max_component_area": max_area,
        "max_component_ratio": max_area / total,
    }


class ModelSelector:
    def __init__(self, models_dir: str, images_dir: str,
                 output_dir: str = "model_evaluation",
                 config_path: Optional[str] = None,
                 config=None, num_images: int = 10, seed: int = 42,
                 device="cuda"):
        self.models_dir = models_dir
        self.images_dir = images_dir
        self.output_dir = output_dir
        self.num_images = num_images
        self.seed = seed
        self.device = resolve_device(device)
        self.cfg = config if config is not None else get_cfg_defaults()
        if config is None and config_path and os.path.exists(config_path):
            update_config(self.cfg, config_path)
        self.vmapped = False  # whether the last evaluation stacked them

    def discover_checkpoints(self) -> List[str]:
        """The .pth files and checkpoint directories (with meta.json) under
        models_dir."""
        found = []
        if not os.path.isdir(self.models_dir):
            return found
        for name in sorted(os.listdir(self.models_dir)):
            p = os.path.join(self.models_dir, name)
            if name.endswith(".pth"):
                found.append(p)
            elif os.path.isdir(p) and os.path.exists(
                    os.path.join(p, "meta.json")):
                found.append(p)
        return found

    def sample_images(self) -> List[str]:
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
        files = sorted(
            os.path.join(self.images_dir, f)
            for f in os.listdir(self.images_dir)
            if f.lower().endswith(exts))
        if len(files) > self.num_images:
            random.Random(self.seed).shuffle(files)
            files = files[: self.num_images]
        return files

    def _load_model(self, path: str) -> torch.nn.Module:
        if path.endswith(".pth"):
            model = init_model(create_model_from_config(self.cfg), seed=0)
            import_pth(path, model)
        else:
            with torch.device("meta"):
                model = create_model_from_config(self.cfg)
            load_flax_weights(model, read_weights(path))
        return model.eval().to(self.device, torch_dtype(self.cfg.MODEL.DTYPE))

    @staticmethod
    def _stackable(models: List[torch.nn.Module]) -> bool:
        if len(models) < 2:
            return False
        ref = [(k, v.shape, v.dtype) for k, v in
               models[0].state_dict().items()]
        return all(type(m) is type(models[0]) and
                   [(k, v.shape, v.dtype) for k, v in
                    m.state_dict().items()] == ref for m in models[1:])

    @torch.inference_mode()
    def forward_all(self, models: List[torch.nn.Module],
                    norm: torch.Tensor, vmap: Optional[bool] = None
                    ) -> torch.Tensor:
        """(M, N, S, S) float32 probabilities of every model on the
        normalized (N, S, S, 3) batch: one vmapped forward when the models
        stack (or vmap=True), else one forward each (vmap=False)."""
        dtype = torch_dtype(self.cfg.MODEL.DTYPE)
        x = norm.to(dtype)
        stack = self._stackable(models) if vmap is None else vmap
        self.vmapped = stack
        if not stack:
            return torch.stack([torch.sigmoid(m(x)[..., 0].float())
                                for m in models])
        params, buffers = torch.func.stack_module_state(models)
        base = models[0]

        def one(p, b):
            return torch.func.functional_call(base, (p, b), (x,))

        logits = torch.func.vmap(one)(params, buffers)
        return torch.sigmoid(logits[..., 0].float())

    def run_evaluation(self) -> Dict:
        os.makedirs(self.output_dir, exist_ok=True)
        checkpoints = self.discover_checkpoints()
        images = self.sample_images()
        if not checkpoints:
            return {"status": "error", "message": "no checkpoints found"}
        if not images:
            return {"status": "error", "message": "no images found"}
        logger.info("evaluating %d checkpoints on %d images",
                    len(checkpoints), len(images))
        t0 = time.time()
        s = self.cfg.DATA.IMG_SIZE
        batch, sizes = [], []
        for p in images:
            img = image_io.read_rgb_tensor(p, self.device)
            sizes.append(tuple(img.shape[:2]))
            batch.append(resize_linear_u8(img, (s, s)))
        x = torch.stack(batch).to(torch.float32) / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        std = torch.tensor(IMAGENET_STD, device=self.device)
        norm = (x - mean) / std

        loaded = []
        for ck in checkpoints:
            try:
                loaded.append((ck, self._load_model(ck)))
            except NotImplementedError:
                raise
            except Exception as e:  # noqa: BLE001
                logger.error("failed to load %s: %s", ck, e)
        if not loaded:
            return {"status": "error", "message": "no loadable checkpoints"}
        probs_all = self.forward_all([m for _, m in loaded], norm)

        threshold = self.cfg.PREDICT.THRESHOLD
        all_results: Dict = {"models": {}}
        for mi, (ck, _) in enumerate(loaded):
            name = os.path.basename(ck)
            predictions = []
            detected = 0
            ratios = []
            for ni, img_path in enumerate(images):
                oh, ow = sizes[ni]
                prob = resize_linear_f32(probs_all[mi, ni], (oh, ow))
                mask = (prob > threshold).to(torch.uint8) * 255
                metrics = calculate_watermark_metrics(mask, (oh, ow))
                ratios.append(metrics["watermark_ratio"])
                if metrics["watermark_ratio"] > DETECTION_THRESHOLD:
                    detected += 1
                mask_file = os.path.join(
                    self.output_dir,
                    f"{os.path.splitext(os.path.basename(img_path))[0]}_"
                    f"{name.replace('.pth', '')}_mask.png")
                image_io.write_png(mask_file, mask.cpu().numpy())
                predictions.append({
                    "image_name": os.path.basename(img_path),
                    "image_path": img_path,
                    "mask_path": mask_file,
                    "metrics": metrics,
                    "success": True,
                    "error": None,
                })
            stats = {
                "detection_rate": detected / len(images),
                "avg_watermark_ratio": float(np.mean(ratios)),
                "max_watermark_ratio": float(np.max(ratios)),
                "evaluated_images": len(images),
            }
            all_results["models"][name] = {
                "model_path": ck,
                "predictions": predictions,
                "statistics": stats,
            }

        successful = list(all_results["models"])
        best = max(successful, key=lambda n: all_results["models"][n]
                   ["statistics"]["detection_rate"])
        all_results["summary"] = {
            "total_models": len(checkpoints),
            "successful_models": len(successful),
            "evaluation_time": time.time() - t0,
            "best_detection_model": {
                "name": best,
                "path": all_results["models"][best]["model_path"],
                "detection_rate": all_results["models"][best]
                ["statistics"]["detection_rate"],
            },
        }
        out_json = os.path.join(self.output_dir,
                                "model_evaluation_results.json")
        with open(out_json, "w") as f:
            json.dump(all_results, f, indent=2)
        logger.info("best model: %s (detection_rate=%.2f%%)", best,
                    all_results["summary"]["best_detection_model"]
                    ["detection_rate"] * 100)
        return all_results

    def get_best_model_path(self) -> Optional[str]:
        results = self.run_evaluation()
        best = results.get("summary", {}).get("best_detection_model")
        return best["path"] if best else None
