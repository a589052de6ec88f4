"""WatermarkPredictor's two batched surfaces (inference/predict.py in the
JAX package): the fused detect→repair path (:931-985) and step 1's device
part, the mask artifacts (:357-440).

The fused fn maps (N, S, S, 3) images in [0, 1] to (repaired, mask):
ImageNet normalize → segmentation model → sigmoid → threshold → mask
optimization → fill → composite. The fill is the learned FFC-LaMa
generator (models/lama.py, bf16, with the shipped weights/lama_ffc.npz)
by default, push-pull when asked or when no LaMa weights resolve. With
PREDICT.MASK_MODE "parity"
the repair mask goes through the mask-stage kernels
(maskproc.optimize_watermark_mask_batch); with "tight" (and "auto", which
resolves to tight for repair) through the plain tight chain, once for the
batch, which has no kernel in either package.

predict_artifact_masks gives step 1's masks: the raw masks, each image's
watermark type from detect_watermark_type_scores, and one strategy per
image (maskproc.optimize_mask_batch_partitioned); under "auto" the
watermark strategy is the parity chain, through K1 and K2.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import torch

from ..configs import Config, get_cfg_defaults
from ..models import create_model_from_config
from ..models.convert import load_flax_weights
from ..models.factory import torch_dtype
from ..ops.inpaint import inpaint_pushpull
from ..utils.shipping import load_npz, resolve
from . import engines, maskproc

logger = logging.getLogger(__name__)

# ops/augment.py in the JAX package
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resolve_device(device: str) -> torch.device:
    """The caller's device; "cuda" without a card raises rather than moving
    the work to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class WatermarkPredictor:
    """Holds the segmentation model on `device` with the shipped (or given)
    .npz weights. A float32 model on the card follows the process's TF32
    settings (`torch.backends.cudnn.allow_tf32`, default on); the caller
    chooses them, as chip_smoke.py does."""

    def __init__(self, cfg: Optional[Config] = None,
                 weights_path: Optional[str] = None, device: str = "cuda"):
        self.cfg = cfg if cfg is not None else get_cfg_defaults()
        self.device = resolve_device(device)
        self.dtype = torch_dtype(self.cfg.MODEL.DTYPE)
        model = create_model_from_config(self.cfg)
        path = resolve("seg", cfg=self.cfg, explicit=weights_path)
        if path is None:
            raise FileNotFoundError(
                f"no segmentation weights for {self.cfg.MODEL.NAME}/"
                f"{self.cfg.MODEL.ENCODER_NAME}; pass weights_path or set "
                f"PREDICT_SEG_WEIGHTS")
        self.weights_path = str(path)
        self.n_weights = load_flax_weights(model, load_npz(path))
        model = model.eval().to(self.device, self.dtype)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)

    @torch.inference_mode()
    def predict_masks(self, images_01: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 3) [0, 1] → (N, S, S) float32 {0, 1} raw masks."""
        norm = (images_01 - self._mean) / self._std
        logits = self.model(norm)
        probs = torch.sigmoid(logits[..., 0])
        return (probs > self.cfg.PREDICT.THRESHOLD).float()

    @torch.inference_mode()
    def predict_artifact_masks(self, images_01: torch.Tensor
                               ) -> Tuple[torch.Tensor, List[str]]:
        """(N, S, S, 3) [0, 1] → (optimized masks (N, S, S) float32 {0, 1},
        each image's type name). Type detection sees the images as 8-bit
        RGB values, as step 1 gives it the decoded image."""
        images = torch.as_tensor(images_01, dtype=torch.float32,
                                 device=self.device)
        masks = self.predict_masks(images)
        scores = maskproc.detect_watermark_type_scores(
            torch.round(images * 255.0), masks)
        types = [maskproc.classify_type(x) for x in scores.tolist()]
        mode = maskproc.resolve_mask_mode(self.cfg.PREDICT.MASK_MODE,
                                          "artifact")
        opt = maskproc.optimize_mask_batch_partitioned(
            masks, [maskproc.type_code(t) for t in types], mode=mode)
        return opt, types

    def make_fused_repair_fn(self, inpaint_engine: str = "lama",
                             smooth_iterations: int = 32):
        """The fused detect→repair callable; `.engine_used` names the fill.

        With inpaint_engine in {lama, big-lama, mat} and weights that
        resolve (engines.resolve_inpaint_weights), the fill is the FFC
        generator, built once here on this predictor's device in bf16
        (whatever MODEL.DTYPE says, as the JAX fn); otherwise, as for every
        other name, push-pull with `smooth_iterations` Jacobi sweeps."""
        lama = None
        engine_used = "pushpull"
        if inpaint_engine in ("lama", "big-lama", "mat"):
            wp = engines.resolve_inpaint_weights(cfg=self.cfg)
            if wp and os.path.exists(wp):
                lama, cand = engines.load_lama(wp, inpaint_engine,
                                               self.device, torch.bfloat16)
                if lama is not None:
                    engine_used = f"ffc-{cand}"
            if lama is None:
                logger.warning("fused repair: no trained weights for '%s' "
                               "— using pushpull fill", inpaint_engine)
        mode = maskproc.resolve_mask_mode(self.cfg.PREDICT.MASK_MODE,
                                          "repair")

        @torch.inference_mode()
        def fused(images_01):
            images = torch.as_tensor(images_01, dtype=torch.float32,
                                     device=self.device)
            masks = self.predict_masks(images)
            if mode == "parity":
                opt = maskproc.optimize_watermark_mask_batch(masks)
            else:
                opt = maskproc.optimize_watermark_mask_tight(masks)
            if lama is not None:
                return lama(images, opt[..., None]), opt
            repaired = inpaint_pushpull(images, opt[..., None],
                                        smooth_iterations=smooth_iterations)
            return repaired, opt

        fused.engine_used = engine_used
        fused.mask_mode = mode
        return fused
