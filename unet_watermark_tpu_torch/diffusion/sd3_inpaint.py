"""The SD3 inpainting shell (diffusion/sd3_inpaint.py of the JAX package):
the guard rails, the text-region detector and the fallback ladder around a
Stable Diffusion 3 inpainting pipe.

The ladder: the diffusers pipe (the first rung) when diffusers is installed
and its weights load; else the native latent-diffusion engine
(diffusion/latent_diffusion.diffusion_inpaint_bgr, with this remover's
steps) when its weights resolve; else push-pull on the image padded to a
multiple of 32. diffusers is probed with importlib.util.find_spec and only
imported inside _load_pipe when the probe finds it; without diffusers or
the hosted weights the first rung returns None, as JAX's does.

Images are numpy BGR uint8, as JAX's cv2 arrays; the pixel work runs as
torch ops on `device` ("cuda" unless the caller asks for the CPU).
detect_text_regions is JAX's cv2 chain on ops/imgproc.py and
ops/components.py (equal masks): gray, 3x3 elliptic MORPH_GRADIENT, Otsu,
9x3 rectangular close, 8-connected components, then the area, region-ratio
and aspect guards and the max_mask_ratio clear. Files are read and written
through utils/image_io.py (PNG, and JPEG at quality 95, by extension);
process_folder refuses a folder holding a form the port cannot decode yet
(an animated WEBP, a BigTIFF, ROADMAP.md §A.5) before it writes anything;
still WEBP files decode.
"""
from __future__ import annotations

import importlib.util
import logging
import os
import random
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import components as cc
from ..ops import imgproc
from ..ops.morphology import get_structuring_element
from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_MODEL = "stabilityai/stable-diffusion-3-medium-diffusers"
IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".webp")


def diffusers_available() -> bool:
    """Whether diffusers is installed; it is not imported to find out."""
    return importlib.util.find_spec("diffusers") is not None


def read_bgr(path: str, device="cuda") -> Optional[np.ndarray]:
    """cv2.imread(path): BGR uint8 (decoded on `device`), or None where
    cv2 would return None."""
    try:
        rgb = image_io.read_rgb_tensor(path, resolve_device(device))
    except image_io.UNREADABLE:
        return None
    return np.ascontiguousarray(rgb.cpu().numpy()[..., ::-1])


def write_bgr(path: str, img: np.ndarray, device="cuda") -> None:
    """cv2.imwrite(path, img) for .png and .jpg/.jpeg (quality 95, the
    JPEG's pixel stage on `device`): the pixels cv2 writes, not its bytes."""
    rgb = np.ascontiguousarray(img[..., ::-1])
    if path.lower().endswith((".jpg", ".jpeg")):
        image_io.write_jpeg(path, torch.from_numpy(rgb).to(
            resolve_device(device)))
    else:
        image_io.write_png(path, rgb)


def pushpull_bgr(image_bgr: np.ndarray, mask: np.ndarray,
                 device: torch.device) -> np.ndarray:
    """The last rung: push-pull on the image padded to a multiple of 32,
    holes where mask > 127, cropped back and truncated to uint8."""
    from ..inference.engines import get_engine
    from ..inference.tiled import pad_to_multiple

    rgb = torch.from_numpy(np.ascontiguousarray(image_bgr[..., ::-1])).to(
        device).float() / 255.0
    padded, (h, w) = pad_to_multiple(rgb, 32)
    hole = torch.from_numpy(np.ascontiguousarray(mask > 127)).to(
        device).float()
    pmask, _ = pad_to_multiple(hole, 32)
    out = get_engine("pushpull", device=device)(padded[None],
                                                pmask[None, ..., None])
    out = (torch.clamp(out[0, :h, :w], 0, 1) * 255).to(torch.uint8)
    return np.ascontiguousarray(out.cpu().numpy()[..., ::-1])


class SDWatermarkRemover:
    """sd3/inpaint.py's remover: guard rails 0.25 of the image overall,
    0.08 per region, regions of 200 px or more, aspect 0.5-20."""

    def __init__(self, model_name: str = DEFAULT_MODEL,
                 steps: int = 25, guidance_scale: float = 6.0,
                 strength: float = 0.6,
                 max_mask_ratio: float = 0.25,
                 max_region_ratio: float = 0.08,
                 min_region_area: int = 200,
                 prompt: str = "clean background, high quality photo",
                 negative_prompt: str = "watermark, text, logo, blurry",
                 device="cuda"):
        self.model_name = model_name
        self.steps = steps
        self.guidance_scale = guidance_scale
        self.strength = strength
        self.max_mask_ratio = max_mask_ratio
        self.max_region_ratio = max_region_ratio
        self.min_region_area = min_region_area
        self.prompt = prompt
        self.negative_prompt = negative_prompt
        self.device = resolve_device(device)
        self._pipe = None
        self.rung: Optional[str] = None  # the rung the last repair ran

    def _load_pipe(self):
        """The diffusers pipe, or None when diffusers is absent or its
        weights do not load."""
        if self._pipe is not None:
            return self._pipe
        if not diffusers_available():
            return None
        try:
            from diffusers import StableDiffusion3InpaintPipeline

            self._pipe = StableDiffusion3InpaintPipeline.from_pretrained(
                self.model_name, torch_dtype=torch.float32)
            self._pipe.enable_attention_slicing()
            return self._pipe
        except Exception as e:  # noqa: BLE001 - None is the next rung
            logger.warning("SD3 pipeline unavailable (%s); using fast "
                           "inpaint fallback", e)
            return None

    def detect_text_regions(self, image_bgr: np.ndarray) -> np.ndarray:
        """(H, W) uint8 {0, 255} text mask with the area/aspect guards."""
        img = torch.from_numpy(np.ascontiguousarray(image_bgr)).to(
            self.device)
        gray = imgproc.gray_u8(img, "bgr")
        grad = imgproc.morph_gradient(
            gray, get_structuring_element("ellipse", (3, 3)))
        _, bw = imgproc.otsu_threshold(grad)
        joined = imgproc.morph_close(bw, get_structuring_element("rect",
                                                                 (9, 3)))
        h, w = gray.shape
        labels = cc.label_components(joined > 0, 8)
        st = cc.component_stats(labels)
        area = st["area"]
        aspect = st["width"].double() / st["height"].clamp(min=1).double()
        keep = (st["exists"] & (area >= self.min_region_area)
                & (area.double() / (h * w) <= self.max_region_ratio)
                & (aspect >= 0.5) & (aspect <= 20))
        keep[0] = False
        mask = (keep[labels] & (labels > 0)).to(torch.uint8) * 255
        mask = mask.cpu().numpy()
        if (mask > 0).mean() > self.max_mask_ratio:
            logger.info("text mask exceeds max_mask_ratio; clearing")
            return np.zeros((h, w), np.uint8)
        return mask

    def _fallback_inpaint(self, image_bgr: np.ndarray,
                          mask: np.ndarray) -> np.ndarray:
        """The second rung, the native latent diffusion, then push-pull."""
        from .latent_diffusion import diffusion_inpaint_bgr

        native = diffusion_inpaint_bgr(image_bgr, mask, steps=self.steps,
                                       device=self.device)
        if native is not None:
            self.rung = "latent-diffusion"
            return native
        self.rung = "pushpull"
        return pushpull_bgr(image_bgr, mask, self.device)

    def remove_watermark_with_mask(self, image_bgr: np.ndarray,
                                   mask: np.ndarray) -> np.ndarray:
        """inpaint.py:200-240: an empty mask returns the image; a mask over
        max_mask_ratio, or no pipe, takes the fallback."""
        ratio = (mask > 127).mean()
        if ratio == 0:
            self.rung = None
            return image_bgr
        if ratio > self.max_mask_ratio:
            logger.info("mask ratio %.3f exceeds guard %.3f; fast inpaint",
                        ratio, self.max_mask_ratio)
            return self._fallback_inpaint(image_bgr, mask)
        pipe = self._load_pipe()
        if pipe is None:
            return self._fallback_inpaint(image_bgr, mask)
        from PIL import Image

        self.rung = "diffusers"
        img = Image.fromarray(np.ascontiguousarray(image_bgr[..., ::-1]))
        out = pipe(prompt=self.prompt,
                   negative_prompt=self.negative_prompt, image=img,
                   mask_image=Image.fromarray(mask),
                   num_inference_steps=self.steps,
                   guidance_scale=self.guidance_scale,
                   strength=self.strength).images[0]
        return np.ascontiguousarray(np.array(out)[..., ::-1])

    def remove_watermark_auto(self, image_bgr: np.ndarray) -> np.ndarray:
        """inpaint.py:242-360: detect text regions, then repair."""
        mask = self.detect_text_regions(image_bgr)
        if not (mask > 0).any():
            self.rung = None
            return image_bgr
        return self.remove_watermark_with_mask(image_bgr, mask)

    def process_folder(self, input_dir: str, output_dir: str,
                       limit: Optional[int] = None,
                       seed: int = 42) -> Dict:
        """inpaint.py:363-482: every image without an output of its name,
        `limit` of them chosen by random.Random(seed)'s shuffle."""
        os.makedirs(output_dir, exist_ok=True)
        files = sorted(f for f in os.listdir(input_dir)
                       if f.lower().endswith(IMAGE_SUFFIXES))
        todo = [f for f in files
                if not os.path.exists(os.path.join(output_dir, f))]
        if limit and len(todo) > limit:
            random.Random(seed).shuffle(todo)
            todo = todo[:limit]
        for f in todo:  # before any output is written
            image_io.require_decodable(os.path.join(input_dir, f))
        ok = failed = 0
        for f in todo:
            try:
                img = read_bgr(os.path.join(input_dir, f), self.device)
                if img is None:
                    failed += 1
                    continue
                write_bgr(os.path.join(output_dir, f),
                          self.remove_watermark_auto(img), self.device)
                ok += 1
            except Exception as e:  # noqa: BLE001 - counted, as in JAX
                logger.error("failed on %s: %s", f, e)
                failed += 1
        return {"total": len(files), "processed": ok, "failed": failed,
                "skipped": len(files) - len(todo)}


class SD3Pipeline:
    """sd3/sd3_pipeline.py's three steps in-process: the UNet mask, the
    fallback fill, then the SD3 polish where diffusers is installed."""

    def __init__(self, model_path: Optional[str] = None, config=None,
                 sd_remover: Optional[SDWatermarkRemover] = None,
                 device="cuda"):
        from ..inference.predict import WatermarkPredictor

        self.predictor = WatermarkPredictor(config, weights_path=model_path,
                                            device=device)
        self.sd = sd_remover or SDWatermarkRemover(device=device)

    def run(self, image_path: str, output_path: str,
            use_sd_polish: bool = True) -> str:
        img = read_bgr(image_path, self.sd.device)
        if img is None:
            raise ValueError(f"cannot read {image_path}")
        mask = self.predictor.predict_mask(image_path)
        repaired = self.sd._fallback_inpaint(img, mask)
        if use_sd_polish and diffusers_available():
            repaired = self.sd.remove_watermark_with_mask(repaired, mask)
        write_bgr(output_path, repaired, self.sd.device)
        return output_path
