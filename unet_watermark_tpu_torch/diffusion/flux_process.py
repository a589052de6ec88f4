"""The FLUX Kontext shell (diffusion/flux_process.py of the JAX package):
prompt-based removal through a FLUX.1-Kontext pipe, OCR-gated text removal
with the (0.001, 0.5) ratio gate, size normalisation to 512-1024 in
multiples of 8, batch mode and the comparison video.

The first rung, init_model, imports diffusers (and nunchaku for the
quantized transformer) inside the function; where neither is installed
it returns None, as JAX's does, and every removal takes _fallback: the
text mask of the OCR detector (ocr.get_ocr_detector, the builtin detector
by default) filled by the native latent diffusion
(diffusion/latent_diffusion.diffusion_inpaint_bgr), or by push-pull
where its weights do not resolve. Images are numpy BGR
uint8; the pixel work runs on `device` ("cuda" unless the caller asks for
the CPU). Files go through utils/image_io.py as in sd3_inpaint.py
(process_batch refuses a folder holding a form the port cannot decode
yet, an animated WEBP among them, ROADMAP.md §A.5).
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import image_io
from ..utils.device import resolve_device
from .sd3_inpaint import IMAGE_SUFFIXES, pushpull_bgr, read_bgr, write_bgr

logger = logging.getLogger(__name__)

DEFAULT_MODEL = "black-forest-labs/FLUX.1-Kontext-dev"
RATIO_GATE = (0.001, 0.5)  # flux_process.py:158


def normalize_size(w: int, h: int, min_side: int = 512,
                   max_side: int = 1024, multiple: int = 8
                   ) -> Tuple[int, int]:
    """flux_process.py:249-284: clamp to [512, 1024], multiples of 8,
    preserving aspect."""
    scale = 1.0
    long_side = max(w, h)
    short_side = min(w, h)
    if long_side > max_side:
        scale = max_side / long_side
    elif short_side < min_side:
        scale = min_side / short_side
    nw, nh = int(w * scale), int(h * scale)
    nw = max((nw // multiple) * multiple, multiple)
    nh = max((nh // multiple) * multiple, multiple)
    return nw, nh


class FluxProcessor:
    def __init__(self, model_name: str = DEFAULT_MODEL,
                 quantized: bool = False,
                 prompt: str = ("remove the watermark and restore the "
                                "underlying image, photorealistic"),
                 ocr_engine: str = "builtin", device="cuda"):
        self.model_name = model_name
        self.quantized = quantized
        self.prompt = prompt
        self.ocr_engine = ocr_engine
        self.device = resolve_device(device)
        self._pipe = None
        self.rung: Optional[str] = None  # the rung the last removal ran

    def init_model(self):
        """flux_process.py:36-80: the diffusers pipe, or None."""
        from .sd3_inpaint import diffusers_available

        if self._pipe is not None:
            return self._pipe
        if not diffusers_available():
            return None
        try:
            from diffusers import FluxKontextPipeline

            kwargs = {"torch_dtype": torch.bfloat16}
            if self.quantized:
                try:
                    from nunchaku import NunchakuFluxTransformer2dModel

                    kwargs["transformer"] = \
                        NunchakuFluxTransformer2dModel.from_pretrained(
                            self.model_name)
                except ImportError:
                    logger.warning("nunchaku unavailable; full precision")
            self._pipe = FluxKontextPipeline.from_pretrained(
                self.model_name, **kwargs)
            return self._pipe
        except Exception as e:  # noqa: BLE001 - None is the next rung
            logger.warning("FLUX pipeline unavailable (%s); in-process "
                           "engine fallback active", e)
            return None

    def _text_mask(self, image_bgr: np.ndarray) -> Optional[np.ndarray]:
        from ..ocr import get_ocr_detector

        det = get_ocr_detector(self.ocr_engine, device=self.device)
        return det.generate_text_mask(
            np.ascontiguousarray(image_bgr[..., ::-1]))

    def _fallback(self, image_bgr: np.ndarray,
                  mask: Optional[np.ndarray]) -> np.ndarray:
        """The native latent diffusion, then push-pull, on the mask."""
        from .latent_diffusion import diffusion_inpaint_bgr

        if mask is None or not (mask > 0).any():
            self.rung = None
            return image_bgr
        native = diffusion_inpaint_bgr(image_bgr, mask, device=self.device)
        if native is not None:
            self.rung = "latent-diffusion"
            return native
        self.rung = "pushpull"
        return pushpull_bgr(image_bgr, mask, self.device)

    def _run_pipe(self, pipe, image_bgr: np.ndarray,
                  prompt: Optional[str]) -> np.ndarray:
        """The pipe at the normalised size, resized back (cv2's default
        INTER_LINEAR, ops/resize.resize_linear_u8)."""
        from PIL import Image

        from ..ops.resize import resize_linear_u8

        h, w = image_bgr.shape[:2]
        nw, nh = normalize_size(w, h)
        small = resize_linear_u8(torch.from_numpy(
            np.ascontiguousarray(image_bgr)), (nh, nw)).numpy()
        out = pipe(image=Image.fromarray(np.ascontiguousarray(
            small[..., ::-1])), prompt=prompt or self.prompt).images[0]
        out = np.ascontiguousarray(np.array(out)[..., ::-1])
        self.rung = "diffusers"
        return resize_linear_u8(torch.from_numpy(out), (h, w)).numpy()

    def remove_watermark(self, image_bgr: np.ndarray,
                         prompt: Optional[str] = None) -> np.ndarray:
        """Prompt-based removal (flux_process.py:82-103); without a pipe,
        the OCR text mask and the fallback."""
        pipe = self.init_model()
        if pipe is None:
            return self._fallback(image_bgr, self._text_mask(image_bgr))
        return self._run_pipe(pipe, image_bgr, prompt)

    def remove_text_watermark(self, image_bgr: np.ndarray
                              ) -> Tuple[np.ndarray, Dict]:
        """OCR-gated removal (flux_process.py:128-246): act only when the
        text-mask ratio lies inside RATIO_GATE."""
        mask = self._text_mask(image_bgr)
        ratio = float((mask > 0).mean()) if mask is not None else 0.0
        info = {"text_ratio": ratio, "acted": False}
        if not (RATIO_GATE[0] <= ratio <= RATIO_GATE[1]):
            self.rung = None
            return image_bgr, info
        info["acted"] = True
        pipe = self.init_model()
        if pipe is None:
            return self._fallback(image_bgr, mask), info
        return self.remove_watermark(image_bgr), info

    def process_batch(self, input_dir: str, output_dir: str,
                      limit: Optional[int] = None,
                      mode: str = "text") -> Dict:
        """flux_process.py:324-388: the first `limit` images without an
        output of their name."""
        os.makedirs(output_dir, exist_ok=True)
        files = sorted(f for f in os.listdir(input_dir)
                       if f.lower().endswith(IMAGE_SUFFIXES))
        todo = [f for f in files
                if not os.path.exists(os.path.join(output_dir, f))]
        if limit:
            todo = todo[:limit]
        for f in todo:  # before any output is written
            image_io.require_decodable(os.path.join(input_dir, f))
        ok = skipped = failed = 0
        for f in todo:
            try:
                img = read_bgr(os.path.join(input_dir, f), self.device)
                if img is None:
                    failed += 1
                    continue
                if mode == "text":
                    out, info = self.remove_text_watermark(img)
                    if not info["acted"]:
                        skipped += 1
                else:
                    out = self.remove_watermark(img)
                write_bgr(os.path.join(output_dir, f), out, self.device)
                ok += 1
            except Exception as e:  # noqa: BLE001 - counted, as in JAX
                logger.error("flux failed on %s: %s", f, e)
                failed += 1
        return {"total": len(files), "processed": ok, "skipped": skipped,
                "failed": failed}

    def generate_comparison_video(self, original_dir: str,
                                  processed_dir: str,
                                  output_path: str) -> Optional[str]:
        """flux_process.py:390+: the shared VideoGenerator, side by side at
        1280 x 720."""
        from ..scripts.video_generator import VideoGenerator

        gen = VideoGenerator(width=1280, height=720, device=self.device)
        return gen.create_side_by_side_video(original_dir, processed_dir,
                                             output_path)
