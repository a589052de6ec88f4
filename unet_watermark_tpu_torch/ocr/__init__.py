"""OCR backends (ocr/ in the JAX package): text detectors behind one
interface, detect_text_regions(image) → region dicts.

  * "easy"    — EasyOCRDetector (gated import; easyocr is optional)
  * "paddle"  — PaddleOCRProcessor, HTTP client to a PaddleX service
  * "builtin" — BuiltinTextDetector: morphological gradient, Otsu, a
                closing and the external contours' boxes, on the torch
                device through ops/imgproc.py; also what "easy" gives when
                easyocr is not installed, as in the JAX package

Each detector's `name` says which one ran. `device` is where the builtin
detector's ops and the EasyOCR reader run: "cuda" unless the caller asks
for the CPU (the PaddleOCR client runs on its service).
"""
import logging

from .base import OCRDetector, TextRegion
from .builtin import BuiltinTextDetector
from .easy_ocr import EasyOCRDetector
from .paddle_ocr import PaddleOCRDetector, PaddleOCRProcessor

logger = logging.getLogger(__name__)


def get_ocr_detector(engine: str = "easy", device="cuda",
                     **kwargs) -> OCRDetector:
    engine = (engine or "easy").lower()
    if engine == "paddle":
        return PaddleOCRProcessor(**kwargs)
    if engine == "builtin":
        return BuiltinTextDetector(device=device, **kwargs)
    if engine == "easy":
        try:
            det = EasyOCRDetector(device=device, **kwargs)
            det.ensure_available()
            return det
        except ImportError:
            logger.warning("easyocr not installed; using builtin text "
                           "detector")
            return BuiltinTextDetector(device=device)
    raise ValueError(f"unknown OCR engine '{engine}'")


__all__ = [
    "OCRDetector",
    "TextRegion",
    "BuiltinTextDetector",
    "EasyOCRDetector",
    "PaddleOCRDetector",
    "PaddleOCRProcessor",
    "get_ocr_detector",
]
