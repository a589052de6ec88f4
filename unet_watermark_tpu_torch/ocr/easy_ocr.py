"""EasyOCR backend (ocr/easy_ocr.py in the JAX package).

Lazily builds the Reader (en/ch_sim by default) and normalizes results to
8-coordinate polygon regions. The easyocr import is gated: the package is
optional, and get_ocr_detector("easy") gives the builtin detector where it
is missing. The Reader runs on `device`, "cuda" unless the caller asks for
the CPU (the JAX package's detector defaults to the CPU).
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

from ..utils.device import resolve_device
from .base import OCRDetector, TextRegion

logger = logging.getLogger(__name__)


class EasyOCRDetector(OCRDetector):
    name = "easy"

    def __init__(self, languages: Optional[Sequence[str]] = None,
                 verbose: bool = False, device="cuda"):
        self.languages = list(languages) if languages else ["en", "ch_sim"]
        self.device = resolve_device(device)
        # easyocr.Reader's gpu: False (CPU), True (its default card) or a
        # torch device string
        self.gpu = (str(self.device) if self.device.index is not None
                    else self.device.type == "cuda")
        self.verbose = verbose
        self.reader = None

    def ensure_available(self) -> None:
        import easyocr  # noqa: F401

    def _init_reader(self):
        if self.reader is None:
            import easyocr
            logger.info("initializing EasyOCR reader (%s)", self.languages)
            self.reader = easyocr.Reader(self.languages, gpu=self.gpu,
                                         verbose=self.verbose)

    def detect_text_regions(self, image_path,
                            languages: Optional[Sequence[str]] = None
                            ) -> List[TextRegion]:
        path = self._path(image_path)
        if path is None:
            img = self._array(image_path)
        elif self._size(path) is None:
            return []
        if languages and list(languages) != self.languages:
            self.languages = list(languages)
            self.reader = None
        self._init_reader()
        results = self.reader.readtext(img if path is None else path)
        regions: List[TextRegion] = []
        for bbox, text, conf in results:
            if len(bbox) == 4 and len(bbox[0]) == 2:
                flat = [float(c) for point in bbox for c in point]
                regions.append({"bbox": flat, "text": text,
                                "confidence": float(conf)})
        return regions
