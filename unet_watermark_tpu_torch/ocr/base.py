"""Common OCR detector interface (ocr/base.py in the JAX package).

Region dicts follow the reference's format: bbox is either [x, y, w, h] or
the 8-coordinate polygon [x1, y1, ..., x4, y4], plus text and confidence.
Images are read with utils/image_io.py (PNG, JPEG, BMP, TIFF, WEBP) as
RGB, where the JAX package reads BGR with cv2; every detector here takes
that into account.
A path's size comes from its headers: only a detector that looks at the
pixels decodes it, on its own device.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.imgproc import fill_poly, fill_rect
from ..utils import image_io

TextRegion = Dict


def rasterize_regions(regions, h: int, w: int) -> np.ndarray:
    """(h, w) uint8 mask with each region filled with 255: a 4-value bbox as
    cv2.rectangle(..., -1), an 8-value one as cv2.fillPoly."""
    mask = np.zeros((h, w), np.uint8)
    for region in regions or []:
        bbox = region.get("bbox")
        if bbox is None:
            continue
        if len(bbox) == 8:
            fill_poly(mask, np.array(bbox).reshape(-1, 2).astype(np.int32))
        elif len(bbox) == 4:
            x, y, bw, bh = (int(v) for v in bbox)
            fill_rect(mask, x, y, bw, bh)
    return mask


class OCRDetector:
    """Base class: implement detect_text_regions; mask helpers shared."""

    name = "base"
    image_extensions = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif"}

    def detect_text_regions(self, image_path,
                            languages: Optional[Sequence[str]] = None
                            ) -> List[TextRegion]:
        raise NotImplementedError

    def generate_text_mask(self, image_input,
                           output_path: Optional[str] = None,
                           languages: Optional[Sequence[str]] = None
                           ) -> Optional[np.ndarray]:
        """The regions of a path or an (H, W, 3) RGB image filled into a
        uint8 {0, 255} mask, written to output_path when given; None where
        the image cannot be read."""
        path = self._path(image_input)
        if path is None:
            img = self._array(image_input)
            size = img.shape[:2]
        else:
            size = self._size(path)
            if size is None:
                return None
        regions = self.detect_text_regions(img if path is None else path,
                                           languages=languages)
        mask = rasterize_regions(regions, *size)
        if output_path:
            image_io.write_png(output_path, mask)
        return mask

    def batch_process(self, input_folder: str, output_folder: str,
                      limit: Optional[int] = None,
                      random_seed: int = 42) -> Dict:
        """Every image of the folder without a {stem}_mask.png in
        output_folder, `limit` of them chosen by a seeded shuffle. A file
        the port cannot decode raises NotImplementedError before any mask
        is written."""
        os.makedirs(output_folder, exist_ok=True)
        files = sorted(
            p for p in (os.path.join(input_folder, f)
                        for f in os.listdir(input_folder))
            if os.path.splitext(p)[1].lower() in self.image_extensions)
        todo = [p for p in files if not os.path.exists(self._out_path(
            output_folder, p))]
        if limit is not None and 0 < limit < len(todo):
            random.Random(random_seed).shuffle(todo)
            todo = todo[:limit]
        for p in todo:  # before any mask is written
            image_io.require_decodable(p)
        ok = failed = 0
        for p in todo:
            mask = self.generate_text_mask(p, self._out_path(output_folder, p))
            if mask is None:
                failed += 1
            else:
                ok += 1
        return {"total": len(files), "processed": ok, "failed": failed,
                "skipped": len(files) - len(todo)}

    @staticmethod
    def _out_path(output_folder: str, image_path: str) -> str:
        stem = os.path.splitext(os.path.basename(image_path))[0]
        return os.path.join(output_folder, f"{stem}_mask.png")

    @staticmethod
    def _path(image_input) -> Optional[str]:
        """The path of a path input, None for an image. A path the port
        cannot decode (where cv2 could) raises NotImplementedError."""
        if not isinstance(image_input, (str, os.PathLike)):
            return None
        path = str(image_input)
        image_io.require_decodable(path)
        return path

    @staticmethod
    def _size(path: str) -> Optional[Tuple[int, int]]:
        """(H, W) of a path from its headers; None where they tell that
        cv2.imread would return None."""
        try:
            return image_io.check_image(path)
        except image_io.UNREADABLE:
            return None

    @staticmethod
    def _array(image_input) -> np.ndarray:
        """An (H, W, 3) uint8 RGB image input (a PIL image goes through
        np.asarray)."""
        arr = np.asarray(image_input)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"expected an (H, W, 3) uint8 RGB image, got "
                             f"{arr.shape} {arr.dtype}")
        return arr
