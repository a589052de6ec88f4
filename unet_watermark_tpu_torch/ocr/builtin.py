"""Dependency-free text-region detector (ocr/builtin.py in the JAX
package), its image ops on a torch device through ops/imgproc.py.

Stroke edges (morphological gradient with the 3x3 ellipse, Otsu) are joined
into line blobs (a close with a 9x3 rectangle); each external contour's box
is kept when its area, aspect, height and edge density look like text, and
horizontally adjacent boxes merge into lines. Returns [x, y, w, h] boxes in
the shared region format. Tuned for watermark-style overlay text: recall
over precision, since the boxes feed an inpainter.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops import imgproc
from ..ops.morphology import ellipse_kernel, rect_kernel
from ..utils import image_io
from ..utils.device import resolve_device
from .base import OCRDetector, TextRegion


class BuiltinTextDetector(OCRDetector):
    name = "builtin"

    def __init__(self, min_area: int = 30, max_area_ratio: float = 0.05,
                 merge_gap: float = 1.2, device="cuda"):
        self.min_area = min_area
        self.max_area_ratio = max_area_ratio
        self.merge_gap = merge_gap
        self.device = resolve_device(device)

    def detect_text_regions(self, image_path,
                            languages: Optional[Sequence[str]] = None
                            ) -> List[TextRegion]:
        del languages
        path = self._path(image_path)
        if path is None:
            img = self._array(image_path)
            if not img.flags.writeable:  # a PIL image's buffer
                img = img.copy()
            rgb = torch.from_numpy(img).to(self.device)
        else:
            try:
                rgb = image_io.read_rgb_tensor(path, self.device)
            except image_io.UNREADABLE:
                return []
        gray = imgproc.gray_u8(rgb, "rgb")
        h, w = gray.shape
        grad = imgproc.morph_gradient(gray, ellipse_kernel(3, 3))
        _, bw_img = imgproc.otsu_threshold(grad)
        joined = imgproc.morph_close(bw_img, rect_kernel(9, 3))
        rects = imgproc.external_boxes(joined)
        # nonzero pixels of bw_img in each box, from its integral image
        counts = []
        if rects:
            ii = F.pad(torch.cumsum(torch.cumsum(
                (bw_img > 0).to(torch.int64), 0), 1), (1, 0, 1, 0))
            r = torch.tensor(rects, device=self.device)
            x0, y0 = r[:, 0], r[:, 1]
            x1, y1 = x0 + r[:, 2], y0 + r[:, 3]
            counts = (ii[y1, x1] - ii[y0, x1] - ii[y1, x0]
                      + ii[y0, x0]).tolist()
        boxes = []
        max_area = h * w * self.max_area_ratio
        for (x, y, bw_, bh), count in zip(rects, counts):
            area = bw_ * bh
            if area < self.min_area or area > max_area * 10:
                continue
            aspect = bw_ / max(bh, 1)
            fill = count / max(area, 1)
            if 0.8 <= aspect <= 30 and bh < h * 0.3 and fill > 0.15:
                boxes.append([x, y, bw_, bh])
        boxes = self._merge_lines(boxes)
        return [{"bbox": [float(v) for v in b], "text": "",
                 "confidence": 0.5} for b in boxes]

    def _merge_lines(self, boxes: List[List[int]]) -> List[List[int]]:
        """Greedy merge of horizontally-adjacent character boxes into
        line boxes."""
        boxes = sorted(boxes, key=lambda b: (b[1], b[0]))
        merged: List[List[int]] = []
        for b in boxes:
            placed = False
            for mitem in merged:
                mx, my, mw, mh = mitem
                bx, by, bw, bh = b
                same_line = abs((by + bh / 2) - (my + mh / 2)) < \
                    max(mh, bh) * 0.6
                gap = bx - (mx + mw)
                if same_line and gap < max(mh, bh) * self.merge_gap and \
                        gap > -max(mw, bw):
                    nx = min(mx, bx)
                    ny = min(my, by)
                    nx2 = max(mx + mw, bx + bw)
                    ny2 = max(my + mh, by + bh)
                    mitem[:] = [nx, ny, nx2 - nx, ny2 - ny]
                    placed = True
                    break
            if not placed:
                merged.append(list(b))
        return merged
