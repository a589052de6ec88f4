"""PaddleOCR backend (ocr/paddle_ocr.py in the JAX package): an HTTP
client to a PaddleX OCR service, on urllib (the GPU machine has no
`requests`).

POSTs the file as base64 JSON ({"file": ..., "fileType": 1}) and reads the
regions of result.ocrResults[].prunedResult, preferring dt_polys, then
rec_polys, then rec_boxes (as 4-point polygons).
"""
from __future__ import annotations

import base64
import json
import logging
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

from .base import OCRDetector, TextRegion

logger = logging.getLogger(__name__)

DEFAULT_API_URL = "http://127.0.0.1:8080/ocr"


class PaddleOCRProcessor(OCRDetector):
    name = "paddle"

    def __init__(self, api_url: str = DEFAULT_API_URL, timeout: float = 30.0):
        self.api_url = api_url
        self.timeout = timeout

    def ocr_request(self, image_path: str) -> Optional[Dict[str, Any]]:
        with open(image_path, "rb") as f:
            file_data = base64.b64encode(f.read()).decode("ascii")
        body = json.dumps({"file": file_data, "fileType": 1}).encode()
        req = urllib.request.Request(
            self.api_url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                if resp.status == 200:
                    return json.loads(resp.read())["result"]
                logger.error("OCR service HTTP %d for %s", resp.status,
                             image_path)
        except urllib.error.HTTPError as e:
            logger.error("OCR service HTTP %d for %s", e.code, image_path)
        except (OSError, ValueError, KeyError) as e:
            logger.error("OCR request failed for %s: %s", image_path, e)
        return None

    def detect_text_regions(self, image_path,
                            languages: Optional[Sequence[str]] = None
                            ) -> List[TextRegion]:
        del languages  # the service is language-configured server-side
        result = self.ocr_request(str(image_path))
        if not result:
            return []
        regions: List[TextRegion] = []
        for ocr_res in result.get("ocrResults", []) or []:
            pruned = ocr_res.get("prunedResult", {})
            polys = None
            if pruned.get("dt_polys"):
                polys = pruned["dt_polys"]
            elif pruned.get("rec_polys"):
                polys = pruned["rec_polys"]
            elif pruned.get("rec_boxes"):
                polys = [[[x1, y1], [x2, y1], [x2, y2], [x1, y2]]
                         for (x1, y1, x2, y2) in pruned["rec_boxes"]]
            for poly in polys or []:
                flat = [float(c) for point in poly for c in point]
                regions.append({"bbox": flat, "text": "",
                                "confidence": 1.0})
        return regions


# interface-compat alias
PaddleOCRDetector = PaddleOCRProcessor
