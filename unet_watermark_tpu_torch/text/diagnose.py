"""Text-watermark environment diagnosis (text/diagnose.py in the JAX
package): fonts, OCR backends and the text-mask pipeline, with JAX's keys.

  fonts     the font files data/gen_data.load_system_fonts finds (their
            count steers gen_data's draws), how many of the first 20 are
            TrueType/OpenType files, and a sample text. JAX renders each
            font with FreeType through PIL; the card's machine has neither,
            and the port draws all text with ops/draw's block font, which
            the extra key "renderer" says
  ocr       easyocr absent means the builtin detector serves the "easy"
            engine; the PaddleOCR service is probed over HTTP (urllib, 2 s
            timeout, as JAX's requests probe)
  pipeline  a line of block-font text on a dark image → BuiltinTextDetector
            → maskproc.optimize_text_mask on `device` (the card unless
            "cpu"); JAX draws the line with PIL's default font

CLI: python -m unet_watermark_tpu_torch.text.diagnose [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import urllib.error
import urllib.request
from typing import Dict

logger = logging.getLogger(__name__)

# sfnt signatures: TrueType, OpenType (CFF), Apple 'true', collections
_SFNT = (b"\x00\x01\x00\x00", b"OTTO", b"true", b"ttcf")
RENDERER = "block font (ops/draw.py); FreeType is not used"
PROBE_TIMEOUT_S = 2


def _is_font_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) in _SFNT
    except OSError:
        return False


def diagnose_fonts() -> Dict:
    from ..data.gen_data import generate_text_content, load_system_fonts

    fonts = load_system_fonts()
    samples = [fp for fp in fonts[:20] if _is_font_file(fp)]
    result = {
        "fonts_found": len(fonts),
        "fonts_renderable_sampled": len(samples),
        "sample_fonts": samples[:5],
        "sample_text": generate_text_content(),
        "renderer": RENDERER,
    }
    if not fonts:
        result["fix"] = ("no TTF fonts found — the port draws text with its "
                         "block font either way; the font count only "
                         "steers data/gen_data's draws")
    return result


def diagnose_ocr() -> Dict:
    out: Dict = {}
    try:
        import easyocr  # noqa: F401
        out["easyocr"] = "available"
    except ImportError:
        out["easyocr"] = ("missing — 'easy' engine falls back to the "
                          "builtin morphological detector")
    from ..ocr.paddle_ocr import DEFAULT_API_URL

    try:
        with urllib.request.urlopen(DEFAULT_API_URL.rsplit("/", 1)[0],
                                    timeout=PROBE_TIMEOUT_S) as resp:
            out["paddle_service"] = f"reachable (HTTP {resp.status})"
    except urllib.error.HTTPError as e:  # the service answered
        out["paddle_service"] = f"reachable (HTTP {e.code})"
    except Exception as e:  # noqa: BLE001 - any failure is the finding
        out["paddle_service"] = f"unreachable ({type(e).__name__})"
    out["builtin"] = "available"
    return out


def diagnose_pipeline(device="cuda") -> Dict:
    """Block-font text → builtin OCR → the text-mask strategy on
    `device`."""
    import numpy as np
    import torch

    from ..inference import maskproc
    from ..ocr import BuiltinTextDetector
    from ..ops import draw
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    img = torch.full((128, 256, 3), 30, dtype=torch.uint8)
    scale = 0.5  # cap height 11 px
    draw.put_text(img, "WATERMARK TEXT 2024",
                  (40, 60 + int(round(22 * scale))), scale,
                  (255, 255, 255), 1)
    det = BuiltinTextDetector(device=dev)
    mask = det.generate_text_mask(img.numpy())
    found = bool(mask is not None and (mask > 0).any())
    result = {"builtin_ocr_found_text": found}
    if found:
        opt = maskproc.optimize_text_mask(torch.from_numpy(
            (mask > 0).astype(np.float32)).to(dev))
        result["optimized_mask_coverage"] = float(opt.mean())
    return result


def run_all(device="cuda") -> Dict:
    return {
        "fonts": diagnose_fonts(),
        "ocr": diagnose_ocr(),
        "pipeline": diagnose_pipeline(device),
    }


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description="text watermark diagnosis")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = run_all(args.device)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
