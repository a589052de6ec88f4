"""Logo preprocessing (car_logo/logo_process.py in the JAX package):
white-background removal to RGBA with a soft alpha, a crop to the
content, and a letterboxed resize to size × size, as PIL computes them:

  read      Image.open(p).convert("RGBA") (utils/image_io.read_rgba_tensor:
            JPEG, PNG with its alpha or tRNS, WEBP, BMP, TIFF)
  alpha     min(alpha, 0 at brightness ≥ white_threshold, (threshold -
            brightness) × 255 // 20 within 20 below it, else 255), the
            brightness being the smallest of R, G, B
  crop      the bounding box of alpha > 10
  resize    Image.resize(LANCZOS) of RGBA, which PIL runs premultiplied
            (ops/pil.resize_lanczos: premultiply, the two passes,
            unpremultiply)
  paste     canvas.paste(out, box, out) onto a transparent canvas: each
            byte, alpha too, DIV255(v × alpha) with PIL's rounding

The pixel steps run on `device`. remove_background_and_resize returns the
(size, size, 4) uint8 tensor where JAX returns the PIL image; the PNG is
the port's encoder's (the same pixels as PIL's file).

CLI (on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.car_logo.logo_process \\
        --input LOGOS --output OUT [--size 256]
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import torch

from ..ops import pil
from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


def remove_background_and_resize(image_path: str,
                                 output_path: Optional[str] = None,
                                 size: int = 256,
                                 white_threshold: int = 240,
                                 device="cuda") -> torch.Tensor:
    dev = resolve_device(device)
    arr = image_io.read_rgba_tensor(image_path, dev).clone()
    brightness = arr[..., :3].to(torch.int32).amin(-1)
    soft = (white_threshold - brightness) * 255 // 20
    alpha = torch.where(brightness >= white_threshold, 0,
                        torch.where(brightness >= white_threshold - 20,
                                    soft, 255)).to(torch.uint8)
    arr[..., 3] = torch.minimum(arr[..., 3], alpha)
    out = arr
    mask = arr[..., 3] > 10
    if bool(mask.any()):
        ys = torch.nonzero(mask.any(1)).flatten()
        xs = torch.nonzero(mask.any(0)).flatten()
        out = arr[int(ys[0]):int(ys[-1]) + 1, int(xs[0]):int(xs[-1]) + 1]
    h, w = out.shape[:2]
    scale = min(size / w, size / h)
    nw, nh = max(int(w * scale), 1), max(int(h * scale), 1)
    out = pil.resize_lanczos(out.contiguous(), (nw, nh)).to(torch.int64)
    canvas = torch.zeros((size, size, 4), dtype=torch.uint8, device=dev)
    x0, y0 = (size - nw) // 2, (size - nh) // 2
    t = out * out[..., 3:] + 128  # BLEND onto 0 with the alpha as mask
    canvas[y0:y0 + nh, x0:x0 + nw] = (((t >> 8) + t) >> 8).to(torch.uint8)
    if output_path:
        image_io.write_png(output_path, canvas.cpu().numpy())
    return canvas


def process_folder(input_dir: str, output_dir: str, size: int = 256,
                   device="cuda") -> int:
    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for f in sorted(os.listdir(input_dir)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
            continue
        stem = os.path.splitext(f)[0]
        try:
            remove_background_and_resize(
                os.path.join(input_dir, f),
                os.path.join(output_dir, f"{stem}.png"), size,
                device=device)
            count += 1
        except image_io.UNREADABLE as e:
            logger.warning("failed on %s: %s", f, e)
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description="logo background removal")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n = process_folder(args.input, args.output, args.size,
                       device=args.device)
    print(n)
    return n


if __name__ == "__main__":
    main()
