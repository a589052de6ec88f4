"""Synthetic watermark training data: logos, text, both, or several logos
composited onto clean images, with their masks (data/gen_data.py of the
JAX package, with its names, defaults, draws and files).

Every random decision is the JAX module's draw on the same
random.Random, in the same order: a run with the same seed picks the same
source images, kinds, file names, sizes, angles, alphas and placements.
The image work runs as torch ops on `device` ("cuda" unless the caller
passes "cpu"): ops/pil.py gives Pillow's rotate, LANCZOS resize, Gaussian
blur and alpha composite bit for bit, utils/image_io.py reads the sources
as PIL's Image.open(...).convert("RGBA") does (no EXIF rotation) and
writes the JPEGs Pillow's save(quality=95) writes, byte for byte.

The one stated difference is the text raster. JAX rasterises text with
FreeType (ImageFont.truetype over the system fonts, or load_default());
the port draws the line with ops/draw.py's 5 x 7 block font, antialiased,
in the colour JAX draws, at a cap height of CAP_HEIGHT x the font size
(about the cap height of the DejaVu fonts at that size). _render_text
makes JAX's draws in JAX's order (the size, the sample of the fonts, taken
and discarded, the colour), so everything drawn before the raster is JAX's
and everything after it (apply_text_effects, the 80 % clamp, _random_pos,
_paste_and_mask) is JAX's bit for bit given the raster. `logo` and `multi`
samples equal JAX's files byte for byte; `text` and `mixed` samples equal
them outside the text.

    python -m unet_watermark_tpu_torch.data.gen_data --clean-dir C \\
        --output O [--logos-dir L] [--count N] [--seed S] [--device cpu]
"""
from __future__ import annotations

import argparse
import functools
import logging
import os
import random
import string
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import draw, pil
from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
CAP_HEIGHT = 0.73  # the block font's cap height per unit of font size

_WORDS = ["SAMPLE", "WATERMARK", "COPYRIGHT", "DEMO", "PREVIEW", "DRAFT",
          "CONFIDENTIAL", "PROTECTED", "ORIGINAL", "AUTHENTIC"]
_SITES = ["www.example.com", "photo.site.net", "images.demo.org",
          "stock.sample.io"]
_COLORS = [(255, 255, 255), (0, 0, 0), (200, 200, 200), (255, 0, 0),
           (0, 80, 200), (240, 240, 120)]


def load_watermarks(logos_dir: str) -> List[str]:
    if not os.path.isdir(logos_dir):
        return []
    return sorted(
        os.path.join(logos_dir, f) for f in os.listdir(logos_dir)
        if f.lower().endswith(IMAGE_EXTENSIONS))


def load_clean_images(clean_dir: str) -> List[str]:
    if not os.path.isdir(clean_dir):
        return []
    return sorted(
        os.path.join(clean_dir, f) for f in os.listdir(clean_dir)
        if f.lower().endswith(IMAGE_EXTENSIONS))


def load_system_fonts() -> List[str]:
    """The font files JAX's generator would pick from: the draws depend on
    how many there are, not on what they hold."""
    candidates = []
    for root in ("/usr/share/fonts", "/usr/local/share/fonts",
                 os.path.expanduser("~/.fonts")):
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.lower().endswith((".ttf", ".ttc", ".otf")):
                    candidates.append(os.path.join(dirpath, f))
    return sorted(candidates)


def generate_text_content(rng: Optional[random.Random] = None) -> str:
    rng = rng or random
    kind = rng.random()
    if kind < 0.4:
        return rng.choice(_WORDS)
    if kind < 0.6:
        return rng.choice(_SITES)
    if kind < 0.8:
        return "© " + "".join(rng.choices(string.ascii_uppercase,
                                          k=rng.randint(3, 8)))
    return (rng.choice(_WORDS) + " " +
            "".join(rng.choices(string.digits, k=4)))


def _render_text(text: str, fonts: Sequence[str], rng: random.Random,
                 device) -> torch.Tensor:
    """The text as an RGBA raster: JAX's draws (size, the fonts' sample,
    colour), the block font's glyphs (module docstring)."""
    size = rng.randint(28, 96)
    if fonts:
        rng.sample(list(fonts), k=min(3, len(fonts)))
    color = rng.choice(_COLORS)
    return draw.text_raster(text, CAP_HEIGHT * size, color, device)


def apply_text_effects(text_img: torch.Tensor,
                       enhance_transparent: bool = True,
                       rng: Optional[random.Random] = None) -> torch.Tensor:
    """Rotation, anisotropic scale, alpha."""
    rng = rng or random
    angle = rng.uniform(0, 360)
    text_img = pil.rotate_expand(text_img, angle)
    sx, sy = rng.uniform(0.8, 1.4), rng.uniform(0.8, 1.4)
    h, w = text_img.shape[:2]
    text_img = pil.resize_lanczos(text_img, (max(int(w * sx), 1),
                                             max(int(h * sy), 1)))
    alpha = (rng.uniform(0.1, 0.5) if enhance_transparent
             else rng.uniform(0.3, 0.8))
    return pil.scale_alpha(text_img, alpha)


def apply_watermark_effects(watermark: torch.Tensor,
                            enhance_transparent: bool = True,
                            target_size: Optional[Tuple[int, int]] = None,
                            rng: Optional[random.Random] = None
                            ) -> torch.Tensor:
    """Logo effects: scale to 3-35 % of the target's width, rotation,
    optional blur and partial-erasure defects, alpha. `watermark` is RGBA
    (H, W, 4) uint8; target_size is (width, height)."""
    rng = rng or random
    if target_size is not None:
        scale = rng.uniform(0.03, 0.35)
        new_w = max(int(target_size[0] * scale), 8)
        h, w = watermark.shape[:2]
        new_h = max(int(h * new_w / max(w, 1)), 8)
        new_h = min(new_h, max(int(target_size[1] * 0.35), 8))
        watermark = pil.resize_lanczos(watermark, (new_w, new_h))
    angle = rng.uniform(0, 360)
    watermark = pil.rotate_expand(watermark, angle)
    if rng.random() < 0.3:
        watermark = pil.gaussian_blur(watermark, rng.uniform(0.5, 1.5))
    if rng.random() < 0.2:  # partial-erasure defect
        watermark = watermark.clone()
        h, w = watermark.shape[:2]
        for _ in range(rng.randint(1, 3)):
            if h < 4 or w < 4:
                break
            eh, ew = rng.randint(h // 8 + 1, h // 3 + 1), rng.randint(
                w // 8 + 1, w // 3 + 1)
            ey, ex = rng.randint(0, h - eh), rng.randint(0, w - ew)
            watermark[ey:ey + eh, ex:ex + ew, 3] = 0
    alpha = (rng.uniform(0.08, 0.45) if enhance_transparent
             else rng.uniform(0.25, 0.85))
    return pil.scale_alpha(watermark, alpha)


def _paste_and_mask(clean: torch.Tensor, wm: torch.Tensor,
                    pos: Tuple[int, int], mask: torch.Tensor,
                    alpha_threshold: int = 10) -> None:
    """Alpha-composite wm onto clean at pos (x, y); OR its footprint
    (alpha > alpha_threshold) into mask. Both in place."""
    pil.alpha_composite(clean, wm, pos)
    xs, ys = pos
    h, w = wm.shape[:2]
    H, W = mask.shape
    y2, x2 = min(ys + h, H), min(xs + w, W)
    if y2 <= ys or x2 <= xs:
        return
    region = wm[: y2 - ys, : x2 - xs, 3] > alpha_threshold
    mask[ys:y2, xs:x2] |= region


def _random_pos(rng: random.Random, canvas: Tuple[int, int],
                wm: Tuple[int, int]) -> Tuple[int, int]:
    x = rng.randint(0, max(canvas[0] - wm[0], 0))
    y = rng.randint(0, max(canvas[1] - wm[1], 0))
    return x, y


def _size(img: torch.Tensor) -> Tuple[int, int]:
    """(width, height), PIL's order."""
    return img.shape[1], img.shape[0]


def _ocr_refine_text_mask(watermarked: torch.Tensor,
                          geo_mask: torch.Tensor) -> torch.Tensor:
    """The builtin detector's boxes over the composited (H, W, 3) image,
    intersected with the 9 x 9 dilation of the geometric footprint; the
    footprint itself where that recovers less than a fifth of it."""
    from ..ocr.builtin import BuiltinTextDetector

    det = BuiltinTextDetector(device=watermarked.device)
    ocr_mask = det.generate_text_mask(watermarked.cpu().numpy())
    if ocr_mask is None:
        return geo_mask
    g = geo_mask.to(torch.float32)[None, None]
    footprint = F.max_pool2d(g, 9, stride=1, padding=4)[0, 0] > 0
    refined = torch.from_numpy(ocr_mask > 0).to(geo_mask.device) & footprint
    if int(refined.sum()) < 0.2 * max(int(geo_mask.sum()), 1):
        return geo_mask
    return refined


@functools.lru_cache(maxsize=16)
def _read_cached(path: str, device: str, mtime: float) -> torch.Tensor:
    del mtime
    return image_io.read_rgba_tensor(path, device)


def _open_rgba(path: str, device) -> torch.Tensor:
    """Image.open(path).convert("RGBA") as a fresh tensor on device."""
    return _read_cached(path, str(device), os.path.getmtime(path)).clone()


def _clamp_text(timg: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """Text larger than 80 % of the canvas is scaled down to fit."""
    tw, th = _size(timg)
    cw, ch = _size(clean)
    if tw > cw * 0.8 or th > ch * 0.8:
        s = min(cw * 0.8 / tw, ch * 0.8 / th)
        timg = pil.resize_lanczos(timg, (max(int(tw * s), 1),
                                         max(int(th * s), 1)))
    return timg


def generate_text_watermark(clean_image_path: str,
                            enhance_transparent: bool = True,
                            fonts: Optional[Sequence[str]] = None,
                            rng: Optional[random.Random] = None,
                            use_ocr_mask: bool = False, device="cuda"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-3 lines of text: (RGB (H, W, 3) uint8, mask (H, W) uint8 {0,
    255})."""
    device = resolve_device(device)
    rng = rng or random.Random()
    fonts = fonts if fonts is not None else load_system_fonts()
    clean = _open_rgba(clean_image_path, device)
    out_mask = torch.zeros(clean.shape[:2], dtype=torch.bool, device=device)
    for _ in range(rng.randint(1, 3)):
        text = generate_text_content(rng)
        timg = _render_text(text, fonts, rng, device)
        timg = apply_text_effects(timg, enhance_transparent, rng)
        timg = _clamp_text(timg, clean)
        pos = _random_pos(rng, _size(clean), _size(timg))
        _paste_and_mask(clean, timg, pos, out_mask)
    rgb = pil.to_rgb(clean)
    if use_ocr_mask:
        out_mask = _ocr_refine_text_mask(rgb, out_mask)
    return rgb, out_mask.to(torch.uint8) * 255


def generate_watermarked_image(clean_image_path: str, watermark_path: str,
                               enhance_transparent: bool = True,
                               rng: Optional[random.Random] = None,
                               device="cuda"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One logo: (RGB, mask)."""
    device = resolve_device(device)
    rng = rng or random.Random()
    clean = _open_rgba(clean_image_path, device)
    wm = _open_rgba(watermark_path, device)
    wm = apply_watermark_effects(wm, enhance_transparent, _size(clean), rng)
    out_mask = torch.zeros(clean.shape[:2], dtype=torch.bool, device=device)
    pos = _random_pos(rng, _size(clean), _size(wm))
    _paste_and_mask(clean, wm, pos, out_mask)
    return pil.to_rgb(clean), out_mask.to(torch.uint8) * 255


def calculate_overlap_area(rect1, rect2) -> int:
    """Intersection area of two (x, y, w, h) rectangles."""
    x1 = max(rect1[0], rect2[0])
    y1 = max(rect1[1], rect2[1])
    x2 = min(rect1[0] + rect1[2], rect2[0] + rect2[2])
    y2 = min(rect1[1] + rect1[3], rect2[1] + rect2[3])
    return max(0, x2 - x1) * max(0, y2 - y1)


def generate_multiple_watermarks_image(
        clean_image_path: str, watermark_paths: Sequence[str],
        enhance_transparent: bool = True, max_watermarks: int = 3,
        rng: Optional[random.Random] = None, device="cuda"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2..max_watermarks logos, each placed where it overlaps the others
    by less than 30 % (10 tries, else dropped)."""
    device = resolve_device(device)
    rng = rng or random.Random()
    clean = _open_rgba(clean_image_path, device)
    out_mask = torch.zeros(clean.shape[:2], dtype=torch.bool, device=device)
    placed: List[Tuple[int, int, int, int]] = []
    count = rng.randint(2, max(max_watermarks, 2))
    for _ in range(count):
        wm = _open_rgba(rng.choice(list(watermark_paths)), device)
        wm = apply_watermark_effects(wm, enhance_transparent, _size(clean),
                                     rng)
        ww, wh = _size(wm)
        for _attempt in range(10):
            pos = _random_pos(rng, _size(clean), (ww, wh))
            rect = (pos[0], pos[1], ww, wh)
            area = ww * wh
            overlap = sum(calculate_overlap_area(rect, p) for p in placed)
            if area == 0 or overlap / area < 0.3:
                placed.append(rect)
                _paste_and_mask(clean, wm, pos, out_mask)
                break
    return pil.to_rgb(clean), out_mask.to(torch.uint8) * 255


def generate_mixed_watermark(clean_image_path: str,
                             watermark_paths: Sequence[str],
                             enhance_transparent: bool = True,
                             max_watermarks: int = 2,
                             fonts: Optional[Sequence[str]] = None,
                             rng: Optional[random.Random] = None,
                             device="cuda"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logos, then one line of text, on one image."""
    device = resolve_device(device)
    rng = rng or random.Random()
    fonts = fonts if fonts is not None else load_system_fonts()
    img, mask = generate_multiple_watermarks_image(
        clean_image_path, watermark_paths, enhance_transparent,
        max_watermarks, rng, device)
    clean = torch.cat([img, torch.full_like(img[..., :1], 255)], dim=2)
    out_mask = mask > 127
    text = generate_text_content(rng)
    timg = apply_text_effects(_render_text(text, fonts, rng, device),
                              enhance_transparent, rng)
    timg = _clamp_text(timg, clean)
    pos = _random_pos(rng, _size(clean), _size(timg))
    _paste_and_mask(clean, timg, pos, out_mask)
    return pil.to_rgb(clean), out_mask.to(torch.uint8) * 255


def generate_filename(clean_path: str, kind: str, index: int) -> str:
    stem = os.path.splitext(os.path.basename(clean_path))[0]
    return f"{stem}_{kind}_{index:05d}.jpg"


@functools.lru_cache(maxsize=64)
def _clean_copy_bytes(path: str, device: str, mtime: float) -> bytes:
    """The clean copy as JAX writes it: the source opened by PIL, RGB,
    saved at quality 95."""
    del mtime
    return image_io.encode_jpeg(_read_cached(
        path, device, os.path.getmtime(path))[..., :3])


def generate_dataset(clean_dir: str, output_root: str,
                     logos_dir: Optional[str] = None,
                     count: int = 100,
                     ratios: Optional[dict] = None,
                     enhance_transparent: bool = True,
                     seed: int = 42,
                     resume: bool = True,
                     use_ocr_mask: bool = False,
                     device="cuda") -> dict:
    """`count` samples into output_root/{watermarked,clean,masks}: sample
    i draws from random.Random(f"{seed}:{i}") its source, its kind by
    `ratios` ({"logo", "text", "mixed", "multi"} weights) and the rest;
    an existing output is skipped (resume) without drawing. Returns the
    count of each kind and of skipped files. A sample that fails is logged
    and skipped, as in JAX; an input form the port does not read yet
    (NotImplementedError) is raised."""
    device = resolve_device(device)
    ratios = ratios or {"logo": 0.4, "text": 0.3, "mixed": 0.15,
                        "multi": 0.15}
    cleans = load_clean_images(clean_dir)
    if not cleans:
        raise FileNotFoundError(f"no clean images in {clean_dir}")
    logos = load_watermarks(logos_dir) if logos_dir else []
    fonts = load_system_fonts()
    wm_dir = os.path.join(output_root, "watermarked")
    cl_dir = os.path.join(output_root, "clean")
    mk_dir = os.path.join(output_root, "masks")
    for d in (wm_dir, cl_dir, mk_dir):
        os.makedirs(d, exist_ok=True)

    kinds = list(ratios)
    weights = [ratios[k] for k in kinds]
    stats = {k: 0 for k in kinds}
    stats["skipped"] = 0
    for i in range(count):
        rng = random.Random(f"{seed}:{i}")
        clean_path = rng.choice(cleans)
        kind = rng.choices(kinds, weights)[0]
        if kind in ("logo", "mixed", "multi") and not logos:
            kind = "text"
        name = generate_filename(clean_path, kind, i)
        out_img = os.path.join(wm_dir, name)
        if resume and os.path.exists(out_img):
            stats["skipped"] += 1
            continue
        try:
            if kind == "text":
                img, mask = generate_text_watermark(
                    clean_path, enhance_transparent, fonts, rng,
                    use_ocr_mask=use_ocr_mask, device=device)
            elif kind == "logo":
                img, mask = generate_watermarked_image(
                    clean_path, rng.choice(logos), enhance_transparent, rng,
                    device=device)
            elif kind == "multi":
                img, mask = generate_multiple_watermarks_image(
                    clean_path, logos, enhance_transparent, rng=rng,
                    device=device)
            else:
                img, mask = generate_mixed_watermark(
                    clean_path, logos, enhance_transparent, fonts=fonts,
                    rng=rng, device=device)
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001
            logger.warning("generation failed for %s: %s", clean_path, e)
            continue
        image_io.write_jpeg(out_img, img)
        with open(os.path.join(cl_dir, name), "wb") as f:
            f.write(_clean_copy_bytes(clean_path, str(device),
                                      os.path.getmtime(clean_path)))
        image_io.write_png(os.path.join(mk_dir,
                                        os.path.splitext(name)[0] + ".png"),
                           mask.cpu().numpy())
        stats[kind] = stats.get(kind, 0) + 1
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="synthetic watermark data gen")
    p.add_argument("--clean-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--logos-dir", default=None)
    p.add_argument("--count", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--opaque", action="store_true",
                   help="use opaque (non-transparent) watermarks")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--ocr-mask", action="store_true",
                   help="OCR-refined text masks (the builtin detector)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    stats = generate_dataset(
        args.clean_dir, args.output, args.logos_dir, args.count,
        enhance_transparent=not args.opaque, seed=args.seed,
        resume=not args.no_resume, use_ocr_mask=args.ocr_mask,
        device=args.device)
    print(stats)


if __name__ == "__main__":
    main()
