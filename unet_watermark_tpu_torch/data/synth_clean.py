"""Procedural clean images and logos (data/synth_clean.py of the JAX
package, with its names, defaults, draws and files): fractal value noise,
smooth colour gradients and antialiased geometric content, and RGBA logo
emblems, made from a seed with no image source.

Every random decision is the JAX module's numpy draw on the same
default_rng stream, in the same order, so each image is a function of its
seed as in JAX. The pixel work runs on the host in numpy, with cv2 5.0's and
Pillow 12's operations as the port reproduces them:

  cv2.resize INTER_CUBIC (float32)  ops/resize.resize_cubic_f32
  cv2.resize INTER_NEAREST          ops/resize.resize_nearest
  cv2.GaussianBlur (3/5/7, sigma 0) ops/imgproc.gaussian_blur_f32
  cv2.ellipse / fillPoly / line,    ops/imgproc.ellipse_filled_aa,
  LINE_AA                           fill_poly_aa, line_thick_aa (exact)
  ImageDraw ellipse / polygon /     ops/draw.pil_ellipse, pil_polygon,
  rectangle on RGBA                 pil_rectangle (exact)

The stated differences (ROADMAP.md): the cubic resize and the 5- and 7-tap
blurs sum in another order than cv2's vector code, a float32 ulp or three
apart on a share of the values, which moves a uint8 pixel on a small share
of the images' pixels (tests/test_torch_synth_clean.py states the bound);
and synth_logo's letters and text strip, which JAX rasterises with FreeType
and DejaVu, are ops/draw.py's block font at the fonts' cap height, placed
where the fonts' cap line lies, as gen_data's text.

The clean JPEGs go through utils/image_io.encode_jpeg (quality 95, its
colour and quantisation stage on `device`, "cuda" unless the caller asks
for the CPU); the logos are RGBA PNGs (utils/image_io.write_png, whose
bytes are not Pillow's; the pixels are).

    python -m unet_watermark_tpu_torch.data.synth_clean --output D \\
        [--count N] [--size S] [--seed K] [--logos] [--texture-ratio R] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..ops import draw, imgproc
from ..ops.resize import resize_cubic_f32, resize_nearest
from ..utils import image_io
from ..utils.device import resolve_device

# the DejaVu fonts' cap line below the ascender line, per unit of size
# (ascent 1901, cap height 1493, of 2048 units)
_CAP_TOP = (1901 - 1493) / 2048
_CAP_HEIGHT = 1493 / 2048


def _value_noise(rng: np.random.Generator, size: int, cells: int
                 ) -> np.ndarray:
    """Single-octave smooth value noise (bicubic-upsampled grid)."""
    grid = rng.random((cells + 1, cells + 1), np.float32)
    return resize_cubic_f32(grid, (size, size))


def fractal_noise(rng: np.random.Generator, size: int,
                  octaves: int = 4, persistence: float = 0.55) -> np.ndarray:
    """Fractal (fBm) value noise in [0,1]."""
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        cells = min(size // 2, 2 ** (o + 2))
        out += amp * _value_noise(rng, size, cells)
        total += amp
        amp *= persistence
    out /= total
    lo, hi = out.min(), out.max()
    return (out - lo) / max(hi - lo, 1e-6)


def _random_palette(rng: np.random.Generator, n: int = 3) -> np.ndarray:
    base = rng.random(3)
    cols = [base]
    for _ in range(n - 1):
        cols.append(np.clip(base + rng.normal(0, 0.35, 3), 0, 1))
    return np.asarray(cols, np.float32)


def _gradient_layer(rng: np.random.Generator, size: int) -> np.ndarray:
    """Smooth linear or radial colour gradient, (size, size, 3) in [0,1]."""
    c0, c1 = _random_palette(rng, 2)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    if rng.random() < 0.5:
        ang = rng.random() * 2 * np.pi
        t = (np.cos(ang) * xx + np.sin(ang) * yy + 1) / 2
    else:
        cx, cy = rng.random(2)
        t = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        t /= max(t.max(), 1e-6)
    return c0[None, None] * (1 - t[..., None]) + c1[None, None] * t[..., None]


def _draw_shapes(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Antialiased geometric content: ellipses, polygons, thick lines."""
    size = img.shape[0]
    out = (img * 255).astype(np.uint8)
    for _ in range(rng.integers(2, 9)):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        kind = rng.integers(0, 3)
        if kind == 0:
            center = tuple(int(v) for v in rng.integers(0, size, 2))
            axes = tuple(int(v) for v in rng.integers(size // 20, size // 3,
                                                      2))
            imgproc.ellipse_filled_aa(out, center, axes,
                                      float(rng.integers(0, 180)), color)
        elif kind == 1:
            pts = rng.integers(0, size, (rng.integers(3, 7), 2))
            imgproc.fill_poly_aa(out, pts.astype(np.int32), color)
        else:
            p0 = tuple(int(v) for v in rng.integers(0, size, 2))
            p1 = tuple(int(v) for v in rng.integers(0, size, 2))
            imgproc.line_thick_aa(out, p0, p1, color,
                                  int(rng.integers(1, size // 24)))
    return out.astype(np.float32) / 255.0


def synth_clean_image(rng: np.random.Generator, size: int = 512
                      ) -> np.ndarray:
    """One procedural clean image, (size, size, 3) uint8 RGB."""
    style = rng.integers(0, 4)
    base = _gradient_layer(rng, size)
    if style != 1:  # textured background
        noise = fractal_noise(rng, size, octaves=int(rng.integers(3, 6)))
        cols = _random_palette(rng, 2)
        tex = cols[0][None, None] * (1 - noise[..., None]) + \
            cols[1][None, None] * noise[..., None]
        w = rng.uniform(0.25, 0.8)
        base = base * (1 - w) + tex * w
    if style >= 2:  # geometric content on top
        base = _draw_shapes(rng, base)
    if rng.random() < 0.4:  # soft depth-of-field blur
        k = 2 * int(rng.integers(1, 4)) + 1
        base = imgproc.gaussian_blur_f32(base, k)
    if rng.random() < 0.3:  # vignette
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size - 0.5
        v = 1 - np.clip((xx ** 2 + yy ** 2) * rng.uniform(0.4, 1.2), 0, 0.5)
        base = base * v[..., None]
    return (np.clip(base, 0, 1) * 255).astype(np.uint8)


def _grating_layer(rng: np.random.Generator, size: int) -> np.ndarray:
    """Oriented sinusoid grating with noise-distorted phase."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    ang = rng.random() * np.pi
    freq = rng.uniform(12, 80)
    coord = np.cos(ang) * xx + np.sin(ang) * yy
    distort = fractal_noise(rng, size, octaves=3) * rng.uniform(0.0, 0.15)
    wave = np.sin(2 * np.pi * freq * (coord + distort)
                  + rng.random() * 2 * np.pi)
    if rng.random() < 0.4:  # square-ish duty cycle (stripes)
        wave = np.tanh(wave * rng.uniform(2, 8))
    return (wave + 1) / 2


def _cellular_layer(rng: np.random.Generator, size: int) -> np.ndarray:
    """Tile/brick/checker pattern with per-cell value jitter."""
    cells = int(rng.integers(12, 48))
    vals = rng.random((cells, cells), np.float32)
    if rng.random() < 0.5:  # brick offset every other row
        vals[1::2] = np.roll(vals[1::2], 1, axis=1)
    return resize_nearest(torch.from_numpy(vals), (size, size)).numpy()


def _fine_fbm_layer(rng: np.random.Generator, size: int) -> np.ndarray:
    """Full-spectrum fBm: octaves down to 2-4 px features."""
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    octaves = int(np.log2(size)) - 1
    persistence = rng.uniform(0.55, 0.75)
    for o in range(octaves):
        cells = min(size // 2, 2 ** (o + 2))
        out += amp * _value_noise(rng, size, cells)
        total += amp
        amp *= persistence
    out /= total
    lo, hi = out.min(), out.max()
    return (out - lo) / max(hi - lo, 1e-6)


def synth_textured_image(rng: np.random.Generator,
                         size: int = 512) -> np.ndarray:
    """One procedural clean image with natural-image high-frequency
    statistics (fine fBm, gratings, cellular tiles, speckle),
    (size, size, 3) uint8 RGB."""
    base = _gradient_layer(rng, size)
    for _ in range(int(rng.integers(1, 4))):
        kind = rng.integers(0, 3)
        if kind == 0:
            tex = _fine_fbm_layer(rng, size)
        elif kind == 1:
            tex = _grating_layer(rng, size)
        else:
            tex = _cellular_layer(rng, size)
        cols = _random_palette(rng, 2)
        layer = cols[0][None, None] * (1 - tex[..., None]) + \
            cols[1][None, None] * tex[..., None]
        w = rng.uniform(0.35, 0.75)
        base = base * (1 - w) + layer * w
    if rng.random() < 0.5:  # geometric content on top
        base = _draw_shapes(rng, base)
    grain = rng.normal(0, rng.uniform(0.01, 0.05), (size, size, 1))
    base = base + grain.astype(np.float32)
    if rng.random() < 0.2:  # mild blur on a minority only
        base = imgproc.gaussian_blur_f32(base, 3)
    return (np.clip(base, 0, 1) * 255).astype(np.uint8)


def generate_clean_dataset(output_dir: str, count: int = 256,
                           size: int = 512, seed: int = 0,
                           quality: int = 95,
                           texture_ratio: float = 0.0,
                           device="cuda") -> int:
    """Write `count` procedural clean JPEGs synth_{i:05d}.jpg, skipping
    the ones that exist. Image i draws from default_rng(seed * 1_000_003
    + i); with texture_ratio > 0 every round(1 / ratio)-th index comes from
    the textured tier. The JPEG's pixel stage runs on `device`."""
    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    written = 0
    for i in range(count):
        path = os.path.join(output_dir, f"synth_{i:05d}.jpg")
        if os.path.exists(path):
            continue
        rng = np.random.default_rng(seed * 1_000_003 + i)
        if texture_ratio > 0 and (i % max(1, round(1 / texture_ratio))) == 0:
            img = synth_textured_image(rng, size)
        else:
            img = synth_clean_image(rng, size)
        image_io.write_jpeg(path, torch.from_numpy(img).to(device), quality)
        written += 1
    return written


def _blend_text(img: np.ndarray, text: str, xy, font_size: int,
                color) -> None:
    """ImageDraw.text(xy, text, fill=color) with the block font at the
    DejaVu cap height: each channel round((ink m + dst (255 - m)) / 255)
    through the coverage m, clipped to the image."""
    cov = draw.text_coverage(text, _CAP_HEIGHT * font_size)
    m = np.rint(cov * 255).astype(np.int64)[..., None]
    x0 = int(xy[0])
    y0 = int(xy[1]) + int(round(_CAP_TOP * font_size))
    h, w = img.shape[:2]
    ch, cw = min(m.shape[0], h - y0), min(m.shape[1], w - x0)
    if ch <= 0 or cw <= 0:
        return
    m = m[:ch, :cw]
    dst = img[y0:y0 + ch, x0:x0 + cw].astype(np.int64)
    ink = np.asarray(color, np.int64)
    img[y0:y0 + ch, x0:x0 + cw] = (ink * m + dst * (255 - m) + 127) // 255


def synth_logo(rng: np.random.Generator, size: int = 256) -> np.ndarray:
    """One procedural RGBA logo, (size, size, 4) uint8: a ring, a solid
    polygon, crossed bars or letters, and a text strip under it half the
    time (JAX's draws with its DejaVu fonts present)."""
    img = np.zeros((size, size, 4), np.uint8)
    color = tuple(int(c) for c in rng.integers(40, 256, 3)) + (
        int(rng.integers(140, 256)),)
    ink = np.asarray(color, np.uint8)
    kind = rng.integers(0, 4)
    m = size // 5
    if kind == 0:    # ring
        w = int(rng.integers(size // 16, size // 6))
        draw.pil_ellipse(img, [m, m, size - m, size - m], ink, width=w)
    elif kind == 1:  # solid polygon
        n_pts = int(rng.integers(3, 8))
        ang0 = rng.random() * 2 * np.pi
        pts = [(size / 2 + (size / 2 - m) * np.cos(ang0 + 2 * np.pi * i
                                                   / n_pts),
                size / 2 + (size / 2 - m) * np.sin(ang0 + 2 * np.pi * i
                                                   / n_pts))
               for i in range(n_pts)]
        draw.pil_polygon(img, pts, ink)
    elif kind == 2:  # crossed bars
        w = int(rng.integers(size // 12, size // 5))
        draw.pil_rectangle(img, [m, size // 2 - w // 2, size - m,
                                 size // 2 + w // 2], ink)
        draw.pil_rectangle(img, [size // 2 - w // 2, m, size // 2 + w // 2,
                                 size - m], ink)
    else:            # letters
        text = "".join(chr(int(rng.integers(65, 91)))
                       for _ in range(int(rng.integers(2, 4))))
        _blend_text(img, text, (size // 6, size // 4), size // 2, color)
    if rng.random() < 0.5:  # text strip under the emblem
        word = "".join(chr(int(rng.integers(97, 123)))
                       for _ in range(int(rng.integers(4, 9))))
        _blend_text(img, word, (size // 6, size - size // 6), size // 8,
                    color)
    return img


def generate_logo_set(output_dir: str, count: int = 24,
                      size: int = 256, seed: int = 0) -> int:
    """Write `count` RGBA logos logo_{i:03d}.png from default_rng(seed *
    7_000_003 + i), skipping the ones that exist."""
    os.makedirs(output_dir, exist_ok=True)
    written = 0
    for i in range(count):
        path = os.path.join(output_dir, f"logo_{i:03d}.png")
        if os.path.exists(path):
            continue
        rng = np.random.default_rng(seed * 7_000_003 + i)
        image_io.write_png(path, synth_logo(rng, size))
        written += 1
    return written


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description="synthesize clean images/logos")
    p.add_argument("--output", required=True)
    p.add_argument("--count", type=int, default=256)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logos", action="store_true",
                   help="generate RGBA logo assets instead of clean images")
    p.add_argument("--texture-ratio", type=float, default=0.0,
                   help="fraction of images from the high-frequency "
                        "textured tier (0 = the smooth corpus)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the JPEG's pixel stage")
    args = p.parse_args(argv)
    if args.logos:
        n = generate_logo_set(args.output, args.count, args.size, args.seed)
    else:
        n = generate_clean_dataset(args.output, args.count, args.size,
                                   args.seed,
                                   texture_ratio=args.texture_ratio,
                                   device=args.device)
    print(f"wrote {n} images to {args.output}")


if __name__ == "__main__":
    main()
