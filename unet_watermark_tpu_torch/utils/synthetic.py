"""Synthetic watermarked images, made with numpy from a seed (no PIL/cv2).

Each image is a smooth colour gradient with mild noise, with a
semi-transparent logo blended over it: a thin ring with a bar through it,
white or black, of 12-40 px radius (a watermark's size, whatever the image
size) at a random place. The last `clean` images carry no logo, as a
folder of user images holds some that have none. text_images draws lines
of block capitals from a 5x7 bitmap font over such images, as a text
watermark lies over a photo, and returns each line's box and the pixels
its glyphs cover. Used by
chip_smoke.py and the tests.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# 5x7 glyphs, rows top to bottom, "#" ink
FONT = {
    "A": ".###./#...#/#...#/#####/#...#/#...#/#...#",
    "B": "####./#...#/#...#/####./#...#/#...#/####.",
    "C": ".###./#...#/#..../#..../#..../#...#/.###.",
    "D": "####./#...#/#...#/#...#/#...#/#...#/####.",
    "E": "#####/#..../#..../####./#..../#..../#####",
    "F": "#####/#..../#..../####./#..../#..../#....",
    "G": ".###./#...#/#..../#.###/#...#/#...#/.####",
    "H": "#...#/#...#/#...#/#####/#...#/#...#/#...#",
    "I": ".###./..#../..#../..#../..#../..#../.###.",
    "J": "..###/...#./...#./...#./...#./#..#./.##..",
    "K": "#...#/#..#./#.#../##.../#.#../#..#./#...#",
    "L": "#..../#..../#..../#..../#..../#..../#####",
    "M": "#...#/##.##/#.#.#/#.#.#/#...#/#...#/#...#",
    "N": "#...#/#...#/##..#/#.#.#/#..##/#...#/#...#",
    "O": ".###./#...#/#...#/#...#/#...#/#...#/.###.",
    "P": "####./#...#/#...#/####./#..../#..../#....",
    "Q": ".###./#...#/#...#/#...#/#.#.#/#..#./.##.#",
    "R": "####./#...#/#...#/####./#.#../#..#./#...#",
    "S": ".####/#..../#..../.###./....#/....#/####.",
    "T": "#####/..#../..#../..#../..#../..#../..#..",
    "U": "#...#/#...#/#...#/#...#/#...#/#...#/.###.",
    "V": "#...#/#...#/#...#/#...#/#...#/.#.#./..#..",
    "W": "#...#/#...#/#...#/#.#.#/#.#.#/#.#.#/.#.#.",
    "X": "#...#/#...#/.#.#./..#../.#.#./#...#/#...#",
    "Y": "#...#/#...#/.#.#./..#../..#../..#../..#..",
    "Z": "#####/....#/...#./..#../.#.../#..../#####",
    "0": ".###./#...#/#..##/#.#.#/##..#/#...#/.###.",
    "1": "..#../.##../..#../..#../..#../..#../.###.",
    "2": ".###./#...#/....#/...#./..#../.#.../#####",
    "3": "#####/...#./..#../...#./....#/#...#/.###.",
    "4": "...#./..##./.#.#./#..#./#####/...#./...#.",
    "5": "#####/#..../####./....#/....#/#...#/.###.",
    "6": "..##./.#.../#..../####./#...#/#...#/.###.",
    "7": "#####/....#/...#./..#../.#.../.#.../.#...",
    "8": ".###./#...#/#...#/.###./#...#/#...#/.###.",
    "9": ".###./#...#/#...#/.####/....#/...#./.##..",
    " ": "...../...../...../...../...../...../.....",
}
WORDS = ("SAMPLE", "PREVIEW", "STOCK PHOTO", "COPYRIGHT 2026", "DRAFT",
         "DO NOT COPY", "WATERMARK", "PROOF COPY")


def watermarked_images(n: int, size: int, seed: int = 0, clean: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(images (n, size, size, 3) float32 in [0, 1], logo masks (n, size,
    size) float32 {0, 1}). The first n - clean images are those of
    clean = 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    images = np.empty((n, size, size, 3), np.float32)
    logos = np.empty((n, size, size), np.float32)
    for i in range(n):
        c0, c1, c2 = rng.random((3, 3)).astype(np.float32)
        base = (c0 + (c1 - c0) * yy[..., None] + (c2 - c0) * xx[..., None]) / 2
        base += rng.normal(0, 0.02, base.shape).astype(np.float32)
        r = rng.uniform(12, min(40, size / 3))
        cy, cx = rng.uniform(r + 2, size - r - 2, 2)
        d = np.hypot(yy * size - cy, xx * size - cx)
        ring = np.abs(d - 0.8 * r) < 0.15 * r
        bar = (np.abs(yy * size - cy) < 0.12 * r) & (d < r)
        logo = (ring | bar) & (i < n - clean)
        ink = np.float32(rng.integers(0, 2))
        alpha = np.float32(rng.uniform(0.45, 0.7))
        img = np.where(logo[..., None], (1 - alpha) * base + alpha * ink, base)
        images[i] = np.clip(img, 0.0, 1.0)
        logos[i] = logo
    return images, logos


def glyph_mask(text: str, scale: int) -> np.ndarray:
    """(7 * scale, (6 * len(text) - 1) * scale) bool ink of a line: 5x7
    glyphs one column apart, each font pixel a scale x scale block."""
    cols = []
    for i, ch in enumerate(text.upper()):
        rows = [[c == "#" for c in r] for r in FONT[ch].split("/")]
        if i:
            cols.append(np.zeros((7, 1), bool))
        cols.append(np.array(rows, bool))
    ink = np.concatenate(cols, axis=1)
    return np.kron(ink, np.ones((scale, scale), bool))


def draw_text(img: np.ndarray, text: str, x: int, y: int, scale: int,
              color: Sequence[int], alpha: float = 1.0
              ) -> Tuple[int, int, int, int]:
    """Blend a line of block capitals into an (H, W, 3) uint8 image in
    place, its top-left corner at (x, y); returns the line's box (x, y, w,
    h), which must lie inside the image."""
    ink = glyph_mask(text, scale)
    h, w = ink.shape
    if x < 0 or y < 0 or y + h > img.shape[0] or x + w > img.shape[1]:
        raise ValueError(f"line {text!r} at ({x}, {y}) leaves the image")
    region = img[y:y + h, x:x + w].astype(np.float32)
    blend = (1 - alpha) * region + alpha * np.asarray(color, np.float32)
    img[y:y + h, x:x + w] = np.where(ink[..., None], np.rint(blend),
                                     region).astype(np.uint8)
    return x, y, w, h


def text_images(shapes: Sequence[Tuple[int, int]], seed: int = 0,
                logo: Sequence[bool] = ()
                ) -> Tuple[List[np.ndarray], List[List[Tuple[int, ...]]],
                           List[np.ndarray]]:
    """One (h, w, 3) uint8 image for each shape: a watermarked_images
    background (with its logo where `logo[i]` is true, else clean), cut to
    the shape, with one or two lines of text from WORDS drawn over it at
    random places (the words that fit the width), white on a dark place and
    black on a light one, 80-95 % opaque, glyph pixels of min(h // 100 + 2,
    6) px. Returns (images, each image's line boxes, each image's (h, w)
    bool mask of the glyph pixels drawn)."""
    rng = np.random.default_rng(seed)
    images, boxes, inks = [], [], []
    for i, (h, w) in enumerate(shapes):
        side = max(h, w)
        bg, _ = watermarked_images(1, side, seed=seed + 100 + i,
                                   clean=0 if i < len(logo) and logo[i]
                                   else 1)
        y0, x0 = (side - h) // 2, (side - w) // 2
        img = (bg[0, y0:y0 + h, x0:x0 + w] * 255).astype(np.uint8)
        # letters one glyph pixel apart, at most 6 px: the builtin text
        # detector's 9x3 closing joins them into a line
        scale = min(h // 100 + 2, 6)
        lines = []
        drawn = np.zeros((h, w), bool)
        band = h // 2  # one line in each half, so that they do not touch
        for k in range(int(rng.integers(1, 3))):
            fits = [t for t in WORDS if (6 * len(t) - 1) * scale < w]
            text = fits[int(rng.integers(len(fits)))]
            lw, lh = (6 * len(text) - 1) * scale, 7 * scale
            x = int(rng.integers(0, w - lw))
            y = int(rng.integers(k * band, (k + 1) * band - lh))
            dark = img[y:y + lh, x:x + lw].mean() < 128
            ink = (255, 255, 255) if dark else (0, 0, 0)
            lines.append(draw_text(img, text, x, y, scale, ink,
                                   float(rng.uniform(0.8, 0.95))))
            drawn[y:y + lh, x:x + lw] |= glyph_mask(text, scale)
        images.append(img)
        boxes.append(lines)
        inks.append(drawn)
    return images, boxes, inks
