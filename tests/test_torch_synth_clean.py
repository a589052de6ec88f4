"""data/synth_clean.py of the port against the JAX package's, and the
cv2/Pillow operations it runs, each against cv2 5.0 or Pillow 12 directly.

Exact: cv2's LINE_AA drawing (line_aa, line_thick_aa, ellipse_filled_aa,
fill_poly_aa), cv2.GaussianBlur at ksize 3, INTER_NEAREST upsampling,
Pillow's ellipse(width), polygon (convex) and rectangle, the logos'
emblems, and the clean JPEG's bytes (cv2.imwrite's, quality 95).

Stated differences (ROADMAP.md): the cubic resize sums in another order
than cv2 5.0 (at most CUBIC_ULPS float32 ulps of 1.0 apart, measured 2),
the 5- and 7-tap blurs too (BLUR_ULPS, measured 1.5); through fractal
noise and the x255 truncation that moves a uint8 pixel by at most 1 on a
share of the pixels below IMAGE_SHARE at 64² and IMAGE_SHARE_512 at 512²
(measured: 0.0043 and 3.2e-5 over these seeds). The logos' letters and text strip are the block font where JAX
has DejaVu: the port's ink height over JAX's lies in LETTER_RATIO for the
letters (measured 0.78-1.01 over 200 seeds) and STRIP_RATIO for the strip
(0.77-1.33: lower-case DejaVu is shorter or taller than the block
capitals).
"""
import cv2
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import unet_watermark_tpu.data.synth_clean as J
import unet_watermark_tpu_torch.data.synth_clean as P
from unet_watermark_tpu_torch.ops import draw, imgproc
from unet_watermark_tpu_torch.ops.resize import (resize_cubic_f32,
                                                 resize_nearest)
from unet_watermark_tpu_torch.utils import image_io

ULP = float(np.spacing(np.float32(1.0)))  # at 1.0: values lie in [0, 1]
CUBIC_ULPS, BLUR_ULPS = 3, 2
CUBIC_SHARE, BLUR_SHARE = 0.6, 0.5
IMAGE_MAX_DIFF = 1
IMAGE_SHARE, IMAGE_SHARE_512 = 0.005, 1e-4
LETTER_RATIO, STRIP_RATIO = (0.75, 1.05), (0.75, 1.35)
LOGO = 256
STRIP_TOP = 205  # the strip's rows start below every emblem's (size - m)


@pytest.mark.parametrize("fn", ["synth_clean_image", "synth_textured_image"])
@pytest.mark.parametrize("first", range(0, 40, 8))
def test_images_at_64(fn, first):
    for seed in range(first, first + 8):
        a = getattr(J, fn)(np.random.default_rng(seed), 64)
        b = getattr(P, fn)(np.random.default_rng(seed), 64)
        assert a.shape == b.shape == (64, 64, 3) and b.dtype == np.uint8
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= IMAGE_MAX_DIFF, seed
        assert (d > 0).mean() <= IMAGE_SHARE, seed


@pytest.mark.parametrize("fn", ["synth_clean_image", "synth_textured_image"])
@pytest.mark.parametrize("seed", range(3))
def test_images_at_512(fn, seed):
    a = getattr(J, fn)(np.random.default_rng(seed), 512)
    b = getattr(P, fn)(np.random.default_rng(seed), 512)
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= IMAGE_MAX_DIFF
    assert (d > 0).mean() <= IMAGE_SHARE_512


def test_fractal_noise_and_gradient():
    for seed in range(6):
        for size in (64, 128):
            a = J.fractal_noise(np.random.default_rng(seed), size)
            b = P.fractal_noise(np.random.default_rng(seed), size)
            assert np.abs(a - b).max() <= 1e-5
            assert np.array_equal(
                J._gradient_layer(np.random.default_rng(seed), size),
                P._gradient_layer(np.random.default_rng(seed), size))


@pytest.mark.parametrize("cells, size", [(4, 64), (32, 64), (8, 128),
                                         (64, 512)])
def test_resize_cubic_against_cv2(cells, size):
    g = np.random.default_rng(cells).random((cells + 1, cells + 1),
                                             np.float32)
    want = cv2.resize(g, (size, size), interpolation=cv2.INTER_CUBIC)
    got = resize_cubic_f32(g, (size, size))
    d = np.abs(got - want)
    assert got.dtype == np.float32 and got.shape == (size, size)
    assert d.max() <= CUBIC_ULPS * ULP
    assert (d > 0).mean() <= CUBIC_SHARE


def test_resize_nearest_upsampling_equals_cv2():
    for cells in (12, 25, 47):
        v = np.random.default_rng(cells).random((cells, cells), np.float32)
        for size in (64, 512):
            want = cv2.resize(v, (size, size),
                              interpolation=cv2.INTER_NEAREST)
            got = resize_nearest(torch.from_numpy(v), (size, size)).numpy()
            assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_gaussian_blur_against_cv2(k):
    rng = np.random.default_rng(k)
    for shape in ((64, 64, 3), (50, 70)):
        x = rng.random(shape, np.float32)
        want = cv2.GaussianBlur(x, (k, k), 0)
        got = imgproc.gaussian_blur_f32(x, k)
        d = np.abs(got - want)
        if k == 3:
            assert np.array_equal(got, want)
        assert d.max() <= BLUR_ULPS * ULP
        assert (d > 0).mean() <= BLUR_SHARE


@pytest.mark.parametrize("span", [(2, 45), (-10, 60)])
def test_line_aa_equals_cv2(span):
    rng = np.random.default_rng(span[0] + 20)
    for _ in range(120):
        img = rng.integers(0, 256, (48, 56, 3)).astype(np.uint8)
        p0 = tuple(int(v) for v in rng.integers(*span, 2))
        p1 = tuple(int(v) for v in rng.integers(*span, 2))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        want = img.copy()
        cv2.line(want, p0, p1, color, 1, cv2.LINE_AA)
        got = img.copy()
        imgproc.line_thick_aa(got, p0, p1, color, 1)
        assert np.array_equal(got, want), (p0, p1)


@pytest.mark.parametrize("size", [64, 512])
def test_shapes_aa_equal_cv2(size):
    """The three shapes of _draw_shapes with its draws' ranges, over noise
    (the blends read what lies beneath) and crossing the image's edge."""
    rng = np.random.default_rng(size)
    for t in range(90 if size == 64 else 30):
        img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        want, got = img.copy(), img.copy()
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        if t % 3 == 0:
            c = tuple(int(v) for v in rng.integers(0, size, 2))
            ax = tuple(int(v) for v in rng.integers(size // 20, size // 3,
                                                    2))
            ang = float(rng.integers(0, 180))
            cv2.ellipse(want, c, ax, ang, 0, 360, color, -1, cv2.LINE_AA)
            imgproc.ellipse_filled_aa(got, c, ax, ang, color)
        elif t % 3 == 1:
            pts = rng.integers(0, size, (rng.integers(3, 7), 2)).astype(
                np.int32)
            cv2.fillPoly(want, [pts], color, cv2.LINE_AA)
            imgproc.fill_poly_aa(got, pts, color)
        else:
            p0 = tuple(int(v) for v in rng.integers(0, size, 2))
            p1 = tuple(int(v) for v in rng.integers(0, size, 2))
            th = int(rng.integers(1, max(2, size // 24)))
            cv2.line(want, p0, p1, color, th, cv2.LINE_AA)
            imgproc.line_thick_aa(got, p0, p1, color, th)
        assert np.array_equal(got, want), t


def _pil(size, paint):
    img = Image.new("RGBA", (size, size), (0, 0, 0, 0))
    paint(ImageDraw.Draw(img))
    return np.asarray(img)


def test_pil_ellipse_outline_equals_pillow():
    rng = np.random.default_rng(0)
    ink = (10, 200, 30, 180)
    cases = [([51, 51, 205, 205], w) for w in range(1, 64)]
    cases += [([int(x), int(y), int(x + a), int(y + b)], int(w))
              for x, y, a, b, w in zip(*(rng.integers(0, 30, 40),
                                         rng.integers(0, 30, 40),
                                         rng.integers(5, 60, 40),
                                         rng.integers(5, 60, 40),
                                         rng.integers(1, 20, 40)))]
    for box, w in cases:
        want = _pil(100 if box[2] < 100 else LOGO,
                    lambda d: d.ellipse(box, outline=ink, width=w))
        got = np.zeros_like(want)
        draw.pil_ellipse(got, box, np.asarray(ink, np.uint8), width=w)
        assert np.array_equal(got, want), (box, w)


def test_pil_polygon_and_rectangle_equal_pillow():
    rng = np.random.default_rng(1)
    m, ink = LOGO // 5, (5, 6, 7, 200)
    for _ in range(200):
        n = int(rng.integers(3, 8))
        a0 = rng.random() * 2 * np.pi
        pts = [(LOGO / 2 + (LOGO / 2 - m) * np.cos(a0 + 2 * np.pi * i / n),
                LOGO / 2 + (LOGO / 2 - m) * np.sin(a0 + 2 * np.pi * i / n))
               for i in range(n)]
        want = _pil(LOGO, lambda d: d.polygon(pts, fill=ink))
        got = np.zeros_like(want)
        draw.pil_polygon(got, pts, np.asarray(ink, np.uint8))
        assert np.array_equal(got, want)
    for w in range(LOGO // 12, LOGO // 5):
        boxes = ([m, LOGO // 2 - w // 2, LOGO - m, LOGO // 2 + w // 2],
                 [LOGO // 2 - w // 2, m, LOGO // 2 + w // 2, LOGO - m])
        want = _pil(LOGO, lambda d: [d.rectangle(b, fill=ink)
                                     for b in boxes])
        got = np.zeros_like(want)
        for b in boxes:
            draw.pil_rectangle(got, b, np.asarray(ink, np.uint8))
        assert np.array_equal(got, want)


def _ink_height(a, lo, hi):
    rows = np.nonzero((a[lo:hi, :, 3] > 0).any(1))[0]
    return rows.max() - rows.min() + 1 if len(rows) else 0


def _kind(seed):
    rng = np.random.default_rng(seed)
    rng.integers(40, 256, 3)
    rng.integers(140, 256)
    return int(rng.integers(0, 4))


def test_logos_against_jax():
    """Emblems (kinds 0-2) equal JAX's; every logo equal where no text is
    drawn; the letters' and the strip's ink heights within the stated
    ratios."""
    letters, strips = [], []
    for seed in range(120):
        a = J.synth_logo(np.random.default_rng(seed), LOGO)
        b = P.synth_logo(np.random.default_rng(seed), LOGO)
        assert a.shape == b.shape == (LOGO, LOGO, 4)
        kind = _kind(seed)
        if kind < 3:
            assert np.array_equal(a[:STRIP_TOP], b[:STRIP_TOP]), seed
        else:
            letters.append(_ink_height(b, 0, 214) / _ink_height(a, 0, 214))
        ha = _ink_height(a, 214, LOGO)
        if ha:
            strips.append(_ink_height(b, 214, LOGO) / ha)
        elif kind < 3:
            assert np.array_equal(a, b), seed
        assert (b[..., 3] > 0).any()
    assert len(letters) > 20 and len(strips) > 40
    assert LETTER_RATIO[0] <= min(letters) <= max(letters) <= LETTER_RATIO[1]
    assert STRIP_RATIO[0] <= min(strips) <= max(strips) <= STRIP_RATIO[1]


def test_generate_clean_dataset_writes_cv2s_jpeg(tmp_path):
    n = P.generate_clean_dataset(str(tmp_path / "p"), count=5, size=64,
                                 seed=3, texture_ratio=0.5, device="cpu")
    assert n == 5
    assert P.generate_clean_dataset(str(tmp_path / "p"), count=5, size=64,
                                    seed=3, texture_ratio=0.5,
                                    device="cpu") == 0  # resumable
    for i in range(5):
        name = f"synth_{i:05d}.jpg"
        rng = np.random.default_rng(3 * 1_000_003 + i)
        img = (P.synth_textured_image if i % 2 == 0
               else P.synth_clean_image)(rng, 64)
        ok, want = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                                [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert ok and (tmp_path / "p" / name).read_bytes() == want.tobytes()


def test_generate_logo_set_and_main(tmp_path):
    assert P.generate_logo_set(str(tmp_path / "l"), count=6, seed=2) == 6
    for i in range(6):
        got = image_io.decode_png_rgba(
            (tmp_path / "l" / f"logo_{i:03d}.png").read_bytes())
        want = P.synth_logo(np.random.default_rng(2 * 7_000_003 + i))
        assert np.array_equal(got, want)
    P.main(["--output", str(tmp_path / "m"), "--count", "2", "--size",
            "64", "--device", "cpu"])
    P.main(["--output", str(tmp_path / "ml"), "--count", "2", "--logos"])
    assert len(list((tmp_path / "m").iterdir())) == 2
    assert len(list((tmp_path / "ml").iterdir())) == 2
