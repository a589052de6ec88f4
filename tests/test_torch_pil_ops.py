"""ops/pil.py against Pillow 12 itself, and data/gen_data.py's effects
against the JAX package's on the same draws: equal bytes, no tolerance.

Pillow's C side runs here; the port's ops are torch integer ops (the same
on the card). apply_watermark_effects and _paste_and_mask are held to
JAX's over N_SEEDS seeds each, including the random.Random state each
leaves behind; apply_text_effects given the same RGBA raster.
"""
import random

import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

import unet_watermark_tpu.data.gen_data as J
import unet_watermark_tpu_torch.data.gen_data as P
from unet_watermark_tpu_torch.ops import pil

N_SEEDS = 200


def _t(im):
    return torch.from_numpy(np.array(im.convert("RGBA")))


def _rgba(rng, h, w, clear=0.3):
    a = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    a[..., 3] = np.where(rng.random((h, w)) < clear, 0, a[..., 3])
    return Image.fromarray(a, "RGBA")


ANGLES = [0.0, 90.0, 180.0, 270.0, 359.99, 0.01, 45.0, 200.5, 720.0, -30.0]


@pytest.mark.parametrize("angle", ANGLES + list(
    np.random.default_rng(1).uniform(0, 360, 20)))
def test_rotate_expand(angle):
    rng = np.random.default_rng(int(angle * 1000) % 2**32)
    for h, w in ((1, 1), (2, 9), (7, 13), (40, 31), (64, 100)):
        im = _rgba(rng, h, w)
        ref = np.array(im.rotate(angle, expand=True, fillcolor=(0, 0, 0, 0)))
        assert np.array_equal(ref, pil.rotate_expand(_t(im), angle).numpy())


def test_rotate_float_path():
    """Past 32767 px of corner coordinate Geometry.c leaves fixed point."""
    im = _rgba(np.random.default_rng(2), 2, 47000, clear=0.0)
    ref = np.array(im.rotate(0.3, expand=True, fillcolor=(0, 0, 0, 0)))
    assert np.array_equal(ref, pil.rotate_expand(_t(im), 0.3).numpy())


SIZES = [(1, 1), (2, 3), (8, 8), (13, 40), (200, 17), (5, 1), (1, 6)]


@pytest.mark.parametrize("src", [(7, 13), (40, 31), (64, 100), (3, 1),
                                 (100, 3), (300, 500)])
def test_resize_lanczos(src):
    rng = np.random.default_rng(src[0] * 1000 + src[1])
    h, w = src
    im = _rgba(rng, h, w)
    for size in SIZES + [(w * 2, h), (w, h * 3), (w, h)]:
        ref = np.array(im.resize(size, Image.LANCZOS))
        assert np.array_equal(ref, pil.resize_lanczos(_t(im), size).numpy()), \
            size


@pytest.mark.parametrize("radius", [0.5, 0.51, 0.7, 0.99, 1.0, 1.23, 1.37,
                                    1.5, 2.0, 3.7])
def test_gaussian_blur(radius):
    rng = np.random.default_rng(int(radius * 100))
    for h, w in ((1, 5), (2, 2), (7, 13), (40, 31)):
        im = _rgba(rng, h, w)
        ref = np.array(im.filter(ImageFilter.GaussianBlur(radius)))
        assert np.array_equal(ref, pil.gaussian_blur(_t(im), radius).numpy())


def test_alpha_composite_at_and_across_edges():
    rng = np.random.default_rng(3)
    for _ in range(60):
        H, W = rng.integers(5, 60, 2)
        h, w = rng.integers(1, 80, 2)
        canvas, im = _rgba(rng, H, W), _rgba(rng, h, w)
        x, y = int(rng.integers(0, W + 3)), int(rng.integers(0, H + 3))
        got = _t(canvas).clone()
        canvas.alpha_composite(im, dest=(x, y))
        pil.alpha_composite(got, _t(im), (x, y))
        assert np.array_equal(np.array(canvas), got.numpy()), (x, y)


def test_premultiply_round_trip_and_rgb():
    a = np.stack(np.meshgrid(np.arange(256), np.arange(256)), -1)
    px = np.zeros((256, 256, 4), np.uint8)
    px[..., 0] = px[..., 1] = px[..., 2] = a[..., 0]
    px[..., 3] = a[..., 1]
    im = Image.fromarray(px, "RGBA")
    pre = pil.premultiply(_t(im))
    assert np.array_equal(np.array(im.convert("RGBa")), pre.numpy())
    back = Image.fromarray(pre.numpy(), "RGBa").convert("RGBA")
    assert np.array_equal(np.array(back), pil.unpremultiply(pre).numpy())
    assert np.array_equal(np.array(im.convert("RGB")),
                          pil.to_rgb(_t(im)).numpy())


@pytest.fixture(scope="module")
def logos():
    rng = np.random.default_rng(4)
    lg = np.zeros((40, 60, 4), np.uint8)
    yy, xx = np.mgrid[0:40, 0:60]
    ring = np.abs(np.hypot(yy - 20, xx - 30) - 14) < 4
    lg[ring] = (250, 240, 10, 255)
    lg[np.abs(yy - 20) < 3] = (10, 10, 200, 128)
    pal = Image.fromarray(rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)
                          ).quantize(8)
    pal.info["transparency"] = bytes([0, 255, 128, 64, 255, 255, 0, 200])
    return [Image.fromarray(lg, "RGBA"), pal.convert("RGBA"),
            _rgba(rng, 9, 120)]


def test_watermark_effects_over_seeds(logos):
    for seed in range(N_SEEDS):
        logo = logos[seed % len(logos)]
        target = (None, (320, 240), (96, 128), (40, 30))[seed % 4]
        transparent = bool(seed % 3)
        rj, rp = random.Random(seed), random.Random(seed)
        ref = J.apply_watermark_effects(logo, transparent, target, rj)
        got = P.apply_watermark_effects(_t(logo), transparent, target, rp)
        assert np.array_equal(np.array(ref), got.numpy()), seed
        assert rj.getstate() == rp.getstate(), seed


def test_paste_and_mask_over_seeds(logos):
    rng = np.random.default_rng(5)
    for seed in range(N_SEEDS):
        H, W = rng.integers(20, 90, 2)
        canvas = _rgba(rng, H, W, clear=0.1)
        rj, rp = random.Random(seed), random.Random(seed)
        wm = J.apply_watermark_effects(logos[seed % 3], True, (W, H), rj)
        wm_t = P.apply_watermark_effects(_t(logos[seed % 3]), True, (W, H),
                                         rp)
        pos_j = J._random_pos(rj, (W, H), wm.size)
        pos_p = P._random_pos(rp, (W, H), (wm_t.shape[1], wm_t.shape[0]))
        if seed % 5 == 0:  # across the right and bottom edges
            pos_j = pos_p = (int(W) - 3, int(H) - 2)
        assert pos_j == pos_p
        mj = np.zeros((H, W), bool)
        mp = torch.zeros(int(H), int(W), dtype=torch.bool)
        cj, cp = canvas.copy(), _t(canvas).clone()
        J._paste_and_mask(cj, wm, pos_j, mj)
        P._paste_and_mask(cp, wm_t, pos_p, mp)
        assert np.array_equal(np.array(cj), cp.numpy()), seed
        assert np.array_equal(mj, mp.numpy()), seed
        assert rj.getstate() == rp.getstate(), seed


@pytest.mark.parametrize("seed", range(12))
def test_text_effects_given_the_raster(seed):
    raster = np.zeros((30 + seed, 90 + 7 * seed, 4), np.uint8)
    raster[4:-4, 4:-4] = (255, 0, 0, 255)
    raster[8:-8:3, 6:-6:4, 3] = 40
    im = Image.fromarray(raster, "RGBA")
    rj, rp = random.Random(seed), random.Random(seed)
    ref = J.apply_text_effects(im, bool(seed % 2), rj)
    got = P.apply_text_effects(_t(im), bool(seed % 2), rp)
    assert np.array_equal(np.array(ref), got.numpy())
    assert rj.getstate() == rp.getstate()
