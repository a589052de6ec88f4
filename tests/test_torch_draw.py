"""ops/draw.py against cv2 5.0.0, the drawing of the comparison videos.

cv2 5.0 draws FONT_HERSHEY_SIMPLEX from an embedded outline font through
its own antialiasing rasterizer (not drawing.cpp's Hershey strokes of
cv2 4), so the port carries that raster for the labels the video
generator draws (ops/draw.LABELS). These tests render each label with cv2
at test time and hold the port's put_text and get_text_size to it, pixel
for pixel, at several origins and over clipped edges; any other string is
drawn by the port's block font and is not cv2's (ROADMAP.md §A.5).
"""
import cv2
import numpy as np
import pytest
import torch

from unet_watermark_tpu_torch.ops import draw

FONT = cv2.FONT_HERSHEY_SIMPLEX


@pytest.mark.parametrize("key", sorted(draw.LABELS))
def test_labels_equal_cv2(key):
    text, scale, thickness = key
    assert draw.get_text_size(text, scale, thickness) == \
        cv2.getTextSize(text, FONT, scale, thickness)
    # the overlay's scales as the video generator computes them
    for org in ((30, 50), (3, 12), (-5, 40), (180, 70)):
        img = np.zeros((90, 220, 3), np.uint8)
        cv2.putText(img, text, org, FONT, scale, (255, 255, 255), thickness,
                    cv2.LINE_AA)
        got = torch.zeros(90, 220, 3, dtype=torch.uint8)
        draw.put_text(got, text, org, scale, (255, 255, 255), thickness)
        assert np.array_equal(img, got.numpy()), (key, org)


def test_label_scales_are_the_generators():
    for width in (426, 640, 960, 1280, 1920):
        scale = max(width / 1920.0, 0.5) * 1.2
        thickness = max(int(2 * scale), 1)
        if (round(scale, 6), thickness) in {(k[1], k[2])
                                            for k in draw.LABELS}:
            assert draw._label("Mask", scale, thickness) is not None


@pytest.mark.parametrize("p1,p2", [((10, 5), (40, 30)), ((40, 30), (10, 5)),
                                   ((-10, -4), (12, 9)), ((50, 20),
                                                          (90, 70)),
                                   ((3, 3), (3, 3)), ((70, 2), (80, 9))])
def test_filled_rectangle_equals_cv2(p1, p2):
    img = np.full((48, 64, 3), 77, np.uint8)
    got = torch.from_numpy(img.copy())
    cv2.rectangle(img, p1, p2, (1, 2, 3), -1)
    draw.rectangle_filled(got, p1, p2, (1, 2, 3))
    assert np.array_equal(img, got.numpy())


def test_colormap_hot_equals_cv2():
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    ref = cv2.applyColorMap(gray, cv2.COLORMAP_HOT)
    got = draw.apply_colormap_hot(torch.from_numpy(gray)).numpy()
    assert np.array_equal(ref, got)


def test_block_font_raster():
    """gen_data's raster: the cap height it is asked for, 4 px of margin,
    PIL's mask painting (ink * m + 127) // 255 on every channel."""
    r = draw.text_raster("SAMPLE 12", 33.5, (255, 0, 0), "cpu").numpy()
    a = r[..., 3]
    ys, xs = np.nonzero(a)
    assert ys.min() == 4 and xs.min() == 4
    assert ys.max() + 1 + 4 == r.shape[0] and xs.max() + 1 + 4 == r.shape[1]
    assert abs((ys.max() - ys.min() + 1) - 33.5) <= 1
    full = a == 255
    assert full.any() and (r[full][:, :3] == (255, 0, 0)).all()
    part = (a > 0) & (a < 255)
    assert part.any()  # antialiased edges
    assert np.array_equal(r[part][:, 0],
                          (255 * a[part].astype(int) + 127) // 255)
    # lower case takes the capitals' glyphs; unknown characters are blank
    assert np.array_equal(draw.text_coverage("abc", 14),
                          draw.text_coverage("ABC", 14))
    assert not draw.text_coverage("~", 14).any()
