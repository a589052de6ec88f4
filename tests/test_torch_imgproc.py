"""ops/imgproc.py, the port's cv2-parity image ops, against cv2 5.0.0 itself,
bit for bit, on seeded inputs: odd sizes, 1 x N and N x 1, sizes that are
not multiples of the CLAHE grid, flat and two-level images, rings with
blobs inside, shapes touching every border, rotated and concave quads,
and quads that cross the image's edge (test_fill_poly_crossing_the_edge)."""
import cv2
import numpy as np
import pytest
import torch

from unet_watermark_tpu_torch.ops import imgproc as ip

SHAPES = [(1, 1), (1, 17), (17, 1), (2, 2), (5, 7), (8, 9), (9, 8),
          (16, 16), (33, 41), (64, 48), (100, 37), (120, 160)]
ELEMENTS = {
    "ellipse3": cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3)),
    "rect9x3": cv2.getStructuringElement(cv2.MORPH_RECT, (9, 3)),
    "ellipse2": cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2, 2)),
    "ellipse5": cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5)),
}


def _images(seed, h, w):
    """Noise, a wrapped gradient with noise, a flat image, a two-level
    image, and a scene with cv2-drawn text over a smooth background."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    two = np.where(rng.random((h, w)) < 0.3, 40, 200).astype(np.uint8)
    grad = ((yy * 7 + xx * 3) % 256 + rng.integers(0, 20, (h, w)))
    return {"noise": rng.integers(0, 256, (h, w), dtype=np.uint8),
            "gradient": grad.clip(0, 255).astype(np.uint8),
            "flat": np.full((h, w), 77, np.uint8),
            "two_level": two,
            "scene": _scene(rng, h, w)}


def _scene(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (np.sin(yy / rng.uniform(5, 40)) * 60
            + np.cos(xx / rng.uniform(5, 40)) * 60 + 128)
    img = (base + rng.normal(0, 6, (h, w))).clip(0, 255).astype(np.uint8)
    for _ in range(3):
        org = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        cv2.putText(img, "Sample 42", org, cv2.FONT_HERSHEY_SIMPLEX,
                    rng.uniform(0.3, 1.5), int(rng.integers(0, 256)),
                    int(rng.integers(1, 4)))
    return img


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_gray_equals_cv2_on_every_red_green_pair():
    """Every (R, G) pair with 16 blue values, both channel orders."""
    v = np.arange(256)
    blues = np.random.default_rng(0).choice(256, 16, replace=False)
    r, g, b = np.meshgrid(v, v, blues, indexing="ij")
    rgb = np.stack([r, g, b], -1).reshape(1024, 1024, 3).astype(np.uint8)
    np.testing.assert_array_equal(ip.gray_u8(_t(rgb), "rgb").numpy(),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(ip.gray_u8(_t(rgb), "bgr").numpy(),
                                  cv2.cvtColor(rgb, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_morphology_equals_cv2(shape):
    for img in _images(sum(shape), *shape).values():
        for k in ELEMENTS.values():
            np.testing.assert_array_equal(ip.grey_dilate(_t(img), k).numpy(),
                                          cv2.dilate(img, k))
            np.testing.assert_array_equal(ip.grey_erode(_t(img), k).numpy(),
                                          cv2.erode(img, k))
            np.testing.assert_array_equal(
                ip.morph_close(_t(img), k).numpy(),
                cv2.morphologyEx(img, cv2.MORPH_CLOSE, k))
            np.testing.assert_array_equal(
                ip.morph_gradient(_t(img), k).numpy(),
                cv2.morphologyEx(img, cv2.MORPH_GRADIENT, k))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_otsu_equals_cv2(shape):
    """Threshold and binary image; the flat image (every class split empty:
    t = 0) and the two-level one (a plateau of equal variances, where the
    first maximum wins) among the inputs."""
    for name, img in _images(sum(shape) + 1, *shape).items():
        t, ref = cv2.threshold(img, 0, 255,
                               cv2.THRESH_BINARY | cv2.THRESH_OTSU)
        got_t, got = ip.otsu_threshold(_t(img))
        assert got_t == int(t), name
        np.testing.assert_array_equal(got.numpy(), ref)
    flat = np.full(shape, 77, np.uint8)
    assert ip.otsu_value(_t(flat)) == 0
    if flat.size > 1:
        two = np.full(shape, 40, np.uint8)
        two.reshape(-1)[::2] = 200
        t, _ = cv2.threshold(two, 0, 255, cv2.THRESH_BINARY | cv2.THRESH_OTSU)
        assert ip.otsu_value(_t(two)) == int(t) == 40


def _cv2_boxes(binary):
    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    return [tuple(cv2.boundingRect(c)) for c in contours]


def _shapes_image():
    """Rings with blobs inside (cv2 leaves the inner ones out), a ring with a
    4-connected gap (its blob is outside) and one with a diagonal gap only
    (its blob stays inside), nested rings, shapes touching each border and
    each corner, and pixels joined only diagonally."""
    a = np.zeros((60, 80), np.uint8)
    cv2.rectangle(a, (4, 4), (20, 20), 255, 1)
    a[11:13, 11:13] = 255
    cv2.rectangle(a, (25, 4), (41, 20), 255, 3)
    a[12, 33] = 255
    cv2.rectangle(a, (45, 4), (55, 14), 255, 1)
    a[4, 50] = 0  # gap on the 4-connected path: the blob is outside
    a[9, 50] = 255
    cv2.rectangle(a, (60, 4), (70, 14), 255, 1)
    a[4, 60] = 0  # a corner gap leaves the hole closed to 4-paths
    a[9, 65] = 255
    cv2.rectangle(a, (2, 25), (40, 55), 255, 1)
    cv2.rectangle(a, (8, 30), (34, 50), 255, 1)
    a[40, 20] = 255
    a[0, 44:50] = a[59, 10:12] = a[30:33, 0] = a[20:22, 79] = 255
    a[0, 0] = a[0, 79] = a[59, 0] = a[59, 79] = 255
    a[45, 60] = a[46, 61] = a[47, 62] = a[45, 70] = 255
    return a


def test_external_boxes_equal_cv2_on_shapes():
    img = _shapes_image()
    got = ip.external_boxes(_t(img))
    assert got == _cv2_boxes(img)
    inner = (11, 11, 2, 2)  # the blob inside the first ring
    assert inner not in got and (50, 9, 1, 1) in got
    assert (65, 9, 1, 1) not in got
    full = np.full((5, 7), 255, np.uint8)
    assert ip.external_boxes(_t(full)) == _cv2_boxes(full) == [(0, 0, 7, 5)]
    for row in ([0, 255, 255, 0, 255], [255]):
        one = np.array([row], np.uint8)
        assert ip.external_boxes(_t(one)) == _cv2_boxes(one)
        assert ip.external_boxes(_t(one.T.copy())) == _cv2_boxes(one.T.copy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_external_boxes_equal_cv2_in_order(shape):
    """Random masks of three densities, and the detector's own input (the
    closed Otsu edges of a scene): the same boxes in cv2's list order."""
    rng = np.random.default_rng(sum(shape) + 2)
    for p in (0.05, 0.3, 0.6):
        bw = ((rng.random(shape) < p) * 255).astype(np.uint8)
        assert ip.external_boxes(_t(bw)) == _cv2_boxes(bw)
    scene = _scene(rng, *shape)
    grad = cv2.morphologyEx(scene, cv2.MORPH_GRADIENT, ELEMENTS["ellipse3"])
    _, bw = cv2.threshold(grad, 0, 255, cv2.THRESH_BINARY | cv2.THRESH_OTSU)
    joined = cv2.morphologyEx(bw, cv2.MORPH_CLOSE, ELEMENTS["rect9x3"])
    assert ip.external_boxes(_t(joined)) == _cv2_boxes(joined)


@pytest.mark.parametrize("shape", SHAPES + [(135, 240), (257, 311)],
                         ids=str)
def test_clahe_equals_cv2(shape):
    """Sizes that are and are not multiples of the 8 x 8 grid (cv2 pads
    both sides unless both divide); no exception: 0 pixels differ."""
    for img in _images(sum(shape) + 3, *shape).values():
        np.testing.assert_array_equal(
            ip.clahe(_t(img)).numpy(),
            cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(img))


@pytest.mark.parametrize("clip", [0.0, 1.0, 4.0, 40.0])
def test_clahe_parameters_equal_cv2(clip):
    rng = np.random.default_rng(int(clip))
    img = _scene(rng, 97, 131)
    for grid in ((8, 8), (3, 5), (1, 1), (16, 4)):
        np.testing.assert_array_equal(
            ip.clahe(_t(img), clip, grid).numpy(),
            cv2.createCLAHE(clipLimit=clip, tileGridSize=grid).apply(img))


@pytest.mark.parametrize("shape", SHAPES + [(135, 240), (270, 480)],
                         ids=str)
def test_canny_equals_cv2(shape):
    """On the images, and on the CLAHE output _enhance_text_features feeds
    it; thresholds 50 / 150 and one swapped pair."""
    for img in _images(sum(shape) + 4, *shape).values():
        for src in (img, cv2.createCLAHE(2.0, (8, 8)).apply(img)):
            np.testing.assert_array_equal(ip.canny(_t(src), 50, 150).numpy(),
                                          cv2.Canny(src, 50, 150))
        np.testing.assert_array_equal(ip.canny(_t(img), 120, 30).numpy(),
                                      cv2.Canny(img, 120, 30))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_filter2d_equals_cv2(shape):
    rng = np.random.default_rng(sum(shape) + 5)
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(ip.filter2d_u8(_t(rgb), ip.SHARPEN).numpy(),
                                  cv2.filter2D(rgb, -1, ip.SHARPEN))
    for img in _images(sum(shape), *shape).values():
        np.testing.assert_array_equal(
            ip.filter2d_u8(_t(img), ip.SHARPEN).numpy(),
            cv2.filter2D(img, -1, ip.SHARPEN))
    box = np.ones((3, 5), np.float32)
    np.testing.assert_array_equal(ip.filter2d_u8(_t(rgb), box).numpy(),
                                  cv2.filter2D(rgb, -1, box))


def test_fill_rect_equals_cv2():
    rng = np.random.default_rng(6)
    for _ in range(500):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        x, y = (int(v) for v in rng.integers(-10, max(h, w) + 5, 2))
        bw, bh = (int(v) for v in rng.integers(0, 40, 2))
        got = np.zeros((h, w), np.uint8)
        ref = got.copy()
        ip.fill_rect(got, x, y, bw, bh)
        cv2.rectangle(ref, (x, y), (x + bw, y + bh), 255, -1)
        np.testing.assert_array_equal(got, ref)


def _quads(rng, n, h, w):
    """Rotated rectangles, and concave quads (one corner pulled inward),
    with every corner inside an (h, w) image."""
    out = []
    while len(out) < n:
        c = rng.uniform(0, [w, h])
        a = rng.uniform(0, np.pi)
        half = rng.uniform(1, 30, 2)
        d1 = np.array([np.cos(a), np.sin(a)]) * half[0]
        d2 = np.array([-np.sin(a), np.cos(a)]) * half[1]
        pts = np.array([c - d1 - d2, c + d1 - d2, c + d1 + d2, c - d1 + d2])
        if len(out) % 2:
            pts[2] = (pts[0] + pts[2]) / 2 + rng.uniform(-3, 3, 2)
        pts = np.rint(pts).astype(np.int32)
        if ((pts >= 0) & (pts < [w, h])).all():
            out.append(pts)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fill_poly_equals_cv2(seed):
    """Rotated and concave quads, and random 3-6 point polygons, all inside
    the image: equal, no exception."""
    rng = np.random.default_rng(seed)
    polys = _quads(rng, 300, 70, 90)
    for _ in range(300):
        k = int(rng.integers(3, 7))
        polys.append(np.stack([rng.integers(0, 90, k),
                               rng.integers(0, 70, k)], 1).astype(np.int32))
    for pts in polys:
        got = np.zeros((70, 90), np.uint8)
        ref = got.copy()
        ip.fill_poly(got, pts)
        cv2.fillPoly(ref, [pts], 255)
        np.testing.assert_array_equal(got, ref, err_msg=str(pts.tolist()))


# Random quads with corners up to 8 px beyond the edges of a 1-59 px image
# (seed 7) that cross the image's edge: every mask equals cv2 5.0's.
FILL_POLY_CROSSING_N = 2000


def test_fill_poly_crossing_the_edge():
    rng = np.random.default_rng(7)
    n = differ = 0
    while n < FILL_POLY_CROSSING_N:
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        pts = np.stack([rng.integers(-8, w + 8, 4),
                        rng.integers(-8, h + 8, 4)], 1).astype(np.int32)
        if ((pts >= 0) & (pts < [w, h])).all():
            continue
        n += 1
        got = np.zeros((h, w), np.uint8)
        ref = got.copy()
        ip.fill_poly(got, pts)
        cv2.fillPoly(ref, [pts], 255)
        differ += not np.array_equal(got, ref)
    assert differ == 0


def test_wrong_inputs_raise():
    with pytest.raises(TypeError):
        ip.gray_u8(torch.zeros(4, 4, 3))
    with pytest.raises(TypeError):
        ip.canny(torch.zeros(4, 4, 3, dtype=torch.uint8), 50, 150)
    with pytest.raises(ValueError):
        ip.gray_u8(torch.zeros(4, 4, 3, dtype=torch.uint8), "rbg")
