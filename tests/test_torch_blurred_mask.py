"""The blurred training masks (`train --use-blurred-mask`) of the port's
WatermarkDataset against the JAX package's, and the cv2 functions they
rest on against cv2 5.0.0: ops/contours (findContours with
RETR_EXTERNAL and CHAIN_APPROX_SIMPLE, contourArea, convexHull, arcLength,
approxPolyDP), imgproc.gaussian_blur_u8 (cv2's 8-bit fixed-point
GaussianBlur) and the largest-component rule's tie.

Every comparison is exact: the val-mode masks byte for byte, the contour
functions' points and values, the blur's bytes. Train mode adds noise that
JAX draws from numpy's global generator and the port from a
torch.Generator (a stated difference), so there the moments are held.
"""
import cv2
import numpy as np
import pytest
import torch

from unet_watermark_tpu.data import dataset as jds
from unet_watermark_tpu_torch.data import dataset as tds
from unet_watermark_tpu_torch.ops import components, contours, imgproc
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

torch.set_num_threads(2)

# (height, width) of the generated pairs: square ones take K1, the others
# the plain whole-image chain
SHAPES = [(128, 128), (192, 192), (160, 224), (256, 256), (96, 200),
          (224, 160), (144, 144), (300, 300)]


def _pair(i, h, w):
    s = max(h, w)
    marked, _ = watermarked_images(1, s, seed=20 + i)
    clean, _ = watermarked_images(1, s, seed=20 + i, clean=1)
    u8 = lambda x: np.rint(x[0, :h, :w] * 255).astype(np.uint8)  # noqa
    return u8(marked), u8(clean)


@pytest.fixture(scope="module")
def pairs():
    out = [_pair(i, h, w) for i, (h, w) in enumerate(SHAPES)]
    # scattered specks: no component reaches 500 px (the > 200 px rule)
    a, b = out[0]
    speck = b.copy()
    rng = np.random.default_rng(0)
    for y, x in rng.integers(10, 110, (6, 2)):
        speck[y:y + 16, x:x + 16] = 255 - speck[y:y + 16, x:x + 16]
    out.append((speck, b))
    # a thick U: its hull is far larger than it (the polygon branch)
    _, b = out[3]
    u = b.copy()
    region = np.zeros(b.shape[:2], bool)
    region[28:228, 28:228] = True
    region[28:208, 48:208] = False
    u[region] = np.where(b[region] < 128, 255, 0)
    out.append((u, b))
    out.append((b.copy(), b))  # no difference: an empty mask
    return out


def test_val_masks_equal_jax(pairs, monkeypatch):
    """generate_mask in val mode, at each pair's own size: the port's
    bytes are JAX's. Both contour branches (the hull and the polygon
    approximation) and both morphology routes (K1 for a square mask, the
    plain chain otherwise) run; the specks pair's components are all
    below 500 px (the > 200 px rule)."""
    calls = {"approx": 0, "fill": 0, "k1": 0, "plain": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tds.contours, "approx_poly_dp",
                        counting("approx", contours.approx_poly_dp))
    monkeypatch.setattr(tds.imgproc, "fill_poly",
                        counting("fill", imgproc.fill_poly))
    monkeypatch.setattr(tds, "morph_chain_watermark",
                        counting("k1", tds.morph_chain_watermark))
    monkeypatch.setattr(tds, "morph_chain_plain",
                        counting("plain", tds.morph_chain_plain))
    jd = jds.WatermarkDataset([], mode="val", use_blurred_mask=True)
    td = tds.WatermarkDataset([], mode="val", use_blurred_mask=True,
                              device="cpu")
    soft = 0
    for marked, clean in pairs:
        want = jd.generate_mask(marked, clean)
        got = td.generate_mask(torch.from_numpy(marked),
                               torch.from_numpy(clean)).numpy()
        np.testing.assert_array_equal(got, want)
        soft += int(((want > 0) & (want < 255)).sum())
    assert soft > 0
    assert all(v > 0 for v in calls.values()), calls
    assert calls["fill"] > calls["approx"], calls  # some hulls filled


def test_dataset_items_equal_jax(pairs, tmp_path):
    """WatermarkDataset(use_blurred_mask=True, mode="val") over a folder of
    the pairs: each item (image and mask, resized to IMG_SIZE) is JAX's,
    and the masks cached as PNGs are JAX's bytes."""
    root = tmp_path / "data"
    for sub in ("watermarked", "clean"):
        (root / sub).mkdir(parents=True)
    for i, (marked, clean) in enumerate(pairs):
        for sub, img in (("watermarked", marked), ("clean", clean)):
            cv2.imwrite(str(root / sub / f"p{i:02d}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    kw = dict(img_size=96, mode="val", use_blurred_mask=True)
    jd = jds.WatermarkDataset(str(root / "watermarked"), str(root / "clean"),
                              str(tmp_path / "jmasks"), **kw)
    td = tds.WatermarkDataset(str(root / "watermarked"), str(root / "clean"),
                              str(tmp_path / "tmasks"), device="cpu", **kw)
    assert len(td) == len(jd) == len(pairs)
    for i in range(len(jd)):
        (ji, jm), (ti, tm) = jd[i], td[i]
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)
    for p in sorted((tmp_path / "jmasks").iterdir()):
        assert (tmp_path / "tmasks" / p.name).read_bytes() != b""
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "tmasks" / p.name), 0),
            cv2.imread(str(p), 0))


def test_train_noise_is_clipped_with_jax_moments(pairs):
    """Train mode adds N(0, 5) to the soft mask, clipped to [0, 255] and
    truncated to uint8, as JAX does; the draws differ (torch.Generator
    against numpy's global generator), so the differences to the val mask
    are held to the same moments as JAX's: mean about -0.5 (truncation)
    and spread about 5 inside, about 42 % of the zero pixels raised
    (n >= 1), none above 255."""
    marked, clean = pairs[3]
    val = jds.WatermarkDataset([], mode="val", use_blurred_mask=True) \
        .generate_mask(marked, clean).astype(np.float64)
    np.random.seed(0)
    jtrain = jds.WatermarkDataset([], mode="train", use_blurred_mask=True) \
        .generate_mask(marked, clean).astype(np.float64)
    ttrain = tds.WatermarkDataset([], mode="train", use_blurred_mask=True,
                                  device="cpu").generate_mask(
        torch.from_numpy(marked), torch.from_numpy(clean)).numpy()
    ttrain = ttrain.astype(np.float64)
    inside = (val >= 30) & (val <= 225)
    zero = val == 0
    assert inside.sum() > 2000 and zero.sum() > 2000
    for train in (jtrain, ttrain):
        d = (train - val)[inside]
        assert abs(d.mean() + 0.5) < 0.2, d.mean()
        assert abs(d.std() - 5.0) < 0.3, d.std()
        raised = (train[zero] > 0).mean()
        assert abs(raised - 0.42) < 0.04, raised
        assert train.min() >= 0 and train.max() <= 255
    assert not np.array_equal(ttrain, val)


def _masks(seed, n=40):
    """Random masks of three kinds: noise, dilated specks (blobs with
    holes and touching blobs), filled polygons crossing the edge."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        h, w = (int(v) for v in rng.integers(5, 90, 2))
        kind = t % 3
        if kind == 0:
            m = (rng.random((h, w)) < rng.uniform(0.05, 0.6)) * 255
        elif kind == 1:
            m = (rng.random((h, w)) < 0.02).astype(np.uint8) * 255
            k = int(rng.integers(3, 12))
            m = cv2.dilate(m, cv2.getStructuringElement(
                cv2.MORPH_ELLIPSE, (k, k)))
        else:
            m = np.zeros((h, w), np.uint8)
            for _ in range(int(rng.integers(1, 5))):
                pts = rng.integers(-5, max(h, w) + 5,
                                   (int(rng.integers(3, 8)), 2))
                cv2.fillPoly(m, [pts.astype(np.int32)], 255)
        out.append(np.ascontiguousarray(m, np.uint8))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_contours_equal_cv2(seed):
    """find_external_contours, contour_area, convex_hull, arc_length and
    approx_poly_dp (closed and open, three epsilons) against cv2 on random
    and edge-touching masks: the same contours in the same order, the
    same points, the same values."""
    n_contours = 0
    for m in _masks(seed):
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        got = contours.find_external_contours(m)
        assert len(got) == len(want)
        for g, c in zip(got, want):
            np.testing.assert_array_equal(g, c.reshape(-1, 2))
            n_contours += 1
            assert contours.contour_area(g) == cv2.contourArea(c)
            np.testing.assert_array_equal(contours.convex_hull(g),
                                          cv2.convexHull(c).reshape(-1, 2))
            length = cv2.arcLength(c, True)
            assert contours.arc_length(g, True) == length
            assert contours.arc_length(g, False) == cv2.arcLength(c, False)
            for closed in (True, False):
                for f in (0.015, 0.05, 0.2):
                    np.testing.assert_array_equal(
                        contours.approx_poly_dp(g, f * length, closed),
                        cv2.approxPolyDP(c, f * length, closed).reshape(
                            -1, 2))
    assert n_contours > 100


@pytest.mark.parametrize("seed", range(2))
def test_hull_and_approximation_on_point_sets(seed):
    """convex_hull (on distinct points: cv2's unstable sort may order
    repeated ones either way) and approx_poly_dp (on any) of arbitrary
    integer point sets with collinear runs and few points, as cv2 gives
    them."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(400):
        k = int(rng.integers(1, 14))
        pts = rng.integers(0, int(rng.integers(2, 30)), (k, 2)).astype(
            np.int32)
        if len({tuple(p) for p in pts.tolist()}) == k:  # cv2 sorts
            np.testing.assert_array_equal(contours.convex_hull(pts),
                                          cv2.convexHull(pts).reshape(-1, 2))
        eps = float(rng.uniform(0, 8))
        for closed in (True, False):
            np.testing.assert_array_equal(
                contours.approx_poly_dp(pts, eps, closed),
                cv2.approxPolyDP(pts.reshape(-1, 1, 2), eps,
                                 closed).reshape(-1, 2))


@pytest.mark.parametrize("ksize, sigma", [(15, 5.0), (31, 10.0), (3, 0.8),
                                          (7, 2.0), (21, 3.5)])
def test_gaussian_blur_u8_equals_cv2(ksize, sigma):
    """cv2's 8-bit GaussianBlur (sigma > 0, BORDER_REFLECT_101): the taps
    and the bytes, on masks and on noise, small images included."""
    one = np.zeros((1, 3 * ksize), np.uint8)
    one[0, ksize + ksize // 2] = 255
    seen = cv2.GaussianBlur(one, (ksize, 1), sigma)[0, ksize:2 * ksize]
    taps = imgproc.gaussian_kernel_q8(ksize, sigma)
    assert taps.sum() == 256
    # a 255 impulse through the taps (the column pass's single tap is 256)
    np.testing.assert_array_equal((taps * 255 * 256 + (1 << 15)) >> 16,
                                  seen.astype(np.int64))
    rng = np.random.default_rng(ksize)
    for h, w in ((ksize, ksize + 3), (40, 57), (96, 64)):
        for img in ((rng.random((h, w)) < 0.3).astype(np.uint8) * 255,
                    rng.integers(0, 256, (h, w)).astype(np.uint8)):
            got = imgproc.gaussian_blur_u8(torch.from_numpy(img), ksize,
                                           sigma).numpy()
            np.testing.assert_array_equal(
                got, cv2.GaussianBlur(img, (ksize, ksize), sigma))


def test_largest_component_tie_is_cv2_raster_order():
    """Where two components tie for the largest area, keep_largest_component
    keeps the first in raster order, as np.argmax over cv2's labels
    (numbered by their first pixel in raster order) does in JAX."""
    rng = np.random.default_rng(7)
    for _ in range(30):
        m = np.zeros((64, 64), np.uint8)
        for _ in range(int(rng.integers(2, 5))):
            y, x = rng.integers(0, 44, 2)
            m[y:y + 20, x:x + 25] = 255  # equal areas where apart
        m = np.ascontiguousarray(m)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(m, 8)
        largest = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
        want = labels == largest
        if stats[largest, cv2.CC_STAT_AREA] < 500:
            want = np.isin(labels, [i for i in range(1, n)
                                    if stats[i, cv2.CC_STAT_AREA] > 200])
        got = components.keep_largest_component(
            torch.from_numpy(m > 0).float(), 8, 500, 200).numpy() > 0.5
        np.testing.assert_array_equal(got, want)
