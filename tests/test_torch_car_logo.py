"""car_logo/ against the JAX package's on the CPU: logo_process (JPEG,
RGBA PNG, palette PNG with tRNS and RGB PNG logos) and LogoPlacer's
batch_process, template matching and compositing, with the inputs written
by cv2 and Pillow at test time.

Tolerances: pixels exactly equal (the JPEGs byte for byte); the template
score within 1e-4 of cv2's (cv2 correlates in float32 through a DFT, the
port in float64), at the same (x, y), and the whole score map within
2e-4 of cv2's. Stated differences: the port's
remove_background_and_resize returns an (S, S, 4) uint8 tensor where JAX
returns a PIL image, its PNGs are its encoder's bytes (the same pixels),
and the homography stage (detect_features, warp_and_place_logo with an
anchor) raises NotImplementedError (ROADMAP.md §A.8)."""
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from unet_watermark_tpu.car_logo import logo_placement as jlp
from unet_watermark_tpu.car_logo import logo_process as jpr
from unet_watermark_tpu_torch import car_logo
from unet_watermark_tpu_torch.car_logo import logo_placement as tlp
from unet_watermark_tpu_torch.car_logo import logo_process as tpr

SCORE_ATOL = 1e-4


def _logos(folder, rng):
    folder.mkdir()
    for i in range(5):
        h, w = (int(v) for v in rng.integers(40, 120, 2))
        img = np.full((h, w, 3), 250, np.uint8)
        colour = tuple(int(v) for v in rng.integers(0, 230, 3))
        cv2.circle(img, (w // 2, h // 2), min(h, w) // 3, colour, -1)
        img[h // 2:h // 2 + 3] = 235  # inside the soft band
        if i == 0:
            cv2.imwrite(str(folder / "l0.jpg"), img)
        elif i == 1:
            a = rng.integers(0, 256, (h, w), dtype=np.uint8)
            Image.fromarray(np.dstack([img[..., ::-1], a]), "RGBA").save(
                folder / "l1.png")
        elif i == 2:
            Image.fromarray(img[..., ::-1]).convert(
                "P", palette=Image.ADAPTIVE, colors=16).save(
                    folder / "l2.png", transparency=3)
        elif i == 3:
            cv2.imwrite(str(folder / "l3.png"), img)
        else:  # all white: nothing to crop to
            cv2.imwrite(str(folder / "l4.png"), np.full((30, 50, 3), 255,
                                                        np.uint8))


@pytest.mark.parametrize("size", [64, 97])
def test_logo_process_equals_jax(tmp_path, size):
    _logos(tmp_path / "in", np.random.default_rng(3))
    nj = jpr.process_folder(str(tmp_path / "in"), str(tmp_path / "j"), size)
    nt = tpr.process_folder(str(tmp_path / "in"), str(tmp_path / "t"), size,
                            device="cpu")
    assert nj == nt == 5
    for name in sorted(os.listdir(tmp_path / "j")):
        a = np.array(Image.open(tmp_path / "j" / name))
        b = np.array(Image.open(tmp_path / "t" / name))
        assert a.shape == b.shape == (size, size, 4)
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_remove_background_returns_a_tensor(tmp_path):
    _logos(tmp_path / "in", np.random.default_rng(5))
    path = str(tmp_path / "in" / "l1.png")
    got = car_logo.remove_background_and_resize(path, size=48, device="cpu")
    want = jpr.remove_background_and_resize(path, size=48)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert isinstance(want, Image.Image)
    np.testing.assert_array_equal(got.numpy(), np.array(want))


def _cars(folder, rng, n=6):
    folder.mkdir()
    for i in range(n):
        car = cv2.GaussianBlur((rng.random((90, 140, 3)) * 255).astype(
            np.uint8), (7, 7), 2)
        ext = ".jpg" if i % 3 == 2 else ".png"
        cv2.imwrite(str(folder / f"c{i}{ext}"), car)
    (folder / "broken.png").write_bytes(b"not an image")


def test_batch_process_equals_jax(tmp_path):
    rng = np.random.default_rng(7)
    _logos(tmp_path / "logos_in", rng)
    jpr.process_folder(str(tmp_path / "logos_in"), str(tmp_path / "logos"),
                       64)
    Image.new("RGB", (30, 20), (10, 200, 30)).save(
        tmp_path / "logos" / "rgb.png")  # a logo without alpha
    _cars(tmp_path / "cars", rng)
    want = jlp.LogoPlacer(seed=5).batch_process(
        str(tmp_path / "cars"), str(tmp_path / "logos"), str(tmp_path / "j"))
    got = tlp.LogoPlacer(seed=5, device="cpu").batch_process(
        str(tmp_path / "cars"), str(tmp_path / "logos"), str(tmp_path / "t"))
    assert got == want and got["random"] == 6 and got["failed"] == 1
    for sub in ("watermarked", "clean", "masks"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert names == sorted(os.listdir(tmp_path / "t" / sub))
        for name in names:
            a, b = tmp_path / "j" / sub / name, tmp_path / "t" / sub / name
            np.testing.assert_array_equal(
                cv2.imread(str(b), cv2.IMREAD_UNCHANGED),
                cv2.imread(str(a), cv2.IMREAD_UNCHANGED), err_msg=name)
            if name.endswith(".jpg"):
                assert a.read_bytes() == b.read_bytes(), name
    masks = [cv2.imread(str(tmp_path / "t" / "masks" / n), 0)
             for n in os.listdir(tmp_path / "t" / "masks")]
    assert sum(m.max() == 255 for m in masks) >= 3


@pytest.mark.parametrize("box", [(20, 30, 30, 40), (5, 5, 20, 20),
                                 (40, 60, 40, 60), (0, 0, 8, 90)])
def test_template_matching_equals_jax(box):
    rng = np.random.default_rng(1)
    target = cv2.GaussianBlur((rng.random((90, 140)) * 255).astype(
        np.uint8), (5, 5), 2)
    y, x, h, w = box
    anchor = target[y:y + h, x:x + w].copy()
    want = jlp.LogoPlacer().template_matching_fallback(target, anchor)
    got = tlp.LogoPlacer(device="cpu").template_matching_fallback(
        torch.from_numpy(target), torch.from_numpy(anchor))
    if want is None:
        assert got is None
        return
    assert got[:2] == want[:2]
    assert abs(got[2] - want[2]) <= SCORE_ATOL


def test_match_template_map_and_flat_rules():
    rng = np.random.default_rng(2)
    img = cv2.GaussianBlur((rng.random((40, 50)) * 255).astype(np.uint8),
                           (5, 5), 2)
    img[:12, :15] = 77  # flat windows: 0
    for t in (img[20:30, 25:40], np.full((6, 6), 9, np.uint8)):
        want = cv2.matchTemplate(img, t, cv2.TM_CCOEFF_NORMED)
        got = tlp.match_template_ccoeff_normed(torch.from_numpy(img),
                                               torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_composite_equals_jax():
    rng = np.random.default_rng(4)
    target = (rng.random((30, 40, 3)) * 255).astype(np.uint8)
    logo = (rng.random((12, 16, 4)) * 255).astype(np.uint8)
    for x, y in ((3, 4), (30, 25), (40, 2)):
        wo, wm = jlp.LogoPlacer._composite(target, logo, x, y)
        to, tm = tlp.LogoPlacer._composite(torch.from_numpy(target),
                                           torch.from_numpy(logo), x, y)
        np.testing.assert_array_equal(to.numpy(), wo)
        np.testing.assert_array_equal(tm.numpy(), wm)


def test_homography_stage_raises():
    placer = tlp.LogoPlacer(device="cpu")
    img = torch.zeros((40, 40, 3), dtype=torch.uint8)
    logo = torch.zeros((8, 8, 4), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="§A.8"):
        placer.detect_features(img[..., 0], img[..., 0])
    with pytest.raises(NotImplementedError, match="§A.8"):
        placer.warp_and_place_logo(img, logo, anchor_rgb=img)
    out, mask, method = placer.warp_and_place_logo(img, logo)
    assert method == "random" and out.shape == img.shape
