"""scripts/method_compare.py against the JAX package's, on the CPU: the five
predict_mask variants with the default configuration's UNet++/resnet34
shipped weights carried across (float32, IMG_SIZE 64; the predictors of
tests/test_torch_repair.py), the scores, the report's files and the
ground truth found beside the image.

Tolerances: the five masks exactly equal; the scores within 1e-6 of
JAX's score_masks on the same masks (float32 sums of the same counts).
The grid is the port's own drawing (no matplotlib on the card's
machine), so it is checked for its layout, not against JAX's figure."""
import os

import cv2
import numpy as np
import pytest

from test_torch_repair import _jax, _port
from unet_watermark_tpu.scripts import method_compare as jmc
from unet_watermark_tpu_torch.scripts import method_compare as tmc
from unet_watermark_tpu_torch.utils import image_io
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

SCORE_ATOL = 1e-6


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("method_compare")
    img, logos = watermarked_images(1, 64, seed=5)
    path = d / "photo.png"
    cv2.imwrite(str(path), cv2.cvtColor((img[0] * 255).astype(np.uint8),
                                        cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(d / "photo_mask.png"),
                (logos[0] > 0.5).astype(np.uint8) * 255)
    jpred, pred = _jax(), _port()
    return {"dir": d, "path": str(path), "jpred": jpred, "pred": pred,
            "jax": jmc.run_methods(jpred, str(path)),
            "port": tmc.run_methods(pred, str(path))}


def test_five_masks_equal_jax(case):
    assert list(case["port"]) == list(tmc.METHODS) == list(case["jax"])
    for name in tmc.METHODS:
        got, want = case["port"][name], case["jax"][name]
        assert got.dtype == np.uint8 and got.shape == (64, 64)
        np.testing.assert_array_equal(got, want, err_msg=name)
    cfg = case["pred"].cfg.PREDICT
    assert (cfg.MULTI_SCALE_TEST, cfg.POST_PROCESS) == (
        case["jpred"].cfg.PREDICT.MULTI_SCALE_TEST,
        case["jpred"].cfg.PREDICT.POST_PROCESS)


def test_scores_equal_jax(case):
    gt = cv2.imread(os.path.join(case["dir"], "photo_mask.png"),
                    cv2.IMREAD_GRAYSCALE)
    want = jmc.score_masks(case["jax"], gt)
    got = tmc.score_masks(case["port"], gt, device="cpu")
    assert list(got) == list(want)
    for name in got:
        assert list(got[name]) == list(want[name])
        for key in got[name]:
            assert abs(got[name][key] - want[name][key]) <= SCORE_ATOL, \
                (name, key)
    assert any(s["iou"] > 0 for s in got.values())
    with pytest.raises(RuntimeError):  # the card by default; none here
        tmc.score_masks(case["port"], gt)


def test_compare_methods_finds_the_ground_truth(case, tmp_path):
    out = tmp_path / "report"
    r = tmc.compare_methods(case["path"], str(out), predictor=case["pred"])
    assert r["scores"] is not None and set(r["scores"]) == set(tmc.METHODS)
    for name in tmc.METHODS:
        np.testing.assert_array_equal(
            image_io.read_gray(str(out / f"photo_{name}_mask.png")),
            case["jax"][name])
    lines = (out / "photo_metrics.txt").read_text().splitlines()
    assert len(lines) == 6 and lines[0].split()[:2] == ["method", "IoU"]
    grid = image_io.read_rgb(r["grid"])
    rows, cols = 2, tmc.GRID_COLS
    assert grid.shape == (tmc.GAP + rows * (tmc.TITLE_H + 64 + tmc.GAP),
                          tmc.GAP + cols * (64 + tmc.GAP), 3)
    # the image sits in the first cell under its title, the masks after
    y0, x0 = tmc.GAP + tmc.TITLE_H, tmc.GAP
    np.testing.assert_array_equal(grid[y0:y0 + 64, x0:x0 + 64],
                                  image_io.read_rgb(case["path"]))
    title = grid[tmc.GAP:y0, x0:x0 + 64]
    assert (title < 128).any()  # a title is drawn


def test_no_ground_truth_gives_no_scores(case, tmp_path):
    lone = tmp_path / "lone.png"
    lone.write_bytes(open(case["path"], "rb").read())
    assert tmc.find_gt_mask(str(lone)) is None
    r = tmc.compare_methods(str(lone), str(tmp_path / "o"),
                            predictor=case["pred"])
    assert r["scores"] is None and os.path.exists(r["grid"])
    assert not (tmp_path / "o" / "lone_metrics.txt").exists()
