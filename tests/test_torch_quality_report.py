"""scripts/quality_report.eval_segmentation of the port against the JAX
package's, on the same triads (made by the port's gen_data) and the same
shipped Unet weights, both in float32: the raw, pipeline and tight scores.

JAX scores its pipelines with host cv2 mirrors of the device chains, the
port with the chains themselves (K1, the component rule, K2 on the card).
The raw masks of the two float32 forwards may differ where a probability
lies within ~1e-6 of the threshold, so each score (IoU, F1, precision,
recall, rounded to 4 digits by both) is held within SCORE_TOL. A port
checkpoint directory and the .npz exported from it give the predictor the
same masks.
"""
import json
import os

import numpy as np
import pytest
import torch

import unet_watermark_tpu.configs as jconfigs
from unet_watermark_tpu_torch.configs import get_cfg_defaults as pcfg
from unet_watermark_tpu_torch.data.gen_data import generate_dataset
from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
from unet_watermark_tpu_torch.scripts import quality_report as pqr
from unet_watermark_tpu_torch.utils import image_io, shipping, synthetic

SCORE_TOL = 2e-3
SIZE = 128


@pytest.fixture(scope="module")
def triads(tmp_path_factory):
    root = tmp_path_factory.mktemp("triads")
    clean, logos = root / "clean", root / "logos"
    clean.mkdir()
    logos.mkdir()
    imgs, _ = synthetic.watermarked_images(3, 150, seed=9, clean=3)
    u8 = (imgs * 255).astype(np.uint8)
    image_io.write_png(clean / "a.png", u8[0][:SIZE, :SIZE])
    image_io.write_png(clean / "b.png", u8[1][:SIZE, :SIZE])
    image_io.write_png(clean / "c.png", u8[2][:100, :150])  # resized
    lg = np.zeros((40, 60, 4), np.uint8)
    lg[6:34, 8:52] = (250, 250, 250, 255)
    lg[14:26, 16:44, 3] = 0
    image_io.write_png(logos / "l.png", lg)
    generate_dataset(str(clean), str(root / "set"), str(logos), count=10,
                     seed=11, ratios={"logo": 1.0, "multi": 1.0},
                     enhance_transparent=False, device="cpu")
    return str(root / "set")


def _f32(get):
    def make():
        cfg = get()
        cfg.MODEL.DTYPE = "float32"
        return cfg
    return make


def test_eval_segmentation_matches_jax(triads, monkeypatch):
    from unet_watermark_tpu.scripts.quality_report import \
        eval_segmentation as jeval

    monkeypatch.setattr(jconfigs, "get_cfg_defaults",
                        _f32(jconfigs.get_cfg_defaults))
    monkeypatch.setattr(pqr, "get_cfg_defaults", _f32(pcfg))
    weights = str(shipping.seg_weights_path("Unet", "resnet34"))
    kw = dict(limit=9, batch=4, weights=weights, model_name="Unet",
              img_size=SIZE)
    j = jeval(triads, **kw)
    p = pqr.eval_segmentation(triads, device="cpu", **kw)
    assert sorted(p) == sorted(j)
    assert p["n_images"] == j["n_images"] == 9
    assert (p["model"], p["encoder"], p["quant"]) == \
        (j["model"], j["encoder"], j["quant"])
    assert p["raw"]["iou"] > 0.3  # the shipped net finds these logos
    for key in ("raw", "pipeline", "pipeline_tight"):
        for stat, value in j[key].items():
            assert abs(p[key][stat] - value) <= SCORE_TOL, (key, stat)


def test_missing_weights_and_sidecar(triads, tmp_path):
    r = pqr.eval_segmentation(triads, 2, weights=str(tmp_path / "no.npz"),
                              device="cpu")
    assert "error" in r
    ck = tmp_path / "ck"
    ck.mkdir()
    np.savez(ck / "tree.npz", step=np.int64(0))
    r = pqr.eval_segmentation(triads, 2, weights=str(ck), quant=True,
                              device="cpu")
    assert "sidecar" in r["error"]


def test_predictor_reads_a_checkpoint_directory(tmp_path):
    """A port checkpoint directory (tree.npz + meta.json) and the shipped-
    format .npz exported from it give equal masks."""
    cfg = pcfg()
    cfg.MODEL.NAME, cfg.MODEL.DTYPE, cfg.DATA.IMG_SIZE = "Unet", \
        "float32", 64
    flat = shipping.load_npz(shipping.seg_weights_path("Unet", "resnet34"))
    ck = tmp_path / "checkpoint_epoch_3"
    ck.mkdir()
    np.savez(ck / "tree.npz", step=np.int64(7),
             **{k: v for k, v in flat.items()})
    (ck / "meta.json").write_text(json.dumps({"epoch": 3}))
    npz = shipping.save_params_npz(str(tmp_path / "w.npz"), flat)
    images, _ = synthetic.watermarked_images(3, 64, seed=4)
    x = torch.from_numpy(images)
    a = WatermarkPredictor(cfg, weights_path=str(ck), device="cpu")
    b = WatermarkPredictor(cfg, weights_path=npz, device="cpu")
    assert a.n_weights == b.n_weights == len(flat)
    ma, mb = a.predict_masks(x), b.predict_masks(x)
    assert ma.any() and torch.equal(ma, mb)
    assert os.path.isdir(a.weights_path)
