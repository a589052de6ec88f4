"""scripts/quality_report.eval_segmentation of the port against the JAX
package's, on the same triads (made by the port's gen_data) and the same
shipped Unet weights, both in float32: the raw, pipeline and tight scores.

JAX scores its pipelines with host cv2 mirrors of the device chains, the
port with the chains themselves (K1, the component rule, K2 on the card).
The raw masks of the two float32 forwards may differ where a probability
lies within ~1e-6 of the threshold, so each score (IoU, F1, precision,
recall, rounded to 4 digits by both) is held within SCORE_TOL. A port
checkpoint directory and the .npz exported from it give the predictor the
same masks. The rest of the report against JAX's: ensure_frozen_set (the
stated differences below), render_markdown and update_docs (text-equal),
and build_report and main on a tiny workdir; eval_e2e_repair is held in
tests/test_torch_quality_e2e.py.
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


# ---------------------------------------------------------------------------
# the rest of the report: the frozen set, the e2e repair, build_report,
# render_markdown and update_docs
# ---------------------------------------------------------------------------
# ensure_frozen_set: the names of every file equal JAX's (the same draws
# pick the same sources, kinds and logos); the held-out clean copies equal
# byte for byte; a clean source JPEG equals cv2's bytes where its synthetic
# image equals JAX's and lies within FROZEN_JPEG_DIFF levels elsewhere (the
# stated cubic/blur difference, through JPEG); the logos and the
# composites differ where the block font stands for DejaVu (letters and
# strips; text samples): a logo/multi composite's mask agrees with JAX's on
# FROZEN_MASK_AGREE of its pixels. The logos (256², whatever the set's
# size) equal JAX's pixel for pixel exactly where they carry no text: the
# FROZEN_EMBLEMS; the other 7 of the 12 have letters or a strip.
FROZEN_JPEG_DIFF, FROZEN_MASK_AGREE = 3, 0.99
FROZEN_EMBLEMS = ["logo_001.png", "logo_002.png", "logo_008.png",
                  "logo_009.png", "logo_011.png"]


def _subdirs(tex):
    t = "_tex" if tex else ""
    return [f"clean_src{t}", "logos", f"heldout{t}/watermarked",
            f"heldout{t}/clean", f"heldout{t}/masks"]


@pytest.mark.parametrize("textured", [False, True])
def test_ensure_frozen_set_against_jax(tmp_path, textured, monkeypatch):
    """The port's set takes no font draws (ROADMAP.md §C.12): JAX's set
    equals it where JAX finds no font files."""
    import cv2

    import unet_watermark_tpu.data.gen_data as jgen
    from unet_watermark_tpu.scripts.quality_report import \
        ensure_frozen_set as jfrozen

    monkeypatch.setattr(jgen, "load_system_fonts", lambda: [])
    j = jfrozen(str(tmp_path / "j"), n=4, img_size=64, textured=textured)
    p = pqr.ensure_frozen_set(str(tmp_path / "p"), n=4, img_size=64,
                              textured=textured, device="cpu")
    assert os.path.relpath(p, tmp_path / "p") == \
        os.path.relpath(j, tmp_path / "j")
    equal_logos = []
    for sub in _subdirs(textured):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert sorted(os.listdir(tmp_path / "p" / sub)) == names, sub
        assert len(names) == (16 if sub.startswith("clean_src") else
                              12 if sub == "logos" else 4), sub
        for n in names:
            a = (tmp_path / "j" / sub / n).read_bytes()
            b = (tmp_path / "p" / sub / n).read_bytes()
            x = cv2.imdecode(np.frombuffer(a, np.uint8), cv2.IMREAD_UNCHANGED)
            y = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_UNCHANGED)
            d = np.abs(x.astype(int) - y.astype(int))
            if sub == "logos" and x.shape == y.shape and not d.any():
                equal_logos.append(n)
            if sub.endswith("/clean"):
                assert a == b, n
            elif sub.startswith("clean_src"):
                assert a == b or d.max() <= FROZEN_JPEG_DIFF, n
            elif sub.endswith("/masks") and "_text_" not in n \
                    and "_mixed_" not in n:
                assert (d == 0).mean() >= FROZEN_MASK_AGREE, n
    assert equal_logos == FROZEN_EMBLEMS
    # a complete set is reused as it is
    before = sorted(os.listdir(tmp_path / "p" / _subdirs(textured)[2]))
    assert pqr.ensure_frozen_set(str(tmp_path / "p"), n=3, img_size=64,
                                 textured=textured, device="cpu") == p
    assert sorted(os.listdir(tmp_path / "p" / _subdirs(textured)[2])) == \
        before


def _report():
    """A report dict with every shape the renderers meet: an error row, a
    row without the tight pipeline, the inpaint table's weights entry."""
    seg = {"a_resnet34": {"raw": {"iou": 0.81234, "f1": 0.9, "precision":
                                  0.8, "recall": 0.95},
                          "pipeline": {"iou": 0.4},
                          "pipeline_tight": {"iou": 0.7, "recall": 0.75}},
           "b_resnet34": {"raw": {"iou": 0.5, "f1": 0.6, "precision": 0.7,
                                  "recall": 0.8}, "pipeline": {"iou": 0.3}},
           "c_resnet34_int8": {"error": "no calibration sidecar at x"}}
    e2e = {"n_images": 8, "floor": {"psnr_to_clean_db": 41.91,
                                    "region_psnr_db": 23.5},
           "pushpull": {"engine_used": "pushpull", "psnr_to_clean_db": 49.1,
                        "region_psnr_db": 32.52},
           "lama": {"engine_used": "ffc-lama", "psnr_to_clean_db": 44.0,
                    "region_psnr_db": 28.41}}
    tier = {"segmentation": seg,
            "inpaint": {"pushpull": {"hole_psnr_db": 24.67, "ssim": 0.9897,
                                     "n_images": 8},
                        "weights": "w.npz"},
            "e2e_repair": e2e, "e2e_repair_tight": e2e}
    return {"protocol": {"clean_seed": 7700, "compose_seed": 7701,
                         "tex_clean_seed": 7800, "tex_compose_seed": 7801,
                         "img_size": 512, "n_images": 8,
                         "tiers": ["smooth", "textured"]},
            "smooth": tier, "textured": tier}


def test_render_and_update_docs_equal_jax(tmp_path):
    from unet_watermark_tpu.scripts import quality_report as jqr

    flat = {k: v for k, v in _report().items() if k != "textured"}
    flat.update(flat.pop("smooth"))
    for report in (_report(), {k: v for k, v in _report().items()
                               if k != "textured"}, flat):
        assert pqr.render_markdown(report) == jqr.render_markdown(report)
    assert (pqr.AUTOGEN_BEGIN, pqr.AUTOGEN_END) == (jqr.AUTOGEN_BEGIN,
                                                    jqr.AUTOGEN_END)
    seeds = {"new": None, "markers": f"# Q\n\nhead\n{jqr.AUTOGEN_BEGIN}\nold"
             f"\n{jqr.AUTOGEN_END}\ntail\n", "no_markers": "# Q\n\ntext\n"}
    for name, text in seeds.items():
        paths = []
        for pkg in ("j", "p"):
            path = tmp_path / f"{name}_{pkg}.md"
            if text is not None:
                path.write_text(text)
            paths.append(path)
        jqr.update_docs(_report(), str(paths[0]))
        pqr.update_docs(_report(), str(paths[1]))
        assert paths[0].read_text() == paths[1].read_text(), name


def test_build_report_on_a_tiny_workdir(tmp_path):
    """main at 64², 2 triads, the smooth tier, on the CPU: the report's
    keys and JAX's seeds, the int8 row through the shipped sidecar, a row
    without a sidecar left out, every number finite, the JSON file."""
    import math

    npz = tmp_path / "w.npz"
    npz.write_bytes(shipping.seg_weights_path("Unet", "resnet34")
                    .read_bytes())  # no sidecar beside it
    seg = [{"model_name": "Unet", "encoder": "resnet34"},
           {"model_name": "Unet", "encoder": "resnet34", "quant": True},
           {"model_name": "Unet", "encoder": "resnet18", "quant": True,
            "weights": str(npz)}]
    r = pqr.build_report(str(tmp_path / "q"), limit=2, seg_configs=seg,
                         img_size=64, tiers=["smooth"], device="cpu")
    assert list(r) == ["protocol", "smooth", "segmentation", "inpaint",
                       "e2e_repair"]
    assert r["protocol"] == {"clean_seed": 7700, "compose_seed": 7701,
                             "tex_clean_seed": 7800,
                             "tex_compose_seed": 7801, "img_size": 64,
                             "n_images": 2, "tiers": ["smooth"]}
    tier = r["smooth"]
    assert list(tier["segmentation"]) == ["unet_resnet34",
                                          "unet_resnet34_int8"]
    assert tier["segmentation"]["unet_resnet34_int8"]["quant"] is True
    assert sorted(tier["inpaint"]) == ["diffusion", "lama", "pushpull",
                                       "weights"]
    assert tier["e2e_repair_tight"]["lama"]["engine_used"] == "ffc-lama"

    def numbers(node):
        if isinstance(node, dict):
            return [x for v in node.values() for x in numbers(v)]
        return [node] if isinstance(node, float) else []

    assert all(math.isfinite(x) for x in numbers(r))
    out = tmp_path / "m"
    rep = pqr.main(["--workdir", str(out), "--limit", "2", "--img-size",
                    "64", "--tiers", "smooth", "--device", "cpu"])
    assert json.loads((out / "quality_report.json").read_text()) == \
        json.loads(json.dumps(rep))
    assert list(rep["smooth"]["segmentation"]) == [
        "unetplusplus_resnet34", "unet_resnet34",
        "unetplusplus_resnet34_int8", "unet_resnet34_int8"]
