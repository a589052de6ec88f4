"""The port's repair entry point against the JAX package's, on the CPU:
WatermarkPredictor.process_folder_batch without OCR (steps 1, 2 and 5) and
with the builtin OCR detector (steps 1-5), and the `repair` CLI, on folders
of PNGs written by cv2, with the default configuration's UNet++/resnet34
shipped weights in float32 at IMG_SIZE 64 and the push-pull engine
("telea"). Also the tiled high-res path and the predict flags
(EDGE_REFINEMENT, CONNECTIVITY_CHECK, MULTI_SCALE_TEST), predict_mask for
the three mask types, and what raises until a later slice. The same on a
folder of JPEGs written by cv2 (an EXIF-rotated and a progressive file
among them), and the --no-unet route with OCR on JPEGs, whose step 3 reads
JPEG bytes copied under .png names."""
import json
import os
import struct
import zlib
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from test_torch_jpeg import splice_exif
from test_torch_pipeline import _jax_predictor
from unet_watermark_tpu import cli as jax_cli
from unet_watermark_tpu_torch import cli
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.inference import predict as port_predict
from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
from unet_watermark_tpu_torch.utils.shipping import seg_weights_path
from unet_watermark_tpu_torch.utils.synthetic import (text_images,
                                                      watermarked_images,
                                                      write_training_folder)

torch.set_num_threads(2)

# (name, height, width, seed of the synthetic image; None: no logo): 64²,
# 80x96, 100x70, a clean one, and two more with logos. Of the found logos,
# b and f type as "watermark" (the parity chain; K1/K2 on the card) and the
# rest as "text"
FOLDER = (("a", 64, 64, 20), ("b", 80, 96, 106), ("c", 100, 70, 22),
          ("d", 72, 72, None), ("e", 64, 64, 24), ("f", 90, 120, 30))
# Repaired pixels: push-pull with 64 Jacobi sweeps, run 3 times, in float32
# on each side (sums in another order), then truncated to 8 bits; observed:
# all 101 016 channel values of the 5 repaired images equal.
REPAIR_LSB = 1
# The tiled path's blended probabilities: float32 convs in each package's
# own order, the same blend order; observed max difference 2.4e-6 (mean
# 8.6e-9).
TILED_PROB_ATOL = 1e-5
TIME_KEYS = ("processing_time", "avg_processing_time_per_image")
# the OCR run's folder: FOLDER's images and two with lines of text (one
# over a logo), at sizes where the glyphs are 3-4 px
TEXT_FOLDER = ((128, 160), (96, 200))
PORT_KEYS = ("engine_failures", "engine_used", "ocr_engine_used",
             "ocr_failures")


def _write_folder(folder: Path, spec) -> None:
    """Synthetic images, each cut from the middle of a square one, written
    by cv2 (so libpng's adaptive row filters, Paeth among them, are what
    the decoders read)."""
    folder.mkdir(parents=True, exist_ok=True)
    for name, h, w, seed in spec:
        side = max(h, w)
        img, _ = watermarked_images(1, side, seed=seed or 0,
                                    clean=int(seed is None))
        y0, x0 = (side - h) // 2, (side - w) // 2
        rgb = (img[0, y0:y0 + h, x0:x0 + w] * 255).astype(np.uint8)
        cv2.imwrite(str(folder / f"{name}.png"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))


def _write_jpeg_folder(folder: Path, spec, rotated=(), progressive=()
                       ) -> None:
    """_write_folder's images as JPEGs written by cv2 with its defaults
    (quality 95, 4:2:0, baseline): the names in `rotated` stored turned a
    quarter left with EXIF orientation 6 (read back upright), those in
    `progressive` progressive."""
    folder.mkdir(parents=True, exist_ok=True)
    for name, h, w, seed in spec:
        side = max(h, w)
        img, _ = watermarked_images(1, side, seed=seed or 0,
                                    clean=int(seed is None))
        y0, x0 = (side - h) // 2, (side - w) // 2
        bgr = cv2.cvtColor((img[0, y0:y0 + h, x0:x0 + w] * 255).astype(
            np.uint8), cv2.COLOR_RGB2BGR)
        if name in rotated:
            bgr = np.ascontiguousarray(np.rot90(bgr, 1))
        ok, buf = cv2.imencode(".jpg", bgr, [
            cv2.IMWRITE_JPEG_PROGRESSIVE, int(name in progressive)])
        data = buf.tobytes()
        if name in rotated:
            data = splice_exif(data, 6, big_endian=True)
        (folder / f"{name}.jpg").write_bytes(data)


def _jax(mask_mode="auto"):
    pred = _jax_predictor("UnetPlusPlus", mask_mode)
    pred._forward = jax.jit(pred._apply_model)
    pred.img_size = pred.cfg.DATA.IMG_SIZE
    pred._engine_name = None
    pred.device = "cpu"
    return pred


def _jax_quant():
    """The JAX predictor of the `repair --quant` run: its int8 tier needs the
    fused decoder (the sidecar's ':up' and ':skip' paths), and its jitted
    forward takes the weights as arguments (as constants, XLA would fold
    the quantized kernels for minutes)."""
    from unet_watermark_tpu.ops import quant as jq
    from unet_watermark_tpu.models import create_model_from_config

    pred = _jax()
    pred.cfg.MODEL.FUSED_DECODER = True
    pred.cfg.PREDICT.QUANT = True
    pred.model = create_model_from_config(pred.cfg)
    scales = jq.load_scales(str(seg_weights_path("UnetPlusPlus", "resnet34"))
                            [:-len(".npz")] + ".quant.json")
    pred._quant_scales = scales

    def forward(v, x):
        with jq.quant_int8(scales):
            return pred.model.apply(v, x, train=False)

    jitted = jax.jit(forward)
    pred._forward = lambda x: jitted(pred.variables, x)
    return pred


def _port():
    cfg = get_cfg_defaults()
    cfg.MODEL.DTYPE = "float32"
    cfg.DATA.IMG_SIZE = 64
    return WatermarkPredictor(cfg, device="cpu")


def _record_step1(pred):
    """Keep what step 1 returns (each image's type and ratio)."""
    seen = {}
    step1 = pred.step1_batch_predict_watermark_masks

    def recording(*args, **kwargs):
        seen["step1"] = step1(*args, **kwargs)
        return seen["step1"]

    pred.step1_batch_predict_watermark_masks = recording
    return seen


def _gray(path) -> np.ndarray:
    out = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert out is not None, path
    return out


def _rgb(path) -> np.ndarray:
    out = cv2.imread(str(path))
    assert out is not None, path
    return out


def _records(results):
    return [(os.path.basename(r["original_path"]), r.get("mask_type"),
             r["watermark_ratio"]) for r in results]


@pytest.fixture(scope="module")
def preds():
    return _jax(), _port()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("repair") / "in"
    _write_folder(d, FOLDER)
    return d


@pytest.fixture(scope="module")
def runs(preds, folder):
    jpred, pred = preds
    out = {}
    for key, p in (("jax", jpred), ("port", pred)):
        seen = _record_step1(p)
        o = folder.parent / f"out_{key}"
        stats = p.process_folder_batch(str(folder), str(o),
                                       watermark_model="telea",
                                       use_ocr=False, steps=3)
        del p.step1_batch_predict_watermark_masks
        out[key] = {"dir": o, "stats": stats, "step1": seen["step1"]}
    return out


@pytest.fixture(scope="module")
def ocr_runs(preds, folder):
    """process_folder_batch with OCR on (the builtin detector, push-pull for
    both engines, 3 steps) on FOLDER plus two text images."""
    d = folder.parent / "in_ocr"
    _write_folder(d, FOLDER)
    imgs, _, _ = text_images(TEXT_FOLDER, seed=11, logo=[True])
    for i, img in enumerate(imgs):
        cv2.imwrite(str(d / f"t{i}.png"), cv2.cvtColor(img,
                                                       cv2.COLOR_RGB2BGR))
    out = {}
    for key, p in zip(("jax", "port"), preds):
        o = folder.parent / f"ocr_{key}"
        stats = p.process_folder_batch(
            str(d), str(o), watermark_model="telea", text_model="telea",
            use_ocr=True, ocr_engine="builtin", steps=3)
        out[key] = {"dir": o, "stats": stats}
    return out


@pytest.fixture(scope="module")
def jpeg_runs(preds, tmp_path_factory):
    """process_folder_batch without OCR on FOLDER written as JPEGs: b.jpg
    EXIF-rotated, f.jpg progressive."""
    d = tmp_path_factory.mktemp("repair_jpeg") / "in"
    _write_jpeg_folder(d, FOLDER, rotated=("b",), progressive=("f",))
    out = {"folder": d}
    for key, p in zip(("jax", "port"), preds):
        seen = _record_step1(p)
        o = d.parent / f"out_{key}"
        stats = p.process_folder_batch(str(d), str(o),
                                       watermark_model="telea",
                                       use_ocr=False, steps=3)
        del p.step1_batch_predict_watermark_masks
        out[key] = {"dir": o, "stats": stats, "step1": seen["step1"]}
    return out


def test_step1_masks_types_and_ratios_equal_jax(runs, folder):
    j, t = runs["jax"], runs["port"]
    names = sorted(os.listdir(j["dir"] / "step1_masks"))
    assert names == sorted(os.listdir(t["dir"] / "step1_masks"))
    assert len(names) == len(FOLDER)
    sizes = {n: (h, w) for n, h, w, _ in FOLDER}
    for name in names:
        tm = _gray(t["dir"] / "step1_masks" / name)
        assert tm.shape == sizes[name.split("_mask")[0]]
        np.testing.assert_array_equal(tm, _gray(j["dir"] / "step1_masks" /
                                                name))
    assert _records(t["step1"]) == _records(j["step1"])
    # some images found, some not; both strategies' types among them
    assert 0 < len(t["step1"]) < len(FOLDER)
    assert {r["mask_type"] for r in t["step1"]} == {"watermark", "text"}


def test_step2_repaired_images_within_one_lsb(runs):
    j, t = runs["jax"], runs["port"]
    for sub in ("step2_watermark_repaired", "."):
        jn = sorted(n for n in os.listdir(j["dir"] / sub) if
                    n.endswith(".png"))
        assert jn == sorted(n for n in os.listdir(t["dir"] / sub)
                            if n.endswith(".png"))
        assert jn
        for name in jn:
            a = _rgb(j["dir"] / sub / name).astype(int)
            b = _rgb(t["dir"] / sub / name).astype(int)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= REPAIR_LSB, name


def test_stage_timer_splits_a_run(preds, folder, tmp_path, monkeypatch):
    """With predict.STAGE_TIMER set, each stage of a predictor's
    construction and of process_folder_batch reports its own seconds, and
    their sum stays within the run's wall time."""
    import time

    from unet_watermark_tpu_torch.inference import predict as P

    timer = P.StageTimer(torch.device("cpu"))
    monkeypatch.setattr(P, "STAGE_TIMER", timer)
    t0 = time.perf_counter()
    pred = _port()
    stats = pred.process_folder_batch(str(folder), str(tmp_path / "o"),
                                      watermark_model="telea",
                                      use_ocr=False, steps=1)
    wall = time.perf_counter() - t0
    assert stats["status"] == "success"
    assert set(timer.seconds) == {
        "predictor_init", "decode", "upload_resize", "step1_device",
        "engine_load", "step2_device", "step5", "encode"}
    assert min(timer.seconds.values()) > 0
    assert sum(timer.seconds.values()) <= wall
    assert not timer.parts  # no JPEG; a PNG's upload is in upload_resize


def test_step2_decodes_one_batch_at_a_time(folder, tmp_path, monkeypatch):
    """Step 2 buckets the images by the sizes in their headers and decodes
    each batch's images when the batch runs, so the device holds one batch
    of them at a time: before each engine call, the images read since the
    last one are that batch's."""
    from unet_watermark_tpu_torch.inference import predict as P

    pred = _port()
    pred.cfg.PREDICT.BATCH_SIZE = 2
    events, in_step2 = [], []
    read = P.image_io.read_rgb_tensor
    get_engine = P.engines.get_engine
    step2 = pred.step2_batch_iopaint_watermark_repair

    def reading(path, *args, **kwargs):
        if in_step2:
            events.append(("read", os.path.basename(path)))
        return read(path, *args, **kwargs)

    def engine_of(*args, **kwargs):
        engine = get_engine(*args, **kwargs)

        def run(imgs, masks):
            events.append(("engine", imgs.shape[0]))
            return engine(imgs, masks)
        run.name = engine.name
        return run

    def step2_marked(*args, **kwargs):
        in_step2.append(True)
        return step2(*args, **kwargs)

    monkeypatch.setattr(P.image_io, "read_rgb_tensor", reading)
    monkeypatch.setattr(P.engines, "get_engine", engine_of)
    pred.step2_batch_iopaint_watermark_repair = step2_marked
    stats = pred.process_folder_batch(str(folder), str(tmp_path / "o"),
                                      watermark_model="telea",
                                      use_ocr=False, steps=1)
    assert stats["status"] == "success"
    pending, batches = 0, []
    for kind, value in events:
        if kind == "read":
            pending += 1
        else:
            assert pending == value, events
            batches.append(value)
            pending = 0
    assert pending == 0 and max(batches) == 2
    assert sum(batches) == len(os.listdir(tmp_path / "o" /
                                          "step2_watermark_repaired"))


def test_repaired_images_keep_the_unmasked_pixels(runs, folder):
    t = runs["port"]
    for rec in t["step1"]:
        name = os.path.basename(rec["original_path"])
        src = _rgb(folder / name)
        out = _rgb(t["dir"] / "step2_watermark_repaired" / name)
        keep = _gray(rec["mask_path"]) <= 127
        np.testing.assert_array_equal(out[keep], src[keep])
        assert (out != src).any()


def test_step5_merged_masks_equal_jax(runs):
    j, t = runs["jax"], runs["port"]
    names = sorted(os.listdir(j["dir"] / "masks"))
    assert names and names == sorted(os.listdir(t["dir"] / "masks"))
    for name in names:
        np.testing.assert_array_equal(_gray(t["dir"] / "masks" / name),
                                      _gray(j["dir"] / "masks" / name))


def test_stats_equal_jax_apart_from_times(runs):
    js, ts = dict(runs["jax"]["stats"]), dict(runs["port"]["stats"])
    assert [ts.pop(k) for k in PORT_KEYS] == [0, "pushpull", None, 0]
    for key in TIME_KEYS:
        assert ts.pop(key) > 0 and js.pop(key) > 0
    assert ts == js
    assert ts["status"] == "success"


def test_ocr_run_text_masks_and_stats_equal_jax(ocr_runs):
    """Steps 3-4: the same text-mask files (equal after decode), the same
    stats apart from times, finals within the push-pull tolerance, and the
    merged masks (step-1 and text masks) equal."""
    j, t = ocr_runs["jax"], ocr_runs["port"]
    sub = "step3_text_masks"
    names = sorted(os.listdir(j["dir"] / sub))
    assert names == sorted(os.listdir(t["dir"] / sub))
    # step 3 reads step 2's files: t1's lines type as a watermark in step
    # 1 and are repaired away there; t0's logo is, and its lines stay
    assert "t0_text_mask.png" in names
    for name in names:
        np.testing.assert_array_equal(_gray(t["dir"] / sub / name),
                                      _gray(j["dir"] / sub / name))
    js, ts = dict(j["stats"]), dict(t["stats"])
    assert [ts.pop(k) for k in PORT_KEYS] == [0, "pushpull", "builtin", 0]
    for key in TIME_KEYS:
        assert ts.pop(key) > 0 and js.pop(key) > 0
    assert ts == js
    assert ts["status"] == "success" and ts["avg_text_pixels"] > 0
    assert ts["steps_completed"]["step3_text_extraction"] >= 1
    for sub in (".", "masks"):
        jn = sorted(n for n in os.listdir(j["dir"] / sub)
                    if n.endswith(".png"))
        assert jn and jn == sorted(n for n in os.listdir(t["dir"] / sub)
                                   if n.endswith(".png"))
        for name in jn:
            a = _rgb(j["dir"] / sub / name).astype(int)
            b = _rgb(t["dir"] / sub / name).astype(int)
            assert np.abs(a - b).max() <= (REPAIR_LSB if sub == "." else 0)


def test_ocr_finals_keep_step2_outside_the_text_mask(ocr_runs):
    t = ocr_runs["port"]["dir"]
    for name in os.listdir(t / "step3_text_masks"):
        stem = name[:-len("_text_mask.png")]
        keep = _gray(t / "step3_text_masks" / name) <= 127
        step2 = _rgb(t / "step2_watermark_repaired" / f"{stem}.png")
        final = _rgb(t / f"{stem}.png")
        np.testing.assert_array_equal(final[keep], step2[keep])
        if not keep.all():
            assert (final != step2).any()


def test_jpeg_folder_matches_jax(jpeg_runs):
    """A folder of JPEGs (one stored rotated with EXIF orientation 6, one
    progressive): step-1 masks at each image's upright size and types
    equal, repaired images within REPAIR_LSB, merged masks equal, stats
    equal apart from times."""
    j, t = jpeg_runs["jax"], jpeg_runs["port"]
    sizes = {n: (h, w) for n, h, w, _ in FOLDER}
    names = sorted(os.listdir(j["dir"] / "step1_masks"))
    assert names == sorted(os.listdir(t["dir"] / "step1_masks"))
    assert len(names) == len(FOLDER)
    for name in names:
        tm = _gray(t["dir"] / "step1_masks" / name)
        assert tm.shape == sizes[name.split("_mask")[0]]
        np.testing.assert_array_equal(
            tm, _gray(j["dir"] / "step1_masks" / name))
    assert _records(t["step1"]) == _records(j["step1"])
    assert 0 < len(t["step1"]) < len(FOLDER)
    found = {os.path.basename(r["original_path"]) for r in t["step1"]}
    assert {"b.jpg", "f.jpg"} <= found  # the rotated and progressive files
    for sub in ("step2_watermark_repaired", ".", "masks"):
        jn = sorted(n for n in os.listdir(j["dir"] / sub)
                    if n.endswith(".png"))
        assert jn and jn == sorted(n for n in os.listdir(t["dir"] / sub)
                                   if n.endswith(".png"))
        for name in jn:
            a = _rgb(j["dir"] / sub / name).astype(int)
            b = _rgb(t["dir"] / sub / name).astype(int)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= (0 if sub == "masks"
                                            else REPAIR_LSB), (sub, name)
    js, ts = dict(j["stats"]), dict(t["stats"])
    assert [ts.pop(k) for k in PORT_KEYS] == [0, "pushpull", None, 0]
    for key in TIME_KEYS:
        assert ts.pop(key) > 0 and js.pop(key) > 0
    assert ts == js and ts["status"] == "success"


def test_jpeg_no_unet_ocr_reads_jpeg_under_png_names(preds, tmp_path):
    """--no-unet with OCR on JPEGs: each file is copied to
    step2_watermark_repaired/{stem}.png as it is, and step 3 and step 4
    read those copies as the JPEGs they are, as cv2 does. Text masks equal
    JAX's, finals within REPAIR_LSB, stats equal apart from times."""
    d = tmp_path / "in"
    _write_jpeg_folder(d, FOLDER[:2], rotated=("a",))
    imgs, _, _ = text_images(TEXT_FOLDER, seed=11, logo=[True])
    for i, img in enumerate(imgs):
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        (d / f"t{i}.jpg").write_bytes(buf.tobytes())
    stats = {}
    for key, p in zip("jt", preds):
        stats[key] = dict(p.process_folder_batch(
            str(d), str(tmp_path / key), watermark_model="telea",
            text_model="telea", use_unet=False, use_ocr=True,
            ocr_engine="builtin", steps=1))
    copy = tmp_path / "t" / "step2_watermark_repaired" / "t0.png"
    assert copy.read_bytes()[:3] == b"\xff\xd8\xff"  # a JPEG
    sub = "step3_text_masks"
    names = sorted(os.listdir(tmp_path / "j" / sub))
    assert "t0_text_mask.png" in names
    assert names == sorted(os.listdir(tmp_path / "t" / sub))
    for name in names:
        np.testing.assert_array_equal(_gray(tmp_path / "t" / sub / name),
                                      _gray(tmp_path / "j" / sub / name))
    finals = sorted(n for n in os.listdir(tmp_path / "j")
                    if n.endswith(".png"))
    assert finals == sorted(n for n in os.listdir(tmp_path / "t")
                            if n.endswith(".png"))
    for name in finals:
        a = _rgb(tmp_path / "j" / name).astype(int)
        b = _rgb(tmp_path / "t" / name).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= REPAIR_LSB, name
    js, ts = stats["j"], stats["t"]
    assert [ts.pop(k) for k in PORT_KEYS] == [0, "pushpull", "builtin", 0]
    for key in TIME_KEYS:
        ts.pop(key), js.pop(key)
    assert ts == js and ts["steps_completed"]["step3_text_extraction"] >= 1


@pytest.mark.parametrize("options", [{"use_unet": False},
                                     {"save_intermediate": False}],
                         ids=["no-unet", "temporary-folders"])
def test_other_options_match_jax(preds, folder, tmp_path, options):
    """Without the network every image passes through as it is; without
    intermediate folders steps 1-2 write to a temporary directory and the
    output holds the final images and the merged masks only."""
    stats = {}
    for key, p in zip("jt", preds):
        stats[key] = dict(p.process_folder_batch(
            str(folder), str(tmp_path / key), watermark_model="telea",
            use_ocr=False, steps=1, **options))
    js, ts = stats["j"], stats["t"]
    assert ts.pop("engine_failures") == ts.pop("ocr_failures") == 0
    assert ts.pop("engine_used") == (None if options.get("use_unet") is False
                                     else "pushpull")
    assert ts.pop("ocr_engine_used") is None
    for key in TIME_KEYS:
        ts.pop(key), js.pop(key)
    assert ts == js
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    for name in names:
        if name.endswith(".png"):
            a = _rgb(tmp_path / "j" / name).astype(int)
            b = _rgb(tmp_path / "t" / name).astype(int)
            assert np.abs(a - b).max() <= REPAIR_LSB, name


def test_tiled_path_matches_jax(preds, tmp_path, monkeypatch):
    """PREDICT.TILED with TILE_SIZE 64 and overlap 16 on a 160x200 image:
    15 tiles of the padded 160x224 image, blended; probabilities within
    TILED_PROB_ATOL and the step-1 mask equal."""
    jpred, pred = preds
    for p in (jpred, pred):
        monkeypatch.setattr(p.cfg.PREDICT, "TILED", True)
        monkeypatch.setattr(p.cfg.PREDICT, "TILE_SIZE", 64)
        monkeypatch.setattr(p.cfg.PREDICT, "TILE_OVERLAP", 16)
    d = tmp_path / "in"
    _write_folder(d, [("big", 160, 200, 26)])
    rgb = cv2.cvtColor(_rgb(d / "big.png"), cv2.COLOR_BGR2RGB)
    jp = jpred._infer_prob_map(rgb)
    tp = pred._infer_prob_map(torch.from_numpy(rgb)).numpy()
    assert tp.shape == jp.shape == (160, 200)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=TILED_PROB_ATOL)
    jr = jpred.step1_batch_predict_watermark_masks(str(d), str(tmp_path / "j"))
    tr = pred.step1_batch_predict_watermark_masks(str(d), str(tmp_path / "t"))
    tm = _gray(tmp_path / "t" / "big_mask.png")
    assert tm.shape == (160, 200) and tm.any()
    np.testing.assert_array_equal(tm, _gray(tmp_path / "j" / "big_mask.png"))
    assert _records(tr) == _records(jr)


@pytest.mark.parametrize("flag", ["EDGE_REFINEMENT", "CONNECTIVITY_CHECK",
                                  "MULTI_SCALE_TEST"])
def test_predict_flags_match_jax(preds, folder, tmp_path, monkeypatch, flag):
    """Each flag of the text configuration on, alone: the step-1 masks,
    types and ratios equal JAX's. MULTI_SCALE_TEST runs scales 0.5, 1.0 and
    1.5 (sides 32, 64 and 96 at IMG_SIZE 64), so both float resizes run."""
    jpred, pred = preds
    for p in (jpred, pred):
        monkeypatch.setattr(p.cfg.PREDICT, flag, True)
        monkeypatch.setattr(p.cfg.PREDICT, "TEST_SCALES", [0.5, 1.0, 1.5])
    jr = jpred.step1_batch_predict_watermark_masks(str(folder),
                                                   str(tmp_path / "j"))
    tr = pred.step1_batch_predict_watermark_masks(str(folder),
                                                  str(tmp_path / "t"))
    for name in sorted(os.listdir(tmp_path / "j")):
        np.testing.assert_array_equal(_gray(tmp_path / "t" / name),
                                      _gray(tmp_path / "j" / name))
    assert _records(tr) == _records(jr)


@pytest.mark.parametrize("mask_type", ["watermark", "text", "mixed"])
def test_predict_mask_matches_jax(preds, folder, mask_type):
    """The single-image API at the image's own size (the probability map
    resized as float32, the strategy at the padded size); the text and
    mixed types see the image after _enhance_text_features and take their
    own strategies."""
    jpred, pred = preds
    for name in ("b.png", "c.png"):
        path = str(folder / name)
        np.testing.assert_array_equal(pred.predict_mask(path, mask_type),
                                      jpred.predict_mask(path, mask_type))


# the first bytes of a WEBP file (a format the port does not decode yet)
WEBP_HEAD = b"RIFF\x24\x00\x00\x00WEBPVP8 "


def _interlaced_png(path: Path) -> None:
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1)
    chunk = (struct.pack(">I", 13) + b"IHDR" + ihdr
             + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)))
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk)


@pytest.mark.parametrize("bad", ["photo.webp", "interlaced.png"])
def test_undecodable_files_raise_before_any_work(preds, folder, tmp_path,
                                                 bad):
    _, pred = preds
    d = tmp_path / "in"
    _write_folder(d, FOLDER[:1])
    if bad.endswith(".webp"):
        (d / bad).write_bytes(WEBP_HEAD)
    else:
        _interlaced_png(d / bad)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pred.process_folder_batch(str(d), str(tmp_path / "out"),
                                  use_ocr=False)
    assert not (tmp_path / "out" / "step1_masks").exists() or \
        not os.listdir(tmp_path / "out" / "step1_masks")


def _repair_args(folder, out):
    return ["repair", "--input", str(folder), "--output", str(out),
            "--no-ocr", "--watermark-model", "telea",
            "--opts", "DATA.IMG_SIZE", "64", "MODEL.DTYPE", "float32"]


def test_cli_writes_the_jax_summary_keys(preds, folder, tmp_path,
                                         monkeypatch):
    """The port's `repair --device cpu --no-ocr` against the JAX CLI's
    repair_command on the same folder; the JAX CLI's predictor is the one
    assembled without its eager init."""
    jpred, _ = preds
    monkeypatch.setattr("unet_watermark_tpu.inference.WatermarkPredictor",
                        lambda model_path=None, config=None: jpred)
    jargs = jax_cli.build_parser().parse_args(
        _repair_args(folder, tmp_path / "j") + ["--device", "cpu"])
    assert jax_cli.repair_command(jargs) == 0
    assert cli.main(_repair_args(folder, tmp_path / "t")
                    + ["--device", "cpu"]) == 0
    j = json.loads((tmp_path / "j" / "repair_summary.json").read_text())
    t = json.loads((tmp_path / "t" / "repair_summary.json").read_text())
    assert set(t) == set(j) | set(PORT_KEYS)
    assert t["engine_used"] == "pushpull"
    assert set(t["steps_completed"]) == set(j["steps_completed"])
    assert t["status"] == j["status"] == "success"
    for sub in ("step1_masks", "step2_watermark_repaired", "masks"):
        assert sorted(os.listdir(tmp_path / "t" / sub)) == \
            sorted(os.listdir(tmp_path / "j" / sub))


@pytest.mark.parametrize("extra, error", [
    (["--device", "cpu", "--no-ocr"], None),
    (["--device", "cpu"], None),
    (["--device", "cpu", "--no-ocr", "--quant"], None),
    (["--device", "cpu", "--no-ocr", "--video"], None),
    (["--device", "tpu", "--no-ocr"], ValueError)],
    ids=["ok", "ocr", "quant", "video", "tpu"])
def test_cli_raises_for_what_is_not_ported(preds, folder, tmp_path,
                                           monkeypatch, extra, error):
    """What runs writes the JAX CLI's summary: with OCR (--ocr-engine easy,
    the builtin detector without easyocr; --text-model telea here) and with
    --quant (the int8 tier, PREDICT.QUANT set after --opts, against the JAX
    CLI's --quant run) the same values apart from times, and the port's
    four extra keys. --video writes comparison_video.mp4, three-way (the
    output has masks/), at the JAX CLI's 1920 x 1080, 30 fps and 2 s an
    image."""
    opts = ["--watermark-model", "telea", "--text-model", "telea", "--opts",
            "DATA.IMG_SIZE", "64", "MODEL.DTYPE", "float32"]
    args = ["repair", "--input", str(folder), "--output",
            str(tmp_path / "o")] + opts + extra
    if error is None:
        made = []
        if "--quant" in extra:  # keep the predictor the CLI makes
            monkeypatch.setattr(port_predict, "WatermarkPredictor",
                                lambda *a, **k: made.append(
                                    WatermarkPredictor(*a, **k)) or made[-1])
        assert cli.main(args) == 0
        if "--video" in extra:
            import cv2

            cap = cv2.VideoCapture(str(tmp_path / "o" /
                                       "comparison_video.mp4"))
            triplets = len(os.listdir(tmp_path / "o" / "masks"))
            assert triplets > 0
            assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                    cap.get(cv2.CAP_PROP_FPS),
                    int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == (
                        triplets * 60, 30.0, 1920, 1080)
            ok, frame = cap.read()
            assert ok and frame.shape == (1080, 1920, 3)
            cap.release()
        if "--no-ocr" in extra and "--quant" not in extra:
            return
        jpred = preds[0]
        if "--quant" in extra:
            assert made[0].cfg.PREDICT.QUANT
            assert len(made[0]._quant_plans) == 68
            jpred = _jax_quant()
        monkeypatch.setattr(
            "unet_watermark_tpu.inference.WatermarkPredictor",
            lambda model_path=None, config=None: jpred)
        jargs = jax_cli.build_parser().parse_args(
            ["repair", "--input", str(folder), "--output",
             str(tmp_path / "j")] + opts + extra)
        assert jax_cli.repair_command(jargs) == 0
        j = json.loads((tmp_path / "j" / "repair_summary.json").read_text())
        t = json.loads((tmp_path / "o" / "repair_summary.json").read_text())
        ocr = None if "--no-ocr" in extra else "builtin"
        assert [t.pop(k) for k in PORT_KEYS] == [0, "pushpull", ocr, 0]
        for key in TIME_KEYS:
            assert t.pop(key) > 0 and j.pop(key) > 0
        if "--quant" in extra:
            # int8 masks: a few pixels of the 64² masks take the other side
            # of the threshold where an activation one ulp apart (XLA's
            # fused BN rounding under jit) flips an int8 step
            # (tests/test_torch_quant.py); observed 0.18106 against 0.18095
            ratio = "avg_watermark_ratio"
            assert t.pop(ratio) == pytest.approx(j.pop(ratio), rel=0.01)
        assert t == j
        return
    with pytest.raises(error, match="ROADMAP.md|cuda"):
        cli.main(args)
    assert not (tmp_path / "o").exists()


def test_cli_cuda_without_a_card_and_training_raise(folder, tmp_path):
    """Without a card "cuda" raises for both commands. --use-blurred-mask
    is no longer refused: `train` with it makes the soft masks of the
    images without a mask file (cached in masks/, values between 0 and
    255; their bytes against JAX's: tests/test_torch_blurred_mask.py) and
    trains (the `auto` loop runs: tests/test_torch_auto_train.py)."""
    if not torch.cuda.is_available():
        for args in (["repair", "--input", str(folder), "--output",
                      str(tmp_path / "o"), "--no-ocr"],
                     ["train", "--data-dir", str(tmp_path / "d")]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(args)
    data = tmp_path / "d"
    write_training_folder(data, 6, 128, seed=4, masks=2)
    out = tmp_path / "t"
    assert cli.main(["train", "--device", "cpu", "--use-blurred-mask",
                     "--data-dir", str(data), "--epochs", "1",
                     "--batch-size", "4", "--output-dir", str(out),
                     "--model-save-path", str(out / "m.pth"), "--opts",
                     "MODEL.NAME", "Unet", "MODEL.DTYPE", "float32",
                     "DATA.IMG_SIZE", "64", "TRAIN.CHECKPOINT_DIR",
                     str(out / "ck")]) == 0
    made = sorted(os.listdir(data / "masks"))
    assert len(made) == 6
    soft = [cv2.imread(str(data / "masks" / m), 0) for m in made]
    assert any(((m > 0) & (m < 255)).any() for m in soft)
    assert (out / "m.pth").exists()
