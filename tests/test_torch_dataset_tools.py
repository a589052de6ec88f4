"""The dataset tools of scripts/ against the JAX package's, on the CPU
(device="cpu"): check.validate_dataset in its three modes,
enhance_masks (enhance_mask, yolo_to_mask, enhance_folder's PNG, JPEG and
BMP outputs), image_fixer's stages and fixes, watermark_filter and
batch_repair_optimizer over the default configuration's UNet++/resnet34
shipped weights (float32, IMG_SIZE 64: the predictors of
tests/test_torch_repair.py), and extract_watermarks. The inputs are written
at test time with cv2 and Pillow.

Tolerances: summaries, stages, records, boxes and pixels exactly equal;
the watermark ratios within 1e-3 (float32 convs in each package's own
order). Stated differences: image_fixer's message after its stage prefix
is the port's own; a PNG the port writes has its encoder's bytes (the
pixels are compared); a .webp, .tif or .tiff that needs re-encoding raises
NotImplementedError (ROADMAP.md §A.8)."""
import os
import random
import shutil

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_repair import FOLDER, _jax, _port, _write_folder
from unet_watermark_tpu.scripts import batch_repair_optimizer as jbro
from unet_watermark_tpu.scripts import check as jcheck
from unet_watermark_tpu.scripts import enhance_masks as jem
from unet_watermark_tpu.scripts import extract_watermarks as jex
from unet_watermark_tpu.scripts import image_fixer as jfix
from unet_watermark_tpu.scripts import watermark_filter as jwf
from unet_watermark_tpu_torch.scripts import batch_repair_optimizer as tbro
from unet_watermark_tpu_torch.scripts import check as tcheck
from unet_watermark_tpu_torch.scripts import enhance_masks as tem
from unet_watermark_tpu_torch.scripts import extract_watermarks as tex
from unet_watermark_tpu_torch.scripts import image_fixer as tfix
from unet_watermark_tpu_torch.scripts import watermark_filter as twf
from unet_watermark_tpu_torch.utils import bmp, image_io

RATIO_ATOL = 1e-3


def _smooth(rng, h, w):
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    return cv2.GaussianBlur(img, (7, 7), 3)


def _mask(rng, h, w, blobs=3, specks=0):
    m = np.zeros((h, w), np.uint8)
    for _ in range(blobs):
        cx, cy = rng.integers(8, w - 8), rng.integers(8, h - 8)
        cv2.circle(m, (int(cx), int(cy)), int(rng.integers(3, 8)), 255, -1)
    for _ in range(specks):
        y, x = rng.integers(0, h // 2) * 2, rng.integers(0, w // 2) * 2
        m[y, x] = 255
    return m


# ---- check -----------------------------------------------------------------
def _triads(root, rng):
    """Good, black-mask, fragmented, missing-mask, missing-clean, orphaned
    and corrupted triads."""
    for d in ("watermarked", "clean", "masks"):
        os.makedirs(os.path.join(root, d))

    def put(d, name, arr):
        cv2.imwrite(os.path.join(root, d, name), arr)

    for i in range(3):
        put("watermarked", f"g{i}.png", _smooth(rng, 40, 48))
        put("clean", f"g{i}.png", _smooth(rng, 40, 48))
        put("masks", f"g{i}.png", _mask(rng, 40, 48))
    put("watermarked", "black.jpg", _smooth(rng, 40, 48))
    put("clean", "black.png", _smooth(rng, 40, 48))
    put("masks", "black.png", np.zeros((40, 48), np.uint8))
    put("watermarked", "frag.png", _smooth(rng, 40, 48))
    put("clean", "frag.png", _smooth(rng, 40, 48))
    put("masks", "frag.png", _mask(rng, 40, 48, 1, specks=80))
    put("watermarked", "nomask.png", _smooth(rng, 40, 48))
    put("clean", "nomask.png", _smooth(rng, 40, 48))
    put("watermarked", "noclean.bmp", _smooth(rng, 40, 48))
    put("masks", "noclean.png", _mask(rng, 40, 48))
    put("clean", "orphan.png", _smooth(rng, 40, 48))
    put("masks", "orphan2.png", _mask(rng, 40, 48))
    with open(os.path.join(root, "watermarked", "broken.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot really")
    put("clean", "broken.png", _smooth(rng, 40, 48))
    put("masks", "broken.png", _mask(rng, 40, 48))


def _relative(summary, root):
    """The summary with paths relative to root (the two copies differ)."""
    def rel(p):
        return os.path.relpath(p, root)
    out = dict(summary)
    out["problem_files"] = {k: [rel(p) for p in v]
                            for k, v in summary["problem_files"].items()}
    out["handled"] = sorted(rel(p) for p in summary["handled"])
    return out


@pytest.mark.parametrize("mode", ["detect", "delete", "move"])
def test_validate_dataset_equals_jax(tmp_path, mode):
    rng = np.random.default_rng(11)
    _triads(tmp_path / "src", rng)
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(tmp_path / "src", jroot)
    shutil.copytree(tmp_path / "src", troot)
    want = jcheck.validate_dataset(str(jroot), mode)
    got = tcheck.validate_dataset(str(troot), mode, device="cpu")
    assert _relative(got, str(troot)) == _relative(want, str(jroot))
    assert got["problems"]["fragmented_mask"] == 1
    assert got["problems"]["corrupted"] == 1
    assert got["affected_triads"] == 3
    for d in ("watermarked", "clean", "masks", "quarantine"):
        a, b = jroot / d, troot / d
        assert (sorted(os.listdir(a)) if a.exists() else None) == \
            (sorted(os.listdir(b)) if b.exists() else None)


def test_check_main_and_default_device(tmp_path, capsys):
    _triads(tmp_path, np.random.default_rng(3))
    s = tcheck.main(["--root", str(tmp_path), "--device", "cpu"])
    assert s["total_watermarked"] == 8
    assert "problem_files" not in capsys.readouterr().out
    with pytest.raises(RuntimeError):  # the card by default; none here
        tcheck.validate_dataset(str(tmp_path))


# ---- enhance_masks ----------------------------------------------------------
@pytest.mark.parametrize("kwargs", [{}, {"dilate_size": 3,
                                         "dilate_iterations": 1,
                                         "blur_size": 8, "blur_sigma": 1.3,
                                         "rethreshold": 0.6}])
def test_enhance_mask_equals_jax(kwargs):
    rng = np.random.default_rng(5)
    m = _mask(rng, 61, 77, blobs=4, specks=30)
    m[::9, :] = 200  # thin lines above 127
    m[5::9, :] = 100  # and below
    want = jem.enhance_mask(m, **kwargs)
    got = tem.enhance_mask(m, device="cpu", **kwargs)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_yolo_to_mask_equals_jax(tmp_path):
    lines = ["0 0.5 0.5 0.2 0.3", "1 0.1 0.1 0.4 0.4", "0 0.95 0.9 0.3 0.5",
             "2 1.3 0.5 0.2 0.2", "bad line", "0 -0.2 0.5 0.1 0.1"]
    path = tmp_path / "a.txt"
    path.write_text("\n".join(lines))
    for cf in (None, 0, 2):
        np.testing.assert_array_equal(
            tem.yolo_to_mask(str(path), (50, 64), cf),
            jem.yolo_to_mask(str(path), (50, 64), cf))
    np.testing.assert_array_equal(
        tem.yolo_to_mask(str(tmp_path / "none.txt"), (5, 6)),
        np.zeros((5, 6), np.uint8))


def test_enhance_folder_writes_what_jax_writes(tmp_path):
    rng = np.random.default_rng(9)
    src = tmp_path / "in"
    src.mkdir()
    for name in ("a.png", "b.jpg", "c.bmp", "d.jpeg"):
        cv2.imwrite(str(src / name), _mask(rng, 45, 70, blobs=5))
    (src / "e.png").write_bytes(b"broken")
    (src / "f.txt").write_text("not an image")
    n_j = jem.enhance_folder(str(src), str(tmp_path / "jax"))
    n_t = tem.enhance_folder(str(src), str(tmp_path / "port"),
                             device="cpu")
    assert n_j == n_t == 4
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(tmp_path / "port"))
    for name in os.listdir(tmp_path / "jax"):
        a = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(b, a, err_msg=name)
        if not name.endswith(".png"):  # the JPEGs and the BMP byte for byte
            assert (tmp_path / "jax" / name).read_bytes() == \
                (tmp_path / "port" / name).read_bytes(), name


@pytest.mark.parametrize("shape", [(37, 53), (8, 8), (1, 1), (17, 130)])
def test_gray_jpeg_and_bmp_writers_equal_cv2(shape):
    rng = np.random.default_rng(shape[0])
    g = (rng.random(shape) * 255).astype(np.uint8)
    rgb = (rng.random(shape + (3,)) * 255).astype(np.uint8)
    assert image_io.encode_jpeg(torch.from_numpy(g)) == \
        cv2.imencode(".jpg", g)[1].tobytes()
    assert bmp.encode(g) == cv2.imencode(".bmp", g)[1].tobytes()
    assert bmp.encode(rgb) == cv2.imencode(
        ".bmp", np.ascontiguousarray(rgb[..., ::-1]))[1].tobytes()
    with pytest.raises(ValueError):
        image_io.write_image("x.gif", g)


# ---- image_fixer ------------------------------------------------------------
def _damaged_folder(folder):
    """Healthy PNG, JPEG, BMP and TIFF files; truncated baseline and
    progressive JPEGs; a JPEG without EOI; a truncated PNG; one without
    IEND; a bad IDAT CRC; a broken zlib stream; a truncated BMP; an empty
    file; random bytes named .jpg."""
    rng = np.random.default_rng(4)
    folder.mkdir()
    img = _smooth(rng, 64, 80)
    for name in ("a.png", "b.jpg", "c.bmp", "d.tiff"):
        cv2.imwrite(str(folder / name), img)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    (folder / "tb.jpg").write_bytes(jpg[:len(jpg) // 2])
    (folder / "noeoi.jpg").write_bytes(jpg[:-2])
    gjpg = cv2.imencode(".jpg", gray)[1].tobytes()
    (folder / "tg.jpg").write_bytes(gjpg[:len(gjpg) * 2 // 3])
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
                        )[1].tobytes()
    (folder / "tp.jpg").write_bytes(prog[:len(prog) * 2 // 3])
    png = (folder / "a.png").read_bytes()
    (folder / "tpng.png").write_bytes(png[:len(png) // 2])
    (folder / "noiend.png").write_bytes(png[:-12])
    i = png.index(b"IDAT")
    n = int.from_bytes(png[i - 4:i], "big")
    bad = bytearray(png)
    bad[i + 4 + n] ^= 1
    (folder / "crc.png").write_bytes(bytes(bad))
    zl = bytearray(png)
    zl[i + 14] ^= 0xFF
    import zlib
    zl[i + 4 + n:i + 8 + n] = zlib.crc32(bytes(zl[i:i + 4 + n])).to_bytes(
        4, "big")
    (folder / "zl.png").write_bytes(bytes(zl))
    b = (folder / "c.bmp").read_bytes()
    (folder / "tbmp.bmp").write_bytes(b[:len(b) // 2])
    (folder / "empty.jpg").write_bytes(b"")
    (folder / "rand.jpg").write_bytes(
        rng.integers(0, 256, 500, dtype=np.uint8).tobytes())


def test_image_fixer_stages_and_fixes_equal_jax(tmp_path):
    _damaged_folder(tmp_path / "src")
    shutil.copytree(tmp_path / "src", tmp_path / "jax")
    shutil.copytree(tmp_path / "src", tmp_path / "port")
    fixer = tfix.ImageFixer(device="cpu")
    stages = {}
    for name in sorted(os.listdir(tmp_path / "src")):
        p = str(tmp_path / "src" / name)
        want, got = jfix.ImageFixer.check_image(p), fixer.check_image(p)
        stages[name] = want and want.split(":")[0]
        assert (got and got.split(":")[0]) == stages[name], name
    assert stages["tb.jpg"] == stages["tp.jpg"] == "pil_load"
    assert stages["crc.png"] == stages["empty.jpg"] == "pil_verify"
    assert stages["a.png"] is None and stages["d.tiff"] is None
    want = jfix.ImageFixer().scan_folder(str(tmp_path / "jax"), fix=True)
    got = fixer.scan_folder(str(tmp_path / "port"), fix=True)
    assert {k: got[k] for k in ("checked", "corrupted", "fixed")} == \
        {k: want[k] for k in ("checked", "corrupted", "fixed")}
    for a, b in zip(want["details"], got["details"]):
        assert os.path.basename(a["path"]) == os.path.basename(b["path"])
        assert a["problem"].split(":")[0] == b["problem"].split(":")[0]
        assert a["fixed"] == b["fixed"], a["path"]
    assert got["fixed"] >= 5
    for name in sorted(os.listdir(tmp_path / "src")):
        a = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=name)
        if name.endswith(".jpg"):  # PIL's and cv2's JPEG bytes are the port's
            assert (tmp_path / "jax" / name).read_bytes() == \
                (tmp_path / "port" / name).read_bytes(), name


def test_image_fixer_messages_are_the_ports_own(tmp_path):
    _damaged_folder(tmp_path / "src")
    fixer = tfix.ImageFixer(device="cpu")
    got = fixer.check_image(str(tmp_path / "src" / "tb.jpg"))
    want = jfix.ImageFixer.check_image(str(tmp_path / "src" / "tb.jpg"))
    assert got == "pil_load: image file is truncated"
    assert want.startswith("pil_load: image file is truncated (")
    assert fixer.check_image(str(tmp_path / "src" / "crc.png")) == \
        jfix.ImageFixer.check_image(str(tmp_path / "src" / "crc.png"))


def test_image_fixer_refuses_to_encode_webp_and_tiff(tmp_path):
    rng = np.random.default_rng(2)
    img = _smooth(rng, 32, 40)
    cv2.imwrite(str(tmp_path / "a.webp"), img)
    data = (tmp_path / "a.webp").read_bytes()
    (tmp_path / "a.webp").write_bytes(data)
    fixer = tfix.ImageFixer(device="cpu", backup_dir=str(tmp_path / "bak"))
    with pytest.raises(NotImplementedError, match="§A.8"):
        fixer.fix_image(str(tmp_path / "a.webp"))
    assert (tmp_path / "bak" / "a.webp").read_bytes() == data
    cv2.imwrite(str(tmp_path / "b.tiff"), img)
    with pytest.raises(NotImplementedError, match="§A.8"):
        fixer.fix_image(str(tmp_path / "b.tiff"))


# ---- watermark_filter and batch_repair_optimizer ----------------------------
@pytest.fixture(scope="module")
def predictors():
    return _jax(), _port()


def _record_probs(jpred):
    seen = []
    forward = jpred._forward_probs

    def recording(batch):
        out = np.asarray(forward(batch))
        seen.append(out)
        return out

    jpred._forward_probs = recording
    return seen


def test_filter_folder_moves_what_jax_moves(tmp_path, predictors):
    jpred, pred = predictors
    _write_folder(tmp_path / "src", FOLDER)
    (tmp_path / "src" / "z.png").write_bytes(b"unreadable")
    for side in ("jax", "port"):
        shutil.copytree(tmp_path / "src", tmp_path / side)
    jf = jwf.WatermarkFilter.__new__(jwf.WatermarkFilter)
    jf.threshold, jf.predictor = jwf.RATIO_THRESHOLD, jpred
    jpred.cfg.PREDICT.BATCH_SIZE = pred.cfg.PREDICT.BATCH_SIZE = 4
    seen = _record_probs(jpred)
    try:
        want = jf.filter_folder(str(tmp_path / "jax"), str(tmp_path / "jc"))
    finally:
        del jpred._forward_probs
    tf = twf.WatermarkFilter(predictor=pred)
    got = tf.filter_folder(str(tmp_path / "port"), str(tmp_path / "pc"))
    assert {k: got[k] for k in ("total", "with_watermark", "clean_moved")} \
        == {k: want[k] for k in ("total", "with_watermark", "clean_moved")}
    assert [os.path.basename(p) for p in got["moved_files"]] == \
        [os.path.basename(p) for p in want["moved_files"]]
    assert 0 < got["clean_moved"] < got["total"]
    probs = np.concatenate([s[:n] for s, n in zip(seen, (4, 2))])
    thr = jpred.cfg.PREDICT.THRESHOLD
    want_ratios = (probs > thr).mean((1, 2))
    names = sorted(os.path.basename(p) for p in tf.ratios)
    assert names == [f"{n[0]}.png" for n in FOLDER]
    for name, r in zip(names, want_ratios):
        assert abs(tf.ratios[str(tmp_path / "port" / name)] - r) <= \
            RATIO_ATOL, name
    assert tf.has_watermark(str(tmp_path / "src" / "a.png")) == (
        (jpred.predict_mask(str(tmp_path / "src" / "a.png")) > 0).mean()
        >= jwf.RATIO_THRESHOLD)


def test_batch_repair_optimizer_records_equal_jax(tmp_path, predictors):
    jpred, pred = predictors
    _write_folder(tmp_path / "src", FOLDER)
    kwargs = dict(use_ocr=False, steps=1, watermark_model="telea")
    random.seed(7)  # both packages draw a chunk's files with random.shuffle
    want = jbro.BatchRepairOptimizer(jpred, chunk_size=4).run(
        str(tmp_path / "src"), str(tmp_path / "jax"), **kwargs)
    random.seed(7)
    got = tbro.BatchRepairOptimizer(pred, chunk_size=4).run(
        str(tmp_path / "src"), str(tmp_path / "port"), **kwargs)

    def untimed(agg):
        return {**agg, "chunks": [{k: v for k, v in c.items() if k != "time"}
                                  for c in agg["chunks"]]}

    assert untimed(got) == untimed(want)
    assert len(got["chunks"]) == 2 and got["total_images"] == 6
    assert got["processed"] == sum(c["images"] for c in got["chunks"]) > 0
    masks = sorted(os.listdir(tmp_path / "port" / "step1_masks"))
    assert masks == sorted(os.listdir(tmp_path / "jax" / "step1_masks"))
    for name in masks:
        np.testing.assert_array_equal(
            image_io.read_gray(str(tmp_path / "port" / "step1_masks" / name)),
            cv2.imread(str(tmp_path / "jax" / "step1_masks" / name),
                       cv2.IMREAD_GRAYSCALE), err_msg=name)


# ---- extract_watermarks ----------------------------------------------------
def _pairs(root, rng):
    for d in ("w", "c"):
        os.makedirs(os.path.join(root, d))
    for i in range(3):
        clean = _smooth(rng, 120, 160)
        wm = clean.copy()
        for _ in range(3):
            x, y = (int(v) for v in rng.integers(0, [130, 95]))
            cv2.putText(wm, "AB", (x, y + 20), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                        (255, 255, 255), 2)
        cv2.imwrite(os.path.join(root, "w", f"{i}.png"), wm)
        if i == 2:  # a clean image of another size: resized to the pair's
            clean = cv2.resize(clean, (150, 110))
        cv2.imwrite(os.path.join(root, "c", f"{i}.png"), clean)
    cv2.imwrite(os.path.join(root, "w", "alone.png"), _smooth(rng, 20, 20))


def test_extractor_boxes_and_assets_equal_jax(tmp_path):
    _pairs(tmp_path, np.random.default_rng(1))
    j, t = jex.WatermarkExtractor(), tex.WatermarkExtractor(device="cpu")
    want = j.batch_extract(str(tmp_path / "w"), str(tmp_path / "c"),
                           str(tmp_path / "oj"))
    got = t.batch_extract(str(tmp_path / "w"), str(tmp_path / "c"),
                          str(tmp_path / "op"))
    assert got == want and got["assets"] >= 3
    for name in sorted(os.listdir(tmp_path / "oj")):
        a = np.array(Image.open(tmp_path / "oj" / name))
        b = np.array(Image.open(tmp_path / "op" / name))
        assert a.shape == b.shape and a.shape[2] == 4, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for i in range(3):
        wm = cv2.imread(str(tmp_path / "w" / f"{i}.png"))
        cl = cv2.imread(str(tmp_path / "c" / f"{i}.png"))
        jm = j.diff_mask(wm, cl)
        tm = t.diff_mask(torch.from_numpy(wm[..., ::-1].copy()),
                         torch.from_numpy(cl[..., ::-1].copy()))
        np.testing.assert_array_equal(tm.numpy(), jm)
        assert t.cluster_regions(tm) == j.cluster_regions(jm)
