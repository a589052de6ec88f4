"""The SD3 and FLUX shells of the port (diffusion/sd3_inpaint.py,
diffusion/flux_process.py) against the JAX package's, on the CPU, where
neither package finds diffusers.

Exact: detect_text_regions' masks (the guards and the max_mask_ratio clear
included), normalize_size over a grid, RATIO_GATE on both of its sides, the
rung each ladder takes and what it hands that rung (the same image, mask
and steps), the push-pull rung's output, and the counts of process_folder
and process_batch. The native latent-diffusion rung draws its noise from
torch where JAX draws it from jax.random (tests/test_torch_latent_diffusion
holds that engine), so its fill is compared outside the holes only, where
both return the input.
"""
import os

import cv2
import numpy as np
import pytest

import unet_watermark_tpu.diffusion.flux_process as JF
import unet_watermark_tpu.diffusion.latent_diffusion as JLD
import unet_watermark_tpu.diffusion.sd3_inpaint as JS
import unet_watermark_tpu.ocr as jocr
import unet_watermark_tpu_torch.diffusion.flux_process as PF
import unet_watermark_tpu_torch.diffusion.latent_diffusion as PLD
import unet_watermark_tpu_torch.diffusion.sd3_inpaint as PS
import unet_watermark_tpu_torch.ocr as pocr
from unet_watermark_tpu_torch import diffusion
from unet_watermark_tpu_torch.utils import image_io
from unet_watermark_tpu_torch.utils.synthetic import text_images

SHAPES = [(96, 128), (160, 160), (200, 320), (257, 311)]


@pytest.fixture(scope="module")
def images():
    imgs, _, _ = text_images(SHAPES, seed=11, logo=[True, False, True])
    return [np.ascontiguousarray(im[..., ::-1]) for im in imgs]  # BGR


def test_exports_and_probe():
    assert diffusion.__all__ == ["SDWatermarkRemover", "FluxProcessor",
                                 "diffusers_available"]
    assert PS.diffusers_available() is JS.diffusers_available() is False
    assert PS.SDWatermarkRemover(device="cpu")._load_pipe() is None
    assert PF.FluxProcessor(device="cpu").init_model() is None


@pytest.mark.parametrize("guards", [
    {}, {"min_region_area": 50}, {"max_region_ratio": 0.002},
    {"max_mask_ratio": 0.001}, {"max_mask_ratio": 0.02}])
def test_detect_text_regions_equals_jax(images, guards):
    j = JS.SDWatermarkRemover(**guards)
    p = PS.SDWatermarkRemover(device="cpu", **guards)
    found = 0
    for img in images:
        a, b = j.detect_text_regions(img), p.detect_text_regions(img)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert np.array_equal(a, b)
        found += int(b.any())
    if not guards:
        assert found >= len(images) - 1  # text found (not on one image)
    if guards.get("max_mask_ratio") == 0.001:
        assert found == 0  # the clear


def _record(calls, result):
    def native(image_bgr, mask, steps=20, **kw):
        calls.append((image_bgr.copy(), mask.copy(), steps))
        return result(image_bgr, mask)
    return native


def _paint(image_bgr, mask):
    out = image_bgr.copy()
    out[mask > 127] = (10, 200, 30)
    return out


def test_sd3_ladder_takes_the_native_rung_as_jax(images, monkeypatch):
    jc, pc = [], []
    monkeypatch.setattr(JLD, "diffusion_inpaint_bgr", _record(jc, _paint))
    monkeypatch.setattr(PLD, "diffusion_inpaint_bgr", _record(pc, _paint))
    j, p = JS.SDWatermarkRemover(), PS.SDWatermarkRemover(device="cpu")
    found = 0
    for img in images:
        a, b = j.remove_watermark_auto(img), p.remove_watermark_auto(img)
        assert np.array_equal(a, b)
        hit = p.detect_text_regions(img).any()
        assert p.rung == ("latent-diffusion" if hit else None)
        found += int(hit)
    assert len(jc) == len(pc) == found > 0
    for (ja, jm, js), (pa, pm, ps) in zip(jc, pc):
        assert np.array_equal(ja, pa) and np.array_equal(jm, pm)
        assert js == ps == 25
    # a mask over max_mask_ratio skips the pipe for the same rung; an
    # empty one returns the image
    mask = np.full(images[0].shape[:2], 255, np.uint8)
    assert np.array_equal(j.remove_watermark_with_mask(images[0], mask),
                          p.remove_watermark_with_mask(images[0], mask))
    empty = np.zeros_like(mask)
    assert p.remove_watermark_with_mask(images[0], empty) is images[0]
    assert p.rung is None


def test_sd3_pushpull_rung_equals_jax(images, monkeypatch):
    monkeypatch.setattr(JLD, "diffusion_inpaint_bgr", lambda *a, **k: None)
    monkeypatch.setattr(PLD, "diffusion_inpaint_bgr", lambda *a, **k: None)
    j, p = JS.SDWatermarkRemover(), PS.SDWatermarkRemover(device="cpu")
    for img in images[:2]:
        mask = j.detect_text_regions(img)
        a = j._fallback_inpaint(img, mask)
        b = p._fallback_inpaint(img, mask)
        assert p.rung == "pushpull"
        assert np.array_equal(a, b)
        keep = mask <= 127
        assert np.array_equal(b[keep], img[keep])


def test_native_rung_keeps_pixels_outside_the_mask(images):
    """The port's real second rung with the shipped weights (2 steps):
    outside the mask the input's pixels, as JAX returns them."""
    if PLD.default_weights_path() is None:
        pytest.skip("latent_diffusion.npz is not in this tree")
    p = PS.SDWatermarkRemover(steps=2, device="cpu")
    img, mask = next((im, m) for im, m in (
        (im, p.detect_text_regions(im)) for im in images) if m.any())
    out = p.remove_watermark_with_mask(img, mask)
    assert p.rung == "latent-diffusion" and out.shape == img.shape
    keep = mask <= 127
    assert np.array_equal(out[keep], img[keep])
    assert not np.array_equal(out[~keep], img[~keep])


def test_flux_remove_watermark_equals_jax(images, monkeypatch):
    """No pipe: the builtin detector's text mask, then the native rung (a
    stub that paints the mask, the same in both)."""
    jc, pc = [], []
    monkeypatch.setattr(JLD, "diffusion_inpaint_bgr", _record(jc, _paint))
    monkeypatch.setattr(PLD, "diffusion_inpaint_bgr", _record(pc, _paint))
    j, p = JF.FluxProcessor(), PF.FluxProcessor(device="cpu")
    for img in images:
        a, b = j.remove_watermark(img), p.remove_watermark(img)
        assert np.array_equal(a, b)
    assert len(jc) == len(pc) > 0
    for (_, jm, js), (_, pm, ps) in zip(jc, pc):
        assert np.array_equal(jm, pm) and js == ps == 20


def test_normalize_size_equals_jax():
    for w in range(1, 2400, 7):
        for h in range(1, 2400, 11):
            assert PF.normalize_size(w, h) == JF.normalize_size(w, h)
    for kw in ({"min_side": 256, "max_side": 768, "multiple": 16},
               {"multiple": 1}):
        for w in range(1, 1600, 13):
            for h in range(1, 1600, 17):
                assert PF.normalize_size(w, h, **kw) == \
                    JF.normalize_size(w, h, **kw)


@pytest.mark.parametrize("ratio", [0.0, 0.0009, 0.001, 0.25, 0.5, 0.5004])
def test_ratio_gate_equals_jax(ratio, monkeypatch):
    assert PF.RATIO_GATE == JF.RATIO_GATE == (0.001, 0.5)
    h, w = 50, 100
    mask = np.zeros((h, w), np.uint8)
    mask.reshape(-1)[:int(round(ratio * h * w))] = 255

    class Det:
        def generate_text_mask(self, image):
            return mask

    monkeypatch.setattr(jocr, "get_ocr_detector", lambda *a, **k: Det())
    monkeypatch.setattr(pocr, "get_ocr_detector", lambda *a, **k: Det())
    monkeypatch.setattr(JLD, "diffusion_inpaint_bgr", _paint)
    monkeypatch.setattr(PLD, "diffusion_inpaint_bgr",
                        lambda i, m, **k: _paint(i, m))
    img = np.full((h, w, 3), 90, np.uint8)
    (a, ja), (b, pa) = (JF.FluxProcessor().remove_text_watermark(img),
                        PF.FluxProcessor(device="cpu")
                        .remove_text_watermark(img))
    assert ja == pa
    assert pa["acted"] == (0.001 <= pa["text_ratio"] <= 0.5)
    assert np.array_equal(a, b)


def _folder(root):
    rng = np.random.default_rng(2)
    root.mkdir()
    for i in range(6):
        image_io.write_png(root / f"f{i}.png",
                           rng.integers(0, 256, (40, 60, 3), np.uint8))
    (root / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nnot a png")
    (root / "notes.txt").write_text("skipped: not an image")
    return root


def _tree(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


@pytest.mark.parametrize("limit", [None, 3])
def test_process_folder_counts_equal_jax(tmp_path, limit, monkeypatch):
    src = _folder(tmp_path / "in")
    monkeypatch.setattr(JS.SDWatermarkRemover, "remove_watermark_auto",
                        lambda self, img: img)
    monkeypatch.setattr(PS.SDWatermarkRemover, "remove_watermark_auto",
                        lambda self, img: img)
    outs = {}
    for pkg, remover in (("jax", JS.SDWatermarkRemover()),
                         ("port", PS.SDWatermarkRemover(device="cpu"))):
        out = tmp_path / pkg
        out.mkdir()
        cv2.imwrite(str(out / "f0.png"), np.zeros((4, 4, 3), np.uint8))
        outs[pkg] = remover.process_folder(str(src), str(out), limit=limit,
                                           seed=9)
    assert outs["port"] == outs["jax"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for name in _tree(tmp_path / "port"):
        if name != "f0.png":
            assert np.array_equal(
                image_io.read_rgb(tmp_path / "port" / name),
                image_io.read_rgb(src / name))


@pytest.mark.parametrize("mode", ["text", "prompt"])
def test_process_batch_counts_equal_jax(tmp_path, mode, monkeypatch):
    src = _folder(tmp_path / "in")

    def text(self, img):
        return img, {"text_ratio": 0.0, "acted": bool(img[0, 0, 0] % 2)}

    for cls in (JF.FluxProcessor, PF.FluxProcessor):
        monkeypatch.setattr(cls, "remove_text_watermark", text)
        monkeypatch.setattr(cls, "remove_watermark", lambda self, img: img)
    outs = {}
    for pkg, proc in (("jax", JF.FluxProcessor()),
                      ("port", PF.FluxProcessor(device="cpu"))):
        out = tmp_path / pkg
        out.mkdir()
        cv2.imwrite(str(out / "f1.png"), np.zeros((4, 4, 3), np.uint8))
        outs[pkg] = proc.process_batch(str(src), str(out), limit=4,
                                       mode=mode)
    assert outs["port"] == outs["jax"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_undecodable_formats_are_refused_first(tmp_path):
    """An animated .webp in the folder (a form not ported yet; a still
    WEBP decodes): the port refuses it (ROADMAP.md §A.5) before any output
    is written, where cv2 would read its first frame."""
    import struct

    src = _folder(tmp_path / "in")
    vp8x = b"VP8X" + struct.pack("<I", 10) + bytes([2, 0, 0, 0]) + bytes(6)
    (src / "w.webp").write_bytes(b"RIFF" + struct.pack("<I", 4 + len(vp8x))
                                 + b"WEBP" + vp8x)
    for run in (lambda out: PS.SDWatermarkRemover(device="cpu")
                .process_folder(str(src), out),
                lambda out: PF.FluxProcessor(device="cpu")
                .process_batch(str(src), out)):
        out = tmp_path / f"out{len(os.listdir(tmp_path))}"
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            run(str(out))
        assert _tree(out) == []
