"""The port's OCR package (unet_watermark_tpu_torch/ocr) against the JAX
package's, on the CPU: the builtin detector's region lists and text masks
on the same PNG files (PIL-drawn text, and block letters drawn by
utils/synthetic.text_images), the engine registry's easyocr fallback, the
PaddleOCR client through a mock PaddleX service, and the predictor's
_enhance_text_features."""
import sys
import threading
import types
from http.server import HTTPServer

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from test_easyocr_fixture import RECORDED
from test_ocr_http import MockPaddleHandler
from unet_watermark_tpu import ocr as jax_ocr
from unet_watermark_tpu.inference.predict import \
    WatermarkPredictor as JaxPredictor
from unet_watermark_tpu_torch import ocr
from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
from unet_watermark_tpu_torch.utils import image_io
from unet_watermark_tpu_torch.utils.synthetic import text_images

TEXT_SHAPES = [(64, 64), (100, 140), (257, 311), (512, 512)]


def _pil_text(path, size, text, ink, bg, at):
    img = Image.new("RGB", size, bg)
    ImageDraw.Draw(img).text(at, text, fill=ink)
    img.save(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """PNG files written by PIL (text drawn by PIL, as
    tests/test_predictor.py draws it) and by the port's encoder (block
    letters over synthetic photos, one over a logo)."""
    d = tmp_path_factory.mktemp("ocr")
    paths = []
    for i, (size, text, ink, bg) in enumerate((
            ((200, 100), "WATERMARK TEXT", (255, 255, 255), (30, 30, 30)),
            ((320, 90), "Sample text 2026", (20, 20, 20), (230, 220, 200)),
            ((64, 64), "", (0, 0, 0), (255, 255, 255)))):
        p = d / f"pil{i}.png"
        _pil_text(p, size, text, ink, bg, (10, size[1] // 2 - 5))
        paths.append(p)
    imgs, _, _ = text_images(TEXT_SHAPES, seed=3, logo=[False, True])
    for i, img in enumerate(imgs):
        p = d / f"glyph{i}.png"
        image_io.write_png(p, img)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def detectors():
    return jax_ocr.BuiltinTextDetector(), \
        ocr.BuiltinTextDetector(device="cpu")


def test_builtin_regions_and_masks_equal_jax(files, detectors):
    jd, td = detectors
    found = 0
    for p in files:
        regions = td.detect_text_regions(str(p))
        assert regions == jd.detect_text_regions(str(p)), p.name
        found += bool(regions)
        np.testing.assert_array_equal(td.generate_text_mask(str(p)),
                                      jd.generate_text_mask(str(p)))
    assert found >= len(files) - 1  # all but the blank PIL image


def test_builtin_finds_every_drawn_line(detectors):
    """text_images' lines, each covered to at least 90 % by the text mask,
    as phase 3e of chip_smoke.py checks at 512² and above. Glyph pixels of
    4-6 px here; below ~200 px the glyphs are 2-3 px and the detector (the
    JAX package's as well: the regions are equal) misses some lines."""
    _, td = detectors
    imgs, boxes, _ = text_images([(257, 311), (512, 512), (512, 512)], seed=5,
                              logo=[True])
    for img, lines in zip(imgs, boxes):
        mask = td.generate_text_mask(img)
        for x, y, w, h in lines:
            assert (mask[y:y + h, x:x + w] > 0).mean() >= 0.9


def test_array_and_pil_inputs(detectors, files):
    """An (H, W, 3) RGB array or a PIL image gives what its file gives; the
    JAX package takes the PIL image (converting it to BGR)."""
    jd, td = detectors
    path = str(files[0])
    rgb = image_io.read_rgb(path)
    pil = Image.open(path).convert("RGB")
    expect = jd.generate_text_mask(path)
    np.testing.assert_array_equal(td.generate_text_mask(rgb), expect)
    np.testing.assert_array_equal(td.generate_text_mask(pil), expect)
    np.testing.assert_array_equal(jd.generate_text_mask(pil), expect)
    with pytest.raises(ValueError):
        td.generate_text_mask(rgb[..., 0])
    big = files[0].parent.parent / "photo.tif"  # a BigTIFF: not ported yet
    big.write_bytes(b"II+\x00\x08\x00\x00\x00" + bytes(8))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        td.detect_text_regions(str(big))


def test_batch_process_equals_jax(files, detectors, tmp_path):
    """The seeded random limit picks the same files; the masks match."""
    jd, td = detectors
    src = files[0].parent
    js = jd.batch_process(str(src), str(tmp_path / "j"), limit=4)
    ts = td.batch_process(str(src), str(tmp_path / "t"), limit=4)
    assert ts == js and ts["processed"] == 4
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        np.testing.assert_array_equal(
            image_io.read_gray(tmp_path / "t" / n),
            cv2.imread(str(tmp_path / "j" / n), cv2.IMREAD_GRAYSCALE))


def test_batch_process_rejects_undecoded_types_first(files, detectors,
                                                      tmp_path):
    """A folder holding a BigTIFF file (a form not ported yet) raises
    before any mask is written, as process_folder_batch does. A BMP file
    is read now: its text mask equals the JAX detector's on the same
    file."""
    jd, td = detectors
    src = tmp_path / "src"
    src.mkdir()
    for p in files[:2]:
        (src / p.name).write_bytes(p.read_bytes())
    (src / "zz.tif").write_bytes(b"II+\x00\x08\x00\x00\x00" + bytes(8))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        td.batch_process(str(src), str(tmp_path / "out"))
    assert not any((tmp_path / "out").iterdir())
    bmp = tmp_path / "glyphs.bmp"
    cv2.imwrite(str(bmp), cv2.imread(str(files[3])))
    np.testing.assert_array_equal(td.generate_text_mask(str(bmp)),
                                  jd.generate_text_mask(str(bmp)))
    assert td.detect_text_regions(str(bmp)) == jd.detect_text_regions(
        str(bmp))


def _no_entropy_decode(*args, **kwargs):
    raise AssertionError("the pixels were decoded")


def test_builtin_detector_decodes_a_jpeg_path_on_its_device(
        files, detectors, tmp_path, monkeypatch):
    """A JPEG path goes through image_io.read_rgb_tensor on the detector's
    device, not through the host reader; its regions and mask equal the
    JAX detector's on the same file."""
    jd, td = detectors
    img = cv2.imread(str(files[3]))
    path = str(tmp_path / "g.jpg")
    assert cv2.imwrite(path, img)
    monkeypatch.setattr(image_io, "read_rgb", _no_entropy_decode)
    regions = td.detect_text_regions(path)
    assert regions and regions == jd.detect_text_regions(path)
    np.testing.assert_array_equal(td.generate_text_mask(path),
                                  jd.generate_text_mask(path))


class _RecordingReader:
    """easyocr.Reader stand-in: records its arguments, returns the
    readtext results recorded in tests/test_easyocr_fixture.py."""
    made = []

    def __init__(self, languages, gpu=False, verbose=False):
        self.languages, self.gpu = list(languages), gpu
        _RecordingReader.made.append(self)

    def readtext(self, img):
        return list(RECORDED)


@pytest.mark.parametrize("device,gpu", [("cpu", False), ("cuda", True),
                                        ("cuda:1", "cuda:1")])
def test_easy_reader_runs_on_the_callers_device(monkeypatch, tmp_path,
                                                device, gpu):
    """With easyocr installed, get_ocr_detector("easy") gives the EasyOCR
    detector on the caller's device (the card by default), and its regions
    equal the JAX package's on the same reader output."""
    from unet_watermark_tpu.ocr.easy_ocr import \
        EasyOCRDetector as JaxEasyOCRDetector

    mod = types.ModuleType("easyocr")
    mod.Reader = _RecordingReader
    monkeypatch.setitem(sys.modules, "easyocr", mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    _RecordingReader.made = []
    path = tmp_path / "img.png"
    image_io.write_png(path, np.full((80, 100, 3), 200, np.uint8))
    det = ocr.get_ocr_detector("easy", device=device)
    assert isinstance(det, ocr.EasyOCRDetector) and det.name == "easy"
    assert det.device == torch.device(device)
    regions = det.detect_text_regions(str(path))
    assert _RecordingReader.made[-1].gpu == gpu
    assert regions == JaxEasyOCRDetector().detect_text_regions(str(path))
    assert len(regions) == 2
    default = ocr.get_ocr_detector("easy")
    default.detect_text_regions(str(path))
    assert default.device.type == "cuda" and _RecordingReader.made[-1].gpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ocr.EasyOCRDetector()


def test_easy_falls_back_to_builtin_in_both_packages():
    det = ocr.get_ocr_detector("easy", device="cpu")
    assert isinstance(det, ocr.BuiltinTextDetector)
    assert det.name == "builtin" and det.device.type == "cpu"
    assert isinstance(jax_ocr.get_ocr_detector("easy"),
                      jax_ocr.BuiltinTextDetector)
    assert isinstance(ocr.get_ocr_detector("builtin", device="cpu"),
                      ocr.BuiltinTextDetector)
    assert ocr.get_ocr_detector("paddle").name == "paddle"
    with pytest.raises(ValueError):
        ocr.get_ocr_detector("tesseract")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ocr.BuiltinTextDetector()


@pytest.fixture()
def mock_server():
    server = HTTPServer(("127.0.0.1", 0), MockPaddleHandler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_port}/ocr"
    server.shutdown()
    server.server_close()
    t.join(timeout=5)
    assert not t.is_alive()


PADDLE_PAYLOADS = {
    "dt_polys": {"dt_polys": [[[1, 2], [20, 2], [20, 10], [1, 10]],
                              [[30, 5], [55, 9], [52, 30], [28, 25]]]},
    "rec_polys": {"rec_polys": [[[4, 4], [40, 8], [38, 20], [2, 16]]]},
    "rec_boxes": {"rec_boxes": [[2, 3, 15, 12], [20, 20, 58, 38]]},
}


@pytest.mark.parametrize("key", list(PADDLE_PAYLOADS))
def test_paddle_client_equals_jax(mock_server, tmp_path, key):
    MockPaddleHandler.response_payload = {"ocrResults": [
        {"prunedResult": PADDLE_PAYLOADS[key]}]}
    p = str(tmp_path / "img.png")
    Image.fromarray(np.zeros((40, 60, 3), np.uint8)).save(p)
    jd = jax_ocr.PaddleOCRProcessor(api_url=mock_server)
    td = ocr.PaddleOCRProcessor(api_url=mock_server)
    regions = td.detect_text_regions(p)
    assert regions and regions == jd.detect_text_regions(p)
    np.testing.assert_array_equal(td.generate_text_mask(p),
                                  jd.generate_text_mask(p))


def test_paddle_batch_process_reads_no_jpeg_pixels(mock_server, tmp_path,
                                                   monkeypatch):
    """The PaddleOCR client sends the file; its masks take each image's size
    from the headers, so a JPEG folder (one EXIF-rotated file among them)
    is never entropy-decoded. Masks and counts equal the JAX client's."""
    from unet_watermark_tpu_torch.ops.kernels import jpeg_entropy
    from unet_watermark_tpu_torch.utils import jpeg

    MockPaddleHandler.response_payload = {"ocrResults": [
        {"prunedResult": PADDLE_PAYLOADS["dt_polys"]}]}
    src = tmp_path / "src"
    src.mkdir()
    for i, (h, w) in enumerate(((40, 60), (64, 48))):
        ok, data = cv2.imencode(".jpg", np.full((h, w, 3), 40 * i, np.uint8))
        (src / f"p{i}.jpg").write_bytes(data.tobytes())
    rotated = bytearray((src / "p1.jpg").read_bytes())  # APP1 Exif, MM,
    rotated[2:2] = bytes.fromhex(  # orientation 6
        "ffe10022457869660000""4d4d002a00000008""0001011200030000"
        "000100060000""00000000")
    (src / "p1.jpg").write_bytes(bytes(rotated))
    assert cv2.imread(str(src / "p1.jpg")).shape[:2] == (48, 64)
    monkeypatch.setattr(jpeg_entropy, "decode_scans", _no_entropy_decode)
    monkeypatch.setattr(jpeg, "decode_scans", _no_entropy_decode)
    jd = jax_ocr.PaddleOCRProcessor(api_url=mock_server)
    td = ocr.PaddleOCRProcessor(api_url=mock_server)
    js = jd.batch_process(str(src), str(tmp_path / "j"))
    ts = td.batch_process(str(src), str(tmp_path / "t"))
    assert ts == js and ts["processed"] == 2
    for n in ("p0_mask.png", "p1_mask.png"):
        np.testing.assert_array_equal(
            image_io.read_gray(tmp_path / "t" / n),
            cv2.imread(str(tmp_path / "j" / n), cv2.IMREAD_GRAYSCALE))


def test_paddle_client_service_down(tmp_path):
    p = str(tmp_path / "img.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(p)
    det = ocr.PaddleOCRProcessor(api_url="http://127.0.0.1:1/ocr",
                                 timeout=0.5)
    assert det.detect_text_regions(p) == []
    mask = det.generate_text_mask(p)
    assert mask.shape == (8, 8) and not mask.any()


@pytest.mark.parametrize("shape", [(64, 64), (100, 140), (257, 311),
                                   (135, 240)], ids=str)
def test_enhance_text_features_equals_jax(shape):
    """CLAHE → Canny → 2x2 dilate → x1.2 on edges → sharpen, on the same
    RGB image; neither method reads its predictor's state."""
    imgs, _, _ = text_images([shape], seed=sum(shape), logo=[True])
    rgb = imgs[0]
    ref = JaxPredictor._enhance_text_features(None, rgb)
    got = WatermarkPredictor._enhance_text_features(None, torch.from_numpy(rgb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != rgb).any()
