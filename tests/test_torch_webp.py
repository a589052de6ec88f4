"""WEBP decoding (utils/webp.py, csrc/webp_decode.c, ops/webp.py) against
cv2 5.0.0's and Pillow 12.1's libwebp, bit for bit: files cv2.imencode
writes (lossy at several qualities, lossless, with alpha), the synthetic
writers' files (utils/synthetic: every 16x16, B_PRED and chroma mode,
segments, 1-8 token partitions, both loop filters; every VP8L transform,
the colour cache, backward references, meta prefix codes; ALPH with both
methods and every filter), the container's chunks (EXIF orientation, ICCP,
XMP), and cut or corrupt files (unreadable where cv2 gives None). Then the
slice against the JAX package: repair on a folder of WEBP and TIFF files,
and gen_data's PIL reads of WEBP logos."""
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from unet_watermark_tpu_torch.utils import image_io, synthetic, webp

RNG_SEED = 21


def _content(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "palette":
        pal = rng.integers(0, 256, (5 + seed % 11, 3))
        return pal[rng.integers(0, len(pal), (h, w))].astype(np.uint8)
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                            (0, 0), 1.5 + seed % 3)


def _check(tmp_path, data: bytes, name: str = "x.webp") -> None:
    """Every reader against cv2's and PIL's decode of the same file."""
    path = tmp_path / name
    path.write_bytes(data)
    ref = cv2.imread(str(path))
    assert ref is not None
    np.testing.assert_array_equal(image_io.read_rgb(path), ref[..., ::-1])
    np.testing.assert_array_equal(image_io.read_gray(path), cv2.imread(
        str(path), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(
        image_io.read_rgb_tensor(path, "cpu").numpy(), ref[..., ::-1])
    np.testing.assert_array_equal(
        image_io.read_rgba_tensor(path, "cpu").numpy(),
        np.asarray(Image.open(path).convert("RGBA")))
    assert image_io.check_image(path) == ref.shape[:2]


@pytest.mark.parametrize("quality", [5, 40, 80, 100, 101])
@pytest.mark.parametrize("kind", ["blur", "noise", "palette"])
@pytest.mark.parametrize("alpha", [False, True])
def test_cv2_encoded_files_decode_as_cv2(tmp_path, quality, kind, alpha):
    """cv2.imencode's files (101: lossless) of odd sizes."""
    img = _content(kind, 37, 53, quality + len(kind))
    if alpha:
        a = np.tile(np.linspace(0, 255, 53).astype(np.uint8), (37, 1))
        img = np.dstack([img, a])
    ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])
    _check(tmp_path, buf.tobytes())


@pytest.mark.parametrize("partitions", [1, 2, 4, 8])
@pytest.mark.parametrize("loop_filter", ["normal", "simple", None])
@pytest.mark.parametrize("segments", [False, True])
def test_synthetic_vp8_frames_decode_as_cv2(tmp_path, partitions,
                                            loop_filter, segments):
    """Random modes (every 16x16, B_PRED and chroma mode), skips and levels
    of every token category, at sizes that end inside a macroblock."""
    seed = partitions * 7 + len(str(loop_filter)) + segments
    _check(tmp_path, synthetic.vp8_bytes(35, 50, seed, partitions, segments,
                                         loop_filter))


def test_vp8_of_an_image_approximates_it(tmp_path):
    """The writer's image mode (DC prediction, one level a block) decodes
    as cv2 decodes it and lies near the image it was made from."""
    img = _content("blur", 48, 64, 3)
    data = synthetic.vp8_bytes(48, 64, 3, image=img)
    _check(tmp_path, data)
    got = webp.decode(data, "cpu").numpy().astype(int)
    assert np.abs(got - img).mean() < 12


@pytest.mark.parametrize("transforms", [
    (), ("subtract_green",), ("predictor",), ("cross_color",), ("palette",),
    ("subtract_green", "predictor", "cross_color"), ("palette", "predictor")])
@pytest.mark.parametrize("options", [{}, {"cache_bits": 5, "backrefs": True,
                                          "meta_bits": 2}])
def test_synthetic_vp8l_streams_are_lossless(tmp_path, transforms, options):
    img = _content("palette" if "palette" in transforms else "blur", 29, 43,
                   len(transforms))
    alpha = np.random.default_rng(2).integers(0, 256, img.shape[:2],
                                              dtype=np.uint8)
    if "palette" in transforms:  # as few colours as the image has
        alpha = np.where(img[..., 0] > 127, 255, 40).astype(np.uint8)
    rgba = np.dstack([img, alpha])
    data = synthetic.vp8l_bytes(rgba, transforms, seed=5, **options)
    _check(tmp_path, data)
    np.testing.assert_array_equal(webp.decode(data, "cpu", exif=False,
                                              rgba=True).numpy(), rgba)


@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("filtering", [0, 1, 2, 3])
def test_alph_methods_and_filters(tmp_path, method, filtering):
    """A VP8 frame with an ALPH chunk: cv2 drops the alpha (its colours
    are not premultiplied), PIL keeps it exactly."""
    alpha = np.random.default_rng(filtering).integers(0, 256, (30, 40),
                                                      dtype=np.uint8)
    alpha[:, :10] = 0
    frame = synthetic.vp8_bytes(30, 40, 4)[20:]
    data = synthetic.webp_container(b"VP8 ", frame, alpha=synthetic.alph_bytes(
        alpha, method, filtering, **({"transforms": ("predictor",)}
                                     if method else {})))
    _check(tmp_path, data)
    np.testing.assert_array_equal(
        webp.decode(data, "cpu", exif=False, rgba=True).numpy()[..., 3], alpha)


def _exif(orientation: int, big: bool = False) -> bytes:
    e = ">" if big else "<"
    return ((b"MM\0*" if big else b"II*\0") + struct.pack(e + "IH", 8, 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))


@pytest.mark.parametrize("form", ["1", "2", "3", "4", "5", "6", "7", "8",
                                  "big6", "prefixed6", "unflagged6",
                                  "icc_xmp", "alph_unflagged"])
def test_extended_files_and_exif_orientation(tmp_path, form):
    """cv2.imread applies the first EXIF chunk's orientation where VP8X's
    EXIF flag is set (the TIFF header at the chunk's first byte; an
    "Exif" prefix hides it); PIL applies none; ICCP and XMP are skipped;
    an ALPH chunk without VP8X's alpha flag reads as opaque in PIL."""
    frame = synthetic.vp8_bytes(24, 40, 6)[20:]
    if form == "alph_unflagged":  # PIL reads it opaque
        alpha = np.arange(24 * 40, dtype=np.uint8).reshape(24, 40)
        data = bytearray(synthetic.webp_container(
            b"VP8 ", frame, alpha=synthetic.alph_bytes(alpha, 0)))
        data[20] &= ~0x10
        data = bytes(data)
    elif form == "icc_xmp":
        data = synthetic.webp_container(b"VP8 ", frame, icc=b"icc" * 9,
                                        xmp=b"<x/>")
    else:
        o = int(form[-1])
        exif = _exif(o, big=form.startswith("big"))
        if form.startswith("prefixed"):
            exif = b"Exif\0\0" + exif
        data = bytearray(synthetic.webp_container(b"VP8 ", frame, exif=exif))
        if form.startswith("unflagged"):
            data[20] &= ~0x08
        data = bytes(data)
    _check(tmp_path, data)


def test_cut_and_corrupt_files_are_unreadable(tmp_path):
    """Every cut and corruption cv2 gives None for raises one of
    UNREADABLE (libwebp's checks: the RIFF size against the file, the
    chunk sizes, the VP8 partitions, the VP8L stream's end); one that
    cv2 decodes decodes the same."""
    rng = np.random.default_rng(RNG_SEED)
    alpha = rng.integers(0, 256, (40, 56), dtype=np.uint8)
    lossy = synthetic.webp_container(
        b"VP8 ", synthetic.vp8_bytes(40, 56, 1)[20:],
        alpha=synthetic.alph_bytes(alpha, 1, 1))
    lossless = synthetic.vp8l_bytes(_content("blur", 40, 56, 1),
                                    ("predictor", "cross_color"))
    cases = []
    for data in (lossy, lossless):
        cases += [data[:n] for n in (len(data) - 1, len(data) // 2, 40, 20,
                                     11)]
        for at in (len(data) // 2, len(data) - 5, 30):
            bad = bytearray(data)
            bad[at] ^= 0x55
            cases.append(bytes(bad))
        bad = bytearray(data)
        bad[4:8] = struct.pack("<I", len(data))
        cases.append(bytes(bad))
        cases.append(data + b"junk")
    unreadable = 0
    for i, data in enumerate(cases):
        path = tmp_path / f"c{i}.webp"
        path.write_bytes(data)
        ref = cv2.imread(str(path))
        if ref is None:
            unreadable += 1
            with pytest.raises(image_io.UNREADABLE):
                image_io.read_rgb(path)
        else:
            np.testing.assert_array_equal(image_io.read_rgb(path),
                                          ref[..., ::-1])
    assert unreadable >= len(cases) // 2


def test_animated_files_are_refused(tmp_path):
    vp8x = b"VP8X" + struct.pack("<I", 10) + bytes([0x02, 0, 0, 0]) + bytes(6)
    path = tmp_path / "a.webp"
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(vp8x)) + b"WEBP"
                     + vp8x)
    for call in (image_io.require_decodable, image_io.read_rgb,
                 lambda p: image_io.read_rgba_tensor(p, "cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md §A.5"):
            call(path)


def test_no_decoder_no_read(tmp_path, monkeypatch):
    """A C decoder that does not build makes the read raise, and not as an
    unreadable file (the pipeline would skip it): nothing falls back to
    another path."""
    from unet_watermark_tpu_torch.ops.kernels import build
    from unet_watermark_tpu_torch.ops.kernels import webp as webp_c

    path = tmp_path / "x.webp"
    path.write_bytes(synthetic.vp8_bytes(16, 16, 0))
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    webp_c._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="cannot run"):
            image_io.read_rgb(path)
    finally:
        webp_c._lib.cache_clear()


# -- the slice against the JAX package ---------------------------------------

def test_repair_folder_of_webp_and_tiff_matches_jax(tmp_path):
    """process_folder_batch (no OCR) on WEBP (lossy, lossless with alpha)
    and TIFF (LZW with predictor 2, tiled Deflate, PackBits planar) files
    in both packages: step-1 masks equal, repaired images within
    REPAIR_LSB, merged masks equal, stats equal apart from times, as for
    the JPEG folder (tests/test_torch_repair.py). (The JAX package's
    IMAGE_EXTS takes .tiff, not .tif: a .tif file is skipped by both.)"""
    from test_torch_repair import (PORT_KEYS, REPAIR_LSB, TIME_KEYS, _gray,
                                   _jax, _port, _rgb)

    d = tmp_path / "in"
    d.mkdir()
    spec = (("a", 64, 64, 20), ("b", 80, 96, 106), ("c", 72, 72, None),
            ("e", 64, 80, 24))
    files = {}
    for (name, h, w, seed), form in zip(spec, ("lossy", "lossless", "lzw",
                                                "tiles")):
        side = max(h, w)
        img, _ = synthetic.watermarked_images(1, side, seed=seed or 0,
                                              clean=int(seed is None))
        rgb = (img[0, :h, :w] * 255).astype(np.uint8)
        if form == "lossy":
            ok, buf = cv2.imencode(".webp", rgb[..., ::-1],
                                   [cv2.IMWRITE_WEBP_QUALITY, 90])
            data, ext = buf.tobytes(), "webp"
        elif form == "lossless":
            rgba = np.dstack([rgb, np.full((h, w), 255, np.uint8)])
            data, ext = synthetic.vp8l_bytes(
                rgba, ("subtract_green", "predictor", "cross_color")), "webp"
        elif form == "lzw":
            data, ext = synthetic.tiff_bytes(rgb, "lzw", 2,
                                             rows_per_strip=16), "tiff"
        else:
            data, ext = synthetic.tiff_bytes(rgb, "deflate", 2, 2,
                                             tile=(32, 32)), "tiff"
        files[name] = d / f"{name}.{ext}"
        files[name].write_bytes(data)
        assert cv2.imread(str(files[name])) is not None
    (d / "skipped.tif").write_bytes(files["c"].read_bytes())
    runs = {}
    for key, pred in (("jax", _jax()), ("port", _port())):
        out = tmp_path / f"out_{key}"
        stats = pred.process_folder_batch(str(d), str(out),
                                          watermark_model="telea",
                                          use_ocr=False, steps=3)
        runs[key] = (out, stats)
    (jo, js), (to, ts) = runs["jax"], runs["port"]
    names = sorted(os.listdir(jo / "step1_masks"))
    assert len(names) == len(spec)
    assert names == sorted(os.listdir(to / "step1_masks"))
    for name in names:
        np.testing.assert_array_equal(_gray(to / "step1_masks" / name),
                                      _gray(jo / "step1_masks" / name))
    for sub in ("step2_watermark_repaired", ".", "masks"):
        jn = sorted(n for n in os.listdir(jo / sub) if n.endswith(".png"))
        assert jn == sorted(n for n in os.listdir(to / sub)
                            if n.endswith(".png"))
        for name in jn:
            a, b = _rgb(jo / sub / name).astype(int), _rgb(
                to / sub / name).astype(int)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= (0 if sub == "masks"
                                            else REPAIR_LSB), (sub, name)
    js, ts = dict(js), dict(ts)
    [ts.pop(k) for k in PORT_KEYS]
    for key in TIME_KEYS:
        assert ts.pop(key) > 0 and js.pop(key) > 0
    assert ts == js and ts["status"] == "success"


def test_gen_data_reads_webp_logos_as_pil(tmp_path):
    """JAX's gen_data reads its logos and clean images with PIL's
    convert("RGBA"); with WEBP logos (lossy with alpha, lossless) and a
    WEBP clean image, the port's logo and multi-logo files equal JAX's
    byte for byte."""
    import unet_watermark_tpu.data.gen_data as J
    import unet_watermark_tpu_torch.data.gen_data as P

    clean, logos = tmp_path / "clean", tmp_path / "logos"
    clean.mkdir()
    logos.mkdir()
    imgs, _ = synthetic.watermarked_images(2, 96, seed=3, clean=2)
    u8 = (imgs * 255).astype(np.uint8)
    image_io.write_png(clean / "a.png", u8[0])
    ok, buf = cv2.imencode(".webp", u8[1][..., ::-1],
                           [cv2.IMWRITE_WEBP_QUALITY, 85])
    (clean / "b.webp").write_bytes(buf.tobytes())
    lg = np.zeros((30, 44, 4), np.uint8)
    yy, xx = np.mgrid[0:30, 0:44]
    lg[np.abs(np.hypot(yy - 15, xx - 22) - 10) < 3] = (250, 240, 10, 255)
    lg[np.abs(yy - 15) < 2] = (10, 10, 200, 128)
    ok, buf = cv2.imencode(".webp", lg[..., [2, 1, 0, 3]],
                           [cv2.IMWRITE_WEBP_QUALITY, 75])
    (logos / "l1.webp").write_bytes(buf.tobytes())
    (logos / "l2.webp").write_bytes(synthetic.vp8l_bytes(lg, ("predictor",)))
    for path in (clean / "b.webp", logos / "l1.webp", logos / "l2.webp"):
        np.testing.assert_array_equal(
            image_io.read_rgba_tensor(path, "cpu").numpy(),
            np.asarray(Image.open(path).convert("RGBA")))
    J.generate_dataset(str(clean), str(tmp_path / "jax"), str(logos),
                       count=12, seed=1000)
    P.generate_dataset(str(clean), str(tmp_path / "port"), str(logos),
                       count=12, seed=1000, device="cpu")
    names = sorted(os.listdir(tmp_path / "jax" / "watermarked"))
    assert names == sorted(os.listdir(tmp_path / "port" / "watermarked"))
    logo_files = [n for n in names if n.split("_")[1] in ("logo", "multi")]
    assert logo_files
    for name in logo_files:
        assert (tmp_path / "port" / "watermarked" / name).read_bytes() == \
            (tmp_path / "jax" / "watermarked" / name).read_bytes(), name
