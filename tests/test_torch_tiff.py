"""TIFF decoding (utils/tiff.py, csrc/tiff_codecs.c) against cv2 5.0.0's
libtiff 4.7.1 and Pillow 12.1, bit for bit: the synthetic writer's files
(utils/synthetic.tiff_bytes) over every codec, predictor, planar
configuration, strip and tile layout and byte order in scope, every
photometric interpretation with and without alpha, palettes with 16-bit
and 8-bit entries and every orientation; files cv2.imwrite and PIL write;
the forms still refused (NotImplementedError naming ROADMAP.md §A.5) and
cut or corrupt files (unreadable where cv2 gives None). Then JAX's
WatermarkDataset over TIFF images with RGB and palette mask PNGs against
the port's."""
import io
import itertools
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from unet_watermark_tpu_torch.utils import image_io, synthetic, tiff

H, W = 37, 45


def _base(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                            (0, 0), 1.5)


def _check(tmp_path, data: bytes, name="x.tiff") -> None:
    """read_rgb, read_gray and read_rgb_tensor against cv2.imread;
    read_rgba_tensor against PIL's convert("RGBA") where PIL opens the
    file (else both refuse it)."""
    path = tmp_path / name
    path.write_bytes(data)
    ref = cv2.imread(str(path))
    assert ref is not None
    np.testing.assert_array_equal(image_io.read_rgb(path), ref[..., ::-1])
    np.testing.assert_array_equal(image_io.read_gray(path), cv2.imread(
        str(path), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(
        image_io.read_rgb_tensor(path, "cpu").numpy(), ref[..., ::-1])
    assert image_io.check_image(path) == ref.shape[:2]
    try:
        want = np.asarray(Image.open(path).convert("RGBA"))
    except Exception:  # PIL cannot open this layout
        with pytest.raises(image_io.UNREADABLE):
            image_io.read_rgba_tensor(path, "cpu")
        return
    np.testing.assert_array_equal(
        image_io.read_rgba_tensor(path, "cpu").numpy(), want)


LAYOUTS = list(itertools.product(
    ("none", "lzw", "deflate", "deflate32946", "packbits"), (1, 2), (1, 2),
    (None, (16, 32)), ("<", ">")))


@pytest.mark.parametrize("codec,predictor,planar,tile,bo", LAYOUTS)
def test_codecs_and_layouts_decode_as_cv2(tmp_path, codec, predictor, planar,
                                          tile, bo):
    """Strips of 7 rows or 16 x 32 tiles (edge tiles padded), each sample
    in its own planes or not, horizontal differencing (applied under LZW
    and Deflate only, as libtiff does), either byte order."""
    data = synthetic.tiff_bytes(_base(planar), codec, predictor, planar,
                                tile, 7, bo)
    _check(tmp_path, data)


@pytest.mark.parametrize("tile", [(16, 16), (16, 32), (48, 48), (32, 64)])
def test_uncompressed_tiles_decode_as_cv2_imread(tmp_path, tile):
    """cv2.imread reads uncompressed tiles of any size (cv2.imdecode, from
    memory, refuses those whose TileWidth x TileLength is not a multiple
    of 1024; the readers follow cv2.imread)."""
    _check(tmp_path, synthetic.tiff_bytes(_base(), "none", tile=tile))


@pytest.mark.parametrize("samples,extra,min_is_white", [
    (s, e, w) for s, e in ((1, None), (2, 2), (2, 1), (2, 0), (3, None),
                           (4, 2), (4, 1), (4, 0))
    for w in ((False, True) if s <= 2 else (False,))])
def test_photometric_and_alpha_decode_as_cv2(tmp_path, samples, extra,
                                             min_is_white):
    """Gray (min-is-black, min-is-white) and RGB, with an unassociated (2),
    associated (1) or unspecified (0) extra sample: cv2 premultiplies
    unassociated RGB alpha (libtiff's RGBA interface) and drops it; PIL
    keeps it (dividing associated alpha out)."""
    base = _base(samples)
    alpha = np.random.default_rng(9).integers(0, 256, (H, W), dtype=np.uint8)
    alpha[0, :4] = (0, 255, 1, 128)
    img = {1: base[..., 0], 2: np.dstack([base[..., 0], alpha]), 3: base,
           4: np.dstack([base, alpha])}[samples]
    _check(tmp_path, synthetic.tiff_bytes(img, "lzw", 2, extra=extra,
                                          min_is_white=min_is_white))


@pytest.mark.parametrize("entries", [16, 8])
def test_palettes_decode_as_cv2(tmp_path, entries):
    """A ColorMap of 16-bit entries reads as their high byte; one whose
    entries are all below 256 as they are under cv2 (libtiff's old 8-bit
    map test) and as their high byte under PIL."""
    rng = np.random.default_rng(entries)
    cmap = rng.integers(0, 256, (3, 256)).astype(np.uint16)
    if entries == 16:
        cmap = cmap * 257
    idx = rng.integers(0, 256, (H, W), dtype=np.uint8)
    _check(tmp_path, synthetic.tiff_bytes(idx, "packbits", colormap=cmap))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_as_cv2_and_pil_apply_it(tmp_path, orientation):
    """cv2.imread flips the image for orientations 2-4 and gives None for
    5-8 (its imread fails its own check after the decoder turns the
    image; cv2.imdecode reads it): the cv2 readers raise as unreadable
    there. PIL turns it."""
    data = synthetic.tiff_bytes(_base(), "deflate", rows_per_strip=8,
                                orientation=orientation)
    if orientation < 5:
        _check(tmp_path, data)
        return
    path = tmp_path / "t.tiff"
    path.write_bytes(data)
    assert cv2.imread(str(path)) is None
    assert cv2.imdecode(np.frombuffer(data, np.uint8), 1) is not None
    for call in (image_io.read_rgb, image_io.check_image):
        with pytest.raises(image_io.UNREADABLE):
            call(path)
    image_io.require_decodable(path)
    np.testing.assert_array_equal(
        image_io.read_rgba_tensor(path, "cpu").numpy(),
        np.asarray(Image.open(path).convert("RGBA")))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("compression", [None, "tiff_lzw",
                                         "tiff_adobe_deflate", "packbits"])
def test_pil_written_files(tmp_path, mode, compression):
    img = Image.fromarray(_base(3)).convert(mode) if mode != "P" else \
        Image.fromarray(_base(3)).quantize(64)
    buf = io.BytesIO()
    img.save(buf, format="TIFF", compression=compression,
             tiffinfo={278: 9})
    _check(tmp_path, buf.getvalue())


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_written_files(tmp_path, channels):
    img = np.dstack([_base(4), _base(5)[..., :1]])[..., :channels]
    path = tmp_path / "c.tif"
    assert cv2.imwrite(str(path), img if channels > 1 else img[..., 0])
    _check(tmp_path, path.read_bytes(), name="c.tif")


def _refused_forms():
    """(name, bytes) of forms cv2 reads that the port refuses."""
    base = _base(6)
    forms = {}
    for name, kwargs in (("16-bit", {"dtype": np.uint16}),
                         ("1-bit", {"mode": "1"}),
                         ("jpeg", {"compression": "jpeg"}),
                         ("g4", {"mode": "1", "compression": "group4"}),
                         ("ycbcr", {"mode": "YCbCr"}),
                         ("cmyk", {"mode": "CMYK"})):
        if "dtype" in kwargs:
            ok, buf = cv2.imencode(".tiff", base.astype(np.uint16) * 257)
            forms[name] = buf.tobytes()
            continue
        img = Image.fromarray(base).convert(kwargs.get("mode", "RGB"))
        out = io.BytesIO()
        img.save(out, format="TIFF", **{k: v for k, v in kwargs.items()
                                        if k == "compression"})
        forms[name] = out.getvalue()
    data = bytearray(synthetic.tiff_bytes(base, "lzw"))
    strip = tiff.parse(bytes(data)).tags[273][0]
    data[strip:strip + 2] = b"\x00\x01"  # old-style LZW's first bytes
    forms["old-lzw"] = bytes(data)
    forms["bigtiff"] = b"II+\x00\x08\x00\x00\x00" + bytes(16)
    return forms


@pytest.mark.parametrize("name", ["16-bit", "1-bit", "jpeg", "g4", "ycbcr",
                                  "cmyk", "old-lzw", "bigtiff"])
def test_forms_not_ported_are_refused(tmp_path, name):
    data = _refused_forms()[name]
    path = tmp_path / f"{name}.tiff"
    path.write_bytes(data)
    for call in (image_io.require_decodable, image_io.read_rgb,
                 image_io.read_gray,
                 lambda p: image_io.read_rgba_tensor(p, "cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md §A.5"):
            call(path)


def test_cut_and_corrupt_files_are_unreadable(tmp_path):
    """Cuts inside the strips and the directory, an offset past the end and
    a corrupt LZW code: cv2 gives None and the readers raise as
    unreadable."""
    cases = []
    for codec in ("none", "lzw", "deflate", "packbits"):
        data = synthetic.tiff_bytes(_base(7), codec, rows_per_strip=8)
        ifd = struct.unpack("<I", data[4:8])[0]
        cases += [data[:len(data) // 3], data[:ifd + 20], data[:ifd - 7]]
    bad = bytearray(synthetic.tiff_bytes(_base(7), "none"))
    bad[4:8] = struct.pack("<I", len(bad) + 100)
    cases.append(bytes(bad))
    for i, data in enumerate(cases):
        path = tmp_path / f"c{i}.tiff"
        path.write_bytes(data)
        assert cv2.imread(str(path)) is None, i
        with pytest.raises(image_io.UNREADABLE):
            image_io.read_rgb(path)


def test_corrupt_lzw_strip_is_a_stated_difference(tmp_path):
    """A corrupt LZW code inside a strip: libtiff stops the strip there and
    cv2 returns the image with the rest of the strip zero; the port raises
    as unreadable, so the pipeline skips the file (ROADMAP.md, stated
    differences)."""
    bad = bytearray(synthetic.tiff_bytes(_base(7), "lzw"))
    bad[12:16] = b"\xff\xff\xff\xff"
    path = tmp_path / "c.tiff"
    path.write_bytes(bytes(bad))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(image_io.UNREADABLE):
        image_io.read_rgb(path)


def test_lzw_codec_round_trips_large_strips():
    """The encoder's table clears (12-bit codes, more than 4094 entries)
    and the decoder's code widths over a strip of 300 KB."""
    from unet_watermark_tpu_torch.ops.kernels import tiff as tiff_c

    rng = np.random.default_rng(1)
    raw = np.repeat(rng.integers(0, 256, 100_000, dtype=np.uint8),
                    rng.integers(1, 6, 100_000))[:300_000].tobytes()
    coded = tiff_c.lzw_encode(raw)
    assert tiff_c.lzw_decode(coded, len(raw)).tobytes() == raw
    assert tiff_c.packbits_decode(tiff_c.packbits_encode(raw, 1000),
                                  len(raw)).tobytes() == raw


def test_dataset_with_tiff_images_and_colour_masks_equals_jax(tmp_path):
    """JAX's WatermarkDataset and the port's over TIFF images (LZW, tiled
    Deflate, PackBits planar) whose masks are RGB, palette and 16-bit RGB
    PNGs (read as gray through libpng's rgb_to_gray in both): every item
    byte for byte."""
    import unet_watermark_tpu.data.dataset as jds
    import unet_watermark_tpu_torch.data.dataset as tds

    root = tmp_path / "data"
    (root / "watermarked").mkdir(parents=True)
    (root / "masks").mkdir()
    imgs, masks = synthetic.watermarked_images(3, 64, seed=8)
    forms = (("lzw", {"predictor": 2, "rows_per_strip": 16}),
             ("deflate", {"tile": (32, 32)}),
             ("packbits", {"planar": 2}))
    for i, (codec, kw) in enumerate(forms):
        rgb = (imgs[i] * 255).astype(np.uint8)
        (root / "watermarked" / f"w{i}.tiff").write_bytes(
            synthetic.tiff_bytes(rgb, codec, **kw))
        m = (masks[i] > 0.5).astype(np.uint8) * 255
        color = np.dstack([m, m // 2, 255 - m])
        path = str(root / "masks" / f"w{i}.png")
        if i == 0:
            cv2.imwrite(path, color)
        elif i == 1:
            Image.fromarray(color).quantize(4).save(path)
        else:
            cv2.imwrite(path, color.astype(np.uint16) * 257)
    t = tds.WatermarkDataset([str(root / "watermarked")], img_size=64,
                             device="cpu")
    j = jds.WatermarkDataset([str(root / "watermarked")], img_size=64)
    assert len(t) == len(j) == 3
    for i in range(len(j)):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
