"""The port's stand-ins for cv2 on the GPU machine, against cv2 itself:
utils/image_io.py (PNG read and write with numpy and zlib) and
ops/resize.py (cv2.resize on tensors)."""
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from unet_watermark_tpu_torch.ops import resize as rs
from unet_watermark_tpu_torch.utils import image_io

SETTINGS = settings(max_examples=25, deadline=None)


def _content(rng, h, w, c, dtype=np.uint8):
    """A wrapped gradient with noise, `c` channels of `dtype`."""
    top = 65535 if dtype == np.uint16 else 255
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 3 + xx * 5)[..., None] * np.arange(1, c + 1) % (top + 1)
    noise = rng.integers(0, top // 16 + 1, (h, w, c))
    return ((base + noise) % (top + 1)).astype(dtype)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _filters(path) -> set:
    """The row filter types a PNG file uses (8-bit, one IDAT stream)."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    h = hdr[1]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


@SETTINGS
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       mode=st.sampled_from(["gray8", "rgb8", "rgba8", "gray16", "rgb16",
                             "rgba16"]),
       level=st.sampled_from([None, 9]), seed=st.integers(0, 2 ** 16))
def test_decode_matches_cv2_on_files_cv2_wrote(tmp_path_factory, h, w, mode,
                                               level, seed):
    """Every mode cv2 writes; with a compression level given, libpng picks
    each row's filter (all five occur), by default Sub on every row. Read
    as gray, a colour file goes through libpng's rgb_to_gray as cv2 sets
    it up (no gAMA chunk in cv2's files: the plain rule)."""
    c = {"gray": 1, "rgb": 3, "rgba": 4}[mode.rstrip("0123456789")]
    dtype = np.uint16 if mode.endswith("16") else np.uint8
    img = _content(np.random.default_rng(seed), h, w, c, dtype)
    path = tmp_path_factory.mktemp("png") / "x.png"
    params = [] if level is None else [cv2.IMWRITE_PNG_COMPRESSION, level]
    assert cv2.imwrite(str(path), img[..., 0] if c == 1 else img, params)
    np.testing.assert_array_equal(image_io.read_rgb(path), _cv2_rgb(path))
    np.testing.assert_array_equal(
        image_io.read_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def test_cv2_files_mix_sub_average_and_paeth_rows(tmp_path):
    """Given a compression level, libpng under cv2 picks each row's filter
    by its content (by default cv2 writes Sub rows only): on a noisy
    gradient above noisy stripes it mixes Sub (1), Average (3) and Paeth
    (4), as most writers' files do, so the decoder's wavefront path is what
    reads such files."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:200, 0:300]
    grad = np.stack([yy / 2, xx / 3, (yy + xx) / 4], -1) + \
        rng.normal(0, 6, (200, 300, 3))
    img = np.concatenate([np.clip(grad, 0, 255).astype(np.uint8),
                          _content(rng, 200, 300, 3)])
    path = tmp_path / "mixed.png"
    cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    assert _filters(path) == {1, 3, 4}
    np.testing.assert_array_equal(image_io.read_rgb(path), _cv2_rgb(path))


@pytest.mark.parametrize("channels,dtype", [
    (1, np.uint8), (3, np.uint8), (4, np.uint8), (1, np.uint16),
    (3, np.uint16), (4, np.uint16)], ids=str)
def test_cv2_default_files_are_sub_rows_read_row_by_row(tmp_path, channels,
                                                        dtype):
    """By default cv2 writes Sub rows only; the decoder undoes them row by
    row (a running sum at a stride of one pixel: 1 to 8 bytes here), never
    through the wavefront, and gets cv2's pixels."""
    img = _content(np.random.default_rng(channels), 61, 83, channels, dtype)
    path = tmp_path / "x.png"
    assert cv2.imwrite(str(path), img[..., 0] if channels == 1 else img)
    assert _filters(path) == {1}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(image_io, "_wavefront", None)  # calling it would raise
        out = image_io.read_rgb(path)
    np.testing.assert_array_equal(out, _cv2_rgb(path))


@pytest.mark.parametrize("filters", [(1,), (2,), (0, 1, 2), (1, 1, 0, 2)],
                         ids=str)
def test_row_path_equals_wavefront(filters):
    """On None, Sub and Up rows the row-by-row path and the wavefront give
    the same bytes."""
    img = _content(np.random.default_rng(len(filters)), 45, 38, 3)
    raw = np.frombuffer(image_io._filter_rows(img, filters), np.uint8)
    rows = raw.reshape(45, -1)
    ftype = rows[:, 0].astype(np.int16)
    fast = image_io._unfilter(raw, 45, rows.shape[1] - 1, 3)
    np.testing.assert_array_equal(fast, img.reshape(45, -1))
    np.testing.assert_array_equal(image_io._wavefront(rows, ftype, 3), fast)


@pytest.mark.parametrize("mode", ["LA", "P", "1", "L", "RGB", "RGBA"])
def test_decode_matches_cv2_on_files_pil_wrote(tmp_path, mode):
    """Gray+alpha and palette files (cv2 writes neither), 1-bit gray."""
    rng = np.random.default_rng(1)
    img = Image.fromarray(_content(rng, 37, 53, 3)).convert(mode)
    if mode == "P":
        img = Image.fromarray(_content(rng, 37, 53, 3)).quantize(200)
    path = tmp_path / "x.png"
    img.save(path)
    np.testing.assert_array_equal(image_io.read_rgb(path), _cv2_rgb(path))
    if mode in ("LA", "1", "L"):
        np.testing.assert_array_equal(
            image_io.read_gray(path), cv2.imread(str(path),
                                                 cv2.IMREAD_GRAYSCALE))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _raw_png(rows: np.ndarray, w: int, depth: int, ctype: int,
             palette=None, interlace=0) -> bytes:
    """A PNG of already packed rows, each with filter 0."""
    h = rows.shape[0]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + \
        _chunk(b"IEND", b"")


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("ctype", [0, 3], ids=["gray", "palette"])
def test_decode_matches_cv2_at_low_bit_depths(tmp_path, depth, ctype):
    rng = np.random.default_rng(depth)
    h, w = 9, 13
    values = rng.integers(0, 1 << depth, (h, w)).astype(np.uint8)
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = values
    shifts = np.arange(8 - depth, -1, -depth)
    rows = (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    path = tmp_path / "x.png"
    path.write_bytes(_raw_png(rows, w, depth, ctype, palette))
    np.testing.assert_array_equal(image_io.read_rgb(path), _cv2_rgb(path))


@SETTINGS
@given(h=st.integers(1, 40), w=st.integers(1, 40), color=st.booleans(),
       filters=st.lists(st.integers(0, 4), min_size=1, max_size=6),
       seed=st.integers(0, 2 ** 16))
def test_port_written_files_read_back_by_cv2(tmp_path_factory, h, w, color,
                                             filters, seed):
    """Every row filter, in any order, written by the port: cv2 and the
    port's decoder both read the image back."""
    img = _content(np.random.default_rng(seed), h, w, 3 if color else 1)
    img = img if color else img[..., 0]
    path = tmp_path_factory.mktemp("png") / "x.png"
    image_io.write_png(path, img, filters=filters)
    assert _filters(path) == set(np.resize(filters, h).tolist())
    if color:
        np.testing.assert_array_equal(_cv2_rgb(path), img)
        np.testing.assert_array_equal(image_io.read_rgb(path), img)
    else:
        np.testing.assert_array_equal(
            cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), img)
        np.testing.assert_array_equal(image_io.read_gray(path), img)


def test_interlaced_and_malformed_files_raise(tmp_path):
    """An interlaced file decodes (as cv2 reads it); a bad CRC, a cut
    JPEG, an Adam7 file whose data is a pass short, and a non-uint8 image
    to encode raise."""
    rows = np.arange(16, dtype=np.uint8).reshape(4, 4) * 9
    (tmp_path / "i.png").write_bytes(_adam7_png(rows[..., None], 8, 0))
    np.testing.assert_array_equal(image_io.read_rgb(tmp_path / "i.png"),
                                  _cv2_rgb(tmp_path / "i.png"))
    assert image_io.check_image(tmp_path / "i.png") == (4, 4)
    short = _adam7_png(rows[..., None], 8, 0, drop_last_pass=True)
    (tmp_path / "s.png").write_bytes(short)
    assert cv2.imread(str(tmp_path / "s.png")) is None
    with pytest.raises(image_io.PNGError, match="bytes, expected"):
        image_io.read_rgb(tmp_path / "s.png")
    good = bytearray(_raw_png(rows, 4, 8, 0))
    good[-20] ^= 0xFF  # inside the IDAT chunk: its CRC no longer holds
    (tmp_path / "c.png").write_bytes(bytes(good))
    with pytest.raises(image_io.PNGError, match="CRC"):
        image_io.read_rgb(tmp_path / "c.png")
    # a JPEG signature and nothing more: cv2.imread gives None
    (tmp_path / "j.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    assert cv2.imread(str(tmp_path / "j.jpg")) is None
    with pytest.raises(image_io.JPEGError, match="cut off|no frame"):
        image_io.read_rgb(tmp_path / "j.jpg")
    with pytest.raises(ValueError, match="uint8"):
        image_io.encode_png(np.zeros((4, 4), np.float32))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples → (h, rowbytes) packed rows, big-endian 16-bit."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per)))
    shifts = np.arange(8 - depth, -1, -depth)
    return (flat.reshape(h, -1, per) << shifts).sum(2).astype(np.uint8)


def _adam7_png(samples, depth, ctype, palette=None, filters=(0,),
               drop_last_pass=False) -> bytes:
    """An interlaced PNG of (h, w, c) samples: each Adam7 pass packed and
    filtered on its own (the types of `filters` cycled over its rows, the
    bytes of a pixel as the filters' step), its pass-empty ones skipped."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7[:6 if drop_last_pass else 7]:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            rows = _pack(sub, depth)
            n = rows.shape[1] // bpp
            body = image_io._filter_rows(
                np.ascontiguousarray(rows.reshape(len(rows), n, bpp)),
                filters) if rows.shape[1] % bpp == 0 and bpp > 1 else \
                image_io._filter_rows(np.ascontiguousarray(rows), filters)
            raw += body
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


ADAM7_FORMS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + \
    [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (9, 17), (16, 16)],
                         ids=str)
@pytest.mark.parametrize("ctype,depth", ADAM7_FORMS,
                         ids=[f"type{c}_{d}bit" for c, d in ADAM7_FORMS])
def test_adam7_matches_cv2(tmp_path, ctype, depth, shape):
    """Every colour type and bit depth, interlaced, from the writer above
    (None, Sub, Up, Average and Paeth rows inside the passes): byte-equal
    to cv2.imread in colour, and in gray for the gray types; PIL's RGBA
    where read_rgba_tensor reads that form. Tolerance: none."""
    h, w = shape
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(ctype * 100 + depth + h)
    samples = rng.integers(0, 1 << depth, (h, w, c))
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    path = tmp_path / "a7.png"
    path.write_bytes(_adam7_png(samples, depth, ctype, palette,
                                filters=(0, 1, 2, 3, 4)))
    np.testing.assert_array_equal(image_io.read_rgb(path), _cv2_rgb(path))
    if ctype in (0, 4):
        np.testing.assert_array_equal(
            image_io.read_gray(path),
            cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    if depth != 16 and not (ctype == 0 and depth < 8):
        np.testing.assert_array_equal(
            image_io.read_rgba_tensor(path, "cpu").numpy(),
            np.asarray(Image.open(path).convert("RGBA")))


# resizes: sources and destinations up and down, odd sizes included
SIZES = [(64, 64), (37, 53), (100, 70), (80, 96), (2, 2), (512, 512)]
DESTS = [(64, 64), (17, 91), (33, 33), (120, 90), (256, 256), (1, 5)]


@pytest.mark.parametrize("src", SIZES, ids=str)
def test_linear_u8_equals_cv2(src):
    """cv2's fixed-point INTER_LINEAR on uint8 HWC images, to the bit."""
    rng = np.random.default_rng(sum(src))
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    batch = torch.from_numpy(np.stack([img, 255 - img]))
    for oh, ow in DESTS + [src[::-1]]:
        out = rs.resize_linear_u8(batch, (oh, ow)).numpy()
        np.testing.assert_array_equal(out[0], cv2.resize(img, (ow, oh)))
        np.testing.assert_array_equal(out[1], cv2.resize(255 - img,
                                                         (ow, oh)))


@pytest.mark.parametrize("src", SIZES, ids=str)
def test_linear_f32_equals_cv2(src):
    """cv2's INTER_LINEAR on float32 maps, to the bit (sources at least
    2 x 2: cv2 takes another path for a source one pixel wide or tall,
    which the pipeline never resizes)."""
    rng = np.random.default_rng(sum(src) + 1)
    x = rng.random(src).astype(np.float32)
    for oh, ow in DESTS + [src[::-1]]:
        np.testing.assert_array_equal(
            rs.resize_linear_f32(torch.from_numpy(x), (oh, ow)).numpy(),
            cv2.resize(x, (ow, oh)))


@pytest.mark.parametrize("src", SIZES, ids=str)
def test_nearest_equals_cv2(src):
    """INTER_NEAREST's index rounding on uint8 masks and float32 maps."""
    rng = np.random.default_rng(sum(src) + 2)
    mask = (rng.random(src) < 0.3).astype(np.uint8) * 255
    x = rng.random(src).astype(np.float32)
    for oh, ow in DESTS + [src[::-1]]:
        np.testing.assert_array_equal(
            rs.resize_nearest(torch.from_numpy(mask), (oh, ow)).numpy(),
            cv2.resize(mask, (ow, oh), interpolation=cv2.INTER_NEAREST))
        np.testing.assert_array_equal(
            rs.resize_nearest(torch.from_numpy(x), (oh, ow)).numpy(),
            cv2.resize(x, (ow, oh), interpolation=cv2.INTER_NEAREST))


@SETTINGS
@given(h=st.integers(2, 300), w=st.integers(2, 300),
       oh=st.integers(1, 300), ow=st.integers(1, 300),
       seed=st.integers(0, 2 ** 16))
def test_resizes_equal_cv2_at_any_size(h, w, oh, ow, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    x = rng.random((h, w)).astype(np.float32)
    np.testing.assert_array_equal(
        rs.resize_linear_u8(torch.from_numpy(img), (oh, ow)).numpy(),
        cv2.resize(img, (ow, oh)))
    np.testing.assert_array_equal(
        rs.resize_linear_f32(torch.from_numpy(x), (oh, ow)).numpy(),
        cv2.resize(x, (ow, oh)))
    np.testing.assert_array_equal(
        rs.resize_nearest(torch.from_numpy(img[..., 0]), (oh, ow)).numpy(),
        cv2.resize(img[..., 0], (ow, oh), interpolation=cv2.INTER_NEAREST))
