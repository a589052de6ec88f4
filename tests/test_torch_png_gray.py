"""PNG reads that take libpng's conversions (utils/image_io.py) against
cv2 5.0.0 (libpng 1.6.58) and Pillow 12.1, bit for bit: colour, palette
and 16-bit files read as gray (png_set_rgb_to_gray(png, 1, 0.299, 0.587),
with the gamma tables a gAMA or sRGB chunk brings, sBIT's shift at 16
bits), interlaced too; and PIL's RGBA of 16-bit files (I;16 clipped to
255, other samples' high byte) and of 1/2/4-bit gray files with tRNS."""
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from unet_watermark_tpu_torch.utils import image_io

H, W = 11, 29


def _pack(px: np.ndarray, depth: int) -> np.ndarray:
    h, w = px.shape[:2]
    if depth == 16:
        return px.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return px.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    q = np.zeros((h, -(-w // per) * per), np.uint8)
    q[:, :w] = px.reshape(h, w)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (q.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _png(px, depth, ctype, pre=b"", plte=None, trns=None, interlace=False):
    """A PNG of the samples `px` with the chunks `pre` before PLTE/IDAT."""
    h, w = px.shape[:2]
    chunk = image_io._chunk
    if interlace:
        raw = b""
        for x0, y0, dx, dy in image_io.ADAM7:
            sub = px[y0::dy, x0::dx]
            if sub.size:
                rows = _pack(sub, depth)
                raw += np.concatenate([np.zeros((rows.shape[0], 1), np.uint8),
                                       rows], 1).tobytes()
    else:
        rows = _pack(px, depth)
        raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    out = image_io.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))) + pre
    if plte is not None:
        out += chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _gama(g: int) -> bytes:
    return image_io._chunk(b"gAMA", struct.pack(">I", g))


CHUNKS = {
    "none": b"", "gAMA45455": _gama(45455), "gAMA1.0": _gama(100000),
    "gAMA22000": _gama(22000), "gAMA96000": _gama(96000),
    "gAMA104000": _gama(104000), "gAMA0": _gama(0),
    "sRGB": image_io._chunk(b"sRGB", b"\0"),
    "sRGB+gAMA": image_io._chunk(b"sRGB", b"\0") + _gama(45455),
    "cHRM": image_io._chunk(b"cHRM", struct.pack(
        ">8I", 31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000)),
    "gAMA+sBIT10": _gama(45455) + image_io._chunk(b"sBIT", bytes([10] * 3)),
    "gAMA30000+sBIT4": _gama(30000) + image_io._chunk(b"sBIT",
                                                      bytes([4] * 3)),
}


def _samples(depth: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    px = rng.integers(0, top + 1, (H, W, channels))
    if channels >= 3:
        px[:3, :, 1] = px[:3, :, 2] = px[:3, :, 0]     # gray pixels
        px[3, :4, :3] = [[0, 0, 0], [top] * 3, [1, 2, 3],
                         [top - 1, top, top]]
    return px


@pytest.mark.parametrize("chunks", list(CHUNKS))
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype", [2, 6])
def test_colour_png_read_as_gray_equals_cv2(tmp_path, chunks, depth, ctype):
    px = _samples(depth, 3 if ctype == 2 else 4, depth + ctype)
    pre = CHUNKS[chunks]
    if ctype == 6:  # sBIT has a fourth entry for alpha
        pre = pre.replace(image_io._chunk(b"sBIT", bytes([10] * 3)),
                          image_io._chunk(b"sBIT", bytes([10] * 4))).replace(
            image_io._chunk(b"sBIT", bytes([4] * 3)),
            image_io._chunk(b"sBIT", bytes([4] * 4)))
    path = tmp_path / "c.png"
    path.write_bytes(_png(px, depth, ctype, pre))
    np.testing.assert_array_equal(
        image_io.read_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(image_io.read_rgb(path),
                                  cv2.imread(str(path))[..., ::-1])


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("chunks", ["none", "gAMA", "gAMA after PLTE",
                                    "sRGB", "tRNS"])
def test_palette_png_read_as_gray_equals_cv2(tmp_path, depth, chunks):
    """A gAMA after PLTE is out of place for libpng: ignored."""
    rng = np.random.default_rng(depth)
    pal = rng.integers(0, 256, (1 << depth, 3))
    idx = rng.integers(0, 1 << depth, (H, W))
    pre = {"gAMA": _gama(45455), "sRGB": CHUNKS["sRGB"]}.get(chunks, b"")
    data = _png(idx, depth, 3, pre, pal,
                trns=bytes(range(1 << depth)) if chunks == "tRNS" else None)
    if chunks == "gAMA after PLTE":
        at = data.index(b"IDAT") - 4
        data = data[:at] + _gama(45455) + data[at:]
    path = tmp_path / "p.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(
        image_io.read_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("ctype,depth", [(2, 16), (6, 8), (0, 16), (3, 4)])
def test_interlaced_reads_as_gray_equal_cv2(tmp_path, ctype, depth):
    channels = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    px = _samples(depth, channels, 5)
    pal = np.random.default_rng(1).integers(0, 256, (16, 3)) \
        if ctype == 3 else None
    if ctype == 3:
        px = px % 16
    path = tmp_path / "i.png"
    path.write_bytes(_png(px, depth, ctype, _gama(45455), pal,
                          interlace=True))
    np.testing.assert_array_equal(
        image_io.read_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def _trns_cases():
    cases = []
    for depth, ctype in ((16, 0), (16, 2), (16, 4), (16, 6), (1, 0), (2, 0),
                         (4, 0), (8, 0)):
        keys = [None]
        if ctype == 0:
            keys += sorted({0, 1, (1 << depth) - 1, 255, 300, 0x134}
                           if depth == 16 else
                           set(range(min(1 << depth, 4))) | {255, 261})
        if ctype == 2:
            keys += ["pixel", "high bytes"]
        cases += [(depth, ctype, k) for k in keys]
    return cases


@pytest.mark.parametrize("depth,ctype,key", _trns_cases())
def test_rgba_of_16bit_and_low_depth_trns_equals_pil(tmp_path, depth, ctype,
                                                     key):
    """What gen_data reads (PIL's Image.open(p).convert("RGBA"))."""
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    px = _samples(depth, channels, depth * 7 + ctype) if channels >= 3 else \
        np.random.default_rng(depth).integers(0, 1 << depth, (H, W, channels))
    if depth == 16:
        px[0, :6, 0] = (0, 1, 255, 256, 300, 65535)
    trns = None
    if key == "pixel":
        trns = struct.pack(">3H", *map(int, px[1, 1, :3]))
    elif key == "high bytes":
        trns = struct.pack(">3H", *map(int, px[1, 1, :3] >> 8))
    elif key is not None:
        trns = struct.pack(">H", key)
    path = tmp_path / "t.png"
    path.write_bytes(_png(px, depth, ctype, trns=trns))
    np.testing.assert_array_equal(
        image_io.read_rgba_tensor(path, "cpu").numpy(),
        np.asarray(Image.open(path).convert("RGBA")))
