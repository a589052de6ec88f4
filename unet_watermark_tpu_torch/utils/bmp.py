"""BMP decoding as cv2.imread (OpenCV's BmpDecoder) and PIL's
BmpImagePlugin read it, with numpy on the host.

decode(data, gray) is cv2.imread(path) (RGB, after BGR2RGB) or
cv2.imread(path, IMREAD_GRAYSCALE):

  headers     BITMAPCOREHEADER (12 bytes: 16-bit sizes, a 3-byte palette
              of 1 << depth entries) and the 40-byte BITMAPINFOHEADER with
              its longer forms (V2-V5: 52..124 bytes, the part past 40
              skipped); depth and compression from the header, the pixels
              at the file header's offset, the palette right after the
              info header
  depths      1, 4, 8 (a palette of biClrUsed entries, 1 << depth where
              that is 0, the rest black; at most 256), 16 (BI_RGB read as
              5-5-5; BI_BITFIELDS with the three masks that follow the
              header, 5-5-5 or 5-6-5, others refused: so a V4/V5 file,
              whose masks are inside its header, is refused), 24, 32 (the
              first three bytes of each pixel, B G R; BI_BITFIELDS with a
              header of 56 bytes or more: each channel by its mask from
              the header, byte-aligned 8-bit masks decoded, others raise
              NotImplementedError)
  samples     5/6-bit channels shifted up (v << 3, v << 2), not scaled;
              rows padded to 4 bytes; bottom-up unless the height is
              negative
  RLE8/RLE4   cv2's run decoder, in C on the host (csrc/bmp_rle.c,
              built at first use; a failed build raises): encoded runs,
              absolute runs (padded to a 16-bit word), end of line, delta
              and end of bitmap, the
              pixels these skip set to palette entry 0; a run that would
              cross the row's end, or data that ends before the bitmap
              does, makes the file unreadable (None); an RLE8 end of line
              right after a run that ended the row is skipped; in RLE4 the
              end of bitmap acts as an end of line and a delta moves right
              only (its rows are read and dropped), as cv2 fills them
  gray        cv2's own BGR -> gray (weights 1868, 9617, 4899 over 2^14,
              rounded) of the colour pixel, the palette's entries for a
              palette file; for 32-bit BI_BITFIELDS with the masks in the
              header, 0.299 R + 0.587 G + 0.114 B in float32, truncated

decode_rgba(data) is PIL's Image.open(path).convert("RGBA"): the same
pixels except where PIL reads differently. 5/6-bit channels are scaled
(v * 255 // 31, v * 255 // 63); a 32-bit BI_BITFIELDS file whose masks
give alpha (a V4/V5 header; 0xFF000000 beside the B G R masks) keeps its
fourth byte as alpha, every other pixel has alpha 255; a 16-bit
BI_BITFIELDS file takes its masks from a V4/V5 header itself; palette
indices past the palette's end read as black; RLE runs that cross the row
are cut at its end (PIL's decoder, in the same C source), a delta escape
reads as PIL reads it, and a bitmap whose runs end before its last pixel
raises (PIL's "not enough image data").

A file either reader gives None for (or fails to open) raises BMPError.

encode(img) is cv2.imwrite's BmpEncoder: an (H, W) gray image as an 8-bit
file with the 256-entry gray palette, an (H, W, 3) RGB image as a 24-bit
B G R file; a BITMAPINFOHEADER with no resolution, size or colour counts,
bottom-up rows padded to 4 bytes.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.kernels import build
from .jpeg import MAX_PIXELS

RGB, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
MASKS_555 = (0x7C00, 0x3E0, 0x1F)
MASKS_565 = (0xF800, 0x7E0, 0x1F)
# cv2's BGR -> gray weights (utils.cpp: 0.299, 0.587, 0.114 at 14 bits)
_CR, _CG, _CB = 4899, 9617, 1868
# cv2's validateInputImageSize: CV_IO_MAX_IMAGE_WIDTH/HEIGHT and _PIXELS
MAX_SIDE = 1 << 20


class BMPError(ValueError):
    """cv2.imread gives None for the file (or PIL cannot open it)."""


@dataclass
class Info:
    width: int
    height: int          # rows, positive
    bottom_up: bool
    bpp: int             # 15 for 5-5-5 16-bit samples under cv2's rule
    compression: int
    offset: int          # the pixels' byte offset
    palette: np.ndarray  # (256, 3) uint8 B G R, zeros past the entries
    colors: int          # palette entries in the file
    header_size: int
    masks: tuple = ()    # (r, g, b, a) as PIL reads them


def _u16(data, pos):
    return struct.unpack_from("<H", data, pos)[0]


def _i32(data, pos):
    return struct.unpack_from("<i", data, pos)[0]


def _u32(data, pos):
    return struct.unpack_from("<I", data, pos)[0]


def parse(data: bytes, pil: bool = False) -> Info:
    """The header as cv2's BmpDecoder::readHeader reads it (pil=True: as
    PIL's BmpImageFile reads it); raises BMPError where it refuses."""
    try:
        return _parse(data, pil)
    except struct.error:
        raise BMPError("BMP header cut off") from None


def _palette(data: bytes, pos: int, entries: int, stride: int):
    raw = np.frombuffer(data[pos:pos + entries * stride], np.uint8)
    if raw.size != entries * stride:
        raise BMPError("BMP palette cut off")
    pal = np.zeros((256, 3), np.uint8)
    n = min(entries, 256)
    pal[:n] = raw.reshape(entries, stride)[:n, :3]
    return pal


def _parse(data: bytes, pil: bool) -> Info:
    if data[:2] != b"BM":
        raise BMPError("not a BMP file")
    offset = _u32(data, 10)
    size = _u32(data, 14)
    if size == 12:
        width, height = _u16(data, 18), _u16(data, 20)
        if pil:  # PIL reads the core header's sizes as signed
            width = width - (1 << 16) if width >= 1 << 15 else width
            height = height - (1 << 16) if height >= 1 << 15 else height
        bpp = _u16(data, 24)
        comp, colors, stride = RGB, 1 << bpp if bpp <= 8 else 0, 3
        if bpp not in (1, 4, 8, 24, 32) or width <= 0 or height == 0:
            raise BMPError(f"BMP core header: {bpp}-bit, {width}x{height}")
        masks = ()
    elif size >= 36 and (not pil or size in (40, 52, 56, 64, 108, 124)):
        width, height = _i32(data, 18), _i32(data, 22)
        bpp = _u16(data, 28)
        comp = _u32(data, 30)
        clrused = _u32(data, 46)
        stride = 4
        if comp > BITFIELDS:
            raise BMPError(f"BMP compression {comp}")
        ok = (bpp in (1, 4, 8, 24, 32) and comp == RGB) or (
            bpp in (16, 32) and comp in (RGB, BITFIELDS)) or (
            bpp == 4 and comp == RLE4) or (bpp == 8 and comp == RLE8)
        if pil:
            ok = ok or (bpp == 24 and comp == BITFIELDS)
        if width <= 0 or height == 0 or not ok:
            raise BMPError(f"BMP: {bpp}-bit, compression {comp}, "
                           f"{width}x{height}")
        if bpp <= 8 and clrused > 256 and not pil:
            raise BMPError(f"BMP: {clrused} palette entries")
        colors = (clrused or 1 << bpp) if bpp <= 8 else 0
        masks = ()
        if comp == BITFIELDS:
            if size >= 56 and (pil or bpp == 32):
                masks = struct.unpack_from("<4I", data, 54)
            elif size >= 52 and pil:
                masks = struct.unpack_from("<3I", data, 54) + (0,)
            else:  # cv2 (any header) and PIL's 40-byte one: after it
                masks = struct.unpack_from("<3I", data, 14 + size) + (0,)
            if bpp == 16 and masks[:3] not in (MASKS_555, MASKS_565) or (
                    bpp == 24 and masks[:3] != (0xFF0000, 0xFF00, 0xFF)):
                raise BMPError(f"BMP {bpp}-bit masks {masks[:3]}")
            if bpp == 16 and masks[:3] == MASKS_555:
                bpp = 15
        elif bpp == 16:
            bpp = 15
    else:
        raise BMPError(f"BMP header of {size} bytes")
    bottom_up = height > 0
    height = abs(height)
    if max(width, height) > MAX_SIDE or width * height > MAX_PIXELS:
        raise BMPError(f"a {width} x {height} BMP: over cv2.imread's limits")
    pal = np.zeros((256, 3), np.uint8)
    if colors:
        if pil and not 0 < colors <= 65536:
            raise BMPError(f"BMP palette of {colors} entries")
        pal = _palette(data, 14 + size, colors, stride)
    return Info(width, height, bottom_up, bpp, comp, offset, pal, colors,
                size, masks)


def _gray(bgr: np.ndarray) -> np.ndarray:
    """cv2's icvCvt_BGR2Gray_8u_C3C1R."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * _CB + g * _CG + r * _CR + (1 << 13)) >> 14).astype(np.uint8)


def _rows(data: bytes, info: Info, bits: int) -> np.ndarray:
    """(H, pitch) uint8 rows top to bottom."""
    pitch = ((info.width * bits + 7) // 8 + 3) & ~3
    need = info.offset + pitch * info.height
    if info.offset < 0 or len(data) < need:
        raise BMPError("BMP pixel data cut off")
    rows = np.frombuffer(data, np.uint8, pitch * info.height,
                         info.offset).reshape(info.height, pitch)
    return rows[::-1] if info.bottom_up else rows


def _indices(rows: np.ndarray, bpp: int, width: int) -> np.ndarray:
    if bpp == 8:
        return rows[:, :width]
    per = 8 // bpp
    shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
    px = (rows[:, :, None] >> shifts) & ((1 << bpp) - 1)
    return px.reshape(rows.shape[0], -1)[:, :width]


SOURCE = "bmp_rle.c"  # the run decoders, cv2's and PIL's
_RLE_ERRORS = {-1: "BMP RLE data cut off",
               -2: "BMP RLE run crosses the row's end",
               -3: "not enough image data (PIL's RLE decoder)"}


@functools.lru_cache(maxsize=1)
def _rle_lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    for fn in (lib.uwt_bmp_rle_cv2, lib.uwt_bmp_rle_pil):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int32
    return lib


def _rle(data: bytes, info: Info, pil: bool) -> np.ndarray:
    """(H, W) palette indices of an RLE8/RLE4 bitmap, top to bottom, by
    csrc/bmp_rle.c's run decoder: cv2's, or PIL's with `pil`."""
    w, h = info.width, info.height
    out = np.zeros(h * w, np.uint8)
    lib = _rle_lib()
    fn = lib.uwt_bmp_rle_pil if pil else lib.uwt_bmp_rle_cv2
    rc = fn(bytes(data), len(data), info.offset, w, h,
            int(info.compression == RLE4), out.ctypes.data)
    if rc:
        raise BMPError(_RLE_ERRORS[rc])
    img = out.reshape(h, w)
    return img[::-1] if info.bottom_up else img


def decode(data: bytes, gray: bool = False) -> np.ndarray:
    """cv2.imread of a BMP: (H, W, 3) RGB uint8, or (H, W) with gray."""
    info = parse(data)
    bpp = info.bpp
    if info.compression in (RLE8, RLE4) or bpp <= 8:
        idx = (_rle(data, info, False) if info.compression in (RLE8, RLE4)
               else _indices(_rows(data, info, bpp), bpp, info.width))
        if gray:
            return _gray(info.palette)[idx]
        return info.palette[:, ::-1][idx]
    if bpp in (15, 16):
        v = _rows(data, info, 16)[:, :2 * info.width].copy().view("<u2")
        v = v.astype(np.int32)
        gshift, gmask = (2, 0xF8) if bpp == 15 else (3, 0xFC)
        rshift = 7 if bpp == 15 else 8
        bgr = np.stack([(v << 3) & 0xF8, (v >> gshift) & gmask,
                        (v >> rshift) & 0xF8], axis=-1).astype(np.uint8)
    elif bpp == 32 and info.compression == BITFIELDS and \
            info.header_size >= 56:
        px = _rows(data, info, 32)[:, :4 * info.width].copy().view("<u4")
        bgr = np.stack([_channel(px, m) for m in info.masks[2::-1]], -1)
        if gray:  # float32, R G B in this order, truncated
            b, g, r = (bgr[..., i].astype(np.float32) for i in range(3))
            y = (np.float32(0.299) * r + np.float32(0.587) * g
                 + np.float32(0.114) * b)
            return y.astype(np.uint8)
    else:
        k = bpp // 8
        bgr = _rows(data, info, bpp)[:, :k * info.width].reshape(
            info.height, info.width, k)[..., :3]
    if gray:
        return _gray(bgr)
    return np.ascontiguousarray(bgr[..., ::-1])


def _channel(px: np.ndarray, mask: int) -> np.ndarray:
    """The 8-bit channel a byte-aligned mask selects from 32-bit pixels
    (0 for an empty mask)."""
    if mask == 0:
        return np.zeros(px.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    if mask >> shift != 0xFF or shift % 8:
        raise NotImplementedError(
            f"a 32-bit BMP with the channel mask 0x{mask:08x}: only "
            f"byte-aligned 8-bit masks are decoded (ROADMAP.md §A.5, other "
            f"image formats)")
    return ((px >> shift) & 0xFF).astype(np.uint8)


def decode_rgba(data: bytes) -> np.ndarray:
    """PIL's Image.open(BMP).convert("RGBA"): (H, W, 4) uint8."""
    info = parse(data, pil=True)
    bpp, h, w = info.bpp, info.height, info.width
    alpha = np.full((h, w, 1), 255, np.uint8)
    if info.compression in (RLE8, RLE4) or bpp <= 8:
        idx = (_rle(data, info, True) if info.compression in (RLE8, RLE4)
               else _indices(_rows(data, info, bpp), bpp, w))
        pal = info.palette[:, ::-1].copy()
        pal[min(info.colors, 256):] = 0
        n = min(info.colors, 256)
        if bpp == 8 and info.colors != 2 and (
                info.palette[:n] == np.arange(n)[:, None]).all():
            pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        return np.concatenate([pal[idx], alpha], axis=2)
    if bpp in (15, 16):
        v = _rows(data, info, 16)[:, :2 * w].copy().view("<u2").astype(
            np.int32)
        if bpp == 15:
            rgb = [((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31,
                   (v & 31) * 255 // 31]
        else:
            rgb = [((v >> 11) & 31) * 255 // 31, ((v >> 5) & 63) * 255 // 63,
                   (v & 31) * 255 // 31]
        return np.concatenate([np.stack(rgb, -1).astype(np.uint8), alpha], 2)
    k = bpp // 8
    px = _rows(data, info, bpp)[:, :k * w].reshape(h, w, k)
    if bpp == 24:
        return np.concatenate([px[..., ::-1], alpha], axis=2)
    return _pil_32(px, info, alpha)


# PIL's raw modes of a 32-bit BI_BITFIELDS file by its (r, g, b, a) masks:
# the byte (little-endian order) of R, G, B and of alpha (None: none)
_PIL32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0, None),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1, None),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0, None),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0, 3),
}


def _pil_32(px: np.ndarray, info: Info, alpha: np.ndarray) -> np.ndarray:
    if info.compression != BITFIELDS:
        return np.concatenate([px[..., 2::-1], alpha], axis=2)
    order: Optional[tuple] = _PIL32.get(tuple(info.masks))
    if order is None:
        raise BMPError(f"BMP 32-bit masks {info.masks} (PIL refuses them)")
    r, g, b, a = order
    out = [px[..., r], px[..., g], px[..., b],
           px[..., a] if a is not None else alpha[..., 0]]
    return np.stack(out, axis=-1)


def encode(img: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 → the BMP bytes cv2.imwrite
    writes for it (the colour image after RGB2BGR)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    gray = img.ndim == 2
    row = w * (1 if gray else 3)
    stride = (row + 3) & ~3
    palette = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    palette[:, 3] = 0
    head = palette.tobytes() if gray else b""
    offset = 14 + 40 + len(head)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :row] = (img if gray else img[..., ::-1]).reshape(h, row)
    return (b"BM" + struct.pack("<IHHI", offset + h * stride, 0, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8 if gray else 24,
                          0, 0, 0, 0, 0, 0)
            + head + rows[::-1].tobytes())
