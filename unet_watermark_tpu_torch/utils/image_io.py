"""Image read and write: the port's stand-in for the JAX package's
cv2.imread / cv2.imwrite (the GPU machine has no cv2 or PIL). As in cv2, a
file's content picks its decoder, not its name: PNG here (numpy and zlib),
JPEG (utils/jpeg.py's parser, ops/kernels/jpeg_entropy.py, the pixel stage
of ops/jpeg.py), BMP (utils/bmp.py), TIFF (utils/tiff.py) and WEBP
(utils/webp.py: csrc/webp_decode.c on the host, ops/webp.py's pixel
stage on the device).

read_rgb(path) returns what cv2.cvtColor(cv2.imread(path), BGR2RGB) returns:
(H, W, 3) uint8. PNG: interlaced or not, alpha dropped (no compositing),
gray replicated to three channels, palettes expanded, 1/2/4-bit gray
scaled to 8 bits and 16-bit samples reduced to their high byte (as
libpng's strip_16 does under cv2). JPEG: libjpeg-turbo's pixels, EXIF
orientation applied. read_gray(path) is cv2.imread(path,
IMREAD_GRAYSCALE): a gray PNG as stored; a colour or palette PNG through
libpng's rgb_to_gray as cv2 sets it up (png_set_rgb_to_gray(png, 1, 0.299,
0.587)): (9797 R + 19234 G + 3737 B) >> 15, truncated at 8 bits, rounded
at 16 bits and before strip_16, and through libpng's gamma tables where a
gAMA or sRGB chunk gives a significant file gamma (_rgb_to_gray); a
JPEG's Y plane; the other formats as their modules say. Both decode on
the host (a JPEG with the plain Python entropy decoder, a WEBP with the C
decoder and its pixel stage on the CPU). read_rgb_tensor(path, device)
returns the RGB image on a device: a JPEG's or a WEBP's pixel stage runs
there (on a CUDA device a JPEG's entropy decode is the C decoder); a PNG,
BMP or TIFF is decoded on the host and uploaded. The forms the format
modules refuse (a BigTIFF, a TIFF of other depths, codecs or colour
spaces, an animated WEBP, the JPEG forms utils/jpeg.py refuses) raise
NotImplementedError naming ROADMAP.md §A.5; a file cv2 would give None
for raises one of UNREADABLE.

read_rgba_tensor(path, device) is PIL's Image.open(path).convert("RGBA")
(data/gen_data.py's reads): a PNG's alpha channel or tRNS kept (a 16-bit
gray PNG as PIL's I;16 clipped to 255, other 16-bit samples' high byte), a
JPEG without its EXIF orientation, a WEBP's alpha, a TIFF as PIL opens it.

write_png(path, img) stores an (H, W) gray, (H, W, 3) RGB or (H, W, 4)
RGBA uint8 image as cv2.imwrite stores it (after RGB2BGR for colour):
8-bit, no interlace. `filters` picks the row filters (0 None, 1 Sub, 2 Up,
3 Average, 4 Paeth), cycled over the rows; the default is Up on every
row. encode_jpeg(img) / write_jpeg(path, img) give the bytes Pillow's
save(path, quality=95) writes: libjpeg-turbo's baseline 4:2:0 file, its
pixel stage on the image's device (ops/jpeg.encode_coefficients), the
Huffman coding on the host (csrc/jpeg_entropy.c); of a gray image, the
1-component file. write_image(path, img) is cv2.imwrite by extension
(PNG, JPEG, BMP).

Decoding undoes the five row filters in one pass over the anti-diagonals
of the byte grid: every filter reads only the left, upper and upper-left
neighbours, so all bytes on one diagonal y + x = d are independent, and
H + W numpy steps decode any mix of row filters. A file of None, Sub and
Up rows only (what write_png and cv2.imwrite write by default) is undone
row by row: all Sub rows at once (each a running sum mod 256 at a stride
of one pixel), then the Up rows from the top.
"""
from __future__ import annotations

import contextlib
import math
import struct
import zlib
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import jpeg as jpeg_pixels
from ..ops.kernels import jpeg_entropy
from . import bmp, jpeg, tiff, webp
from .bmp import BMPError
from .decode_error import DecodeError
from .jpeg import JPEGError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each colour type: gray, RGB, palette, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
ZLIB_LEVEL = 1  # the deflate level cv2.imwrite uses by default
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PNGError(DecodeError):
    """The file is not a well-formed PNG."""


# what a reader raises where cv2.imread would return None (PNGError,
# tiff.TIFFError and webp.WEBPError are DecodeErrors)
UNREADABLE = (OSError, DecodeError, JPEGError, BMPError)
FORMATS = "PNG, JPEG, BMP, TIFF or WEBP"


def sniff(head: bytes) -> Optional[str]:
    """The format a file's first bytes name: png, jpeg, bmp, tiff, webp or
    None (a file cv2 reads by none of the port's decoders)."""
    if head.startswith(SIGNATURE):
        return "png"
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(b"BM"):
        return "bmp"
    if tiff.is_tiff(head):
        return "tiff"
    if webp.is_webp(head):
        return "webp"
    return None


def require_decodable(path) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for a file
    this module cannot decode where cv2 could: a form check_image refuses
    (a BigTIFF, a TIFF of other depths, codecs or colour spaces, an
    animated WEBP, an arithmetic-coded, 12-bit, lossless or hierarchical
    JPEG). A file cv2 would give None for passes: the pipeline logs and
    skips it, as the JAX package does."""
    try:
        check_image(path)
    except UNREADABLE:
        pass


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"CRC mismatch in {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PNGError("no IEND chunk")


def _header(body: bytes):
    """(width, height, bit depth, colour type) of an IHDR body."""
    if len(body) != 13:
        raise PNGError("bad IHDR length")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body)
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise PNGError(f"bad colour type {ctype} / bit depth {depth}")
    if comp != 0 or filt != 0 or w == 0 or h == 0 or interlace > 1:
        raise PNGError("bad IHDR fields")
    return w, h, depth, ctype, interlace


def check_image(path) -> Tuple[int, int]:
    """(height, width) of the image cv2.imread would return, from the
    headers alone (a JPEG's up to its first scan, a TIFF's first IFD, a
    WEBP's chunks up to its image's, EXIF or TIFF orientation applied);
    raises as the decoder would for a file it cannot decode."""
    with open(path, "rb") as f:
        head = f.read(33)
        kind = sniff(head)
        if kind == "jpeg":
            return jpeg.parse(head + f.read(), headers_only=True
                              ).oriented_size()
        if kind == "bmp":
            info = bmp.parse(head + f.read(2048))
            return info.height, info.width
        if kind == "tiff":
            info = tiff.parse(head + f.read())
            if info.orientation in (5, 6, 7, 8):
                raise tiff.TIFFError(f"{path}: cv2.imread reads no TIFF "
                                     f"turned a quarter")
            return info.height, info.width
        if kind == "webp":
            return webp.oriented_size(webp.parse(head + f.read()))
    if kind != "png" or head[12:16] != b"IHDR":
        raise DecodeError(f"{path}: not a {FORMATS} file")
    w, h = _header(head[16:29])[:2]
    return h, w


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, rowbytes: int, bpp: int
              ) -> np.ndarray:
    """(h, rowbytes) uint8 reconstructed bytes from the filtered stream."""
    rows = raw.reshape(h, rowbytes + 1)
    ftype = rows[:, 0].astype(np.int16)
    if ftype.max(initial=0) > 4:
        raise PNGError(f"unknown row filter {int(ftype.max())}")
    if not ftype.any():
        return rows[:, 1:].copy()
    if np.isin(ftype, (0, 1, 2)).all():  # None, Sub and Up: row by row
        out = rows[:, 1:].copy()
        sub = np.flatnonzero(ftype == 1)  # each depends on its own row only
        if sub.size:  # uint8 wraps mod 256
            out[sub] = np.cumsum(out[sub].reshape(sub.size, -1, bpp), axis=1,
                                 dtype=np.uint8).reshape(sub.size, rowbytes)
        for y in np.flatnonzero(ftype[1:] == 2) + 1:  # Up, top to bottom;
            out[y] += out[y - 1]  # row 0's upper neighbours are zeros
        return out
    return _wavefront(rows, ftype, bpp)


def _wavefront(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of row filters, one anti-diagonal of pixels at a time."""
    h, rowbytes = rows.shape[0], rows.shape[1] - 1
    w = rowbytes // bpp  # "pixels" of bpp bytes: a filter's left neighbour
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int16)
    # skewed layout: diagonal d = y + x is row d + 2 of `rec`, pixel y at
    # column y + 1; rows 0-1 and column 0 are the zeros beyond the image
    ys = np.arange(h)[:, None]
    skew_f = np.zeros((h + w, h, bpp), np.int16)
    skew_f[ys + np.arange(w), ys] = filt
    rec = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    kinds = [int(k) for k in np.unique(ftype)]
    mixed = len(kinds) > 1
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a = rec[d + 1, lo + 1:hi + 1]  # left: (y, x - 1)
        b = rec[d + 1, lo:hi]          # up: (y - 1, x)
        pred = 0
        for k in kinds:  # only the predictors of the filters in use
            if k == 0:
                continue
            p = (a if k == 1 else b if k == 2 else (a + b) >> 1 if k == 3
                 else _paeth(a, b, rec[d, lo:hi]))  # c: up-left
            pred = np.where(ftype[lo:hi, None] == k, p, pred) \
                if mixed else p
        rec[d + 2, lo + 1:hi + 1] = (skew_f[d, lo:hi] + pred) & 0xFF
    out = rec[ys + np.arange(w) + 2, ys + 1]
    return out.astype(np.uint8).reshape(h, rowbytes)


def _unpack(rows: np.ndarray, w: int, h: int, depth: int, ctype: int,
            channels: int, wide: bool = False) -> np.ndarray:
    """Unfiltered rows → (h, w, channels) uint8 samples: 16-bit ones
    reduced to their high byte (wide=True: kept, uint16), 1/2/4-bit gray
    scaled to 8 bits."""
    if depth == 16:
        pairs = rows.reshape(h, w, channels, 2)
        if wide:
            return pairs[..., 0].astype(np.uint16) << 8 | pairs[..., 1]
        return pairs[..., 0]  # the high byte
    if depth == 8:
        return rows.reshape(h, w, channels)
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    px = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1))
    px = px.reshape(h, rows.shape[1] * per)[:, :w, None]
    if ctype == 0:  # scaled to 8 bits, as libpng's expand does
        px = px * np.uint8(255 // ((1 << depth) - 1))
    return px


class PNGSamples(NamedTuple):
    px: np.ndarray               # (H, W, channels) uint8, or uint16 (wide)
    ctype: int                   # colour type
    depth: int                   # bit depth
    palette: Optional[np.ndarray]  # PLTE as (N, 3) uint8
    trns: Optional[bytes]        # the tRNS body
    gamma: Optional[int]         # the file gamma x 100000 libpng takes
    sig_bit: int                 # sBIT's largest colour entry, 0 if none


def _png_samples(data: bytes, wide: bool = False) -> PNGSamples:
    """The unfiltered samples of a PNG, 16-bit ones reduced to their high
    byte (wide=True: kept), 1/2/4-bit gray scaled to 8 bits, with the
    chunks the readers use. An interlaced file's seven Adam7 passes are
    each unfiltered and unpacked on their own, then scattered into the
    image. The gamma is libpng's: sRGB's 45455 where an sRGB chunk comes
    before PLTE and IDAT, else such a gAMA chunk's value (16 up to
    625000000), else None."""
    header, palette, trns, idat = None, None, None, []
    gama = srgb = None
    sig_bit = 0
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif palette is None and not idat:  # libpng's place for these
            if kind == b"gAMA" and len(body) == 4 and gama is None:
                g = struct.unpack(">I", body)[0]
                gama = g if 16 <= g <= 625000000 else None
            elif kind == b"sRGB" and len(body) == 1 and body[0] < 4:
                srgb = 45455
            elif kind == b"sBIT" and body:
                sig_bit = max(body[:3])
    if header is None or not idat:
        raise PNGError("missing IHDR or IDAT")
    w, h, depth, ctype, interlace = header
    channels = _CHANNELS[ctype]
    bits = depth * channels
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    shapes = [(-(-(w - x0) // dx), -(-(h - y0) // dy))
              for x0, y0, dx, dy in passes]
    sizes = [ph * ((pw * bits + 7) // 8 + 1) if pw and ph else 0
             for pw, ph in shapes]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise PNGError(f"bad image data: {e}") from None
    if raw.size != sum(sizes):
        raise PNGError(f"image data is {raw.size} bytes, expected "
                       f"{sum(sizes)}")
    if interlace:
        px = np.empty((h, w, channels),
                      np.uint16 if wide and depth == 16 else np.uint8)
    at = 0
    for (x0, y0, dx, dy), (pw, ph), size in zip(passes, shapes, sizes):
        if not size:
            continue
        rowbytes = (pw * bits + 7) // 8
        rows = _unfilter(raw[at:at + size], ph, rowbytes, max(1, bits // 8))
        at += size
        sub = _unpack(rows, pw, ph, depth, ctype, channels, wide)
        if not interlace:
            px = sub
        else:
            px[y0::dy, x0::dx] = sub
    if ctype == 3:
        if palette is None:
            raise PNGError("palette image without PLTE")
        if px.max(initial=0) >= len(palette):
            raise PNGError("palette index out of range")
    return PNGSamples(px, ctype, depth, palette, trns, srgb or gama,
                      sig_bit if ctype != 3 else 0)


# png_set_rgb_to_gray(png, 1, 0.299, 0.587) (cv2's call) at libpng's 15
# bits: red and green truncated, blue the rest
_RC, _GC = 9797, 19234
_BC = 32768 - _RC - _GC


def _reciprocal(a: int) -> int:
    return int(math.floor(1e10 / a + .5))  # png_reciprocal


def _significant(g: int) -> bool:
    return g < 95000 or g > 105000  # png_gamma_significant


def _table8(gamma: int) -> np.ndarray:
    """png_build_8bit_table: value -> floor(255 (v / 255)^g + .5)."""
    v = np.arange(256, dtype=np.float64)
    if not _significant(gamma):
        return np.arange(256, dtype=np.int64)
    t = np.floor(255 * np.power(v / 255, gamma * 1e-5) + .5).astype(np.int64)
    t[0], t[255] = 0, 255
    return t


def _table16(shift: int, gamma: int) -> np.ndarray:
    """png_build_16bit_table, indexed by value >> shift."""
    top = (1 << (16 - shift)) - 1
    ig = np.arange(top + 1, dtype=np.int64)
    if not _significant(gamma):
        return (ig * 65535 + (1 << (15 - shift))) // top
    return np.floor(65535. * np.power(ig / top, gamma * 1e-5) + .5
                    ).astype(np.int64)


def _table16to8(shift: int, gamma: int) -> np.ndarray:
    """png_build_16to8_table, indexed by value >> shift: the 16-bit form
    (i * 257) of the 8-bit value nearest each input's gamma-corrected
    one."""
    top = (1 << (16 - shift)) - 1
    out = np.full(top + 1, 65535, np.int64)
    last = 0
    for i in range(255):
        v = i * 257 + 128  # the boundary above output i
        bound = int(math.floor(65535 * math.pow(v / 65535, gamma * 1e-5)
                               + .5)) if 0 < v < 65535 else v
        bound = (bound * top + 32768) // 65535 + 1
        if bound > last:
            out[last:bound] = i * 257
            last = bound
    return out


def _rgb_to_gray(rgb: np.ndarray, gamma: Optional[int], sig_bit: int
                 ) -> np.ndarray:
    """libpng's png_do_rgb_to_gray under cv2's IMREAD_GRAYSCALE, then
    strip_16: (..., 3) uint8 or uint16 samples -> uint8 gray. Without a
    significant file gamma: (rc R + gc G + bc B) >> 15, truncated at 8
    bits and rounded at 16. With one (gAMA or sRGB), through libpng's
    gamma_to_1 and gamma_from_1 tables (the screen gamma is the file's
    reciprocal), and at 16 bits its 16-to-8 table for gray pixels."""
    x = rgb.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    same = (r == g) & (g == b)
    wide = rgb.dtype == np.uint16
    tables = gamma is not None and (_significant(gamma)
                                    or _significant(_reciprocal(gamma)))
    if not tables:
        if not wide:
            return np.where(same, r, (_RC * r + _GC * g + _BC * b) >> 15
                            ).astype(np.uint8)
        return (((_RC * r + _GC * g + _BC * b + 16384) >> 15) >> 8
                ).astype(np.uint8)
    screen = _reciprocal(gamma)
    if not wide:
        to1, from1 = _table8(screen), _table8(_reciprocal(screen))
        y = from1[(_RC * to1[r] + _GC * to1[g] + _BC * to1[b] + 16384) >> 15]
        return np.where(same, r, y).astype(np.uint8)
    shift = 16 - sig_bit if 0 < sig_bit < 16 else 0
    shift = min(max(shift, 16 - 11), 8)  # PNG_MAX_GAMMA_8 under strip_16
    to1 = _table16(shift, screen)
    from1 = _table16(shift, _reciprocal(screen))
    same16 = _table16to8(shift, int(math.floor(gamma * 1e-5 * screen + .5)))
    lin = (_RC * to1[r >> shift] + _GC * to1[g >> shift]
           + _BC * to1[b >> shift] + 16384) >> 15
    y = np.where(same, same16[r >> shift], from1[lin >> shift])
    return (y >> 8).astype(np.uint8)


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    """PNG bytes → (H, W, 3) RGB uint8, or (H, W) uint8 with gray=True
    (see the module docstring for the rules)."""
    s = _png_samples(data, wide=gray)
    px, ctype = s.px, s.ctype
    if ctype == 3:
        rgb = s.palette[px[..., 0]]
        return _rgb_to_gray(rgb, s.gamma, 0) if gray else rgb
    if ctype in (0, 4):
        g = np.ascontiguousarray(px[..., 0])
        if g.dtype == np.uint16:
            g = (g >> 8).astype(np.uint8)
        return g if gray else np.repeat(g[..., None], 3, axis=2)
    if gray:
        return _rgb_to_gray(px[..., :3], s.gamma, s.sig_bit)
    return np.ascontiguousarray(px[..., :3])


def decode_png_rgba(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 4) uint8 as PIL's Image.open(p).convert("RGBA")
    gives it: gray replicated, palettes expanded, alpha from the file's
    alpha channel or from tRNS (per palette index, or 0 where a gray or
    RGB pixel equals the tRNS colour's low bytes), else 255. A 16-bit
    gray file is PIL's I;16 image, each sample clipped to 255; other
    16-bit samples are reduced to their high byte; the tRNS key is matched
    against those 8-bit values. A 1-bit gray tRNS makes the 0 bits
    transparent where it is 0 and the 1 bits where not; a 2/4-bit one is
    matched against the sample scaled to 8 bits."""
    s = _png_samples(data, wide=True)
    px, ctype, depth, palette, trns = s.px, s.ctype, s.depth, s.palette, \
        s.trns
    if px.dtype == np.uint16:
        px = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(np.uint8)
    h, w = px.shape[:2]
    alpha = np.full((h, w, 1), 255, np.uint8)
    if ctype == 3:
        lut = np.full((len(palette),), 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[:len(palette)]
            lut[:len(t)] = t
        idx = px[..., 0]
        return np.concatenate([palette[idx], lut[idx][..., None]], axis=2)
    if ctype in (4, 6):
        alpha = px[..., -1:]
    color = px[..., :1].repeat(3, axis=2) if ctype in (0, 4) else px[..., :3]
    if trns is not None and ctype in (0, 2):
        key = np.frombuffer(trns, ">u2").astype(np.int64)
        sample = px[..., :len(key)].astype(np.int64)
        if ctype == 0 and depth == 1:  # mode "1": any nonzero key is white
            sample, key = sample != 0, key != 0
        else:  # PIL keeps the key's low byte
            key = key & 0xFF
        same = (sample == key).all(axis=2)
        alpha = np.where(same, 0, 255).astype(np.uint8)[..., None]
    return np.ascontiguousarray(np.concatenate([color, alpha], axis=2))


def _no_part(name: str):
    return contextlib.nullcontext()


def decode_jpeg(data: bytes, device="cuda", gray: bool = False,
                part: Callable = _no_part, exif: bool = True,
                pil: bool = False) -> torch.Tensor:
    """JPEG bytes → (H, W, 3) RGB or (H, W) gray uint8 on `device`, as
    cv2.imread gives it (exif=False: as PIL's Image.open gives it, without
    the EXIF orientation; pil=True also converts a CMYK or YCCK file as
    PIL does). part(name) wraps each of the two stages,
    "jpeg_entropy" (host) and "jpeg_pixels" (upload and pixel stage on the
    device), for a caller that times them."""
    device = torch.device(device)
    with part("jpeg_entropy"):
        header = jpeg.parse(data)
        coefs = jpeg_entropy.decode_scans(header, data, device)
    with part("jpeg_pixels"):
        return jpeg_pixels.decode(
            header, [torch.from_numpy(c).to(device) for c in coefs], gray,
            exif=exif, pil=pil)


def _read(path, device, gray: bool, part: Callable = _no_part):
    """The decoded file: a tensor on `device` for a JPEG or a WEBP, a
    numpy array for a PNG, a BMP or a TIFF."""
    with open(path, "rb") as f:
        data = f.read()
    kind = sniff(data[:16])
    if kind == "jpeg":
        return decode_jpeg(data, device, gray, part)
    if kind == "webp":
        return webp.decode(data, device, gray, part)
    if kind == "bmp":
        return bmp.decode(data, gray=gray)
    if kind == "tiff":
        return tiff.decode(data, gray=gray)
    if kind != "png":
        raise DecodeError(f"{path}: not a {FORMATS} file")
    return decode_png(data, gray=gray)


def read_rgb(path) -> np.ndarray:
    img = _read(path, "cpu", False)
    return img.numpy() if isinstance(img, torch.Tensor) else img


def read_gray(path) -> np.ndarray:
    img = _read(path, "cpu", True)
    return img.numpy() if isinstance(img, torch.Tensor) else img


def read_rgb_tensor(path, device, part: Callable = _no_part
                    ) -> torch.Tensor:
    """(H, W, 3) uint8 RGB on `device`: a JPEG or a WEBP decoded there
    (the host's entropy decode, then the pixel stage on the device, inside
    part("jpeg_entropy"/"jpeg_pixels") or part("webp_entropy"/
    "webp_pixels"); a JPEG's entropy decode is the C decoder on a CUDA
    device), a PNG, a BMP or a TIFF decoded on the host and uploaded
    inside part("png_upload")."""
    img = _read(path, device, False, part)
    if isinstance(img, np.ndarray):
        with part("png_upload"):
            img = torch.from_numpy(img).to(device)
    return img


def read_gray_tensor(path, device) -> torch.Tensor:
    """cv2.imread(path, IMREAD_GRAYSCALE) as an (H, W) uint8 tensor on
    `device` (a JPEG's or a WEBP's pixel stage there)."""
    img = _read(path, device, True)
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(img).to(device)
    return img


def read_rgba_tensor(path, device) -> torch.Tensor:
    """(H, W, 4) uint8 on `device`, as PIL's
    Image.open(path).convert("RGBA") gives it: a PNG through
    decode_png_rgba, a BMP through bmp.decode_rgba, a TIFF through
    tiff.decode_rgba, a WEBP through webp.decode (its alpha kept, no EXIF
    orientation), a JPEG through decode_jpeg without its EXIF orientation
    (PIL's open does not apply it) and with alpha 255 (a CMYK or YCCK one
    through PIL's own CMYK -> RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    kind = sniff(data[:16])
    if kind == "png":
        return torch.from_numpy(decode_png_rgba(data)).to(device)
    if kind == "bmp":
        return torch.from_numpy(bmp.decode_rgba(data)).to(device)
    if kind == "tiff":
        return torch.from_numpy(tiff.decode_rgba(data)).to(device)
    if kind == "webp":
        return webp.decode(data, device, exif=False, rgba=True)
    if kind != "jpeg":
        raise DecodeError(f"{path}: not a {FORMATS} file")
    rgb = decode_jpeg(data, device, exif=False, pil=True)
    return torch.cat([rgb, torch.full_like(rgb[..., :1], 255)], dim=2)


def _filter_rows(img: np.ndarray, filters: Sequence[int]) -> bytes:
    """The filtered byte stream: each row's filter type, then its bytes
    minus the filter's predictor (computed only for the types in use)."""
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, -1).astype(np.int16)
    kinds = np.resize(np.asarray(filters, np.int16), h)
    out = np.empty((h, x.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    for k in np.unique(kinds):
        sel = np.flatnonzero(kinds == k)
        cur = x[sel]
        a = np.zeros_like(cur)  # left
        a[:, bpp:] = cur[:, :-bpp]
        b = np.zeros_like(cur)  # up: the previous row, 0 above the image
        up = sel > 0
        b[up] = x[sel[up] - 1]
        c = np.zeros_like(cur)  # up-left
        c[:, bpp:] = b[:, :-bpp]
        pred = (0 if k == 0 else a if k == 1 else b if k == 2
                else (a + b) >> 1 if k == 3 else _paeth(a, b, c))
        out[sel, 1:] = (cur - pred) & 0xFF
    return out.tobytes()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, filters: Sequence[int] = (2,)) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 → PNG bytes, rows
    filtered by `filters` (cycled), deflated at ZLIB_LEVEL."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] in (3, 4))):
        raise ValueError(f"expected (H, W), (H, W, 3) or (H, W, 4) uint8, "
                         f"got {img.shape} {img.dtype}")
    if not len(filters) or not all(0 <= int(f) <= 4 for f in filters):
        raise ValueError(f"row filters must be in 0..4, got {filters}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    data = zlib.compress(_filter_rows(img, filters), ZLIB_LEVEL)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data)
            + _chunk(b"IEND", b""))


def encode_jpeg(img: torch.Tensor, quality: int = 95) -> bytes:
    """(H, W, 3) RGB uint8 (a tensor on any device, or numpy) → the bytes
    Pillow's Image.fromarray(img).save(path, quality=quality) writes, which
    are cv2.imwrite's of the BGR image: libjpeg-turbo's baseline 4:2:0 file
    (ops/jpeg.encode_coefficients on the tensor's device, the Huffman
    coding on the host). An (H, W) gray image gives the 1-component file
    both write (ops/jpeg.encode_gray_coefficients)."""
    img = torch.as_tensor(img)
    h, w = img.shape[:2]
    gray = img.dim() == 2
    blocks = [jpeg_pixels.encode_gray_coefficients(img, quality)] if gray \
        else jpeg_pixels.encode_coefficients(img, quality)
    data = jpeg_entropy.encode_scan([b.cpu().numpy() for b in blocks])
    return (jpeg.baseline_headers(w, h, jpeg_pixels.quality_tables(quality),
                                  gray) + data + b"\xff\xd9")


def write_jpeg(path, img: torch.Tensor, quality: int = 95) -> None:
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)


def write_png(path, img: np.ndarray, filters: Optional[Sequence[int]] = None
              ) -> None:
    data = encode_png(img, filters or (2,))
    with open(path, "wb") as f:
        f.write(data)


WRITERS = (".png", ".jpg", ".jpeg", ".bmp")


def write_image(path, img) -> bool:
    """cv2.imwrite(path, img) for an (H, W) gray or (H, W, 3) RGB uint8
    image (numpy or a tensor; the colour one as cv2 writes the BGR image),
    the format by the name's extension: PNG, JPEG at cv2's quality 95, or
    BMP (utils/bmp.encode). An (H, W, 4) RGBA image goes to PNG only. Any
    other extension raises ValueError; the result is True, as cv2's."""
    ext = str(path)[str(path).rfind("."):].lower()
    if ext not in WRITERS:
        raise ValueError(f"{path}: the port writes {WRITERS}, not {ext}")
    if ext in (".jpg", ".jpeg"):
        data = encode_jpeg(img, 95)
    else:
        arr = np.asarray(img.cpu() if isinstance(img, torch.Tensor) else img)
        data = encode_png(arr) if ext == ".png" else bmp.encode(arr)
    with open(path, "wb") as f:
        f.write(data)
    return True
