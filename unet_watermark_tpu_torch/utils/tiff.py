"""TIFF files as cv2.imread (libtiff 4.7 through its RGBA interface) and
PIL's Image.open read them, with numpy on the host, the LZW and PackBits
strips in C (ops/kernels/tiff.py: csrc/tiff_codecs.c).

In scope: classic TIFF in either byte order, its first IFD (cv2.imread
reads the first page), 8 bits a sample, strips or tiles, PlanarConfiguration
1 and 2, Compression 1 (none), 5 (LZW), 8 and 32946 (Deflate, through
zlib) and 32773 (PackBits), Predictor 2 (horizontal differencing, under
LZW and Deflate only, as libtiff applies it), Photometric min-is-white,
min-is-black, RGB and palette, one extra sample as alpha.

decode(data, gray) is cv2.imread(path) (RGB, after BGR2RGB) or
cv2.imread(path, IMREAD_GRAYSCALE):

  gray        min-is-black as stored, min-is-white inverted; an alpha
              sample dropped (libtiff does not premultiply gray)
  RGB         unassociated alpha (ExtraSamples 2) premultiplied as
              libtiff's RGBA interface does it, (v a + 127) // 255, then
              dropped; associated alpha, or an unspecified extra sample
              (libtiff takes it as associated), dropped as stored
  palette     the ColorMap's 16-bit entries reduced to their high byte, or
              taken as they are where none is 256 or more (libtiff's test
              for an old 8-bit map)
  IMREAD_     cv2's own BGR -> gray of those colours (weights 1868, 9617,
  GRAYSCALE   4899 over 2^14, rounded, as utils/bmp.py's)
  Orientation the tag's flip (2-4), as cv2.imread applies EXIF's

cv2.imread gives None, and decode raises TIFFError, for Orientation 5-8,
which PIL reads (cv2 5.0's imread fails its own check after the decoder
turns the image). cv2.imdecode, from memory, differs from cv2.imread here
and for uncompressed tiles (it reads the first and refuses the second
unless TileWidth x TileLength is a multiple of 1024); the readers follow
cv2.imread, the JAX package's reader of images.

decode_rgba(data) is PIL's Image.open(path).convert("RGBA"), for the
layouts PIL's TIFF plugin opens (PIL_MODES; others raise TIFFError): gray
replicated (min-is-white inverted), a gray alpha sample (ExtraSamples 2)
kept, an RGB image's fourth sample kept as alpha unless ExtraSamples says
0 (associated alpha divided out as PIL's RGBa unpacker does: v * 255 //
a, 0 where a is 0), a palette's entries // 256, alpha 255 elsewhere; the
Orientation tag applied as cv2 applies it.

Other forms raise NotImplementedError naming ROADMAP.md §A.5: BigTIFF,
bit depths other than 8 (1-bit, 16-bit, float), the other compressions
(CCITT, JPEG, old-style LZW, ...), YCbCr, CMYK and the other photometric
interpretations, signed samples, FillOrder 2, more than one extra sample,
Predictor 3. A file libtiff refuses (cv2 gives None): a cut or corrupt
directory or strip, a missing required tag, raises TIFFError.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.jpeg import orient
from ..ops.kernels import tiff as tiff_c
from .decode_error import DecodeError

SIGNATURES = (b"II*\x00", b"MM\x00*")
BIGTIFF = (b"II+\x00", b"MM\x00+")
CODECS = {1: "none", 5: "lzw", 8: "deflate", 32946: "deflate",
          32773: "packbits"}
# libtiff's other codecs: cv2 reads these, the port does not yet
UNPORTED_CODECS = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4",
                   6: "old JPEG", 7: "JPEG", 32766: "NeXT",
                   32771: "CCITT RLEW", 32809: "ThunderScan",
                   32909: "PixarLog", 34661: "JBIG", 34676: "SGILog",
                   34677: "SGILog24", 34712: "JPEG 2000", 34887: "LERC",
                   34925: "LZMA", 50000: "ZSTD", 50001: "WEBP",
                   50002: "JPEG XL"}
# bytes of one value of each field type
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 13: 4}
_FORMS = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i",
          11: "f", 12: "d", 13: "I"}
# cv2's BGR -> gray weights for its TIFF reader (icvCvt_BGRA2Gray)
_CR, _CG, _CB = 4899, 9617, 1868


class TIFFError(DecodeError):
    """cv2.imread gives None for the file."""


def _refuse(what: str):
    raise NotImplementedError(
        f"{what}: the port decodes 8-bit TIFF (none, LZW, Deflate, "
        f"PackBits; gray, RGB, palette); this form is not ported yet "
        f"(ROADMAP.md §A.5, other image formats)")


@dataclass
class Info:
    width: int
    height: int
    tags: Dict[int, tuple] = field(default_factory=dict)
    spp: int = 1
    compression: int = 1
    photometric: int = 1
    planar: int = 1
    predictor: int = 1
    extra: int = -1             # ExtraSamples[0], -1 without one
    orientation: int = 1


def is_tiff(head: bytes) -> bool:
    return head[:4] in SIGNATURES or head[:4] in BIGTIFF


def _read_ifd(data: bytes, bo: str) -> Dict[int, tuple]:
    n = len(data)
    (off,) = struct.unpack_from(f"{bo}I", data, 4)
    if off < 8 or off + 2 > n:
        raise TIFFError("TIFF directory outside the file")
    (count,) = struct.unpack_from(f"{bo}H", data, off)
    if off + 2 + 12 * count > n:
        raise TIFFError("TIFF directory cut off")
    tags = {}
    for i in range(count):
        tag, kind, num = struct.unpack_from(f"{bo}HHI", data, off + 2 + 12 * i)
        size = _SIZES.get(kind)
        if size is None:
            continue  # libtiff skips a field of unknown type
        pos = off + 2 + 12 * i + 8
        if size * num > 4:
            (pos,) = struct.unpack_from(f"{bo}I", data, pos)
            if pos + size * num > n:
                raise TIFFError(f"TIFF tag {tag} outside the file")
        if kind in (5, 10):
            raw = struct.unpack_from(f"{bo}{2 * num}{'I' if kind == 5 else 'i'}",
                                     data, pos)
            tags[tag] = tuple(raw[0::2])
        else:
            tags[tag] = struct.unpack_from(f"{bo}{num}{_FORMS[kind]}", data,
                                           pos)
    return tags


def parse(data: bytes) -> Info:
    """The first IFD as libtiff reads it; raises TIFFError where libtiff
    refuses the file, NotImplementedError for a form not ported."""
    if data[:4] in BIGTIFF:
        _refuse("a BigTIFF file")
    if data[:4] not in SIGNATURES:
        raise TIFFError("not a TIFF file")
    if len(data) < 8:
        raise TIFFError("TIFF header cut off")
    bo = "<" if data[:2] == b"II" else ">"
    tags = _read_ifd(data, bo)

    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    w, h = one(256), one(257)
    if not w or not h:
        raise TIFFError("TIFF without its image size")
    info = Info(w, h, tags)
    info.spp = one(277, 1)
    info.compression = one(259, 1)
    info.planar = one(284, 1)
    info.predictor = one(317, 1)
    extras = tags.get(338, ())
    info.extra = extras[0] if extras else -1
    o = one(274, 1)
    info.orientation = o if o in range(1, 9) else 1
    bits = tags.get(258, (1,))
    if any(b != 8 for b in bits):
        _refuse(f"a TIFF of {bits[0]}-bit samples")
    if one(339, 1) != 1:
        _refuse("a TIFF of signed or floating-point samples")
    if one(266, 1) != 1:
        _refuse("a TIFF with FillOrder 2")
    if info.compression in UNPORTED_CODECS:
        _refuse(f"a {UNPORTED_CODECS[info.compression]}-compressed TIFF")
    if info.compression not in CODECS:
        raise TIFFError(f"unknown TIFF compression {info.compression}")
    first = (tags.get(273) or tags.get(324) or (None,))[0]
    if info.compression == 5 and first is not None and \
            data[first:first + 1] == b"\0" and \
            data[first + 1:first + 2] and data[first + 1] & 1:
        _refuse("a TIFF in old-style LZW")  # libtiff's test, first strip
    photometric = tags.get(262)
    if photometric is None:  # libtiff's guess
        photometric = (2 if info.spp - len(extras) >= 3 else 1,)
    info.photometric = photometric[0]
    if info.photometric not in (0, 1, 2, 3):
        names = {4: "a transparency mask", 5: "a CMYK (separated)",
                 6: "a YCbCr", 8: "a CIELab", 9: "an ICCLab",
                 10: "an ITULab", 32844: "a LogL", 32845: "a LogLuv"}
        _refuse(f"{names.get(info.photometric, 'an unknown')} TIFF "
                f"(Photometric {info.photometric})")
    color = 3 if info.photometric == 2 else 1
    if info.spp not in (color, color + 1) or len(extras) > 1 or (
            info.photometric == 3 and info.spp != 1):
        _refuse(f"a TIFF of {info.spp} samples a pixel")
    if info.planar not in (1, 2):
        raise TIFFError(f"bad PlanarConfiguration {info.planar}")
    if info.predictor not in (1, 2, 3):
        raise TIFFError(f"bad Predictor {info.predictor}")
    if info.predictor == 3 and CODECS[info.compression] in ("lzw",
                                                             "deflate"):
        _refuse("a TIFF with the floating-point predictor")
    if info.photometric == 3 and len(tags.get(320, ())) < 3 * 256:
        raise TIFFError("palette TIFF without its ColorMap")
    return info


def _blocks(info: Info) -> Tuple[List[int], List[int], int, int, int, int]:
    """(offsets, counts, rows a block, columns a block, blocks down,
    blocks across)."""
    tags, w, h = info.tags, info.width, info.height
    if 322 in tags or 324 in tags:
        tw, th = tags.get(322, (0,))[0], tags.get(323, (0,))[0]
        if not tw or not th or tw % 16 or th % 16:
            raise TIFFError("bad TIFF tile size")
        offsets, counts = tags.get(324), tags.get(325)
        down, across = -(-h // th), -(-w // tw)
    else:
        rps = min(tags.get(278, (h,))[0] or h, h)
        th, tw = rps, w
        offsets, counts = tags.get(273), tags.get(279)
        down, across = -(-h // rps), 1
    planes = info.spp if info.planar == 2 else 1
    if offsets is None or len(offsets) < planes * down * across:
        raise TIFFError("TIFF without its strip or tile offsets")
    if counts is None:
        if info.compression != 1:
            raise TIFFError("TIFF without its strip byte counts")
        per = info.spp if info.planar == 1 else 1
        counts = [th * tw * per] * len(offsets)
    if len(counts) < len(offsets):
        raise TIFFError("TIFF strip byte counts cut off")
    return list(offsets), list(counts), th, tw, down, across


def _strip(info: Info, data: bytes, off: int, count: int, size: int,
           row: int) -> np.ndarray:
    """One strip or tile decoded to exactly `size` bytes."""
    if off + count > len(data):
        raise TIFFError("TIFF strip outside the file")
    raw = data[off:off + count]
    codec = CODECS[info.compression]
    try:
        if codec == "none":
            out = np.frombuffer(raw, np.uint8)[:size]
        elif codec == "lzw":
            out = tiff_c.lzw_decode(raw, size)
        elif codec == "packbits":
            out = tiff_c.packbits_decode(raw, size)
        else:
            d = zlib.decompressobj()
            out = np.frombuffer(d.decompress(raw, size), np.uint8)
    except (tiff_c.TIFFStreamError, zlib.error) as e:
        raise TIFFError(f"corrupt TIFF strip: {e}") from None
    if out.size < size:
        raise TIFFError("TIFF strip shorter than its rows")
    if info.predictor == 2 and codec in ("lzw", "deflate"):
        per = info.spp if info.planar == 1 else 1
        out = np.cumsum(out.reshape(-1, row // per, per), axis=1,
                        dtype=np.uint8).reshape(-1)
    return out


def samples(data: bytes, info: Info) -> np.ndarray:
    """(H, W, samples a pixel) uint8 as stored."""
    offsets, counts, th, tw, down, across = _blocks(info)
    w, h, spp = info.width, info.height, info.spp
    planes = spp if info.planar == 2 else 1
    per = spp // planes
    out = np.empty((h, w, spp), np.uint8)
    i = 0
    for p in range(planes):
        for by in range(down):
            for bx in range(across):
                rows = th if 322 in info.tags or 324 in info.tags else \
                    min(th, h - by * th)
                size = rows * tw * per
                block = _strip(info, data, offsets[i], counts[i], size,
                               tw * per).reshape(rows, tw, per)
                i += 1
                y0, x0 = by * th, bx * tw
                ch, cw = min(rows, h - y0), min(tw, w - x0)
                out[y0:y0 + ch, x0:x0 + cw, p * per:(p + 1) * per] = \
                    block[:ch, :cw]
    return out


def _colormap(info: Info, pil: bool) -> np.ndarray:
    cmap = np.asarray(info.tags[320][:3 * 256], np.int64).reshape(3, 256).T
    if pil or (cmap >= 256).any():
        cmap = cmap >> 8
    return cmap.astype(np.uint8)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    return orient(torch.from_numpy(img), orientation).numpy()


def decode(data: bytes, gray: bool = False) -> np.ndarray:
    """TIFF bytes → (H, W, 3) RGB or (H, W) gray uint8 as cv2.imread gives
    them (see the module docstring)."""
    info = parse(data)
    if info.orientation in (5, 6, 7, 8):
        raise TIFFError("cv2.imread reads no TIFF turned a quarter")
    px = samples(data, info)
    p = info.photometric
    if p in (0, 1):
        g = 255 - px[..., 0] if p == 0 else px[..., 0]
        out = g if gray else np.repeat(g[..., None], 3, axis=2)
        return _orient(np.ascontiguousarray(out), info.orientation)
    if p == 3:
        rgb = _colormap(info, pil=False)[px[..., 0]]
    else:
        rgb = px[..., :3]
        if info.spp == 4 and info.extra == 2:
            a = px[..., 3:].astype(np.int32)
            rgb = ((rgb.astype(np.int32) * a + 127) // 255).astype(np.uint8)
    if gray:
        x = rgb.astype(np.int32)
        rgb = ((x[..., 0] * _CR + x[..., 1] * _CG + x[..., 2] * _CB
                + (1 << 13)) >> 14).astype(np.uint8)
    return _orient(np.ascontiguousarray(rgb), info.orientation)


# PIL's TiffImagePlugin.OPEN_INFO for 8-bit samples: (photometric,
# planar configuration, samples a pixel, ExtraSamples) -> its raw mode
PIL_MODES = {(0, 1, 1, ()): "L;I", (1, 1, 1, ()): "L",
             (1, 1, 2, (2,)): "LA", (3, 1, 1, ()): "P",
             **{(2, pl, 3, ()): "RGB" for pl in (1, 2)},
             **{(2, pl, 4, ex): mode for pl in (1, 2)
                for ex, mode in (((), "RGBA"), ((0,), "RGBX"),
                                 ((1,), "RGBa"), ((2,), "RGBA"),
                                 ((999,), "RGBA"))}}


def decode_rgba(data: bytes) -> np.ndarray:
    """TIFF bytes → (H, W, 4) uint8 as PIL's convert("RGBA") gives them;
    a layout PIL cannot open raises TIFFError."""
    info = parse(data)
    mode = PIL_MODES.get((info.photometric, info.planar, info.spp,
                          tuple(info.tags.get(338, ()))))
    if mode is None:
        raise TIFFError("PIL cannot open this TIFF layout")
    px = samples(data, info)
    h, w = px.shape[:2]
    alpha = np.full((h, w, 1), 255, np.uint8)
    if mode in ("L", "L;I", "LA"):
        g = 255 - px[..., :1] if mode == "L;I" else px[..., :1]
        rgb = np.repeat(g, 3, axis=2)
        if mode == "LA":
            alpha = px[..., 1:]
    elif mode == "P":
        rgb = _colormap(info, pil=True)[px[..., 0]]
    else:
        rgb = px[..., :3]
        if mode in ("RGBA", "RGBa"):
            alpha = px[..., 3:]
        if mode == "RGBa":  # PIL's unpacker divides the alpha out
            a = alpha.astype(np.int32)
            un = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1),
                            255)
            rgb = np.where(a == 255, rgb, np.where(a == 0, 0, un)).astype(
                np.uint8)
    out = np.ascontiguousarray(np.concatenate([rgb, alpha], axis=2))
    return _orient(out, info.orientation)
