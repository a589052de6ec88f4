"""Image read and write: the port's stand-in for the JAX package's
cv2.imread / cv2.imwrite (the GPU machine has no cv2 or PIL). PNG is read
and written with numpy and zlib; JPEG is read by utils/jpeg.py's parser,
the entropy decoder of ops/kernels/jpeg_entropy.py and the pixel stage of
ops/jpeg.py. As in cv2, a file's content picks its decoder, not its name.

read_rgb(path) returns what cv2.cvtColor(cv2.imread(path), BGR2RGB) returns:
(H, W, 3) uint8. PNG: alpha dropped (no compositing), gray replicated to
three channels, palettes expanded, 1/2/4-bit gray scaled to 8 bits and
16-bit samples reduced to their high byte (as libpng's strip_16 does under
cv2). JPEG: libjpeg-turbo's pixels, EXIF orientation applied.
read_gray(path) is cv2.imread(path, IMREAD_GRAYSCALE) for PNGs stored as
gray (with or without alpha; the mask files the pipeline writes) and for
every JPEG (a colour JPEG's Y plane). A colour PNG read as gray raises
NotImplementedError: cv2 converts it inside libpng with a gamma-aware rule
that is not ported. Both decode on the host (a JPEG with the plain Python
entropy decoder). read_rgb_tensor(path, device) returns the RGB image on a
device: a JPEG's pixel stage runs there, and on a CUDA device its entropy
decode is the C decoder; a PNG is decoded on the host and uploaded.
Interlaced PNGs, BMP, TIFF and WEBP files and the JPEG forms utils/jpeg.py
refuses raise NotImplementedError; a file cv2 would give None for raises
one of UNREADABLE.

read_rgba_tensor(path, device) is PIL's Image.open(path).convert("RGBA")
(data/gen_data.py's reads): a PNG's alpha channel or tRNS kept, a JPEG
without its EXIF orientation; 16-bit PNGs raise NotImplementedError.

write_png(path, img) stores an (H, W) gray, (H, W, 3) RGB or (H, W, 4)
RGBA uint8 image as cv2.imwrite stores it (after RGB2BGR for colour):
8-bit, no interlace. `filters` picks the row filters (0 None, 1 Sub, 2 Up,
3 Average, 4 Paeth), cycled over the rows; the default is Up on every
row. encode_jpeg(img) / write_jpeg(path, img) give the bytes Pillow's
save(path, quality=95) writes: libjpeg-turbo's baseline 4:2:0 file, its
pixel stage on the image's device (ops/jpeg.encode_coefficients), the
Huffman coding on the host (csrc/jpeg_entropy.c).

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
import os
import struct
import zlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import jpeg as jpeg_pixels
from ..ops.kernels import jpeg_entropy
from . import jpeg
from .jpeg import JPEGError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each colour type: gray, RGB, palette, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
ZLIB_LEVEL = 1  # the deflate level cv2.imwrite uses by default
# signatures of the formats cv2 reads that the port does not decode yet
UNPORTED = {"bmp": (b"BM",), "tiff": (b"II*\x00", b"MM\x00*"),
            "webp": (b"RIFF",)}
UNPORTED_EXTS = ("bmp", "tiff", "tif", "webp")


class DecodeError(ValueError):
    """The file is neither a PNG nor a JPEG (cv2.imread gives None)."""


class PNGError(DecodeError):
    """The file is not a well-formed PNG."""


# what a reader raises where cv2.imread would return None
UNREADABLE = (OSError, DecodeError, JPEGError)


def sniff(head: bytes) -> Optional[str]:
    """The format a file's first bytes name: png, jpeg, one of UNPORTED's,
    or None."""
    if head.startswith(SIGNATURE):
        return "png"
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    for kind, sigs in UNPORTED.items():
        if any(head.startswith(sig) for sig in sigs) and (
                kind != "webp" or head[8:12] == b"WEBP"):
            return kind
    return None


def _refuse_unported(path, head: bytes) -> Optional[str]:
    """The format of a file from its first bytes (sniff); raises
    NotImplementedError, naming the ROADMAP.md item, for a BMP, TIFF or
    WEBP file, by content, or by name where the content is neither PNG nor
    JPEG."""
    kind = sniff(head)
    ext = os.path.splitext(str(path))[1][1:].lower()
    if kind in UNPORTED or (kind is None and ext in UNPORTED_EXTS):
        raise NotImplementedError(
            f"{path}: a {(kind or ext).upper()} file: the port decodes PNG "
            f"and JPEG only; BMP, TIFF and WEBP decoding is not ported yet "
            f"(ROADMAP.md §A.5, other image formats)")
    return kind


def require_decodable(path) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for a file
    this module cannot decode where cv2 could: a BMP, TIFF or WEBP file, an
    interlaced PNG or a refused JPEG form. A file cv2 would give None for
    passes: the pipeline logs and skips it, as the JAX package does."""
    try:
        with open(path, "rb") as f:
            head = f.read(16)
    except OSError:
        head = b""
    _refuse_unported(path, head)
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
    if comp != 0 or filt != 0 or w == 0 or h == 0:
        raise PNGError("bad IHDR fields")
    if interlace != 0:
        raise NotImplementedError(
            "interlaced (Adam7) PNGs are not decoded yet (ROADMAP.md §A.5, "
            "other image formats)")
    return w, h, depth, ctype


def check_image(path) -> Tuple[int, int]:
    """(height, width) of the image cv2.imread would return, from the
    headers alone (a JPEG's up to its first scan, EXIF orientation
    applied); raises as the decoder would for a file it cannot decode."""
    with open(path, "rb") as f:
        head = f.read(33)
        kind = sniff(head)
        if kind == "jpeg":
            return jpeg.parse(head + f.read(), headers_only=True
                              ).oriented_size()
    if kind != "png" or head[12:16] != b"IHDR":
        raise DecodeError(f"{path}: neither a PNG nor a JPEG file")
    w, h, _, _ = _header(head[16:29])
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


def _png_samples(data: bytes):
    """The unfiltered samples of a PNG: (px (H, W, channels) uint8, colour
    type, bit depth, PLTE as (N, 3) or None, tRNS body or None); 16-bit
    samples reduced to their high byte, 1/2/4-bit gray scaled to 8 bits."""
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise PNGError("missing IHDR or IDAT")
    w, h, depth, ctype = header
    channels = _CHANNELS[ctype]
    bits = depth * channels
    rowbytes = (w * bits + 7) // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise PNGError(f"bad image data: {e}") from None
    if raw.size != h * (rowbytes + 1):
        raise PNGError(f"image data is {raw.size} bytes, expected "
                       f"{h * (rowbytes + 1)}")
    rows = _unfilter(raw, h, rowbytes, max(1, bits // 8))
    if depth == 16:
        px = rows.reshape(h, w, channels, 2)[..., 0]  # the high byte
    elif depth == 8:
        px = rows.reshape(h, w, channels)
    else:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1))
        px = px.reshape(h, rowbytes * per)[:, :w, None]
        if ctype == 0:  # scaled to 8 bits, as libpng's expand does
            px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise PNGError("palette image without PLTE")
        if px.max(initial=0) >= len(palette):
            raise PNGError("palette index out of range")
    return px, ctype, depth, palette, trns


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    """PNG bytes → (H, W, 3) RGB uint8, or (H, W) uint8 with gray=True
    (see the module docstring for the rules)."""
    px, ctype, _, palette, _ = _png_samples(data)
    if ctype == 3:
        if gray:
            raise NotImplementedError(
                "a palette PNG read as gray: cv2 converts it with libpng's "
                "gamma-aware rule, which is not ported")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        g = np.ascontiguousarray(px[..., 0])
        return g if gray else np.repeat(g[..., None], 3, axis=2)
    if gray:
        raise NotImplementedError(
            "a colour PNG read as gray: cv2 converts it with libpng's "
            "gamma-aware rule, which is not ported")
    return np.ascontiguousarray(px[..., :3])


def decode_png_rgba(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 4) uint8 as PIL's Image.open(p).convert("RGBA")
    gives it: gray replicated, palettes expanded, alpha from the file's
    alpha channel or from tRNS (per palette index, or 0 where a gray or
    RGB pixel equals the tRNS colour), else 255. PIL keeps 16 bits and
    compares a low-depth gray tRNS against unscaled samples, so 16-bit
    files and 1/2/4-bit gray files with tRNS raise NotImplementedError."""
    px, ctype, depth, palette, trns = _png_samples(data)
    if depth == 16:
        raise NotImplementedError(
            "a 16-bit PNG read as RGBA: PIL keeps 16-bit samples where the "
            "port reduces them to 8 bits (ROADMAP.md §A.5, other image "
            "formats)")
    if ctype == 0 and trns is not None and depth < 8:
        raise NotImplementedError(
            "a 1/2/4-bit gray PNG with tRNS read as RGBA: PIL matches the "
            "transparent sample before scaling (ROADMAP.md §A.5, other "
            "image formats)")
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
        same = (px[..., :len(key)].astype(np.int64) == key).all(axis=2)
        alpha = np.where(same, 0, 255).astype(np.uint8)[..., None]
    return np.ascontiguousarray(np.concatenate([color, alpha], axis=2))


def _no_part(name: str):
    return contextlib.nullcontext()


def decode_jpeg(data: bytes, device="cuda", gray: bool = False,
                part: Callable = _no_part, exif: bool = True
                ) -> torch.Tensor:
    """JPEG bytes → (H, W, 3) RGB or (H, W) gray uint8 on `device`, as
    cv2.imread gives it (exif=False: as PIL's Image.open gives it, without
    the EXIF orientation). part(name) wraps each of the two stages,
    "jpeg_entropy" (host) and "jpeg_pixels" (upload and pixel stage on the
    device), for a caller that times them."""
    device = torch.device(device)
    with part("jpeg_entropy"):
        header = jpeg.parse(data)
        coefs = jpeg_entropy.decode_scans(header, data, device)
    with part("jpeg_pixels"):
        return jpeg_pixels.decode(
            header, [torch.from_numpy(c).to(device) for c in coefs], gray,
            exif=exif)


def _read(path, device, gray: bool, part: Callable = _no_part):
    """The decoded file: a tensor on `device` for a JPEG, a numpy array
    for a PNG."""
    with open(path, "rb") as f:
        data = f.read()
    kind = _refuse_unported(path, data[:16])
    if kind == "jpeg":
        return decode_jpeg(data, device, gray, part)
    if kind != "png":
        raise DecodeError(f"{path}: neither a PNG nor a JPEG file")
    return decode_png(data, gray=gray)


def read_rgb(path) -> np.ndarray:
    img = _read(path, "cpu", False)
    return img.numpy() if isinstance(img, torch.Tensor) else img


def read_gray(path) -> np.ndarray:
    img = _read(path, "cpu", True)
    return img.numpy() if isinstance(img, torch.Tensor) else img


def read_rgb_tensor(path, device, part: Callable = _no_part
                    ) -> torch.Tensor:
    """(H, W, 3) uint8 RGB on `device`: a JPEG decoded there (the C entropy
    decoder and the card's pixel stage on a CUDA device), a PNG decoded on
    the host and uploaded inside part("png_upload")."""
    img = _read(path, device, False, part)
    if isinstance(img, np.ndarray):
        with part("png_upload"):
            img = torch.from_numpy(img).to(device)
    return img


def read_rgba_tensor(path, device) -> torch.Tensor:
    """(H, W, 4) uint8 on `device`, as PIL's
    Image.open(path).convert("RGBA") gives it: a PNG through
    decode_png_rgba, a JPEG through decode_jpeg without its EXIF
    orientation (PIL's open does not apply it) and with alpha 255."""
    with open(path, "rb") as f:
        data = f.read()
    kind = _refuse_unported(path, data[:16])
    if kind == "png":
        return torch.from_numpy(decode_png_rgba(data)).to(device)
    if kind != "jpeg":
        raise DecodeError(f"{path}: neither a PNG nor a JPEG file")
    rgb = decode_jpeg(data, device, exif=False)
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
    Pillow's Image.fromarray(img).save(path, quality=quality) writes:
    libjpeg-turbo's baseline 4:2:0 file (ops/jpeg.encode_coefficients on
    the tensor's device, the Huffman coding on the host)."""
    img = torch.as_tensor(img)
    h, w = img.shape[:2]
    blocks = jpeg_pixels.encode_coefficients(img, quality)
    data = jpeg_entropy.encode_scan([b.cpu().numpy() for b in blocks])
    return (jpeg.baseline_headers(w, h, jpeg_pixels.quality_tables(quality))
            + data + b"\xff\xd9")


def write_jpeg(path, img: torch.Tensor, quality: int = 95) -> None:
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)


def write_png(path, img: np.ndarray, filters: Optional[Sequence[int]] = None
              ) -> None:
    data = encode_png(img, filters or (2,))
    with open(path, "wb") as f:
        f.write(data)
