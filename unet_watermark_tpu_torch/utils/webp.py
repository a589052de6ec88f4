"""WEBP files as cv2.imread and PIL's Image.open read them: the RIFF
container here, the streams in C (ops/kernels/webp.py:
csrc/webp_decode.c), the pixel stage on the image's device (ops/webp.py).

parse(data) walks the container as libwebp 1.x's WebPDecode does:

  RIFF      "RIFF", its size (at least 12, and not past the file's end:
            a cut file is unreadable), "WEBP"
  simple    a "VP8 " or "VP8L" chunk right after the header
  VP8X      a 10-byte chunk (flags, canvas size), then chunks skipped up to
            the first VP8 or VP8L chunk (none may pass the RIFF size); the
            last ALPH among them is the alpha of a VP8 frame; the canvas
            must be the frame's size. EXIF (where VP8X's EXIF flag is
            set): the first EXIF chunk's orientation (the chunk follows
            the image's), read as cv2 reads
            it (the TIFF header at the chunk's first byte), is applied by
            cv2.imread, not by PIL.
            ICCP and XMP are skipped. An animated file (the animation flag,
            or an ANIM or ANMF chunk) raises NotImplementedError
            (ROADMAP.md §A.5)
  streams   a stream reads from its chunk's payload to the end of the file,
            as libwebp's does; a VP8 frame must be a shown key frame whose
            first partition ends inside its chunk

cv2 drops the alpha (IMREAD_COLOR) or converts BGRA to gray; colours are
never premultiplied, so the ALPH chunk changes no colour. has_alpha is
what PIL's RGBA keeps: the VP8X alpha flag for a VP8 frame (an ALPH chunk
without it reads as opaque), the VP8L header's hint for a VP8L image; 255
where it is not set.

A file libwebp refuses (cv2 gives None) raises WEBPError.
"""
from __future__ import annotations

import contextlib
import struct
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops import webp as webp_pixels
from ..ops.imgproc import gray_u8
from ..ops.jpeg import orient
from ..ops.kernels import webp as webp_c
from .decode_error import DecodeError
from .jpeg import exif_orientation

ALPHA_FLAG, EXIF_FLAG, ANIMATION_FLAG = 0x10, 0x08, 0x02
MAX_CHUNK = 0xFFFFFFFF - 8 - 1  # libwebp's MAX_CHUNK_PAYLOAD


class WEBPError(DecodeError):
    """cv2.imread gives None for the file."""


@dataclass
class Info:
    width: int
    height: int
    lossless: bool
    stream: bytes            # the VP8 or VP8L payload to the file's end
    alpha: Optional[bytes]   # the ALPH payload (VP8 only)
    has_alpha: bool
    orientation: int = 1


def _u32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def is_webp(head: bytes) -> bool:
    return head[:4] == b"RIFF" and head[8:12] == b"WEBP"


def _refuse_animation() -> None:
    raise NotImplementedError(
        "an animated WEBP file: the port decodes still WEBP images only "
        "(ROADMAP.md §A.5, other image formats)")


def parse(data: bytes) -> Info:
    """The container as libwebp reads it; raises WEBPError where it
    refuses the file."""
    n = len(data)
    if n < 12 or not is_webp(data):
        raise WEBPError("not a RIFF WEBP file")
    riff = _u32(data, 4)
    if riff < 12 or riff > MAX_CHUNK:
        raise WEBPError("bad RIFF size")
    if riff > n - 8:
        raise WEBPError("WEBP file cut off")
    pos, alpha, orientation = 12, None, 1
    has_alpha = vp8x = False
    flags = 0
    if n - pos < 8:
        raise WEBPError("WEBP file cut off")
    if data[pos:pos + 4] == b"VP8X":
        if _u32(data, pos + 4) != 10:
            raise WEBPError("bad VP8X chunk")
        if n - pos < 18:
            raise WEBPError("WEBP file cut off")
        flags = _u32(data, pos + 8)
        cw = 1 + int.from_bytes(data[pos + 12:pos + 15], "little")
        ch = 1 + int.from_bytes(data[pos + 15:pos + 18], "little")
        if cw * ch >= 1 << 32:
            raise WEBPError("canvas too large")
        if flags & ANIMATION_FLAG:
            _refuse_animation()
        has_alpha, vp8x = bool(flags & ALPHA_FLAG), True
        pos += 18
        total = 22
        while True:
            if n - pos < 8:
                raise WEBPError("WEBP file cut off")
            tag, size = data[pos:pos + 4], _u32(data, pos + 4)
            if size > MAX_CHUNK:
                raise WEBPError("bad chunk size")
            disk = (8 + size + 1) & ~1
            total += disk
            if total > riff:
                raise WEBPError("a chunk passes the RIFF size")
            if tag in (b"VP8 ", b"VP8L"):
                break
            if n - pos < disk:
                raise WEBPError("WEBP file cut off")
            if tag in (b"ANIM", b"ANMF"):
                _refuse_animation()
            if tag == b"ALPH":
                alpha = data[pos + 8:pos + 8 + size]
            pos += disk
    tag = data[pos:pos + 4]
    if tag not in (b"VP8 ", b"VP8L"):
        raise WEBPError(f"no VP8 or VP8L chunk ({tag!r})")
    size = _u32(data, pos + 4)
    if riff >= 12 and size > riff - 12:
        raise WEBPError("VP8 chunk larger than the file")
    if size > n - pos - 8:
        raise WEBPError("WEBP file cut off")
    stream = data[pos + 8:]
    lossless = tag == b"VP8L"
    if lossless:
        if len(stream) < 5 or stream[0] != 0x2F or stream[4] >> 5:
            raise WEBPError("bad VP8L header")
        bits = int.from_bytes(stream[1:5], "little")
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
        has_alpha = bool((bits >> 28) & 1)
        alpha = None
    else:
        if len(stream) < 10 or stream[3:6] != b"\x9d\x01\x2a":
            raise WEBPError("bad VP8 frame header")
        tag3 = stream[0] | stream[1] << 8 | stream[2] << 16
        w = (stream[6] | stream[7] << 8) & 0x3FFF
        h = (stream[8] | stream[9] << 8) & 0x3FFF
        if tag3 & 1 or (tag3 >> 1) & 7 > 3 or not (tag3 >> 4) & 1 or \
                tag3 >> 5 >= size or not w or not h:
            raise WEBPError("not a shown VP8 key frame")
    if vp8x and (w, h) != (cw, ch):
        raise WEBPError("the canvas is not the frame's size")
    if flags & EXIF_FLAG:
        orientation = _exif_orientation(data, riff)
    return Info(w, h, lossless, stream, alpha, has_alpha,
                orientation if orientation in range(1, 9) else 1)


def _exif_orientation(data: bytes, riff: int) -> int:
    """The orientation in the first EXIF chunk of an extended file (it
    follows the image's chunk), read as cv2 reads it: the TIFF header at
    the chunk's first byte. 1 where there is none."""
    pos, end = 30, min(len(data), riff + 8)  # past RIFF, WEBP and VP8X
    while pos + 8 <= end:
        tag, size = data[pos:pos + 4], _u32(data, pos + 4)
        if pos + 8 + size > end:
            break
        if tag == b"EXIF":
            return exif_orientation(bytes(6) + data[pos + 8:pos + 8 + size])
        pos += (8 + size + 1) & ~1
    return 1


def oriented_size(info: Info):
    """(height, width) as cv2.imread returns the image."""
    if info.orientation in (5, 6, 7, 8):
        return info.width, info.height
    return info.height, info.width


def _no_part(name: str):
    return contextlib.nullcontext()


def decode(data: bytes, device="cuda", gray: bool = False,
           part: Callable = _no_part, exif: bool = True,
           rgba: bool = False) -> torch.Tensor:
    """WEBP bytes → (H, W, 3) RGB or (H, W) gray uint8 on `device` as
    cv2.imread gives them (exif=False, rgba=True: (H, W, 4) as PIL's
    Image.open(p).convert("RGBA") gives it). part(name) wraps the stages
    "webp_entropy" (the C decoder on the host) and "webp_pixels" (upload
    and pixel stage on the device)."""
    device = torch.device(device)
    info = parse(data)
    w, h = info.width, info.height
    try:
        with part("webp_entropy"):
            if info.lossless:
                bgra = webp_c.vp8l_argb(info.stream, w, h)
            else:
                planes = webp_c.vp8_planes(info.stream, w, h)
                a = (webp_c.alpha_plane(info.alpha, w, h)
                     if info.alpha is not None else None)
    except webp_c.WEBPStreamError as e:
        raise WEBPError(str(e)) from None
    with part("webp_pixels"):
        if info.lossless:
            t = torch.from_numpy(bgra).to(device)
            rgb, a = t[..., :3].flip(2), t[..., 3]
        else:
            y, u, v = (torch.from_numpy(p).to(device) for p in planes)
            rgb = webp_pixels.yuv_to_rgb(y, u, v)
            a = torch.from_numpy(a).to(device) if a is not None else None
        if rgba:  # PIL keeps the alpha where libwebp reports one
            if a is None or not info.has_alpha:
                a = torch.full_like(rgb[..., 0], 255)
            return torch.cat([rgb, a[..., None]], dim=2).contiguous()
        out = gray_u8(rgb) if gray else rgb
        return (orient(out, info.orientation) if exif else out).contiguous()
