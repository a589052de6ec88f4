"""The WEBP decoders (csrc/webp_decode.c), bound with ctypes.

Host code in C on every device (there is no plain version: a VP8
macroblock's prediction reads its reconstructed neighbours, a VP8L pixel
its decoded predecessors), built with the host compiler at first use; a
failed build raises. vp8_planes(chunk, w, h) gives a VP8 key frame's Y, U
and V planes (ops/webp.py turns them into RGB on the image's device),
vp8l_argb(chunk, w, h) a VP8L image's ARGB as (h, w, 4) uint8 in B, G, R,
A byte order, alpha_plane(chunk, w, h) an ALPH chunk's alpha. A malformed
or truncated stream raises WEBPStreamError.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from . import build

SOURCE = "webp_decode.c"
_ERRORS = {-1: "the data end before the image does",
           -2: "corrupt stream", -3: "not a shown key frame",
           -4: "out of memory",
           -5: "the stream's size differs from the container's"}


class WEBPStreamError(ValueError):
    """A VP8, VP8L or ALPH stream libwebp would refuse."""


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ("uwt_vp8_decode", "uwt_vp8l_decode", "uwt_webp_alpha"):
        fn = getattr(lib, name)
        fn.argtypes = ([vp, i64, i32, i32, vp, vp, vp]
                       if name == "uwt_vp8_decode" else [vp, i64, i32, i32,
                                                         vp])
        fn.restype = i32
    lib.uwt_vp8_encode.argtypes = [vp, vp, vp, vp, i64]
    lib.uwt_vp8_encode.restype = i64
    lib.uwt_pack_bits_lsb.argtypes = [vp, vp, i64, vp, i64]
    lib.uwt_pack_bits_lsb.restype = i64
    return lib


def _src(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if len(data) else np.zeros(1,
                                                                     np.uint8)


def _check(rc: int, what: str) -> None:
    if rc < 0:
        raise WEBPStreamError(f"{what}: {_ERRORS.get(rc, f'error {rc}')}")


def vp8_planes(chunk, w: int, h: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Y (h, w), U, V ((h + 1) // 2, (w + 1) // 2)) uint8 of a VP8 chunk's
    payload."""
    src = _src(chunk)
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    _check(_lib().uwt_vp8_decode(src.ctypes.data, len(chunk), w, h,
                                 y.ctypes.data, u.ctypes.data,
                                 v.ctypes.data), "VP8")
    return y, u, v


def vp8l_argb(chunk, w: int, h: int) -> np.ndarray:
    """(h, w, 4) uint8, B G R A, of a VP8L chunk's payload."""
    src = _src(chunk)
    out = np.empty((h, w), np.uint32)
    _check(_lib().uwt_vp8l_decode(src.ctypes.data, len(chunk), w, h,
                                  out.ctypes.data), "VP8L")
    return out.view(np.uint8).reshape(h, w, 4)


def alpha_plane(chunk, w: int, h: int) -> np.ndarray:
    """(h, w) uint8 alpha of an ALPH chunk's payload."""
    src = _src(chunk)
    out = np.empty((h, w), np.uint8)
    _check(_lib().uwt_webp_alpha(src.ctypes.data, len(chunk), w, h,
                                 out.ctypes.data), "ALPH")
    return out


# the writer's header fields, in uwt_vp8_encode's order
VP8_HEADER = ("w", "h", "log2parts", "use_segment", "update_map",
              "absolute_delta", "seg_q0", "seg_q1", "seg_q2", "seg_q3",
              "seg_lf0", "seg_lf1", "seg_lf2", "seg_lf3", "seg_p0", "seg_p1",
              "seg_p2", "simple", "level", "sharpness", "use_lf_delta",
              "ref_lf0", "ref_lf1", "ref_lf2", "ref_lf3", "mode_lf0",
              "mode_lf1", "mode_lf2", "mode_lf3", "base_q", "dq_y1_dc",
              "dq_y2_dc", "dq_y2_ac", "dq_uv_dc", "dq_uv_ac", "use_skip",
              "skip_p")


def vp8_encode(header: dict, mbs: np.ndarray, levels: np.ndarray) -> bytes:
    """A VP8 key frame (utils/synthetic.vp8_bytes's coder): `header` maps
    VP8_HEADER's names to ints (missing ones 0), `mbs` is (n_mb, 21)
    uint8 (segment, skip, is_i4x4, 16x16 mode, chroma mode, 16 4x4
    modes), `levels` (n_mb, 25, 16) int16 in zigzag order (16 Y blocks,
    4 U, 4 V, Y2)."""
    hdr = np.array([int(header.get(k, 0)) for k in VP8_HEADER], np.int32)
    mbs = np.ascontiguousarray(mbs, np.uint8)
    levels = np.ascontiguousarray(levels, np.int16)
    cap = levels.size * 4 + mbs.size * 4 + 4096
    out = np.empty(cap, np.uint8)
    rc = _lib().uwt_vp8_encode(hdr.ctypes.data, mbs.ctypes.data,
                               levels.ctypes.data, out.ctypes.data, cap)
    _check(rc, "VP8 writer")
    return out[:rc].tobytes()


def pack_bits_lsb(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """(code, length) pairs packed least significant bit first."""
    codes = np.ascontiguousarray(codes, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.uint8)
    cap = int(lengths.astype(np.int64).sum()) // 8 + 8
    out = np.empty(cap, np.uint8)
    rc = _lib().uwt_pack_bits_lsb(codes.ctypes.data, lengths.ctypes.data,
                                  codes.size, out.ctypes.data, cap)
    _check(rc, "bit packer")
    return out[:rc].tobytes()
