"""TIFF's LZW and PackBits codecs (csrc/tiff_codecs.c), bound with ctypes.

Host code in C on every device (there is no plain version), built with the
host compiler at first use; a failed build raises. lzw_decode(data, size)
and packbits_decode(data, size) give up to `size` bytes of a strip (fewer
where the strip ends early: the caller checks); lzw_encode and
packbits_encode are utils/synthetic.py's writers. A corrupt LZW code
raises TIFFStreamError.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import build

SOURCE = "tiff_codecs.c"


class TIFFStreamError(ValueError):
    """A strip libtiff would refuse."""


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in ("uwt_lzw_decode", "uwt_lzw_encode", "uwt_packbits_decode"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i64, vp, i64]
        fn.restype = i64
    lib.uwt_packbits_encode.argtypes = [vp, i64, i64, vp, i64]
    lib.uwt_packbits_encode.restype = i64
    return lib


def _src(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if len(data) else np.zeros(1,
                                                                     np.uint8)


def _run(name: str, data, size: int) -> np.ndarray:
    src, out = _src(data), np.empty(max(size, 1), np.uint8)
    rc = getattr(_lib(), name)(src.ctypes.data, len(data), out.ctypes.data,
                               size)
    if rc < 0:
        raise TIFFStreamError(f"{name[4:]}: corrupt strip (error {rc})")
    return out[:rc]


def lzw_decode(data, size: int) -> np.ndarray:
    return _run("uwt_lzw_decode", data, size)


def packbits_decode(data, size: int) -> np.ndarray:
    return _run("uwt_packbits_decode", data, size)


def lzw_encode(data) -> bytes:
    n = len(data)
    cap = 3 * n // 2 + 16
    out = _run("uwt_lzw_encode", data, cap)
    return out.tobytes()


def packbits_encode(data, row: int) -> bytes:
    """PackBits of each `row` bytes on their own."""
    src = _src(data)
    cap = len(data) + len(data) // max(row, 1) * 2 + len(data) // 128 + 16
    out = np.empty(cap, np.uint8)
    rc = _lib().uwt_packbits_encode(src.ctypes.data, len(data), row,
                                    out.ctypes.data, cap)
    if rc < 0:
        raise TIFFStreamError(f"packbits_encode: error {rc}")
    return out[:rc].tobytes()
