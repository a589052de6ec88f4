"""The Zstandard decoder (csrc/zstd_decode.c), bound with ctypes.

Host code in C on every device (there is no plain version), built with the
host compiler at first use; a failed build raises. decompress(data) gives
the concatenated content of every frame in `data` as bytes;
decompress_into(data, out) writes it straight into a numpy array of the
exact size (a zarr chunk), without a copy. A corrupt, truncated or
checksum-failing frame raises ZstdError. crc32c(data) is the checksum
that closes OCDBT's files (training/ocdbt.py), in the same C library.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from . import build

SOURCE = "zstd_decode.c"
_ERRORS = {-1: "truncated frame", -2: "not a zstd frame (bad magic)",
           -3: "corrupt frame", -4: "output larger than expected",
           -5: "content checksum mismatch",
           -6: "frame needs a dictionary (not supported)",
           -7: "output size differs from the frame's content size",
           -8: "out of memory"}
_MAX_OUT = 1 << 36  # the growth limit for frames that declare no size


class ZstdError(ValueError):
    """The input is not a well-formed zstd stream."""


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.uwt_zstd_decompress.argtypes = [vp, i64, vp, i64]
    lib.uwt_zstd_decompress.restype = i64
    lib.uwt_zstd_content_size.argtypes = [vp, i64]
    lib.uwt_zstd_content_size.restype = i64
    lib.uwt_crc32c.argtypes = [vp, i64]
    lib.uwt_crc32c.restype = ctypes.c_uint32
    return lib


def _src(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if len(data) else np.zeros(1,
                                                                     np.uint8)


def content_size(data) -> Optional[int]:
    """The total content size the frames declare, None where one does not
    declare it."""
    src = _src(data)
    rc = _lib().uwt_zstd_content_size(src.ctypes.data, len(data))
    if rc == -2:
        return None
    if rc < 0:
        raise ZstdError(_ERRORS.get(rc, f"error {rc}"))
    return rc


def _run(src: np.ndarray, n: int, out: np.ndarray) -> int:
    rc = _lib().uwt_zstd_decompress(src.ctypes.data, n, out.ctypes.data,
                                    out.nbytes)
    return rc


def decompress_into(data, out: np.ndarray) -> None:
    """Decode `data` into the C-contiguous array `out`, which must take the
    content exactly."""
    if not out.flags.c_contiguous:
        raise ValueError("decompress_into needs a C-contiguous array")
    src = _src(data)
    view = out.reshape(-1).view(np.uint8)
    rc = _run(src, len(data), view)
    if rc < 0:
        raise ZstdError(_ERRORS.get(rc, f"error {rc}"))
    if rc != out.nbytes:
        raise ZstdError(f"content is {rc} bytes, expected {out.nbytes}")


def decompress(data) -> bytes:
    """Every frame of `data`, decoded and concatenated."""
    src = _src(data)
    size = content_size(data)
    cap = size if size is not None else max(4 * len(data), 1 << 16)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        rc = _run(src, len(data), out)
        if rc == -4 and size is None and cap < _MAX_OUT:
            cap *= 4
            continue
        if rc < 0:
            raise ZstdError(_ERRORS.get(rc, f"error {rc}"))
        return out[:rc].tobytes()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of `data`, as OCDBT's files end with it."""
    src = _src(data)
    return int(_lib().uwt_crc32c(src.ctypes.data, len(data)))
