"""Connected components of numpy masks on the host, with cv2's stats
(utils/native.py in the JAX package), over csrc/maskops.c.

The C library is the JAX package's native/maskops.cpp in C (the same
two-pass union-find, so the same labels), built by ops/kernels/build.py
with the host compiler at first use into _build/ and loaded with ctypes. A
failed build or load raises: there is no cv2 or Python fallback (the JAX
module falls back to cv2). The card's path is ops/components.py; this is
the host runtime for tooling and a cross-check of it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from ..ops.kernels import build

SOURCE = "maskops.c"


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    i32 = ctypes.c_int32
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.maskops_label.argtypes = [u8p, i32, i32, i32, i32p, i32p, i32]
    lib.maskops_label.restype = i32
    lib.maskops_filter_area.argtypes = [u8p, i32, i32, i32, i32]
    lib.maskops_filter_area.restype = i32
    lib.maskops_keep_largest.argtypes = [u8p, i32, i32, i32, i32, i32]
    lib.maskops_keep_largest.restype = i32
    return lib


def _check(rc: int, what: str) -> int:
    if rc == -1:
        raise RuntimeError(f"{what}: too many components")
    if rc < 0:
        raise MemoryError(f"{what}: out of memory")
    return rc


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _lib() is not None


def connected_components_with_stats(mask: np.ndarray, connectivity: int = 8
                                    ) -> Tuple[int, np.ndarray, np.ndarray]:
    """cv2.connectedComponentsWithStats-compatible (num, labels, stats):
    labels int32 (H, W), 0 the background and components 1.. in raster
    order of their first pixel; stats (num, 5) int32 rows [LEFT, TOP,
    WIDTH, HEIGHT, AREA], row 0 the background's."""
    m = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    h, w = m.shape
    labels = np.zeros((h, w), np.int32)
    max_labels = h * w // 2 + 2
    stats = np.zeros((max_labels, 5), np.int32)
    num = _check(_lib().maskops_label(m, h, w, connectivity,
                                      labels.reshape(-1), stats.reshape(-1),
                                      max_labels), "maskops_label")
    return int(num), labels, stats[:num]


def filter_components_by_area(mask: np.ndarray, min_area: int,
                              connectivity: int = 8) -> np.ndarray:
    """Keep components with area > min_area; returns uint8 {0, 255}."""
    m = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8) * 255)
    _check(_lib().maskops_filter_area(m, m.shape[0], m.shape[1],
                                      connectivity, min_area),
           "maskops_filter_area")
    return m


def keep_largest_component(mask: np.ndarray, min_keep_area: int = 500,
                           fallback_min_area: int = 200,
                           connectivity: int = 8) -> np.ndarray:
    """The largest-component rule of the watermark chain: the largest
    component, or, where it is smaller than min_keep_area, every component
    larger than fallback_min_area; returns uint8 {0, 255}."""
    m = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8) * 255)
    _check(_lib().maskops_keep_largest(m, m.shape[0], m.shape[1],
                                       connectivity, min_keep_area,
                                       fallback_min_area),
           "maskops_keep_largest")
    return m
