"""The JPEG entropy decode on the host (csrc/jpeg_entropy.c), bound with
ctypes, and the route that picks it.

decode_scans(header, data, device) gives utils/jpeg.parse's scans as one
(bh, bw, 64) int16 coefficient array a component. For a CUDA device (the
card's route: the pixel stage then runs there) it calls the C decoder,
built with the host compiler at first use; a failed build raises. For the
CPU it runs the plain Python decoder, utils/jpeg.decode_scans, as the
kernel wrappers take their plain versions on CPU tensors.
`decode_scans_c.calls` counts the files the C decoder decoded.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List

import numpy as np
import torch

from ...utils import jpeg
from . import build

SOURCE = "jpeg_entropy.c"


class _Comp(ctypes.Structure):
    _fields_ = [("coef", ctypes.c_void_p), ("bw", ctypes.c_int32),
                ("h", ctypes.c_int32), ("v", ctypes.c_int32)]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    lib.uwt_jpeg_decode_scan.argtypes = [
        vp, i64, i64, ctypes.POINTER(_Comp), i32, vp, vp, i32, i32, i32, i32,
        i32, i32, i32, i32]
    lib.uwt_jpeg_decode_scan.restype = ctypes.c_int
    return lib


def decode_scans_c(header: jpeg.Header, data: bytes) -> List[np.ndarray]:
    """Every scan's coefficients through the C decoder (host)."""
    lib = _lib()
    coefs = [np.zeros((c.bh, c.bw, 64), np.int16) for c in header.components]
    buf = np.frombuffer(data, np.uint8)
    for scan in header.scans:
        n_mcu, _, across = jpeg.scan_blocks(header, scan)
        ns = len(scan.comps)
        comps = (_Comp * ns)()
        progressive = header.progressive
        need_dc = not progressive or (scan.ss == 0 and scan.ah == 0)
        need_ac = not progressive or scan.ss != 0
        keep = []  # the lookup arrays, alive for the call
        dc_ptrs = (ctypes.c_void_p * ns)()
        ac_ptrs = (ctypes.c_void_p * ns)()
        for i, ci in enumerate(scan.comps):
            comp = header.components[ci]
            comps[i] = _Comp(coefs[ci].ctypes.data, comp.bw, comp.h, comp.v)
            if need_dc:
                keep.append(jpeg.huffman_lookup(jpeg.scan_table(scan, i, True),
                                                True))
                dc_ptrs[i] = keep[-1].ctypes.data
            if need_ac:
                keep.append(jpeg.huffman_lookup(
                    jpeg.scan_table(scan, i, False), False))
                ac_ptrs[i] = keep[-1].ctypes.data
        rc = lib.uwt_jpeg_decode_scan(
            buf.ctypes.data, scan.start, scan.end, comps, ns, dc_ptrs,
            ac_ptrs, n_mcu, across, scan.ss, scan.se, scan.ah, scan.al,
            int(progressive), scan.restart)
        if rc < -1:
            raise RuntimeError(f"uwt_jpeg_decode_scan: bad arguments ({rc})")
        scan.cut = rc
    decode_scans_c.calls += 1
    return coefs


decode_scans_c.calls = 0


def decode_scans(header: jpeg.Header, data: bytes, device) -> List[np.ndarray]:
    """The C decoder for a CUDA device, the plain Python one for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return decode_scans_c(header, data)
    if device.type != "cpu":
        raise ValueError(f"decode_scans: unsupported device {device}")
    return jpeg.decode_scans(header, data)
