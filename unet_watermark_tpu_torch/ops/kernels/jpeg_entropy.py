"""The JPEG entropy decode on the host (csrc/jpeg_entropy.c), bound with
ctypes, and the route that picks it.

decode_scans(header, data, device) gives utils/jpeg.parse's scans as one
(bh, bw, 64) int16 coefficient array a component. For a CUDA device (the
card's route: the pixel stage then runs there) it calls the C decoder,
built with the host compiler at first use; a failed build raises. For the
CPU it runs the plain Python decoder, utils/jpeg.decode_scans, as the
kernel wrappers take their plain versions on CPU tensors.
`decode_scans_c.calls` counts the files the C decoder decoded.
encode_scan(blocks) is the encoder's Huffman stage, in C on every device
(host code, there is no plain version): the quantized blocks of
ops/jpeg.encode_coefficients in MCU order through the standard tables.
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
    lib.uwt_jpeg_encode_scan.argtypes = [vp, i64, vp, i32, vp, vp, vp, i64]
    lib.uwt_jpeg_encode_scan.restype = ctypes.c_int64
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


@functools.lru_cache(maxsize=1)
def _std_codes():
    """(codes, lens) uint32/int32 (2, 512): table sets 0 (luma) and 1
    (chroma), 256 DC codes then 256 AC codes each."""
    codes = np.zeros((2, 512), np.uint32)
    lens = np.zeros((2, 512), np.int32)
    for t, (dc, ac) in enumerate(((jpeg.STD_DC_LUMA, jpeg.STD_AC_LUMA),
                                  (jpeg.STD_DC_CHROMA, jpeg.STD_AC_CHROMA))):
        for half, table in ((0, dc), (256, ac)):
            c, n = jpeg.huffman_codes(table)
            codes[t, half:half + 256] = c
            lens[t, half:half + 256] = n
    return codes, lens


def encode_scan(blocks: List[np.ndarray]) -> bytes:
    """The entropy-coded data of a baseline 4:2:0 scan: blocks are Y
    (2m, 2n, 64), Cb and Cr (m, n, 64) int16 in zigzag order; each MCU
    takes its four Y blocks row by row, then Cb, then Cr. One (bh, bw, 64)
    array alone is a gray file's scan: its blocks in raster order on the
    luma tables."""
    codes, lens = _std_codes()
    if len(blocks) == 1:
        order = np.ascontiguousarray(
            np.asarray(blocks[0], np.int16).reshape(-1, 64))
        comp = np.zeros(order.shape[0], np.int32)
        return _encode(order, comp, 1, codes[:1].copy(), lens[:1].copy())
    y, cb, cr = (np.asarray(b, np.int16) for b in blocks)
    m, n = cb.shape[:2]
    yq = y.reshape(m, 2, n, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        m, n, 4, 64)
    order = np.ascontiguousarray(np.concatenate(
        [yq, cb[:, :, None], cr[:, :, None]], axis=2).reshape(-1, 64))
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.int32), m * n)
    # three DC predictors; Cr shares the chroma tables
    codes3 = np.ascontiguousarray(codes[[0, 1, 1]])
    lens3 = np.ascontiguousarray(lens[[0, 1, 1]])
    return _encode(order, comp, 3, codes3, lens3)


def _encode(order: np.ndarray, comp: np.ndarray, ncomp: int,
            codes: np.ndarray, lens: np.ndarray) -> bytes:
    """uwt_jpeg_encode_scan over the blocks in coding order; codes and lens
    hold each component's (DC, AC) tables."""
    cap = order.size * 8 + 1024  # 2 bytes a coefficient and stuffing
    out = np.empty(cap, np.uint8)
    size = _lib().uwt_jpeg_encode_scan(
        order.ctypes.data, order.shape[0], comp.ctypes.data, ncomp,
        codes.ctypes.data, lens.ctypes.data, out.ctypes.data, cap)
    if size < 0:
        raise RuntimeError(f"uwt_jpeg_encode_scan failed ({size})")
    encode_scan.calls += 1
    return out[:size].tobytes()


encode_scan.calls = 0
