"""The mask stage's two kernels (ops/pallas/morph_chain.py in the JAX
package), as hand-written CUDA kernels (csrc/morph_chain.cu).

  K1 morph_chain_watermark      open(3) → close(7)x3 → close(11)x2 →
                                dilate(9)x2 with cv2 elliptical elements
  K2 gaussian_smooth_threshold  threshold, 3x3 Gaussian (sigma 0.5) with zero
                                beyond the image, threshold

Each wrapper takes (N, S, S) float32 contiguous masks. On a CUDA tensor it
launches its kernel on the current stream (or raises); on a CPU tensor it
runs its plain PyTorch version, which chip_smoke.py also holds the kernel
against on the card. `<wrapper>.launches` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import morphology as m
from . import build

SOURCE = "morph_chain.cu"
_GAUSS = [float(g) for g in m.gaussian_kernel_1d(3, 0.5)]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uwt_morph_chain.argtypes = [vp, vp, ci, ci, vp]
    lib.uwt_morph_chain.restype = ci
    lib.uwt_smooth_threshold.argtypes = [vp, vp, ci, ci, cf, cf, cf, vp]
    lib.uwt_smooth_threshold.restype = ci
    lib.uwt_error_string.argtypes = [ci]
    lib.uwt_error_string.restype = ctypes.c_char_p
    return lib


def _check(masks: torch.Tensor, name: str) -> None:
    if masks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {masks.device}")
    if masks.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {masks.dtype}")
    if masks.ndim != 3 or masks.shape[1] != masks.shape[2]:
        raise ValueError(f"{name}: expected (N, S, S), got "
                         f"{tuple(masks.shape)}")
    if not masks.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().uwt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def morph_chain_plain(masks: torch.Tensor) -> torch.Tensor:
    """K1's plain version: maskproc.optimize_watermark_mask's morphology
    with the whole-image ops (the kernel's chain is kChain in the source)."""
    x = (masks > 0.5).float()
    x = m.morph_open(x, m.ellipse_kernel(3, 3), 1)
    x = m.morph_close(x, m.ellipse_kernel(7, 7), 3)
    x = m.morph_close(x, m.ellipse_kernel(11, 11), 2)
    return m.dilate(x, m.ellipse_kernel(9, 9), 2)


def morph_chain_watermark(masks: torch.Tensor) -> torch.Tensor:
    """K1. (N, S, S) masks → the watermark chain's output before the
    component stage."""
    _check(masks, "morph_chain_watermark")
    if masks.device.type == "cpu":
        return morph_chain_plain(masks)
    n, s, _ = masks.shape
    out = torch.empty_like(masks)
    if n == 0:
        return out
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().uwt_morph_chain(masks.data_ptr(), out.data_ptr(), n, s,
                                    stream)
    _raise_on(rc, "morph_chain_watermark")
    morph_chain_watermark.launches += 1
    return out


def smooth_threshold_plain(masks: torch.Tensor) -> torch.Tensor:
    """K2's plain version, in the kernel's order of fp32 operations."""
    g0, g1, g2 = _GAUSS
    x = F.pad((masks > 0.5).float(), (1, 1, 1, 1))
    gy = g0 * x[:, :-2, :] + g1 * x[:, 1:-1, :] + g2 * x[:, 2:, :]
    gx = g0 * gy[:, :, :-2] + g1 * gy[:, :, 1:-1] + g2 * gy[:, :, 2:]
    return (gx > 0.5).float()


def gaussian_smooth_threshold(masks: torch.Tensor) -> torch.Tensor:
    """K2. (N, S, S) masks → GaussianBlur(3x3, 0.5) with zero border,
    thresholded at 0.5."""
    _check(masks, "gaussian_smooth_threshold")
    if masks.device.type == "cpu":
        return smooth_threshold_plain(masks)
    n, s, _ = masks.shape
    out = torch.empty_like(masks)
    if n == 0:
        return out
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().uwt_smooth_threshold(masks.data_ptr(), out.data_ptr(),
                                         n, s, *_GAUSS, stream)
    _raise_on(rc, "gaussian_smooth_threshold")
    gaussian_smooth_threshold.launches += 1
    return out


morph_chain_watermark.launches = 0
gaussian_smooth_threshold.launches = 0
KERNELS = (morph_chain_watermark, gaussian_smooth_threshold)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
