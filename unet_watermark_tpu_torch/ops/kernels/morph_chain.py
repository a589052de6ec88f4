"""The mask stage's two kernels (ops/pallas/morph_chain.py in the JAX
package), as hand-written CUDA kernels (csrc/morph_chain.cu).

  K1 morph_chain_watermark      open(3) → close(7)x3 → close(11)x2 →
                                dilate(9)x2 with cv2 elliptical elements
  K2 gaussian_smooth_threshold  threshold, 3x3 Gaussian (sigma 0.5) with zero
                                beyond the image, threshold

Each wrapper takes (N, S, S) float32 contiguous masks (K1: S up to
K1_MAX_SIZE). On a CUDA tensor it launches its kernel on the tensor's
device's current stream (or raises); on a CPU tensor it runs its plain
PyTorch version, which chip_smoke.py also holds the kernel against on the
card. `<wrapper>.launches` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import morphology as m
from . import build

SOURCE = "morph_chain.cu"
K1_MAX_SIZE = 4096  # kMaxSize in the source: two band buffers fit a block
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
    if not (masks.is_cuda or masks.is_cpu):
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


def _launch(fn, masks: torch.Tensor, out: torch.Tensor, *args) -> int:
    """fn(in, out, *args, stream) on the current stream of masks' device,
    which is made the current device only for the call if it is not. The
    raw stream handle and device index come from torch._C, as PyTorch's
    own generated kernels take them: a Stream object costs more host time
    than the kernels it would launch."""
    dev = masks.get_device()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return _launch(fn, masks, out, *args)
    return fn(masks.data_ptr(), out.data_ptr(), *args,
              torch._C._cuda_getCurrentRawStream(dev))


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
    if masks.is_cpu:
        return morph_chain_plain(masks)
    n, s, _ = masks.shape
    if s > K1_MAX_SIZE:
        raise ValueError(f"morph_chain_watermark: S = {s} exceeds the "
                         f"kernel's limit of {K1_MAX_SIZE}")
    out = torch.empty_like(masks)
    if n == 0:
        return out
    rc = _launch(_lib().uwt_morph_chain, masks, out, n, s)
    _raise_on(rc, "morph_chain_watermark")
    morph_chain_watermark.launches += 1
    return out


def smooth_threshold_plain(masks: torch.Tensor) -> torch.Tensor:
    """K2's plain version, in the kernel's order of fp32 operations.

    Its output equals (masks > 0.5).float() for every float input: on the
    thresholded field the centre weight 0.787² = 0.619 exceeds 0.5 and the
    other eight sum to 0.381 (tests/test_torch_morph.py,
    test_k2_is_the_threshold_on_all_3x3_patterns and
    test_k2_is_the_threshold_on_special_floats)."""
    g0, g1, g2 = _GAUSS
    x = F.pad((masks > 0.5).float(), (1, 1, 1, 1))
    gy = g0 * x[:, :-2, :] + g1 * x[:, 1:-1, :] + g2 * x[:, 2:, :]
    gx = g0 * gy[:, :, :-2] + g1 * gy[:, :, 1:-1] + g2 * gy[:, :, 2:]
    return (gx > 0.5).float()


def gaussian_smooth_threshold(masks: torch.Tensor) -> torch.Tensor:
    """K2. (N, S, S) masks → GaussianBlur(3x3, 0.5) with zero border,
    thresholded at 0.5."""
    _check(masks, "gaussian_smooth_threshold")
    if masks.is_cpu:
        return smooth_threshold_plain(masks)
    n, s, _ = masks.shape
    out = torch.empty_like(masks)
    if n == 0:
        return out
    rc = _launch(_lib().uwt_smooth_threshold, masks, out, n, s, *_GAUSS)
    _raise_on(rc, "gaussian_smooth_threshold")
    gaussian_smooth_threshold.launches += 1
    return out


morph_chain_watermark.launches = 0
gaussian_smooth_threshold.launches = 0
KERNELS = (morph_chain_watermark, gaussian_smooth_threshold)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
