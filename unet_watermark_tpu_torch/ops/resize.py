"""cv2.resize on tensors, on whichever device they lie: the three calls the
JAX package's predictor makes (inference/predict.py), reproduced to the
bit.

  resize_linear_u8   cv2.resize(rgb_u8, (w, h)), INTER_LINEAR on uint8.
                     cv2 rounds its coefficients to 11 bits (2048 = 1.0),
                     sums each row's two taps in integers, then combines
                     two rows as its vector code does:
                     (((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2)
                     >> 2. A float interpolation is off by one on a share
                     of the pixels; this is exact
                     (tests/test_torch_image_io.py).
  resize_linear_f32  cv2.resize(f32, (w, h)), INTER_LINEAR on float32: each
                     pass is a + (b - a) * t with one rounding (an FMA),
                     t the float32 of the double tap offset.
  resize_nearest     cv2.resize(x, (w, h), INTER_NEAREST), any dtype:
                     source index floor(dst * (src / dst)), clamped.

Sizes are (height, width), unlike cv2's dsize. The tap tables are computed
on the host in float64, as cv2 computes them, and cached per size pair.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _linear_taps(src: int, dst: int, by_division: bool, clamp: bool):
    """(i0, i1, frac) for each destination index: the two source taps and
    the offset between them (float64). cv2's scale is 1 / (dst / src) in
    its uint8 path and src / dst in its float path; `clamp` zeroes the
    offset where the left tap leaves the image, as cv2 does along x (its
    uint8 path keeps the offset along y and clamps only the row index)."""
    scale = src / dst if by_division else 1.0 / (dst / src)
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    if not by_division:  # the uint8 path rounds the position to float32
        pos = pos.astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0.astype(pos.dtype)).astype(np.float64)
    if clamp:
        frac[(i0 < 0) | (i0 >= src - 1)] = 0.0
        i0 = np.clip(i0, 0, src - 1)
    return (np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), frac)


def _fixed(frac: np.ndarray):
    """cv2's 11-bit coefficients: round-half-even of float32 (1 - t) and t
    times 2048."""
    t = frac.astype(np.float32)
    c0 = np.rint((np.float32(1) - t) * np.float32(2048)).astype(np.int32)
    c1 = np.rint(t * np.float32(2048)).astype(np.int32)
    return c0, c1


def _on(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _check_size(size: Tuple[int, int]) -> Tuple[int, int]:
    oh, ow = (int(v) for v in size)
    if oh < 1 or ow < 1:
        raise ValueError(f"resize to {size}")
    return oh, ow


def resize_linear_u8(img: torch.Tensor, size: Tuple[int, int]
                     ) -> torch.Tensor:
    """(..., H, W, C) uint8 → (..., oh, ow, C) uint8, cv2 INTER_LINEAR."""
    if img.dtype != torch.uint8 or img.ndim < 3:
        raise TypeError(f"expected (..., H, W, C) uint8, got "
                        f"{tuple(img.shape)} {img.dtype}")
    oh, ow = _check_size(size)
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (oh, ow):
        return img.clone()
    x0, x1, fx = _linear_taps(w, ow, False, True)
    y0, y1, fy = _linear_taps(h, oh, False, False)
    a0, a1 = _fixed(fx)
    b0, b1 = _fixed(fy)
    dev = img.device
    x0, x1, a0, a1, y0, y1 = _on(dev, x0, x1, a0[:, None], a1[:, None],
                                 y0, y1)
    b0, b1 = _on(dev, b0[:, None, None], b1[:, None, None])

    def row_taps(rows):  # the horizontal pass, exact in int32
        r = img.index_select(-3, rows).to(torch.int32)
        return r.index_select(-2, x0) * a0 + r.index_select(-2, x1) * a1

    d0, d1 = row_taps(y0), row_taps(y1)
    out = (((d0 >> 4) * b0 >> 16) + ((d1 >> 4) * b1 >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


def _lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a + (b - a) * t rounded once to float32, as an FMA: the product of
    two float32 values is exact in float64."""
    return (a.double() + (b - a).double() * t).float()


def resize_linear_f32(x: torch.Tensor, size: Tuple[int, int]
                      ) -> torch.Tensor:
    """(..., H, W) float32 → (..., oh, ow) float32, cv2 INTER_LINEAR (exact
    for sources at least 2 x 2; cv2 takes another path for a source one
    pixel wide or tall)."""
    if x.dtype != torch.float32 or x.ndim < 2:
        raise TypeError(f"expected (..., H, W) float32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    oh, ow = _check_size(size)
    h, w = x.shape[-2:]
    if (h, w) == (oh, ow):
        return x.clone()
    x0, x1, fx = _linear_taps(w, ow, True, True)
    y0, y1, fy = _linear_taps(h, oh, True, True)
    dev = x.device
    tx = torch.as_tensor(fx.astype(np.float32), device=dev).double()
    ty = torch.as_tensor(fy.astype(np.float32)[:, None], device=dev).double()
    x0, x1, y0, y1 = _on(dev, x0, x1, y0, y1)
    d = _lerp(x.index_select(-1, x0), x.index_select(-1, x1), tx)
    return _lerp(d.index_select(-2, y0), d.index_select(-2, y1), ty)


@functools.lru_cache(maxsize=64)
def _nearest_index(src: int, dst: int) -> np.ndarray:
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                      src - 1)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) of any dtype → (..., oh, ow), cv2 INTER_NEAREST."""
    oh, ow = _check_size(size)
    h, w = x.shape[-2:]
    iy, ix = _on(x.device, _nearest_index(h, oh), _nearest_index(w, ow))
    return x.index_select(-2, iy).index_select(-1, ix)


def _cubic_weight(t: float) -> float:
    """cv2's bicubic kernel with A = -0.75, evaluated in double."""
    a, t = -0.75, abs(t)
    if t <= 1:
        return ((a + 2) * t - (a + 3)) * t * t + 1
    return ((a * t - 5 * a) * t + 8 * a) * t - 4 * a


@functools.lru_cache(maxsize=64)
def _cubic_taps(src: int, dst: int):
    scale = src / dst
    idx = np.zeros((dst, 4), np.int64)
    wts = np.zeros((dst, 4), np.float32)
    for d in range(dst):
        fx = (d + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        t = fx - sx
        wts[d] = [_cubic_weight(t + 1), _cubic_weight(t),
                  _cubic_weight(1 - t), _cubic_weight(2 - t)]
        idx[d] = np.clip(np.arange(sx - 1, sx + 3), 0, src - 1)
    return idx, wts


def resize_cubic_f32(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(x, (w, h), interpolation=INTER_CUBIC) on a float32 (H, W)
    host array: the 4 taps of the A = -0.75 kernel at the double source
    offset, rounded to float32, a replicated border, rows then columns,
    each a left-to-right float32 sum. cv2 5.0 sums in another order (its
    path for 4 rows or more): up to 3 float32 ulps apart on about half of
    the values (ROADMAP.md, stated differences)."""
    oh, ow = _check_size(size)
    x = np.asarray(x, np.float32)
    ix, wx = _cubic_taps(x.shape[1], ow)
    iy, wy = _cubic_taps(x.shape[0], oh)
    g = x[:, ix]
    rows = g[..., 0] * wx[:, 0]
    for k in range(1, 4):
        rows = rows + g[..., k] * wx[:, k]
    g = rows[iy]
    out = g[:, 0] * wy[:, 0, None]
    for k in range(1, 4):
        out = out + g[:, k] * wy[:, k, None]
    return out
