"""The PIL operations of data/gen_data.py, bit for bit with Pillow 12, as
torch ops on an RGBA uint8 tensor (H, W, 4) on any device.

  rotate_expand   Image.rotate(angle, expand=True, fillcolor=(0, 0, 0, 0))
                  with NEAREST: the fast paths (0, 90, 180, 270 degrees as
                  transposes), else Image.py's matrix (cos and sin rounded
                  to 15 digits, the expanded size from the corners) and
                  Geometry.c's affine_fixed: the matrix in 16.16 fixed
                  point, source pixel (a2 + y*a1 + x*a0) >> 16; where a
                  corner's coordinate reaches 32767 the float loop, whose
                  per-pixel sums run in float64 in Geometry.c's order
  resize_lanczos  Image.resize(size, LANCZOS) on RGBA: premultiplied RGBa
                  (Convert.c's MULDIV255), Resample.c's coefficients
                  (lanczos over 3 lobes, normalised, fixed at 22 bits), the
                  horizontal pass before the vertical one, each pass a
                  clip to 8 bits; back to RGBA by 255 * c / a
  gaussian_blur   ImageFilter.GaussianBlur(r): BoxBlur.c, the box radius
                  from the Gaussian's sigma in single precision, three
                  extended box passes each way (fractional edge weight,
                  edges repeated), 24-bit fixed point
  alpha_composite Image.alpha_composite(im, dest): AlphaComposite.c's
                  integer formula over the part of `im` inside the canvas
  to_rgb          convert("RGB"): the alpha dropped

Every pass is exact integer arithmetic (float64 matmuls only where each
product and partial sum is an integer below 2^53), so the card and the CPU
give the same bytes.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2  # Resample.c
COMPOSITE_BITS = 7  # AlphaComposite.c's PRECISION_BITS


def _check(img: torch.Tensor) -> None:
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 4:
        raise ValueError(f"expected an (H, W, 4) uint8 RGBA tensor, got "
                         f"{tuple(img.shape)} {img.dtype}")


# -- rotate -------------------------------------------------------------------

def rotation_matrix(width: int, height: int, angle: float
                    ) -> Tuple[list, int, int]:
    """Image.rotate's inverse affine matrix and output size for
    expand=True (angle already reduced mod 360, not a fast path)."""
    w, h = width, height
    center = (w / 2, h / 2)
    a = -math.radians(angle)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
         round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]

    def tf(x, y):
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    m[2], m[5] = tf(-center[0], -center[1])
    m[2] += center[0]
    m[5] += center[1]
    xs, ys = zip(*(tf(x, y) for x, y in ((0, 0), (w, 0), (w, h), (0, h))))
    nw = math.ceil(max(xs)) - math.floor(min(xs))
    nh = math.ceil(max(ys)) - math.floor(min(ys))
    m[2], m[5] = tf(-(nw - w) / 2.0, -(nh - h) / 2.0)
    return m, nw, nh


def _check_fixed(a, x: int, y: int) -> bool:
    return (abs(x * a[0] + y * a[1] + a[2]) < 32767.0
            and abs(x * a[3] + y * a[4] + a[5]) < 32767.0)


def _fix16(v: float) -> int:
    return math.floor(v * 65536.0 + 0.5)


def _source_fixed(a, nw: int, nh: int, device) -> Tuple[torch.Tensor, ...]:
    a0, a1, a3, a4 = (_fix16(a[0]), _fix16(a[1]), _fix16(a[3]),
                      _fix16(a[4]))
    a2 = _fix16(a[2] + a[0] * 0.5 + a[1] * 0.5)
    a5 = _fix16(a[5] + a[3] * 0.5 + a[4] * 0.5)
    y = torch.arange(nh, device=device, dtype=torch.int64)[:, None]
    x = torch.arange(nw, device=device, dtype=torch.int64)[None, :]
    return (a2 + y * a1 + x * a0) >> 16, (a5 + y * a4 + x * a3) >> 16


def _source_float(a, nw: int, nh: int, device) -> Tuple[torch.Tensor, ...]:
    """The float loop: xo/yo advance by a[1]/a[4] a row, xx/yy by
    a[0]/a[3] a pixel, each a float64 running sum in C's order."""
    xo = np.empty(nh)
    yo = np.empty(nh)
    xo[0] = a[2] + a[1] * 0.5 + a[0] * 0.5
    yo[0] = a[5] + a[4] * 0.5 + a[3] * 0.5
    for i in range(1, nh):
        xo[i] = xo[i - 1] + a[1]
        yo[i] = yo[i - 1] + a[4]
    xx = np.empty((nh, nw))
    yy = np.empty((nh, nw))
    xx[:, 0], yy[:, 0] = xo, yo
    for j in range(1, nw):
        xx[:, j] = xx[:, j - 1] + a[0]
        yy[:, j] = yy[:, j - 1] + a[3]
    # COORD(v): -1 below zero, else the truncation
    xi = np.where(xx < 0, -1, np.trunc(np.where(xx < 0, 0, xx)))
    yi = np.where(yy < 0, -1, np.trunc(np.where(yy < 0, 0, yy)))
    return (torch.from_numpy(xi.astype(np.int64)).to(device),
            torch.from_numpy(yi.astype(np.int64)).to(device))


def rotate_expand(img: torch.Tensor, angle: float) -> torch.Tensor:
    """Image.rotate(angle, expand=True, fillcolor=(0, 0, 0, 0)), NEAREST."""
    _check(img)
    angle = angle % 360.0
    if angle == 0:
        return img.clone()
    if angle == 180:
        return img.flip(0, 1)
    if angle == 90:
        return torch.rot90(img, 1, (0, 1)).contiguous()
    if angle == 270:
        return torch.rot90(img, 3, (0, 1)).contiguous()
    h, w = img.shape[:2]
    a, nw, nh = rotation_matrix(w, h, angle)
    if a[1] == 0 and a[3] == 0:  # ImagingScaleAffine: not reached by rotate
        raise NotImplementedError("a rotation whose matrix has no shear")
    fixed = all(_check_fixed(a, x, y) for x, y in
                ((0, 0), (nw, nh), (0, nh), (nw, 0)))
    xin, yin = (_source_fixed if fixed else _source_float)(a, nw, nh,
                                                           img.device)
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    src = img[yin.clamp(0, h - 1), xin.clamp(0, w - 1)]
    return torch.where(inside[..., None], src, torch.zeros_like(src))


# -- resize -------------------------------------------------------------------

def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    """Resample.c lanczos_filter (libm's sin, as math.sin)."""
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def lanczos_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc as a dense
    (out_size, in_size) int64 matrix of 22-bit fixed-point weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ss = 1.0 / filterscale
    mat = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:  # C's running float64 sum
            ww += v
        for x, v in enumerate(k):
            if ww != 0.0:
                v /= ww
            f = v * (1 << PRECISION_BITS)
            mat[xx, xmin + x] = int(-0.5 + f) if v < 0 else int(0.5 + f)
    return mat


def _resample(img: torch.Tensor, mat: np.ndarray, dim: int) -> torch.Tensor:
    """One pass along `dim` (0 rows, 1 columns): clip8 of 2^21 + the
    fixed-point sum, exact in float64 (|sum| < 2^53)."""
    k = torch.from_numpy(mat.astype(np.float64)).to(img.device)
    x = img.to(torch.float64)
    if dim == 1:
        acc = torch.einsum("oi,hic->hoc", k, x)
    else:
        acc = torch.einsum("oi,iwc->owc", k, x)
    acc = acc.to(torch.int64) + (1 << (PRECISION_BITS - 1))
    return (acc >> PRECISION_BITS).clamp(0, 255).to(torch.uint8)


def _muldiv255(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def premultiply(img: torch.Tensor) -> torch.Tensor:
    """RGBA → RGBa (Convert.c rgbA2rgba)."""
    x = img.to(torch.int64)
    rgb = _muldiv255(x[..., :3], x[..., 3:])
    return torch.cat([rgb, x[..., 3:]], -1).to(torch.uint8)


def unpremultiply(img: torch.Tensor) -> torch.Tensor:
    """RGBa → RGBA (Convert.c rgba2rgbA): 255 * c / a, clipped, where
    0 < a < 255."""
    x = img.to(torch.int64)
    a = x[..., 3:]
    div = (255 * x[..., :3]) // a.clamp(min=1)
    rgb = torch.where((a == 0) | (a == 255), x[..., :3], div.clamp(0, 255))
    return torch.cat([rgb, a], -1).to(torch.uint8)


def resize_lanczos(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Image.resize(size, Image.LANCZOS) on RGBA; size is (width,
    height)."""
    _check(img)
    h, w = img.shape[:2]
    nw, nh = size
    if (nw, nh) == (w, h):
        return img.clone()
    x = premultiply(img)
    if nw != w:
        x = _resample(x, lanczos_coeffs(w, nw), 1)
    if nh != h:
        x = _resample(x, lanczos_coeffs(h, nh), 0)
    return unpremultiply(x)


# -- Gaussian blur ------------------------------------------------------------

def box_radius(radius: float, passes: int = 3) -> float:
    """BoxBlur.c _gaussian_blur_radius, in C's single and double
    precision."""
    f32 = np.float32
    r = f32(radius)
    sigma2 = f32(r * r / f32(passes))
    big_l = f32(math.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f32(math.floor((float(big_l) - 1.0) / 2.0))
    a = f32(f32(2) * small_l + f32(1)) * f32(small_l * (small_l + f32(1))
                                             - f32(3) * sigma2)
    a = f32(a / f32(f32(6) * f32(sigma2 - (small_l + f32(1))
                                  * (small_l + f32(1)))))
    return float(f32(small_l + a))


def _box_pass(x: torch.Tensor, radius: float) -> torch.Tensor:
    """ImagingHorizontalBoxBlur along the last-but-one axis of an
    (..., N, C) int64 tensor: the window of 2r + 1 pixels at weight ww and
    the two beyond it at fw, indices clamped to the line."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / np.float32(np.float32(radius) * 2 + 1))
    fw = ((1 << 24) - (r * 2 + 1) * ww) // 2
    n = x.shape[-2]
    idx = torch.arange(n, device=x.device)
    window = torch.zeros_like(x)
    for k in range(-r, r + 1):
        window += x[..., (idx + k).clamp(0, n - 1), :]
    far = (x[..., (idx - r - 1).clamp(0, n - 1), :]
           + x[..., (idx + r + 1).clamp(0, n - 1), :])
    return (window * ww + far * fw + (1 << 23)) >> 24


def gaussian_blur(img: torch.Tensor, radius: float) -> torch.Tensor:
    """img.filter(ImageFilter.GaussianBlur(radius)) on RGBA."""
    _check(img)
    if radius == 0:
        return img.clone()
    br = box_radius(radius)
    x = img.to(torch.int64)
    if br != 0:
        for _ in range(3):  # along each row
            x = _box_pass(x, br)
        x = x.transpose(0, 1)
        for _ in range(3):  # along each column
            x = _box_pass(x, br)
        x = x.transpose(0, 1)
    return x.to(torch.uint8).contiguous()


# -- composite ----------------------------------------------------------------

def _shift_div255(a: torch.Tensor) -> torch.Tensor:
    return ((a >> 8) + a) >> 8


def composite_over(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """AlphaComposite.c: src over dst, both (H, W, 4) uint8."""
    d, s = dst.to(torch.int64), src.to(torch.int64)
    sa, da = s[..., 3:], d[..., 3:]
    blend = da * (255 - sa)
    outa255 = sa * 255 + blend
    coef1 = sa * 255 * 255 * (1 << COMPOSITE_BITS) // outa255.clamp(min=1)
    coef2 = 255 * (1 << COMPOSITE_BITS) - coef1
    tmp = s[..., :3] * coef1 + d[..., :3] * coef2
    rgb = _shift_div255(tmp + (0x80 << COMPOSITE_BITS)) >> COMPOSITE_BITS
    a = _shift_div255(outa255 + 0x80)
    out = torch.cat([rgb, a], -1).to(torch.uint8)
    return torch.where(sa == 0, dst, out)


def alpha_composite(canvas: torch.Tensor, im: torch.Tensor,
                    dest: Tuple[int, int]) -> None:
    """canvas.alpha_composite(im, dest=dest), in place: the part of `im`
    that lies inside the canvas."""
    _check(canvas)
    _check(im)
    x0, y0 = dest
    if x0 < 0 or y0 < 0:
        raise ValueError("destination must be non-negative")
    hh = min(im.shape[0], canvas.shape[0] - y0)
    ww = min(im.shape[1], canvas.shape[1] - x0)
    if hh <= 0 or ww <= 0:
        return
    region = canvas[y0:y0 + hh, x0:x0 + ww]
    region.copy_(composite_over(region, im[:hh, :ww]))


def scale_alpha(img: torch.Tensor, alpha: float) -> torch.Tensor:
    """gen_data's `(a.astype(float32) * alpha).astype(uint8)` on the alpha
    channel: a float32 product, truncated."""
    a = img[..., 3].to(torch.float32) * torch.tensor(
        np.float32(alpha), device=img.device)
    out = img.clone()
    out[..., 3] = a.to(torch.uint8)
    return out


def to_rgb(img: torch.Tensor) -> torch.Tensor:
    """convert("RGB") of RGBA: the alpha dropped."""
    _check(img)
    return img[..., :3].contiguous()
