"""Batched data augmentation on the batch's device (ops/augment.py in the
JAX package): the same four policies, the same ops in the same order, on
(N, H, W, 3) float images in [0, 1] and (N, H, W, 1) masks.

The JAX package draws each sample's parameters from a jax.random key inside
a vmapped augment_sample. The port splits that in two:

  draw_params(gen, n, h, w, policy)  every per-sample parameter of a batch,
                                     drawn at once with a torch.Generator
                                     on the batch's device
  apply_params(images, masks, params, policy)
                                     the augmentation of the whole batch
                                     with those parameters, no Python loop
                                     over samples

The draws cannot equal jax.random's threefry stream; they follow the same
distributions. apply_params computes what augment_sample computes from the
same drawn values: the tests recover JAX's draws from a key and hold the
two outputs together.

The affine warp takes the policy's interpolation, as JAX's does. The
default, "nearest", is the separable nearest warp
(_separable_nearest_warp): not an exact 2-D nearest warp, but two index
maps, each a per-output-line base plus a per-input-line shift into the
reflect-101 extended axis. Here both maps are built as JAX builds them and
applied as gathers, which gives the same pixels as JAX's one-hot matmuls
and binary rolls given the same float32 coefficients. "nearest_gather"
(JAX's _nearest_sample) and any other name, bilinear (_bilinear_sample),
sample JAX's inverse-map grid (_affine_grid) with one or four gathers of
reflect-101 coordinates. The image and mask go through one warp and the
mask is thresholded at 0.5 after it, as in JAX.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugmentPolicy:
    hflip_p: float = 0.5
    vflip_p: float = 0.2
    rot90_p: float = 0.3
    affine_p: float = 0.3
    scale_limit: float = 0.1
    rotate_limit: float = 15.0   # degrees
    shear_limit: float = 0.0     # degrees
    shift_limit: float = 0.1     # fraction of size
    brightness_limit: float = 0.2
    contrast_limit: float = 0.2
    bc_p: float = 0.3
    hue_limit: float = 10.0      # degrees of hue shift
    sat_limit: float = 20.0      # 0-255 scale shift
    val_limit: float = 10.0
    hsv_p: float = 0.3
    noise_p: float = 0.0
    noise_std: float = 0.03      # on the [0, 1] scale
    blur_p: float = 0.0
    gamma_p: float = 0.0
    gamma_limit: Tuple[float, float] = (0.8, 1.2)
    jpeg_p: float = 0.0
    jpeg_quality: Tuple[float, float] = (60.0, 100.0)
    # "nearest" (the separable warp), "nearest_gather" or bilinear
    interpolation: str = "nearest"


POLICIES = {
    "basic": AugmentPolicy(),
    "enhanced": AugmentPolicy(
        brightness_limit=0.25, contrast_limit=0.25, bc_p=0.6,
        hue_limit=12, sat_limit=25, val_limit=15, hsv_p=0.4,
        noise_p=0.2, noise_std=0.02, blur_p=0.15, gamma_p=0.3),
    "transparent_watermark": AugmentPolicy(
        affine_p=0.3, scale_limit=0.1, rotate_limit=15, shear_limit=5,
        shift_limit=0.0,
        brightness_limit=0.3, contrast_limit=0.3, bc_p=0.7,
        hue_limit=15, sat_limit=30, val_limit=20, hsv_p=0.5,
        noise_p=0.3, noise_std=0.03, blur_p=0.2,
        jpeg_p=0.3, jpeg_quality=(60.0, 100.0)),
    "text_watermark": AugmentPolicy(
        affine_p=0.2, scale_limit=0.05, rotate_limit=8, shear_limit=2,
        shift_limit=0.0,
        brightness_limit=0.3, contrast_limit=0.3, bc_p=0.7,
        hue_limit=15, sat_limit=30, val_limit=20, hsv_p=0.5,
        noise_p=0.3, noise_std=0.03, blur_p=0.1),
}


def resolve_policy(policy) -> AugmentPolicy:
    return POLICIES[policy] if isinstance(policy, str) else policy


def has_warp(policy: AugmentPolicy, h: int, w: int) -> bool:
    """Whether augment_sample runs its affine branch for this shape."""
    return policy.affine_p > 0 or (h == w and policy.rot90_p > 0)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

def draw_params(gen: torch.Generator, n: int, h: int, w: int,
                policy) -> Dict[str, torch.Tensor]:
    """Every per-sample parameter augment_sample draws, for n samples at
    once on gen's device, with the same distributions: each op fires with
    its probability, its amounts are uniform over its limits, rot90 turns
    by 90, 180 or 270 degrees, the noise is normal. The values are the
    effective ones (a disabled affine gives scale 1, angle 0, ...), which
    is what apply_params takes."""
    pol = resolve_policy(policy)
    dev = gen.device

    def u(*shape):
        return torch.rand(shape or (n,), generator=gen, device=dev)

    def between(lo, hi, *shape):
        return lo + u(*shape) * (hi - lo)

    p = {}
    p["hflip"] = u() < pol.hflip_p
    p["vflip"] = u() < pol.vflip_p
    if has_warp(pol, h, w):
        rot = torch.zeros(n, device=dev)
        if h == w and pol.rot90_p > 0:
            k = torch.randint(1, 4, (n,), generator=gen, device=dev)
            rot = torch.where(u() < pol.rot90_p, 90.0 * k, 0.0)
        do_a = u() < pol.affine_p
        scale = 1.0 + between(-pol.scale_limit, pol.scale_limit)
        angle = between(-pol.rotate_limit, pol.rotate_limit)
        shear = between(-pol.shear_limit, pol.shear_limit)
        shift = between(-pol.shift_limit, pol.shift_limit, n, 2)
        p["scale"] = torch.where(do_a, scale, 1.0)
        p["angle"] = torch.where(do_a, angle, 0.0) + rot
        p["shear"] = torch.where(do_a, shear, 0.0)
        p["shift"] = torch.where(do_a[:, None], shift, 0.0)
    p["bc"] = u() < pol.bc_p
    p["brightness"] = between(-pol.brightness_limit, pol.brightness_limit)
    p["contrast"] = between(-pol.contrast_limit, pol.contrast_limit)
    p["hsv"] = u() < pol.hsv_p
    p["dh"] = between(-pol.hue_limit, pol.hue_limit)
    p["ds"] = between(-pol.sat_limit, pol.sat_limit)
    p["dv"] = between(-pol.val_limit, pol.val_limit)
    if pol.noise_p > 0:
        p["noise"] = u() < pol.noise_p
        p["noise_values"] = torch.randn((n, h, w, 3), generator=gen,
                                        device=dev) * pol.noise_std
    p["blur"] = u() < pol.blur_p
    p["jpeg"] = u() < pol.jpeg_p
    p["quality"] = between(pol.jpeg_quality[0], pol.jpeg_quality[1])
    return p


# ---------------------------------------------------------------------------
# geometry (image + mask)
# ---------------------------------------------------------------------------

def _inverse_matrix(scale, angle_deg, shear_deg):
    """The 2 x 2 inverse of scale → shear(x) → rotate, (i00, i01, i10,
    i11), each (N,) float32, in the JAX functions' order."""
    ang = torch.deg2rad(angle_deg)
    shr = torch.deg2rad(shear_deg)
    cos, sin = torch.cos(ang), torch.sin(ang)
    m00 = scale * cos
    m01 = scale * (cos * torch.tan(shr) - sin)
    m10 = scale * sin
    m11 = scale * (sin * torch.tan(shr) + cos)
    det = m00 * m11 - m01 * m10
    return m11 / det, -m01 / det, -m10 / det, m00 / det


def _affine_coeffs(h: int, w: int, scale, angle_deg, shear_deg, shift_xy):
    """The inverse map of a centred scale → shear(x) → rotate, as linear
    coefficients: src_x = p·xo + q·yo + rx, src_y = s·xo + t·yo + ry; float32
    (N,) tensors, computed in the JAX function's order."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    i00, i01, i10, i11 = _inverse_matrix(scale, angle_deg, shear_deg)
    ty, tx = shift_xy[:, 1] * h, shift_xy[:, 0] * w
    rx = cx - i00 * (cx + tx) - i01 * (cy + ty)
    ry = cy - i10 * (cx + tx) - i11 * (cy + ty)
    return i00, i01, rx, i10, i11, ry


def affine_grid(h: int, w: int, scale, angle_deg, shear_deg, shift_xy):
    """JAX's _affine_grid on a batch: the inverse map's source coordinates
    (src_y, src_x), each (N, H, W) float32, in the JAX function's order of
    operations."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    i00, i01, i10, i11 = (_col(v) for v in _inverse_matrix(
        scale, angle_deg, shear_deg))
    dev = scale.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    ty, tx = _col(shift_xy[:, 1] * h), _col(shift_xy[:, 0] * w)
    yy = ys - cy - ty
    xx = xs - cx - tx
    return i10 * xx + i11 * yy + cy, i00 * xx + i01 * yy + cx


def _reflect101(v: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect-101 of float coordinates, for any overshoot."""
    period = 2 * (n - 1)
    v = torch.remainder(torch.abs(v), period)
    return torch.where(v >= n, period - v, v)


def _take(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor
          ) -> torch.Tensor:
    """img (N, H, W, C) at integer (N, H', W') coordinates."""
    n, h, w, c = img.shape
    idx = (yi * w + xi).reshape(n, -1, 1).expand(-1, -1, c)
    return torch.gather(img.reshape(n, h * w, c), 1, idx).reshape(
        yi.shape + (c,))


def nearest_sample(img: torch.Tensor, src_y: torch.Tensor,
                   src_x: torch.Tensor) -> torch.Tensor:
    """JAX's _nearest_sample on a batch: one gather at the rounded (half to
    even) reflect-101 coordinates."""
    h, w = img.shape[1:3]
    yi = torch.clamp(torch.round(_reflect101(src_y, h)), 0, h - 1).long()
    xi = torch.clamp(torch.round(_reflect101(src_x, w)), 0, w - 1).long()
    return _take(img, yi, xi)


def bilinear_sample(img: torch.Tensor, src_y: torch.Tensor,
                    src_x: torch.Tensor) -> torch.Tensor:
    """JAX's _bilinear_sample on a batch: reflect-101 coordinates, four
    gathers, the weights in JAX's order."""
    h, w = img.shape[1:3]
    src_y, src_x = _reflect101(src_y, h), _reflect101(src_x, w)
    y0 = torch.clamp(torch.floor(src_y), 0, h - 1)
    x0 = torch.clamp(torch.floor(src_x), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (src_y - y0)[..., None]
    wx = (src_x - x0)[..., None]
    y0i, y1i, x0i, x1i = (v.long() for v in (y0, y1, x0, x1))
    top = _take(img, y0i, x0i) * (1 - wx) + _take(img, y0i, x1i) * wx
    bot = _take(img, y1i, x0i) * (1 - wx) + _take(img, y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def separable_nearest_warp(img: torch.Tensor, p, q, rx, s, t, ry
                           ) -> torch.Tensor:
    """JAX's _separable_nearest_warp on a batch: img (N, H, W, C), the six
    (N,) float32 coefficients of each sample.

      pass 1 (rows):  mid[yo, x] = ext1[(base1[yo] + shift1[x]) mod ny, x]
      pass 2 (cols):  out[yo, xo] = ext2[yo, (base2[xo] + shift2[yo]) mod nx]

    ext1/ext2 extend each axis with its mirrored interior (reflect-101,
    sizes 2H-2 and 2W-2); base and shift are JAX's rounded index terms. A
    square sample whose |s| > |p| is warped transposed with its
    coefficients swapped, as in JAX."""
    n, h, w, c = img.shape
    if h == w:
        flip = torch.abs(s) > torch.abs(p)
        img = torch.where(flip[:, None, None, None], img.transpose(1, 2),
                          img)
        sel = lambda a, b: torch.where(flip, a, b)  # noqa: E731
        p, q, rx, s, t, ry = (sel(s, p), sel(t, q), sel(ry, rx), sel(p, s),
                              sel(q, t), sel(rx, ry))
    tiny = torch.where(p < 0, -1e-6, 1e-6)
    p_safe = torch.where(torch.abs(p) < 1e-6, tiny, p)
    slope_b = s / p_safe
    a_coef = (p * t - q * s) / p_safe
    c_coef = ry - s * rx / p_safe
    dev = img.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    xs = torch.arange(w, device=dev, dtype=torch.float32)

    ny = 2 * h - 2
    ext = torch.cat([img, img.flip(1)[:, 1:-1]], dim=1)
    shift1 = torch.round(slope_b[:, None] * xs).long()
    base1 = torch.remainder(
        torch.round(a_coef[:, None] * ys + c_coef[:, None]).long(), ny)
    idx1 = torch.remainder(base1[:, :, None] + shift1[:, None, :], ny)
    mid = torch.gather(ext, 1, idx1[..., None].expand(n, h, w, c))

    nx = 2 * w - 2
    ext2 = torch.cat([mid, mid.flip(2)[:, :, 1:-1]], dim=2)
    shift2 = torch.round(q[:, None] * ys).long()
    base2 = torch.remainder(
        torch.round(p[:, None] * xs + rx[:, None]).long(), nx)
    idx2 = torch.remainder(base2[:, None, :] + shift2[:, :, None], nx)
    return torch.gather(ext2, 2, idx2[..., None].expand(n, h, w, c))


# ---------------------------------------------------------------------------
# photometric (image only)
# ---------------------------------------------------------------------------

def _col(x: torch.Tensor) -> torch.Tensor:
    """(N,) → (N, 1, 1) for a per-sample value over (N, H, W)."""
    return x[:, None, None]


def hsv_shift(img: torch.Tensor, dh, ds, dv) -> torch.Tensor:
    """JAX's _hsv_shift on (N, H, W, 3) RGB in [0, 1]; dh in degrees, ds
    and dv on the 0-255 scale, (N,) each."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn + 1e-8
    h = torch.where(
        mx == r, torch.remainder((g - b) / diff, 6.0),
        torch.where(mx == g, (b - r) / diff + 2.0, (r - g) / diff + 4.0))
    h = h * 60.0
    s = diff / (mx + 1e-8)
    v = mx
    h = torch.remainder(h + _col(dh), 360.0)
    s = torch.clamp(s + _col(ds) / 255.0, 0.0, 1.0)
    v = torch.clamp(v + _col(dv) / 255.0, 0.0, 1.0)
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    i = torch.remainder(hp.to(torch.int32), 6)

    def pick(*vals):  # jnp.select over i == 0..5
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    m = v - c
    return torch.stack([pick(c, x, z, z, x, c) + m, pick(x, c, c, x, z, z) + m,
                        pick(z, z, x, c, c, x) + m], dim=-1)


def blur3(img: torch.Tensor) -> torch.Tensor:
    """The [1 2 1]^T [1 2 1] / 16 blur per channel, zero border."""
    k = _consts(img.device)["blur"]
    c = img.shape[-1]
    x = img.permute(0, 3, 1, 2)
    y = F.conv2d(x, k.expand(c, 1, 3, 3), padding=1, groups=c)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=1)
def _dct8() -> np.ndarray:
    """The orthonormal 8-point DCT-II matrix, float32."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    m = np.cos(np.pi * (2 * n + 1) * k / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return np.asarray(m, np.float32)


# luminance quantization base table (JPEG Annex K)
JPEG_Q = np.asarray([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)


def jpeg_compression_sim(image: torch.Tensor, quality: torch.Tensor
                         ) -> torch.Tensor:
    """JAX's jpeg_compression_sim on a batch: (N, H, W, C) in [0, 1], H and W
    multiples of 8, (N,) quality in [1, 100]. Per channel 8 x 8 block DCT,
    quantization by the luminance table scaled by the quality, inverse DCT.
    The DCTs are matmuls whose float32 sums may round differently from
    XLA's einsums, so a coefficient at .5 of its step may round the other
    way (the tests count such blocks)."""
    n, h, w, c = image.shape
    d, base = _consts(image.device)["dct"], _consts(image.device)["jpeg_q"]
    scale = torch.where(quality < 50, 5000.0 / quality, 200.0 - 2.0 * quality)
    q = torch.clamp(torch.floor((base * scale[:, None, None] + 50.0) / 100.0),
                    1, 255)  # (N, 8, 8)
    x = image * 255.0 - 128.0
    xb = x.reshape(n, h // 8, 8, w // 8, 8, c).permute(0, 1, 3, 5, 2, 4)
    f = d @ xb @ d.T  # (N, H/8, W/8, C, 8, 8)
    qb = q[:, None, None, None]
    f = torch.round(f / qb) * qb
    y = d.T @ f @ d
    out = (y.permute(0, 1, 4, 2, 5, 3).reshape(n, h, w, c) + 128.0) / 255.0
    return torch.clamp(out, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> Dict[str, torch.Tensor]:
    """The constant tables on `device`, uploaded once: an upload from the
    host is a blocking copy, which in a step would stall the host until
    the card drained its queue."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in (("blur", np.outer([1., 2., 1.], [1., 2., 1.]) / 16),
                         ("dct", _dct8()), ("jpeg_q", JPEG_Q),
                         ("mean", IMAGENET_MEAN), ("std", IMAGENET_STD))}


def _where_n(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(flag.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def apply_params(images: torch.Tensor, masks: torch.Tensor,
                 params: Dict[str, torch.Tensor], policy
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """augment_sample over a batch with drawn parameters (draw_params):
    images (N, H, W, 3) float32 [0, 1], masks (N, H, W, 1) float32."""
    pol = resolve_policy(policy)
    n, h, w = images.shape[:3]
    if pol.hflip_p > 0:
        images = _where_n(params["hflip"], images.flip(2), images)
        masks = _where_n(params["hflip"], masks.flip(2), masks)
    if pol.vflip_p > 0:
        images = _where_n(params["vflip"], images.flip(1), images)
        masks = _where_n(params["vflip"], masks.flip(1), masks)
    if has_warp(pol, h, w):
        warp = (params["scale"], params["angle"], params["shear"],
                params["shift"])
        both = torch.cat([images, masks], -1)
        if pol.interpolation == "nearest":
            both = separable_nearest_warp(both, *_affine_coeffs(h, w, *warp))
        elif pol.interpolation == "nearest_gather":
            both = nearest_sample(both, *affine_grid(h, w, *warp))
        else:
            both = bilinear_sample(both, *affine_grid(h, w, *warp))
        images = both[..., :3]
        masks = (both[..., 3:] > 0.5).float()
    if pol.bc_p > 0:
        f = params["bc"].float()
        images = torch.clamp(
            (images + _col(params["brightness"] * f)[..., None])
            * (1.0 + _col(params["contrast"] * f)[..., None]), 0, 1)
    if pol.hsv_p > 0:
        shifted = hsv_shift(images, params["dh"], params["ds"], params["dv"])
        images = _where_n(params["hsv"], shifted, images)
    if pol.noise_p > 0:
        images = torch.clamp(_where_n(params["noise"],
                                      images + params["noise_values"],
                                      images), 0, 1)
    if pol.blur_p > 0:
        images = _where_n(params["blur"], blur3(images), images)
    if pol.jpeg_p > 0 and h % 8 == 0 and w % 8 == 0:
        images = _where_n(params["jpeg"],
                          jpeg_compression_sim(images, params["quality"]),
                          images)
    return images, masks


def normalize(image: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization over the last (channel) axis."""
    c = _consts(image.device)
    return (image - c["mean"]) / c["std"]


def augment_batch(gen: torch.Generator, images: torch.Tensor,
                  masks: torch.Tensor, policy="transparent_watermark",
                  apply_normalize: bool = True,
                  rows: Optional[Tuple[int, int]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw, then apply, then (by default) normalize: images (N, H, W, 3)
    float [0, 1], masks (N, H, W, 1). `policy` is a name or a policy.

    rows=(global_n, start): the batch is rows start.. of a global batch of
    global_n (one rank's share in data-parallel training); the parameters
    are drawn for the whole global batch, as one process draws them, and
    these rows' are kept, so every rank's generator stays in step."""
    n, h, w = images.shape[:3]
    if rows is None:
        params = draw_params(gen, n, h, w, policy)
    else:
        total, start = rows
        params = {k: v[start:start + n] for k, v in
                  draw_params(gen, total, h, w, policy).items()}
    images, masks = apply_params(images, masks, params, policy)
    if apply_normalize:
        images = normalize(images)
    return images, masks


def val_preprocess(images: torch.Tensor) -> torch.Tensor:
    """Validation: normalize only (the host already resized)."""
    return normalize(images)
