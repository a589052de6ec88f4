"""cv2's image operations on uint8 tensors, on whichever device they lie:
the calls that the JAX package's text detector (ocr/builtin.py) and text
enhancement (inference/predict.py, _enhance_text_features) make, reproduced
to the bit against cv2 5.0.0 (tests/test_torch_imgproc.py).

  gray_u8         cvtColor(RGB2GRAY / BGR2GRAY): 15-bit fixed point,
                  (R 9798 + G 19235 + B 3735 + 2^14) >> 15.
  grey_dilate, grey_erode, morph_close, morph_gradient
                  uint8 max / min over a structuring element anchored at
                  (w // 2, h // 2); pixels beyond the border are left out
                  (cv2's default border value for morphology).
  otsu_threshold  threshold(THRESH_BINARY | THRESH_OTSU): cv2's scan of the
                  256-bin histogram in double, on the host, with its running
                  class mean (multiplied back before each skip test), the
                  first maximum; then src > t → 255.
  external_boxes  findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) then
                  boundingRect: the boxes of the 8-connected foreground
                  components that touch the outer background (the
                  4-connected background around the image; pixels on the
                  image's edge count as inside it), in cv2's order: the
                  reverse of the raster order of each component's first
                  pixel.
  clahe           createCLAHE(clip, grid).apply on uint8: reflect-101 padding
                  to a multiple of the grid (of both sides, unless both
                  divide), clipped histograms, LUTs rint(float32(cumsum) *
                  (255f / area)), and the bilinear blend of four LUTs in
                  float32, one rounding an operation.
  canny           Canny(gray, low, high) with the 3x3 Sobel (replicated
                  border), the L1 gradient, cv2's fixed-point direction test
                  and its asymmetric suppression, and hysteresis as the
                  8-connected components of the candidates that hold a
                  strong pixel.
  filter2d_u8     filter2D(img, -1, kernel), BORDER_REFLECT_101: float32 sums
                  (exact for integer taps), rounded half to even, saturated.
  gaussian_blur_u8
                  GaussianBlur(img, (k, k), sigma) on uint8 with sigma > 0,
                  BORDER_REFLECT_101: cv2's fixed-point taps (8 fraction
                  bits, error-diffused) in exact integer sums.
  fill_rect, fill_poly
                  cv2.rectangle(..., -1) and cv2.fillPoly (shift 0,
                  8-connected edges) on host numpy masks: a region list is
                  a few shapes, inside the mask or crossing its edge.

Images are (H, W) uint8 unless the function says otherwise. Labelling goes
through ops/components.label_components. Each function's comment names
the rule it copies; where cv2 5.0 differs from the 4.x sources (gray's
15-bit weights, fillPoly's spans), testing against cv2 decided.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import components as cc

GRAY_COEFFS = (9798, 19235, 3735)  # R, G, B; they sum to 2^15
FLT_EPSILON = float(np.finfo(np.float32).eps)
TG22 = 13573  # tan(22.5°) * 2^15, cv2's Canny direction test
SHARPEN = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32)


def _check(img: torch.Tensor, ndims: Sequence[int]) -> None:
    if img.dtype != torch.uint8 or img.ndim not in ndims:
        raise TypeError(f"expected a uint8 image of {tuple(ndims)} dims, got "
                        f"{tuple(img.shape)} {img.dtype}")


def gray_u8(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """(H, W, 3) uint8 in `order` ("rgb" or "bgr") → (H, W) uint8."""
    _check(img, (3,))
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order {order!r}")
    cr, cg, cb = GRAY_COEFFS
    if order == "bgr":
        cr, cb = cb, cr
    x = img.to(torch.int32)
    y = x[..., 0] * cr + x[..., 1] * cg + x[..., 2] * cb + (1 << 14)
    return (y >> 15).to(torch.uint8)


def _window(img: torch.Tensor, kernel: np.ndarray, fill: int, reduce):
    """reduce over the element's taps of img shifted by (dy, dx) from the
    anchor (w // 2, h // 2), with `fill` beyond the border."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape
    p = F.pad(img, (ax, kw - 1 - ax, ay, kh - 1 - ay), value=fill)
    out = None
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j]:
                v = p[i:i + h, j:j + w]
                out = v.clone() if out is None else reduce(out, v)
    if out is None:
        raise ValueError("empty structuring element")
    return out


def grey_dilate(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.dilate(img, kernel) on uint8 (the border left out)."""
    _check(img, (2,))
    return _window(img, kernel, 0, torch.maximum)


def grey_erode(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.erode(img, kernel) on uint8 (the border left out)."""
    _check(img, (2,))
    return _window(img, kernel, 255, torch.minimum)


def morph_close(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.morphologyEx(MORPH_CLOSE): dilate, then erode."""
    return grey_erode(grey_dilate(img, kernel), kernel)


def morph_gradient(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.morphologyEx(MORPH_GRADIENT): dilate - erode, saturated."""
    d, e = grey_dilate(img, kernel), grey_erode(img, kernel)
    return d - torch.minimum(d, e)


def otsu_value(gray: torch.Tensor) -> int:
    """The threshold cv2's THRESH_OTSU picks for a uint8 image."""
    _check(gray, (2,))
    hist = torch.bincount(gray.reshape(-1).to(torch.int64),
                          minlength=256).tolist()
    scale = 1.0 / gray.numel()
    mu = 0.0
    for i, count in enumerate(hist):
        mu += i * float(count)
    mu *= scale
    mu1 = q1 = max_sigma = 0.0
    best = 0
    for i, count in enumerate(hist):
        p_i = count * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < FLT_EPSILON or max(q1, q2) > 1.0 - FLT_EPSILON:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, best = sigma, i
    return best


def otsu_threshold(gray: torch.Tensor) -> Tuple[int, torch.Tensor]:
    """cv2.threshold(gray, 0, 255, THRESH_BINARY | THRESH_OTSU): (t, gray >
    t as 0/255 uint8)."""
    t = otsu_value(gray)
    return t, (gray > t).to(torch.uint8) * 255


def external_boxes(binary: torch.Tensor) -> List[Tuple[int, int, int, int]]:
    """[(x, y, w, h)] of cv2.findContours(binary, RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE) → boundingRect, in cv2's order. Foreground is any
    nonzero pixel."""
    _check(binary, (2,))
    fg = binary > 0
    labels = cc.label_components(fg.to(torch.uint8), 8)
    # the background with a one-pixel frame: its 4-connected region holding
    # the frame's first pixel (label 1, the least) is the outer background
    bg = F.pad((~fg).to(torch.uint8), (1, 1, 1, 1), value=1)
    outer = cc.label_components(bg, 4) == 1
    touch = (outer[:-2, 1:-1] | outer[2:, 1:-1] | outer[1:-1, :-2]
             | outer[1:-1, 2:])
    ids = torch.unique(labels[fg & touch]).flip(0)  # reverse raster order
    st = cc.component_stats(labels)
    return [tuple(b) for b in torch.stack(
        [st[k][ids] for k in ("x0", "y0", "width", "height")], 1).tolist()]


def _reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    """Source indices of a length-n axis padded by lo before and hi after,
    as cv2.borderInterpolate(BORDER_REFLECT_101) gives them."""
    out = []
    for p in range(-lo, n + hi):
        if n == 1:
            out.append(0)
            continue
        while not 0 <= p < n:
            p = -p if p < 0 else 2 * n - 2 - p
        out.append(p)
    return np.asarray(out, np.int64)


def _pad_reflect101(img: torch.Tensor, top: int, bottom: int, left: int,
                    right: int) -> torch.Tensor:
    h, w = img.shape[:2]
    dev = img.device
    iy = torch.as_tensor(_reflect101(h, top, bottom), device=dev)
    ix = torch.as_tensor(_reflect101(w, left, right), device=dev)
    return img.index_select(0, iy).index_select(1, ix)


def _blend_axis(n: int, tile: int, tiles: int):
    """cv2 CLAHE's interpolation taps along one axis: the two tile indices
    and the float32 weights (1 - a, a) of each position."""
    inv = np.float32(1.0) / np.float32(tile)
    t = np.arange(n, dtype=np.float32) * inv - np.float32(0.5)
    t1 = np.floor(t).astype(np.int64)
    a = (t - t1.astype(np.float32)).astype(np.float32)
    return (np.maximum(t1, 0), np.minimum(t1 + 1, tiles - 1),
            (np.float32(1.0) - a).astype(np.float32), a)


def clahe(gray: torch.Tensor, clip: float = 2.0,
          grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """cv2.createCLAHE(clipLimit=clip, tileGridSize=grid).apply(gray);
    grid is (tiles across, tiles down), as cv2's Size."""
    _check(gray, (2,))
    gx, gy = grid
    h, w = gray.shape
    src = gray
    if h % gy or w % gx:
        src = _pad_reflect101(gray, 0, gy - h % gy, 0, gx - w % gx)
    th, tw = src.shape[0] // gy, src.shape[1] // gx
    area = th * tw
    dev = gray.device
    # one histogram a tile
    ty = torch.arange(gy * th, device=dev) // th
    tx = torch.arange(gx * tw, device=dev) // tw
    tile = ty[:, None] * gx + tx[None, :]
    idx = (tile * 256 + src[:gy * th, :gx * tw].to(torch.int64)).reshape(-1)
    hist = torch.bincount(idx, minlength=gx * gy * 256).reshape(gx * gy, 256)
    if clip > 0:
        limit = max(int(clip * area / 256), 1)
        clipped = (hist - limit).clamp(min=0).sum(dim=1, keepdim=True)
        hist = hist.clamp(max=limit) + clipped // 256
        residual = clipped % 256
        step = (256 // residual.clamp(min=1)).clamp(min=1)
        i = torch.arange(256, device=dev)
        hist = hist + ((i % step == 0) & (i // step < residual)).long()
    scale = torch.tensor(np.float32(255.0) / np.float32(area), device=dev)
    lut = torch.round(torch.cumsum(hist, dim=1).float() * scale)
    lut = lut.clamp(0, 255).reshape(-1)
    # the bilinear blend of the four nearest tiles' LUTs
    y1, y2, ya1, ya = (torch.as_tensor(v, device=dev)[:, None]
                       for v in _blend_axis(h, th, gy))
    x1, x2, xa1, xa = (torch.as_tensor(v, device=dev)[None, :]
                       for v in _blend_axis(w, tw, gx))
    v = gray.to(torch.int64)

    def at(ty_, tx_):
        return lut[(ty_ * gx + tx_) * 256 + v]

    res = (at(y1, x1) * xa1 + at(y1, x2) * xa) * ya1 + \
        (at(y2, x1) * xa1 + at(y2, x2) * xa) * ya
    return torch.round(res).clamp(0, 255).to(torch.uint8)


def _sobel(gray: torch.Tensor):
    """cv2.Sobel dx and dy (aperture 3, BORDER_REPLICATE) as int32."""
    h, w = gray.shape
    dev = gray.device
    iy = torch.arange(-1, h + 1, device=dev).clamp(0, h - 1)
    ix = torch.arange(-1, w + 1, device=dev).clamp(0, w - 1)
    p = gray.to(torch.int32).index_select(0, iy).index_select(1, ix)
    dx = (p[:-2, 2:] - p[:-2, :-2]) + 2 * (p[1:-1, 2:] - p[1:-1, :-2]) + \
        (p[2:, 2:] - p[2:, :-2])
    dy = (p[2:, :-2] - p[:-2, :-2]) + 2 * (p[2:, 1:-1] - p[:-2, 1:-1]) + \
        (p[2:, 2:] - p[:-2, 2:])
    return dx, dy


def sobel_f32(gray: torch.Tensor):
    """cv2.Sobel(gray, CV_32F, 1, 0) and (0, 1) of (H, W) uint8: aperture
    3 with cv2's default BORDER_REFLECT_101 (not _sobel's replicated
    border, which is Canny's), as float32."""
    p = F.pad(gray.to(torch.float32)[None, None], (1, 1, 1, 1),
              mode="reflect")[0, 0]
    dx = (p[:-2, 2:] - p[:-2, :-2]) + 2 * (p[1:-1, 2:] - p[1:-1, :-2]) + \
        (p[2:, 2:] - p[2:, :-2])
    dy = (p[2:, :-2] - p[:-2, :-2]) + 2 * (p[2:, 1:-1] - p[:-2, 1:-1]) + \
        (p[2:, 2:] - p[:-2, 2:])
    return dx, dy


def canny(gray: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """cv2.Canny(gray, low, high) (aperture 3, L2gradient False): 0/255
    uint8 edges."""
    _check(gray, (2,))
    low, high = sorted((int(np.floor(low)), int(np.floor(high))))
    dx, dy = _sobel(gray)
    mag = dx.abs() + dy.abs()
    mp = F.pad(mag, (1, 1, 1, 1))  # 0 beyond the border
    ax, ay = dx.abs(), dy.abs() << 15
    tg22x = ax * TG22
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg22x + (ax << 16))
    same_sign = (dx ^ dy) >= 0
    left, right = mp[1:-1, :-2], mp[1:-1, 2:]
    up, down = mp[:-2, 1:-1], mp[2:, 1:-1]
    diag = torch.where(same_sign,
                       (mag > mp[:-2, :-2]) & (mag > mp[2:, 2:]),
                       (mag > mp[:-2, 2:]) & (mag > mp[2:, :-2]))
    keep = torch.where(horizontal, (mag > left) & (mag >= right),
                       torch.where(vertical, (mag > up) & (mag >= down), diag))
    cand = keep & (mag > low)
    strong = cand & (mag > high)
    labels = cc.label_components(cand.to(torch.uint8), 8)
    has_strong = torch.zeros(labels.numel() + 1, dtype=torch.bool,
                             device=gray.device)
    has_strong[labels[strong]] = True
    return (cand & has_strong[labels]).to(torch.uint8) * 255


def filter2d_u8(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.filter2D(img, -1, kernel) on (H, W) or (H, W, C) uint8, anchor at
    the kernel's centre, BORDER_REFLECT_101."""
    _check(img, (2, 3))
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    p = _pad_reflect101(img, ay, kh - 1 - ay, ax, kw - 1 - ax).float()
    acc = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j]:
                acc = acc + float(np.float32(kernel[i, j])) * \
                    p[i:i + h, j:j + w]
    return torch.round(acc).clamp(0, 255).to(torch.uint8)


# --------------------------------------------------------------------------
# region rasterization on the host (cv2.rectangle filled, cv2.fillPoly)
# --------------------------------------------------------------------------
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def fill_rect(mask: np.ndarray, x: int, y: int, w: int, h: int,
              value: int = 255) -> None:
    """cv2.rectangle(mask, (x, y), (x + w, y + h), value, -1): both corners
    included, clipped to the mask."""
    x0, x1 = sorted((x, x + w))
    y0, y1 = sorted((y, y + h))
    mh, mw = mask.shape[:2]
    mask[max(y0, 0):max(min(y1 + 1, mh), 0),
         max(x0, 0):max(min(x1 + 1, mw), 0)] = value


def _clip_line(w: int, h: int, p1, p2):
    """cv2.clipLine(Size(w, h), p1, p2): (visible, p1, p2)."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _trunc_div((a - y1) * (x2 - x1), (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _trunc_div((a - y2) * (x2 - x1), (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _trunc_div((a - x1) * (y2 - y1), (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _trunc_div((a - x2) * (y2 - y1), (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _trunc_div(a: int, b: int) -> int:
    """C integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line8(mask: np.ndarray, p1, p2, value: int) -> None:
    """cv2's Line with 8-connectivity (LineIterator, left to right)."""
    h, w = mask.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        ok, p1, p2 = _clip_line(w, h, p1, p2)
        if not ok:
            return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus, minus = dx + dx, -(dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = value
        diagonal = err < 0
        err += minus + (plus if diagonal else 0)
        if vert:
            y += sy
            x += sx if diagonal else 0
        else:
            x += sx
            y += sy if diagonal else 0


def fill_poly(mask: np.ndarray, pts, value: int = 255) -> None:
    """cv2.fillPoly(mask, [pts], value) for one int32 polygon (shift 0,
    LINE_8): the outline drawn with 8-connected lines, then cv2's scanline
    fill of the edge list. As cv2 5.0's CollectPolyEdges, an edge that
    leaves the mask takes its x and dx from the clipped line's endpoints
    (dx 0 where the clipped line is one row or is not visible), and keeps
    its unclipped rows; the fill clamps each row's span to the mask."""
    h, w = mask.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        _line8(mask, (x0, y0), (x1, y1), value)
        t0, t1 = (x0, y0), (x1, y1)
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h
                and 0 <= y1 < h):
            _, t0, t1 = _clip_line(w, h, t0, t1)
        if y0 != y1:
            dxe = 0
            if t0[1] != t1[1]:
                dxe = _trunc_div((t1[0] - t0[0]) << XY_SHIFT, t1[1] - t0[1])
            if y0 < y1:
                edges.append([y0, y1, (t0[0] << XY_SHIFT)
                              + (y0 - t0[1]) * dxe, dxe])
            else:
                edges.append([y1, y0, (t1[0] << XY_SHIFT)
                              + (y1 - t1[1]) * dxe, dxe])
        x0, y0 = x1, y1
    _fill_edges(mask, edges, value)


def _fill_edges(mask: np.ndarray, edges, value: int) -> None:
    """cv2's FillEdgeCollection for LINE_8: edges are [y0, y1, x, dx] with x
    in 16.16 fixed point at row y0; the active list is kept sorted by x, and
    each row fills the pairs' spans from ceil(left) to floor(right), cv2
    5.0's rule (4.x added half a pixel and floored both ends)."""
    h, w = mask.shape[:2]
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    pending = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    active: list = []
    y_max = min(y_max, h)
    k = 0
    for y in range(pending[0][0], y_max):
        active = [e for e in active if e[1] != y]
        while k < len(pending) and pending[k][0] == y:
            e = pending[k]
            pos = 0
            while pos < len(active) and active[pos][2] < e[2]:
                pos += 1
            active.insert(pos, e)
            k += 1
        for left, right in zip(active[0::2], active[1::2]):
            if y >= 0:
                a, b = sorted((left[2], right[2]))
                x1, x2 = (a + XY_ONE - 1) >> XY_SHIFT, b >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    mask[y, max(x1, 0):min(x2, w - 1) + 1] = value
            left[2] += left[3]
            right[2] += right[3]
        active.sort(key=lambda e: e[2])


# --------------------------------------------------------------------------
# antialiased drawing on host numpy images (cv2's LINE_AA), and
# cv2.GaussianBlur on float32 with the small kernels
# --------------------------------------------------------------------------
# drawing.cpp's tables: the slope correction and the 3-row line filter
# (cv2 5.0's filter tail, entries 48-63, read back from its output)
SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192,
              194, 196, 198, 201, 203, 206, 209, 211, 214, 218, 221, 224,
              227, 231, 235, 238, 242, 246, 250, 254)
AA_FILTER = (168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246,
             249, 252, 254, 254, 254, 254, 252, 249, 246, 241, 236, 231,
             224, 218, 210, 202, 194, 185, 177, 168, 158, 149, 140, 131,
             122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45, 40, 36, 32,
             28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5)
# sin of 0..450 degrees, drawing.cpp's SinTable: 7 decimals, as floats
SIN_TABLE = np.float32(np.round(np.sin(np.deg2rad(np.arange(451))), 7))


def _blend_aa(img: np.ndarray, xs, ys, alphas, color) -> None:
    """LineAA's ICV_PUT_POINT at pixels that are all distinct: each channel
    moves toward the colour by ((c - p) * a + 127) >> 8, twice."""
    if not xs:
        return
    ys, xs = np.asarray(ys), np.asarray(xs)
    a = np.asarray(alphas, np.int64)[:, None]
    c = np.asarray(color, np.int64)[None, :img.shape[2]]
    p = img[ys, xs].astype(np.int64)
    p = p + (((c - p) * a + 127) >> 8)
    img[ys, xs] = p + (((c - p) * a + 127) >> 8)


def line_aa(img: np.ndarray, p1, p2, color) -> None:
    """drawing.cpp's LineAA on an (H, W, C) uint8 image, the endpoints in
    16.16 fixed point: the line clipped to the image, 3 pixels across each
    step along its major axis, weighted by the filter table and the slope
    correction, with the end-point corrections."""
    h, w = img.shape[:2]
    ok, p1, p2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not ok:
        return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    major_x = ax > ay
    if major_x:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _trunc_div(dy << XY_SHIFT, ax | 1)
        x2 += XY_ONE
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
        y1 += ((step * -(x1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
        i, j = (x1 >> (XY_SHIFT - 7)) & 0x78, (x2 >> (XY_SHIFT - 7)) & 0x78
        along, across = x1, y1
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _trunc_div(dx << XY_SHIFT, ay | 1)
        y2 += XY_ONE
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
        x1 += ((step * -(y1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
        i, j = (y1 >> (XY_SHIFT - 7)) & 0x78, (y2 >> (XY_SHIFT - 7)) & 0x78
        along, across = y1, x1
    slope = ((step >> (XY_SHIFT - 5)) & 0x3f) ^ (0x3f if step < 0 else 0)
    slope = 0x100 if slope & 0x20 else SLOPE_CORR[slope]
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    ep = [0, 0, (t1 >> 8) & 0x1ff, 0,
          ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff,
          ((t1 + t0) >> 8) & 0x1ff, (t2 >> 8) & 0x1ff,
          ((t2 + t0) >> 8) & 0x1ff, slope]
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff
    n_along, n_across = (w, h) if major_x else (h, w)
    pos = along >> XY_SHIFT
    us, vs, alphas = [], [], []
    scount = 0
    while ecount >= 0:
        if 0 <= pos < n_along:
            v = (across >> XY_SHIFT) - 1
            corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3
                      + (((ecount >= 2) + 1) & (ecount | 2))]
            dist = (across >> (XY_SHIFT - 5)) & 31
            for k, f in ((0, AA_FILTER[dist + 32]), (1, AA_FILTER[dist]),
                         (2, AA_FILTER[63 - dist])):
                if 0 <= v + k < n_across:
                    us.append(pos)
                    vs.append(v + k)
                    alphas.append((corr * f >> 8) & 0xff)
        pos += 1
        across += step
        scount += 1
        ecount -= 1
    if major_x:
        _blend_aa(img, us, vs, alphas, color)
    else:
        _blend_aa(img, vs, us, alphas, color)


def ellipse_poly(center, axes, angle: int, delta: int
                 ) -> List[Tuple[float, float]]:
    """cv2.ellipse2Poly's double form for the whole ellipse (arc 0-360):
    its points every `delta` degrees, from the SinTable, in double."""
    angle %= 360
    beta, alpha = float(SIN_TABLE[angle]), float(SIN_TABLE[450 - angle])
    pts = []
    for a in range(0, 360 + delta, delta):
        a = min(a, 360)
        x = axes[0] * float(SIN_TABLE[450 - a])
        y = axes[1] * float(SIN_TABLE[a])
        pts.append((center[0] + x * alpha - y * beta,
                    center[1] + x * beta + y * alpha))
    return pts


def _ellipse_filled_fixed(img: np.ndarray, center, axes, angle: int,
                          color) -> None:
    """EllipseEx(..., 0, 360, thickness -1, LINE_AA), center and axes in
    16.16: the polygon of ellipse_poly, vertices rounded to the fixed-point
    grid as cv2 rounds them, then fill_convex_poly_aa."""
    axes = (abs(axes[0]), abs(axes[1]))
    delta = (max(axes) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 \
        else 5
    v, prev = [], None
    for fx, fy in ellipse_poly((float(center[0]), float(center[1])),
                               (float(axes[0]), float(axes[1])), angle,
                               delta):
        px = int(np.rint(fx / XY_ONE)) << XY_SHIFT
        py = int(np.rint(fy / XY_ONE)) << XY_SHIFT
        pt = (px + int(np.rint(fx - px)), py + int(np.rint(fy - py)))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [tuple(center)] * 2
    fill_convex_poly_aa(img, v, color)


def fill_convex_poly_aa(img: np.ndarray, v, color) -> None:
    """drawing.cpp's FillConvexPoly with LINE_AA, vertices in 16.16: the
    outline with line_aa, then the two-edge scanline fill from the topmost
    vertex, each span [(xl + 1 - 2^-16) floor, xr floor]."""
    h, w = img.shape[:2]
    n = len(v)
    p0 = v[-1]
    for p in v:
        line_aa(img, p0, p, color)
        p0 = p
    half = XY_ONE >> 1
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + half) >> XY_SHIFT, (max(xs) + half) >> XY_SHIFT
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymin >= h or xmin >= w:
        return
    ymax = min(ymax, h - 1)
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    y, edges = ymin, n
    fill = np.asarray(color, np.uint8)[:img.shape[2]]
    while True:
        if y < ymax or y == ymin:
            for e in edge:  # [idx, di, x, dx, ye]
                if y < e[4]:
                    continue
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + half) >> XY_SHIFT
                    if ty > y:
                        xs0, xe = v[idx0][0], v[idx][0]
                        e[2:] = [xs0, _trunc_div((xe - xs0) * 2 + (ty - y),
                                                 2 * (ty - y)), ty]
                        e[0] = idx
                        break
                    idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted((edge[0][2], edge[1][2]))
            x1, x2 = (left + XY_ONE - 1) >> XY_SHIFT, right >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = fill
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def ellipse_filled_aa(img: np.ndarray, center, axes, angle: float,
                      color) -> None:
    """cv2.ellipse(img, center, axes, angle, 0, 360, color, -1, LINE_AA)
    with integer center and axes (shift 0)."""
    _ellipse_filled_fixed(img, (center[0] << XY_SHIFT, center[1] << XY_SHIFT),
                          (axes[0] << XY_SHIFT, axes[1] << XY_SHIFT),
                          int(np.rint(angle)), color)


def line_thick_aa(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """cv2.line(img, p0, p1, color, thickness, LINE_AA) (shift 0):
    thickness 1 is line_aa; a thicker line is drawing.cpp's ThickLine, the
    quad of half-width (t/2, plus half a pixel where t is odd) filled by
    fill_convex_poly_aa, then a filled circle of radius t/2 at each end."""
    p0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    p1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    if thickness <= 1:
        line_aa(img, p0, p1, color)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / np.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        fill_convex_poly_aa(img, [(p0[0] + ox, p0[1] + oy),
                                  (p0[0] - ox, p0[1] - oy),
                                  (p1[0] - ox, p1[1] - oy),
                                  (p1[0] + ox, p1[1] + oy)], color)
    for c in (p0, p1):
        _ellipse_filled_fixed(img, c, (thickness, thickness), 0, color)


def fill_poly_aa(img: np.ndarray, pts, color) -> None:
    """cv2.fillPoly(img, [pts], color, LINE_AA) for one int32 polygon
    (shift 0): each edge drawn with line_aa, then the edge-list fill with
    cv2 5.0's spans (_fill_edges), edges at the unrounded fixed-point x."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        line_aa(img, (x0 << XY_SHIFT, y0 << XY_SHIFT),
                (x1 << XY_SHIFT, y1 << XY_SHIFT), color)
        if y0 != y1:
            dxe = _trunc_div((x1 - x0) << XY_SHIFT, y1 - y0)
            edges.append([y0, y1, x0 << XY_SHIFT, dxe] if y0 < y1
                         else [y1, y0, x1 << XY_SHIFT, dxe])
        x0, y0 = x1, y1
    _fill_edges(img, edges, np.asarray(color, np.uint8)[:img.shape[2]])


# cv2.getGaussianKernel's fixed kernels for ksize 3, 5, 7 with sigma <= 0
SMALL_GAUSSIAN = {3: (0.25, 0.5, 0.25),
                  5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
                  7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875,
                      0.109375, 0.03125)}


def _symm_pass(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    r = len(k) // 2
    n = x.shape[axis]
    idx = np.abs(np.arange(-r, n + r))
    idx = np.where(idx > n - 1, 2 * (n - 1) - idx, idx)  # reflect-101
    xp = np.take(x, idx, axis=axis)

    def tap(o):
        return np.take(xp, np.arange(o, o + n), axis=axis)

    s = tap(r) * k[r]
    for j in range(1, r + 1):
        s = s + (tap(r - j) + tap(r + j)) * k[r + j]
    return s


def gaussian_blur_f32(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (k, k), 0) on a float32 (H, W[, C]) host
    array, k in 3, 5, 7: the fixed kernel, BORDER_REFLECT_101, rows then
    columns, each output k_c x_c + (x_-1 + x_1) k_1 + ... in float32.
    Equal to cv2 for k = 3; for 5 and 7 cv2's vector order differs on a
    share of the values by one float32 ulp (ROADMAP.md, stated
    differences)."""
    k = np.asarray(SMALL_GAUSSIAN[ksize], np.float32)
    x = np.asarray(img, np.float32)
    return _symm_pass(_symm_pass(x, k, 1), k, 0)


def gaussian_kernel_q8(ksize: int, sigma: float) -> np.ndarray:
    """The taps cv2.GaussianBlur uses on 8-bit images (ksize odd, sigma >
    0), in units of 2^-8: getGaussianKernelBitExact's normalized taps, in
    double, rounded from the outermost inwards with the rounding error
    carried to the next tap (getGaussianKernelFixedPoint_ED); the centre
    takes what makes the sum 256."""
    half = (ksize - 1) // 2
    x = np.arange(1 - ksize, 0, 2, dtype=np.float64)[:half]
    vals = np.exp(x * x * (-0.125 / (sigma * sigma)))
    total = 0.0
    for v in vals.tolist():
        total += v
    mul = 1.0 / (total * 2.0 + 1.0)
    taps, err = [], 0.0
    for v in vals.tolist():
        adj = v * mul * 256.0 + err
        q = int(np.rint(adj))
        err = adj - q
        taps.append(q)
    return np.asarray(taps + [256 - 2 * sum(taps)] + taps[::-1], np.int64)


def gaussian_blur_u8(img: torch.Tensor, ksize: int, sigma: float
                     ) -> torch.Tensor:
    """cv2.GaussianBlur(img, (k, k), sigma) on an (H, W) uint8 tensor, k
    odd and sigma > 0, BORDER_REFLECT_101: cv2's fixed-point path in exact
    integers, rows then columns, (sum_j k_j sum_i k_i x + 2^15) >> 16 with
    the taps of gaussian_kernel_q8."""
    k = gaussian_kernel_q8(ksize, sigma).tolist()
    r = ksize // 2
    h, w = img.shape
    p = _pad_reflect101(img, r, r, r, r).to(torch.int32)
    rows = k[0] * p[:, :w]
    for i in range(1, ksize):
        rows = rows + k[i] * p[:, i:i + w]
    out = k[0] * rows[:h]
    for j in range(1, ksize):
        out = out + k[j] * rows[j:j + h]
    return ((out + (1 << 15)) >> 16).to(torch.uint8)
