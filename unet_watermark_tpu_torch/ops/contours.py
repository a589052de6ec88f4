"""cv2's contour functions on host numpy arrays, as the blurred training
masks (data/dataset.py) call them, reproduced against cv2 5.0.0
(tests/test_torch_blurred_mask.py):

  find_external_contours  findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE):
                          Suzuki-Abe border following on a copy padded by
                          one zero pixel, cv2's raster scan with its
                          last-border rule (a new outer border starts only
                          where the last border pixel met on the row is not
                          a marked left border), each border traced from its
                          first pixel in raster order with cv2's neighbour
                          order and its marks (2, and -126 for a pixel whose
                          east neighbour was examined); a point is kept where
                          the chain code changes. The list is in cv2's
                          order: the reverse of discovery.
  contour_area            contourArea: the shoelace sum in double over the
                          points as float32, the last point first.
  convex_hull             convexHull(clockwise=False): Sklansky's scan of
                          the points sorted by x then y, upper and lower
                          halves, cv2's collinear rule and its cyclic shift
                          toward ascending input indices.
  arc_length              arcLength: float32 differences and square roots,
                          summed in double from the closing edge on.
  approx_poly_dp          approxPolyDP on integer points: Douglas-Peucker
                          with cv2's stack order and cv2 5.0's distance,
                          from the segment rather than its line (4.x used
                          the line); a closed curve starts at cv2's own far
                          point (three rounds of the farthest point from the
                          last one found), then cv2's clean-up pass over
                          nearly straight vertices.

These are sequential walks over a few borders; they run on the host, where
the dataset's mask already is for the fill (ops/imgproc.fill_poly).
Points are int32 arrays of shape (K, 2) as (x, y).
"""
from __future__ import annotations

from typing import List

import numpy as np

# chain code s → (dx, dy), cv2's icvCodeDeltas; y grows downwards
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_MARK = -126  # (schar)(2 | -128): a border pixel seen from its east


def _trace(img: np.ndarray, x0: int, y0: int) -> List[tuple]:
    """icvFetchContour for an outer border starting at (x0, y0) with
    CHAIN_APPROX_SIMPLE; marks the border in `img` (padded coordinates)."""
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        x1, y1 = x0 + _DX[s], y0 + _DY[s]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        img[y0, x0] = _RIGHT_MARK
        return [(x0, y0)]
    pts = []
    x3, y3 = x0, y0
    prev_s = s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            x4, y4 = x3 + _DX[s & 7], y3 + _DY[s & 7]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:
            img[y3, x3] = _RIGHT_MARK
        elif img[y3, x3] == 1:
            img[y3, x3] = 2
        if s != prev_s:
            pts.append((x3, y3))
            prev_s = s
        if x4 == x0 and y4 == y0 and x3 == x1 and y3 == y1:
            return pts
        x3, y3 = x4, y4
        s = (s + 4) & 7


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0] of an
    (H, W) array (nonzero is foreground): a list of (K, 2) int32 (x, y)."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int16)
    img[1:-1, 1:-1] = mask != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        lnbd = 0  # x of the last border pixel met on this row
        x = 1
        while x <= w:
            changes = np.flatnonzero(row[x:w + 1] != row[x - 1:w]) + x
            fetched = False
            for xt in changes.tolist():
                prev, p = int(row[xt - 1]), int(row[xt])
                if prev == 0 and p == 1:
                    if row[lnbd] <= 0:
                        pts = _trace(img, xt, y)
                        found.append(np.asarray(pts, np.int32) - 1)
                        x, fetched = xt + 1, True
                        break
                elif p == 0 and prev >= 1 and prev & -2:
                    lnbd = xt - 1  # a hole's left edge
                if p & -2:
                    lnbd = xt
            if not fetched:
                break
    return found[::-1]


def contour_area(pts: np.ndarray, oriented: bool = False) -> float:
    """cv2.contourArea."""
    p = np.asarray(pts, np.float32).reshape(-1, 2).astype(np.float64)
    if len(p) == 0:
        return 0.0
    a = 0.0
    px, py = p[-1]
    for x, y in p:
        a += px * y - py * x
        px, py = x, y
    a *= 0.5
    return a if oriented else abs(a)


def arc_length(pts: np.ndarray, closed: bool) -> float:
    """cv2.arcLength on integer points."""
    p = np.asarray(pts, np.float32).reshape(-1, 2)
    if len(p) <= 1:
        return 0.0
    prev = p[-1] if closed else p[0]
    d = p - np.concatenate([prev[None], p[:-1]])
    seg = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])  # float32
    total = 0.0
    for v in seg.tolist():
        total += v
    return total


def _sign(v: int) -> int:
    return (v > 0) - (v < 0)


def _sklansky(pt: List[tuple], start: int, end: int, nsign: int,
              sign2: int) -> List[int]:
    """cv2's Sklansky_: the stack of indices into `pt` (sorted points)."""
    incr = 1 if end > start else -1
    if start == end or pt[start] == pt[end]:
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = pt[pcur][1], pt[pnext][1]
        by = nexty - cury
        if _sign(by) != nsign:
            ax = pt[pcur][0] - pt[pprev][0]
            bx = pt[pnext][0] - pt[pcur][0]
            ay = cury - pt[pprev][1]
            convexity = ay * bx - ax * by
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """cv2.convexHull(pts) (clockwise=False, returnPoints=True) of integer
    points: (K, 2) int32."""
    src = [tuple(int(v) for v in q) for q in
           np.asarray(pts).reshape(-1, 2).tolist()]
    total = len(src)
    if total == 0:
        return np.zeros((0, 2), np.int32)
    order = sorted(range(total), key=lambda i: (src[i][0], src[i][1]))
    pt = [src[i] for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if pt[miny][1] > pt[i][1]:
            miny = i
        if pt[maxy][1] < pt[i][1]:
            maxy = i
    if pt[0] == pt[-1]:
        hull = [order[0]]
    else:
        tl = _sklansky(pt, 0, maxy, -1, 1)
        tr = _sklansky(pt, total - 1, maxy, -1, -1)
        tl, tr = tr, tl  # counter-clockwise
        hull = [order[i] for i in tl[:-1]]
        hull += [order[tr[i]] for i in range(len(tr) - 1, 0, -1)]
        stop = (tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1)
        bl = _sklansky(pt, 0, miny, 1, -1)
        br = _sklansky(pt, total - 1, miny, 1, 1)
        if stop >= 0:
            check = (bl[1] if len(bl) > 2 else
                     br[2 - len(bl)] if len(bl) + len(br) > 2 else -1)
            if check == stop or (check >= 0 and pt[check] == pt[stop]):
                # every point on one line: the lower half mirrors the upper
                bl, br = bl[:2], br[:2]
        hull += [order[i] for i in bl[:-1]]
        hull += [order[br[i]] for i in range(len(br) - 1, 0, -1)]
        hull = _ascending_shift(hull)
    return np.asarray([src[i] for i in hull], np.int32).reshape(-1, 2)


def _ascending_shift(hull: List[int]) -> List[int]:
    """cv2's cyclic shift that makes the hull's input indices run in one
    direction where they can."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_i = max_i = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_i]:
            min_i = i
        if idx > hull[max_i]:
            max_i = i
    mmdist = abs(max_i - min_i)
    if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
        ascending = (max_i + 1) % nout == min_i
        i0 = min_i if ascending else max_i
        if i0 > 0:
            out, j = [], i0
            for i in range(nout):
                cur = hull[j]
                out.append(cur)
                nj = j + 1 if j + 1 < nout else 0
                if i < nout - 1 and ascending != (cur < hull[nj]):
                    break
                j = nj
            else:
                return out
    return hull


def approx_poly_dp(pts: np.ndarray, epsilon: float, closed: bool
                   ) -> np.ndarray:
    """cv2.approxPolyDP(pts, epsilon, closed) on integer points: (K, 2)
    int32."""
    src = [tuple(int(v) for v in q) for q in
           np.asarray(pts).reshape(-1, 2).tolist()]
    count = len(src)
    if count == 0:
        return np.zeros((0, 2), np.int32)
    eps = float(epsilon) ** 2
    dst: List[tuple] = []
    stack: List[list] = []
    init_iters = 3
    is_closed = closed
    right = [0, 0]
    pos = 0
    if not is_closed:
        right[0] = count
        if src[count - 1] != src[0]:
            stack.append([0, count - 1])
        else:
            is_closed, init_iters = True, 1
    if is_closed:
        right[0] = 0
        le_eps = False
        for _ in range(init_iters):
            max_dist = 0.0
            pos = (pos + right[0]) % count
            start = src[pos]
            pos = (pos + 1) % count
            for j in range(1, count):
                q = src[pos]
                pos = (pos + 1) % count
                dx, dy = float(q[0] - start[0]), float(q[1] - start[1])
                dist = dx * dx + dy * dy
                if dist > max_dist:
                    max_dist, right[0] = dist, j
            le_eps = max_dist <= eps
        if not le_eps:
            s0 = pos % count
            right[1] = s0
            s1 = (right[0] + s0) % count
            right[0] = s1
            stack.append(list(right))
            stack.append([s0, s1])
        else:
            dst.append(start)
    while stack:
        s_start, s_end = stack.pop()
        end = src[s_end]
        pos = s_start
        start = src[pos]
        pos = (pos + 1) % count
        if pos != s_end:
            dx, dy = float(end[0] - start[0]), float(end[1] - start[1])
            max_dist = 0.0
            seg2 = dx * dx + dy * dy
            while pos != s_end:
                q = src[pos]
                pos = (pos + 1) % count
                dist = _segment_dist2(q, start, end, dx, dy, seg2)
                if dist > max_dist:
                    max_dist = dist
                    right[0] = (pos + count - 1) % count
            le_eps = max_dist <= eps * seg2
        else:
            le_eps = True
            start = src[s_start]
        if le_eps:
            dst.append(start)
        else:
            stack.append([right[0], s_end])
            stack.append([s_start, right[0]])
    if not is_closed:
        dst.append(src[count - 1])
    return np.asarray(_clean_up(dst, closed, eps), np.int32).reshape(-1, 2)


def _segment_dist2(q, start, end, dx, dy, seg2) -> float:
    """The squared distance of q from the segment start-end, times the
    segment's squared length (exact in double for image coordinates)."""
    qx, qy = q[0] - start[0], q[1] - start[1]
    t = qx * dx + qy * dy
    if t <= 0:
        return float(qx * qx + qy * qy) * seg2
    if t >= seg2:
        ex, ey = q[0] - end[0], q[1] - end[1]
        return float(ex * ex + ey * ey) * seg2
    cross = qy * dx - qx * dy
    return cross * cross


def _clean_up(dst: List[tuple], closed: bool, eps: float) -> List[tuple]:
    """approxPolyDP's last pass: drop a vertex on a nearly straight,
    forward-going diagonal run."""
    dst = list(dst)
    count = new_count = len(dst)
    pos = count - 1 if closed else 0
    start = dst[pos]
    pos = (pos + 1) % count
    wpos = pos
    pt = dst[pos]
    pos = (pos + 1) % count
    i = 0 if closed else 1
    while i < count - (0 if closed else 1) and new_count > 2:
        end = dst[pos]
        pos = (pos + 1) % count
        dx, dy = float(end[0] - start[0]), float(end[1] - start[1])
        dist = abs((pt[0] - start[0]) * dy - (pt[1] - start[1]) * dx)
        inner = ((pt[0] - start[0]) * (end[0] - pt[0])
                 + (pt[1] - start[1]) * (end[1] - pt[1]))
        if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0
                and dy != 0 and inner >= 0):
            new_count -= 1
            dst[wpos] = start = end
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start = pt
        wpos = (wpos + 1) % count
        pt = end
        i += 1
    if not closed:
        dst[wpos] = pt
    return dst[:new_count]
