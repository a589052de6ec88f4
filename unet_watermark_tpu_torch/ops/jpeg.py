"""The JPEG pixel stage as torch integer ops on the coefficients' device:
libjpeg-turbo 3.1's output stage under cv2.imread, bit for bit, run on all
of an image's blocks at once.

  block smoothing    jdcoefct.c decompress_smooth_data, where
                     utils/jpeg.block_smoothing says libjpeg-turbo 3.1
                     applies it (a progressive file cut before its last
                     scan): zero coefficients of zigzag 1..9 that are not
                     exact get estimates from the 5 x 5 block DCs around
                     them, and the DC too where no AC scan has begun; a
                     stencil over the quantized coefficients of all blocks
  dequantize + IDCT  the islow IDCT (CONST_BITS 13, PASS1_BITS 2, the
                     column pass then the row pass, the final descale and
                     the +128 level shift) as libjpeg-turbo's SIMD code
                     computes it in 16-bit lanes: the products and some
                     sums wrap, each pass saturates, the DC-only column
                     shortcut shifts in 16 bits; one IDCT over every
                     block of every component
  upsample           jdsample.c's choice per component: fancy (triangle)
                     h2v1 and h2v2 where the downsampled width is over 2,
                     fancy h1v2, plain replication otherwise (h2v1/h2v2 at
                     width <= 2, 4:1:1 and other integer factors); the rows
                     above the first and below the last real row repeat
                     them (jdmainct.c's context rows)
  colour             jdcolor.c's fixed-point YCbCr -> RGB tables
                     (SCALEBITS 16, ONE_HALF rounding), RGB and gray
                     copies; a colour file read as gray is its Y plane
                     (JCS_GRAYSCALE output), an RGB one read as gray goes
                     through rgb_gray_convert's weights
  orientation        EXIF 2-8 as cv2's ExifTransform applies them

decode(header, coefs, gray) takes utils/jpeg.parse's header and the
entropy decoder's coefficient arrays (tensors on the output's device).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..utils import jpeg

CONST_BITS, PASS1_BITS = 13, 2
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
# jidctint.c's FIX() constants
F0_298, F0_390, F0_541, F0_765 = 2446, 3196, 4433, 6270
F0_899, F1_175, F1_501, F1_847 = 7373, 9633, 12299, 15137
F1_961, F2_053, F2_562, F3_072 = 16069, 16819, 20995, 25172


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """int32 values taken mod 2^16 as int16 (a 16-bit lane's add or
    multiply)."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(c: Sequence[torch.Tensor]):
    """jidctint.c's even and odd parts on the 8 inputs of one pass, with
    the sums that the SIMD code forms in 16-bit lanes (in0 +- in4, in7 +
    in3, in5 + in1) wrapped there; the products and the other sums are
    int32 (pmaddwd, paddd), which the scalar grouping below equals mod
    2^32. Returns the 8 outputs before the pass's descale."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * F0_541
    tmp2 = z1 + z3 * -F1_847
    tmp3 = z1 + z2 * F0_765
    tmp0 = _wrap16(c[0] + c[4]) << CONST_BITS
    tmp1 = _wrap16(c[0] - c[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2 = t0 + t3, t1 + t2
    z3, z4 = _wrap16(t0 + t2), _wrap16(t1 + t3)
    z5 = (z3 + z4) * F1_175
    t0, t1, t2, t3 = t0 * F0_298, t1 * F2_053, t2 * F3_072, t3 * F1_501
    z1, z2 = z1 * -F0_899, z2 * -F2_562
    z3, z4 = z3 * -F1_961 + z5, z4 * -F0_390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def dequantize(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """(..., 64) int16 coefficients times the (64,) table as pmullw forms
    it: the product's low 16 bits, as int32."""
    return _wrap16(coef.to(torch.int32)
                   * quant.to(torch.int16).to(torch.int32))


def idct_islow(x: torch.Tensor, ac_rows_zero: torch.Tensor) -> torch.Tensor:
    """(..., 64) dequantized coefficients (dequantize) in natural order →
    (..., 8, 8) uint8 samples, as libjpeg-turbo's SIMD islow IDCT
    (jidctint-avx2.asm) computes them in 16-bit lanes: a block whose raw
    coefficients in rows 1..7 are all zero (`ac_rows_zero`, (...,) bool)
    takes the column pass's shortcut, row 0 shifted left by PASS1_BITS in
    16 bits; each pass's descaled outputs saturate to int16, and the
    samples saturate to [-128, 127] before the +128 level shift. On the
    values a real file gives this equals jidctint.c with its range-limit
    table; where a cut file's zero bits decode to coefficients far out of
    range, it is what cv2.imread gives."""
    x = x.view(*x.shape[:-1], 8, 8)  # rows: vertical frequency
    # pass 1: columns (the 8 inputs of a column are its 8 rows)
    ws = _idct_1d([x[..., k, :] for k in range(8)])
    ws = torch.stack([_descale(w, CONST_BITS - PASS1_BITS)
                      .clamp(-32768, 32767) for w in ws], dim=-2)
    dc = _wrap16(x[..., :1, :] << PASS1_BITS).expand_as(ws)
    ws = torch.where(ac_rows_zero[..., None, None], dc, ws)
    # pass 2: rows
    out = _idct_1d([ws[..., :, k] for k in range(8)])
    out = torch.stack([_descale(o, CONST_BITS + PASS1_BITS + 3)
                       for o in out], dim=-1)
    return (out.clamp(-128, 127) + 128).to(torch.uint8)


# jdcoefct.c's estimates: (zigzag index, natural position, kernel over the
# 5 x 5 block DCs for a DC-only latch, kernel otherwise); rows of 5 are the
# block rows -2..+2, columns -2..+2. The last four and the DC are estimated
# only for a DC-only latch.
_K = {
    "ac01_dc": ((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3),
                (-3, 13, 0, -13, 3), (-1, -1, 0, 1, 1)),
    "ac01": ((0,) * 5, (0,) * 5, (-7, 50, 0, -50, 7), (0,) * 5, (0,) * 5),
    "ac20_dc": ((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0),
                (0, 2, 7, 2, 0), (0, 0, 1, 0, 0)),
    "ac20": ((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0),
             (0, 0, 13, 0, 0), (0, 0, -1, 0, 0)),
    "ac11_dc": ((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), (0,) * 5,
                (0, -9, 0, 9, 0), (1, 0, 0, 0, -1)),
    "ac11": ((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), (0,) * 5,
             (1, -10, 0, 10, -1), (0, 1, 0, -1, 0)),
    "ac03": ((0,) * 5, (0, 1, 0, -1, 0), (0, 2, 0, -2, 0), (0, 1, 0, -1, 0),
             (0,) * 5),
    "ac12": ((0,) * 5, (0, 1, -3, 1, 0), (0,) * 5, (0, -1, 3, -1, 0),
             (0,) * 5),
    "dc": ((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6), (-8, 42, 152, 42, -8),
           (-6, 6, 42, 6, -6), (-2, -6, -8, -6, -2)),
}


def _t(k):
    return tuple(zip(*k))


# zigzag 1..9 in jdcoefct.c's order; AC10, AC02, AC21, AC30 are the
# transposes of AC01, AC20, AC12, AC03
_SMOOTH = (
    (1, 1, _K["ac01_dc"], _K["ac01"]),
    (2, 8, _t(_K["ac01_dc"]), _t(_K["ac01"])),
    (3, 16, _K["ac20_dc"], _K["ac20"]),
    (4, 9, _K["ac11_dc"], _K["ac11"]),
    (5, 2, _t(_K["ac20_dc"]), _t(_K["ac20"])),
    (6, 3, _K["ac03"], None),
    (7, 10, _K["ac12"], None),
    (8, 17, _t(_K["ac12"]), None),
    (9, 24, _t(_K["ac03"]), None),
)


def _neighbour_rows(comp, rows: int) -> List[List[int]]:
    """Block rows -2..+2 of each block row, as decompress_smooth_data picks
    them: an absent row repeats the nearer one, with its image_block_row
    counted in the last iMCU row's own block rows."""
    v = comp.v
    hib = -(-comp.height // 8)
    last_rows = hib % v or v
    out = []
    for r in range(hib):
        m, br = divmod(r, v)
        block_rows = v if m < rows - 1 else last_rows
        ib, ibs = m * block_rows + br, block_rows * rows
        p1 = r - 1 if ib > 0 else r
        p2 = r - 2 if ib > 1 else p1
        n1 = r + 1 if ib < ibs - 1 else r
        n2 = r + 2 if ib < ibs - 2 else n1
        out.append([p2, p1, r, n1, n2])
    return out


def smooth(coef: torch.Tensor, comp, quant, rows: int, cur, prev,
           last_good_row: int) -> torch.Tensor:
    """jdcoefct.c decompress_smooth_data on one component's (bh, bw, 64)
    quantized coefficients: every real block's zero coefficients of
    zigzag 1..9 that its latch says are not exact get an estimate from
    the 5 x 5 DCs around it (edges repeated), clipped below 2^Al; with a
    DC-only latch (1..9 all -1) the DC is replaced by a Gaussian-like mean
    too. Block rows in iMCU rows past last_good_row take `prev`."""
    hib, wib = -(-comp.height // 8), -(-comp.width // 8)
    dev = coef.device
    rsel = torch.tensor(_neighbour_rows(comp, rows), device=dev)  # (hib, 5)
    cols = torch.arange(wib, device=dev)
    csel = torch.stack([(cols + d).clamp(0, wib - 1) for d in range(-2, 3)],
                       1)  # (wib, 5)
    dc = coef[..., 0].long()
    grid = dc[rsel[:, :, None, None], csel[None, None, :, :]]
    grid = grid.permute(0, 2, 1, 3)  # (hib, wib, 5 rows, 5 cols)
    q = [int(quant[p]) for p in range(64)]
    q00 = q[0]
    full = coef.clone()
    # the block rows of iMCU rows up to last_good_row take `cur`
    split = min(hib, (last_good_row + 1) * comp.v)
    for latch, lo, hi in ((cur, 0, split), (prev, split, hib)):
        if lo == hi:
            continue
        change_dc = all(b == -1 for b in latch[1:10])
        blk = coef[lo:hi, :wib]
        g = grid[lo:hi]
        new = blk.clone()
        for zz, pos, k_dc, k_ac in _SMOOTH:
            al = latch[zz]
            kernel = k_dc if change_dc else k_ac
            if al == 0 or kernel is None:
                continue
            num = q00 * (g * torch.tensor(kernel, device=dev)).sum((-2, -1))
            qk = q[pos]
            pred = ((qk << 7) + num.abs()) // (qk << 8)
            if al > 0:
                pred = pred.clamp(max=(1 << al) - 1)
            pred = torch.where(num < 0, -pred, pred)
            new[..., pos] = torch.where(blk[..., pos] == 0, pred.to(blk.dtype),
                                        blk[..., pos])
        if change_dc:
            num = q00 * (g * torch.tensor(_K["dc"], device=dev)).sum((-2, -1))
            pred = ((q00 << 7) + num.abs()) // (q00 << 8)
            new[..., 0] = torch.where(num < 0, -pred, pred).to(blk.dtype)
        full[lo:hi, :wib] = new
    return full


def _planes(header, coefs: Sequence[torch.Tensor], needed) -> dict:
    """The needed components' samples, {index: (height, width) int32},
    from one IDCT over all of their blocks."""
    comps = header.components
    smoothing = jpeg.block_smoothing(header)
    x, zero = [], []
    for ci in needed:
        if smoothing is not None and smoothing.cur[ci] is not None:
            coefs = list(coefs)
            coefs[ci] = smooth(coefs[ci], comps[ci], comps[ci].quant,
                               header.mcuy, smoothing.cur[ci],
                               smoothing.prev[ci], smoothing.last_good_row)
        quant = comps[ci].quant
        quant = torch.zeros(64, dtype=torch.int32) if quant is None else \
            torch.from_numpy(quant)
        x.append(dequantize(coefs[ci], quant.to(coefs[ci].device)
                            ).reshape(-1, 64))
        zero.append((coefs[ci].reshape(-1, 8, 8)[:, 1:] == 0)
                    .flatten(1).all(1))
    px = idct_islow(torch.cat(x), torch.cat(zero))  # (blocks, 8, 8)
    planes, start = {}, 0
    for ci in needed:
        comp = comps[ci]
        bh, bw = coefs[ci].shape[:2]
        blk = px[start:start + bh * bw].view(bh, bw, 8, 8)
        start += bh * bw
        planes[ci] = blk.permute(0, 2, 1, 3).reshape(bh * 8, bw * 8)[
            :comp.height, :comp.width].to(torch.int32)
    return planes


def _h2v1_fancy(x: torch.Tensor) -> torch.Tensor:
    """jdsample.c h2v1_fancy_upsample: (h, w) → (h, 2w), w > 2."""
    left = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    right = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    even = (3 * x + left + 1) >> 2
    odd = (3 * x + right + 2) >> 2
    even[:, 0] = x[:, 0]
    odd[:, -1] = x[:, -1]
    return torch.stack([even, odd], dim=-1).reshape(x.shape[0], -1)


def _vertical_sums(x: torch.Tensor):
    """3 * nearer row + further row, for the output row above (row above
    as the further one) and below each input row; the first and last real
    rows stand in for the rows beyond them."""
    up = torch.cat([x[:1], x[:-1]], dim=0)
    down = torch.cat([x[1:], x[-1:]], dim=0)
    return 3 * x + up, 3 * x + down


def _h1v2_fancy(x: torch.Tensor) -> torch.Tensor:
    """jdsample.c h1v2_fancy_upsample: (h, w) → (2h, w)."""
    above, below = _vertical_sums(x)
    return torch.stack([(above + 1) >> 2, (below + 2) >> 2],
                       dim=1).reshape(-1, x.shape[1])


def _h2v2_fancy(x: torch.Tensor) -> torch.Tensor:
    """jdsample.c h2v2_fancy_upsample: (h, w) → (2h, 2w), w > 2."""
    rows = []
    for colsum in _vertical_sums(x):
        last = torch.cat([colsum[:, :1], colsum[:, :-1]], dim=1)
        nxt = torch.cat([colsum[:, 1:], colsum[:, -1:]], dim=1)
        even = (3 * colsum + last + 8) >> 4
        odd = (3 * colsum + nxt + 7) >> 4
        even[:, 0] = (colsum[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (colsum[:, -1] * 4 + 7) >> 4
        rows.append(torch.stack([even, odd], dim=-1).reshape(x.shape[0], -1))
    return torch.stack(rows, dim=1).reshape(2 * x.shape[0], -1)


def upsample(x: torch.Tensor, hexp: int, vexp: int) -> torch.Tensor:
    """A component's samples expanded by (hexp, vexp) with the method
    jinit_upsampler picks (fancy upsampling on)."""
    if hexp == 1 and vexp == 1:
        return x
    if hexp == 2 and vexp == 1 and x.shape[1] > 2:
        return _h2v1_fancy(x)
    if hexp == 1 and vexp == 2:
        return _h1v2_fancy(x)
    if hexp == 2 and vexp == 2 and x.shape[1] > 2:
        return _h2v2_fancy(x)
    return x.repeat_interleave(vexp, 0).repeat_interleave(hexp, 1)


def _ycc_tables(device) -> List[torch.Tensor]:
    x = torch.arange(256, dtype=torch.int64, device=device) - 128
    cr_r = (_fix(1.40200) * x + ONE_HALF) >> SCALEBITS
    cb_b = (_fix(1.77200) * x + ONE_HALF) >> SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + ONE_HALF
    return [t.to(torch.int32) for t in (cr_r, cb_b, cr_g, cb_g)]


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
               ) -> torch.Tensor:
    """jdcolor.c ycc_rgb_convert on int32 planes → (H, W, 3) uint8."""
    cr_r, cb_b, cr_g, cb_g = _ycc_tables(y.device)
    cb, cr = cb.long(), cr.long()
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> SCALEBITS)
    b = y + cb_b[cb]
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def rgb_to_gray(r, g, b) -> torch.Tensor:
    """jdcolor.c rgb_gray_convert on int32 planes → uint8."""
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + ONE_HALF) >> SCALEBITS
    return y.to(torch.uint8)


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """cv2's ExifTransform on an (H, W) or (H, W, C) image."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(0, 1)
    flips = {2: [1], 3: [0, 1], 4: [0], 6: [1], 7: [0, 1], 8: [0]}
    dims = flips.get(orientation)
    return img.flip(dims) if dims else img.contiguous()


def decode(header, coefs: Sequence[torch.Tensor], gray: bool = False
           ) -> torch.Tensor:
    """The image as cv2.imread gives it (RGB): (H, W, 3) uint8, or (H, W)
    with gray=True, on the coefficients' device, oriented."""
    comps = header.components
    h, w = header.height, header.width
    needed = [0] if gray and header.color == "ycc" else range(len(comps))
    planes = _planes(header, coefs, needed)
    for ci in needed:
        planes[ci] = upsample(planes[ci], header.hmax // comps[ci].h,
                              header.vmax // comps[ci].v)[:h, :w]
    if header.color == "gray":
        y = planes[0].to(torch.uint8)
        img = y if gray else y[..., None].expand(h, w, 3)
    elif header.color == "ycc":
        img = planes[0].to(torch.uint8) if gray else \
            ycc_to_rgb(planes[0], planes[1], planes[2])
    else:  # RGB
        img = rgb_to_gray(planes[0], planes[1], planes[2]) if gray else \
            torch.stack([planes[i] for i in range(3)],
                        dim=-1).to(torch.uint8)
    return orient(img, header.orientation)
