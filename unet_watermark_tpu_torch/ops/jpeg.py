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
                     through rgb_gray_convert's weights. A four-component
                     file comes out of libjpeg as CMYK (cv2 asks for
                     JCS_CMYK): CMYK as stored, YCCK through
                     ycck_cmyk_convert (the YCbCr -> RGB tables on its
                     first three components, inverted; K as stored); then
                     cv2's icvCvt_CMYK2BGR_8u_C4C3R (c' = k - ((255 - c) *
                     k >> 8), R G B = c' m' y') or, read as gray,
                     icvCvt_CMYK2Gray_8u_C4C1R (its BGR -> gray weights
                     1868, 9617, 4899 over 2^14, rounded, on c' m' y');
                     PIL's reading (pil=True) instead takes the values
                     inverted and converts with its cmyk2rgb
  orientation        EXIF 2-8 as cv2's ExifTransform applies them

decode(header, coefs, gray) takes utils/jpeg.parse's header and the
entropy decoder's coefficient arrays (tensors on the output's device).
encode_coefficients(rgb, quality) is the encoder's pixel stage (see its
section below).
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


def ycck_to_cmyk(y, cb, cr, k) -> List[torch.Tensor]:
    """jdcolor.c ycck_cmyk_convert on int32 planes: the inverted RGB of
    the first three components, K as it is."""
    rgb = ycc_to_rgb(y, cb, cr).to(torch.int32)
    return [255 - rgb[..., 0], 255 - rgb[..., 1], 255 - rgb[..., 2], k]


def cmyk_to_rgb(c, m, y, k, gray: bool = False) -> torch.Tensor:
    """cv2's icvCvt_CMYK2BGR_8u_C4C3R as RGB (H, W, 3) uint8, or with gray
    icvCvt_CMYK2Gray_8u_C4C1R (H, W), on int32 planes."""
    c, m, y = (k - (((255 - v) * k) >> 8) for v in (c, m, y))
    if gray:
        return ((y * 1868 + m * 9617 + c * 4899 + (1 << 13)) >> 14
                ).to(torch.uint8)
    return torch.stack([c, m, y], dim=-1).to(torch.uint8)


def pil_cmyk_to_rgb(c, m, y, k) -> torch.Tensor:
    """Pillow's cmyk2rgb (Convert.c): nk = 255 - k, each channel
    nk - MULDIV255(v, nk), on int32 planes → (H, W, 3) uint8."""
    nk = 255 - k

    def muldiv255(a):
        t = a * nk + 128
        return ((t >> 8) + t) >> 8

    return torch.stack([(nk - muldiv255(v)).clamp(0, 255) for v in (c, m, y)],
                       dim=-1).to(torch.uint8)


def decode(header, coefs: Sequence[torch.Tensor], gray: bool = False,
           exif: bool = True, pil: bool = False) -> torch.Tensor:
    """The image as cv2.imread gives it (RGB): (H, W, 3) uint8, or (H, W)
    with gray=True, on the coefficients' device, oriented (exif=False: as
    stored, as PIL's Image.open gives it). pil=True converts a CMYK or
    YCCK file as PIL's convert("RGB") does."""
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
    elif header.color in ("cmyk", "ycck"):
        cmyk = [planes[i] for i in range(4)]
        if header.color == "ycck":
            cmyk = ycck_to_cmyk(*cmyk)
        if pil:  # PIL reads the values inverted ("CMYK;I"), Adobe or not
            img = pil_cmyk_to_rgb(*[255 - v for v in cmyk])
        else:
            img = cmyk_to_rgb(*cmyk, gray=gray)
    else:  # RGB
        img = rgb_to_gray(planes[0], planes[1], planes[2]) if gray else \
            torch.stack([planes[i] for i in range(3)],
                        dim=-1).to(torch.uint8)
    return orient(img, header.orientation) if exif else img.contiguous()


# -- the encoder's pixel stage ------------------------------------------------
# libjpeg-turbo 3.1's compressor as Pillow's save(path, quality=q) drives
# it: jccolor.c's RGB -> YCbCr, 4:2:0 by jcsample.c's h2v2_downsample, the
# edges padded to whole blocks and MCUs as jcprepct.c and jccoefct.c pad
# them, jfdctint.c's islow FDCT and jcdctmgr.c's quantization by
# reciprocal (what its SIMD quantize computes too). Torch integer ops on
# the image's device; the Huffman coding is the host's
# (ops/kernels/jpeg_entropy.encode_scan).

_ZIGZAG = list(jpeg.NATURAL[:64])


def quality_tables(quality: int) -> List[List[int]]:
    """jpeg_set_quality(quality, force_baseline=TRUE): the luma and chroma
    tables (natural order)."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return [[min(max((b * scale + 50) // 100, 1), 255) for b in base]
            for base in (jpeg.STD_LUMA_Q, jpeg.STD_CHROMA_Q)]


def rgb_to_ycc(rgb: torch.Tensor) -> List[torch.Tensor]:
    """jccolor.c rgb_ycc_convert: (H, W, 3) uint8 → Y, Cb, Cr int64."""
    r, g, b = (rgb[..., i].to(torch.int64) for i in range(3))
    half = 1 << (SCALEBITS - 1)
    cbcr_off = 128 << SCALEBITS
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + half) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + cbcr_off + half - 1) >> SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + cbcr_off + half - 1) >> SCALEBITS
    return [y, cb, cr]


def _extend(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Repeat the last row and column out to (rows, cols)."""
    h, w = x.shape
    ri = torch.arange(rows, device=x.device).clamp(max=h - 1)
    ci = torch.arange(cols, device=x.device).clamp(max=w - 1)
    return x[ri][:, ci]


def downsample_h2v2(plane: torch.Tensor, out_cols: int) -> torch.Tensor:
    """jcsample.c h2v2_downsample of a full plane: the input's last column
    repeated out to 2 * out_cols, its last row to an even count (the row
    group), then (a + b + c + d + bias) >> 2 with bias 1, 2, 1, 2, ...
    along each row."""
    h = plane.shape[0]
    x = _extend(plane, h + (h & 1), 2 * out_cols)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    bias = 1 + (torch.arange(out_cols, device=x.device) & 1)
    return (s + bias) >> 2


def _fdct_1d(d: Sequence[torch.Tensor], shift: int, even_shift):
    """jfdctint.c's butterfly on the 8 inputs of one pass; even_shift(x)
    scales outputs 0 and 4, the others are descaled by `shift`."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    out[0] = even_shift(tmp10 + tmp11)
    out[4] = even_shift(tmp10 - tmp11)
    z1 = (tmp12 + tmp13) * F0_541
    out[2] = _descale(z1 + tmp13 * F0_765, shift)
    out[6] = _descale(z1 + tmp12 * -F1_847, shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1_175
    tmp4, tmp5 = tmp4 * F0_298, tmp5 * F2_053
    tmp6, tmp7 = tmp6 * F3_072, tmp7 * F1_501
    z1, z2 = z1 * -F0_899, z2 * -F2_562
    z3, z4 = z3 * -F1_961 + z5, z4 * -F0_390 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return out


def fdct_islow(x: torch.Tensor) -> torch.Tensor:
    """jpeg_fdct_islow on (..., 8, 8) level-shifted int64 samples → the
    (..., 8, 8) coefficients, scaled up by 8 as libjpeg leaves them."""
    rows = _fdct_1d([x[..., k] for k in range(8)], CONST_BITS - PASS1_BITS,
                    lambda v: v << PASS1_BITS)
    ws = torch.stack(rows, dim=-1)
    cols = _fdct_1d([ws[..., k, :] for k in range(8)],
                    CONST_BITS + PASS1_BITS,
                    lambda v: _descale(v, PASS1_BITS))
    return torch.stack(cols, dim=-2)


def _reciprocal(divisor: int):
    """jcdctmgr.c compute_reciprocal for 16-bit DCTELEMs: (reciprocal,
    correction, total shift)."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def quantize(coef: torch.Tensor, table: Sequence[int]) -> torch.Tensor:
    """(..., 8, 8) FDCT output → (..., 64) quantized, natural order:
    sign(x) * (((|x| + c) * recip) >> shift) with each divisor 8 * q."""
    recips = [_reciprocal(8 * q) for q in table]
    dev = coef.device
    fq, c, r = (torch.tensor([v[i] for v in recips], dtype=torch.int64,
                             device=dev) for i in range(3))
    x = coef.reshape(*coef.shape[:-2], 64)
    q = ((x.abs() + c) * fq) >> r
    return torch.where(x < 0, -q, q)


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(8 bh, 8 bw) → (bh, bw, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(1, 2)


def encode_coefficients(rgb: torch.Tensor, quality: int = 95
                        ) -> List[torch.Tensor]:
    """(H, W, 3) uint8 → the quantized blocks of a 4:2:0 baseline file,
    each component (bh, bw, 64) int16 in zigzag order: Y with the dummy
    blocks that fill its last MCU column and row (AC zero, the DC of the
    block before it in the MCU), Cb and Cr."""
    if rgb.dtype != torch.uint8 or rgb.dim() != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")
    h, w = rgb.shape[:2]
    y, cb, cr = rgb_to_ycc(rgb)
    luma_t, chroma_t = quality_tables(quality)
    ybh, ybw = -(-h // 8), -(-w // 8)
    cbh, cbw = -(-h // 16), -(-w // 16)
    out = []
    planes = [(_extend(y, 8 * ybh, 8 * ybw), luma_t)]
    for p in (cb, cr):
        small = downsample_h2v2(p, 8 * cbw)
        planes.append((_extend(small, 8 * cbh, 8 * cbw), chroma_t))
    for plane, table in planes:
        coef = quantize(fdct_islow(_blocks(plane) - 128), table)
        out.append(coef[..., _ZIGZAG].to(torch.int16))
    yb = out[0]
    if ybw & 1:  # a dummy column: the DC of the block to its left
        dummy = torch.zeros_like(yb[:, :1])
        dummy[..., 0] = yb[:, -1:, 0]
        yb = torch.cat([yb, dummy], 1)
    if ybh & 1:  # a dummy row: each MCU's last block of the row above
        dummy = torch.zeros_like(yb[:1])
        dummy[..., 0] = yb[-1, 1::2, 0].repeat_interleave(2)[None]
        yb = torch.cat([yb, dummy], 0)
    out[0] = yb
    return out


def encode_gray_coefficients(gray: torch.Tensor, quality: int = 95
                             ) -> torch.Tensor:
    """(H, W) uint8 → the quantized blocks of a 1-component baseline file
    (cv2.imwrite of a gray image): (bh, bw, 64) int16 in zigzag order, the
    plane's last row and column repeated out to whole blocks, the luma
    table."""
    if gray.dtype != torch.uint8 or gray.dim() != 2:
        raise ValueError(f"expected (H, W) uint8, got "
                         f"{tuple(gray.shape)} {gray.dtype}")
    h, w = gray.shape
    plane = _extend(gray.to(torch.int64), 8 * -(-h // 8), 8 * -(-w // 8))
    coef = quantize(fdct_islow(_blocks(plane) - 128),
                    quality_tables(quality)[0])
    return coef[..., _ZIGZAG].to(torch.int16)
