"""Synthetic watermarked images, made with numpy from a seed (no PIL/cv2).

Each image is a smooth colour gradient with mild noise, with a
semi-transparent logo blended over it: a thin ring with a bar through it,
white or black, of 12-40 px radius (a watermark's size, whatever the image
size) at a random place. The last `clean` images carry no logo, as a
folder of user images holds some that have none. text_images draws lines
of block capitals from a 5x7 bitmap font over such images, as a text
watermark lies over a photo, and returns each line's box and the pixels
its glyphs cover. encode_jpeg writes JPEG files of them (the GPU machine
has no cv2 or PIL to write one); encode_jpeg_blocks writes a gray file of
given quantized coefficients and quantizer, as a test pins a decoder's
arithmetic on values no photo gives. Used by chip_smoke.py and the tests; no
entry point of the port exposes them.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import jpeg

# 5x7 glyphs, rows top to bottom, "#" ink
FONT = {
    "A": ".###./#...#/#...#/#####/#...#/#...#/#...#",
    "B": "####./#...#/#...#/####./#...#/#...#/####.",
    "C": ".###./#...#/#..../#..../#..../#...#/.###.",
    "D": "####./#...#/#...#/#...#/#...#/#...#/####.",
    "E": "#####/#..../#..../####./#..../#..../#####",
    "F": "#####/#..../#..../####./#..../#..../#....",
    "G": ".###./#...#/#..../#.###/#...#/#...#/.####",
    "H": "#...#/#...#/#...#/#####/#...#/#...#/#...#",
    "I": ".###./..#../..#../..#../..#../..#../.###.",
    "J": "..###/...#./...#./...#./...#./#..#./.##..",
    "K": "#...#/#..#./#.#../##.../#.#../#..#./#...#",
    "L": "#..../#..../#..../#..../#..../#..../#####",
    "M": "#...#/##.##/#.#.#/#.#.#/#...#/#...#/#...#",
    "N": "#...#/#...#/##..#/#.#.#/#..##/#...#/#...#",
    "O": ".###./#...#/#...#/#...#/#...#/#...#/.###.",
    "P": "####./#...#/#...#/####./#..../#..../#....",
    "Q": ".###./#...#/#...#/#...#/#.#.#/#..#./.##.#",
    "R": "####./#...#/#...#/####./#.#../#..#./#...#",
    "S": ".####/#..../#..../.###./....#/....#/####.",
    "T": "#####/..#../..#../..#../..#../..#../..#..",
    "U": "#...#/#...#/#...#/#...#/#...#/#...#/.###.",
    "V": "#...#/#...#/#...#/#...#/#...#/.#.#./..#..",
    "W": "#...#/#...#/#...#/#.#.#/#.#.#/#.#.#/.#.#.",
    "X": "#...#/#...#/.#.#./..#../.#.#./#...#/#...#",
    "Y": "#...#/#...#/.#.#./..#../..#../..#../..#..",
    "Z": "#####/....#/...#./..#../.#.../#..../#####",
    "0": ".###./#...#/#..##/#.#.#/##..#/#...#/.###.",
    "1": "..#../.##../..#../..#../..#../..#../.###.",
    "2": ".###./#...#/....#/...#./..#../.#.../#####",
    "3": "#####/...#./..#../...#./....#/#...#/.###.",
    "4": "...#./..##./.#.#./#..#./#####/...#./...#.",
    "5": "#####/#..../####./....#/....#/#...#/.###.",
    "6": "..##./.#.../#..../####./#...#/#...#/.###.",
    "7": "#####/....#/...#./..#../.#.../.#.../.#...",
    "8": ".###./#...#/#...#/.###./#...#/#...#/.###.",
    "9": ".###./#...#/#...#/.####/....#/...#./.##..",
    " ": "...../...../...../...../...../...../.....",
}
WORDS = ("SAMPLE", "PREVIEW", "STOCK PHOTO", "COPYRIGHT 2026", "DRAFT",
         "DO NOT COPY", "WATERMARK", "PROOF COPY")


def watermarked_images(n: int, size: int, seed: int = 0, clean: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(images (n, size, size, 3) float32 in [0, 1], logo masks (n, size,
    size) float32 {0, 1}). The first n - clean images are those of
    clean = 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    images = np.empty((n, size, size, 3), np.float32)
    logos = np.empty((n, size, size), np.float32)
    for i in range(n):
        c0, c1, c2 = rng.random((3, 3)).astype(np.float32)
        base = (c0 + (c1 - c0) * yy[..., None] + (c2 - c0) * xx[..., None]) / 2
        base += rng.normal(0, 0.02, base.shape).astype(np.float32)
        r = rng.uniform(12, min(40, size / 3))
        cy, cx = rng.uniform(r + 2, size - r - 2, 2)
        d = np.hypot(yy * size - cy, xx * size - cx)
        ring = np.abs(d - 0.8 * r) < 0.15 * r
        bar = (np.abs(yy * size - cy) < 0.12 * r) & (d < r)
        logo = (ring | bar) & (i < n - clean)
        ink = np.float32(rng.integers(0, 2))
        alpha = np.float32(rng.uniform(0.45, 0.7))
        img = np.where(logo[..., None], (1 - alpha) * base + alpha * ink, base)
        images[i] = np.clip(img, 0.0, 1.0)
        logos[i] = logo
    return images, logos


def logo_images(n: int, seed: int = 0) -> List[np.ndarray]:
    """n RGBA uint8 logos for data/gen_data.py: a ring with a bar through
    it on a transparent canvas of 32-128 px a side, one colour each, the
    ring opaque and the bar at alpha 160-255."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(32, 129, 2))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        r = min(h, w) / 2 - 2
        d = np.hypot(yy - h / 2, xx - w / 2)
        ring = np.abs(d - 0.8 * r) < 0.15 * r
        bar = (np.abs(yy - h / 2) < 0.12 * r) & (d < r)
        img = np.zeros((h, w, 4), np.uint8)
        img[..., :3] = rng.integers(0, 256, 3, dtype=np.uint8)
        img[..., 3] = np.where(ring, 255, np.where(
            bar, rng.integers(160, 256), 0))
        out.append(img)
    return out


def glyph_mask(text: str, scale: int) -> np.ndarray:
    """(7 * scale, (6 * len(text) - 1) * scale) bool ink of a line: 5x7
    glyphs one column apart, each font pixel a scale x scale block."""
    cols = []
    for i, ch in enumerate(text.upper()):
        rows = [[c == "#" for c in r] for r in FONT[ch].split("/")]
        if i:
            cols.append(np.zeros((7, 1), bool))
        cols.append(np.array(rows, bool))
    ink = np.concatenate(cols, axis=1)
    return np.kron(ink, np.ones((scale, scale), bool))


def draw_text(img: np.ndarray, text: str, x: int, y: int, scale: int,
              color: Sequence[int], alpha: float = 1.0
              ) -> Tuple[int, int, int, int]:
    """Blend a line of block capitals into an (H, W, 3) uint8 image in
    place, its top-left corner at (x, y); returns the line's box (x, y, w,
    h), which must lie inside the image."""
    ink = glyph_mask(text, scale)
    h, w = ink.shape
    if x < 0 or y < 0 or y + h > img.shape[0] or x + w > img.shape[1]:
        raise ValueError(f"line {text!r} at ({x}, {y}) leaves the image")
    region = img[y:y + h, x:x + w].astype(np.float32)
    blend = (1 - alpha) * region + alpha * np.asarray(color, np.float32)
    img[y:y + h, x:x + w] = np.where(ink[..., None], np.rint(blend),
                                     region).astype(np.uint8)
    return x, y, w, h


def text_images(shapes: Sequence[Tuple[int, int]], seed: int = 0,
                logo: Sequence[bool] = ()
                ) -> Tuple[List[np.ndarray], List[List[Tuple[int, ...]]],
                           List[np.ndarray]]:
    """One (h, w, 3) uint8 image for each shape: a watermarked_images
    background (with its logo where `logo[i]` is true, else clean), cut to
    the shape, with one or two lines of text from WORDS drawn over it at
    random places (the words that fit the width), white on a dark place and
    black on a light one, 80-95 % opaque, glyph pixels of min(h // 100 + 2,
    6) px. Returns (images, each image's line boxes, each image's (h, w)
    bool mask of the glyph pixels drawn)."""
    rng = np.random.default_rng(seed)
    images, boxes, inks = [], [], []
    for i, (h, w) in enumerate(shapes):
        side = max(h, w)
        bg, _ = watermarked_images(1, side, seed=seed + 100 + i,
                                   clean=0 if i < len(logo) and logo[i]
                                   else 1)
        y0, x0 = (side - h) // 2, (side - w) // 2
        img = (bg[0, y0:y0 + h, x0:x0 + w] * 255).astype(np.uint8)
        # letters one glyph pixel apart, at most 6 px: the builtin text
        # detector's 9x3 closing joins them into a line
        scale = min(h // 100 + 2, 6)
        lines = []
        drawn = np.zeros((h, w), bool)
        band = h // 2  # one line in each half, so that they do not touch
        for k in range(int(rng.integers(1, 3))):
            fits = [t for t in WORDS if (6 * len(t) - 1) * scale < w]
            text = fits[int(rng.integers(len(fits)))]
            lw, lh = (6 * len(text) - 1) * scale, 7 * scale
            x = int(rng.integers(0, w - lw))
            y = int(rng.integers(k * band, (k + 1) * band - lh))
            dark = img[y:y + lh, x:x + lw].mean() < 128
            ink = (255, 255, 255) if dark else (0, 0, 0)
            lines.append(draw_text(img, text, x, y, scale, ink,
                                   float(rng.uniform(0.8, 0.95))))
            drawn[y:y + lh, x:x + lw] |= glyph_mask(text, scale)
        images.append(img)
        boxes.append(lines)
        inks.append(drawn)
    return images, boxes, inks


# ---------------------------------------------------------------------------
# a JPEG writer, vectorized with numpy (no loop per block or symbol)
# ---------------------------------------------------------------------------
# the JPEG spec's example tables (K.1), natural order, scaled by quality as
# libjpeg's jpeg_quality_scaling does
STD_LUMA_Q = np.array(jpeg.STD_LUMA_Q)
STD_CHROMA_Q = np.array(jpeg.STD_CHROMA_Q)
SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}  # luma (h, v)
# spectral bands of a progressive file's AC scans, one scan each per
# component
BANDS = ((1, 5), (6, 63))
_ZIGZAG = np.array(jpeg.NATURAL[:64])  # zigzag k -> natural index


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    d = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    d[0] /= np.sqrt(2)
    return d


def _magnitude(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(size category, extra bits) of each value."""
    size = np.frexp(np.abs(x).astype(np.float64))[1].astype(np.int64)
    extra = np.where(x < 0, x + (1 << size) - 1, x)
    return size, extra


def _scan_bytes(zz: np.ndarray, comp: np.ndarray, mcu: np.ndarray,
                tables, ss: int, se: int, restart: int) -> bytes:
    """The entropy-coded data of one scan: zz (N, 64) zigzag coefficients
    of its blocks in coding order, each block's scan component (index into
    tables: (dc, ac) code tables) and MCU; DC differences when ss == 0, the
    AC run/size symbols of positions max(ss, 1)..se (EOB where the band
    ends in zeros), each restart interval padded with 1-bits and followed
    by its RST marker, 0xFF bytes stuffed."""
    n = zz.shape[0]
    keys, vals, lens = [], [], []
    interval = mcu // restart if restart else np.zeros(n, np.int64)
    if ss == 0:
        dc = zz[:, 0].astype(np.int64)
        diff = np.empty(n, np.int64)
        for c in np.unique(comp):  # DC prediction along each component
            sel = np.flatnonzero(comp == c)
            d = dc[sel].copy()
            first = np.ones(sel.size, bool)
            first[1:] = interval[sel][1:] != interval[sel][:-1]
            d[~first] -= dc[sel][:-1][~first[1:]]
            diff[sel] = d
        size, extra = _magnitude(diff)
        code = np.stack([tables[c][0][0] for c in range(len(tables))])
        clen = np.stack([tables[c][0][1] for c in range(len(tables))])
        keys.append(np.arange(n) * 260)
        lens.append(clen[comp, size] + size)
        vals.append((code[comp, size] << size) | extra)
    lo = max(ss, 1)
    if se >= lo:
        band = zz[:, lo:se + 1].astype(np.int64)
        blk, kk = np.nonzero(band)
        kk = kk + lo
        prev = np.empty_like(kk)
        prev[:] = lo - 1
        same = np.zeros(kk.size, bool)
        same[1:] = blk[1:] == blk[:-1]
        prev[same] = kk[:-1][same[1:]]
        run = kk - prev - 1
        size, extra = _magnitude(band[blk, kk - lo])
        code = np.stack([tables[c][1][0] for c in range(len(tables))])
        clen = np.stack([tables[c][1][1] for c in range(len(tables))])
        cb = comp[blk]
        sym = ((run % 16) << 4) | size
        keys.append(blk * 260 + kk * 4 + 3)
        lens.append(clen[cb, sym] + size)
        vals.append((code[cb, sym] << size) | extra)
        nzrl = run // 16  # a ZRL (0xF0) for each 16 zeros of the run
        for j in range(3):
            sel = nzrl > j
            keys.append(blk[sel] * 260 + kk[sel] * 4 + j)
            lens.append(clen[cb[sel], 0xF0])
            vals.append(code[cb[sel], 0xF0])
        last = np.full(n, lo - 1)
        np.maximum.at(last, blk, kk)
        eob = np.flatnonzero(last < se)
        keys.append(eob * 260 + 256)
        lens.append(clen[comp[eob], 0x00])
        vals.append(code[comp[eob], 0x00])
    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    block_of = (key[order] // 260)
    # pad each restart interval's bits to a byte with 1-bits
    item_interval = interval[block_of]
    ends = np.flatnonzero(np.diff(item_interval)) + 1
    bounds = np.concatenate([[0], ends, [ln.size]])
    bits = np.add.reduceat(ln, bounds[:-1]) if ln.size else np.zeros(0, int)
    pad = (-bits) % 8
    val = np.insert(val, bounds[1:], (1 << pad) - 1)
    ln = np.insert(ln, bounds[1:], pad)
    interval_bytes = (bits + pad) // 8
    start = np.cumsum(ln) - ln
    total = int(start[-1] + ln[-1]) // 8 if ln.size else 0
    # each item's bits into a 40-bit big-endian window at its first byte;
    # the windows' bytes add up without carries (no two share a bit)
    b0 = start // 8
    window = val << (40 - (start % 8) - ln)
    out = np.zeros(total + 5, np.float64)
    for d in range(5):
        out += np.bincount(b0 + d, weights=(window >> (8 * (4 - d))) & 0xFF,
                           minlength=total + 5)
    out = out[:total].astype(np.uint8)
    ff = np.flatnonzero(out == 0xFF) + 1
    rst_at = np.cumsum(interval_bytes)[:-1]
    rst = np.arange(rst_at.size) % 8 + 0xD0
    pos = np.concatenate([ff, np.repeat(rst_at, 2)])
    ins = np.concatenate([np.zeros(ff.size, np.int64),
                          np.stack([np.full(rst.size, 0xFF), rst], 1).ravel()])
    order = np.argsort(pos * 2 + np.concatenate(
        [np.zeros(ff.size, np.int64), np.ones(2 * rst.size, np.int64)]),
        kind="stable")
    return np.insert(out, pos[order], ins[order].astype(np.uint8)).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _exif(orientation: int) -> bytes:
    """An APP1 body: "Exif\0\0", a big-endian TIFF header and IFD0 with
    the orientation tag alone."""
    return (b"Exif\x00\x00MM\x00\x2a" + struct.pack(">I", 8)
            + struct.pack(">HHHIHH", 1, 0x0112, 3, 1, orientation, 0)
            + struct.pack(">I", 0))


def encode_jpeg(img: np.ndarray, quality: int = 95, sampling: str = "420",
                progressive: bool = False, restart: int = 0,
                orientation: Optional[int] = None) -> bytes:
    """(H, W, 3) RGB or (H, W) gray uint8 → JPEG bytes: JFIF YCbCr (one
    component for gray), `sampling` 444/422/420, quality-scaled example
    quantization tables, the standard Huffman tables, baseline, or
    progressive by spectral selection (a DC scan, then each component's AC
    bands BANDS), a restart interval of `restart` MCUs, and an EXIF
    orientation tag where given. Samples go through libjpeg's JFIF colour
    transform and an orthonormal float DCT; the bytes differ from cv2's
    encoder, the decoded pixels are what cv2.imread gives for them."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected (H, W[, 3]) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes = [img.astype(np.float64)]
        factors = [(1, 1)]
    else:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        factors = [SAMPLING[sampling], (1, 1), (1, 1)]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qtabs = [quality_table(STD_LUMA_Q, quality),
             quality_table(STD_CHROMA_Q, quality)]
    dct = _dct_matrix()
    blocks = []  # each component's (bh, bw, 64) zigzag coefficients
    for i, (plane, (hf, vf)) in enumerate(zip(planes, factors)):
        plane = np.clip(np.rint(plane), 0, 255)
        plane = np.pad(plane, ((0, mcuy * 8 * vmax - h),
                               (0, mcux * 8 * hmax - w)), mode="edge")
        sy, sx = vmax // vf, hmax // hf
        if sy > 1 or sx > 1:
            plane = np.rint(plane.reshape(plane.shape[0] // sy, sy,
                                          plane.shape[1] // sx, sx)
                            .mean(axis=(1, 3)))
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        x = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
        coef = dct @ x @ dct.T
        q = qtabs[min(i, 1)].reshape(8, 8)
        zz = np.rint(coef / q).astype(np.int64).reshape(bh, bw, 64)
        blocks.append(zz[..., _ZIGZAG])
    std = [(jpeg.STD_DC_LUMA, jpeg.STD_AC_LUMA),
           (jpeg.STD_DC_CHROMA, jpeg.STD_AC_CHROMA)]
    codes = [(jpeg.huffman_codes(dc), jpeg.huffman_codes(ac)) for dc, ac in std]
    ncomp = len(planes)
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01"
                                          b"\x00\x01\x00\x00")]
    if orientation is not None:
        out.append(_segment(0xE1, _exif(orientation)))
    for t, q in enumerate(qtabs[:min(ncomp, 2)]):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            q[_ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, h, w, ncomp) + b"".join(
        bytes([i + 1, (f[0] << 4) | f[1], min(i, 1)])
        for i, f in enumerate(factors))
    out.append(_segment(0xC2 if progressive else 0xC0, sof))
    dht = b""
    for t, (dc, ac) in enumerate(std[:min(ncomp, 2)]):
        for cls, (bits, vals) in ((0, dc), (1, ac)):
            dht += bytes([cls << 4 | t]) + bytes(bits) + bytes(vals)
    out.append(_segment(0xC4, dht))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))

    def sos(comps, ss, se):
        body = bytes([len(comps)]) + b"".join(
            bytes([c + 1, (min(c, 1) << 4) | min(c, 1)]) for c in comps)
        return _segment(0xDA, body + bytes([ss, se, 0]))

    # the interleaved scan's blocks in coding order: MCUs across, then each
    # component's h x v blocks
    my, mx = np.divmod(np.arange(mcuy * mcux), mcux)
    order_zz, order_comp, order_mcu = [], [], []
    for c, (hf, vf) in enumerate(factors):
        by, bx = np.divmod(np.arange(vf * hf), hf)
        rows = my[:, None] * vf + by[None, :]
        cols = mx[:, None] * hf + bx[None, :]
        order_zz.append(blocks[c][rows, cols])  # (mcus, hv, 64)
        order_comp.append(np.full(rows.shape, c))
        order_mcu.append(np.broadcast_to(np.arange(rows.shape[0])[:, None],
                                         rows.shape))
    if ncomp == 1:  # one component: its own block grid, block by block
        grid = blocks[0][:-(-h // 8), :-(-w // 8)]
        zz_i = grid.reshape(-1, 64)
        comp_i = np.zeros(zz_i.shape[0], np.int64)
        mcu_i = np.arange(zz_i.shape[0])
    else:
        zz_i = np.concatenate(order_zz, 1).reshape(-1, 64)
        comp_i = np.concatenate(order_comp, 1).ravel()
        mcu_i = np.concatenate(order_mcu, 1).ravel()
    tabs = [codes[min(c, 1)] for c in range(ncomp)]
    if not progressive:
        out.append(sos(range(ncomp), 0, 63))
        out.append(_scan_bytes(zz_i, comp_i, mcu_i, tabs, 0, 63, restart))
    else:
        out.append(sos(range(ncomp), 0, 0))
        out.append(_scan_bytes(zz_i, comp_i, mcu_i, tabs, 0, 0, restart))
        for c, (hf, vf) in enumerate(factors):
            ch = -(-h * vf // vmax)
            cw = -(-w * hf // hmax)
            grid = blocks[c][:-(-ch // 8), :-(-cw // 8)].reshape(-1, 64)
            for ss, se in BANDS:
                out.append(sos([c], ss, se))
                out.append(_scan_bytes(
                    grid, np.zeros(grid.shape[0], np.int64),
                    np.arange(grid.shape[0]), [tabs[c]], ss, se, restart))
    out.append(b"\xff\xd9")
    return b"".join(out)


def encode_jpeg_blocks(blocks: np.ndarray, quant: np.ndarray) -> bytes:
    """A gray baseline JPEG of (bh, bw, 64) quantized coefficients in
    natural (row-major) order with the (64,) natural-order quantizer
    (1..255). The standard tables code DC differences up to 2047 and AC
    values up to 1023 in magnitude."""
    blocks = np.asarray(blocks, np.int64)
    quant = np.asarray(quant, np.int64)
    bh, bw = blocks.shape[:2]
    zz = blocks.reshape(-1, 64)[:, _ZIGZAG]
    dc = zz[:, 0]
    if (np.abs(np.diff(dc, prepend=0)) > 2047).any() or \
            (np.abs(zz[:, 1:]) > 1023).any() or \
            quant.min() < 1 or quant.max() > 255:
        raise ValueError("a value the standard tables cannot code")
    codes = (jpeg.huffman_codes(jpeg.STD_DC_LUMA), jpeg.huffman_codes(jpeg.STD_AC_LUMA))
    dht = b"".join(bytes([cls << 4]) + bytes(bits) + bytes(vals)
                   for cls, (bits, vals) in ((0, jpeg.STD_DC_LUMA),
                                             (1, jpeg.STD_AC_LUMA)))
    n = zz.shape[0]
    return b"".join([
        b"\xff\xd8",
        _segment(0xDB, b"\x00" + bytes(quant[_ZIGZAG].astype(np.uint8))),
        _segment(0xC0, struct.pack(">BHHB", 8, 8 * bh, 8 * bw, 1)
                 + b"\x01\x11\x00"),
        _segment(0xC4, dht),
        _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00"),
        _scan_bytes(zz, np.zeros(n, np.int64), np.arange(n), [codes], 0, 63,
                    0),
        b"\xff\xd9"])


def write_training_folder(root, n: int, size: int, seed: int = 0,
                          masks: int = 0) -> None:
    """A training folder in the data contract: root/watermarked and
    root/clean with n PNGs each (watermarked_images with and without the
    logos), and root/masks with the logo masks (0/255) of the first
    `masks` files; the rest get theirs from the clean images."""
    import os

    from .image_io import write_png

    marked, logos = watermarked_images(n, size, seed)
    clean, _ = watermarked_images(n, size, seed, clean=n)
    for sub in ("watermarked", "clean", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    to_u8 = lambda x: np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)  # noqa
    for i in range(n):
        name = f"img_{i:04d}.png"
        write_png(os.path.join(root, "watermarked", name), to_u8(marked[i]))
        write_png(os.path.join(root, "clean", name), to_u8(clean[i]))
        if i < masks:
            write_png(os.path.join(root, "masks", name), to_u8(logos[i]))


TIFF_CODECS = {"none": 1, "lzw": 5, "deflate": 8, "deflate32946": 32946,
               "packbits": 32773}


def tiff_bytes(img: np.ndarray, compression: str = "none",
               predictor: int = 1, planar: int = 1,
               tile: Optional[Tuple[int, int]] = None,
               rows_per_strip: Optional[int] = None, byteorder: str = "<",
               colormap: Optional[np.ndarray] = None,
               extra: Optional[int] = None, min_is_white: bool = False,
               orientation: Optional[int] = None) -> bytes:
    """A classic 8-bit TIFF of an (H, W) or (H, W, C) uint8 image: C 1 gray
    (min-is-black, or min-is-white with the samples stored inverted so the
    image reads the same), 2 gray and alpha, 3 RGB, 4 RGB and alpha (an
    ExtraSamples tag of `extra`: 0 unspecified, 1 associated, 2
    unassociated; default 2 where C is 2 or 4), or palette indices with
    `colormap` ((3, 256) uint16). `compression` is a key of TIFF_CODECS
    (LZW and PackBits through csrc/tiff_codecs.c, Deflate through zlib),
    `predictor` 2 differences each row's samples (LZW and Deflate), planar
    2 stores each sample in its own strips or tiles, `tile` (rows, cols;
    multiples of 16) writes tiles instead of strips of `rows_per_strip`
    rows, `byteorder` "<" little-endian (II) or ">" (MM); `orientation`
    adds the tag. The pixel data come first, the IFD after them."""
    import zlib

    from ..ops.kernels import tiff as tiff_c

    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    samples = img.copy()
    if min_is_white:
        samples[..., 0] = 255 - img[..., 0]
    if colormap is not None:
        photometric = 3
    elif spp in (1, 2):
        photometric = 0 if min_is_white else 1
    else:
        photometric = 2
    if extra is None and spp in (2, 4):
        extra = 2
    planes = ([np.ascontiguousarray(samples[..., c:c + 1])
               for c in range(spp)] if planar == 2 else [samples])
    if tile:
        th, tw = tile
        blocks_y, blocks_x = -(-h // th), -(-w // tw)
    else:
        rps = min(rows_per_strip or h, h)
        th, tw = rps, w
        blocks_y, blocks_x = -(-h // rps), 1

    def encode(block: np.ndarray) -> bytes:
        if predictor == 2:
            d = block.astype(np.int16)
            d[:, 1:] -= block[:, :-1]
            block = (d & 0xFF).astype(np.uint8)
        raw = block.tobytes()
        if compression == "lzw":
            return tiff_c.lzw_encode(raw)
        if compression.startswith("deflate"):
            return zlib.compress(raw, 6)
        if compression == "packbits":
            return tiff_c.packbits_encode(raw, block.shape[1] *
                                          block.shape[2])
        return raw

    body, offsets, counts = bytearray(b"\0" * 8), [], []
    for plane in planes:
        for by in range(blocks_y):
            for bx in range(blocks_x):
                block = plane[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw]
                if tile:  # edge tiles padded to the full tile
                    full = np.zeros((th, tw, plane.shape[2]), np.uint8)
                    full[:block.shape[0], :block.shape[1]] = block
                    block = full
                data = encode(block)
                offsets.append(len(body))
                counts.append(len(data))
                body += data
                if len(body) & 1:
                    body += b"\0"
    bo = byteorder
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp),
            259: (3, [TIFF_CODECS[compression]]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra is not None and spp in (2, 4):
        tags[338] = (3, [extra])
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).reshape(-1)])
    if orientation is not None:
        tags[274] = (3, [orientation])
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th]), 324: (4, offsets),
                     325: (4, counts)})
    else:
        tags.update({273: (4, offsets), 278: (4, [th]), 279: (4, counts)})
    ifd = len(body)
    n = len(tags)
    extra_at = ifd + 2 + 12 * n + 4
    entries, blob = b"", b""
    for tag in sorted(tags):
        kind, values = tags[tag]
        fmt = "H" if kind == 3 else "I"
        packed = struct.pack(f"{bo}{len(values)}{fmt}", *values)
        if len(packed) <= 4:
            field = packed.ljust(4, b"\0")
        else:
            field = struct.pack(f"{bo}I", extra_at + len(blob))
            blob += packed + (b"\0" if len(packed) & 1 else b"")
        entries += struct.pack(f"{bo}HHI", tag, kind, len(values)) + field
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(f"{bo}I", ifd)
    body[:8] = head
    return (bytes(body) + struct.pack(f"{bo}H", n) + entries
            + struct.pack(f"{bo}I", 0) + blob)


# -- WEBP writers (test data: cv2's encoder never writes some of these) --

# the DC dequantizers at base_q 10 with no deltas (the decoder's tables):
# Y2's is twice DC_TABLE[10], the chroma's DC_TABLE[10]
_Q10_Y2_DC, _Q10_UV_DC = 26, 13


def _vp8_dc_pred(top, left) -> int:
    """VP8's DC prediction of a block from its top row and left column
    (None where outside the frame)."""
    if top is not None and left is not None:
        return (int(top.sum()) + int(left.sum()) + top.size) >> (
            top.size.bit_length())
    if top is not None or left is not None:
        edge = top if top is not None else left
        return (int(edge.sum()) + (edge.size >> 1)) >> (
            edge.size.bit_length() - 1)
    return 128


def _vp8_from_image(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Modes and levels (base_q 10) that make a VP8 frame approximate an
    (H, W, 3) RGB image: 16x16 and chroma DC prediction everywhere, one
    luma level a macroblock (its Y2 DC) and one level a 4x4 chroma block,
    each the nearest to the BT.601 Y, U or V mean of its block given the
    frame reconstructed so far (as the decoder predicts, from unfiltered
    neighbours)."""
    h, w = img.shape[:2]
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    x = np.pad(img.astype(np.float64), ((0, mb_h * 16 - h),
                                        (0, mb_w * 16 - w), (0, 0)),
               mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = (16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256,
              128 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256,
              128 + (112.439 * r - 94.154 * g - 18.285 * b) / 256)
    y_mean = planes[0].reshape(mb_h, 16, mb_w, 16).mean(axis=(1, 3))
    c_mean = [c.reshape(mb_h * 2, 8, mb_w * 2, 8).mean(axis=(1, 3))
              for c in planes[1:]]
    levels = np.zeros((mb_h * mb_w, 25, 16), np.int16)
    rec_y = np.zeros((mb_h * 16, mb_w * 16), np.int64)
    rec_c = [np.zeros((mb_h * 8, mb_w * 8), np.int64) for _ in range(2)]

    def nearest(target, pred, recon):
        """The level in -74..74 whose reconstruction is nearest."""
        lv = np.arange(-74, 75)
        out = np.clip(pred + recon(lv), 0, 255)
        i = int(np.argmin(np.abs(out - target)))
        return int(lv[i]), int(out[i])

    for my in range(mb_h):
        for mx in range(mb_w):
            k = my * mb_w + mx
            y0, x0 = my * 16, mx * 16
            pred = _vp8_dc_pred(rec_y[y0 - 1, x0:x0 + 16] if my else None,
                                rec_y[y0:y0 + 16, x0 - 1] if mx else None)
            lev, val = nearest(y_mean[my, mx], pred, lambda v: (
                ((v * _Q10_Y2_DC + 3) >> 3) + 4) >> 3)
            levels[k, 24, 0] = lev
            rec_y[y0:y0 + 16, x0:x0 + 16] = val
            for c in range(2):
                rc, cy, cx = rec_c[c], my * 8, mx * 8
                pred = _vp8_dc_pred(rc[cy - 1, cx:cx + 8] if my else None,
                                    rc[cy:cy + 8, cx - 1] if mx else None)
                for blk in range(4):
                    by, bx = blk >> 1, blk & 1
                    lev, val = nearest(c_mean[c][my * 2 + by, mx * 2 + bx],
                                       pred, lambda v: (v * _Q10_UV_DC + 4)
                                       >> 3)
                    levels[k, 16 + 4 * c + blk, 0] = lev
                    rc[cy + 4 * by:cy + 4 * by + 4,
                       cx + 4 * bx:cx + 4 * bx + 4] = val
    return np.zeros((mb_h * mb_w, 21), np.uint8), levels


def vp8_bytes(h: int, w: int, seed: int = 0, partitions: int = 1,
              segments: bool = True, loop_filter: Optional[str] = "normal",
              image: Optional[np.ndarray] = None) -> bytes:
    """A lossy WEBP file ("VP8 " chunk) of a VP8 key frame coded with the
    default probabilities (the coder is csrc/webp_decode.c's
    uwt_vp8_encode). Without `image`: every header field, macroblock mode
    (each 16x16, B_PRED and chroma mode, segments, skips) and quantized
    level drawn from `seed`, levels up to 74 (every token category) with
    most blocks sparse; the quantizer indices stay at 18 or below and Y2's
    levels at 8, so every dequantized coefficient stays inside the 12 bits
    libwebp's SIMD transforms are exact for (cv2's and Pillow's decoders
    take them; a real encoder's coefficients stay there). With `image` ((h, w, 3) uint8 RGB): a blocky
    approximation of it, DC prediction and one level a block
    (_vp8_from_image). `partitions` is 1, 2, 4 or 8; `loop_filter` is
    "normal", "simple" or None (level 0)."""
    from ..ops.kernels import webp as webp_c

    rng = np.random.default_rng(seed)
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    n = mb_w * mb_h
    hdr = {"w": w, "h": h, "log2parts": {1: 0, 2: 1, 4: 2, 8: 3}[partitions],
           "simple": int(loop_filter == "simple"),
           "level": 0 if loop_filter is None else int(rng.integers(1, 64)),
           "sharpness": int(rng.integers(0, 8)), "use_lf_delta": 1,
           "ref_lf0": int(rng.integers(-8, 9)),
           "mode_lf0": int(rng.integers(-8, 9)),
           "base_q": int(rng.integers(0, 9)) if image is None else 10}
    if image is None:
        hdr.update({f"dq_{k}": int(rng.integers(-4, 5)) for k in
                    ("y1_dc", "y2_dc", "y2_ac", "uv_dc", "uv_ac")})
        hdr.update({"use_skip": 1, "skip_p": int(rng.integers(1, 256))})
    if segments:
        absolute = int(rng.integers(0, 2))
        hdr.update({"use_segment": 1, "update_map": 1,
                    "absolute_delta": absolute,
                    **{f"seg_q{s}": int(rng.integers(0, 13) if absolute
                                        else rng.integers(-6, 7))
                       for s in range(4)},
                    **{f"seg_lf{s}": int(rng.integers(0, 64) if absolute
                                         else rng.integers(-20, 21))
                       for s in range(4)},
                    **{f"seg_p{s}": int(rng.integers(1, 256))
                       for s in range(3)}})
    if image is not None:
        hdr.update({"use_segment": 0, "update_map": 0})
        mbs, levels = _vp8_from_image(np.asarray(image))
    else:
        mbs = np.zeros((n, 21), np.uint8)
        mbs[:, 0] = rng.integers(0, 4, n) if segments else 0
        mbs[:, 1] = rng.random(n) < 0.1
        mbs[:, 2] = rng.random(n) < 0.5
        mbs[:, 3] = rng.integers(0, 4, n)
        mbs[:, 4] = rng.integers(0, 4, n)
        mbs[:, 5:] = rng.integers(0, 10, (n, 16))
        levels = np.zeros((n, 25, 16), np.int16)
        nnz = np.minimum(rng.geometric(0.35, (n, 25)) - 1, 16)
        pos = np.arange(16)
        mag = np.where(rng.random((n, 25, 16)) < 0.08,
                       rng.integers(5, 75, (n, 25, 16)),
                       rng.integers(1, 5, (n, 25, 16)))
        sign = np.where(rng.random((n, 25, 16)) < 0.5, -1, 1)
        keep = (pos < nnz[..., None]) & (rng.random((n, 25, 16)) < 0.8)
        levels[:] = np.where(keep, mag * sign, 0)
        levels[:, 24] = np.clip(levels[:, 24], -8, 8)
    frame = webp_c.vp8_encode(hdr, mbs, levels)
    return webp_container(b"VP8 ", frame)


def _reverse(code: np.ndarray, length: np.ndarray) -> np.ndarray:
    out = np.zeros_like(code)
    for i in range(15):
        out |= ((code >> i) & 1) << np.maximum(length - 1 - i, 0) * (i < length)
    return out * (length > 0)


def _code_lengths(counts: np.ndarray, limit: int) -> np.ndarray:
    """Huffman code lengths of the nonzero counts, at most `limit` (counts
    halved until they fit); a single symbol gets length 1."""
    import heapq

    counts = np.asarray(counts, np.int64)
    lengths = np.zeros(counts.size, np.int64)
    used = np.flatnonzero(counts)
    if used.size == 1:
        lengths[used[0]] = 1
    if used.size <= 1:
        return lengths
    c = counts.copy()
    while True:
        heap = [(int(c[s]), int(s), [int(s)]) for s in used]
        heapq.heapify(heap)
        depth = dict.fromkeys(used.tolist(), 0)
        while len(heap) > 1:
            a, b = heapq.heappop(heap), heapq.heappop(heap)
            for s in a[2] + b[2]:
                depth[s] += 1
            heapq.heappush(heap, (a[0] + b[0], min(a[1], b[1]), a[2] + b[2]))
        if max(depth.values()) <= limit:
            for s, d in depth.items():
                lengths[s] = d
            return lengths
        c[used] = (c[used] + 1) // 2


def _canonical(lengths: np.ndarray) -> np.ndarray:
    """Each symbol's canonical code (by length, then symbol), reversed for
    least-significant-bit-first packing."""
    lengths = np.asarray(lengths, np.int64)
    codes = np.zeros(lengths.size, np.int64)
    code = 0
    for ln in range(1, 16):
        for s in np.flatnonzero(lengths == ln):
            codes[s] = code
            code += 1
        code <<= 1
    return _reverse(codes, lengths)


class _Bits:
    """(value, bit count) pairs, packed least significant bit first."""

    def __init__(self):
        self.codes: List[np.ndarray] = []
        self.lens: List[np.ndarray] = []

    def put(self, value: int, nbits: int) -> None:
        self.codes.append(np.array([value], np.uint32))
        self.lens.append(np.array([nbits], np.uint8))

    def extend(self, codes: np.ndarray, lens: np.ndarray) -> None:
        self.codes.append(np.asarray(codes, np.uint32).reshape(-1))
        self.lens.append(np.asarray(lens, np.uint8).reshape(-1))

    def pack(self) -> bytes:
        from ..ops.kernels import webp as webp_c
        return webp_c.pack_bits_lsb(np.concatenate(self.codes),
                                    np.concatenate(self.lens))


CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                     13, 14, 15)


def _put_code(bits: _Bits, lengths: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Writes a prefix code's lengths; returns each symbol's reversed code
    and the bits it takes (none for a code of one symbol)."""
    used = np.flatnonzero(lengths)
    if used.size <= 1:
        s = int(used[0]) if used.size else 0
        if s < 256:
            bits.put(1, 1)                 # simple code
            bits.put(0, 1)                 # one symbol
            bits.put(int(s > 1), 1)
            bits.put(s, 8 if s > 1 else 1)
            return (np.zeros(lengths.size, np.int64),
                    np.zeros(lengths.size, np.int64))
    cl = _code_lengths(np.bincount(lengths, minlength=19), 7)
    num = max(4, max(i for i, s in enumerate(CODE_LENGTH_ORDER) if cl[s]) + 1)
    bits.put(0, 1)
    bits.put(num - 4, 4)
    for i in range(num):
        bits.put(int(cl[CODE_LENGTH_ORDER[i]]), 3)
    bits.put(0, 1)                     # max_symbol: the whole alphabet
    if np.count_nonzero(cl) == 1:      # one length: no bits a symbol
        bits.extend(np.zeros(lengths.size), np.zeros(lengths.size))
    else:
        bits.extend(_canonical(cl)[lengths], cl[lengths])
    if used.size == 1:
        return (np.zeros(lengths.size, np.int64),
                np.zeros(lengths.size, np.int64))
    return _canonical(lengths), lengths


def _prefix(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """VP8L's prefix coding of values >= 1: (symbol, extra bits, count)."""
    d = np.asarray(v, np.int64) - 1
    hb = np.where(d < 4, 0, np.floor(np.log2(np.maximum(d, 1))).astype(
        np.int64))
    nbits = np.where(d < 4, 0, hb - 1)
    sym = np.where(d < 4, d, 2 * hb + ((d >> np.maximum(hb - 1, 0)) & 1))
    return sym, d & ((1 << nbits) - 1), nbits


def _entropy_image(bits: _Bits, argb: np.ndarray, cache_bits: int = 0,
                   backrefs: bool = False, meta_bits: int = 0,
                   level0: bool = True) -> None:
    """Writes an image's colour cache, prefix codes and pixels."""
    h, w = argb.shape
    flat = argb.reshape(-1).astype(np.int64)
    if cache_bits:
        bits.put(1, 1)
        bits.put(cache_bits, 4)
    else:
        bits.put(0, 1)
    groups = np.zeros(h * w, np.int64)
    if level0:
        bits.put(int(meta_bits > 0), 1)
        if meta_bits:
            mh, mw = -(-h // (1 << meta_bits)), -(-w // (1 << meta_bits))
            tiles = (np.arange(mh)[:, None] + np.arange(mw)) % 2
            bits.put(meta_bits - 2, 3)
            _entropy_image(bits, (tiles << 8).astype(np.uint32), level0=False)
            ys, xs = np.divmod(np.arange(h * w), w)
            groups = tiles[ys >> meta_bits, xs >> meta_bits]
    # the symbol stream: (kind, value) with kind 0 literal, 1 copy, 2 cache
    syms = []
    if cache_bits or backrefs:
        cache = np.zeros(1 << max(cache_bits, 1), np.int64)
        i, n = 0, h * w
        while i < n:
            run = 0
            if backrefs and i >= w:
                while i + run < n and run < 4096 and \
                        flat[i + run] == flat[i + run - w]:
                    run += 1
            if run >= 3:
                syms.append((1, run, 1, i))     # plane code 1: the row above
            else:
                run = 0
                if backrefs and i >= 1:
                    while i + run < n and run < 4096 and \
                            flat[i + run] == flat[i - 1]:
                        run += 1
                if run >= 3:
                    syms.append((1, run, 121, i))   # distance 1, no plane
                else:
                    run = 1
                    key = (int(flat[i]) * 0x1E35A7BD & 0xFFFFFFFF) >> (
                        32 - cache_bits) if cache_bits else 0
                    if cache_bits and cache[key] == flat[i]:
                        syms.append((2, key, 0, i))
                    else:
                        syms.append((0, int(flat[i]), 0, i))
            if cache_bits:
                for j in range(i, i + run):
                    cache[(int(flat[j]) * 0x1E35A7BD & 0xFFFFFFFF) >> (
                        32 - cache_bits)] = flat[j]
            i += run
        kind = np.array([s[0] for s in syms])
        val = np.array([s[1] for s in syms], np.int64)
        dist = np.array([s[2] for s in syms], np.int64)
        at = np.array([s[3] for s in syms], np.int64)
    else:
        kind = np.zeros(h * w, np.int64)
        val, dist, at = flat, np.zeros(h * w, np.int64), np.arange(h * w)
    grp = groups[at]
    ngroups = int(groups.max()) + 1
    green_size = 256 + 24 + (1 << cache_bits if cache_bits else 0)
    lit = kind == 0
    lsym, lext, lnb = _prefix(np.maximum(val, 1))
    dsym, dext, dnb = _prefix(np.maximum(dist, 1))
    green = np.where(lit, (val >> 8) & 0xFF,
                     np.where(kind == 1, 256 + lsym, 280 + val))
    chans = [green, (val >> 16) & 0xFF, val & 0xFF, (val >> 24) & 0xFF, dsym]
    masks = [np.ones_like(lit), lit, lit, lit, kind == 1]
    sizes = [green_size, 256, 256, 256, 40]
    tables = []
    for g in range(ngroups):
        sel = grp == g
        row = []
        for c in range(5):
            counts = np.bincount(chans[c][sel & masks[c]],
                                 minlength=sizes[c])
            row.append(_put_code(bits, _code_lengths(counts, 15)))
        tables.append(row)
    # the symbols in order: green, then red, blue, alpha (a literal) or
    # the length's extra bits, the distance and its extra bits (a copy)
    n = kind.size
    codes = np.zeros((n, 6), np.int64)
    lens = np.zeros((n, 6), np.int64)
    for c in range(5):
        code_t = np.stack([tables[g][c][0] for g in range(ngroups)])
        len_t = np.stack([tables[g][c][1] for g in range(ngroups)])
        col = c if c < 4 else 4
        sym = np.clip(chans[c], 0, sizes[c] - 1)
        on = masks[c]
        if c == 4:  # copies: length extra bits first, then the distance
            codes[:, 1] = np.where(kind == 1, lext, codes[:, 1])
            lens[:, 1] = np.where(kind == 1, lnb, lens[:, 1])
            codes[:, 2] = np.where(on, code_t[grp, sym], codes[:, 2])
            lens[:, 2] = np.where(on, len_t[grp, sym], lens[:, 2])
            codes[:, 3] = np.where(on, dext, codes[:, 3])
            lens[:, 3] = np.where(on, dnb, lens[:, 3])
            continue
        codes[:, col] = np.where(on, code_t[grp, sym], codes[:, col])
        lens[:, col] = np.where(on, len_t[grp, sym], lens[:, col])
    bits.extend(codes.reshape(-1), lens.reshape(-1))


def _forward_predict(argb: np.ndarray, modes: np.ndarray, tbits: int
                     ) -> np.ndarray:
    """The residuals of the predictor transform (each pixel minus its
    tile's mode's prediction from the original neighbours)."""
    h, w = argb.shape
    px = argb.view(np.uint8).reshape(h, w, 4).astype(np.int64)
    left = np.zeros_like(px)
    left[:, 1:] = px[:, :-1]
    up = np.zeros_like(px)
    up[1:] = px[:-1]
    ul = np.zeros_like(px)
    ul[1:, 1:] = px[:-1, :-1]
    ur = np.zeros_like(px)
    ur[1:, :-1] = px[:-1, 1:]
    ur[1:, -1] = px[1:, 0]   # the last column's up-right: this row's first

    def avg(a, b):
        return (a + b) >> 1

    def select(t, l_, tl):
        pa_minus_pb = (np.abs(l_ - tl) - np.abs(t - tl)).sum(axis=-1,
                                                            keepdims=True)
        return np.where(pa_minus_pb <= 0, t, l_)

    black = np.zeros_like(px)
    black[..., 3] = 255
    half = avg(left, up)
    preds = [black, left, up, ur, ul, avg(avg(left, ur), up), avg(left, ul),
             avg(left, up), avg(ul, up), avg(up, ur),
             avg(avg(left, ul), avg(up, ur)), select(up, left, ul),
             np.clip(left + up - ul, 0, 255),
             np.clip(half + (half - ul) // 2 + ((half - ul) < 0) *
                     ((half - ul) % 2 != 0), 0, 255)]
    ys, xs = np.mgrid[:h, :w]
    mode = modes[ys >> tbits, xs >> tbits]
    mode[0, :] = 1
    mode[:, 0] = 2
    mode[0, 0] = 0
    pred = np.choose(mode[..., None], preds)
    res = ((px - pred) & 0xFF).astype(np.uint8)
    return res.reshape(h, w * 4).view(np.uint32).reshape(h, w)


def vp8l_stream(argb: np.ndarray, transforms: Sequence[str] = (),
                seed: int = 0, cache_bits: int = 0, backrefs: bool = False,
                meta_bits: int = 0, header: bool = True) -> bytes:
    """A VP8L stream of an (H, W) uint32 ARGB image: its header (unless
    header=False, an ALPH stream), the `transforms` in the order applied
    ("palette", "subtract_green", "predictor", "cross_color"; tile modes
    and multipliers drawn from `seed`), then the pixels' prefix codes
    (meta codes over 2^meta_bits tiles, a colour cache of cache_bits,
    backward references to the row above and the pixel before)."""
    rng = np.random.default_rng(seed)
    argb = np.ascontiguousarray(argb, np.uint32)
    h, w = argb.shape
    bits = _Bits()
    if header:
        alpha = bool(((argb >> 24) != 255).any())
        bits.put(0x2F, 8)
        bits.put(w - 1, 14)
        bits.put(h - 1, 14)
        bits.put(int(alpha), 1)
        bits.put(0, 3)
    img = argb
    for t in transforms:
        bits.put(1, 1)
        px = img.view(np.uint8).reshape(img.shape[0], img.shape[1], 4
                                        ).astype(np.int64)
        if t == "subtract_green":
            bits.put(2, 2)
            px[..., 0] -= px[..., 1]  # B
            px[..., 2] -= px[..., 1]  # R
            img = (px & 0xFF).astype(np.uint8).reshape(img.shape[0], -1
                                                       ).view(np.uint32)
        elif t == "palette":
            colors, idx = np.unique(img.reshape(-1), return_inverse=True)
            if colors.size > 256:
                raise ValueError(f"{colors.size} colours for a palette")
            n = colors.size
            pbits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            bits.put(3, 2)
            bits.put(n - 1, 8)
            pal = colors.view(np.uint8).reshape(n, 4).astype(np.int64)
            delta = pal.copy()
            delta[1:] -= pal[:-1]
            _entropy_image(bits, (delta & 0xFF).astype(np.uint8).reshape(
                1, -1).view(np.uint32), level0=False)
            idx = idx.reshape(img.shape)
            per = 1 << pbits
            pw = -(-img.shape[1] // per)
            padded = np.zeros((img.shape[0], pw * per), np.int64)
            padded[:, :img.shape[1]] = idx
            shifts = (np.arange(per) * (8 >> pbits))
            packed = (padded.reshape(img.shape[0], pw, per) << shifts).sum(-1)
            img = (packed << 8).astype(np.uint32)
        else:
            tbits = int(rng.integers(2, 5))
            th, tw = -(-img.shape[0] // (1 << tbits)), \
                -(-img.shape[1] // (1 << tbits))
            if t == "predictor":
                bits.put(0, 2)
                bits.put(tbits - 2, 3)
                modes = rng.integers(0, 14, (th, tw))
                _entropy_image(bits, (modes << 8).astype(np.uint32),
                               level0=False)
                img = _forward_predict(img, modes, tbits)
            else:
                bits.put(1, 2)
                bits.put(tbits - 2, 3)
                mult = rng.integers(0, 256, (th, tw, 3))
                _entropy_image(bits, (mult[..., 2] << 16 | mult[..., 1] << 8
                                      | mult[..., 0]).astype(np.uint32),
                               level0=False)
                ys, xs = np.mgrid[:img.shape[0], :img.shape[1]]
                m = mult[ys >> tbits, xs >> tbits].astype(np.int8).astype(
                    np.int64)
                g = px[..., 1].astype(np.uint8).astype(np.int8).astype(
                    np.int64)
                red = px[..., 2].astype(np.uint8).astype(np.int8).astype(
                    np.int64)
                px[..., 2] -= (m[..., 0] * g) >> 5
                px[..., 0] -= ((m[..., 1] * g) >> 5) + ((m[..., 2] * red)
                                                        >> 5)
                img = (px & 0xFF).astype(np.uint8).reshape(img.shape[0], -1
                                                           ).view(np.uint32)
    bits.put(0, 1)  # no more transforms
    _entropy_image(bits, img, cache_bits, backrefs, meta_bits, level0=True)
    return bits.pack()


def to_argb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB or (H, W, 4) RGBA uint8 -> (H, W) uint32 ARGB."""
    img = np.asarray(img, np.uint8)
    a = img[..., 3] if img.shape[2] == 4 else np.full(img.shape[:2], 255,
                                                      np.uint8)
    bgra = np.stack([img[..., 2], img[..., 1], img[..., 0], a], axis=2)
    return np.ascontiguousarray(bgra).view(np.uint32)[..., 0]


def vp8l_bytes(img: np.ndarray, transforms: Sequence[str] = (),
               seed: int = 0, cache_bits: int = 0, backrefs: bool = False,
               meta_bits: int = 0) -> bytes:
    """A lossless WEBP file ("VP8L" chunk) of an (H, W, 3) RGB or (H, W, 4)
    RGBA uint8 image (see vp8l_stream)."""
    return webp_container(b"VP8L", vp8l_stream(
        to_argb(img), transforms, seed, cache_bits, backrefs, meta_bits))


def alph_bytes(alpha: np.ndarray, method: int = 1, filtering: int = 0,
               **vp8l) -> bytes:
    """An ALPH chunk's payload for an (H, W) uint8 alpha plane: the filter
    (0 none, 1 horizontal, 2 vertical, 3 gradient) applied, then stored raw
    (method 0) or as a headerless VP8L stream of green values."""
    a = np.asarray(alpha, np.int64)
    pred = np.zeros_like(a)
    if filtering:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        if filtering == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif filtering == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0,
                                   255)
    res = ((a - pred) & 0xFF).astype(np.uint32)
    head = bytes([method | filtering << 2])
    if method == 0:
        return head + res.astype(np.uint8).tobytes()
    return head + vp8l_stream(res << 8 | 0xFF000000, header=False, **vp8l)


def webp_container(tag: bytes, payload: bytes, alpha: Optional[bytes] = None,
                   exif: Optional[bytes] = None, icc: Optional[bytes] = None,
                   xmp: Optional[bytes] = None,
                   size: Optional[Tuple[int, int]] = None) -> bytes:
    """A RIFF WEBP file of one "VP8 " or "VP8L" chunk: simple, or an
    extended (VP8X) file where an ALPH, EXIF, ICCP or XMP chunk is given
    (`size`, (w, h), the canvas; read from the payload where None)."""
    def chunk(t: bytes, body: bytes) -> bytes:
        return t + struct.pack("<I", len(body)) + body + b"\0" * (
            len(body) & 1)

    if alpha is None and exif is None and icc is None and xmp is None:
        body = chunk(tag, payload)
    else:
        if size is None:
            if tag == b"VP8L":
                v = int.from_bytes(payload[1:5], "little")
                size = ((v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1)
            else:
                size = (int.from_bytes(payload[6:8], "little") & 0x3FFF,
                        int.from_bytes(payload[8:10], "little") & 0x3FFF)
        flags = (0x20 * (icc is not None) | 0x10 * (alpha is not None)
                 | 0x08 * (exif is not None) | 0x04 * (xmp is not None))
        w, h = size
        body = chunk(b"VP8X", struct.pack("<I", flags)
                     + (w - 1).to_bytes(3, "little")
                     + (h - 1).to_bytes(3, "little"))
        if icc is not None:
            body += chunk(b"ICCP", icc)
        if alpha is not None:
            body += chunk(b"ALPH", alpha)
        body += chunk(tag, payload)
        if exif is not None:
            body += chunk(b"EXIF", exif)
        if xmp is not None:
            body += chunk(b"XMP ", xmp)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body
