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
