"""JPEG markers and headers, and the plain entropy decoder: what
libjpeg-turbo (under cv2.imread) does before its pixel stage.

parse(data) reads the markers (SOI, APPn, DQT with 8- and 16-bit tables,
SOF0/SOF1/SOF2, DHT, DRI, SOS, RST0-7, EOI; COM and other APPn skipped) and
returns a Header: the frame, each component's sampling factors and the
quantization table latched at its first scan (as jdinput.c latches it), the
colour space as jdapimin.c defaults it (one component: gray; three: YCbCr
under JFIF or Adobe transform 1, RGB under Adobe transform 0 or component
ids 'R' 'G' 'B'), the EXIF orientation as cv2 reads it (the first APP1's
IFD0 tag 0x0112, either byte order), and each scan with the Huffman tables
and restart interval in force when it starts and the byte range of its
entropy-coded data.

decode_scans(header, data) turns the scans into one int16 array of
coefficients per component, (blocks_h, blocks_w, 64) in natural order,
with jdhuff.c's and jdphuff.c's rules: baseline and progressive (DC first
and refinement, AC first and refinement with EOB runs), restart intervals
with libjpeg's resync rules, and its insufficient-data rule: where the
entropy data ends early (a truncated file), the missing bits read as zeros
for the MCU in progress and the MCUs after it keep the coefficients they
have (zero in a baseline file, what the earlier scans gave in a
progressive one). It is the plain version of csrc/jpeg_entropy.c, which
ops/kernels/jpeg_entropy.py runs on the host for the card's route.

A file without a frame or a scan, with a malformed segment, or with a
frame over cv2.imread's size limits (MAX_SIDE, MAX_PIXELS) raises
JPEGError (cv2.imread gives None). Arithmetic coding, lossless and
hierarchical frames, 12-bit samples and 4-component (CMYK/YCCK) files
raise NotImplementedError naming ROADMAP.md §A.5.

block_smoothing(header) is jdcoefct.c's smoothing_ok for a progressive file
whose coefficients are not all exact (a file cut before its last scan):
each component's coefficient-bit latches as libjpeg-turbo 3.1 keeps them,
and the last iMCU row the last scan decoded in full (the entropy decoders
set each scan's `cut`). ops/jpeg.py applies it to the coefficients.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# zigzag position k -> natural (row-major) index, with the 16 extra entries
# libjpeg reads when corrupt data runs k past 63
NATURAL = tuple([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16)

# the standard Huffman tables of the JPEG spec (K.3), as (bits[1..16],
# values); libjpeg-turbo falls back to them for tables 0 and 1 when a file
# defines none (Motion-JPEG), and utils/synthetic.py writes with them
STD_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
               tuple(range(12)))
STD_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                 tuple(range(12)))
STD_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
STD_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# jcparam.c's example quantization tables (natural order), which
# jpeg_set_quality scales
STD_LUMA_Q = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
STD_CHROMA_Q = (
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) \
    + (99,) * 32

ROADMAP = "(ROADMAP.md §A.5, other image formats)"
SOI = b"\xff\xd8"
_APP0, _APP1, _APP14 = 0xE0, 0xE1, 0xEE
_SOF_SUPPORTED = (0xC0, 0xC1, 0xC2)
_SOF_REFUSED = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
                0xC7: "hierarchical", 0xC9: "arithmetic-coded",
                0xCA: "arithmetic-coded", 0xCB: "arithmetic-coded",
                0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded",
                0xCF: "arithmetic-coded"}
# the largest frame cv2.imread decodes: libjpeg's JPEG_MAX_DIMENSION a side
# (jdinput.c) and cv2's CV_IO_MAX_IMAGE_PIXELS (validateInputImageSize); a
# larger frame is refused before any decoding
MAX_SIDE = 65500
MAX_PIXELS = 1 << 30


class JPEGError(ValueError):
    """The file is not a JPEG that libjpeg decodes (cv2.imread gives
    None)."""


def _refuse(what: str):
    raise NotImplementedError(f"{what} JPEG files are not decoded yet "
                              f"{ROADMAP}")


@dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int
    width: int = 0      # samples, ceil(X * h / hmax)
    height: int = 0
    bw: int = 0         # block columns and rows allocated (whole MCUs)
    bh: int = 0
    # the quantization table (natural order) latched at the first scan of
    # this component; None until then (its samples then stay 128)
    quant: Optional[np.ndarray] = None


@dataclass
class Scan:
    comps: List[int]                  # indices into Header.components
    td: List[int]
    ta: List[int]
    ss: int
    se: int
    ah: int
    al: int
    restart: int
    start: int                        # entropy-coded data: [start, end)
    end: int
    # the MCU at which the entropy data ran out, -1 where it did not; set
    # by the entropy decoders
    cut: int = -1
    dc_tables: Dict[int, Tuple[tuple, bytes]] = field(default_factory=dict)
    ac_tables: Dict[int, Tuple[tuple, bytes]] = field(default_factory=dict)


@dataclass
class Header:
    width: int
    height: int
    progressive: bool
    components: List[Component]
    hmax: int
    vmax: int
    mcux: int
    mcuy: int
    color: str = "ycc"                # "gray", "ycc" or "rgb"
    orientation: int = 1              # EXIF 1-8 (others: as 1)
    scans: List[Scan] = field(default_factory=list)

    def oriented_size(self) -> Tuple[int, int]:
        """(height, width) of the image as cv2.imread returns it."""
        if self.orientation in (5, 6, 7, 8):
            return self.width, self.height
        return self.height, self.width


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


def exif_orientation(body: bytes) -> int:
    """The orientation tag of an APP1 body as cv2's ExifReader reads it: the
    TIFF header 6 bytes in (the "Exif\\0\\0" identifier is not checked),
    then IFD0's entries in order, the first tag 0x0112's 16-bit value;
    parsing stops at the first read past the end (the entries before it
    count). 1 where there is none."""
    tiff = body[6:]
    n = len(tiff)
    if n < 1 or (n > 1 and tiff[0] != tiff[1]) or tiff[0] not in b"IM":
        return 1
    big = tiff[0] == ord("M")

    def u16(off):
        if off + 1 >= n:
            raise IndexError
        return (tiff[off] << 8 | tiff[off + 1]) if big else \
            (tiff[off] | tiff[off + 1] << 8)

    def u32(off):
        if off + 3 >= n:
            raise IndexError
        v = tiff[off:off + 4]
        return int.from_bytes(v, "big" if big else "little")

    try:
        if u16(2) != 0x2A:
            return 1
        off = u32(4)
        count = u16(off)
        off += 2
        for _ in range(count):
            if u16(off) == 0x0112:
                return u16(off + 8)
            off += 12
    except IndexError:
        pass
    return 1


# what libjpeg's stdio source manager inserts, again and again, when the
# file has no more bytes (jdatasrc.c fill_input_buffer, "Premature end of
# JPEG file"); enough for a segment of any length
_FAKE_EOI = b"\xff\xd9" * 32768


def _next_marker(arr: np.ndarray, pos: int) -> int:
    """Index of the 0xFF that starts the first marker other than RST0-7 at
    or after pos (a run of 0xFF fill bytes counts from its first byte), or
    len(arr): the end of a scan's entropy-coded data."""
    ff = np.flatnonzero(arr[pos:-1] == 0xFF) + pos
    nxt = arr[ff + 1]
    # the byte after a 0xFF is a stuffed 0x00, another 0xFF (fill), RST0-7,
    # or the code of the marker that ends the scan
    hit = np.flatnonzero((nxt != 0x00) & (nxt != 0xFF)
                         & ((nxt < 0xD0) | (nxt > 0xD7)))
    if not hit.size:
        return arr.size
    i = int(ff[hit[0]])
    while i > pos and arr[i - 1] == 0xFF:
        i -= 1
    return i


def parse(data: bytes, headers_only: bool = False) -> Header:
    """The file's header and scans. With headers_only, stops at the first
    SOS header (the header check's work); otherwise reads every scan up to
    EOI or the end of the data."""
    if data[:2] != SOI:
        raise JPEGError("not a JPEG file (no SOI marker)")
    arr = np.frombuffer(data, np.uint8)
    n = len(data)
    pos = 2
    quant: Dict[int, np.ndarray] = {}
    dc: Dict[int, Tuple[tuple, bytes]] = {}
    ac: Dict[int, Tuple[tuple, bytes]] = {}
    restart = 0
    frame = None
    scans: List[Scan] = []
    jfif = False
    adobe = None
    orientation = None
    while True:
        # next marker: skip to 0xFF, swallow fill bytes (libjpeg's
        # next_marker); the end of the data reads as EOI
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0x00:
            continue  # a stuffed byte outside a scan: skipped as garbage
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue  # a stray RST (or TEM): no body
        if marker == 0xD8:
            raise JPEGError("SOI inside the file")
        cut = pos + 2 > n or pos + _u16(data, pos) > n
        if cut and not scans:
            raise JPEGError(f"segment 0x{marker:02X} cut off")
        if cut:
            # after the first scan cv2's source manager reads past the
            # end of the data as EOI markers (FF D9 FF D9 ...): the cut
            # segment is read from those bytes, then the file ends
            src = data[pos:] + _FAKE_EOI
            length = _u16(src, 0)
            body, pos = src[2:length], n
        else:
            length = _u16(data, pos)
            body = data[pos + 2:pos + length]
            pos += length
        if length < 2:
            raise JPEGError(f"segment 0x{marker:02X}: bad length")
        if marker in _SOF_REFUSED:
            _refuse(_SOF_REFUSED[marker])
        if marker == 0xCC:
            _refuse("arithmetic-coded")
        if marker == 0xDE:
            _refuse("hierarchical")
        if marker in _SOF_SUPPORTED:
            if frame is not None:
                raise JPEGError("two frames")
            frame = _read_sof(body, marker)
        elif marker == 0xC4:
            _read_dht(body, dc, ac)
        elif marker == 0xDB:
            _read_dqt(body, quant)
        elif marker == 0xDD:
            if len(body) != 2:
                raise JPEGError("bad DRI length")
            restart = _u16(body, 0)
        elif marker in (_APP0, _APP1, _APP14) and scans:
            pass  # after the first scan: the header is already read
        elif marker == _APP0:
            if len(body) >= 14 and body[:5] == b"JFIF\x00":
                jfif = True
        elif marker == _APP14:
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
        elif marker == _APP1:
            if orientation is None:  # cv2 reads the first APP1 only
                orientation = exif_orientation(body)
        elif marker == 0xDA:
            if frame is None:
                raise JPEGError("SOS before SOF")
            scan = _read_sos(body, frame.components, frame.progressive,
                             restart)
            for c in scan.comps:  # latch quant tables (jdinput.c)
                comp = frame.components[c]
                if comp.quant is None:
                    if comp.tq not in quant:
                        raise JPEGError(f"no quantization table {comp.tq}")
                    comp.quant = quant[comp.tq].copy()
            scan.dc_tables = dict(dc)
            scan.ac_tables = dict(ac)
            scan.start = pos
            if headers_only:
                scans.append(scan)
                break
            pos = _next_marker(arr, pos) if pos < n else n
            scan.end = pos
            scans.append(scan)
        # COM, other APPn, DNL, JPGn and reserved markers with a length:
        # skipped
        if cut:
            break
    if frame is None:
        raise JPEGError("no frame (SOF) marker")
    if not scans:
        raise JPEGError("no scan (SOS) marker")
    comps = frame.components
    if len(comps) == 1:
        frame.color = "gray"
    elif jfif:
        frame.color = "ycc"
    elif adobe is not None:
        frame.color = "rgb" if adobe == 0 else "ycc"
    elif [c.cid for c in comps] == [82, 71, 66]:
        frame.color = "rgb"
    frame.orientation = orientation if orientation in range(1, 9) else 1
    frame.scans = scans
    return frame


def _read_sof(body: bytes, marker: int) -> Header:
    """The frame: its size, components and MCU grid (no scans yet)."""
    if len(body) < 6:
        raise JPEGError("bad SOF length")
    precision, height, width, nf = struct.unpack(">BHHB", body[:6])
    if max(width, height) > MAX_SIDE or width * height > MAX_PIXELS:
        raise JPEGError(f"a {width} x {height} frame: over cv2.imread's "
                        f"limits ({MAX_SIDE} a side, {MAX_PIXELS} pixels)")
    if precision == 12:
        _refuse("12-bit")
    if precision != 8:
        raise JPEGError(f"{precision}-bit samples")
    if height == 0 or width == 0:
        raise JPEGError("empty image (or a DNL height)")
    if nf == 4:
        _refuse("4-component (CMYK/YCCK)")
    if nf not in (1, 3):
        raise JPEGError(f"{nf} components")
    if len(body) != 6 + 3 * nf:
        raise JPEGError("bad SOF length")
    comps = []
    for i in range(nf):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise JPEGError("bad sampling factors or table")
        comps.append(Component(cid, h, v, tq))
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for c in comps:
        if hmax % c.h or vmax % c.v:
            raise JPEGError("fractional sampling factors")
        c.width = -(-width * c.h // hmax)
        c.height = -(-height * c.v // vmax)
        c.bw, c.bh = mcux * c.h, mcuy * c.v
    return Header(width, height, marker == 0xC2, comps, hmax, vmax, mcux,
                  mcuy)


def _read_dht(body: bytes, dc, ac) -> None:
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise JPEGError("bad DHT length")
        index = body[pos]
        bits = tuple(body[pos + 1:pos + 17])
        count = sum(bits)
        pos += 17
        if count > 256 or pos + count > len(body):
            raise JPEGError("bad Huffman table")
        vals = bytes(body[pos:pos + count])
        pos += count
        table = ac if index & 0x10 else dc
        index &= ~0x10
        if index > 3:
            raise JPEGError("bad DHT index")
        table[index] = (bits, vals)


def _read_dqt(body: bytes, quant) -> None:
    pos = 0
    while pos < len(body):
        n = body[pos]
        prec, tq = n >> 4, n & 15
        if tq > 3:
            raise JPEGError("bad DQT index")
        size = 128 if prec else 64
        if pos + 1 + size > len(body):
            raise JPEGError("bad DQT length")
        raw = np.frombuffer(body, ">u2" if prec else np.uint8, 64, pos + 1)
        table = np.zeros(64, np.int32)
        table[list(NATURAL[:64])] = raw
        quant[tq] = table
        pos += 1 + size


def _read_sos(body: bytes, comps: List[Component], progressive: bool,
              restart: int) -> Scan:
    if not body:
        raise JPEGError("bad SOS length")
    ns = body[0]
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise JPEGError("bad SOS length")
    ids = [c.cid for c in comps]
    idx, td, ta = [], [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        if cid not in ids:
            raise JPEGError(f"scan component {cid} not in the frame")
        idx.append(ids.index(cid))
        td.append(t >> 4)
        ta.append(t & 15)
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if ns > 1 and sum(comps[c].h * comps[c].v for c in idx) > 10:
        raise JPEGError("too many blocks in an MCU")
    if progressive:
        # jdphuff.c's checks on the progression parameters
        bad = (ss == 0 and se != 0) or (ss != 0 and (se < ss or se > 63
                                                     or ns != 1))
        bad = bad or (ah != 0 and ah - 1 != al) or al > 13
        if bad:
            raise JPEGError("bad progression parameters")
    if max(td + ta) > 3:
        raise JPEGError("bad Huffman table index")
    return Scan(idx, td, ta, ss, se, ah, al, restart, 0, 0)


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------
_LUT_CACHE: Dict[Tuple[tuple, bytes, bool], np.ndarray] = {}


def huffman_lookup(table: Tuple[tuple, bytes], is_dc: bool) -> np.ndarray:
    """65536 int32 entries, one per 16-bit window: (code length << 8) |
    symbol, or 0 where no code of 16 bits or fewer starts the window.
    Raises JPEGError for a table jpeg_make_d_derived_tbl refuses. Cached
    by content: a folder's files mostly share their tables."""
    key = (table[0], bytes(table[1]), is_dc)
    lut = _LUT_CACHE.get(key)
    if lut is not None:
        return lut
    bits, vals = table
    lut = np.zeros(65536, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if is_dc and vals[k] > 15:
                raise JPEGError("bad DC Huffman symbol")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | vals[k]
            code += 1
            k += 1
        if code >= (1 << length):
            raise JPEGError("bad Huffman table")
        code <<= 1
    if len(_LUT_CACHE) > 64:
        _LUT_CACHE.clear()
    _LUT_CACHE[key] = lut
    return lut


def huffman_codes(table) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of each of the 256 symbols of a (bits, values) table
    (length 0: not coded), as jchuff.c's jpeg_make_c_derived_tbl."""
    bits, vals = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def baseline_headers(width: int, height: int, qtables) -> bytes:
    """SOI to SOS of a baseline 4:2:0 YCbCr file as libjpeg-turbo writes
    it under Pillow's save(quality=q): JFIF 1.01 APP0 (no density unit,
    1:1), one DQT per table (zigzag order), SOF0 (components 1-3, Y 2x2 on
    table 0, Cb and Cr 1x1 on table 1), one DHT per standard table (luma
    DC, AC, chroma DC, AC), SOS over the three components."""
    out = [SOI, _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate(qtables):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            q[i] for i in NATURAL[:64])))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_t, (bits, vals) in ((0x00, STD_DC_LUMA), (0x10, STD_AC_LUMA),
                                (0x01, STD_DC_CHROMA),
                                (0x11, STD_AC_CHROMA)):
        out.append(_segment(0xC4, bytes([cls_t]) + bytes(bits)
                            + bytes(vals)))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                     0])))
    return b"".join(out)


def scan_table(scan: Scan, i: int, is_dc: bool) -> Tuple[tuple, bytes]:
    """Scan component i's DC or AC table; the standard table where a file
    defines none of number 0 or 1, as libjpeg-turbo does (Motion-JPEG)."""
    num = scan.td[i] if is_dc else scan.ta[i]
    table = (scan.dc_tables if is_dc else scan.ac_tables).get(num)
    if table is None:
        if num > 1:
            raise JPEGError(f"Huffman table {num} not defined")
        table = ((STD_DC_LUMA, STD_DC_CHROMA) if is_dc else
                 (STD_AC_LUMA, STD_AC_CHROMA))[num]
    return table


def scan_blocks(header: Header, scan: Scan):
    """(MCU count, blocks of one MCU as (scan component, block row offset,
    block col offset) in order, MCUs across) of a scan: a non-interleaved
    scan's MCU is one block of the component's own block grid."""
    if len(scan.comps) == 1:
        c = header.components[scan.comps[0]]
        across = -(-c.width // 8)
        return across * -(-c.height // 8), [(0, 0, 0)], across
    blocks = [(i, by, bx) for i, ci in enumerate(scan.comps)
              for by in range(header.components[ci].v)
              for bx in range(header.components[ci].h)]
    return header.mcux * header.mcuy, blocks, header.mcux


# ---------------------------------------------------------------------------
# block smoothing: what jdcoefct.c decides on the host
# ---------------------------------------------------------------------------
SAVED_COEFS = 10  # the DC and the first 9 AC coefficients (zigzag order)
# natural positions of zigzag 1..9, jdcoefct.c's Q01_POS .. Q30_POS
SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)


@dataclass
class Smoothing:
    """jdcoefct.c's block smoothing of a progressive file, as libjpeg-turbo
    3.1 sets it up (smoothing_ok): per component, the coefficient-bit
    latches of the last scan's state (`cur`) and of the state before it
    (`prev`), each SAVED_COEFS long (-1: no scan yet, 0: exact, Al > 0:
    known up to bit Al), or None where the component is skipped (its DC
    not yet begun, or a zero among its DC and first 9 AC quantizers); and
    the last iMCU row the last scan decoded in full. Rows past it take
    `prev`."""
    cur: List[Optional[Tuple[int, ...]]]
    prev: List[Optional[Tuple[int, ...]]]
    last_good_row: int


def block_smoothing(header: Header) -> Optional[Smoothing]:
    """The smoothing libjpeg applies to this file's coefficients, or None
    (a baseline file, or every latched coefficient of 1..9 exact).

    coef_bits follows jdphuff.c's start_pass: at each scan's start, before
    its data is read (so a scan cut partway counts as begun), the state of
    coefficients min(Ss, 1)..max(Se, 9) of its components is saved as the
    previous one (0 in the first scan), and Ss..Se take Al. The last
    scan's `cut` (set by the entropy decoder) gives the last good iMCU
    row."""
    if not header.progressive:
        return None
    n = len(header.components)
    cur = [[-1] * 64 for _ in range(n)]
    prev = [[-1] * 64 for _ in range(n)]
    for number, scan in enumerate(header.scans, 1):
        for ci in scan.comps:
            for k in range(min(scan.ss, 1), max(scan.se, 9) + 1):
                prev[ci][k] = cur[ci][k] if number > 1 else 0
            for k in range(scan.ss, scan.se + 1):
                cur[ci][k] = scan.al
    several = len(header.scans) > 1
    latch_cur, latch_prev = [], []
    useful = False
    for ci, comp in enumerate(header.components):
        q = comp.quant
        if q is None or cur[ci][0] < 0 or not q[0] or \
                not all(q[p] for p in SMOOTH_POS):
            latch_cur.append(None)
            latch_prev.append(None)
            continue
        latch_cur.append(tuple(cur[ci][:SAVED_COEFS]))
        latch_prev.append((cur[ci][0],) + tuple(
            prev[ci][k] if several else -1 for k in range(1, SAVED_COEFS)))
        useful |= any(cur[ci][1:SAVED_COEFS])
    if not useful:
        return None
    last = header.scans[-1]
    rows = header.mcuy
    good = rows - 1
    if last.cut >= 0:
        _, _, across = scan_blocks(header, last)
        row = last.cut // across
        if len(last.comps) == 1:
            row //= header.components[last.comps[0]].v
        good = row
    return Smoothing(latch_cur, latch_prev, good)


# ---------------------------------------------------------------------------
# the plain entropy decoder
# ---------------------------------------------------------------------------
class _Bits:
    """libjpeg's bit reader over a scan's bytes [pos, end): 0xFF 0x00 is a
    0xFF data byte, 0xFF fill bytes are skipped, any other 0xFF xx (or the
    end) is a marker, after which zeros are read and `short` is set once a
    bit beyond the real data is taken."""

    __slots__ = ("data", "pos", "end", "acc", "nb", "pad", "marker",
                 "short")

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.acc = self.nb = self.pad = 0
        self.marker = None  # the pending marker's code (0x100: the end)
        self.short = False

    def fill(self) -> None:
        """Load bytes until 25 bits are buffered (zeros past a marker)."""
        data, end = self.data, self.end
        acc, nb, pos = self.acc, self.nb, self.pos
        while nb < 25:
            if self.marker is None:
                if pos >= end:
                    self.marker = 0x100
                    continue
                c = data[pos]
                pos += 1
                if c == 0xFF:
                    while pos < end and data[pos] == 0xFF:
                        pos += 1
                    if pos >= end:
                        self.marker = 0x100
                        continue
                    c = data[pos]
                    pos += 1
                    if c != 0:
                        self.marker = c
                        continue
                    c = 0xFF
                acc = (acc << 8) | c
            else:
                acc <<= 8
                self.pad += 8
            nb += 8
        self.acc, self.nb, self.pos = acc & ((1 << nb) - 1), nb, pos

    def take(self, k: int) -> int:
        if self.nb < k:
            self.fill()
        self.nb -= k
        if self.nb < self.pad:
            self.short = True
            self.pad = self.nb
        return (self.acc >> self.nb) & ((1 << k) - 1)

    def huff(self, lut: list) -> int:
        if self.nb < 16:
            self.fill()
        e = lut[(self.acc >> (self.nb - 16)) & 0xFFFF]
        if not e:  # no code of 16 bits or fewer: libjpeg gives 0 after 17
            self.take(16)
            self.take(1)
            return 0
        self.take(e >> 8)
        return e & 0xFF

    def restart(self, expected: int) -> bool:
        """At a restart boundary: drop the buffered bits, find the next
        marker and resync as jpeg_resync_to_restart does. True where the
        out-of-data flag is cleared (the marker was swallowed)."""
        self.acc = self.nb = self.pad = 0
        while True:
            if self.marker is None:
                self._skip_to_marker()
            m = self.marker
            if m == 0xD0 + expected:
                action = 1
            elif m == 0x100 or m >= 0xC0 and not 0xD0 <= m <= 0xD7:
                action = 3
            elif m < 0xC0:
                action = 2
            elif m in (0xD0 + ((expected + 1) & 7), 0xD0 + ((expected + 2) & 7)):
                action = 3
            elif m in (0xD0 + ((expected - 1) & 7), 0xD0 + ((expected - 2) & 7)):
                action = 2
            else:
                action = 1
            if action == 1:
                self.marker = None
                return True
            if action == 3:
                return False
            self.marker = None  # 2: scan to the next marker and decide again

    def _skip_to_marker(self) -> None:
        data, end, pos = self.data, self.end, self.pos
        while True:
            while pos < end and data[pos] != 0xFF:
                pos += 1
            while pos < end and data[pos] == 0xFF:
                pos += 1
            if pos >= end:
                self.marker = 0x100
                break
            c = data[pos]
            pos += 1
            if c != 0:
                self.marker = c
                break
        self.pos = pos


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def decode_scans(header: Header, data: bytes) -> List[np.ndarray]:
    """Every scan's coefficients, one (bh, bw, 64) int16 array a component
    (natural order), with the Python bit reader: the plain version of the
    C decoder."""
    coefs = [[0] * (c.bh * c.bw * 64) for c in header.components]
    for scan in header.scans:
        _decode_scan(header, scan, data, coefs)
    return [np.array(flat, np.int64).astype(np.int16).reshape(c.bh, c.bw, 64)
            for flat, c in zip(coefs, header.components)]


def _decode_scan(header: Header, scan: Scan, data: bytes, coefs) -> None:
    comps = [header.components[i] for i in scan.comps]
    stores = [coefs[i] for i in scan.comps]
    n_mcu, blocks, across = scan_blocks(header, scan)
    progressive = header.progressive
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    dc_refine = progressive and ss == 0 and ah != 0
    ac_first = progressive and ss != 0 and ah == 0
    need_dc = not progressive or (ss == 0 and ah == 0)
    need_ac = not progressive or ss != 0
    dc_lut = [huffman_lookup(scan_table(scan, i, True), True).tolist()
              if need_dc else None for i in range(len(comps))]
    ac_lut = [huffman_lookup(scan_table(scan, i, False), False).tolist()
              if need_ac else None for i in range(len(comps))]
    bits = _Bits(data, scan.start, scan.end)
    scan.cut = -1
    last_dc = [0] * len(comps)
    eobrun = 0
    restarts_to_go = scan.restart
    next_rst = 0
    short = False
    nat = NATURAL
    p1, m1 = 1 << al, -1 << al
    single = len(comps) == 1
    for mcu in range(n_mcu):
        if scan.restart:
            if restarts_to_go == 0:
                if bits.restart(next_rst):
                    short = False
                    scan.cut = -1
                bits.short = False
                next_rst = (next_rst + 1) & 7
                last_dc = [0] * len(comps)
                eobrun = 0
                restarts_to_go = scan.restart
            restarts_to_go -= 1
        my, mx = divmod(mcu, across)
        if short:
            # out of data: the MCU keeps what it has (a DC refinement would
            # read zeros, which change nothing)
            continue
        for i, by, bx in blocks:
            comp = comps[i]
            if single:
                row, col = my, mx
            else:
                row, col = my * comp.v + by, mx * comp.h + bx
            base = (row * comp.bw + col) * 64
            store = stores[i]
            if dc_refine:
                if bits.take(1):
                    store[base] |= p1
                continue
            if need_dc:
                s = bits.huff(dc_lut[i])
                diff = _extend(bits.take(s), s) if s else 0
                v = (last_dc[i] + diff + 2 ** 31) % 2 ** 32 - 2 ** 31
                last_dc[i] = v
                if not progressive:
                    blk = [0] * 64
                    blk[0] = v
                    k = 1
                    lut = ac_lut[i]
                    while k < 64:
                        rs = bits.huff(lut)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[nat[k]] = _extend(bits.take(s), s)
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                    store[base:base + 64] = blk
                else:
                    store[base] = v << al
                continue
            if ac_first:
                if eobrun:
                    eobrun -= 1
                    continue
                lut = ac_lut[i]
                k = ss
                while k <= se:
                    rs = bits.huff(lut)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        store[base + nat[k]] = _extend(bits.take(s), s) << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (bits.take(r) if r else 0) - 1
                        break
                    k += 1
                continue
            # AC refinement (jdphuff.c decode_mcu_AC_refine)
            lut = ac_lut[i]
            blk = store[base:base + 64]
            k = ss
            if eobrun == 0:
                while k <= se:
                    rs = bits.huff(lut)
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if bits.take(1) else m1
                    elif r != 15:
                        eobrun = (1 << r) + (bits.take(r) if r else 0)
                        break
                    while k <= se:
                        z = nat[k]
                        c = _i16(blk[z])
                        if c:
                            if bits.take(1) and not c & p1:
                                blk[z] = c + (p1 if c >= 0 else m1)
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        blk[nat[k]] = s
                    k += 1
            if eobrun > 0:
                while k <= se:
                    z = nat[k]
                    c = _i16(blk[z])
                    if c and bits.take(1) and not c & p1:
                        blk[z] = c + (p1 if c >= 0 else m1)
                    k += 1
                eobrun -= 1
            store[base:base + 64] = blk
        if bits.short and not short:
            short = True
            scan.cut = mcu


def _i16(v: int) -> int:
    """v as the int16 JCOEF libjpeg stores it."""
    return (v + 32768) % 65536 - 32768
