"""An MP4 writer for MPEG-4 Part 2 Simple Profile video: the codec of
cv2.VideoWriter_fourcc(*"mp4v"), which the JAX package's comparison videos
use, written without cv2 or FFmpeg.

Each new frame is an intra VOP (I-VOP); each repeat of it is a P-VOP whose
macroblocks are all not_coded, which a decoder gives as another copy of
the frame (a VOP with vop_coded = 0 would be dropped by FFmpeg's decoder,
and the frame count would not be the writer's). The intra coding is the
standard's with the fewest tables: H.263 quantization at a fixed vop_quant
(QUANT), the DC by dct_dc_size (the luminance and chrominance VLCs) after
the gradient DC prediction, every AC coefficient by the third escape's
fixed-length code, no AC prediction, no resync markers. Frames are BGR
uint8 (cv2's order), converted to 4:2:0 YCbCr in ITU-R BT.601's video
range (what FFmpeg assumes for this codec), padded to whole macroblocks by
repeating the edge; the forward DCT and quantization run as torch ops on
the frame's device, the bits are packed with numpy on the host.

The container is ftyp, mdat (the VOPs, one sample each, in one chunk),
then moov with one video track: the VOS/VO/VOL headers as the esds
DecoderSpecificInfo (object type 0x20), and stts, stss (the I-VOPs),
stsz, stsc and stco. The frame rate, size and frame count are the writer's
arguments and writes, as in cv2's file; the coded bytes are not cv2's
(FFmpeg's encoder chooses other modes, tables and rates), so a player's
pixels differ from cv2's file by the coding loss of each.

    w = Mp4vWriter(path, fps, (width, height))
    w.write(frame_bgr, hold=n)   # the frame, shown n times
    w.release()
"""
from __future__ import annotations

import functools
import math
import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

QUANT = 2  # vop_quant: a DC scaler of 8, AC steps of 4
PROFILE_LEVEL = 0x03  # Simple Profile (the level is not enforced)
# dct_dc_size VLCs (code, length), sizes 0..12: luminance, chrominance
DC_LUMA = ((3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6),
           (1, 7), (1, 8), (1, 9), (1, 10), (1, 11))
DC_CHROMA = ((3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6),
             (1, 7), (1, 8), (1, 9), (1, 10), (1, 11), (1, 12))
# intra MCBPC (mb_type 3) by cbpc, CBPY by the four luma bits (Y0 high)
MCBPC_INTRA = ((1, 1), (1, 3), (2, 3), (3, 3))
CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def dc_scaler(q: int, luma: bool) -> int:
    """The intra DC quantizer's step for vop_quant q (ISO 14496-2 Table
    7-1)."""
    if q <= 4:
        return 8
    if luma:
        return 2 * q if q <= 8 else q + 8 if q <= 24 else 2 * q - 16
    return (q + 13) // 2 if q <= 24 else q - 6


def pack_bits(vals, lens) -> bytes:
    """The codes (value, length in bits, MSB first) concatenated, then
    next_start_code()'s stuffing: a zero bit and ones to the byte."""
    vals = np.asarray(vals, np.uint64)
    lens = np.asarray(lens, np.int64)
    pad = 7 - int(lens.sum()) % 8
    vals = np.append(vals, np.uint64((1 << pad) - 1))
    lens = np.append(lens, pad + 1)
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    item = np.repeat(np.arange(lens.size), lens)
    pos = np.arange(total) - starts[item]
    shift = (lens[item] - 1 - pos).astype(np.uint64)
    bits = ((vals[item] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits).tobytes()


class _Bits:
    """A list of codes, packed once."""

    def __init__(self):
        self.vals: List[int] = []
        self.lens: List[int] = []

    def put(self, value: int, length: int) -> None:
        self.vals.append(value)
        self.lens.append(length)

    def start_code(self, code: int) -> None:
        self.put(0x000001, 24)
        self.put(code, 8)

    def stuff(self) -> None:
        """next_start_code() inside the headers."""
        pad = 7 - sum(self.lens) % 8
        self.put((1 << pad) - 1, pad + 1)


def vol_headers(width: int, height: int, fps: int) -> bytes:
    """Visual object sequence, visual object, video object and video
    object layer headers (version 1, rectangular, Simple object)."""
    b = _Bits()
    b.start_code(0xB0)
    b.put(PROFILE_LEVEL, 8)
    b.start_code(0xB5)
    b.put(0, 1)  # is_visual_object_identifier
    b.put(1, 4)  # visual_object_type: video
    b.put(0, 1)  # video_signal_type
    b.stuff()
    b.start_code(0x00)  # video_object_start_code
    b.start_code(0x20)  # video_object_layer_start_code
    b.put(0, 1)  # random_accessible_vol
    b.put(1, 8)  # video_object_type_indication: Simple
    b.put(0, 1)  # is_object_layer_identifier
    b.put(1, 4)  # aspect_ratio_info: square pixels
    b.put(1, 1)  # vol_control_parameters
    b.put(1, 2)  # chroma_format 4:2:0
    b.put(1, 1)  # low_delay
    b.put(0, 1)  # vbv_parameters
    b.put(0, 2)  # video_object_layer_shape: rectangular
    b.put(1, 1)
    b.put(fps, 16)  # vop_time_increment_resolution
    b.put(1, 1)
    b.put(1, 1)  # fixed_vop_rate
    b.put(1, _time_bits(fps))  # fixed_vop_time_increment
    b.put(1, 1)
    b.put(width, 13)
    b.put(1, 1)
    b.put(height, 13)
    b.put(1, 1)
    b.put(0, 1)  # interlaced
    b.put(1, 1)  # obmc_disable
    b.put(0, 1)  # sprite_enable
    b.put(0, 1)  # not_8_bit
    b.put(0, 1)  # quant_type: H.263
    b.put(1, 1)  # complexity_estimation_disable
    b.put(1, 1)  # resync_marker_disable
    b.put(0, 1)  # data_partitioned
    b.put(0, 1)  # scalability
    return pack_bits(b.vals, b.lens)


def _time_bits(fps: int) -> int:
    return max(1, math.ceil(math.log2(fps))) if fps > 1 else 1


def _vop_header(b: _Bits, coding_type: int, seconds: int, tick: int,
                fps: int) -> None:
    b.start_code(0xB6)
    b.put(coding_type, 2)
    for _ in range(seconds):
        b.put(1, 1)  # modulo_time_base
    b.put(0, 1)
    b.put(1, 1)
    b.put(tick, _time_bits(fps))
    b.put(1, 1)
    b.put(1, 1)  # vop_coded
    if coding_type == 1:
        b.put(0, 1)  # vop_rounding_type
    b.put(0, 3)  # intra_dc_vlc_thr: always the DC VLC
    b.put(QUANT, 5)
    if coding_type == 1:
        b.put(1, 3)  # vop_fcode_forward


def _ycc(frame: torch.Tensor, ph: int, pw: int) -> List[torch.Tensor]:
    """BGR uint8 (H, W, 3) → Y (ph, pw), Cb, Cr (ph/2, pw/2) float, BT.601
    video range, the edges repeated out to (ph, pw)."""
    h, w = frame.shape[:2]
    ri = torch.arange(ph, device=frame.device).clamp(max=h - 1)
    ci = torch.arange(pw, device=frame.device).clamp(max=w - 1)
    x = frame[ri][:, ci].to(torch.float32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    cb = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    cr = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    sub = [c.reshape(ph // 2, 2, pw // 2, 2).mean(dim=(1, 3))
           for c in (cb, cr)]
    return [t.round().clamp(0, 255) for t in [y] + sub]


@functools.lru_cache(maxsize=4)
def _dct_matrix(device) -> torch.Tensor:
    u = torch.arange(8, dtype=torch.float64)[:, None]
    x = torch.arange(8, dtype=torch.float64)[None, :]
    c = torch.cos((2 * x + 1) * u * math.pi / 16) * math.sqrt(2 / 8)
    c[0] /= math.sqrt(2)
    return c.to(device=device, dtype=torch.float32)


def _blocks(p: torch.Tensor) -> torch.Tensor:
    """(8 m, 8 n) → (m, n, 8, 8)."""
    h, w = p.shape
    return p.reshape(h // 8, 8, w // 8, 8).transpose(1, 2)


def intra_levels(frame: torch.Tensor) -> Tuple[np.ndarray, int, int]:
    """The quantized blocks of an I-VOP in coding order: (levels (mbs, 6,
    64) int32 in zigzag order, the DC quantized by dc_scaler, the AC by
    H.263's intra rule at QUANT, with the nearest reconstruction level;
    the macroblock rows and columns)."""
    h, w = frame.shape[:2]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    y, cb, cr = _ycc(frame, ph, pw)
    c = _dct_matrix(frame.device)
    mh, mw = ph // 16, pw // 16
    yb = _blocks(y).reshape(mh, 2, mw, 2, 8, 8).permute(0, 2, 1, 3, 4, 5)
    yb = yb.reshape(mh, mw, 4, 8, 8)
    cbb = _blocks(cb).reshape(mh, mw, 1, 8, 8)
    crb = _blocks(cr).reshape(mh, mw, 1, 8, 8)
    blocks = torch.cat([yb, cbb, crb], dim=2)  # (mh, mw, 6, 8, 8)
    coef = (c @ blocks @ c.T).reshape(mh, mw, 6, 64)
    zz = torch.as_tensor(ZIGZAG, device=frame.device)
    coef = coef[..., zz]
    q = QUANT
    e = 1 if q % 2 == 0 else 0
    mag = coef[..., 1:].abs()
    lev = torch.floor((mag + e) / (2 * q)).clamp(min=1)
    lev = torch.where(mag < (3 * q - e) / 2, torch.zeros_like(lev), lev)
    ac = (torch.sign(coef[..., 1:]) * lev).clamp(-2047, 2047)
    scal = torch.tensor([dc_scaler(q, True)] * 4 + [dc_scaler(q, False)] * 2,
                        device=frame.device, dtype=torch.float32)
    dc = torch.round(coef[..., 0] / scal).clamp(1, 254)
    levels = torch.cat([dc[..., None], ac], dim=-1).to(torch.int32)
    return levels.reshape(mh * mw, 6, 64).cpu().numpy(), mh, mw


def _dc_predictions(levels: np.ndarray, mh: int, mw: int) -> np.ndarray:
    """The predicted quantized DC of every block (mbs, 6), by the gradient
    rule over the left (A), upper-left (B) and upper (C) blocks of the same
    component, 1024 (a quantized 128 at a DC scaler of 8) outside the
    VOP."""
    dc = levels[..., 0].reshape(mh, mw, 6).astype(np.int64)
    out = np.empty((mh, mw, 6), np.int64)
    luma = dc[..., :4].reshape(mh, mw, 2, 2).transpose(0, 2, 1, 3).reshape(
        2 * mh, 2 * mw)
    grids = [(luma, True), (dc[..., 4], False), (dc[..., 5], False)]
    preds = []
    for g, _ in grids:
        p = np.pad(g, ((1, 0), (1, 0)), constant_values=128)
        a, b, c = p[1:, :-1], p[:-1, :-1], p[:-1, 1:]
        preds.append(np.where(np.abs(a - b) < np.abs(b - c), c, a))
    lp = preds[0].reshape(mh, 2, mw, 2).transpose(0, 2, 1, 3).reshape(
        mh, mw, 4)
    out[..., :4] = lp
    out[..., 4] = preds[1]
    out[..., 5] = preds[2]
    return out.reshape(mh * mw, 6)


def _dc_codes(diff: np.ndarray, luma: np.ndarray):
    """(size code, size length, differential value, its length) of each
    DC difference."""
    size = np.where(diff == 0, 0, np.floor(np.log2(np.maximum(
        np.abs(diff), 1))).astype(np.int64) + 1)
    lum = np.array(DC_LUMA, np.int64)
    chrom = np.array(DC_CHROMA, np.int64)
    table = np.where(luma[..., None], lum[size], chrom[size])
    value = np.where(diff < 0, diff + (1 << size) - 1, diff)
    return table[..., 0], table[..., 1], value, size


def encode_intra(frame: torch.Tensor, seconds: int, tick: int,
                 fps: int) -> bytes:
    """One I-VOP of a BGR frame."""
    levels, mh, mw = intra_levels(frame)
    mbs = mh * mw
    pred = _dc_predictions(levels, mh, mw)
    diff = levels[..., 0].astype(np.int64) - pred
    luma = np.broadcast_to(np.array([True] * 4 + [False] * 2), (mbs, 6))
    dcc, dcl, dcv, dcs = _dc_codes(diff, luma)
    ac = levels[..., 1:].reshape(mbs * 6, 63)
    coded = (ac != 0).any(axis=1).reshape(mbs, 6)
    cbpc = coded[:, 4] * 2 + coded[:, 5]
    cbpy = coded[:, 0] * 8 + coded[:, 1] * 4 + coded[:, 2] * 2 + coded[:, 3]
    mcbpc = np.array(MCBPC_INTRA, np.int64)[cbpc]
    cbpy_c = np.array(CBPY, np.int64)[cbpy]
    # the AC escapes: (block, position) of each nonzero level, in order
    blk, pos = np.nonzero(ac)
    lev = ac[blk, pos].astype(np.int64)
    zpos = pos + 1
    first = np.ones(blk.size, bool)
    first[1:] = blk[1:] != blk[:-1]
    last = np.ones(blk.size, bool)
    last[:-1] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], zpos[:-1]]))
    run = zpos - prev - 1
    esc = ((3 << 23) | (3 << 21) | (last.astype(np.int64) << 20)
           | (run << 14) | (1 << 13) | ((lev & 0xFFF) << 1) | 1)
    # item counts: per block 1 + (dc size > 0) + its escapes; per MB 3 more
    nnz = np.bincount(blk, minlength=mbs * 6).reshape(mbs, 6)
    per_block = 1 + (dcs > 0) + nnz
    per_mb = 3 + per_block.sum(axis=1)
    mb_start = np.cumsum(per_mb) - per_mb
    blk_start = (mb_start[:, None] + 3
                 + np.cumsum(per_block, axis=1) - per_block)
    total = int(per_mb.sum())
    vals = np.zeros(total, np.int64)
    lens = np.zeros(total, np.int64)
    vals[mb_start], lens[mb_start] = mcbpc[:, 0], mcbpc[:, 1]
    lens[mb_start + 1] = 1  # ac_pred_flag 0
    vals[mb_start + 2], lens[mb_start + 2] = cbpy_c[:, 0], cbpy_c[:, 1]
    vals[blk_start], lens[blk_start] = dcc, dcl
    has = dcs > 0
    vals[(blk_start + 1)[has]] = dcv[has]
    lens[(blk_start + 1)[has]] = dcs[has]
    rank = np.arange(blk.size) - (np.cumsum(nnz.ravel()) - nnz.ravel())[blk]
    slot = (blk_start + 1 + has).ravel()[blk] + rank
    vals[slot], lens[slot] = esc, 30
    head = _Bits()
    _vop_header(head, 0, seconds, tick, fps)
    return pack_bits(np.concatenate([head.vals, vals]),
                     np.concatenate([head.lens, lens]))


def encode_skip(mbs: int, seconds: int, tick: int, fps: int) -> bytes:
    """A P-VOP whose macroblocks are all not_coded: the last frame again."""
    b = _Bits()
    _vop_header(b, 1, seconds, tick, fps)
    return pack_bits(np.concatenate([b.vals, np.ones(mbs, np.int64)]),
                     np.concatenate([b.lens, np.ones(mbs, np.int64)]))


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)
    size = bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F])
    return bytes([tag]) + size + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def mp4_file(samples: Sequence[bytes], sync: Sequence[int], width: int,
             height: int, fps: int, decoder_info: bytes) -> bytes:
    """ftyp + mdat + moov around the samples (sync: 1-based I-VOP
    numbers)."""
    n = len(samples)
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isom", b"iso2", b"mp41")
    mdat = _box(b"mdat", *samples)
    chunk_offset = len(ftyp) + 8
    duration_ms = int(round(n * 1000 / fps))
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000,
                                            duration_ms),
                 struct.pack(">IH", 0x10000, 0x100), b"\0" * 10, _MATRIX,
                 b"\0" * 24, struct.pack(">I", 2))
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0,
                                            duration_ms),
                 b"\0" * 8, struct.pack(">HHHH", 0, 0, 0, 0), _MATRIX,
                 struct.pack(">II", width << 16, height << 16))
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, fps, n),
                 struct.pack(">HH", 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide", b"\0" * 12,
                 b"VideoHandler\0")
    vmhd = _full(b"vmhd", 0, 1, b"\0" * 8)
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                               _full(b"url ", 0, 1)))
    dcd = _descriptor(0x04, bytes([0x20, 0x11]) + b"\0\0\0"
                      + struct.pack(">II", 0, 0)
                      + _descriptor(0x05, decoder_info))
    esd = _descriptor(0x03, struct.pack(">HB", 1, 0) + dcd
                      + _descriptor(0x06, b"\x02"))
    esds = _full(b"esds", 0, 0, esd)
    mp4v = _box(b"mp4v", b"\0" * 6, struct.pack(">H", 1), b"\0" * 16,
                struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0,
                            1), b"\0" * 32, struct.pack(">Hh", 0x18, -1),
                esds)
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), mp4v)
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
    stss = _full(b"stss", 0, 0, struct.pack(">I", len(sync)),
                 struct.pack(f">{len(sync)}I", *sync))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                 struct.pack(f">{n}I", *(len(s) for s in samples)))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
    stbl = _box(b"stbl", stsd, stts, stss, stsz, stsc, stco)
    minf = _box(b"minf", vmhd, dinf, stbl)
    mdia = _box(b"mdia", mdhd, hdlr, minf)
    trak = _box(b"trak", tkhd, mdia)
    moov = _box(b"moov", mvhd, trak)
    return ftyp + mdat + moov


class Mp4vWriter:
    """cv2.VideoWriter(path, fourcc("mp4v"), fps, (width, height)) with a
    `hold` argument: write(frame, hold=n) codes the frame once and shows
    it n times. Frames are (height, width, 3) BGR uint8 tensors (or numpy
    arrays) of the writer's size; the file is written at release()."""

    def __init__(self, path, fps: int, size: Tuple[int, int]):
        self.path = str(path)
        self.fps = int(fps)
        self.width, self.height = (int(v) for v in size)
        if self.fps < 1 or self.width < 1 or self.height < 1:
            raise ValueError(f"fps {fps}, size {size}")
        if self.width > 8191 or self.height > 8191:
            raise ValueError(f"size {size}: the VOL holds 13 bits a side")
        self.samples: List[bytes] = []
        self.sync: List[int] = []
        self.frames_coded = 0
        self._mbs = (-(-self.width // 16)) * (-(-self.height // 16))

    def _time(self) -> Tuple[int, int]:
        t = len(self.samples)
        prev = (t - 1) // self.fps if t else 0
        return t // self.fps - prev, t % self.fps

    def write(self, frame, hold: int = 1) -> None:
        frame = torch.as_tensor(frame)
        if tuple(frame.shape) != (self.height, self.width, 3) or \
                frame.dtype != torch.uint8:
            raise ValueError(f"frame {tuple(frame.shape)} {frame.dtype}: "
                             f"expected ({self.height}, {self.width}, 3) "
                             f"uint8")
        for i in range(hold):
            sec, tick = self._time()
            if i == 0:
                self.sync.append(len(self.samples) + 1)
                self.samples.append(encode_intra(frame, sec, tick, self.fps))
                self.frames_coded += 1
            else:
                self.samples.append(encode_skip(self._mbs, sec, tick,
                                                self.fps))

    def release(self) -> None:
        if not self.samples:
            return
        data = mp4_file(self.samples, self.sync, self.width, self.height,
                        self.fps, vol_headers(self.width, self.height,
                                              self.fps))
        with open(self.path, "wb") as f:
            f.write(data)
