"""BMP files through the port's reader (utils/bmp.py by way of
utils/image_io.py) against cv2.imread and PIL, byte for byte:

  read_rgb(p)          == cv2.cvtColor(cv2.imread(p), BGR2RGB)
  read_gray(p)         == cv2.imread(p, IMREAD_GRAYSCALE)
  check_image(p)       == cv2.imread(p).shape[:2]
  read_rgba_tensor(p)  == np.asarray(PIL.Image.open(p).convert("RGBA"))

over BITMAPCOREHEADER, BITMAPINFOHEADER and V4/V5 headers; 1, 4, 8, 16
(5-5-5 and BI_BITFIELDS 5-6-5), 24 and 32-bit pixels (with and without an
alpha mask); RLE8 and RLE4 with end-of-line, delta and end-of-bitmap
escapes; top-down and bottom-up rows; palettes shorter than the depth
allows. The files are written at test time: by cv2, by Pillow, and by the
writer below. A file either library refuses raises one of
image_io.UNREADABLE in the port. Tolerance: none.
"""
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from unet_watermark_tpu_torch.utils import bmp, image_io

H, W = 13, 11


def write_bmp(px, bpp, *, header=40, comp=0, palette=None, colors=None,
              masks=None, top_down=False, rle=None):
    """A BMP of px: (H, W) palette indices for bpp <= 8 (palette: (N, 3)
    RGB), (H, W) uint16 values for 16, (H, W, 3) RGB or (H, W, 4) RGBA
    for 24 and 32 (a fourth byte 0x5A where px has none); `rle` replaces
    the rows with a run stream."""
    h, w = px.shape[:2]
    pal = b""
    if bpp <= 8:
        pal_arr = np.asarray(palette, np.uint8)
        pad = [] if header == 12 else [np.zeros((len(pal_arr), 1), np.uint8)]
        pal = np.concatenate([pal_arr[:, ::-1]] + pad, 1).tobytes()
    if rle is not None:
        body = rle
    else:
        pitch = ((w * bpp + 7) // 8 + 3) & ~3
        rows = []
        for y in range(h):
            r = px[y]
            if bpp <= 8:
                per = 8 // bpp
                vals = np.zeros(-(-w // per) * per, np.int64)
                vals[:w] = r
                shifts = np.arange(8 - bpp, -1, -bpp)
                row = (vals.reshape(-1, per) << shifts).sum(1).astype(
                    np.uint8).tobytes()
            elif bpp == 16:
                row = np.asarray(r, "<u2").tobytes()
            elif bpp == 24:
                row = r[:, ::-1].tobytes()
            elif r.shape[1] == 4:
                row = np.concatenate([r[:, 2::-1], r[:, 3:]], 1).tobytes()
            else:
                row = np.concatenate([r[:, ::-1], np.full((w, 1), 0x5A,
                                                          np.uint8)],
                                     1).tobytes()
            rows.append(row + bytes(pitch - len(row)))
        body = b"".join(rows if top_down else rows[::-1])
    extra = struct.pack("<3I", *masks[:3]) if comp == 3 and header == 40 \
        else b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bpp, comp, len(body), 2835, 2835,
                           colors or 0, 0)
        if header >= 52:
            m = list(masks or ()) + [0] * 4
            info += struct.pack("<4I", *m[:4])[:header - 40]
            info += bytes(header - len(info))
    off = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info
            + extra + pal + body)


def rle_encode(idx, rle4=False, eol=True, eob=True, deltas=()):
    """An RLE8/RLE4 stream of (H, W) indices, bottom row first: runs of a
    value (RLE8) or of an alternating pair (RLE4) as encoded runs, the
    rest as absolute runs padded to a word; deltas: (row, x, dx, dy)
    escapes written where the encoder reaches (row, x)."""
    h, w = idx.shape
    out = bytearray()
    rows = idx[::-1]
    skip = {(r, x): (dx, dy) for r, x, dx, dy in deltas}
    y = 0
    while y < h:
        r, x = rows[y], 0
        while x < w:
            if (y, x) in skip:
                dx, dy = skip[(y, x)]
                out += bytes([0, 2, dx, dy])
                y, x = y + dy, x + dx
                if y >= h:
                    break
                r = rows[y]
                continue
            n = 1
            while x + n < w and n < 255 and r[x + n] == r[x + (n % 2 if rle4
                                                                else 0)]:
                n += 1
            if n >= 3 or w - x < 3:
                v = (int(r[x]) << 4 | (int(r[x + 1]) if n > 1 else 0)) \
                    if rle4 else int(r[x])
                out += bytes([n, v])
                x += n
            else:
                m = max(3, min(w - x, 40))
                vals = [int(v) for v in r[x:x + m]]
                if rle4:
                    vals += [0] * (m % 2)
                    body = bytes(vals[i] << 4 | vals[i + 1]
                                 for i in range(0, len(vals), 2))
                else:
                    body = bytes(vals)
                out += bytes([0, m]) + body + bytes(len(body) % 2)
                x += m
        y += 1
        if eol and y < h:
            out += b"\x00\x00"
    if eob:
        out += b"\x00\x01"
    return bytes(out)


def _cases():
    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    out = {}
    for bpp in (1, 4, 8):
        n = 1 << bpp
        idx = rng.integers(0, n, (H, W), dtype=np.uint8)
        for header in (12, 40, 108, 124):
            for td in ((False, True) if header != 12 else (False,)):
                out[f"p{bpp}_h{header}{'_td' if td else ''}"] = write_bmp(
                    idx, bpp, header=header, palette=pal[:n], top_down=td)
        short = max(1, n // 2 - 1)
        out[f"p{bpp}_short_palette"] = write_bmp(idx, bpp, palette=pal[:short],
                                                 colors=short)
    gray = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    out["p8_gray_palette"] = write_bmp(
        rng.integers(0, 256, (H, W), dtype=np.uint8), 8, palette=gray)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    v16 = rng.integers(0, 1 << 16, (H, W), dtype=np.uint16)
    for header in (12, 40, 108, 124):
        for td in ((False, True) if header != 12 else (False,)):
            sfx = f"_h{header}{'_td' if td else ''}"
            out["rgb24" + sfx] = write_bmp(rgb, 24, header=header,
                                           top_down=td)
            out["rgb32" + sfx] = write_bmp(rgb, 32, header=header,
                                           top_down=td)
    for header in (40, 108, 124):
        out[f"rgb16_555_h{header}"] = write_bmp(v16, 16, header=header)
        for name, m in (("565", bmp.MASKS_565), ("555", bmp.MASKS_555)):
            out[f"bitfields16_{name}_h{header}"] = write_bmp(
                v16, 16, header=header, comp=3, masks=m)
    for header in (40, 56, 108, 124):
        for name, m in (("bgra", (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
                        ("bgr", (0xFF0000, 0xFF00, 0xFF, 0)),
                        ("rgba", (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                        ("abgr", (0xFF000000, 0xFF0000, 0xFF00, 0xFF))):
            out[f"bitfields32_{name}_h{header}"] = write_bmp(
                rgba, 32, header=header, comp=3, masks=m)
    for rle4 in (False, True):
        bpp, comp, n = (4, 2, 16) if rle4 else (8, 1, 256)
        kind = "rle4" if rle4 else "rle8"
        for h, w in ((9, 16), (7, 13), (12, 33)):
            idx = rng.integers(0, n, (h, w), dtype=np.uint8)
            idx[:, 2:9] = idx[:, 2:3]
            idx[3] = 5
            t = f"{kind}_{h}x{w}"

            def f(stream, **kw):
                return write_bmp(idx, bpp, comp=comp,
                                 palette=kw.pop("palette", pal[:n]),
                                 rle=stream, **kw)

            out[t] = f(rle_encode(idx, rle4))
            out[t + "_no_eol"] = f(rle_encode(idx, rle4, eol=False))
            out[t + "_no_eob"] = f(rle_encode(idx, rle4, eob=False))
            out[t + "_delta"] = f(rle_encode(
                idx, rle4, deltas=[(1, 3, 4, 0), (4, 2, 1, 2)]))
            out[t + "_short_palette"] = f(rle_encode(idx, rle4),
                                          palette=pal[:n // 3],
                                          colors=n // 3)
            out[t + "_overrun"] = f(bytes([w + 3, 7]) + rle_encode(idx, rle4))
            out[t + "_early_eob"] = f(rle_encode(idx, rle4)[:20] + b"\0\1")
            out[t + "_top_down"] = f(rle_encode(idx, rle4), top_down=True)
    # cv2's RLE quirks: an RLE4 end of bitmap mid-image acts as an end of
    # line (rows after it still decode); an RLE8 end of line right after
    # a run that ended the row is skipped
    idx = rng.integers(0, 16, (4, 6), dtype=np.uint8)
    stream = bytes([6, 0x12, 0, 1, 6, 0x34, 0, 0, 6, 0x56, 0, 0, 6, 0x78,
                    0, 1])
    out["rle4_eob_mid_image"] = write_bmp(idx, 4, comp=2, palette=pal[:16],
                                          rle=stream)
    stream = bytes([6, 9, 0, 0, 6, 10, 0, 0, 0, 0, 3, 11, 0, 1])
    out["rle8_eol_after_full_row"] = write_bmp(idx, 8, comp=1,
                                               palette=pal[:16], rle=stream)
    return out


CASES = _cases()


def _cv2(path, flag):
    img = cv2.imread(str(path), flag)
    if img is None or img.ndim == 2:
        return img
    return img[..., ::-1]


def _pil(path):
    try:
        return np.asarray(Image.open(path).convert("RGBA"))
    except (OSError, ValueError):
        return None


def _port(fn, path):
    try:
        out = fn(path)
    except image_io.UNREADABLE:
        return None
    return out.numpy() if hasattr(out, "numpy") else out


def _check(path):
    assert image_io.sniff(path.read_bytes()[:16]) == "bmp"
    ref = _cv2(path, cv2.IMREAD_COLOR)
    got = _port(image_io.read_rgb, path)
    assert (ref is None) == (got is None), "cv2 None / port None"
    if ref is not None:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            _port(image_io.read_gray, path),
            cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
        assert image_io.check_image(path) == ref.shape[:2]
    image_io.require_decodable(path)  # never refused: read or skipped
    ref = _pil(path)
    got = _port(lambda p: image_io.read_rgba_tensor(p, "cpu"), path)
    assert (ref is None) == (got is None), "PIL None / port None"
    if ref is not None:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_written_bmp_matches_cv2_and_pil(tmp_path, name):
    path = tmp_path / f"{name}.bmp"
    path.write_bytes(CASES[name])
    _check(path)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pillow_written_bmp(tmp_path, mode):
    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    if mode == "RGBA":
        img = Image.fromarray(rng.integers(0, 256, (H, W, 4),
                                           dtype=np.uint8), "RGBA")
    elif mode == "P":
        img = img.quantize(37)
    else:
        img = img.convert(mode)
    path = tmp_path / f"{mode}.bmp"
    img.save(path)
    _check(path)


@pytest.mark.parametrize("channels", [1, 3])
def test_cv2_written_bmp(tmp_path, channels):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (H, W, channels), dtype=np.uint8)
    path = tmp_path / "cv2.bmp"
    assert cv2.imwrite(str(path), img[..., 0] if channels == 1 else img)
    _check(path)


def test_cv2_none_cases_are_unreadable(tmp_path):
    """Files cv2.imread gives None for raise one of UNREADABLE: a cut
    header, cut pixels, an unknown compression, a 16-bit V5 BI_BITFIELDS
    file (cv2 reads its masks from past the header), a run past the row."""
    good = CASES["rgb24_h40"]
    bad = {"cut_header": good[:30], "cut_pixels": good[:-7],
           "compression_4": good[:30] + struct.pack("<I", 4) + good[34:],
           "v5_bitfields16": CASES["bitfields16_565_h124"],
           "overrun": CASES["rle8_9x16_overrun"]}
    for name, data in bad.items():
        path = tmp_path / f"{name}.bmp"
        path.write_bytes(data)
        assert cv2.imread(str(path)) is None, name
        with pytest.raises(image_io.UNREADABLE):
            image_io.read_rgb(path)


def test_only_tiff_and_webp_stay_unported(tmp_path):
    """TIFF and WEBP decode now; of them only the rarer forms stay
    unported: a BigTIFF and an animated WEBP refuse the file naming
    ROADMAP.md §A.5, while a cut TIFF or WEBP header (cv2.imread gives
    None) passes require_decodable and reads as unreadable."""
    assert image_io.sniff(b"BM" + bytes(14)) == "bmp"
    assert image_io.sniff(b"II*\x00" + bytes(12)) == "tiff"
    assert image_io.sniff(b"RIFF\0\0\0\0WEBPVP8 ") == "webp"
    vp8x = b"VP8X" + struct.pack("<I", 10) + bytes([0x02, 0, 0, 0]) + \
        bytes(6)
    for name, data in (("t.tif", b"II+\x00" + bytes(16)),
                       ("w.webp", b"RIFF" + struct.pack("<I", 4 + len(vp8x))
                        + b"WEBP" + vp8x)):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(NotImplementedError, match="ROADMAP.md §A.5"):
            image_io.require_decodable(tmp_path / name)
    for name, head in (("c.tif", b"II*\x00"), ("c.webp",
                                                b"RIFF\0\0\0\0WEBPVP8 ")):
        (tmp_path / name).write_bytes(head + bytes(16))
        assert cv2.imread(str(tmp_path / name)) is None
        image_io.require_decodable(tmp_path / name)
        with pytest.raises(image_io.UNREADABLE):
            image_io.read_rgb(tmp_path / name)


def test_wider_channel_masks_are_refused(tmp_path):
    """A 32-bit BI_BITFIELDS file with the masks in its header takes each
    channel by its mask in cv2; the port decodes byte-aligned 8-bit masks
    only and refuses others (10-bit channels here) naming ROADMAP.md
    §A.5, where cv2 gives an image (ROADMAP.md's stated differences)."""
    rgba = np.random.default_rng(3).integers(0, 256, (H, W, 4),
                                             dtype=np.uint8)
    path = tmp_path / "ten_bit.bmp"
    path.write_bytes(write_bmp(rgba, 32, header=124, comp=3, masks=(
        0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000)))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A.5"):
        image_io.read_rgb(path)


def _random_runs(rng, w, h, rle4):
    """A stream of random RLE records: encoded runs and absolute runs up
    to two pixels past the row, ends of line, deltas, ends of bitmap."""
    out = bytearray()
    for _ in range(rng.integers(0, 3 * h + 4)):
        r = rng.random()
        if r < 0.45:
            out += bytes([rng.integers(1, w + 2), rng.integers(0, 256)])
        elif r < 0.7:
            c = int(rng.integers(3, w + 2))
            size = ((c + 1) // 2 + 1) & ~1 if rle4 else (c + 1) & ~1
            out += bytes([0, c]) + rng.integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
        elif r < 0.85:
            out += b"\0\0"
        elif r < 0.95:
            out += bytes([0, 2, rng.integers(0, 4), rng.integers(0, 3)])
        else:
            out += b"\0\1"
    return bytes(out)


@pytest.mark.parametrize("seed", range(8))
def test_random_rle_streams_match_cv2_and_pil(tmp_path, seed):
    """40 files of random RLE8/RLE4 records (csrc/bmp_rle.c's two run
    decoders): every escape in every order, runs that cross the row,
    streams that end early; the port reads each as cv2 and PIL do, or
    refuses it where they do."""
    rng = np.random.default_rng(100 + seed)
    for i in range(40):
        w, h = int(rng.integers(2, 12)), int(rng.integers(2, 8))
        rle4 = bool(rng.integers(0, 2))
        pal = rng.integers(0, 256, (16 if rle4 else 256, 3), dtype=np.uint8)
        path = tmp_path / f"r{i}.bmp"
        path.write_bytes(write_bmp(np.zeros((h, w), np.uint8),
                                   4 if rle4 else 8, comp=2 if rle4 else 1,
                                   palette=pal,
                                   rle=_random_runs(rng, w, h, rle4),
                                   top_down=bool(rng.integers(0, 2))))
        _check(path)
