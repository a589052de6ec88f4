"""The port's JPEG decoder (utils/jpeg.py, the C entropy decoder of
csrc/jpeg_entropy.c, ops/jpeg.py's pixel stage) against cv2.imread (cv2
5.0.0 with libjpeg-turbo 3.1.2), on files cv2.imencode writes here: every
byte equal, for colour and gray reads, over qualities, samplings,
progressive and optimized coding, restart intervals, split luma/chroma
qualities, gray files, odd sizes, EXIF orientations 1-8 in both byte
orders, and files cut inside their entropy data (a progressive cut is
smoothed as jdcoefct.c smooths it). Also the C decoder's coefficients
against the Python decoder's, utils/synthetic.encode_jpeg's files in cv2,
and the forms that must raise.
"""
import itertools
import os
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from unet_watermark_tpu_torch.ops.kernels import jpeg_entropy
from unet_watermark_tpu_torch.utils import image_io, jpeg, synthetic
from unet_watermark_tpu_torch.utils.synthetic import encode_jpeg

torch.set_num_threads(2)

SIZES = [(1, 1), (7, 13), (17, 33), (129, 191)]
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
# (quality, IMWRITE_JPEG_OPTIMIZE, restart interval in MCUs): each file of a
# matrix case; every quality, both optimize settings and every interval
CODINGS = [(50, 0, 0), (75, 1, 1), (95, 0, 7), (100, 1, 0)]
# 129 x 191 q95 4:2:0 files cut at these shares of their entropy data
# (from the first scan on), and "scan": at the end of the fifth scan's data.
# In a progressive file the 0.3 cut falls in scan 6 of 10 and the 0.6 cut
# in scan 9, where libjpeg smooths the blocks whose coefficients are not
# yet fully refined; the 0.95 cut falls in the last scan, which counts as
# begun, so nothing is smoothed
CUT_SHARES = (0.3, 0.6, 0.95, "scan")


def cut_file(data: bytes, share) -> bytes:
    if share == "scan":
        scans = jpeg.parse(data).scans
        return data[:scans[min(4, len(scans) - 1)].end]
    start = entropy_start(data)
    return data[:start + int(share * (len(data) - start))]


def photo(h, w, seed, gray=False):
    """A smooth gradient with noise and a few hard edges: the content of a
    photo with a logo over it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w, 2)
    base = np.stack([yy, xx, (yy + xx) / 2], -1) * 190 + 30
    base += rng.normal(0, 10, base.shape)
    base[h // 3:h // 2, w // 4:w // 2] = (240, 20, 200)
    img = np.clip(base, 0, 255).astype(np.uint8)
    return img[..., 1].copy() if gray else img


def encode(img, quality=95, sampling="420", progressive=0, optimize=0,
           restart=0, luma=None, chroma=None) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if luma is not None:
        params += [cv2.IMWRITE_JPEG_LUMA_QUALITY, luma,
                   cv2.IMWRITE_JPEG_CHROMA_QUALITY, chroma]
    ok, buf = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img,
                           params)
    assert ok
    return buf.tobytes()


def cv2_reads(path):
    """(RGB, gray) as cv2.imread gives them."""
    rgb = cv2.imread(str(path))
    assert rgb is not None, path
    return (cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB),
            cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def assert_reads_equal_cv2(path):
    rgb, gray = cv2_reads(path)
    out = image_io.read_rgb(path)
    assert out.shape == rgb.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, rgb)
    np.testing.assert_array_equal(image_io.read_gray(path), gray)
    assert image_io.check_image(path) == rgb.shape[:2]


def matrix_files():
    """The matrix: (id, bytes) of every size x sampling x progressive case,
    each coded the CODINGS ways."""
    for (h, w), s, prog in itertools.product(SIZES, SAMPLING, (0, 1)):
        img = photo(h, w, h * 7 + w)
        for q, opt, rst in CODINGS:
            yield (f"{h}x{w}-{s}-p{prog}-q{q}-o{opt}-r{rst}",
                   encode(img, q, s, prog, opt, rst))


@pytest.fixture
def c_decoder():
    if shutil.which("cc") is None:
        pytest.skip("needs a host C compiler (cc) to build the C decoder")
    return jpeg_entropy.decode_scans_c


@pytest.mark.parametrize("prog", [0, 1], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_reads_equal_cv2(tmp_path, size, sampling, prog):
    """read_rgb and read_gray against cv2.imread: 0 differing bytes, each
    quality / optimize / restart coding of CODINGS."""
    img = photo(*size, size[0] * 7 + size[1])
    for q, opt, rst in CODINGS:
        path = tmp_path / f"q{q}.jpg"
        path.write_bytes(encode(img, q, sampling, prog, opt, rst))
        assert_reads_equal_cv2(path)


@pytest.mark.parametrize("luma, chroma", [(90, 40), (40, 95), (100, 60)])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_split_luma_chroma_quality_equals_cv2(tmp_path, sampling, luma,
                                              chroma):
    path = tmp_path / "split.jpg"
    path.write_bytes(encode(photo(129, 191, 3), 95, sampling, luma=luma,
                            chroma=chroma))
    assert_reads_equal_cv2(path)


@pytest.mark.parametrize("prog", [0, 1], ids=["baseline", "progressive"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_files_equal_cv2(tmp_path, size, prog):
    """One-component files: the plane read as gray, and three times over
    read as colour."""
    path = tmp_path / "gray.jpg"
    img = photo(*size, size[0] + 1, gray=True)
    for q, opt, rst in CODINGS:
        path.write_bytes(encode(img, q, progressive=prog, optimize=opt,
                                restart=rst))
        assert_reads_equal_cv2(path)
        assert jpeg.parse(path.read_bytes()).color == "gray"


def exif_app1(orientation: int, big_endian: bool) -> bytes:
    """An APP1 segment: Exif identifier, TIFF header in the given byte
    order, IFD0 with a make tag before the orientation tag."""
    e = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 2)
    tiff += struct.pack(e + "HHI4s", 0x010F, 2, 4, b"ABC\0")
    tiff += struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff += struct.pack(e + "I", 0)
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def splice_exif(data: bytes, orientation: int, big_endian: bool) -> bytes:
    """The file with an APP1 EXIF segment after its APP0."""
    app0_end = 4 + struct.unpack(">H", data[4:6])[0]
    return data[:app0_end] + exif_app1(orientation, big_endian) + \
        data[app0_end:]


@pytest.mark.parametrize("big_endian", [True, False], ids=["MM", "II"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_equals_cv2(tmp_path, orientation, big_endian):
    path = tmp_path / "o.jpg"
    base = photo(17, 33, 5)
    for sampling in ("420", "444"):
        data = splice_exif(encode(base, 90, sampling), orientation,
                           big_endian)
        path.write_bytes(data)
        assert jpeg.parse(data).orientation == orientation
        assert_reads_equal_cv2(path)
    if orientation == 6:  # cv2 rotates clockwise, both reads
        rgb, gray = cv2_reads(path)
        plain = tmp_path / "plain.jpg"
        plain.write_bytes(encode(base, 90, "444"))
        up_rgb, up_gray = cv2_reads(plain)
        np.testing.assert_array_equal(rgb, np.rot90(up_rgb, -1))
        np.testing.assert_array_equal(gray, np.rot90(up_gray, -1))


def entropy_start(data: bytes) -> int:
    return jpeg.parse(data, headers_only=True).scans[0].start


@pytest.mark.parametrize("share", CUT_SHARES)
@pytest.mark.parametrize("prog", [0, 1], ids=["baseline", "progressive"])
def test_truncated_files(tmp_path, prog, share):
    """A file cut inside its entropy data: cv2 gives the image (a flat gray
    tail in a baseline file, the earlier scans' detail, smoothed, in a
    progressive one). Every cut is exact, colour and gray."""
    data = encode(photo(129, 191, 9), 95, "420", prog)
    cut = cut_file(data, share)
    path = tmp_path / "cut.jpg"
    path.write_bytes(cut)
    rgb, gray = cv2_reads(path)
    out = image_io.read_rgb(path)
    assert out.shape == rgb.shape
    np.testing.assert_array_equal(out, rgb)
    np.testing.assert_array_equal(image_io.read_gray(path), gray)
    header = jpeg.parse(cut)
    jpeg.decode_scans(header, cut)
    smoothing = jpeg.block_smoothing(header)
    if not prog and share != "scan":
        # the MCUs after the cut are left empty: mid-gray luma
        assert gray[-1, -1] == 128
    # smoothed where a coefficient of 1..9 is not exact in the last scan's
    # state: the 0.3 and 0.6 cuts, and the scan-boundary cut (scan 5 of 10)
    assert (smoothing is not None) == (prog and share != 0.95)


# Progressive files cut at random points and at the end of every scan but
# the last, for each sampling (and gray), q50 and q95, with and without
# restarts: block smoothing makes every cut equal to cv2's. Inside the MCU
# where the data ran out the missing bits read as zeros and can decode to
# coefficients far out of range; the port's IDCT wraps and saturates there
# as libjpeg-turbo's SIMD IDCT does in 16-bit lanes (ROADMAP.md §C.8,
# resolved). A cut inside a marker segment between scans (DHT, SOS) is
# read as libjpeg reads the EOI markers its source manager inserts, so the
# port refuses such a file only where cv2 gives none (§C.9, resolved).
# Neither count is above zero for any sampling.
CUT_SWEEP_DIFFER = {"444": 0, "422": 0, "420": 0, "440": 0, "411": 0,
                    "gray": 0}
CUT_SWEEP_REFUSED = {"444": 0, "422": 0, "420": 0, "440": 0, "411": 0,
                     "gray": 0}


@pytest.mark.parametrize("sampling", list(CUT_SWEEP_DIFFER))
def test_progressive_cut_sweep(tmp_path, sampling):
    rng = np.random.default_rng(len(sampling) + ord(sampling[-1]))
    path = tmp_path / "cut.jpg"
    n = differ = refused = 0
    for (h, w), q, rst in itertools.product(((17, 33), (72, 40)), (50, 95),
                                            (0, 3)):
        gray = sampling == "gray"
        data = encode(photo(h, w, h + w, gray), q, "420" if gray else
                      sampling, 1, 0, rst)
        scans = jpeg.parse(data).scans
        start = scans[0].start
        cuts = [sc.end for sc in scans[:-1]] + [
            start + int(u * (len(data) - start)) for u in rng.random(3)]
        for c in cuts:
            path.write_bytes(data[:c])
            try:
                header = jpeg.parse(data[:c])
            except jpeg.JPEGError:  # cut inside a marker segment (§C.9)
                refused += cv2.imread(str(path)) is not None
                continue
            n += 1
            rgb, gray_ref = cv2_reads(path)
            got = (image_io.read_rgb(path), image_io.read_gray(path))
            bad = np.zeros((h, w), bool)
            for a, b in zip(got, (rgb, gray_ref)):
                bad |= (a != b).reshape(h, w, -1).any(-1)
            if not bad.any():
                continue
            differ += 1
            # the differing pixels lie inside the cut MCU (and its
            # upsampling neighbours)
            jpeg.decode_scans(header, data[:c])
            last = header.scans[-1]
            _, _, across = jpeg.scan_blocks(header, last)
            my, mx = divmod(last.cut, across)
            comp = header.components[last.comps[0]]
            sy, sx = ((8 * header.vmax // comp.v, 8 * header.hmax // comp.h)
                      if len(last.comps) == 1 else
                      (8 * header.vmax, 8 * header.hmax))
            inside = np.zeros_like(bad)
            inside[max(my * sy - 2, 0):(my + 1) * sy + 2,
                   max(mx * sx - 2, 0):(mx + 1) * sx + 2] = True
            assert last.cut >= 0 and not (bad & ~inside).any()
    assert n >= 30
    assert differ == CUT_SWEEP_DIFFER[sampling]
    assert refused == CUT_SWEEP_REFUSED[sampling]


def test_unreadable_files_give_jpeg_error(tmp_path):
    """Where cv2.imread gives None: no frame, no scan (a file cut before its
    first SOS), a segment cut off. check_image and require_decodable let
    the pipeline skip such a file; the readers raise JPEGError."""
    data = encode(photo(17, 33, 2))
    sos = data.index(b"\xff\xda")
    dqt = data.index(b"\xff\xdb")
    cases = {"soi_only": data[:2] + b"\xff\xd9",
             "cut_before_sos": data[:sos],
             "cut_in_a_segment": data[:dqt + 20]}
    for name, body in cases.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(body)
        assert cv2.imread(str(path)) is None, name
        for read in (image_io.read_rgb, image_io.read_gray,
                     image_io.check_image):
            with pytest.raises(image_io.JPEGError):
                read(path)
        image_io.require_decodable(path)  # no raise: skipped later


def _framed(h: int, w: int) -> bytes:
    """A small file whose frame header declares h x w."""
    data = bytearray(encode(photo(8, 8, 5)))
    i = data.index(b"\xff\xc0")
    data[i + 5:i + 9] = struct.pack(">HH", h, w)
    return bytes(data)


@pytest.mark.parametrize("h, w", [(8, 65501), (65501, 8), (65535, 65535),
                                  (32768, 32769)], ids=str)
def test_frames_over_cv2_limits_give_jpeg_error(tmp_path, h, w):
    """A header that declares a frame over cv2.imread's limits (libjpeg's
    65500 a side, cv2's 2**30 pixels): cv2 refuses the file before it
    decodes anything (None; cv2 5.0 raises for the pixel limit), and the
    port raises JPEGError at once, before it allocates the frame."""
    path = tmp_path / "big.jpg"
    path.write_bytes(_framed(h, w))
    try:
        assert cv2.imread(str(path)) is None
    except cv2.error as e:
        assert "CV_IO_MAX_IMAGE_PIXELS" in str(e) and h * w > 1 << 30
    t0 = time.perf_counter()
    for read in (image_io.read_rgb, image_io.read_gray,
                 image_io.check_image):
        with pytest.raises(image_io.JPEGError, match="limits"):
            read(path)
    image_io.require_decodable(path)  # no raise: skipped later
    assert time.perf_counter() - t0 < 1.0


def test_frame_at_libjpeg_side_limit_is_decoded(tmp_path):
    """A 8 x 65500 frame is within the limits: cv2 decodes it (its data
    ends at once, so it is flat past the first MCUs), and so does the
    port, byte for byte."""
    path = tmp_path / "wide.jpg"
    path.write_bytes(_framed(8, 65500))
    assert_reads_equal_cv2(path)


def _patched(data: bytes, marker: int, precision=None, ncomp=None) -> bytes:
    """The file with its SOF marker replaced, its precision or component
    count changed."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    if ncomp is not None:
        out[i + 9] = ncomp
    return bytes(out)


@pytest.mark.parametrize("form", ["lossless", "hierarchical", "arithmetic",
                                  "arithmetic_progressive", "dac",
                                  "12bit", "cmyk"])
def test_refused_forms_raise(tmp_path, form):
    data = encode(photo(17, 33, 4), 90, "444")
    body = {"lossless": lambda: _patched(data, 0xC3),
            "hierarchical": lambda: _patched(data, 0xC5),
            "arithmetic": lambda: _patched(data, 0xC9),
            "arithmetic_progressive": lambda: _patched(data, 0xCA),
            "dac": lambda: data[:2] + b"\xff\xcc\x00\x04\x00\x11"
            + data[2:],
            "12bit": lambda: _patched(data, 0xC0, precision=12),
            # a 4-component count over a 3-component list: four-component
            # files decode now (test_cmyk_and_ycck_equal_cv2), this one is
            # malformed and cv2 gives None
            "cmyk": lambda: _patched(data, 0xC0, ncomp=4)}[form]()
    path = tmp_path / f"{form}.jpg"
    path.write_bytes(body)
    if form == "cmyk":
        assert cv2.imread(str(path)) is None
        for call in (image_io.read_rgb, image_io.check_image):
            with pytest.raises(image_io.JPEGError, match="SOF length"):
                call(path)
        image_io.require_decodable(path)  # skipped later, not refused
        return
    for call in (image_io.read_rgb, image_io.check_image,
                 image_io.require_decodable):
        with pytest.raises(NotImplementedError, match="ROADMAP.md §A.5"):
            call(path)


def test_decoder_follows_content_not_name(tmp_path):
    """A JPEG named .png and a PNG named .jpg read as what they are, as
    cv2.imread reads them."""
    img = photo(17, 33, 6)
    (tmp_path / "j.png").write_bytes(encode(img))
    image_io.write_png(tmp_path / "p.jpg", img)
    for name in ("j.png", "p.jpg"):
        assert_reads_equal_cv2(tmp_path / name) if name == "j.png" else \
            np.testing.assert_array_equal(image_io.read_rgb(tmp_path / name),
                                          img)
    t = image_io.read_rgb_tensor(tmp_path / "j.png", "cpu")
    assert t.dtype == torch.uint8 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(),
                                  image_io.read_rgb(tmp_path / "j.png"))


@pytest.mark.parametrize("prog", [0, 1], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_c_decoder_equals_python(c_decoder, sampling, prog):
    """The C entropy decoder's coefficients equal the Python decoder's on
    the matrix (every size and coding of this sampling and mode; gray
    files; split luma/chroma qualities), on the truncated files and on
    encode_jpeg's forms."""
    if sampling == "gray":
        files = [encode(photo(*size, size[0] + 1, gray=True), q,
                        progressive=prog, optimize=opt, restart=rst)
                 for size in SIZES for q, opt, rst in CODINGS]
    else:
        files = [d for name, d in matrix_files()
                 if f"-{sampling}-p{prog}-" in name]
        files += [encode(photo(129, 191, 3), 95, sampling, prog, luma=lq,
                         chroma=cq) for lq, cq in ((90, 40), (40, 95))]
    full = encode(photo(129, 191, 9), 95, "420", prog)
    files += [cut_file(full, s) for s in CUT_SHARES]
    files += [encode_jpeg(photo(40, 56, 1), 85, s, bool(prog), rst, o)
              for s, rst, o in (("444", 0, None), ("422", 3, 6),
                                ("420", 2, 3))]
    for data in files:
        header = jpeg.parse(data)
        plain = jpeg.decode_scans(header, data)
        cuts = [scan.cut for scan in header.scans]
        for a, b in zip(plain, c_decoder(header, data)):
            np.testing.assert_array_equal(a, b)
        # both record the MCU where the data ran out (block smoothing's
        # last good row)
        assert [scan.cut for scan in header.scans] == cuts


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("prog", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
def test_encode_jpeg_files_decode_as_in_cv2(tmp_path, sampling, prog,
                                            restart):
    """utils/synthetic.encode_jpeg's files: cv2 decodes each to what the
    port's decoder gives, near the source image; with orientation 6 both
    give the rotated image."""
    gray = sampling == "gray"
    img = photo(37, 61, 8, gray=gray)
    for orientation in (None, 6):
        path = tmp_path / "w.jpg"
        path.write_bytes(encode_jpeg(img, 90, "444" if gray else sampling,
                                     prog, restart, orientation))
        assert_reads_equal_cv2(path)
        out = image_io.read_gray(path) if gray else image_io.read_rgb(path)
        src = np.rot90(img, -1) if orientation == 6 else img
        assert out.shape == src.shape
        # q90: a few levels on average; subsampled chroma keeps little of
        # the noise (sigma 10) of each channel (observed 5.8, 7.2 and 8.2
        # for 4:4:4, 4:2:2 and 4:2:0)
        assert np.abs(out.astype(int) - src).mean() < 10


BUILD_ONE = """
import ctypes, sys
from pathlib import Path
from unet_watermark_tpu_torch.ops.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
lib, _ = build.build("jpeg_entropy.c")
ctypes.CDLL(str(lib)).uwt_jpeg_decode_scan
print(lib.name)
"""


def test_concurrent_builds_of_one_source(c_decoder, tmp_path):
    """Six processes (more than the test's cores) build the C decoder into
    one empty build directory at once, as test workers may: each loads a
    whole library, all name the same file, no temporary file is left."""
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(repo), os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE,
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(names)


def _crafted_blocks(seed: int, mode: str):
    """Two rows of three gray blocks with extreme quantized coefficients
    (DC differences up to 2047, AC up to 1023) and a quantizer of 1..255,
    as no photo gives them: the products wrap in 16 bits, the passes
    saturate, and a DC-only block takes the column shortcut."""
    rng = np.random.default_rng(seed)
    b = np.zeros((2, 3, 64), np.int64)
    if mode == "row0":
        b[..., 1:8] = rng.choice([-1023, -512, 0, 512, 1023], (2, 3, 7))
    elif mode == "col0":
        b[..., ::8] = rng.choice([-1023, -700, 0, 700, 1023], (2, 3, 8))
    elif mode == "extremes":
        b[:] = rng.choice([-1023, -1, 0, 1, 1023], (2, 3, 64))
    else:
        b[:] = rng.integers(-1023, 1024, (2, 3, 64)) * (
            rng.random((2, 3, 64)) < 0.5)
    dc, prev = [], 0
    for _ in range(6):  # DC differences within the table's 2047
        want = int(rng.choice([-2047, 2047, rng.integers(-2047, 2048)]))
        prev = int(np.clip(want, prev - 2047, prev + 2047))
        dc.append(prev)
    b[..., 0] = np.reshape(dc, (2, 3))
    q = rng.choice([1, 255, int(rng.integers(1, 256))], 64)
    return b, q


@pytest.mark.parametrize("mode", ["dc_only", "row0", "col0", "extremes",
                                  "random"])
@pytest.mark.parametrize("seed", range(4))
def test_idct_on_coefficients_out_of_range(mode, seed):
    """Crafted one-component files whose dequantized coefficients leave
    the range a real file gives: every sample equals cv2.imread's (the
    16-bit lanes of libjpeg-turbo's SIMD IDCT; ROADMAP.md §C.8)."""
    for k in range(6):
        blocks, q = _crafted_blocks(100 * seed + k, mode)
        data = synthetic.encode_jpeg_blocks(blocks, q)
        ref = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_GRAYSCALE)
        got = image_io.decode_jpeg(data, "cpu", gray=True).numpy()
        np.testing.assert_array_equal(got, ref)


# -- Adobe four-component files: CMYK (transform 0) and YCCK (2) -------------

def cmyk_file(h, w, seed, sampling, prog, transform, orientation=None):
    """A four-component JPEG: Pillow's CMYK file (its Adobe marker says
    transform 0; Pillow stores the values inverted, as Photoshop does), with
    its transform byte rewritten for YCCK (the same coefficients read as
    Y Cb Cr K) or its marker renamed for no Adobe marker, and an EXIF
    orientation spliced in."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    base = np.concatenate([photo(h, w, seed), rng.integers(
        0, 256, (h, w, 1), dtype=np.uint8)], 2)
    base[..., 3] = cv2.GaussianBlur(base[..., 3], (5, 5), 2)
    buf = io.BytesIO()
    Image.fromarray(base, "CMYK").save(
        buf, "JPEG", quality=90, progressive=bool(prog),
        subsampling={"444": 0, "420": 2}[sampling])
    data = bytearray(buf.getvalue())
    at = data.index(b"Adobe")
    assert data[at + 11] == 0  # Pillow's CMYK: transform 0
    if transform is None:
        data[at:at + 5] = b"Xdobe"
    else:
        data[at + 11] = transform
    data = bytes(data)
    if orientation is not None:
        data = data[:2] + exif_app1(orientation, False) + data[2:]
    return data


@pytest.mark.parametrize("orientation", [None, 6, 3])
@pytest.mark.parametrize("transform", [0, 2, None],
                         ids=["cmyk", "ycck", "no_adobe"])
@pytest.mark.parametrize("prog", [0, 1], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_cmyk_and_ycck_equal_cv2(tmp_path, sampling, prog, transform,
                                 orientation):
    """CMYK and YCCK at 4:4:4 and 4:2:0 (the first component 2x2),
    baseline and progressive, with and without an EXIF orientation:
    read_rgb, read_gray and check_image byte-equal to cv2.imread (libjpeg's
    CMYK output and cv2's own CMYK -> BGR and -> gray), read_rgba_tensor
    byte-equal to PIL's convert("RGBA"); the C entropy decoder's
    coefficients equal to the Python decoder's. Tolerance: none."""
    from PIL import Image

    data = cmyk_file(29, 43, 5, sampling, prog, transform, orientation)
    path = tmp_path / "c.jpg"
    path.write_bytes(data)
    header = jpeg.parse(data)
    assert header.color == ("ycck" if transform == 2 else "cmyk")
    assert_reads_equal_cv2(path)
    np.testing.assert_array_equal(
        image_io.read_rgba_tensor(path, "cpu").numpy(),
        np.asarray(Image.open(path).convert("RGBA")))
    if shutil.which("cc") is not None:
        plain = jpeg.decode_scans(header, data)
        for a, b in zip(plain, jpeg_entropy.decode_scans_c(
                jpeg.parse(data), data)):
            np.testing.assert_array_equal(a, b)


def test_cmyk_phase_writer_reads_as_cv2(tmp_path):
    """chip_smoke's phase 3o writes its Adobe CMYK file with the port's
    four-component Huffman coder (jpeg_entropy.c): cv2 reads it as the
    port does, and with K at 255 it gives back the image it was made
    from within the JPEG loss."""
    if shutil.which("cc") is None:
        pytest.skip("needs a host C compiler (cc) to build the encoder")
    from unet_watermark_tpu_torch.tools import smoke_formats as sp

    img = photo(40, 56, 2)
    data = sp.cmyk_jpeg(np.concatenate([img, np.full_like(img[..., :1],
                                                          255)], 2))
    path = tmp_path / "w.jpg"
    path.write_bytes(data)
    assert_reads_equal_cv2(path)
    assert np.abs(image_io.read_rgb(path).astype(int) - img).mean() < 4
