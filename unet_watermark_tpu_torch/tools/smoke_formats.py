"""Phase 3o of chip_smoke.py: every still image the JAX package reads, and
its own checkpoint files' zstd frames (formats_phase), with the writers it
makes its files with. chip_smoke.py imports this module; it needs the card,
as chip_smoke.py does (on the CPU it rehearses with --device cpu).

  3o csrc/zstd_decode.c, csrc/bmp_rle.c, csrc/webp_decode.c and
     csrc/tiff_codecs.c built by the card machine's cc with the other
     sources; known answers: two zstd frames (ZSTD_KNOWN: Huffman literals
     with FSE sequences and a checksum; several blocks without a content
     size) to their SHA-256s, three WEBP files cv2.imencode wrote
     (WEBP_KNOWN: lossy with ALPH; lossless with subtract-green, predictor
     and cross-colour; lossless with colour indexing) decoded with their
     pixel stage on the card to the SHA-256s of cv2's and PIL's pixels,
     and four mask PNGs read as gray (PNG_GRAY_KNOWN: RGB, 4-bit palette
     and 16-bit RGB under libpng's plain rgb_to_gray, and RGB with gAMA
     under its gamma tables) to the SHA-256s of cv2's; `repair --no-ocr`
     over a folder of FORMAT_FILES PNGs of SIZE² (utils/synthetic's
     images, FORMAT_CLEAN of them without a logo; the RLE8 one cut to 216
     colours) and over the same pixels as FORMS: a 24-bit BMP, an RLE8
     BMP, a 32-bit BI_BITFIELDS top-down V5 BMP, two Adam7 PNGs, an Adobe
     CMYK JPEG (transform 0, written through jpeg_entropy.c's
     four-component coder), a VP8 WEBP (utils/synthetic.vp8_bytes' blocky
     approximation, 4 token partitions, the normal loop filter), a VP8L
     WEBP with alpha (subtract-green, predictor and cross-colour, meta
     prefix codes), an LZW TIFF with predictor 2, a tiled Deflate TIFF and
     a PackBits planar TIFF: rc 0, K1 and K2 launched in both runs, every
     output PNG of the lossless files byte-equal to the PNG folder's (or,
     where the pipeline copies an image below the repair threshold, a copy
     of its input decoding to the same pixels), the lossy files' decodes
     on the card (colour and gray) equal to their CPU routes. Logs the
     host decode ms of a 1080 x 1920 24-bit BMP, RLE8 BMP, Adam7 PNG, VP8L
     WEBP and LZW TIFF, a 1080 x 1920 CMYK JPEG's and VP8 WEBP's entropy
     (host, C) and pixel (the card) ms, and the phase's seconds. The files
     (write_inputs) are written by a host worker while the kernels build.
"""
from __future__ import annotations

import collections
import contextlib
import time
from pathlib import Path

from .smoke_phases import SIZE, log, run_cli

# Two known-answer zstd frames, made
# on a host with the `zstandard` package (0.25): A is
# ZstdCompressor(level=19, write_checksum=True).compress(text) for
# text = b" ".join(WORDS[(i * i + 3 * i) % 16] + str(i % 97).encode() for
# i in range(400)) (3449 bytes: one compressed block, Huffman literals in
# four streams, FSE-compressed sequence tables, an XXH64 checksum); B is
# ZstdCompressor(level=3, write_content_size=False).compress(
# bytes((i * 7919) % 251 for i in range(300000))) (several blocks, no
# content size). Each is held to its content's SHA-256.
ZSTD_KNOWN = (
    ("28b52ffd64790cbd180076e34c199029190e405b7ce0af96feb776773e524a99"
     "524a12fbee80095a003e003d00523472bfe7f778d1886fbba6e77051a7d2d76d"
     "d9458bc411de25c760d1c8bd01070a0a06866ee0162b1a69500090806038c281"
     "05030e06172810283034814021818084810807080a00181620a17030044242c1"
     "408200050506010ba97fe42ebfc78b466e979ec345d3be6ecb365ae490a7598e"
     "acd146ee8edb8a46ee7251555515553442642a9146543433321f4f87b3282119"
     "11b94b9944452377b928a191bb94459d7ef95deef1a291dbe6eca291d66dd9b5"
     "45a49066c905479bc9ee725b148ddce542ee7251442377b9a8a191bb5c94d0c8"
     "5d06452377b990bacb45118dd05d8ea28646ee723125347271b9a8d3c8fd7251"
     "a691bb5c5469e42e17451ab9cb458d667297db68e42e175277b928a291bb5c04"
     "8189a821a8bcc7ce6ea1898031266f03210408d396c40349bb77a8a55857424d"
     "213c065229942d94dd6d41b77f7bd028eb0654969d17204a81b610f02cd11514"
     "47413704923a56a92b253a90114558c3450523ca45095afce7d12ae72eddcb24"
     "3a8ba21e0df9125a0b6423b5ba32a6086da2c9550b832435c705081d21901a31"
     "6831bf47c9e96536f76c22070ab762ed3c34a1db29b3544124c9de647e256c96"
     "22b1661d80f4c6d63c7f25b99d65928a200288f2a7a356fee76db1111da0e598"
     "7b235354c2592716280081647ecbbc7e4b89245ac4e60ac26120d54169616c51"
     "07b5ec6458b040d2c0750042858b5d1076621d04414bfe8c26a7d7d9ccb3230f"
     "28ddca1af313c56f43195283b0e47a6bfe4aee594e62893c20a0f1dae655896f"
     "6399a422880222f2cb512a97cc7bb18b7e40a1c9854eb912d3a631a20661c9fd"
     "d6fc7e93122b4bc4cc35c262949aa0cc560ca8cc4d5147fcab8e0c08d9e81ae6"
     "df95dc8632484510b555f4d7a33b189f9f04dd48022a9bbcc029a2a86e7d19a5"
     "0ac292e4cdf93f64ccfac08e7aa0406b6b9e9f43b80d652f7550cbba37cfff50"
     "6476026ca200946e7d8de6f9506e4d994b6d5081b2eb6df37ec898f5c1f25507"
     "969b64415347c8b5215b290485ac7863cd71ba5d24a9e502613026a557d500f0"
     "2a0b4f084e",
     "8f1bca7d5bcbf7c222171c3164299a060406efde5c09195a7cc77fa2383c015d"),
    ("28b52ffd00482c0800b40f008a19a332bc4bd564ee7d0c9625af3ec857e170fa"
     "8918a231bb4ad463ed7c0b9524ae3dc756e06ff98817a130ba49d362ec7b0a94"
     "23ad3cc655df6ef88716a02fb948d261eb7a099322ac3bc554de6df786159f2e"
     "b847d160ea79089221ab3ac453dd6cf685149e2db746d05fe978079120aa39c3"
     "52dc6bf584139d2cb645cf5ee87706901fa938c251db6af483129c2bb544ce5d"
     "e776058f1ea837c150da69f382119b2ab443cd5ce675048e1da736c04fd968f2"
     "81109a29b342cc5be574038d1ca635bf4ed867f1800f9928b241cb5ae473028c"
     "1ba534be4dd766f07f0e9827b140ca59e372018b1aa433bd4cd665ef7e0d9726"
     "b03fc958e27101007b817f7f6ea44c0000087b0100fcff3910024d000008f601"
     "00dc131d0801",
     "8c2d8ae844f0b98f041a85f0208f857e73cdc7e22492308755d3657480439207"))
# WEBP files made by cv2.imencode (cv2 5.0.0, libwebp 1.x): a lossy VP8
# frame with an ALPH chunk (a BGRA image of 32 x 48 at quality 80), a
# lossless one that uses subtract-green, predictor and cross-colour (a
# noisy gradient, quality 101) and a lossless one that uses colour
# indexing (a 216-colour image): each with the SHA-256 of cv2.imread's
# pixels (RGB, after BGR2RGB) and of PIL's convert("RGBA").
WEBP_KNOWN = (
    ("lossy_alpha",
     "524946465601000057454250565038580a000000100000002f00001f0000414c"
     "50481d00000001b90a44f43fa0b49114e83ea884fe9bc4a111111390083bda89"
     "c14b070056503820120100007007009d012a300020003e6d2e9245a922a1955c"
     "06fc9006c4b1005493ad20bfd56f91c601bce0faeb7af425e86bcad45ed8975c"
     "7ae1e38e581bf4330bb8e26cb11d1d0000fef786f7a439bedb86fd6bff71ded6"
     "c7a018265935e719e8327c570c6513171a6feab4ad8778a685e5e20a5271e013"
     "bc5bc8e63d2a4183b6f5d6fa9107213d11db585899886292bf33bf8860c1e222"
     "2980f6f37595081c4e022f1e179a49a4c8a5649cb47b08f8de4c47d7b1d6191c"
     "457ed582e1532f681f1cb8027fa8dedecdbd5613587c18cca8bca0f5c5e848f7"
     "03e022de707d609a82a354c12205db360cf5211098b073134f371b2235edaffd"
     "d259506f1a75b808d7d08bc376c3e986dbdba6311af96a36cec314000000",
     "4349a33723ea6dafa4c56638a1722d76bcd733416836b05de66c8cfdadfe832d",
     "019cc38be0bc68fe565112b9faa1e503f4f3f5cd55b8b6006f32586da6383b9b"),
    ("lossless",
     "5249464638030000574542505650384c2b0300002f2fc00700cd5520a2ffb120"
     "93b6897fcdfd361184d9460a853880f993ddf3fcfefd9f80a6940e970700c7e1"
     "5b92244b9224dbb2ab46d4ffffefb5fb238a45c98815b46dc374873fe41a62db"
     "36822465f6afff827f988909f8efd8d947e6f8d9c7cc71736c33e3cc718d33f5"
     "fc99bf74dc8f63fff0badf9f99e3beebbf3ff71c7b8e393dfee3c80c301c731e"
     "b5f7bcde7ad2a57e7c7a27fa29967be799f764bdb938d9ce8ccf2c6cf5cedebc"
     "9cd9db3cbaf4ea56bea5245fbece97363d95c5c5c9c30fdebc4017a8e090c9eb"
     "7daf1ee552be535f7f34b9f4e5fb9afea8172f0b4f16ea4d5bdd85887974e915"
     "59eaf723be2f5fe66bbeefbb84fff7e5c65e3074a0aa278f96da7e97065e7de9"
     "d0b4cdd7979b52ecc52fbd59383658dbcb7974eb47dfaba5b6d3af5ff32569b8"
     "79c10be9e2288542632f74d9a54b1f8ff85ef56bd3aff9be125e169ae4a4dd37"
     "6e682f74d3dbcea22105a8662013db93e9cc6c9985344e90b0dc3a7646b355b3"
     "3b01d8bbbb1b2a5a802a5ed634e4073da116ff2a3b1b46c0b018acd24c83b9ed"
     "9c909a2eb648f9c5c98ded49abed2c52643b71ea89b6c5c2640c668a0b4cb102"
     "9d4e2152e9ebe6219540537e69937832da1b66540164ac32753a536967d18027"
     "63178d27630ded2ce60f26bf3c8c27ddbeeebee90352f738d42e4ec0e9621793"
     "a8fba87041a9f6f24e7af33f648645a5b30db5229b61304e332af3ba8587d8c4"
     "5d3a4d4e3aed385d6ce92496e8f6971bfbba7d481b4ea8e29eb12c625b98463b"
     "83f66438aaf4bb9099ec453b042375663a528fd26dc205b4698b2d2183270ba6"
     "d83dd2543a3b029cb8a8c5932cc6d271d0cc2fde089306a4dd478117ce6e4720"
     "01adc624e6c485a2900e60a3dbe014a39aff28f517c71b5a68c4a2a194062a69"
     "b5819edeff7032425d1099809536e309fca022adc1be6ee7616a4b711817d26a"
     "95f9a5d5137bb300a1713e6c6ad3448a54ebe01ea155071a3496e57fbf94a983"
     "27b8d89574b43d0194dd5ac2a255f271a21d6c76151739a18adb620dd97501f6"
     "a4ce4707b6fa4b7a332c4e66215467e348b2297438591c455f97260f17d81359"
     "4c6988ff3bb629cc8c954d4d6a67ea148cfd83303cb4a1d652d31aac53480100",
     "52ea4fcce76dac6e9a5e2df23d5d18a228c4cd3e3454636a0db31e817085eea9",
     "143e081f9a5f283a943f71b2fb966a517074565057a02d9200f01b54b4c89b69"),
    ("palette",
     "52494646c4010000574542505650384cb70100002f2fc007007740906d53a73b"
     "dd767e3343906d53a7d9dee94ef31f28840c9c043230e1203dc8ad6dbb959b90"
     "a92047138e03950e86269fa506e819dafb4464c22ce22aa6af80b9dc0b1e4da8"
     "12bc2aa1abe2fd5f4344ff15a66dc3d8ddfd24a5d3d5f75768535573fe6b6994"
     "ba100038680bbbf99b526ff821b6cd5055fd6996d26a1f1b1b6dcb2dccccfe77"
     "c7a3f1c2e67a5b68ce66662769210e0a70503d7e324bc3e5ad958a03b49991cd"
     "86f3ddb583a3b2db82354a1abd3bba3a6c9dd5ccecff491a737b0f026c0080c2"
     "fc63b9dbddec1fd68dda9861e65af7242dc9aeb07dbf33b393542671532052dd"
     "944d5d4969182955208da6d93dba972c122140e38d6cbe94428aa0a16a83498c"
     "52ab34bb9a77992cbb948a0a1100a666f766164f3a17a4548a607a0796cd9bca"
     "279242c1740821ec38eeedeea40c0b0594e9e0fc6cfe1d3b2cdc25191aaae33e"
     "adc448564e35f9ecfaf3310b8594f02208324208be2c91b190d321082a549bad"
     "1c938c12c20e2b7e64bc6d703199b0447a043a1782a35b3a24198250a402d9f1"
     "7c1f9718dda75681989ae3ce8ee70bc9e9f091a80acd36e71ef7c7178c6468f7"
     "f3bdd95d772992b11d5f0000",
     "3484799ab9656fcbbecb495183f98fa10393534316c5717c39c8d62c809b9554",
     "53af10640cdcb27a7b4736c2619b70c65eb1587f4b5e9f060af3fc13e31a00ae"),
)
# the SHA-256 of cv2.imread(path, IMREAD_GRAYSCALE) of gray_pngs()'s
# files (cv2 5.0.0, libpng 1.6.58)
PNG_GRAY_KNOWN = {
    "rgb8":
        "db998b418ab1ade2ed931e851f9bafe2c6ed764a6ad582ad7b7d66250d495e0f",
    "palette4":
        "47e81c6bb7b53cfae287ca2f287768ee8497db2f5de1de6a3f4d9d6e9d73b063",
    "rgb16":
        "1cee900c350c1273662072876878d5f350f0690b535c15d0ced2ca3e1aa1d74a",
    "rgb8_gama":
        "1ed449f17cb7ca42c19717943046b70fdbc6eb96ea8467b51aab58a63fbb56c0",
}
# the forms of the mixed folder, in file order: FORMAT_FILES images of
# SIZE²; the lossy ones (CMYK JPEG, VP8 WEBP) are held to their CPU route,
# the others to the PNG folder's outputs byte for byte
FORMS = ("24", "rle8", "32td", "adam7", "adam7", "cmyk", "vp8",
         "vp8l_alpha", "tiff_lzw", "tiff_tiles", "tiff_planar")
FORMAT_FILES = len(FORMS)
FORMAT_CLEAN = 2        # the last ones, without a logo (they run K1 and K2)
LOSSY = ("cmyk", "vp8")
FORMAT_TIMED = (1080, 1920)


def bmp_bytes(rgb, form: str) -> bytes:
    """An (H, W, 3) uint8 image as a BMP: "24" (BITMAPINFOHEADER,
    bottom-up), "rle8" (8-bit palette of the image's colours, RLE8 with an
    end of line a row and an end of bitmap; at most 256 colours), "32td"
    (a V5 header, BI_BITFIELDS with the masks B G R A, top-down)."""
    import struct

    import numpy as np

    h, w = rgb.shape[:2]
    pal = b""
    if form == "24":
        pitch = (3 * w + 3) & ~3
        rows = np.zeros((h, pitch), np.uint8)
        rows[:, :3 * w] = rgb[..., ::-1].reshape(h, -1)
        body, bpp, comp, height = rows[::-1].tobytes(), 24, 0, h
        info = b""
    elif form == "32td":
        px = np.concatenate([rgb[..., ::-1], np.full((h, w, 1), 255,
                                                     np.uint8)], 2)
        body, bpp, comp, height = px.tobytes(), 32, 3, -h
        info = struct.pack("<4I", 0xFF0000, 0xFF00, 0xFF, 0xFF000000)
        info += bytes(124 - 40 - len(info))
    else:
        colors, idx = np.unique(rgb.reshape(-1, 3), axis=0,
                                return_inverse=True)
        if len(colors) > 256:
            raise ValueError(f"{len(colors)} colours for an 8-bit palette")
        idx = idx.reshape(h, w).astype(np.uint8)
        pal = np.concatenate([colors[:, ::-1], np.zeros((len(colors), 1),
                                                        np.uint8)], 1)
        pal = pal.tobytes()
        out = bytearray()
        for r in idx[::-1]:
            cuts = np.flatnonzero(np.diff(r.astype(np.int16))) + 1
            starts = np.concatenate([[0], cuts])
            ends = np.concatenate([cuts, [w]])
            for s, e in zip(starts, ends):
                while e - s > 0:
                    n = min(e - s, 255)
                    out += bytes([n, int(r[s])])
                    s += n
            out += b"\x00\x00"
        out[-2:] = b"\x00\x01"
        body, bpp, comp, height = bytes(out), 8, 1, h
        info = b""
    header = 124 if form == "32td" else 40
    head = struct.pack("<IiiHHIIiiII", header, w, height, 1, bpp, comp,
                       len(body), 2835, 2835, len(pal) // 4, 0) + info
    off = 14 + len(head) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + head
            + pal + body)


def adam7_png(rgb) -> bytes:
    """An (H, W, 3) uint8 image as an interlaced (Adam7) 8-bit RGB PNG,
    each pass's rows Up-filtered (its own first row against zeros)."""
    import struct
    import zlib

    import numpy as np

    from unet_watermark_tpu_torch.utils import image_io

    h, w = rgb.shape[:2]
    raw = b"".join(image_io._filter_rows(np.ascontiguousarray(
        rgb[y0::dy, x0::dx]), (2,)) for x0, y0, dx, dy in image_io.ADAM7
        if rgb[y0::dy, x0::dx].size)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    return (image_io.SIGNATURE + image_io._chunk(b"IHDR", ihdr)
            + image_io._chunk(b"IDAT", zlib.compress(raw, 1))
            + image_io._chunk(b"IEND", b""))


def cmyk_jpeg(cmyk, quality: int = 90) -> bytes:
    """An (H, W, 4) uint8 CMYK image as a baseline 4:4:4 JPEG with an Adobe
    marker of transform 0 (values stored as given): the port's FDCT and
    quantizer (ops/jpeg.py) a component, the luma table for C and the
    chroma one for M, Y and K, and jpeg_entropy.c's Huffman coding of the
    four components in MCU order."""
    import struct

    import numpy as np
    import torch

    from unet_watermark_tpu_torch.ops import jpeg as jpx
    from unet_watermark_tpu_torch.ops.kernels import jpeg_entropy as je
    from unet_watermark_tpu_torch.utils import jpeg

    h, w = cmyk.shape[:2]
    bh, bw = -(-h // 8), -(-w // 8)
    tables = jpx.quality_tables(quality)
    blocks = []
    for c in range(4):
        plane = jpx._extend(torch.from_numpy(cmyk[..., c]).long(), 8 * bh,
                            8 * bw)
        coef = jpx.quantize(jpx.fdct_islow(jpx._blocks(plane) - 128),
                            tables[c > 0])
        blocks.append(coef[..., jpx._ZIGZAG].to(torch.int16).numpy())
    order = np.ascontiguousarray(np.stack(blocks, 2).reshape(-1, 64))
    comp = np.tile(np.arange(4, dtype=np.int32), bh * bw)
    codes, lens = je._std_codes()
    codes4 = np.ascontiguousarray(codes[[0, 1, 1, 1]])
    lens4 = np.ascontiguousarray(lens[[0, 1, 1, 1]])
    cap = order.size * 8 + 1024
    out = np.empty(cap, np.uint8)
    size = je._lib().uwt_jpeg_encode_scan(
        order.ctypes.data, order.shape[0], comp.ctypes.data, 4,
        codes4.ctypes.data, lens4.ctypes.data, out.ctypes.data, cap)
    if size < 0:
        raise RuntimeError(f"uwt_jpeg_encode_scan failed ({size})")
    seg = jpeg._segment
    parts = [jpeg.SOI, seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))]
    for t, q in enumerate(tables):
        parts.append(seg(0xDB, bytes([t]) + bytes(q[i] for i in
                                                  jpeg.NATURAL[:64])))
    parts.append(seg(0xC0, struct.pack(">BHHB", 8, h, w, 4) + bytes(
        [1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1, 4, 0x11, 1])))
    for cls_t, (bits, vals) in ((0x00, jpeg.STD_DC_LUMA),
                                (0x10, jpeg.STD_AC_LUMA),
                                (0x01, jpeg.STD_DC_CHROMA),
                                (0x11, jpeg.STD_AC_CHROMA)):
        parts.append(seg(0xC4, bytes([cls_t]) + bytes(bits) + bytes(vals)))
    parts.append(seg(0xDA, bytes([4, 1, 0x00, 2, 0x11, 3, 0x11, 4, 0x11, 0,
                                  63, 0])))
    return b"".join(parts) + out[:size].tobytes() + b"\xff\xd9"


def format_images(n: int, h: int, w: int, seed: int, clean: int = 0):
    """utils/synthetic's watermarked images as (n, h, w, 3) uint8, the
    last `clean` without a logo (their empty masks classify as the
    watermark type, whose parity chain runs K1 and K2)."""
    import numpy as np

    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    imgs = np.rint(watermarked_images(n, max(h, w), seed=seed,
                                      clean=clean)[0] * 255)
    return imgs[:, :h, :w].astype(np.uint8)


def to_palette(img):
    """An image cut to at most 216 colours (6 levels a channel), so an
    8-bit palette holds it."""
    return img // 43 * 51




def png_bytes(px, depth: int, ctype: int, palette=None, chunks: bytes = b""
              ) -> bytes:
    """A PNG of (H, W, C) samples of `depth` bits (1-16) and colour type
    `ctype`, rows unfiltered, `chunks` before PLTE and IDAT."""
    import struct
    import zlib

    import numpy as np

    from unet_watermark_tpu_torch.utils import image_io

    px = np.asarray(px)
    h, w = px.shape[:2]
    if depth == 16:
        rows = px.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // depth
        q = np.zeros((h, -(-w // per) * per), np.uint8)
        q[:, :w] = px.reshape(h, w)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = (q.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    out = image_io.SIGNATURE + image_io._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 0)) + chunks
    if palette is not None:
        out += image_io._chunk(b"PLTE", np.asarray(palette, np.uint8)
                               .tobytes())
    return (out + image_io._chunk(b"IDAT", zlib.compress(raw))
            + image_io._chunk(b"IEND", b""))


def gray_pngs() -> dict:
    """PNG_GRAY_KNOWN's files: mask-like 24 x 40 images (two levels and a
    ramp in three colours) as RGB, 4-bit palette, 16-bit RGB and RGB with
    gAMA 0.45455 PNGs."""
    import struct

    import numpy as np

    from unet_watermark_tpu_torch.utils import image_io

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:24, 0:40]
    m = ((yy - 12) ** 2 + (xx - 20) ** 2 < 90).astype(np.int64)
    rgb = np.stack([m * 250 + xx, m * 128 + yy * 3, 255 - m * 255], -1)
    rgb = np.clip(rgb + rng.integers(0, 3, rgb.shape), 0, 255)
    pal = rng.integers(0, 256, (16, 3))
    idx = (m * 8 + xx % 8)[..., None]
    gama = image_io._chunk(b"gAMA", struct.pack(">I", 45455))
    return {"rgb8": png_bytes(rgb, 8, 2),
            "palette4": png_bytes(idx, 4, 3, pal),
            "rgb16": png_bytes(rgb * 257 + rng.integers(0, 257, rgb.shape),
                               16, 2),
            "rgb8_gama": png_bytes(rgb, 8, 2, chunks=gama)}


def form_bytes(img, form: str, seed: int):
    """(file bytes, extension) of an (H, W, 3) uint8 image in one of FORMS
    (the VP8 one a blocky approximation, see utils/synthetic.vp8_bytes)."""
    import numpy as np

    from unet_watermark_tpu_torch.utils import synthetic

    h, w = img.shape[:2]
    if form == "cmyk":
        # Adobe's inverted convention with no black: c' = R, and so on
        return cmyk_jpeg(np.concatenate(
            [img, np.full_like(img[..., :1], 255)], 2)), "jpg"
    if form == "adam7":
        return adam7_png(img), "png"
    if form == "vp8":
        return synthetic.vp8_bytes(h, w, seed, partitions=4, segments=False,
                                   image=img), "webp"
    if form == "vp8l_alpha":
        alpha = np.linspace(64, 255, w).astype(np.uint8)[None].repeat(h, 0)
        return synthetic.vp8l_bytes(
            np.dstack([img, alpha]), ("subtract_green", "predictor",
                                      "cross_color"), seed, meta_bits=5
        ), "webp"
    if form == "tiff_lzw":
        return synthetic.tiff_bytes(img, "lzw", 2, rows_per_strip=32), "tiff"
    if form == "tiff_tiles":
        return synthetic.tiff_bytes(img, "deflate", tile=(128, 128)), "tiff"
    if form == "tiff_planar":
        return synthetic.tiff_bytes(img, "packbits", planar=2,
                                    rows_per_strip=64, byteorder=">"), "tiff"
    return bmp_bytes(img, form), "bmp"


def _known_answers(dev) -> dict:
    """The zstd, WEBP and gray-PNG known answers; raises where one is not
    met."""
    import hashlib

    import numpy as np
    import torch

    from unet_watermark_tpu_torch.ops.kernels import zstd
    from unet_watermark_tpu_torch.utils import image_io, webp

    def sha(x) -> str:
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()

    answers = {"zstd": [], "webp": [], "gray_png": []}
    for frame, want in ZSTD_KNOWN:
        out = zstd.decompress(bytes.fromhex(frame))
        answers["zstd"].append({"bytes": len(out), "sha256_ok": hashlib.sha256(
            out).hexdigest() == want})
    for name, data, rgb, rgba in WEBP_KNOWN:
        data = bytes.fromhex(data)
        answers["webp"].append({
            "name": name, "bytes": len(data),
            "rgb_ok": sha(webp.decode(data, dev)) == rgb,
            "rgba_ok": sha(webp.decode(data, dev, exif=False,
                                       rgba=True)) == rgba})
    for name, data in gray_pngs().items():
        answers["gray_png"].append({
            "name": name, "sha256_ok": sha(image_io.decode_png(
                data, gray=True)) == PNG_GRAY_KNOWN[name]})
    if not all(v for group in answers.values() for a in group
               for k, v in a.items() if k.endswith("_ok")):
        raise AssertionError(f"known answers: {answers}")
    return answers


# the 1080p files phase 3o times, by name: (form, extension)
TIMED_FILES = (("bmp24", "bmp"), ("bmp_rle8", "bmp"), ("adam7", "png"),
               ("vp8l", "webp"), ("tiff_lzw", "tiff"), ("cmyk", "jpg"),
               ("vp8", "webp"))


def write_inputs(work: Path, seed: int, size: int = SIZE,
                 timed_shape=FORMAT_TIMED) -> dict:
    """Phase 3o's files, on the host (chip_smoke.py writes them in a host
    worker while the kernels build): the PNG folder fmt_png, the same
    pixels in FORMS under fmt_mixed, and the 1080p files of TIMED_FILES
    under fmt_timed. Returns {"write_s": seconds, "lossy": {stem: form}}."""
    import numpy as np

    from unet_watermark_tpu_torch.utils import image_io, synthetic

    t0 = time.perf_counter()
    imgs = format_images(FORMAT_FILES, size, size, seed + 31,
                         clean=FORMAT_CLEAN)
    imgs[FORMS.index("rle8")] = to_palette(imgs[FORMS.index("rle8")])
    png, mixed, timed = (work / "fmt_png", work / "fmt_mixed",
                         work / "fmt_timed")
    for d in (png, mixed, timed):
        d.mkdir()
    lossy = {}
    for i, (img, form) in enumerate(zip(imgs, FORMS)):
        image_io.write_png(png / f"f{i}.png", img)
        data, ext = form_bytes(img, form, seed + i)
        (mixed / f"f{i}.{ext}").write_bytes(data)
        if form in LOSSY:
            lossy[f"f{i}"] = form
    th, tw = timed_shape
    big = format_images(1, th, tw, seed + 32)[0]
    blobs = {"bmp24": lambda: bmp_bytes(big, "24"),
             "bmp_rle8": lambda: bmp_bytes(to_palette(big), "rle8"),
             "adam7": lambda: adam7_png(big),
             "vp8l": lambda: synthetic.vp8l_bytes(big, ("subtract_green",)),
             "tiff_lzw": lambda: synthetic.tiff_bytes(big, "lzw", 2,
                                                      rows_per_strip=16),
             "cmyk": lambda: cmyk_jpeg(np.concatenate(
                 [big, np.full_like(big[..., :1], 255)], 2)),
             "vp8": lambda: synthetic.vp8_bytes(th, tw, seed, partitions=4)}
    for name, ext in TIMED_FILES:
        (timed / f"{name}.{ext}").write_bytes(blobs[name]())
    return {"write_s": time.perf_counter() - t0, "lossy": lossy}


def formats_phase(work: Path, seed: int, dev, size: int = SIZE,
                  timed_shape=FORMAT_TIMED, inputs=None) -> dict:
    """Phase 3o (see the module docstring), on write_inputs' files (`inputs`
    its result; written here where None). Returns the timing fields and
    the launches of the mixed folder's run. On the CPU (a rehearsal) the
    CLI runs with --device cpu."""
    import numpy as np
    import torch

    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.utils import bmp, image_io, tiff, webp

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    answers = _known_answers(dev)
    if inputs is None:
        inputs = write_inputs(work, seed, size, timed_shape)
    png, mixed = work / "fmt_png", work / "fmt_mixed"
    lossy = {p.stem: (inputs["lossy"][p.stem], p.read_bytes())
             for p in mixed.iterdir() if p.stem in inputs["lossy"]}
    imgs = [image_io.read_rgb(png / f"f{i}.png")
            for i in range(FORMAT_FILES)]
    for path in sorted(mixed.iterdir()):  # the host decode as cv2 reads
        if path.stem not in lossy and not np.array_equal(
                image_io.read_rgb(path), imgs[int(path.stem[1:])]):
            raise AssertionError(f"{path.name} does not decode to the "
                                 f"pixels written")

    runs = {}
    for name, folder in (("png", png), ("mixed", mixed)):
        kc.reset_launch_counts()
        argv = ["repair", "--input", str(folder), "--no-ocr", "--output",
                str(work / f"{name}_out")]
        if dev.type != "cuda":
            argv += ["--device", dev.type]
        rc, wall, _ = run_cli(argv, dev, timer=False)
        launches = {k.__name__: k.launches for k in kc.KERNELS}
        if rc != 0 or (dev.type == "cuda" and min(launches.values()) < 1):
            raise AssertionError(f"repair over {folder.name}: rc {rc}, "
                                 f"launches {launches}")
        runs[name] = {"rc": rc, "wall_s": wall, "launches": launches}
    # every output PNG of the lossless files byte-equal to the PNG folder's,
    # but where the pipeline copies the input file (an image below the
    # repair threshold, as the JAX package copies it): then a copy of the
    # input, decoding to the PNG folder's pixels
    a, b = work / "png_out", work / "mixed_out"
    sources = {p.stem: p for p in mixed.iterdir()}
    outputs = {}
    for root in (a, b):
        outputs[root] = {str(p.relative_to(root)) for p in root.rglob("*.png")
                         if p.name.split(".")[0].split("_")[0] not in lossy}
    compared, copied, differ = 0, 0, []
    if outputs[a] != outputs[b]:
        differ.append(sorted(outputs[a] ^ outputs[b]))
    for rel in sorted(outputs[a] & outputs[b]):
        x, y = (a / rel).read_bytes(), (b / rel).read_bytes()
        compared += 1
        if x == y:
            continue
        src = sources[Path(rel).name.split(".")[0].split("_")[0]]
        if y == src.read_bytes() and np.array_equal(
                image_io.read_rgb(a / rel), image_io.read_rgb(b / rel)):
            copied += 1
        else:
            differ.append(rel)
    if differ or not compared:
        raise AssertionError(f"repair outputs of the mixed folder differ "
                             f"from the PNG folder's: {differ}")

    lossy_err = {}
    for stem, (form, data) in lossy.items():
        decode = image_io.decode_jpeg if form == "cmyk" else webp.decode
        for gray in (True, False):
            card = decode(data, dev, gray=gray).cpu()
            if not torch.equal(card, decode(data, "cpu", gray=gray)):
                raise AssertionError(f"the {form} file's decode on the card "
                                     f"differs from its CPU route")
        pixels = torch.from_numpy(imgs[int(stem[1:])]).int()
        lossy_err[form] = (card.int() - pixels).abs().float().mean().item()

    # 1080p decodes: on the host (BMP, Adam7, VP8L, TIFF), and the CMYK
    # JPEG's and VP8's entropy decode (host, C) and pixel stage (the card)
    files = {name: (work / "fmt_timed" / f"{name}.{ext}").read_bytes()
             for name, ext in TIMED_FILES}
    timed = {}
    for key, fn, reps in (("bmp24", bmp.decode, 3), ("bmp_rle8", bmp.decode, 3),
                          ("adam7", image_io.decode_png, 3),
                          ("vp8l", lambda d: webp.decode(d, "cpu"), 3),
                          ("tiff_lzw", tiff.decode, 3)):
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(files[key])
            ms.append((time.perf_counter() - t0) * 1e3)
        timed[f"{key}_1080x1920_decode_ms"] = ms  # (at timed_shape)
    parts = collections.defaultdict(list)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    @contextlib.contextmanager
    def part(name):
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        parts[name].append((time.perf_counter() - t0) * 1e3)

    for _ in range(4):
        image_io.decode_jpeg(files["cmyk"], dev, part=part)
        webp.decode(files["vp8"], dev, part=part)
    timed["cmyk_1080x1920_entropy_ms"] = parts["jpeg_entropy"][1:]
    timed["cmyk_1080x1920_pixels_ms"] = parts["jpeg_pixels"][1:]
    timed["vp8_1080x1920_entropy_ms"] = parts["webp_entropy"][1:]
    timed["vp8_1080x1920_pixels_ms"] = parts["webp_pixels"][1:]
    fields = {"known_answers": answers, "files": FORMAT_FILES, "forms": FORMS,
              "size": size, "timed_shape": list(timed_shape),
              "write_s": inputs["write_s"],
              "outputs_compared": compared, "outputs_equal": True,
              "outputs_input_copies": copied,
              "lossy_card_equals_cpu": True,
              "lossy_mean_abs_vs_pixels": lossy_err,
              "repair": runs, **timed,
              "phase_s": time.perf_counter() - t_phase}
    log("formats", **fields)
    return {"timing": {k: v for k, v in fields.items()
                       if k.endswith(("_ms", "_s"))},
            "launches": runs["mixed"]["launches"]}
