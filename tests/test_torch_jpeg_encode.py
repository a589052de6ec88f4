"""The JPEG encoder (ops/jpeg.encode_coefficients, the C Huffman stage of
csrc/jpeg_entropy.c, utils/jpeg.baseline_headers, utils/image_io
.encode_jpeg) against Pillow's save(quality=95): equal bytes, for every
size from 1 x 1 to 37 x 53 on a grid (odd sizes and edges off the 8 and
16 px grids), 512², and flat, gradient and noise content."""
import io

import numpy as np
import pytest
import torch
from PIL import Image

from unet_watermark_tpu_torch.ops import jpeg as jpeg_pixels
from unet_watermark_tpu_torch.ops.kernels import jpeg_entropy
from unet_watermark_tpu_torch.utils import image_io


def _pil(a, quality=95):
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG", quality=quality)
    return b.getvalue()


def _content(kind, h, w, seed=0):
    rng = np.random.default_rng(seed + h * 100 + w)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                               (h, w, 3)).copy()
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (yy + xx) * 127 // max(h + w - 2, 1)],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("h", [1, 2, 3, 7, 8, 9, 15, 16, 17, 23, 31, 33,
                               37])
def test_sizes_equal_pillow(h):
    for w in (1, 2, 5, 8, 11, 16, 17, 24, 29, 32, 41, 48, 53):
        for kind in ("noise", "flat", "gradient"):
            a = _content(kind, h, w)
            assert image_io.encode_jpeg(torch.from_numpy(a)) == _pil(a), \
                (h, w, kind)


@pytest.mark.parametrize("kind", ["noise", "flat", "gradient"])
def test_512_equals_pillow(kind):
    a = _content(kind, 512, 512)
    assert image_io.encode_jpeg(torch.from_numpy(a)) == _pil(a)


def test_other_qualities_equal_pillow():
    a = _content("noise", 21, 30)
    for q in (10, 50, 75, 90, 100):
        assert image_io.encode_jpeg(a, q) == _pil(a, q), q


def test_decodes_back():
    """The file decodes to what Pillow decodes it to (through the port's
    decoder, as cv2.imread reads it)."""
    a = _content("gradient", 45, 70)
    data = image_io.encode_jpeg(a)
    ref = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
    got = image_io.decode_jpeg(data, "cpu").numpy()
    assert np.array_equal(ref, got)


def test_stages_count_and_shapes():
    a = torch.from_numpy(_content("noise", 17, 33))
    y, cb, cr = jpeg_pixels.encode_coefficients(a)
    assert y.shape == (4, 6, 64) and cb.shape == cr.shape == (2, 3, 64)
    # the dummy blocks: AC zero, the DC of the block before them
    assert not y[:, 5, 1:].any() and torch.equal(y[:, 5, 0], y[:, 4, 0])
    assert not y[3, :, 1:].any()
    assert torch.equal(y[3, 0::2, 0], y[2, 1::2, 0])
    before = jpeg_entropy.encode_scan.calls
    image_io.encode_jpeg(a)
    assert jpeg_entropy.encode_scan.calls == before + 1
