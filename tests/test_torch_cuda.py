"""The port's CUDA kernels against their plain versions on the card, and
the port's float ops on the card against the CPU.

Run on a machine with an NVIDIA H100 and nvcc:
    python -m pytest tests/test_torch_cuda.py -q
Without a card each test skips (the plain versions are held against the
JAX package in tests/test_torch_morph.py).
"""
import numpy as np
import pytest
import torch

from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.inference import engines, maskproc
from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
from unet_watermark_tpu_torch.ops import components, inpaint, morphology
from unet_watermark_tpu_torch.utils.shipping import WEIGHTS_DIR
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images
from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none on this machine)")
    return torch.device("cuda")


def _masks(seed, n=3, s=128, p=0.35):
    mk = (np.random.default_rng(seed).random((n, s, s)) < p)
    mk[0, :9, :] = mk[0, :, -9:] = True  # foreground on the borders
    return torch.from_numpy(mk.astype(np.float32))


@pytest.mark.parametrize("s", [20, 33, 64, 96, 100, 128, 200, 512, 1000])
@pytest.mark.parametrize("p", [0.2, 0.35, 0.5])
def test_k1_bit_exact(cuda, s, p):
    masks = _masks(int(p * 100) + s, s=s, p=p)
    ref = kc.morph_chain_plain(masks.to(cuda))
    before = kc.morph_chain_watermark.launches
    out = kc.morph_chain_watermark(masks.to(cuda))
    torch.cuda.synchronize()
    assert kc.morph_chain_watermark.launches == before + 1
    assert torch.equal(out, ref)


def test_k1_at_the_size_limit(cuda):
    """S = K1_MAX_SIZE takes the most shared memory (set once per
    device); one above it raises on the card."""
    s = kc.K1_MAX_SIZE
    masks = _masks(4, n=1, s=s, p=0.3).to(cuda)
    for _ in range(2):
        out = kc.morph_chain_watermark(masks)
    assert torch.equal(out, kc.morph_chain_plain(masks))
    before = kc.morph_chain_watermark.launches
    with pytest.raises(ValueError, match="limit"):
        kc.morph_chain_watermark(torch.zeros(1, s + 1, s + 1, device=cuda))
    assert kc.morph_chain_watermark.launches == before


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("s", [64, 100, 101, 128])
def test_k2_bit_exact(cuda, s, aligned):
    x = np.random.default_rng(s).random((3, s, s)).astype(np.float32)
    x.reshape(-1)[::7] = np.resize(np.array(
        [np.nan, np.inf, -np.inf, 0.5, 0.50000006, 0.49999997],
        np.float32), x.size)[::7]
    flat = torch.empty(x.size + 1, device=cuda)  # offset 4 B: no float4
    x = (flat[:x.size] if aligned else flat[1:]).view(x.shape).copy_(
        torch.from_numpy(x))
    before = kc.gaussian_smooth_threshold.launches
    out = kc.gaussian_smooth_threshold(x)
    torch.cuda.synchronize()
    assert kc.gaussian_smooth_threshold.launches == before + 1
    assert torch.equal(out, kc.smooth_threshold_plain(x))
    assert torch.equal(out, (x > 0.5).float())


def test_batch_chain_on_card_matches_plain_chain(cuda):
    masks = _masks(9, n=2, s=128, p=0.4)
    out = maskproc.optimize_watermark_mask_batch(masks.to(cuda)).cpu()
    for i, mk in enumerate(masks):
        assert torch.equal(out[i], maskproc.optimize_watermark_mask(mk))


@pytest.fixture
def default_tf32():
    """torch's default TF32 flags (cuDNN convolutions may use TF32,
    matmuls not), restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def test_float_ops_ignore_the_callers_tf32_flag(cuda, default_tf32):
    """Under the default flags the float ops of the mask and fill stages
    agree with the CPU at the CPU tests' tolerances: the blur within 1e-6,
    the push-pull repair (32 Jacobi sweeps) within 1e-5, the type score's
    Sobel within 1e-4 of values up to 4 * 255, and the scores within the
    1e-5 of tests/test_torch_maskproc.py with equal classes."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((2, 96, 96)).astype(np.float32))
    blur = morphology.gaussian_blur(img.to(cuda), (3, 3), 0.5).cpu()
    assert (blur - morphology.gaussian_blur(img, (3, 3), 0.5)).abs().max() \
        <= 1e-6
    images = torch.from_numpy(rng.random((2, 64, 64, 3)).astype(np.float32))
    holes = _masks(5, n=2, s=64, p=0.3)
    rep = inpaint.inpaint_pushpull(images.to(cuda), holes.to(cuda), 32).cpu()
    assert (rep - inpaint.inpaint_pushpull(images, holes, 32)).abs().max() \
        <= 1e-5
    gray = torch.from_numpy((rng.random((2, 64, 64)) * 255).astype(np.float32))
    for on_card, on_cpu in zip(maskproc._sobel(gray.to(cuda)),
                               maskproc._sobel(gray)):
        assert (on_card.cpu() - on_cpu).abs().max() <= 1e-4
    rgb = torch.round(images * 255)
    scores = maskproc.detect_watermark_type_scores(rgb.to(cuda),
                                                   holes.to(cuda)).cpu()
    ref = maskproc.detect_watermark_type_scores(rgb, holes)
    assert (scores - ref).abs().max() <= 1e-5
    assert [maskproc.classify_type(x) for x in scores.tolist()] == \
        [maskproc.classify_type(x) for x in ref.tolist()]


@pytest.mark.parametrize("mode", ["parity", "tight"])
def test_partitioned_on_card_matches_cpu(cuda, mode):
    """All three strategies on the card; code 0 in parity mode launches
    K1 and K2."""
    masks = _masks(11, n=6, s=128, p=0.3)
    codes = [0, 1, 2, 0, 2, 1]
    before = [k.launches for k in kc.KERNELS]
    out = maskproc.optimize_mask_batch_partitioned(masks.to(cuda), codes,
                                                   mode=mode)
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kc.KERNELS, before)]
    assert launched == ([1, 1] if mode == "parity" else [0, 0])
    assert torch.equal(out.cpu(), maskproc.optimize_mask_batch_partitioned(
        masks, codes, mode=mode))


def test_labels_on_card_past_2_24_pixels(cuda):
    mk = torch.zeros(1, 4100, 4100, device=cuda)
    mk[0, -10:, -10:] = 1
    mk[0, 4095:4098, 18:21] = 1
    labels = components.label_components(mk)
    assert int(labels[0, -1, -1]) == 4090 * 4100 + 4090 + 1
    assert int(labels[0, 4097, 20]) == 4095 * 4100 + 18 + 1


@pytest.fixture
def no_tf32():
    """Full float32 convolutions and matmuls, restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def test_lama_fp32_on_card_matches_cpu(cuda, no_tf32):
    """The float32 generator with the shipped weights on the card (cuDNN,
    cuFFT) against the CPU at 2 x 128², TF32 off: max abs 1e-3."""
    lama_path = WEIGHTS_DIR / "lama_ffc.npz"
    on_card, _ = engines.load_lama(lama_path, "lama", cuda, torch.float32)
    on_cpu, _ = engines.load_lama(lama_path, "lama", "cpu", torch.float32)
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.random((2, 128, 128, 3)).astype(np.float32))
    mask = torch.zeros(2, 128, 128, 1)
    mask[:, 30:70, 40:100] = 1
    with torch.inference_mode():
        out = on_card(img.to(cuda), mask.to(cuda)).cpu()
        ref = on_cpu(img, mask)
    assert (out - ref).abs().max() <= 1e-3


def test_default_fused_fn_on_card_runs_lama(cuda, monkeypatch):
    """The default fused fn on the card fills with the bf16 generator: its
    engine is "ffc-lama", its mask the plain tight chain, pixels outside
    the mask exactly the input's, the output finite in [0, 1]."""
    monkeypatch.delenv("PREDICT_INPAINT_WEIGHTS", raising=False)
    pred = WatermarkPredictor(get_cfg_defaults(), device="cuda")
    fused = pred.make_fused_repair_fn()
    assert fused.engine_used == "ffc-lama"
    images = torch.from_numpy(watermarked_images(2, 128, seed=3)[0]).to(cuda)
    repaired, mask = fused(images)
    raw = pred.predict_masks(images)
    for i, mk in enumerate(raw):
        assert torch.equal(mask[i], maskproc.optimize_watermark_mask_tight(mk))
    assert mask.sum() > 0
    assert torch.isfinite(repaired).all()
    assert repaired.min() >= 0 and repaired.max() <= 1
    keep = (mask == 0)[..., None].expand_as(images)
    assert torch.equal(repaired[keep], images[keep])


@pytest.mark.parametrize("src, dst", [((1080, 1920), (512, 512)),
                                      ((720, 1280), (512, 512)),
                                      ((512, 512), (1080, 1920)),
                                      ((100, 70), (64, 64)),
                                      ((37, 53), (120, 90))], ids=str)
def test_resizes_on_card_equal_cpu(cuda, src, dst):
    """The cv2-parity resizes (ops/resize.py) give the same bits on the card
    as on the CPU, where tests/test_torch_image_io.py holds them to cv2."""
    from unet_watermark_tpu_torch.ops import resize as rs

    rng = np.random.default_rng(sum(src))
    img = torch.from_numpy(rng.integers(0, 256, (2,) + src + (3,),
                                        dtype=np.uint8))
    prob = torch.from_numpy(rng.random((2,) + src).astype(np.float32))
    mask = (prob > 0.7).to(torch.uint8) * 255
    for fn, x in ((rs.resize_linear_u8, img), (rs.resize_linear_f32, prob),
                  (rs.resize_nearest, mask), (rs.resize_nearest, prob)):
        out = fn(x.to(cuda), dst)
        assert out.device.type == "cuda"
        assert torch.equal(out.cpu(), fn(x, dst)), fn.__name__


@pytest.mark.parametrize("shape", [(1080, 1920), (720, 1280), (257, 311),
                                   (1, 17)], ids=str)
def test_image_ops_on_card_equal_cpu(cuda, shape):
    """The cv2-parity image ops (ops/imgproc.py) give the same bits on the
    card as on the CPU, where tests/test_torch_imgproc.py holds them to
    cv2; the text detector's regions and _enhance_text_features too."""
    from unet_watermark_tpu_torch.ocr import BuiltinTextDetector
    from unet_watermark_tpu_torch.ops import imgproc as ip
    from unet_watermark_tpu_torch.utils.synthetic import text_images

    if min(shape) > 1:
        rgb = torch.from_numpy(text_images([shape], seed=sum(shape),
                                           logo=[True])[0][0])
    else:
        rng = np.random.default_rng(sum(shape))
        rgb = torch.from_numpy(rng.integers(0, 256, shape + (3,),
                                            dtype=np.uint8))
    gray = ip.gray_u8(rgb)
    bw = ip.otsu_threshold(ip.morph_gradient(gray, morphology.ellipse_kernel(
        3, 3)))[1]
    for name, fn, x in (
            ("gray", ip.gray_u8, rgb),
            ("dilate", lambda g: ip.grey_dilate(g, morphology.rect_kernel(
                9, 3)), gray),
            ("erode", lambda g: ip.grey_erode(g, morphology.ellipse_kernel(
                2, 2)), gray),
            ("gradient", lambda g: ip.morph_gradient(
                g, morphology.ellipse_kernel(3, 3)), gray),
            ("otsu", lambda g: ip.otsu_threshold(g)[1], gray),
            ("clahe", ip.clahe, gray),
            ("canny", lambda g: ip.canny(ip.clahe(g), 50, 150), gray),
            ("filter2d", lambda x: ip.filter2d_u8(x, ip.SHARPEN), rgb)):
        out = fn(x.to(cuda))
        assert out.device.type == "cuda"
        assert torch.equal(out.cpu(), fn(x)), name
    assert ip.external_boxes(bw.to(cuda)) == ip.external_boxes(bw)
    assert torch.equal(
        WatermarkPredictor._enhance_text_features(None, rgb.to(cuda)).cpu(),
        WatermarkPredictor._enhance_text_features(None, rgb))
    img = rgb.numpy()
    assert BuiltinTextDetector(device="cuda").detect_text_regions(img) == \
        BuiltinTextDetector(device="cpu").detect_text_regions(img)


# encode_jpeg's forms (the decoder matrix's subset that needs no cv2):
# (shape, quality, sampling, progressive, restart, orientation)
JPEG_FORMS = [((512, 512), 95, "420", False, 0, None),
              ((720, 1280), 90, "444", False, 4, None),
              ((720, 1280), 85, "422", False, 0, None),
              ((1080, 1920), 95, "420", True, 0, None),
              ((1920, 1080), 95, "420", False, 0, 6),
              ((129, 191), 90, "gray", True, 3, 3)]


@pytest.mark.parametrize("form", JPEG_FORMS, ids=lambda f: "x".join(
    map(str, f[0])) + f"-{f[2]}-{'p' if f[3] else 'b'}")
def test_jpeg_card_route_equals_cpu(cuda, form):
    """A JPEG decoded on the card's route (the C entropy decoder, the pixel
    stage on the card) equals the CPU's (the Python decoder, the pixel
    stage on the CPU), byte for byte, colour and gray; so does a file cut
    30 % into its entropy data."""
    from unet_watermark_tpu_torch.ops.kernels import jpeg_entropy
    from unet_watermark_tpu_torch.utils import image_io, jpeg
    from unet_watermark_tpu_torch.utils.synthetic import encode_jpeg

    shape, q, sampling, prog, rst, orient = form
    img, _ = watermarked_images(1, max(shape), seed=sum(shape))
    img = (img[0, :shape[0], :shape[1]] * 255).astype(np.uint8)
    if sampling == "gray":
        img, sampling = img[..., 1].copy(), "444"
    data = encode_jpeg(img, q, sampling, prog, rst, orient)
    start = jpeg.parse(data, headers_only=True).scans[0].start
    for body in (data, data[:start + (len(data) - start) * 3 // 10]):
        for gray in (False, True):
            before = jpeg_entropy.decode_scans_c.calls
            card = image_io.decode_jpeg(body, cuda, gray)
            assert jpeg_entropy.decode_scans_c.calls == before + 1
            assert card.device.type == "cuda"
            assert torch.equal(card.cpu(),
                               image_io.decode_jpeg(body, "cpu", gray))


# uwt_conv_s8 (csrc/conv_s8.cu): every conv form of the two archs, at small
# shapes with ragged tiles and at shapes of the 8 x 512² forward, bf16 and
# fp32 outputs, held bit for bit against its plain version on the card: each
# output-channel tile width (Cout 16, 32, 64, 128, and 256 and 512 as two
# and four 128-wide tiles), output-pixel counts that are no multiple of the
# tile, the up-conv's four phases at odd sizes, the stem at 8 x 512², and
# the TMA modes (conv_s8.conv_mode: 3x3 stride-1 convs and up-convs; halo
# where the output row holds whole tiles, taps where a tile holds whole
# rows), with partial channel chunks, the 160 -> 32 conv of the UNet++
# decoder at 8 x 256², and Cout of no 16-byte output row (the epilogue's
# pairwise stores).
# (kernel, stride, padding, lhs dilation, cin, cout, n, side)
CONV_S8_FORMS = [(7, 2, 3, 1, 3, 64, 2, 36), (3, 1, 1, 1, 16, 16, 1, 19),
                 (3, 2, 1, 1, 64, 128, 2, 17), (1, 2, 0, 1, 64, 128, 2, 17),
                 (4, 1, 2, 2, 32, 16, 2, 13), (3, 1, 1, 1, 48, 40, 1, 7),
                 (7, 2, 3, 1, 3, 64, 8, 512), (3, 1, 1, 1, 64, 64, 8, 128),
                 (3, 1, 1, 1, 512, 512, 8, 16), (4, 1, 2, 2, 32, 16, 8, 256),
                 (4, 1, 2, 2, 512, 256, 8, 16),
                 (3, 1, 1, 1, 32, 16, 2, 21), (3, 1, 1, 1, 32, 32, 2, 21),
                 (3, 1, 1, 1, 32, 64, 2, 21), (3, 1, 1, 1, 32, 128, 2, 21),
                 (3, 1, 1, 1, 32, 256, 2, 21), (3, 1, 1, 1, 32, 512, 1, 11),
                 (4, 1, 2, 2, 16, 8, 1, 5), (4, 1, 2, 2, 48, 40, 1, 7),
                 (4, 1, 2, 2, 160, 96, 3, 9), (3, 1, 1, 1, 160, 32, 1, 33),
                 (7, 2, 3, 1, 3, 64, 1, 37), (3, 1, 1, 1, 32, 32, 1, 64),
                 (3, 1, 1, 1, 160, 32, 1, 128), (4, 1, 2, 2, 48, 40, 1, 64),
                 (3, 1, 1, 1, 16, 16, 2, 128), (3, 1, 1, 1, 96, 32, 2, 64),
                 (3, 1, 1, 1, 192, 64, 1, 64), (3, 1, 1, 1, 128, 64, 1, 128),
                 (3, 1, 1, 1, 64, 32, 1, 128), (3, 1, 1, 1, 160, 32, 8, 256),
                 (4, 1, 2, 2, 64, 32, 1, 64), (4, 1, 2, 2, 48, 24, 2, 128),
                 (3, 1, 1, 1, 256, 256, 2, 32), (3, 1, 1, 1, 160, 32, 2, 16),
                 (4, 1, 2, 2, 64, 32, 2, 32), (3, 1, 1, 1, 48, 40, 1, 8),
                 (3, 1, 1, 1, 16, 12, 1, 19), (3, 2, 1, 1, 32, 5, 2, 16),
                 # the zoo's: resnet50's 1x1 convs at stride 1 and 2 (Cin
                 # to 2048) at 2 x 1024², UnetTPU's stride-2 skip2_reduce
                 (1, 1, 0, 1, 64, 256, 2, 256),
                 (1, 1, 0, 1, 2048, 512, 2, 32),
                 (1, 2, 0, 1, 1024, 2048, 2, 64),
                 (1, 2, 0, 1, 256, 512, 2, 256), (3, 2, 1, 1, 64, 64, 8, 256)]


@pytest.mark.parametrize("form", CONV_S8_FORMS, ids=lambda f: "-".join(
    map(str, f)))
def test_conv_s8_bit_exact(cuda, form):
    """An activation of 3 channels is given at 16 (quantize_s8's padded
    stem operand), with random bytes in the padding: they meet zero
    weights. Small forms run with both output-pixel tiles; each form in
    the TMA mode that takes it (conv_s8.conv_mode) and in the gather
    mode."""
    from unet_watermark_tpu_torch.ops import quant
    from unet_watermark_tpu_torch.ops.kernels import conv_s8
    k, stride, pad, dil, cin, cout, n, side = form
    g = torch.Generator().manual_seed(sum(form))
    x = torch.randint(-127, 128, (n, conv_s8.padded_channels(cin), side,
                                  side), generator=g, dtype=torch.int8)
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    w = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                      dtype=torch.int8).to(cuda)
    scale = torch.rand(cout, generator=g).to(cuda) * 1e-3
    scale[0] = 1e-17  # a dead operand's f32(sx) * sw: not flushed
    tiles = (None, 64, 128) if n * side * side <= 4096 else (None,)
    for dtype in (torch.bfloat16, torch.float32):
        ref = quant.conv_s8_plain(x, w, scale, stride, pad, dil, dtype)
        for tile_m in tiles:
            for mode in (None, "gather"):
                before = conv_s8.conv_s8.launches
                out = conv_s8._conv_s8(x, w, scale, stride=stride,
                                       padding=pad, dilation=dil,
                                       out_dtype=dtype, tile_m=tile_m,
                                       mode=mode)
                torch.cuda.synchronize()
                assert conv_s8.conv_s8.launches == before + 1
                assert out.shape == ref.shape and out.dtype == dtype
                assert out.is_contiguous(memory_format=torch.channels_last)
                assert torch.equal(out, ref), (tile_m, mode)
                assert (out[:, 0] != 0).any() or not ref[:, 0].any()


def test_conv_s8_refuses_what_it_does_not_take(cuda):
    from unet_watermark_tpu_torch.ops.kernels import conv_s8
    x = torch.zeros(1, 16, 8, 8, dtype=torch.int8, device=cuda)
    w = torch.zeros(8, 16, 3, 3, dtype=torch.int8, device=cuda)
    s = torch.ones(8, device=cuda)
    cl = torch.channels_last
    with pytest.raises(ValueError, match="channels_last"):
        conv_s8.conv_s8(x, w, s)
    with pytest.raises(TypeError):
        conv_s8.conv_s8(x.float(), w, s)
    x3 = torch.zeros(1, 3, 8, 8, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        conv_s8.conv_s8(x3.contiguous(memory_format=cl), w[:, :3], s)
    with pytest.raises(ValueError, match="up-conv"):
        conv_s8.conv_s8(x.contiguous(memory_format=cl), w, s, dilation=2)
    with pytest.raises(ValueError, match="does not fit"):
        conv_s8._conv_s8(x.contiguous(memory_format=cl), w, s, mode="gather",
                         packed=conv_s8.pack_weight(w[:, :, :1, :1]))
    with pytest.raises(ValueError, match="halo mode"):  # a 9-pixel row
        conv_s8._conv_s8(torch.zeros(1, 16, 9, 9, dtype=torch.int8,
                                     device=cuda).contiguous(
                                         memory_format=cl),
                         w, s, mode="halo")
    with pytest.raises(ValueError, match="mode"):
        conv_s8._conv_s8(x.contiguous(memory_format=cl), w, s, mode="tma")
    # the quantize
    xf = torch.zeros(1, 3, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        conv_s8.quantize_s8(xf, 1.0)
    with pytest.raises(TypeError):
        conv_s8.quantize_s8(x.contiguous(memory_format=cl), 1.0)
    with pytest.raises(ValueError, match="output channels"):
        conv_s8.quantize_s8(xf.contiguous(memory_format=cl), 1.0, 8)
    with pytest.raises(TypeError):
        conv_s8.quantize_s8(xf.half().contiguous(memory_format=cl), 1.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 64, 17, 19), (1, 3, 512, 512),
                                   (3, 5, 7, 9), (8, 96, 64, 64),
                                   (1, 1, 1, 1)])
@pytest.mark.parametrize("aligned", [True, False])
def test_quantize_s8_bit_exact(cuda, dtype, shape, aligned):
    """uwt_quantize_s8 against its plain version (the torch chain on the
    CPU): exact .5 ties of x * f32(1/sx), values far beyond ±127, amax
    1e-12 (1/sx ~ 1.3e14), ragged sizes and, unaligned, the scalar path;
    3- and 5-channel inputs also padded to 16 channels with zeros."""
    from unet_watermark_tpu_torch.ops import quant
    from unet_watermark_tpu_torch.ops.kernels import conv_s8
    n, c, h, w = shape
    g = torch.Generator().manual_seed(sum(shape))
    for amax in (1e-12, 0.37, 6.35, 1e4):
        sx, inv = quant.activation_scale(amax)
        x = torch.randn(n, h, w, c, generator=g) * amax * 1.5
        ties = torch.arange(-130, 130.5, 0.5, dtype=torch.float64) * sx
        m = min(ties.numel(), x.numel())
        x.view(-1)[:m] = ties[:m].float()
        x = x.to(dtype)
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        nhwc = (flat[:x.numel()] if aligned else flat[1:]).view(n, h, w, c)
        xc = nhwc.copy_(x).permute(0, 3, 1, 2)
        assert xc.is_contiguous(memory_format=torch.channels_last)
        for channels in {c, conv_s8.padded_channels(c)}:
            if channels != c and c > 8:
                continue
            ref = quant.quantize_s8_plain(x.permute(0, 3, 1, 2), inv,
                                          channels)
            before = conv_s8.quantize_s8.launches
            out = conv_s8.quantize_s8(xc, inv, channels)
            torch.cuda.synchronize()
            assert conv_s8.quantize_s8.launches == before + 1
            assert out.dtype == torch.int8 and out.shape == ref.shape
            assert out.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_on_card_equals_cpu(cuda, dtype):
    """The activation quantize (a Python-float multiply, round half to
    even, clip) gives the CPU's int8 values on the card, ties included."""
    from unet_watermark_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(3)
    for amax in (1e-12, 0.37, 6.35, 1e4):
        sx = max(amax, quant.MIN_AMAX) / 127.0
        x = torch.randn(2, 7, 9, 11, generator=g) * amax
        ties = torch.arange(-130, 130.5, 0.5, dtype=torch.float64) * sx
        x.view(-1)[:ties.numel()] = ties.float()
        x = x.to(dtype)
        cpu, _ = quant.quantize_activation(x, amax)
        card, _ = quant.quantize_activation(x.to(cuda), amax)
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["fp32", "fp64"])
def test_gan_step_on_card_matches_cpu(cuda, no_tf32, dtype):
    """One G + D step of the full-width inpainting trainer from the same
    init on the card and on the CPU (2 x 64², the same images and masks),
    TF32 off. float32: the losses to rel 1e-4, the running statistics to
    1e-4, the stepped parameters to Adam's 2·lr (the float32 gradients
    carry rounding of up to ~14 % of a tensor's largest through BatchNorm
    at init: not held). float64 (the FFTs too; the feature matching casts
    to float32 as JAX's does): each gradient to 1e-6 of its tensor's
    largest (observed 5.3e-8), a floor of
    1e-12 for the biases before the discriminator's InstanceNorms, which
    get no gradient."""
    from unet_watermark_tpu_torch.training import train_inpaint as ti

    x = torch.from_numpy(np.random.default_rng(11).random(
        (2, 64, 64, 3))).to(dtype)
    masks = ti.random_mask_batch(torch.Generator().manual_seed(11), 2, 64,
                                 "cpu").to(dtype)
    got = []
    for dev in (cuda, torch.device("cpu")):
        tr = ti.build_trainer(seed=0, device=dev, compute_dtype=None)
        tr = ti.InpaintTrainer(tr.model.to(dtype), tr.disc.to(dtype),
                               compute_dtype=None)
        gl, fake, g = tr.g_loss_grads(x.to(dev), masks.to(dev), True)
        dl, dg = tr.d_loss_grads(x.to(dev), fake)
        # a copy: the optimizer clips the gradients in place
        grads = [t.detach().cpu().clone() for t in g + dg]
        tr.opt.step(g)
        tr.d_opt.step(dg)
        got.append((float(gl), float(dl), grads, tr.weights()))
    (gl, dl, g, w), (gl_c, dl_c, g_c, w_c) = got
    assert gl == pytest.approx(gl_c, rel=1e-4)
    assert dl == pytest.approx(dl_c, rel=1e-4)
    if dtype == torch.float64:
        for a, b in zip(g, g_c):
            assert (a - b).abs().max() <= 1e-6 * b.abs().max() + 1e-12
        return
    for k, v in w_c.items():
        tol = 1e-4 if k.startswith("batch_stats/") else 2 * 2e-4 + 1e-6
        assert np.abs(w[k] - v).max() <= tol, k


def test_ddim_sampler_fp32_on_card_matches_cpu(cuda, no_tf32, tmp_path):
    """The float32 latent-diffusion fill with flax-initialized weights
    (written as the shipped format; copies of the tree may lack the
    shipped file), 4 DDIM steps at 1 x 64² with the same noise, card
    against CPU: max abs 1e-3 (chip_smoke.py's 3i observed 2.5e-6 with
    trained weights); pixels outside the mask the input's on both."""
    from unet_watermark_tpu_torch.diffusion.latent_diffusion import (
        LatentInpainter, init_ld_modules, ld_weights)
    from unet_watermark_tpu_torch.utils.shipping import save_params_npz

    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.random((1, 64, 64, 3)).astype(np.float32))
    m = torch.zeros(1, 64, 64, 1)
    m[:, 12:40, 20:52] = 1
    g = torch.Generator().manual_seed(12)
    z = torch.randn(1, 8, 8, 4, generator=g)
    noise = torch.randn(4, 1, 8, 8, 4, generator=g)
    path = save_params_npz(tmp_path / "ld.npz",
                           ld_weights(*init_ld_modules(12)))
    outs = [LatentInpainter(path, device=dev, dtype=None).sample(
        x.to(dev), m.to(dev), z.to(dev), noise.to(dev)).cpu()
        for dev in (cuda, torch.device("cpu"))]
    assert (outs[0] - outs[1]).abs().max() <= 1e-3
    keep = (m == 0).expand_as(x)
    for out in outs:
        assert torch.equal(out[keep], x[keep])


def test_pil_ops_and_jpeg_encoder_on_card_equal_cpu(cuda):
    """gen_data's image ops and the JPEG encoder's pixel stage are integer
    ops: the card gives the CPU's bytes."""
    from unet_watermark_tpu_torch.ops import pil
    from unet_watermark_tpu_torch.utils import image_io

    rng = np.random.default_rng(11)
    img = torch.from_numpy(rng.integers(0, 256, (37, 53, 4),
                                        dtype=np.uint8))
    for fn in (lambda x: pil.rotate_expand(x, 33.3),
               lambda x: pil.resize_lanczos(x, (20, 71)),
               lambda x: pil.gaussian_blur(x, 1.23),
               lambda x: pil.composite_over(x, x.flip(0))):
        assert torch.equal(fn(img.to(cuda)).cpu(), fn(img))
    rgb = img[..., :3].contiguous()
    assert image_io.encode_jpeg(rgb.to(cuda)) == image_io.encode_jpeg(rgb)


def test_gen_data_on_card_equals_cpu(cuda, tmp_path):
    import os

    from unet_watermark_tpu_torch.data.gen_data import generate_dataset
    from unet_watermark_tpu_torch.utils import image_io
    from unet_watermark_tpu_torch.utils.synthetic import logo_images

    clean, logos = tmp_path / "c", tmp_path / "l"
    clean.mkdir()
    logos.mkdir()
    images, _ = watermarked_images(2, 96, seed=2, clean=2)
    for i in range(2):
        image_io.write_png(clean / f"c{i}.png",
                           (images[i] * 255).astype(np.uint8))
    for i, logo in enumerate(logo_images(2, 3)):
        image_io.write_png(logos / f"l{i}.png", logo)
    for dev in ("cuda", "cpu"):
        generate_dataset(str(clean), str(tmp_path / dev), str(logos),
                         count=8, seed=5, device=dev)
    for sub in ("watermarked", "clean", "masks"):
        names = sorted(os.listdir(tmp_path / "cpu" / sub))
        assert names == sorted(os.listdir(tmp_path / "cuda" / sub))
        for n in names:
            assert (tmp_path / "cpu" / sub / n).read_bytes() == \
                (tmp_path / "cuda" / sub / n).read_bytes()


ZOO_ARCHS = ["UnetTPU", "MAnet", "Linknet", "FPN", "PSPNet", "PAN",
             "DeepLabV3", "DeepLabV3Plus"]


@pytest.mark.parametrize("arch, encoder",
                         [(a, "resnet34") for a in ZOO_ARCHS]
                         + [("UnetPlusPlus", "resnet50"),
                            ("UnetPlusPlus", "efficientnet-b3")])
def test_zoo_logits_on_card_match_cpu(cuda, no_tf32, arch, encoder):
    """The seeded zoo models in float32 on the card against the CPU at
    2 x 64², TF32 off: within 1e-3 of the largest logit (at least 1)."""
    from unet_watermark_tpu_torch.models import SMPModelFactory, init_model

    model = init_model(SMPModelFactory.create_model(arch, encoder,
                                                    img_size=512), 3).eval()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert got.shape == want.shape == (2, 64, 64, 1)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-3 * scale
