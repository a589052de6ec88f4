"""The port's int8 tier (ops/quant.py, the plain version of
ops/kernels/conv_s8.py, the split decoder convs of models/unet.py) against
the JAX package's (unet_watermark_tpu/ops/quant.py) on the CPU, on seeded
numpy inputs: the quantized weights, scales and activations bit for bit,
the int32 conv sums of every conv form exactly, the dequantized outputs bit
for bit, the observed amax, and the whole Unet and UNet++ under the shipped
sidecars within a stated tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from unet_watermark_tpu.models.factory import SegmentationModel as JaxModel
from unet_watermark_tpu.models.unet import fuse_up_kernel as jax_fuse_up
from unet_watermark_tpu.ops import quant as jq
from unet_watermark_tpu.utils.shipping import load_params_npz
from unet_watermark_tpu_torch.models import SegmentationModel
from unet_watermark_tpu_torch.models.convert import load_flax_weights
from unet_watermark_tpu_torch.ops import quant as tq
from unet_watermark_tpu_torch.ops.kernels import conv_s8
from unet_watermark_tpu_torch.utils.shipping import load_npz, seg_weights_path
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

torch.set_num_threads(2)

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp32": (jnp.float32, torch.float32)}
ARCHS = {"Unet": 50, "UnetPlusPlus": 68}


def _to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A float32 numpy array in `dtype`, rounded as JAX rounds it."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _jnp(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _weights(rng, shape_hwio):
    """HWIO weights with an all-zero output channel and ties: values that
    land on .5 steps of their channel's scale."""
    w = rng.normal(0, 0.05, shape_hwio).astype(np.float32)
    w[..., 0] = 0.0
    if shape_hwio[-1] > 2:  # channel 1: amax 127 * 2^-7, multiples of 2^-8
        w[..., 1] = rng.integers(-254, 255, w[..., 1].shape) / 256.0
        w[0, 0, 0, 1] = 127 / 128
    return w


@pytest.mark.parametrize("dt", list(DTYPES))
def test_quantize_weight_bit_equal(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(0)
    for shape in [(3, 3, 16, 8), (7, 7, 3, 4), (1, 1, 8, 6), (4, 4, 5, 3)]:
        w = _weights(rng, shape)
        jw, jsw = jq.quantize_weight(_jnp(w, jdt))
        tw, tsw = tq.quantize_weight(_to_torch(w, tdt).permute(3, 2, 0, 1))
        np.testing.assert_array_equal(np.asarray(jsw), tsw.numpy())
        np.testing.assert_array_equal(np.asarray(jw),
                                      tw.permute(2, 3, 1, 0).numpy())
        assert tsw[0] == np.float32(1e-12) and not tw[0].any()


@pytest.mark.parametrize("amax", [1e-12, 0.0, 0.37, 1.0, 6.35, 1e4])
def test_quantize_activation_bit_equal(amax):
    """Ties at .5 of a step round half to even in both; amax 1e-12 (a dead
    operand) gives 1 / sx ~ 1.3e14 without overflow or flush."""
    rng = np.random.default_rng(1)
    sx = max(amax, tq.MIN_AMAX) / 127.0
    x = rng.normal(0, max(amax, 1e-12), (2, 5, 6, 7)).astype(np.float32)
    steps = np.arange(-130, 131, 0.5, dtype=np.float64)
    x.flat[:steps.size] = (steps * sx).astype(np.float32)
    for jdt, tdt in DTYPES.values():
        jx, jsx = jq.quantize_activation(_jnp(x, jdt), amax)
        tx, tsx = tq.quantize_activation(_to_torch(x, tdt), amax)
        assert jsx == tsx
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


@pytest.mark.parametrize("dt", list(DTYPES))
def test_fuse_up_kernel_bit_equal(dt):
    jdt, tdt = DTYPES[dt]
    w3 = np.random.default_rng(2).normal(0, 0.1, (3, 3, 12, 9))
    j = jax_fuse_up(_jnp(w3, jdt))
    t = tq.fuse_up_kernel(_to_torch(w3, tdt).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)),
                                  t.float().permute(2, 3, 1, 0).numpy())


# (name, kernel, stride, padding, lhs dilation, cin, cout, input side): the
# conv forms of the two archs
FORMS = [("stem7x7s2", 7, 2, 3, 1, 3, 8, 18),
         ("3x3s1", 3, 1, 1, 1, 16, 8, 9),
         ("3x3s2", 3, 2, 1, 1, 16, 12, 10),
         ("1x1s2", 1, 2, 0, 1, 32, 8, 9),
         ("up4x4", 4, 1, 2, 2, 16, 8, 7)]


def _form_inputs(k, cin, cout, side, seed, fused_up):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, side, side, cin)).astype(np.float32)
    x[0, 0, 0, 0] = 5.0  # clipped at 127
    if fused_up:
        w = np.array(jax_fuse_up(jnp.asarray(_weights(rng, (3, 3, cin,
                                                                cout)))))
    else:
        w = _weights(rng, (k, k, cin, cout))
    return x, w


@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
def test_int32_sums_and_output_equal_jax(form):
    """conv_s8's plain version: the int32 sums equal XLA's s8 x s8 -> s32
    conv exactly, and the dequantized output equals conv2d_maybe_quant's
    bit for bit (bf16 and fp32)."""
    name, k, stride, pad, dil, cin, cout, side = form
    x, w = _form_inputs(k, cin, cout, side, 3, name == "up4x4")
    amax = 2.5
    padding = [(pad, pad), (pad, pad)]
    ld = (dil, dil) if dil > 1 else None
    for jdt, tdt in DTYPES.values():
        jx, jw = _jnp(x, jdt), _jnp(w, jdt)
        xq, _ = jq.quantize_activation(jx, amax)
        wq, _ = jq.quantize_weight(jw)
        jsum = lax.conv_general_dilated(
            xq, wq, (stride, stride), padding, lhs_dilation=ld,
            dimension_numbers=jq._DN, preferred_element_type=jnp.int32)
        tx = _to_torch(x, tdt).permute(0, 3, 1, 2)
        tw = _to_torch(w, tdt).permute(3, 2, 0, 1)
        txq, _ = tq.quantize_activation(tx, amax)
        twq, _ = tq.quantize_weight(tw)
        tsum = tq.conv_sums_plain(txq, twq, stride, pad, dil)
        assert tsum.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(jsum),
                                      tsum.permute(0, 2, 3, 1).numpy())
        with jq.quant_int8({"c": amax}):
            jy = jq.conv2d_maybe_quant(jx, jw, strides=(stride, stride),
                                       padding=padding, lhs_dilation=ld,
                                       path="c")
        with tq.quant_int8({"c": amax}) as mode:
            ty = tq.conv2d_maybe_quant(tx, tw, stride=stride, padding=pad,
                                       dilation=dil, path="c")
        assert not mode.missing and ty.dtype == tdt
        np.testing.assert_array_equal(
            np.asarray(jy.astype(jnp.float32)),
            ty.float().permute(0, 2, 3, 1).numpy())
        # the wrapper's CPU route is the plain version, with the prebuilt
        # plan as predict.py makes it
        plan = tq.make_plan(tw, amax)
        assert plan.packed is None
        y2 = conv_s8.conv_s8(tq._quantize(tx, plan.inv_sx), plan.wq,
                             plan.scale, stride=stride, padding=pad,
                             dilation=dil, out_dtype=tdt)
        assert torch.equal(y2, ty)


def test_up_conv_equals_conv_of_the_upsampled_input():
    """The lhs-dilated conv with the fused kernel is conv3x3(up2x(x)) (the
    identity SplitUpConcatConv rests on), exactly on integer values."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-3, 4, (1, 5, 6, 7)).astype(np.float64))
    w3 = torch.from_numpy(rng.integers(-3, 4, (4, 5, 3, 3)).astype(np.float64))
    up = torch.nn.functional.interpolate(x, scale_factor=2, mode="nearest")
    ref = torch.nn.functional.conv2d(up, w3, padding=1)
    got = torch.nn.functional.conv2d(tq.dilate2(x), tq.fuse_up_kernel(w3),
                                     padding=2)
    assert torch.equal(got, ref)


def test_missing_scale_runs_the_float_conv():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (1, 4, 6, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (3, 4, 3, 3)).astype(np.float32))
    with tq.quant_int8({"other": 1.0}) as mode:
        y = tq.conv2d_maybe_quant(x, w, path="c")
    assert mode.missing == {"c"}
    assert torch.equal(y, torch.nn.functional.conv2d(x, w, padding=1))


def test_observe_records_jax_amax():
    rng = np.random.default_rng(6)
    x = rng.normal(0, 2, (2, 8, 8, 4)).astype(np.float32)
    w = rng.normal(0, 1, (3, 3, 4, 5)).astype(np.float32)
    zero = np.zeros_like(x)
    for q in (1.0, 0.9):
        js, ts = {}, {}
        with jq.quant_observe(js, q):
            for a, p in ((x, "a"), (x * 0.5, "a"), (zero, "dead")):
                jq.conv2d_maybe_quant(jnp.asarray(a), jnp.asarray(w), path=p)
        with tq.quant_observe(ts, q):
            for a, p in ((x, "a"), (x * 0.5, "a"), (zero, "dead")):
                tq.conv2d_maybe_quant(
                    torch.from_numpy(a).permute(0, 3, 1, 2),
                    torch.from_numpy(w).permute(3, 2, 0, 1), path=p)
        assert ts["dead"] == js["dead"] == tq.MIN_AMAX
        if q == 1.0:
            assert ts == js
        else:  # quantile interpolation in float32 on both sides
            assert ts["a"] == pytest.approx(js["a"], rel=1e-6)


def test_sidecar_roundtrip(tmp_path):
    path = str(tmp_path / "w.quant.json")
    tq.save_scales(path, {"b": 2.0, "a": 1.0}, meta={"weights_sha256": "ab"})
    assert tq.load_scales(path) == jq.load_scales(path) == {"a": 1.0,
                                                            "b": 2.0}
    assert tq.load_sidecar_meta(path) == {"weights_sha256": "ab"}
    assert tq.quant_sidecar_path("/x/seg_unet.npz") == "/x/seg_unet.quant.json"


def _jax_variables(path):
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            parts = k.split("::", 1)[-1].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.zeros(z[k].shape, np.float32)
    return load_params_npz(str(path), tree)


# Whole-model logits, int8 tier, with the shipped weights and sidecar at
# 64², in float32 and in bf16, against the JAX model run two ways:
#  * op by op (model.apply outside jit, each op as the JAX code writes it):
#    every conv's int8 input, int32 sums and output then agree (the tests
#    above), and the logits differ only by the float BN/ReLU/add order:
#    measured ~1e-5 in float32 (logits ~10-20) and one bf16 ulp (0.125)
#    in bf16;
#  * under jax.jit, as the JAX predictor runs it: XLA fuses BN, ReLU and
#    the quantize and rounds them otherwise, so activations one ulp apart
#    that sit at a rounding boundary of x / sx take the next int8 step, and
#    those flips compound through 50 (68) quantized convs. JAX's own jitted
#    and op-by-op logits differ by ~0.9 (mean ~0.09); the port is held to
#    the jitted ones with that gap's bounds, and its masks (logit > 0) must
#    agree on all but a sliver of pixels.
EAGER_TOL = {"fp32": (1e-4, 1e-5), "bf16": (0.5, 0.05)}  # (max, mean)
JIT_TOL = (1.5, 0.15)


@pytest.fixture(scope="module", params=list(ARCHS))
def int8_logits(request):
    arch = request.param
    path = seg_weights_path(arch, "resnet34")
    scales = tq.load_scales(tq.quant_sidecar_path(str(path)))
    images, _ = watermarked_images(2, 64, seed=3)
    x = ((images - 0.45) / 0.225).astype(np.float32)
    v = _jax_variables(path)
    out = {"n_scales": len(scales)}
    for dt, (jdt, tdt) in DTYPES.items():
        jmodel = JaxModel(arch=arch, encoder_name="resnet34", dtype=jdt,
                          fused=True)
        with jq.quant_int8(scales) as jmode:
            eager = jmodel.apply(v, jnp.asarray(x), train=False)
            jitted = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
                v, jnp.asarray(x))
        model = SegmentationModel(arch, "resnet34")
        load_flax_weights(model, load_npz(path))
        model = model.eval().to(tdt)
        with torch.no_grad(), tq.quant_int8(
                scales, tq.build_plans(model, scales)) as tmode:
            tl = model(torch.from_numpy(x))
        with torch.no_grad():
            plain = model(torch.from_numpy(x))
        out[dt] = {"eager": np.asarray(eager), "jit": np.asarray(jitted),
                   "port": tl.numpy(), "plain": plain.numpy(),
                   "missing": jmode.missing | tmode.missing}
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
def test_whole_model_int8_logits_match_jax(int8_logits, dt):
    r = int8_logits[dt]
    assert not r["missing"]
    port = r["port"]
    assert port.shape == r["eager"].shape == (2, 64, 64, 1)
    err = np.abs(port - r["eager"])
    assert err.max() < EAGER_TOL[dt][0] and err.mean() < EAGER_TOL[dt][1]
    err = np.abs(port - r["jit"])
    assert err.max() < JIT_TOL[0] and err.mean() < JIT_TOL[1]
    assert np.mean((port > 0) == (r["jit"] > 0)) > 0.99
    assert np.mean((port > 0) == (r["eager"] > 0)) > 0.999
    # the int8 tier is not the float tier: it moved the logits
    assert np.abs(port - r["plain"]).max() > 1e-3


def test_sidecars_cover_every_conv(int8_logits):
    assert int8_logits["n_scales"] in ARCHS.values()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_plans_and_paths(arch):
    """build_plans makes one plan per sidecar entry (50 Unet, 68 UNet++)
    from the converter's flax paths; outside a quant context the model is
    the float model it was."""
    path = seg_weights_path(arch, "resnet34")
    scales = tq.load_scales(tq.quant_sidecar_path(str(path)))
    model = SegmentationModel(arch, "resnet34")
    load_flax_weights(model, load_npz(path))
    plans = tq.build_plans(model, scales)
    assert set(plans) == set(scales) and len(plans) == ARCHS[arch]
    assert all(p.wq.dtype == torch.int8 and p.scale.dtype == torch.float32
               for p in plans.values())
    up = [k for k in plans if k.endswith(":up")]
    assert all(plans[k].wq.shape[2:] == (4, 4) for k in up)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_predictor_quant_tier(arch, monkeypatch, caplog):
    """PREDICT.QUANT: the predictor loads the sidecar (50 / 68 scales),
    predict_masks runs every calibrated conv through conv_s8 (counted by a
    hook on the wrapper), and its masks agree with the bf16 tier's on the
    procedural logo images as the JAX package's test_predictor_quant_tier
    measures it. Without a sidecar it warns and stays in the model
    dtype."""
    from unet_watermark_tpu_torch.configs import get_cfg_defaults
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor

    def cfg(q):
        c = get_cfg_defaults()
        c.MODEL.NAME = arch
        c.DATA.IMG_SIZE = 64
        c.PREDICT.QUANT = q
        return c

    base = WatermarkPredictor(cfg(False), device="cpu")
    quantp = WatermarkPredictor(cfg(True), device="cpu")
    assert base._quant_scales is None
    assert len(quantp._quant_scales) == ARCHS[arch]
    assert len(quantp._quant_plans) == ARCHS[arch]
    calls = []
    real = conv_s8.conv_s8

    def counting(*args, **kwargs):
        calls.append(kwargs["dilation"])
        return real(*args, **kwargs)

    monkeypatch.setattr(conv_s8, "conv_s8", counting)
    images, _ = watermarked_images(4, 64, seed=11)
    x = torch.from_numpy(images)
    pb = base._forward_probs(x)
    assert not calls
    pq = quantp._forward_probs(x)
    assert len(calls) == ARCHS[arch]
    assert calls.count(2) == (5 if arch == "Unet" else 11)  # the :up convs
    assert torch.equal(quantp.predict_masks(x), (pq > 0.5).float())
    assert float((pb - pq).abs().mean()) < 0.03
    assert float(((pb > 0.5) == (pq > 0.5)).float().mean()) > 0.97
    # no sidecar next to the weights: the model dtype, with a warning
    monkeypatch.setattr(tq, "quant_sidecar_path",
                        lambda p: p + ".missing.quant.json")
    with caplog.at_level("WARNING"):
        plain = WatermarkPredictor(cfg(True), device="cpu")
    assert plain._quant_scales is None and "staying" in caplog.text


# -- the int8 kernels' layouts (ops/kernels/conv_s8.py), held on the CPU ----
def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("h,w", [(5, 7), (6, 6), (7, 4)])
@pytest.mark.parametrize("cin", [3, 16, 32, 48])
@pytest.mark.parametrize("cout", [8, 16, 40])
def test_up_conv_phases_equal_the_dilated_conv_and_jax(h, w, cin, cout):
    """The lhs-dilated 4x4 up-conv (padding 2) as its four 2x2 output
    phases (quant.phase_kernels, conv_sums_phases_plain) gives the int32
    sums of the zero-interleaved conv and of XLA's s8 x s8 -> s32 conv with
    lhs_dilation (2, 2), exactly."""
    rng = np.random.default_rng(h * 100 + w * 10 + cin + cout)
    xq, wq = _int8(rng, (2, cin, h, w)), _int8(rng, (cout, cin, 4, 4))
    phases = tq.conv_sums_phases_plain(xq, wq)
    assert phases.dtype == torch.int32 and phases.shape == (2, cout, 2 * h,
                                                            2 * w)
    assert torch.equal(phases, tq.conv_sums_plain(xq, wq, 1, 2, 2))
    jsum = lax.conv_general_dilated(
        jnp.asarray(xq.permute(0, 2, 3, 1).numpy()),
        jnp.asarray(wq.permute(2, 3, 1, 0).numpy()), (1, 1),
        [(2, 2), (2, 2)], lhs_dilation=(2, 2), dimension_numbers=jq._DN,
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(np.asarray(jsum),
                                  phases.permute(0, 2, 3, 1).numpy())


# (kernel, stride, padding, lhs dilation, cin, cout): the packed forms
PACK_FORMS = [(7, 2, 3, 1, 3, 64), (3, 1, 1, 1, 16, 16), (3, 2, 1, 1, 64, 40),
              (1, 2, 0, 1, 64, 128), (3, 1, 1, 1, 160, 32),
              (4, 1, 2, 2, 32, 16), (4, 1, 2, 2, 48, 40), (3, 1, 1, 1, 96, 8),
              (3, 1, 1, 1, 64, 32), (3, 1, 1, 1, 192, 64),
              (3, 1, 1, 1, 32, 32), (3, 1, 1, 1, 48, 64),
              (4, 1, 2, 2, 64, 32), (4, 1, 2, 2, 48, 24)]
# each form packed densely, and for the halo mode where it takes the form
PACK_CASES = [(f, taps) for f in PACK_FORMS for taps in (False, True)
              if not taps or conv_s8.tma_form(f[0], f[0], *f[1:4])]
PACK_IDS = ["-".join(map(str, f)) + ("-taps" if taps else "")
            for f, taps in PACK_CASES]


def _unswizzle(packed: torch.Tensor) -> torch.Tensor:
    """The packing's rows (of b bytes) with their 16-byte pieces back in K
    order: piece j of row r was stored at piece j ^ ((r * b >> 7) % (b /
    16)), the swizzle of b-byte rows."""
    cout_pad, b = packed.shape[-2:]
    r, pieces = torch.arange(cout_pad), b // 16
    idx = (torch.arange(pieces)[None, :] ^ ((r[:, None] * b >> 7) % pieces))
    t = packed.reshape(-1, cout_pad, pieces, 16)
    return torch.gather(t, 2, idx.view(cout_pad, pieces, 1).expand(
        t.shape)).reshape(packed.shape)


def _phase_gemm_b(packed, taps, cout, channels, th, tw):
    """(phases, cout, channels, th, tw) from a packed weight."""
    b = _unswizzle(packed)
    if taps:  # [P][chunks][th][tw][cout_pad][chunk]
        p, chunks, row = b.shape[0], b.shape[1], b.shape[-1]
        w = b.permute(0, 4, 1, 5, 2, 3).reshape(p, -1, chunks * row, th, tw)
        return w[:, :cout, :channels]
    p, steps, cout_pad, _ = b.shape  # [P][steps][cout_pad][128]
    rows = b.permute(0, 2, 1, 3).reshape(p, cout_pad, steps * 128)
    k = th * tw * channels
    return rows[:, :cout, :k].reshape(p, cout, th, tw, channels).permute(
        0, 1, 4, 2, 3)


@pytest.mark.parametrize("form,taps", PACK_CASES, ids=PACK_IDS)
def test_packed_weight_round_trips_to_oihw(form, taps):
    """pack_weight's layouts (the dense [phases][K / 128][Cout_pad][128]
    and the TMA modes' [phases][chunks][kh][kw][Cout_pad][chunk], rows in
    the swizzle of their width) give back the OIHW weight: the phases
    interleave into the 4x4 kernel, the stem's padded channels and every
    padding byte are zero."""
    k, stride, pad, dil, cin, cout = form
    wq = _int8(np.random.default_rng(sum(form)), (cout, cin, k, k))
    channels = conv_s8.padded_channels(cin)
    packed = conv_s8.pack_weight(wq, dil, channels, taps=taps)
    th, tw = (2, 2) if dil == 2 else (k, k)
    kernels = _phase_gemm_b(packed, taps, cout, channels, th, tw)
    assert not kernels[:, :, cin:].any()
    if dil == 2:
        back = torch.zeros_like(wq)
        for z, ph in enumerate(kernels[:, :, :cin]):
            back[:, :, z // 2::2, z % 2::2] = ph
    else:
        back = kernels[0, :, :cin]
    assert torch.equal(back, wq)
    # every tap once (the phases split the 16), zeros elsewhere
    assert int(packed.abs().sum()) == int(wq.abs().sum())


def _gemm_model(xq, wq, stride, pad, dil, taps):
    """The int32 sums as the kernel forms them: each phase's GEMM of the
    im2col rows (the kernel's A) in its K order against the unswizzled
    packed B, the outputs written to the phase's places."""
    n, cin, h, w = xq.shape
    cout, _, k, _ = wq.shape
    packed = conv_s8.pack_weight(wq, dil, cin, taps=taps)
    if dil == 2:
        th = tw = 2
        geo = [(1 - a, 1 - b, a, b) for a in (0, 1) for b in (0, 1)]
        mh, mw, ho, wo, step = h, w, 2 * h, 2 * w, 2
    else:
        th = tw = k
        geo = [(pad, pad, 0, 0)]
        mh = ho = (h + 2 * pad - k) // stride + 1
        mw = wo = (w + 2 * pad - k) // stride + 1
        step = 1
    kern = _phase_gemm_b(packed, taps, cout, cin, th, tw).long()
    x = xq.long().permute(0, 2, 3, 1)
    out = torch.zeros((n, ho, wo, cout), dtype=torch.long)
    oy, ox = torch.meshgrid(torch.arange(mh), torch.arange(mw),
                            indexing="ij")
    for z, (py, px, ya, xa) in enumerate(geo):
        acc = torch.zeros((n, mh, mw, cout), dtype=torch.long)
        for ty in range(th):
            for tx in range(tw):
                iy, ix = oy * stride - py + ty, ox * stride - px + tx
                ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                a = x[:, iy.clamp(0, h - 1), ix.clamp(0, w - 1)] * \
                    ok[None, ..., None]
                acc += a @ kern[z, :, :, ty, tx].T
        out[:, ya::step, xa::step] = acc
    return out.permute(0, 3, 1, 2).to(torch.int32)


@pytest.mark.parametrize("form,taps", PACK_CASES, ids=PACK_IDS)
def test_packed_gemm_equals_the_conv(form, taps):
    """The packed operand in the kernel's K order, against the im2col rows
    of each phase, gives conv_sums_plain's sums exactly (the stem with its
    activation padded to 16 channels of random bytes: they meet zero
    weights)."""
    k, stride, pad, dil, cin, cout = form
    rng = np.random.default_rng(sum(form) + 7)
    xq = _int8(rng, (2, conv_s8.padded_channels(cin), 9, 7))
    wq = _int8(rng, (cout, cin, k, k))
    ref = tq.conv_sums_plain(xq, wq, stride, pad, dil)
    assert torch.equal(ref, tq.conv_sums_plain(xq[:, :cin], wq, stride, pad,
                                               dil))
    assert torch.equal(_gemm_model(xq, wq, stride, pad, dil, taps), ref)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("channels", [None, 16])
def test_quantize_s8_cpu_route_equals_quantize(dt, channels):
    """quantize_s8 on a CPU tensor is _quantize (the torch chain), with
    zero channels appended up to `channels` (the stem's operand)."""
    rng = np.random.default_rng(12)
    x = _to_torch(rng.normal(0, 3, (2, 3, 5, 6)), DTYPES[dt][1])
    _, inv = tq.activation_scale(2.5)
    before = conv_s8.quantize_s8.launches
    got = conv_s8.quantize_s8(x, inv, channels)
    assert conv_s8.quantize_s8.launches == before  # no kernel on the CPU
    assert got.dtype == torch.int8
    assert torch.equal(got[:, :3], tq._quantize(x, inv))
    assert got.shape[1] == (channels or 3) and not got[:, 3:].any()
    with pytest.raises(ValueError, match="output channels"):
        conv_s8.quantize_s8(x, inv, 8)


@pytest.mark.parametrize("form,grid,tile_m,mode", [
    ((3, 1, 1, 1), (256, 256), 128, "halo"),
    ((3, 1, 1, 1), (64, 64), 64, "halo"),
    ((3, 1, 1, 1), (32, 32), 64, "taps"),
    ((3, 1, 1, 1), (16, 16), 128, "taps"),
    ((3, 1, 1, 1), (19, 19), 64, "gather"),
    ((3, 1, 1, 1), (6, 32), 128, "gather"),  # a tile would span images
    ((4, 1, 2, 2), (128, 128), 128, "halo"),
    ((4, 1, 2, 2), (16, 16), 64, "taps"),
    ((3, 2, 1, 1), (64, 64), 64, "gather"),
    ((1, 2, 0, 1), (64, 64), 64, "gather"),
    ((7, 2, 3, 1), (256, 256), 128, "gather")])
def test_conv_mode(form, grid, tile_m, mode):
    """How the kernel loads A: a TMA box a row where a tile lies in one
    output row, a box a tap where a tile is whole rows of one image, the
    cp.async gather otherwise (stride 2, the stem, ragged rows)."""
    k, stride, pad, dil = form
    assert conv_s8.conv_mode(k, k, stride, pad, dil, *grid, tile_m) == mode


@pytest.mark.parametrize("arch", list(ARCHS))
def test_plan_forms_are_the_forward_convs(arch, monkeypatch):
    """quant_weights gives build_plans each conv's (stride, padding, lhs
    dilation) as the forward runs it, so that make_plan packs the TMA
    modes' weight only where conv_s8.tma_form takes the conv."""
    model = SegmentationModel(arch, "resnet34")
    load_flax_weights(model, load_npz(seg_weights_path(arch, "resnet34")))
    forms = {p: f for m in model.modules()
             if isinstance(m, tq.QConv2d) and m.quant_path
             for p, _, f in m.quant_weights()}
    seen, real = {}, tq.conv2d_maybe_quant

    def record(x, w, *, stride=1, padding=1, dilation=1, path=""):
        seen[path] = (stride, padding, dilation)
        return real(x, w, stride=stride, padding=padding, dilation=dilation,
                    path=path)

    monkeypatch.setattr(tq, "conv2d_maybe_quant", record)
    with tq.quant_observe({}), torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    assert len(seen) == ARCHS[arch] and seen == forms
    tma = {p for p, f in forms.items()
           if conv_s8.tma_form(*((4, 4) if f[2] == 2 else (3, 3)), *f)}
    assert all(f[0] == 1 for p, f in forms.items() if p in tma)
    assert any(f[0] == 2 for f in forms.values())


@pytest.mark.parametrize("conv,want", [
    # (n, h, w, cout, k, stride, padding, dilation): (tile_m, mode)
    ((8, 128, 128, 64, 3, 1, 1, 1), (128, "halo")),
    ((8, 16, 16, 512, 3, 1, 1, 1), (64, "taps")),
    ((8, 32, 32, 256, 3, 1, 1, 1), (64, "taps")),
    ((8, 64, 64, 128, 3, 1, 1, 1), (64, "taps")),
    ((8, 256, 256, 16, 4, 1, 2, 2), (128, "halo")),
    ((8, 512, 512, 64, 7, 2, 3, 1), (128, "gather")),
    ((8, 64, 64, 128, 3, 2, 1, 1), (64, "gather")),
    ((1, 19, 19, 16, 3, 1, 1, 1), (64, "gather"))])
def test_launch_config(conv, want):
    """The wrapper's own tile and A mode on shapes of the 8 x 512² forward
    (132 SMs); forcing gather takes every conv, forcing a TMA mode that
    does not take the conv raises."""
    n, h, w, cout, k, stride, pad, dil = conv
    form = (n, h, w, cout, k, k, stride, pad, dil, 132)
    assert conv_s8.launch_config(*form) == want
    assert conv_s8.launch_config(*form, mode="gather")[1] == "gather"
    for mode in ("halo", "taps"):
        if mode != want[1]:
            with pytest.raises(ValueError, match=f"the {mode} mode"):
                conv_s8.launch_config(*form, mode=mode)
    with pytest.raises(ValueError, match="tile_m"):
        conv_s8.launch_config(*form, tile_m=32)
