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
