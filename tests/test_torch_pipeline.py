"""The port's fused detect→repair fn against the JAX package's
WatermarkPredictor.make_fused_repair_fn at 64², float32 networks: with
the push-pull fill, Unet in parity and auto mode and the default
configuration (UNet++, auto); and the default fn as it is, whose fill is
the bf16 FFC-LaMa generator with the shipped weights ("default-lama").
Under the default configuration, also the mask artifacts of step 1 (type
detection and the partitioned strategies) against the JAX steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_watermark_tpu.configs import get_cfg_defaults as jax_cfg_defaults
from unet_watermark_tpu.inference import maskproc as jmp
from unet_watermark_tpu.inference.predict import \
    WatermarkPredictor as JaxPredictor
from unet_watermark_tpu.models import create_model_from_config as jax_model
from unet_watermark_tpu.utils.shipping import load_params_npz
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
from unet_watermark_tpu_torch.utils.shipping import seg_weights_path
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

torch.set_num_threads(2)

# Repaired pixels: push-pull and 32 Jacobi sweeps in float32, summed in
# another order on each side; observed differences are ~1e-7.
REPAIR_ATOL = 1e-5
# The LaMa fill in bf16 on both sides (each rounds its convs' outputs to
# bf16 in its own order); on the 4827 hole pixels of this batch the
# observed max is 1.8e-3 and the mean 3.2e-4.
LAMA_HOLE_ATOL, LAMA_HOLE_MEAN = 5e-3, 1e-3


def _jax_predictor(arch, mask_mode):
    """The JAX predictor with the shipped weights. Its __init__ runs an
    eager init_model (~19 s on the CPU) only to get a template, so the
    object is assembled from the attributes make_fused_repair_fn reads.
    FUSED_DECODER is off: the fused fn captures the weights as constants,
    and XLA's constant folding of the fused up-conv kernels alone takes
    ~25 s; the plain decoder is the same function
    (tests/test_fused_decoder.py holds the two equal)."""
    cfg = jax_cfg_defaults()
    cfg.MODEL.NAME, cfg.MODEL.DTYPE = arch, "float32"
    cfg.MODEL.FUSED_DECODER = False
    cfg.DATA.IMG_SIZE = 64
    cfg.PREDICT.MASK_MODE = mask_mode
    path = seg_weights_path(arch, "resnet34")
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            parts = k.split("::", 1)[-1].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.zeros(z[k].shape, np.float32)
    pred = JaxPredictor.__new__(JaxPredictor)
    pred.cfg = cfg
    pred.model = jax_model(cfg)
    pred.variables = load_params_npz(str(path), tree)
    pred._quant_scales = None
    return pred


def _port_predictor(arch, mask_mode):
    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.MODEL.DTYPE = arch, "float32"
    cfg.PREDICT.MASK_MODE = mask_mode
    return WatermarkPredictor(cfg, device="cpu")


@pytest.fixture(scope="module")
def images():
    return watermarked_images(3, 64, seed=7)[0]


@pytest.fixture(scope="module", params=[
    pytest.param(("Unet", "parity", "pushpull"), id="parity"),
    pytest.param(("Unet", "auto", "pushpull"), id="auto"),
    pytest.param(("UnetPlusPlus", "auto", "pushpull"), id="default-config"),
    pytest.param(("UnetPlusPlus", "auto", "lama"), id="default-lama")])
def runs(request, images):
    arch, mode, engine = request.param
    with pytest.MonkeyPatch.context() as mp:  # the shipped LaMa weights
        mp.delenv("PREDICT_INPAINT_WEIGHTS", raising=False)
        jpred = _jax_predictor(arch, mode)
        jfused = jpred.make_fused_repair_fn(engine)
        pred = _port_predictor(arch, mode)
        # the LaMa case calls the port's fn as a user would: no argument
        fused = (pred.make_fused_repair_fn() if engine == "lama"
                 else pred.make_fused_repair_fn(engine))
    jrepaired = np.asarray(jfused(jnp.asarray(images)))
    # the JAX fused fn returns only the image: its mask, as it computes it
    x = (jnp.asarray(images) - jnp.asarray([0.485, 0.456, 0.406])) / \
        jnp.asarray([0.229, 0.224, 0.225])
    logits = jpred.model.apply(jpred.variables, x, train=False)
    raw = jax.nn.sigmoid(logits[..., 0]) > jpred.cfg.PREDICT.THRESHOLD
    chain = (jmp.optimize_watermark_mask if mode == "parity"
             else jmp.optimize_watermark_mask_tight)
    jmask = np.stack([np.asarray(chain(mk.astype(jnp.float32)))
                      for mk in raw])
    trepaired, tmask = fused(images)
    return {"mode": mode, "engine": engine, "pred": pred, "fused": fused,
            "jengine": jfused.engine_used,
            "jrepaired": jrepaired, "jraw": np.asarray(raw, np.float32),
            "jmask": jmask, "trepaired": trepaired.numpy(),
            "tmask": tmask.numpy()}


def test_masks_equal_jax(runs):
    assert runs["tmask"].shape == (3, 64, 64)
    assert runs["tmask"].sum() > 0
    np.testing.assert_array_equal(runs["tmask"], runs["jmask"])


def test_repaired_images_match_jax(runs, images):
    t, j = runs["trepaired"], runs["jrepaired"]
    assert t.shape == j.shape == images.shape
    assert np.isfinite(t).all() and t.min() >= 0.0 and t.max() <= 1.0
    keep = runs["tmask"][..., None] == 0
    hole = ~keep.repeat(3, -1)
    if runs["engine"] == "lama":
        err = np.abs(t - j)[hole]
        assert err.max() <= LAMA_HOLE_ATOL and err.mean() <= LAMA_HOLE_MEAN, \
            (err.max(), err.mean())
        np.testing.assert_array_equal(t[~hole], j[~hole])
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=REPAIR_ATOL)
    np.testing.assert_array_equal(np.where(keep, t, 0),
                                  np.where(keep, images, 0))
    assert (t != images)[hole].mean() > 0.5


def test_fused_fn_names_its_engine_and_mode(runs):
    assert runs["fused"].engine_used == runs["jengine"] == {
        "pushpull": "pushpull", "lama": "ffc-lama"}[runs["engine"]]
    assert runs["fused"].mask_mode == {"parity": "parity",
                                       "auto": "tight"}[runs["mode"]]


def test_artifact_masks_match_jax_step1(runs, images):
    """Step 1's order: raw masks → the type of each image from its 8-bit
    RGB values → one strategy per image, under the artifact surface's
    mask mode (auto → parity: the watermark strategy runs K1 and K2)."""
    pred = runs["pred"]
    tmasks, types = pred.predict_artifact_masks(images)
    raw = runs["jraw"]
    np.testing.assert_array_equal(pred.predict_masks(
        torch.from_numpy(images)).numpy(), raw)
    rgb = np.round(images * 255.0).astype(np.float32)
    jtypes = [jmp.classify_type(float(jmp.detect_watermark_type_scores(
        jnp.asarray(rgb[i]), jnp.asarray(raw[i])))) for i in range(len(raw))]
    assert types == jtypes
    jmasks = jmp.optimize_mask_batch_partitioned(
        raw, [jmp.type_code(t) for t in jtypes],
        mode=jmp.resolve_mask_mode(pred.cfg.PREDICT.MASK_MODE, "artifact"))
    assert tmasks.shape == raw.shape and tmasks.dtype == torch.float32
    np.testing.assert_array_equal(tmasks.numpy(), jmasks)


def test_lama_waits_for_its_slice_and_cuda_never_falls_back(images,
                                                            monkeypatch):
    """The engine names as the JAX fn takes them: "lama" builds the
    generator; any name outside {lama, big-lama, mat}, "telea" here, gives
    the push-pull fill, equal to the JAX fn's. Without a card, a predictor
    on "cuda" raises rather than running on the CPU."""
    monkeypatch.delenv("PREDICT_INPAINT_WEIGHTS", raising=False)
    pred = _port_predictor("Unet", "parity")
    assert pred.make_fused_repair_fn("lama").engine_used == "ffc-lama"
    fused = pred.make_fused_repair_fn("telea")
    jfused = _jax_predictor("Unet", "parity").make_fused_repair_fn("telea")
    assert fused.engine_used == jfused.engine_used == "pushpull"
    np.testing.assert_allclose(fused(images)[0].numpy(),
                               np.asarray(jfused(jnp.asarray(images))),
                               rtol=0, atol=REPAIR_ATOL)
    if not torch.cuda.is_available():
        cfg = get_cfg_defaults()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WatermarkPredictor(cfg)
