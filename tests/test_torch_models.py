"""The port's Unet/resnet34 and UNet++/resnet34 against the JAX
SegmentationModel (fused decoder, the default) with the shipped weights,
both in float32 at 64²."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_watermark_tpu.models.encoders import get_encoder
from unet_watermark_tpu.models.factory import SegmentationModel as JaxModel
from unet_watermark_tpu.utils.shipping import load_params_npz
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.models import (SegmentationModel,
                                             create_model_from_config)
from unet_watermark_tpu_torch.models.convert import load_flax_weights
from unet_watermark_tpu_torch.models.unet import (SMPUnetPlusPlusDecoder,
                                                   UnetPlusPlusDecoder)
from unet_watermark_tpu_torch.utils.shipping import load_npz, seg_weights_path
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

torch.set_num_threads(2)

ARCHS = ["Unet", "UnetPlusPlus"]
# Logits: both sides are float32 on the CPU but sum the convolutions in
# other orders, and the JAX decoder's fused up-conv reassociates the first
# conv of each block; logits of magnitude ~10 agree to ~1e-4.
LOGIT_ATOL = 1e-3


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


@pytest.fixture(scope="module", params=ARCHS)
def outputs(request):
    """One JAX and one port forward of one arch on the same inputs; the
    weights are arguments of the jitted JAX fn, not captured constants."""
    arch = request.param
    path = seg_weights_path(arch, "resnet34")
    images, _ = watermarked_images(2, 64, seed=3)
    noise = np.random.default_rng(5).normal(0, 1, (1, 64, 64, 3))
    x = np.concatenate([(images - 0.45) / 0.225, noise]).astype(np.float32)
    v = _jax_variables(path)
    jmodel = JaxModel(arch=arch, encoder_name="resnet34",
                      dtype=jnp.float32, fused=True)
    jlogits = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        v, jnp.asarray(x))
    enc = get_encoder("resnet34", dtype=jnp.float32)
    jfeats = jax.jit(lambda v, x: enc.apply(v, x, train=False))(
        {"params": v["params"]["encoder"],
         "batch_stats": v["batch_stats"]["encoder"]}, jnp.asarray(x))
    model = SegmentationModel(arch, "resnet34")
    load_flax_weights(model, load_npz(path))
    model.eval()
    with torch.no_grad():
        t = torch.from_numpy(x)
        tfeats = model.encoder(t.permute(0, 3, 1, 2))
        tlogits = model(t)
    return {"jlogits": np.asarray(jlogits), "tlogits": tlogits.numpy(),
            "jfeats": [np.asarray(f) for f in jfeats],
            "tfeats": [f.permute(0, 2, 3, 1).numpy() for f in tfeats]}


def test_encoder_features_match(outputs):
    shapes = [(3, 64, 64, 3), (3, 32, 32, 64), (3, 16, 16, 64),
              (3, 8, 8, 128), (3, 4, 4, 256), (3, 2, 2, 512)]
    for i, (t, j) in enumerate(zip(outputs["tfeats"], outputs["jfeats"])):
        assert t.shape == j.shape == shapes[i]
        scale = max(1.0, float(np.abs(j).max()))
        # fp32 conv sums in another order, through up to 33 convs
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-5 * scale,
                                   err_msg=f"stage {i}")


def test_logits_match(outputs):
    t, j = outputs["tlogits"], outputs["jlogits"]
    assert t.shape == j.shape == (3, 64, 64, 1) and t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=0, atol=LOGIT_ATOL)


def test_thresholded_masks_agree(outputs):
    t = outputs["tlogits"] > 0.0  # sigmoid(l) > 0.5
    j = outputs["jlogits"] > 0.0
    assert t.mean() > 0.01  # the logos are detected at all
    assert (t == j).mean() >= 0.999


def test_create_model_from_config_and_errors():
    cfg = get_cfg_defaults()
    model = create_model_from_config(cfg)  # the default arch: UnetPlusPlus
    assert isinstance(model.decoder, UnetPlusPlusDecoder)
    widths = {name: mod[0].weight.shape[1]
              for name, mod in model.decoder.named_children()
              if name.endswith("conv1")}
    assert (widths["x_0_1_conv1"], widths["x_0_4_conv1"],
            widths["x_3_1_conv1"]) == (128, 224, 768)
    assert len(widths) == 10
    cfg.MODEL.NAME, cfg.MODEL.DECODER_IMPL = "UnetPlusPlus", "smp"
    smp = create_model_from_config(cfg).decoder
    assert isinstance(smp, SMPUnetPlusPlusDecoder)
    assert sorted(smp.blocks) == sorted(
        [f"x_{d}_{d + l}" for l in range(4) for d in range(4 - l)]
        + ["x_0_4"])
    cfg.MODEL.NAME, cfg.MODEL.DECODER_IMPL = "FPN", "canonical"
    from unet_watermark_tpu_torch.models.archs import FPNDecoder
    assert isinstance(create_model_from_config(cfg).decoder, FPNDecoder)
    from unet_watermark_tpu.configs import get_cfg_defaults as jcfg
    from unet_watermark_tpu.models.factory import \
        create_model_from_config as jcreate
    for field, name, match in (("NAME", "SegFormer", "unsupported model"),
                               ("ENCODER_NAME", "vgg16",
                                "unsupported encoder")):
        errors = []
        for make, create in ((get_cfg_defaults, create_model_from_config),
                             (jcfg, jcreate)):
            c = make()
            setattr(c.MODEL, field, name)
            with pytest.raises(ValueError, match=match) as err:
                create(c)
            errors.append(str(err.value))
        assert errors[0] == errors[1]
    cfg.MODEL.NAME, cfg.MODEL.DECODER_IMPL = "unet++", "canonical"
    assert isinstance(create_model_from_config(cfg).decoder,
                      UnetPlusPlusDecoder)
    cfg.MODEL.NAME = "Unet"
    model = create_model_from_config(cfg)
    assert [b.conv1[0].weight.shape[1] for b in model.decoder.blocks] == \
        [768, 384, 192, 128, 32]
    with pytest.raises(ValueError, match="multiples of 32"):
        model(torch.zeros(1, 48, 48, 3))
    with pytest.raises(ValueError, match="NHWC"):
        model(torch.zeros(1, 3, 64, 64))


# ---------------------------------------------------------------------------
# the head: MODEL.CLASSES and MODEL.ACTIVATION (ROADMAP.md §C.11)
# ---------------------------------------------------------------------------
# small models with fresh weights (the port's init, carried to JAX through
# convert.to_flax): resnet18 and narrow decoders, at 64², float32. The
# outputs are logits or their sigmoid/softmax, held within LOGIT_ATOL.
HEAD_DECODER = (32, 16, 16, 8, 8)


def _tree(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parts, leaf = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.fixture(scope="module")
def head_inputs():
    images, _ = watermarked_images(2, 64, seed=8)
    return ((images - 0.45) / 0.225).astype(np.float32)


@pytest.mark.parametrize("activation", [None, "sigmoid", "softmax"])
@pytest.mark.parametrize("classes", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_head_classes_and_activation_match_jax(arch, classes, activation,
                                               head_inputs):
    from unet_watermark_tpu_torch.models.convert import to_flax
    from unet_watermark_tpu_torch.models.factory import init_model

    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME = arch, "resnet18"
    cfg.MODEL.DECODER_CHANNELS = list(HEAD_DECODER)
    cfg.MODEL.CLASSES, cfg.MODEL.ACTIVATION = classes, activation
    model = init_model(create_model_from_config(cfg), seed=classes).eval()
    # a bias per class, so the classes differ
    with torch.no_grad():
        model.segmentation_head[0].bias.copy_(torch.linspace(-1, 1, classes))
    jmodel = JaxModel(arch=arch, encoder_name="resnet18",
                      decoder_channels=HEAD_DECODER, classes=classes,
                      activation=activation, dtype=jnp.float32, fused=True)
    want = np.asarray(jmodel.apply(_tree(to_flax(model)),
                                   jnp.asarray(head_inputs), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(head_inputs)).numpy()
    assert got.shape == want.shape == (2, 64, 64, classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    if activation == "softmax":
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    if activation is not None:
        assert got.min() >= 0.0 and got.max() <= 1.0


def test_head_refusals_match_jax():
    from unet_watermark_tpu.configs import get_cfg_defaults as jcfg
    from unet_watermark_tpu.models.factory import \
        create_model_from_config as jcreate

    for make in (get_cfg_defaults, jcfg):
        cfg = make()
        cfg.MODEL.IN_CHANNELS = 4
        create = create_model_from_config if make is get_cfg_defaults \
            else jcreate
        with pytest.raises(NotImplementedError, match="in_channels"):
            create(cfg)
    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME = "Unet", "resnet18"
    cfg.MODEL.ACTIVATION = "tanh"
    model = create_model_from_config(cfg).eval()
    jmodel = JaxModel(arch="Unet", encoder_name="resnet18", activation="tanh",
                      dtype=jnp.float32)
    x = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises(ValueError, match="unsupported activation tanh"):
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="unsupported activation tanh"), \
            torch.no_grad():
        model(torch.from_numpy(x))


def test_two_class_head_through_converter_and_export(tmp_path):
    """A 2-class head goes to flat flax weights and back, through the
    shipped-format .npz that training exports, and into a 2-class model;
    a 1-class model refuses it."""
    from unet_watermark_tpu.utils.shipping import load_params_npz
    from unet_watermark_tpu_torch.models.convert import to_flax
    from unet_watermark_tpu_torch.models.factory import init_model
    from unet_watermark_tpu_torch.training.train import export_npz

    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME = "Unet", "resnet18"
    cfg.MODEL.CLASSES, cfg.MODEL.ACTIVATION = 2, "softmax"
    cfg.TRAIN.MODEL_SAVE_PATH = str(tmp_path / "m.pth")
    model = init_model(create_model_from_config(cfg), seed=4).eval()
    flat = to_flax(model)
    assert flat["params/segmentation_head/conv/kernel"].shape == (3, 3, 16,
                                                                  2)
    path = export_npz(cfg, flat)
    assert path.endswith("seg_unet_resnet18.npz")
    back = load_npz(path)
    twin = create_model_from_config(cfg).eval()
    assert load_flax_weights(twin, back) == len(flat)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = model(x), twin(x)
    assert a.shape == (1, 64, 64, 2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2)  # bf16 file
    # JAX reads the exported file into its 2-class model's tree
    jmodel = JaxModel(arch="Unet", encoder_name="resnet18", classes=2,
                      activation="softmax", dtype=jnp.float32)
    template = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    jv = load_params_npz(path, jax.tree_util.tree_map(np.asarray, template))
    want = np.asarray(jmodel.apply(jv, jnp.asarray(x.numpy()), train=False))
    np.testing.assert_allclose(b.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    cfg.MODEL.CLASSES = 1
    with pytest.raises((KeyError, ValueError, RuntimeError)):
        load_flax_weights(create_model_from_config(cfg), back)
