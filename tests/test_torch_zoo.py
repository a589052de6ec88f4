"""The port's model zoo against the JAX package's, on the CPU, without a
forward: every parameter's name and shape (jax.eval_shape, no init) for
the ten archs with resnet34 at 512² and the three shipped configs; the
registry's names and refusals; upsample_to and pixel_shuffle bit for bit;
FPA's levels; the model-size table. The encoders are
test_torch_zoo_encoders.py's, the decoders' numbers
test_torch_zoo_decoders.py's."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_watermark_tpu.models import archs as jarchs
from unet_watermark_tpu.models import encoders as jenc
from unet_watermark_tpu.models import factory as jfactory
from unet_watermark_tpu.models import model_size as jsize
from unet_watermark_tpu.models import unet as junet
from unet_watermark_tpu_torch.configs import get_cfg_defaults, update_config
from unet_watermark_tpu_torch.models import (SUPPORTED_MODELS,
                                             SMPModelFactory,
                                             available_encoders,
                                             count_parameters,
                                             create_model_from_config,
                                             get_encoder,
                                             get_encoder_channels, init_model)
from unet_watermark_tpu_torch.models import archs, encoders, factory
from unet_watermark_tpu_torch.models import model_size
from unet_watermark_tpu_torch.models.convert import flax_name
from unet_watermark_tpu_torch.models.unet import pixel_shuffle
from unet_watermark_tpu_torch.utils.shipping import REPO_ROOT

torch.set_num_threads(2)

CONFIGS = REPO_ROOT / "unet_watermark_tpu_torch" / "configs"
# the JAX package's counts of the shipped configs' models
CONFIG_PARAMS = {"unet_watermark.yaml": 25_774_097,
                 "unet_text_watermark.yaml": 13_542_137,
                 "unet_watermark_large.yaml": 94_411_649}
# decoders alone, float32: sums over the same terms in other orders
DECODER_ATOL = 1e-4


def _jax_shapes(module, shape, **kw):
    """{flax key: shape} of a JAX module's variables at an input of that
    shape, abstractly."""
    v = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                           jnp.zeros(shape), **kw))
    return {"/".join(p.key for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(v)[0]}


def _port_shapes(module, prefix=""):
    """{flax key: HWIO shape} of a port module's state_dict."""
    out = {}
    for n, t in module.state_dict().items():
        if n.endswith("num_batches_tracked"):
            continue
        s = tuple(t.shape)
        if len(s) == 4:
            s = (s[2], s[3], s[1], s[0])
        out[flax_name(prefix + n)] = s
    return out


def _jax_vars(module, prefix: str = "decoder"):
    """A port module's weights as the flax variables of the JAX module
    that `prefix` names."""
    tree = {}
    for n, t in module.state_dict().items():
        if n.endswith("num_batches_tracked"):
            continue
        arr = t.detach().numpy()
        if arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 1, 0))
        coll, *parts = flax_name(f"{prefix}.{n}").split("/")
        node = tree.setdefault(coll, {})
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(arr)
    return tree


@torch.no_grad()
def _randomize(module, seed: int):
    """Seeded weights, and running statistics and biases off their
    initial values, so BatchNorm and the biases are not identities."""
    init_model(module, seed)
    g = torch.Generator().manual_seed(seed + 1)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(0.2 * torch.randn(m.running_mean.shape,
                                                   generator=g))
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                 generator=g))
            m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
        elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return module


@pytest.mark.parametrize("arch", list(SUPPORTED_MODELS))
def test_structure_equals_jax_at_512(arch):
    """resnet34 at the shipped width: the same parameter names (as
    convert.flax_name maps the port's) and shapes as JAX's init."""
    jmodel = jfactory.SegmentationModel(arch=arch, encoder_name="resnet34",
                                        dtype=jnp.float32)
    want = _jax_shapes(jmodel, (1, 512, 512, 3), train=False)
    with torch.device("meta"):
        model = SMPModelFactory.create_model(arch, "resnet34", img_size=512)
    assert _port_shapes(model) == want


@pytest.mark.parametrize("name", sorted(CONFIG_PARAMS))
def test_shipped_configs_build_as_jax(name):
    """create_model_from_config builds each shipped YAML's model with JAX's
    parameter tree at the config's DATA.IMG_SIZE, and JAX's count."""
    from unet_watermark_tpu.configs import get_cfg_defaults as jcfg
    from unet_watermark_tpu.configs import update_config as jupdate

    cfg = get_cfg_defaults()
    update_config(cfg, CONFIGS / name)
    jc = jcfg()
    jupdate(jc, str(REPO_ROOT / "unet_watermark_tpu" / "configs" / name))
    jc.MODEL.DTYPE = "float32"
    size = cfg.DATA.IMG_SIZE
    want = _jax_shapes(jfactory.create_model_from_config(jc),
                       (1, size, size, 3), train=False)
    with torch.device("meta"):
        model = create_model_from_config(cfg)
    assert _port_shapes(model) == want
    params = sum(int(np.prod(s)) for k, s in want.items()
                 if k.startswith("params/"))
    assert count_parameters(model) == params == CONFIG_PARAMS[name]


def test_registry_equals_jax():
    assert available_encoders() == jenc.available_encoders()
    assert list(SUPPORTED_MODELS) == list(jfactory.SUPPORTED_MODELS)
    assert SMPModelFactory.get_available_encoders() == \
        jfactory.SMPModelFactory.get_available_encoders()
    for alias in ("unet++", "UNET++", "fpn", "deeplabv3PLUS", "UnetTPU"):
        assert factory.canonical_model_name(alias) == \
            jfactory.canonical_model_name(alias)
    # the timm- prefix is dropped, as in JAX
    assert get_encoder_channels("timm-efficientnet-b3") == \
        jenc.get_encoder_channels("timm-efficientnet-b3")
    assert isinstance(get_encoder("timm-resnet50"), encoders.ResNetEncoder)


@pytest.mark.parametrize("call", ["model", "encoder", "channels", "factory",
                                  "decoder"])
def test_unknown_names_raise_as_jax(call):
    """ValueError with JAX's message, where JAX raises."""
    port, jax_ = {
        "model": (lambda: factory.canonical_model_name("SegFormer"),
                  lambda: jfactory.canonical_model_name("SegFormer")),
        "encoder": (lambda: get_encoder("vgg16"),
                    lambda: jenc.get_encoder("vgg16")),
        "channels": (lambda: get_encoder_channels("mit_b0"),
                     lambda: jenc.get_encoder_channels("mit_b0")),
        "factory": (lambda: SMPModelFactory.create_model("FPN", "vgg16"),
                    lambda: jfactory.SMPModelFactory.create_model(
                        "FPN", "vgg16")),
        "decoder": (lambda: archs.make_decoder("segformer", (3,) * 6, ()),
                    lambda: jarchs.make_decoder("segformer", (), jnp.float32)),
    }[call]
    with pytest.raises(ValueError) as a:
        port()
    with pytest.raises(ValueError) as b:
        jax_()
    assert str(a.value) == str(b.value)


# (input h, w) → (output h, w): non-integer factors (jax.image.resize's
# nearest, half-pixel centres) at PSPNet's 3 → 16 and 3 → 32 / 6 → 32 of
# 512² and 1024² inputs, and others; integer factors (a broadcast)
UPSAMPLES = [((3, 3), (16, 16)), ((3, 3), (32, 32)), ((6, 6), (32, 32)),
             ((2, 2), (5, 5)), ((5, 5), (16, 16)), ((7, 7), (16, 16)),
             ((6, 6), (16, 16)), ((2, 3), (16, 16)), ((2, 2), (4, 4)),
             ((1, 1), (16, 16)), ((8, 8), (16, 16)), ((4, 8), (16, 16)),
             ((16, 16), (16, 16))]


@pytest.mark.parametrize("src, dst", UPSAMPLES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                              for a, b in UPSAMPLES])
def test_upsample_to_equals_jax(src, dst):
    x = np.random.default_rng(0).normal(
        size=(2, src[0], src[1], 3)).astype(np.float32)
    want = np.asarray(jarchs.upsample_to(jnp.asarray(x), *dst))
    got = archs.upsample_to(torch.from_numpy(x).permute(0, 3, 1, 2), *dst)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("classes", [1, 2, 3])
@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_equals_jax(classes, r):
    """JAX's channel order (ry, rx, c): F.pixel_shuffle's differs where
    classes > 1."""
    x = np.random.default_rng(classes).normal(
        size=(2, 5, 7, classes * r * r)).astype(np.float32)
    want = np.asarray(junet.pixel_shuffle(jnp.asarray(x), r))
    got = pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    torch_order = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), r)
    assert torch.equal(torch_order, got) == (classes == 1)


def test_model_sizes_equal_jax(monkeypatch):
    """compare_model_sizes' table and its printout equal JAX's over the
    default archs and the ResNet encoders (JAX's init run abstractly,
    jax.eval_shape; the EfficientNet rows' models are held by
    test_shipped_configs_build_as_jax and test_torch_zoo_encoders.py),
    and the default table's rows and order; PAN's size at 512²."""
    import inspect

    def abstract_init(model, img_size, seed=0, batch=1):
        return jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(seed), jnp.zeros((batch, img_size, img_size,
                                                 3)), train=False))

    monkeypatch.setattr(jfactory, "init_model", abstract_init)
    encs = ["resnet18", "resnet50"]
    outs = []
    for mod in (model_size, jsize):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = mod.compare_model_sizes(encoders=encs)
        outs.append((rows, buf.getvalue()))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) == 8 and not any("error" in r
                                             for r in outs[0][0])
    for fn in ("compare_model_sizes", "get_model_size"):
        assert inspect.signature(getattr(model_size, fn)) == \
            inspect.signature(getattr(jsize, fn))
    rows = model_size.compare_model_sizes(print_table=False)
    assert [(r["model"], r["encoder"]) for r in rows] == [
        (m, e) for m in ("Unet", "UnetPlusPlus", "FPN", "Linknet")
        for e in ("resnet18", "resnet34", "resnet50", "efficientnet-b0",
                  "efficientnet-b3")]
    assert model_size.get_model_size("PAN", "resnet34", img_size=512) == \
        jsize.get_model_size("PAN", "resnet34", img_size=512)


def test_watermark_segmentation_model_wraps_the_config():
    """WatermarkSegmentationModel builds the config's model (seeded, in
    MODEL.DTYPE, on the device asked for) and reports JAX's info keys;
    without a card its default device raises."""
    import inspect

    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME = "FPN", "resnet18"
    cfg.MODEL.DTYPE, cfg.DATA.IMG_SIZE = "float32", 64
    wrapped = factory.WatermarkSegmentationModel(cfg, seed=2, device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = init_model(create_model_from_config(cfg), 2).eval()(
            torch.from_numpy(x))
    np.testing.assert_array_equal(wrapped(x).numpy(), want.numpy())
    info = wrapped.get_model_info()
    src = inspect.getsource(jfactory.WatermarkSegmentationModel
                            .get_model_info)
    assert all(f'"{k}"' in src for k in info) and src.count('": ') == 5
    assert info["parameters"] == count_parameters(wrapped.model) == \
        count_parameters(create_model_from_config(cfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            factory.WatermarkSegmentationModel(cfg)
