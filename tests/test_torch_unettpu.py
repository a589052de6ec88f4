"""UnetTPU's int8 tier and the zoo's weights files against the JAX
package's, on the CPU:

  - the int8 tier on a sidecar calibrated by the other package: UnetTPU
    (resnet18, 64², float32) with JAX's calibration runs the port's plain
    int8 forward (quant.conv_s8_plain) to JAX's op-by-op int8 logits, and
    the port's calibration has JAX's keys and amax;
  - .npz (the shipped format, bf16) and .pth (the reference's dict) both
    ways for UnetTPU (FPN and an efficientnet-b0 UNet++ in
    test_torch_zoo_weights.py): every tensor of the file lands, by name
    and layout, where the other package puts it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo import _jax_shapes, _jax_vars, _randomize
from unet_watermark_tpu.models import factory as jfactory
from unet_watermark_tpu.models import torch_import as jti
from unet_watermark_tpu.ops import quant as jq
from unet_watermark_tpu.utils import shipping as jship
from unet_watermark_tpu_torch.models import SMPModelFactory
from unet_watermark_tpu_torch.models import torch_import
from unet_watermark_tpu_torch.models.convert import (load_flax_weights,
                                                     to_flax)
from unet_watermark_tpu_torch.ops import quant as tq
from unet_watermark_tpu_torch.utils.shipping import load_npz, save_params_npz

torch.set_num_threads(2)

# int8 logits against JAX's op-by-op int8 forward: every conv's int8
# input and int32 sums agree; the float BN/ReLU/add order differs (the
# tolerance of tests/test_torch_quant.py's eager comparison in float32)
EAGER_TOL = (1e-4, 1e-5)  # (max, mean)


def _model(arch, encoder, seed):
    return _randomize(SMPModelFactory.create_model(arch, encoder,
                                                   img_size=64), seed).eval()


def _jax_tree(model):
    v = {}
    for part in ("encoder", "decoder", "segmentation_head"):
        for coll, tree in _jax_vars(getattr(model, part), part).items():
            v.setdefault(coll, {})[part] = tree
    return v


def _x(seed=4):
    return np.random.default_rng(seed).normal(size=(2, 64, 64, 3)).astype(
        np.float32)


def _port_observe(model, x):
    load_flax_weights(model, to_flax(model))  # sets the int8 paths
    store = {}
    with torch.no_grad(), tq.quant_observe(store):
        model(torch.from_numpy(x))
    return store


def test_unettpu_int8_on_each_others_sidecars(tmp_path):
    model = _model("UnetTPU", "resnet18", 3)
    v, x = _jax_tree(model), _x()
    jmodel = jfactory.SegmentationModel(arch="UnetTPU",
                                        encoder_name="resnet18",
                                        dtype=jnp.float32)
    jscales = {}
    with jq.quant_observe(jscales):
        jmodel.apply(v, jnp.asarray(x), train=False)
    jq.save_scales(str(tmp_path / "jax.quant.json"), jscales)
    scales = tq.load_scales(str(tmp_path / "jax.quant.json"))
    assert len(scales) == 29  # resnet18's 20 convs and UnetTPU's 9
    with jq.quant_int8(scales) as jmode:
        want = np.asarray(jmodel.apply(v, jnp.asarray(x), train=False))
    load_flax_weights(model, to_flax(model))
    with torch.no_grad(), tq.quant_int8(
            scales, tq.build_plans(model, scales)) as tmode:
        got = model(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        plain = model(torch.from_numpy(x)).numpy()
    assert not jmode.missing and not tmode.missing
    err = np.abs(got - want)
    assert err.max() < EAGER_TOL[0] and err.mean() < EAGER_TOL[1]
    assert np.abs(got - plain).max() > 1e-3  # int8 moved the logits
    # the port's calibration has JAX's keys (each int8 conv's flax path,
    # the split up-convs' ':up' and ':skip') and amax, so it drives JAX's
    # int8 tier whole, and JAX's drove the port's above
    port = _port_observe(model, x)
    tq.save_scales(str(tmp_path / "port.quant.json"), port)
    assert sorted(jq.load_scales(str(tmp_path / "port.quant.json"))) == \
        sorted(jscales)
    for k, a in port.items():
        assert a == pytest.approx(jscales[k], rel=1e-4), k




def _template(arch, encoder):
    """JAX variables of zeros, shaped as its init's (jax.eval_shape)."""
    jmodel = jfactory.SegmentationModel(arch=arch, encoder_name=encoder,
                                        dtype=jnp.float32)
    tree = {}
    for key, shape in _jax_shapes(jmodel, (1, 64, 64, 3),
                                  train=False).items():
        node = tree
        *parts, leaf = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(shape, np.float32)
    return tree


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def test_weights_files_round_trip_both_ways(tmp_path):
    """UnetTPU's (tests/test_torch_zoo_weights.py holds FPN's and an
    efficientnet-b0 UNet++'s)."""
    check_weights_round_trip("UnetTPU", "resnet18", tmp_path)


def check_weights_round_trip(arch, encoder, tmp_path):
    """.npz: the port's export read by JAX's load_params_npz and JAX's
    save_params_npz read by the port, every leaf the bf16 of the model's.
    .pth: the port's export_pth imported by JAX's import_pth and JAX's
    export_pth imported by the port, nothing missing or unused, the
    tensors equal in float32."""
    model = _model(arch, encoder, 8)
    flat = to_flax(model)
    template = _template(arch, encoder)
    path = str(tmp_path / "port.npz")
    save_params_npz(path, flat)
    jv = jship.load_params_npz(path, template)
    got = {k: np.asarray(v) for k, v in jship.flatten_tree(jv).items()}
    assert sorted(got) == sorted(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(got[k], _bf16(a), err_msg=k)
    jpath = str(tmp_path / "jax.npz")
    jship.save_params_npz(jpath, jv)
    twin = SMPModelFactory.create_model(arch, encoder, img_size=64)
    assert load_flax_weights(twin, load_npz(jpath)) == len(flat)
    for k, a in to_flax(twin).items():
        np.testing.assert_array_equal(a, _bf16(flat[k]), err_msg=k)

    path = str(tmp_path / "port.pth")
    torch_import.export_pth(path, None, model, epoch=2)
    jv, report = jti.import_pth(path, template)
    assert not report["missing"] and not report["unused"]
    got = {k: np.asarray(v) for k, v in jship.flatten_tree(jv).items()}
    for k, a in flat.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    jpath = str(tmp_path / "jax.pth")
    jti.export_pth(jpath, None, jv["params"], jv["batch_stats"])
    twin, report = torch_import.import_pth(jpath, twin)
    assert not report["missing"] and not report["unused"]
    assert len(report["loaded"]) == len(flat)
    for k, a in to_flax(twin).items():
        np.testing.assert_array_equal(a, flat[k], err_msg=k)
