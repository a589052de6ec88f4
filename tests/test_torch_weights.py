"""The port's .npz reader and weight converter against the JAX package's
loader and name map."""
import numpy as np
import pytest
import torch

from unet_watermark_tpu.models.torch_import import _torch_name
from unet_watermark_tpu.utils.shipping import flatten_tree, load_params_npz
from unet_watermark_tpu_torch.models import SegmentationModel
from unet_watermark_tpu_torch.models.convert import (load_flax_weights,
                                                     to_state_dict,
                                                     torch_name)
from unet_watermark_tpu_torch.utils.shipping import (WEIGHTS_DIR, load_npz,
                                                     seg_weights_path)

torch.set_num_threads(2)

UNET = seg_weights_path("Unet", "resnet34")


def _template(path):
    """A nested-dict template of the .npz's own keys and shapes."""
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            parts = k.split("::", 1)[-1].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.zeros(z[k].shape, np.float32)
    return tree


@pytest.fixture(scope="module")
def flat():
    return load_npz(UNET)


@pytest.mark.parametrize("name", ["seg_unet_resnet34.npz",
                                  "seg_unetplusplus_resnet34.npz"])
def test_npz_decode_matches_jax_loader(name):
    path = WEIGHTS_DIR / name
    ours = load_npz(path)
    ref = flatten_tree(load_params_npz(str(path), _template(path)))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)


def test_seg_weights_path_names_shipped_files():
    assert UNET.name == "seg_unet_resnet34.npz" and UNET.exists()
    for name in ("UnetPlusPlus", "unet++"):
        assert seg_weights_path(name, "resnet34").name == \
            "seg_unetplusplus_resnet34.npz"


def test_torch_name_matches_jax_name_map(flat):
    for key in flat:
        collection, *path = key.split("/")
        assert torch_name(key) == _torch_name(tuple(path), collection), key


def test_convert_uses_all_232_keys(flat):
    assert len(flat) == 232
    model = SegmentationModel()
    assert load_flax_weights(model, flat) == 232
    sd = model.state_dict()
    n_model = sum(not k.endswith("num_batches_tracked") for k in sd)
    assert n_model == 232
    k = "params/encoder/layer2_0/conv1/kernel"  # HWIO (3,3,64,128) → OIHW
    np.testing.assert_array_equal(
        sd["encoder.layer2.0.conv1.weight"].numpy(),
        np.transpose(flat[k], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        sd["decoder.blocks.0.conv1.1.running_var"].numpy(),
        flat["batch_stats/decoder/block0/conv1/bn/var"])


def test_convert_uses_all_292_unetplusplus_keys():
    pp = load_npz(seg_weights_path("UnetPlusPlus", "resnet34"))
    assert len(pp) == 292
    assert sum(k.split("/")[1] == "decoder" for k in pp) == 110
    model = SegmentationModel("UnetPlusPlus")
    assert load_flax_weights(model, pp) == 292
    sd = model.state_dict()
    assert sum(not k.endswith("num_batches_tracked") for k in sd) == 292
    for key, name in (
            ("params/decoder/x_0_4_conv1/conv/kernel",
             "decoder.x_0_4_conv1.0.weight"),
            ("batch_stats/decoder/x_3_1_conv2/bn/var",
             "decoder.x_3_1_conv2.1.running_var"),
            ("params/decoder/final_block/conv1/bn/scale",
             "decoder.final_block.conv1.1.weight")):
        assert torch_name(key) == name
        want = pp[key]
        if want.ndim == 4:  # HWIO → OIHW
            want = np.transpose(want, (3, 2, 0, 1))
        np.testing.assert_array_equal(sd[name].numpy(), want)
    assert tuple(sd["decoder.x_0_4_conv1.0.weight"].shape) == (32, 224, 3, 3)
    extra = dict(pp)
    extra["params/decoder/x_0_5_conv1/conv/kernel"] = np.zeros((3, 3, 1, 1))
    with pytest.raises(KeyError, match="not in the model"):
        to_state_dict(extra, model)


def test_convert_rejects_leftover_missing_and_misshaped(flat):
    model = SegmentationModel()
    extra = dict(flat)
    extra["params/decoder/block5/conv1/conv/kernel"] = np.zeros((3, 3, 1, 1))
    with pytest.raises(KeyError, match="not in the model"):
        to_state_dict(extra, model)
    short = dict(flat)
    del short["batch_stats/encoder/bn1/mean"]
    with pytest.raises(KeyError, match="got no value"):
        to_state_dict(short, model)
    bad = dict(flat)
    bad["params/segmentation_head/conv/bias"] = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        to_state_dict(bad, model)
