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
from unet_watermark_tpu_torch.models.unet import UnetPlusPlusDecoder
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
    for name, impl, match in (("UnetPlusPlus", "smp", "DECODER_IMPL"),
                              ("FPN", "canonical", "not ported")):
        cfg.MODEL.NAME, cfg.MODEL.DECODER_IMPL = name, impl
        with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
            create_model_from_config(cfg)
        assert match in str(err.value)
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
