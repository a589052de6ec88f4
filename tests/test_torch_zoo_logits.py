"""Each new arch of the zoo (UnetTPU, MAnet, Linknet, FPN, PSPNet, PAN,
DeepLabV3, DeepLabV3Plus) with resnet18 at 64² in float32 against the
JAX package's SegmentationModel, from the same weights (the port's init
with BatchNorm statistics and biases moved off their initial values,
carried to JAX by convert's name map): logits within LOGIT_ATOL."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo import _jax_vars, _randomize
from unet_watermark_tpu.models import factory as jfactory
from unet_watermark_tpu_torch.models import SMPModelFactory

torch.set_num_threads(2)

# float32 convs summed in another order; observed <= 2e-5
# (test_torch_models.py's tolerance)
LOGIT_ATOL = 1e-3
NEW_ARCHS = ["UnetTPU", "MAnet", "Linknet", "FPN", "PSPNet", "PAN",
             "DeepLabV3", "DeepLabV3Plus"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_arch_logits_equal_jax(arch):
    model = _randomize(SMPModelFactory.create_model(arch, "resnet18",
                                                    img_size=64), seed=7)
    model.eval()
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    v = {}
    for part in ("encoder", "decoder", "segmentation_head"):
        for coll, tree in _jax_vars(getattr(model, part), part).items():
            v.setdefault(coll, {})[part] = tree
    jmodel = jfactory.SegmentationModel(arch=arch, encoder_name="resnet18",
                                        dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    assert np.abs(want).max() > 1e-2  # not a degenerate output
