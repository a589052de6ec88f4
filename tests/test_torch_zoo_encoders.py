"""Every encoder of available_encoders() against the JAX package's: the
parameter names and shapes (jax.eval_shape) and the pyramid's channels
(the ResNets and efficientnet-b0, -b3 and -b7 traced whole, every
EfficientNet's block plan against JAX's tables);
and the new families' features in float32 at 64² (resnet50's
bottlenecks, efficientnet-b0 and -b3's MBConv blocks with their
epsilon-1e-3 BatchNorm) from the same weights, carried to JAX by
convert's name map."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo import _jax_shapes, _jax_vars, _port_shapes, _randomize
from unet_watermark_tpu.models import encoders as jenc
from unet_watermark_tpu_torch.models import get_encoder, get_encoder_channels

torch.set_num_threads(2)

# fp32 conv sums in another order, through up to 26 blocks: 3e-5 of the
# largest feature (observed ~1e-6)
FEATURE_RTOL = 3e-5


# whole parameter trees through jax.eval_shape (~4 s an EfficientNet);
# the other EfficientNets differ from these only by their width and depth
# multipliers, held block by block below
TRACED = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
          "efficientnet-b0", "efficientnet-b3", "efficientnet-b7"]


@pytest.mark.parametrize("name", TRACED)
def test_encoder_structure_equals_jax(name):
    want = _jax_shapes(jenc.get_encoder(name, dtype=jnp.float32),
                       (1, 64, 64, 3), train=False)
    with torch.device("meta"):
        enc = get_encoder(name)
    got = {k.replace("params/encoder/", "params/", 1).replace(
        "batch_stats/encoder/", "batch_stats/", 1): v
        for k, v in _port_shapes(enc, "encoder.").items()}
    assert got == want
    assert enc.out_channels == get_encoder_channels(name) == \
        jenc.get_encoder_channels(name)


@pytest.mark.parametrize("name", [n for n in jenc.available_encoders()
                                  if n.startswith("efficientnet")])
def test_efficientnet_block_plan_equals_jax(name):
    """Every EfficientNet's blocks (input and output width, expand ratio,
    kernel, stride, SE width) and feature taps as JAX's _EFFNET_* tables
    and rounding give them (EfficientNetEncoder builds block{i} in this
    order), and the pyramid's channels."""
    width, depth = jenc._EFFNET_PARAMS[name]
    want, cin = [], jenc._round_channels(32, width)
    for er, k, s, _, cout, reps, se in jenc._EFFNET_BASE_BLOCKS:
        out = jenc._round_channels(cout, width)
        for r in range(jenc._round_repeats(reps, depth)):
            want.append((cin, out, cin * er, er, k, s if r == 0 else 1,
                         max(1, int(cin * se))))
            cin = out
        want.append("end")
    with torch.device("meta"):
        enc = get_encoder(name)
    got = []
    for i, b in enumerate(enc.blocks):
        mid = b.dw_conv.in_channels
        got.append((b.expand_conv.in_channels if b.expand_conv is not None
                    else mid, b.project_conv.out_channels, mid,
                    mid // (b.expand_conv.in_channels
                            if b.expand_conv is not None else mid),
                    b.dw_conv.kernel_size[0], b.dw_conv.stride[0],
                    b.se.reduce.out_channels))
        if i in enc.stage_ends:
            got.append("end")
    assert got == want
    assert enc.stem_conv.out_channels == jenc._round_channels(32, width)
    assert enc.out_channels == jenc.get_encoder_channels(name)


@pytest.mark.parametrize("name", ["resnet50", "efficientnet-b0",
                                  "efficientnet-b3"])
def test_new_encoder_features_equal_jax(name):
    enc = _randomize(get_encoder(name), seed=len(name)).eval()
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    v = _jax_vars(enc, "encoder")
    jmod = jenc.get_encoder(name, dtype=jnp.float32)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = enc(torch.from_numpy(x).permute(0, 3, 1, 2))
    chans = get_encoder_channels(name)
    assert len(got) == len(want) == 6
    for i, (t, j) in enumerate(zip(got, want)):
        t, j = t.permute(0, 2, 3, 1).numpy(), np.asarray(j)
        assert t.shape == j.shape == (2, 64 >> i, 64 >> i, chans[i])
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t, j, rtol=0, atol=FEATURE_RTOL * scale,
                                   err_msg=f"stage {i}")
