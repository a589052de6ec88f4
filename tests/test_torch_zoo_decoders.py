"""The zoo's decoders in float32 against the JAX package's, from the same
weights (the port's init with BatchNorm statistics and biases moved off
their initial values, carried to JAX by convert's name map; the whole
models are test_torch_zoo_logits.py's): each decoder whose behaviour
changes with the input size (PSPNet, PAN/FPA, DeepLabV3/V3+ with ASPP,
MAnet) alone on synthetic feature pyramids at the sizes 512² and 1024²
inputs give (deepest 16² and 32²), narrow; one train-mode forward's
outputs and BatchNorm statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo import _jax_vars, _randomize
from unet_watermark_tpu.models import archs as jarchs
from unet_watermark_tpu.models import encoders as jenc
from unet_watermark_tpu_torch.models import archs, encoders

torch.set_num_threads(2)

# decoders alone, float32: sums over the same terms in other orders
DECODER_ATOL = 1e-4


PYRAMID = (3, 16, 16, 24, 32, 48)  # narrow channels at strides 1..32


def _pyramid(size: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, size // s, size // s, c)).astype(np.float32)
            for s, c in zip((1, 2, 4, 8, 16, 32), PYRAMID)]


DECODERS = {
    "PSPNet": (lambda size: archs.PSPDecoder(PYRAMID, out_channels=16),
               lambda: jarchs.PSPDecoder(out_channels=16, dtype=jnp.float32)),
    "PAN": (lambda size: archs.PANDecoder(PYRAMID, 8, img_size=size),
            lambda: jarchs.PANDecoder(decoder_channels=8,
                                      dtype=jnp.float32)),
    "DeepLabV3": (lambda size: archs.DeepLabV3Decoder(PYRAMID, 16),
                  lambda: jarchs.DeepLabV3Decoder(out_ch=16,
                                                  dtype=jnp.float32)),
    "DeepLabV3Plus": (lambda size: archs.DeepLabV3PlusDecoder(PYRAMID, 16,
                                                              8),
                      lambda: jarchs.DeepLabV3PlusDecoder(
                          out_ch=16, low_ch=8, dtype=jnp.float32)),
    "MAnet": (lambda size: archs.MAnetDecoder(PYRAMID, (32, 24, 16, 8, 8)),
              lambda: jarchs.MAnetDecoder(decoder_channels=(32, 24, 16, 8, 8),
                                          dtype=jnp.float32)),
}


@pytest.mark.parametrize("size", [512, 1024])
@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_at_full_size_equals_jax(name, size):
    """Where the 64² model tests do not reach: PSPNet's clamped static
    pooling (16²: 3 bins from the first 15 rows, 6 bins 8x8) and its
    non-integer upsample, FPA's three levels, ASPP's rates 6-18 inside the
    map, PAB's attention over 256 and 1024 pixels."""
    port_make, jax_make = DECODERS[name]
    dec = _randomize(port_make(size), seed=size).eval()
    feats = _pyramid(size, seed=len(name))
    want = np.asarray(jax.jit(lambda v, f: jax_make().apply(
        v, f, train=False))(_jax_vars(dec), [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        got = dec([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, size, size, dec.out_channels)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=DECODER_ATOL * scale)
    if name == "PAN":
        assert dec.fpa.levels == 3


def test_fpa_levels_follow_the_input_size():
    """One level at a 2² deepest map (64² input), three from 8² on; a PAN
    built for 64² refuses a larger input, as JAX's parameters would."""
    assert [archs.fpa_levels(s) for s in (1, 2, 3, 4, 8, 16, 32)] == \
        [0, 1, 1, 2, 3, 3, 3]
    small = archs.PANDecoder(PYRAMID, 8, img_size=64).eval()
    assert small.fpa.levels == 1
    with pytest.raises(ValueError, match="pyramid levels"), torch.no_grad():
        small([torch.zeros(1, c, 256 // s, 256 // s) for s, c in
               zip((1, 2, 4, 8, 16, 32), PYRAMID)])


def test_train_mode_forward_updates_statistics_as_jax():
    """One train-mode forward of DeepLabV3Plus's decoder (ASPP's global
    branch normalizes over N x 1 x 1) and of an EfficientNet MBConv block
    (epsilon 1e-3): outputs and the new running statistics against
    flax's (momentum 0.9, the biased batch variance)."""
    cases = []
    dec = _randomize(archs.DeepLabV3PlusDecoder(PYRAMID, 16, 8), 5)
    feats = _pyramid(128, seed=9)
    feats = [np.concatenate([f, f[:, ::-1]]) for f in feats]  # batch 2
    cases.append((dec, jarchs.DeepLabV3PlusDecoder(
        out_ch=16, low_ch=8, dtype=jnp.float32), "decoder",
        ([jnp.asarray(f) for f in feats],),
        [torch.from_numpy(f.copy()).permute(0, 3, 1, 2) for f in feats]))
    block = _randomize(encoders.MBConv(24, 40, 6, 5, 2, 0.25), 6)
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 24)).astype(
        np.float32)
    cases.append((block, jenc.MBConv(out_ch=40, expand_ratio=6, kernel=5,
                                     strides=2, se_ratio=0.25,
                                     dtype=jnp.float32), "block",
                  (jnp.asarray(x),), torch.from_numpy(x).permute(0, 3, 1, 2)))
    for module, jmod, prefix, jargs, targ in cases:
        v = _jax_vars(module, prefix)
        want, upd = jmod.apply(v, *jargs, train=True,
                               mutable=["batch_stats"])
        module.train()
        with torch.no_grad():
            got = module(targ)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-4)
        new = _jax_vars(module, prefix)["batch_stats"]
        flat_want = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
        flat_got = dict(jax.tree_util.tree_leaves_with_path(new))
        assert len(flat_want) == len(flat_got) > 0
        for path, leaf in flat_want:
            np.testing.assert_allclose(np.asarray(flat_got[path]),
                                       np.asarray(leaf), rtol=1e-5,
                                       atol=1e-6, err_msg=str(path))


