"""The port's FFC-LaMa generator (models/lama.py), its weight converter and
its engine registry (inference/engines.py) against the JAX package's, on
the CPU. Inputs come from np.random.default_rng; each test states its
tolerance and the value observed."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from unet_watermark_tpu.configs import get_cfg_defaults as jax_cfg_defaults
from unet_watermark_tpu.models import lama as jlama
from unet_watermark_tpu.utils import shipping as jshipping
from unet_watermark_tpu.utils.shipping import flatten_tree, load_params_npz
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.inference import engines
from unet_watermark_tpu_torch.models import lama
from unet_watermark_tpu_torch.models.convert import (lama_torch_name,
                                                     load_lama_weights,
                                                     to_state_dict)
from unet_watermark_tpu_torch.ops.inpaint import inpaint_pushpull
from unet_watermark_tpu_torch.utils import shipping
from unet_watermark_tpu_torch.utils.shipping import WEIGHTS_DIR, load_npz

torch.set_num_threads(2)

LAMA = WEIGHTS_DIR / "lama_ffc.npz"
# float32 on both sides; the DFT is a dense matmul in JAX and an FFT here
DFT_ATOL = 1e-5  # observed 1.2e-6 at 64 x 64
FP32_ATOL = 1e-4  # each test states what it observed


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
def jvars():
    """The JAX variables of the shipped weights."""
    return load_params_npz(str(LAMA), _template(LAMA))


@pytest.fixture(scope="module")
def flat():
    return load_npz(LAMA)


def _sub(flat, prefix):
    """The flat weights under `prefix` in both collections, the prefix cut."""
    out = {}
    for k, v in flat.items():
        col, _, rest = k.partition("/")
        if rest.startswith(prefix + "/"):
            out[f"{col}/{rest[len(prefix) + 1:]}"] = v
    return out


def _jsub(jvars, *path):
    out = {}
    for col in ("params", "batch_stats"):
        node = jvars[col]
        for p in path:
            node = node[p]
        out[col] = node
    return out


def _loaded(module, flat):
    assert load_lama_weights(module, flat) == len(flat)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _batch(rng, n, s):
    img = rng.random((n, s, s, 3)).astype(np.float32)
    mask = np.zeros((n, s, s, 1), np.float32)
    mask[:, s // 4:s // 2, s // 3:2 * s // 3] = 1.0
    mask[1:, s // 2:, :s // 5] = 1.0
    return img, mask


# -- the spectral transform's DFT -------------------------------------------

@pytest.mark.parametrize("h,w", [(8, 8), (16, 24), (64, 64)])
def test_dft2_matches_jax(h, w):
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 5)).astype(
        np.float32)
    jr, ji = jlama.dft2(jnp.asarray(x))
    tr, ti = lama.dft2(_nchw(x))
    np.testing.assert_allclose(_nhwc(tr), np.asarray(jr), rtol=0,
                               atol=DFT_ATOL)
    np.testing.assert_allclose(_nhwc(ti), np.asarray(ji), rtol=0,
                               atol=DFT_ATOL)


@pytest.mark.parametrize("h,w", [(8, 8), (16, 24), (64, 64)])
def test_idft2_real_matches_jax(h, w):
    """On a spectrum that is not Hermitian-symmetric, as the fourier conv
    gives: irfft2 would be off by 2.7 here (8 x 8)."""
    rng = np.random.default_rng(h + w)
    re, im = rng.normal(size=(2, 2, h, w, 4)).astype(np.float32)
    ref = np.asarray(jlama.idft2_real(jnp.asarray(re), jnp.asarray(im)))
    out = _nhwc(lama.idft2_real(_nchw(re), _nchw(im)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=DFT_ATOL)


# -- the converter -----------------------------------------------------------

def test_converter_uses_all_433_keys_once(flat):
    assert len(flat) == 433
    names = [lama_torch_name(k) for k in flat]
    assert len(set(names)) == 433
    with torch.device("meta"):
        model = lama.create_lama("lama", torch.float32)
    assert load_lama_weights(model, flat) == 433
    sd = model.state_dict()
    assert sum(not k.endswith("num_batches_tracked") for k in sd) == 433
    assert all(t.device.type == "cpu" for t in sd.values())
    assert lama_torch_name("params/block3/ffc1/g2g/reduce/kernel") == \
        "blocks.3.ffc1.g2g.reduce.weight"
    assert lama_torch_name("batch_stats/up2_bn/var") == "up2_bn.running_var"
    k = flat["params/up1/kernel"]  # (kh, kw, in, out), flipped
    np.testing.assert_array_equal(
        sd["up1.weight"].numpy(),
        np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1])
    np.testing.assert_array_equal(
        sd["blocks.8.ffc2.l2g.weight"].numpy(),
        np.transpose(flat["params/block8/ffc2/l2g/kernel"], (3, 2, 0, 1)))


def test_converter_rejects_another_variants_tree(flat):
    with torch.device("meta"):
        big = lama.create_lama("big-lama", torch.float32)
    with pytest.raises(KeyError, match="got no value"):
        to_state_dict(flat, big, lama_torch_name)


@pytest.mark.parametrize("s,cin,cout", [(4, 8, 6), (7, 5, 3), (16, 16, 8)])
def test_conv_transpose_flip_matches_flax(s, cin, cout):
    """flax ConvTranspose(4x4, stride 2, SAME) = torch ConvTranspose2d(4,
    2, padding 1) with the kernel permuted and flipped; atol 1e-5,
    observed 5.7e-6 (normal inputs, sums of up to 64 terms). Without the
    flip the outputs differ by O(1)."""
    rng = np.random.default_rng(s * cin)
    x = rng.normal(size=(2, s, s, cin)).astype(np.float32)
    kernel = rng.normal(size=(4, 4, cin, cout)).astype(np.float32)
    jconv = fnn.ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME",
                              use_bias=False)
    ref = np.asarray(jconv.apply({"params": {"kernel": kernel}}, x))
    module = torch.nn.Module()
    module.up0 = torch.nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False)
    _loaded(module, {"params/up0/kernel": kernel})
    with torch.inference_mode():
        out = _nhwc(module.up0(_nchw(x)))
        unflipped = _nhwc(torch.nn.functional.conv_transpose2d(
            _nchw(x), torch.from_numpy(np.ascontiguousarray(
                np.transpose(kernel, (2, 3, 0, 1)))), stride=2, padding=1))
    assert out.shape == ref.shape == (2, 2 * s, 2 * s, cout)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert np.abs(unflipped - ref).max() > 0.5


# -- modules in float32 against JAX ------------------------------------------

@pytest.mark.parametrize("s", [8, 16])
def test_spectral_transform_matches_jax(jvars, flat, s):
    """block0/ffc1's global branch with the shipped weights at the /8
    working size of 64² and 128² images; atol 1e-4, observed 1.7e-6."""
    x = np.random.default_rng(s).random((2, s, s, 256)).astype(np.float32)
    ref = np.asarray(jlama.SpectralTransform(256, dtype=jnp.float32).apply(
        _jsub(jvars, "block0", "ffc1", "g2g"), jnp.asarray(x)))
    module = _loaded(lama.SpectralTransform(256, 256),
                     _sub(flat, "block0/ffc1/g2g"))
    with torch.inference_mode():
        out = _nhwc(module(_nchw(x)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("s", [8, 16])
def test_ffc_matches_jax(jvars, flat, s):
    """block4/ffc2 with the shipped weights; atol 1e-4 on both branches,
    observed 1.1e-5."""
    rng = np.random.default_rng(s + 1)
    x_l, x_g = rng.random((2, 2, s, s, 256)).astype(np.float32)
    rl, rg = jlama.FFC(512, dtype=jnp.float32).apply(
        _jsub(jvars, "block4", "ffc2"), jnp.asarray(x_l), jnp.asarray(x_g))
    module = _loaded(lama.FFC(512), _sub(flat, "block4/ffc2"))
    with torch.inference_mode():
        tl, tg = module(_nchw(x_l), _nchw(x_g))
    np.testing.assert_allclose(_nhwc(tl), np.asarray(rl), rtol=0,
                               atol=FP32_ATOL)
    np.testing.assert_allclose(_nhwc(tg), np.asarray(rg), rtol=0,
                               atol=FP32_ATOL)


@pytest.fixture(scope="module")
def generator32(flat):
    return _loaded(lama.create_lama("lama", torch.float32), flat)


def _jax_generator(jvars, img, mask, dtype):
    model = jlama.create_lama("lama", dtype=dtype)
    return np.asarray(jax.jit(lambda a, b: model.apply(
        jvars, a, b, train=False))(img, mask))


@pytest.mark.parametrize("s", [64, 128])
def test_generator_matches_jax_shipped_weights(jvars, generator32, s):
    """The whole generator in float32 with the shipped weights; atol 1e-4,
    observed 2.1e-7. The output is trained, not trivial: hole pixels
    spread over more than 0.15 (observed 0.23)."""
    img, mask = _batch(np.random.default_rng(s), 2, s)
    ref = _jax_generator(jvars, img, mask, jnp.float32)
    with torch.inference_mode():
        out = generator32(torch.from_numpy(img), torch.from_numpy(mask))
    out = out.numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=FP32_ATOL)
    hole = mask[..., 0] > 0
    assert np.ptp(out[hole]) > 0.15
    np.testing.assert_array_equal(out[~hole], img[~hole])


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_matches_jax_random_narrow_weights(seed):
    """base_channels=16, 2 blocks, every weight and BN statistic random;
    atol 1e-4, observed 2.4e-7."""
    rng = np.random.default_rng(seed)
    jmodel = jlama.LamaGenerator(base_channels=16, num_blocks=2,
                                 dtype=jnp.float32)
    img, mask = _batch(rng, 2, 32)
    template = flatten_tree(jmodel.init(jax.random.PRNGKey(seed), img, mask))
    flat = {}
    for k, v in template.items():
        if k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            fan_in = int(np.prod(v.shape[:-1])) if v.ndim == 4 else 4
            flat[k] = (rng.normal(size=v.shape) / np.sqrt(fan_in)
                       ).astype(np.float32)
    tree = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    ref = np.asarray(jmodel.apply(tree, img, mask, train=False))
    model = _loaded(lama.LamaGenerator(base_channels=16, num_blocks=2), flat)
    with torch.inference_mode():
        out = model(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=FP32_ATOL)


def test_generator_bf16_matches_jax_bf16(jvars, flat):
    """Both in bf16 (the engine's dtype), shipped weights, 2 x 64²: on hole
    pixels max 5e-3 and mean 1e-3; observed max 6.1e-4, mean 1.5e-4.
    Known pixels are the input's on both sides."""
    img, mask = _batch(np.random.default_rng(0), 2, 64)
    ref = _jax_generator(jvars, img, mask, jnp.bfloat16)
    model = _loaded(lama.create_lama("lama", torch.float32), flat)
    model = model.to(torch.bfloat16)
    with torch.inference_mode():
        out = model(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    hole = np.broadcast_to(mask > 0, out.shape)
    err = np.abs(out - ref)[hole]
    assert err.max() <= 5e-3 and err.mean() <= 1e-3, (err.max(), err.mean())
    np.testing.assert_array_equal(out[~hole], ref[~hole])
    np.testing.assert_array_equal(out[~hole], np.broadcast_to(
        img, out.shape)[~hole])


# -- weights resolution and the engine registry ------------------------------

def test_resolve_inpaint_weights_precedence(monkeypatch):
    monkeypatch.delenv("PREDICT_INPAINT_WEIGHTS", raising=False)
    cfg, jcfg = get_cfg_defaults(), jax_cfg_defaults()
    # nothing set: the shipped file, as JAX resolves it
    assert engines.resolve_inpaint_weights() == str(LAMA)
    assert engines.default_inpaint_weights() == str(LAMA)
    assert shipping.resolve("inpaint") == jshipping.resolve("inpaint")
    # explicit beats config beats env beats default
    for c in (cfg, jcfg):
        c.PREDICT.INPAINT_WEIGHTS = "/cfg/path"
    monkeypatch.setenv("PREDICT_INPAINT_WEIGHTS", "/env/path")
    assert engines.resolve_inpaint_weights("/explicit", cfg) == "/explicit"
    assert engines.resolve_inpaint_weights(None, cfg) == "/cfg/path"
    cfg.PREDICT.INPAINT_WEIGHTS = None
    assert engines.resolve_inpaint_weights(None, cfg) == "/env/path"
    assert shipping.resolve("inpaint", jcfg) == \
        jshipping.resolve("inpaint", jcfg) == "/cfg/path"


def test_resolve_defaults_only_if_on_disk(tmp_path, monkeypatch):
    """A default path comes back only if it exists; the legacy orbax
    directory weights/lama_ffc is found after the shipped .npz. Segmentation
    weights resolve from the config's arch, and not without a config."""
    monkeypatch.delenv("PREDICT_INPAINT_WEIGHTS", raising=False)
    monkeypatch.delenv("PREDICT_SEG_WEIGHTS", raising=False)
    cfg = get_cfg_defaults()
    assert shipping.resolve("seg", cfg) == str(
        WEIGHTS_DIR / "seg_unetplusplus_resnet34.npz")
    assert shipping.resolve("seg") is None
    monkeypatch.setattr(shipping, "WEIGHTS_DIR", tmp_path / "weights")
    monkeypatch.setattr(shipping, "REPO_ROOT", tmp_path)
    assert shipping.resolve("inpaint") is None
    assert shipping.resolve("seg", cfg) is None
    (tmp_path / "models" / "lama_ffc").mkdir(parents=True)
    assert shipping.resolve("inpaint") == str(tmp_path / "models" /
                                              "lama_ffc")
    (tmp_path / "weights" / "lama_ffc").mkdir(parents=True)
    assert shipping.resolve("inpaint") == str(tmp_path / "weights" /
                                              "lama_ffc")
    # the diffusion kind as JAX resolves it, in the same directories
    monkeypatch.delenv("DIFFUSION_WEIGHTS", raising=False)
    monkeypatch.setattr(jshipping, "weights_dir",
                        lambda: str(tmp_path / "weights"))
    monkeypatch.setattr(jshipping, "_repo_root", lambda: str(tmp_path))
    assert shipping.resolve("diffusion") is None
    assert jshipping.resolve("diffusion") is None
    (tmp_path / "models" / "latent_diffusion").mkdir(parents=True)
    assert shipping.resolve("diffusion") == jshipping.resolve(
        "diffusion") == str(tmp_path / "models" / "latent_diffusion")
    (tmp_path / "weights" / "latent_diffusion.npz").write_bytes(b"")
    assert shipping.resolve("diffusion") == jshipping.resolve(
        "diffusion") == str(tmp_path / "weights" / "latent_diffusion.npz")
    with pytest.raises(ValueError, match="unknown weights kind"):
        shipping.resolve("sd3")


@pytest.mark.parametrize("variant", ["lama", "big-lama", "mat"])
def test_load_lama_finds_the_matching_variant(variant):
    """The 9-block weights serve every LaMa engine name, as in JAX."""
    model, cand = engines.load_lama(LAMA, variant, "cpu", torch.float32)
    assert cand == "lama" and len(model.blocks) == 9
    assert not model.training
    assert model.head.weight.dtype == torch.float32


def test_load_lama_returns_none_on_foreign_weights(caplog):
    seg = WEIGHTS_DIR / "seg_unet_resnet34.npz"
    with caplog.at_level(logging.WARNING):
        assert engines.load_lama(seg, device="cpu") == (None, None)
    assert "matches no lama variant" in caplog.text


def test_load_lama_defaults_to_the_card():
    """load_lama(path) with no device builds on "cuda", as every other entry
    point does: without a card it raises instead of building on the CPU
    (the parent defaulted to "cpu", ROADMAP.md §C.4)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engines.load_lama(LAMA)


def test_get_engine_lama_and_pushpull(generator32, monkeypatch):
    """'lama' runs the bf16 generator (its output within the bf16
    tolerance of the float32 one on hole pixels: observed max 8.6e-4);
    'pushpull', 'fast' and 'telea' are push-pull with 64 sweeps, and
    'lama' falls back to it, with a warning, when no weights exist; each
    engine's .name says which fill it runs."""
    monkeypatch.delenv("PREDICT_INPAINT_WEIGHTS", raising=False)
    img, mask = _batch(np.random.default_rng(3), 2, 64)
    lama = engines.get_engine("lama", device="cpu")
    assert lama.name == "ffc-lama"
    out = lama(img, mask)
    with torch.inference_mode():
        ref = generator32(torch.from_numpy(img), torch.from_numpy(mask))
    assert out.dtype == torch.float32
    hole = np.broadcast_to(mask > 0, img.shape)
    assert np.abs(out.numpy() - ref.numpy())[hole].max() <= 5e-3
    np.testing.assert_array_equal(out.numpy()[~hole], img[~hole])
    pushpull = inpaint_pushpull(torch.from_numpy(img), torch.from_numpy(mask),
                                smooth_iterations=64)
    for name in ("pushpull", "fast", "telea", "PushPull", None):
        engine = engines.get_engine(name, device="cpu")
        assert engine.name == "pushpull"
        np.testing.assert_array_equal(engine(img, mask).numpy(),
                                      pushpull.numpy())
    fallback = engines.get_engine("lama", "/no/such/weights.npz",
                                  device="cpu")
    assert fallback.name == "pushpull"
    np.testing.assert_array_equal(fallback(img, mask).numpy(),
                                  pushpull.numpy())


def test_get_engine_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """A torch checkpoint JAX would import raises NotImplementedError
    naming ROADMAP.md: never a silent push-pull. The three diffusion names
    give the latent-diffusion engine with the shipped weights."""
    ckpt = tmp_path / "big-lama.ckpt"
    ckpt.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        engines.get_engine("big-lama", str(ckpt), device="cpu")
    monkeypatch.delenv("DIFFUSION_WEIGHTS", raising=False)
    for name in ("diffusion", "latent-diffusion", "ld"):
        assert engines.get_engine(name, device="cpu").name == \
            "latent-diffusion"
    with pytest.raises(ValueError, match="unknown inpaint engine"):
        engines.get_engine("photoshop", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engines.get_engine("lama")
