"""The public big-lama checkpoint in the port (models/lama_import.py,
inference/engines.load_lama) against the JAX package's importer: the
seeded torch twin of tests/test_lama_import.py (ngf 16, 2 blocks) imported
by both packages, the full 18-block key set, the prefixes a checkpoint
carries, and the engine registry's route and "no engine" result.

Tolerance: the twin's output within TWIN_ATOL of JAX's. Both run float32
on the CPU; the port's spectral unit is torch.fft, JAX's the dense DFT
matmuls, so the sums differ in order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_lama_import import (TwinWrapper, _randomize, build_torch_twin,
                              synthetic_big_lama_sd)
from unet_watermark_tpu.inference import engines as jengines
from unet_watermark_tpu.models import lama_import as jli
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.inference import engines
from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
from unet_watermark_tpu_torch.models import lama_import as pli

torch.set_num_threads(2)

TWIN_ATOL = 1e-5


def _twin(seed=7):
    twin = TwinWrapper(build_torch_twin(ngf=16, n_blocks=2))
    _randomize(twin, seed=seed)
    return twin.eval()


def test_twin_matches_jax():
    twin = _twin()
    rng = np.random.default_rng(5)
    img = rng.random((2, 64, 64, 3)).astype(np.float32)
    mask = (rng.random((2, 64, 64, 1)) > 0.8).astype(np.float32)
    sd = {k: v.numpy() for k, v in twin.state_dict().items()}
    jmodel = jli.BigLamaGenerator(ngf=16, n_blocks=2)
    jv, jreport = jli.import_big_lama(
        sd, jli.init_big_lama(jmodel, img_size=64), n_blocks=2)
    want = np.asarray(jmodel.apply(jv, jnp.asarray(img), jnp.asarray(mask),
                                   train=False))
    model = pli.BigLamaGenerator(ngf=16, n_blocks=2)
    report = pli.import_big_lama(sd, model)
    assert report["missing"] == jreport["missing"] == []
    assert report["unused"] == jreport["unused"] == []
    assert sorted(report["loaded"]) == sorted(jreport["loaded"])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TWIN_ATOL)
    keep = mask[..., 0] == 0  # known pixels pass through
    np.testing.assert_array_equal(got.numpy()[keep], img[keep])


def test_full_key_set_equals_jax_mapping():
    """The 18-block generator's state_dict is the set of names JAX's
    _torch_lama_name gives its flax tree, each with the shape of the
    flax array in torch's layout (conv OIHW, ConvTranspose2d (in, out,
    kh, kw)); the port has 50 975 875 parameters and 81 152 statistics."""
    jmodel = jli.BigLamaGenerator()
    template = jax.eval_shape(lambda: jli.init_big_lama(jmodel, 64))
    ct = jli._conv_transpose_indices()
    want = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jli._flatten(template[coll]).items():
            shape = tuple(leaf.shape)
            if len(shape) == 4:
                is_ct = int(path[0].split("_")[1]) in ct
                shape = ((shape[2], shape[3], shape[0], shape[1]) if is_ct
                         else (shape[3], shape[2], shape[0], shape[1]))
            want[jli._torch_lama_name(path, coll)] = shape
    model = pli.BigLamaGenerator()
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == 50_975_875
    assert sum(v.numel() for k, v in model.state_dict().items()
               if "running" in k) == 81_152
    report = pli.import_big_lama(synthetic_big_lama_sd(), model)
    assert len(report["loaded"]) == len(want)
    assert report["missing"] == [] and report["unused"] == []


def test_normalize_state_dict_prefixes():
    sd = {"generator.model.1.ffc.convl2l.weight": 1,
          "module.generator.model.34.bias": 2,
          "module.model.5.conv1.bn_l.weight": 3,
          "model.34.weight": 4,
          "discriminator.model0.0.weight": 5,
          "loss_resnet_pl.impl.conv1.weight": 6,
          "val_evaluator.scores.ssim": 7}
    assert pli.normalize_state_dict(sd) == jli.normalize_state_dict(sd)
    assert sorted(pli.normalize_state_dict(sd)) == [
        "model.1.ffc.convl2l.weight", "model.34.bias", "model.34.weight",
        "model.5.conv1.bn_l.weight"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A saicinpainting-style best.ckpt of the public shapes (zeros, as
    JAX's contract test builds them) with one discriminator tensor."""
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          synthetic_big_lama_sd("generator.").items()}
    sd["discriminator.model0.0.weight"] = torch.zeros(64, 3, 4, 4)
    path = tmp_path_factory.mktemp("biglama") / "best.ckpt"
    torch.save({"state_dict": sd, "epoch": 1}, str(path))
    return str(path)


def test_load_lama_routes_torch_checkpoints(ckpt, tmp_path):
    """A .ckpt goes to big-lama (float32, "big-lama-torch", the fused fn's
    engine_used "ffc-big-lama-torch" as JAX names it); a file that is not
    a big-lama generator gives JAX's "no engine" result."""
    model, name = engines.load_lama(ckpt, "big-lama", device="cpu")
    jm, jv, jname = jengines.load_lama_variables(ckpt, "big-lama")
    assert name == jname == "big-lama-torch"
    assert isinstance(model, pli.BigLamaGenerator)
    assert next(model.parameters()).dtype == torch.float32
    assert engines.get_engine("lama", ckpt, device="cpu").name == \
        "ffc-big-lama-torch"
    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.MODEL.DTYPE = "Unet", "float32"
    cfg.DATA.IMG_SIZE = 64
    cfg.PREDICT.INPAINT_WEIGHTS = ckpt
    fused = WatermarkPredictor(cfg, device="cpu").make_fused_repair_fn()
    assert fused.engine_used == f"ffc-{jname}"
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    out, mask = fused(x)
    assert out.shape == x.shape and torch.isfinite(out).all()
    keep = mask == 0
    assert torch.equal(out[keep], x[keep])
    broken = tmp_path / "tiny.ckpt"
    torch.save({"state_dict": {"generator." + k: v for k, v in
                               _twin(3).state_dict().items()}}, str(broken))
    assert engines.load_lama(broken, device="cpu") == (None, None)
    assert jengines.load_lama_variables(str(broken)) == (None, None, None)
    assert engines.get_engine("big-lama", str(broken),
                              device="cpu").name == "pushpull"
    with pytest.raises(ValueError, match="big-lama generator layout"):
        pli.load_big_lama(broken, "cpu")
    if not torch.cuda.is_available():  # its default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pli.load_big_lama(ckpt)
