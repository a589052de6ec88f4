""".pth checkpoints between the port (models/torch_import.py) and the JAX
package: files written by either package read in the other, the smp-layout
UNet++ of the reference's checkpoints (the torch mirror of
tests/test_smp_interop.py), the predictor's auto-detection, the model
selector on .pth files and the best-model export of train().

Tolerances: logits within test_torch_models.LOGIT_ATOL of JAX's (float32
on the CPU, other summation orders); weights that only change format
(a .pth written from the shipped .npz) are compared exactly; masks of the
smp mirror agree on at least 99.9 % of the pixels away from the
threshold's knife edge, as JAX's own interop test holds them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_smp_interop import _randomized_reference_pth
from test_torch_model_selector import RATIO_TOL, setup  # noqa: F401
from test_torch_model_selector import _cfgs as selector_cfgs
from test_torch_models import LOGIT_ATOL, _jax_variables
from unet_watermark_tpu.models import SMPModelFactory
from unet_watermark_tpu.models import init_model as jax_init_model
from unet_watermark_tpu.models import torch_import as jti
from unet_watermark_tpu.utils import shipping as jship
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
from unet_watermark_tpu_torch.models import create_model_from_config
from unet_watermark_tpu_torch.models import torch_import as pti
from unet_watermark_tpu_torch.models.convert import load_flax_weights
from unet_watermark_tpu_torch.models.factory import init_model
from unet_watermark_tpu_torch.models.unet import SMPUnetPlusPlusDecoder
from unet_watermark_tpu_torch.scripts import model_selector as pms
from unet_watermark_tpu_torch.training import train as ttrain
from unet_watermark_tpu_torch.utils.shipping import load_npz, seg_weights_path
from unet_watermark_tpu_torch.utils.synthetic import (watermarked_images,
                                                      write_training_folder)

torch.set_num_threads(2)

ARCHS = ["Unet", "UnetPlusPlus"]


def _port_cfg(arch, impl="canonical"):
    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.MODEL.DTYPE = arch, "float32"
    cfg.MODEL.DECODER_IMPL = impl
    cfg.DATA.IMG_SIZE = 64
    return cfg


def _jax_model(arch, impl="canonical"):
    return SMPModelFactory.create_model(
        model_name=arch, encoder_name="resnet34", dtype=jnp.float32,
        decoder_impl=impl)


def _inputs(seed=3):
    images, _ = watermarked_images(2, 64, seed=seed)
    return ((images - 0.45) / 0.225).astype(np.float32)


def _jax_logits(model, variables, x):
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_pth_loads_in_the_port(tmp_path, arch):
    """JAX's export_pth of the shipped weights imports into the port with
    JAX's report (every tensor loaded, none missing or unused) and gives
    JAX's logits."""
    v = _jax_variables(seg_weights_path(arch, "resnet34"))
    path = str(tmp_path / "jax.pth")
    jti.export_pth(path, None, v["params"], v["batch_stats"], epoch=7,
                   best_val_loss=0.5)
    jmodel = _jax_model(arch)
    _, jreport = jti.import_pth(path, jax_init_model(jmodel, 64, seed=0))
    model = init_model(create_model_from_config(_port_cfg(arch)), 1)
    model, report = pti.import_pth(path, model.eval())
    assert report["missing"] == jreport["missing"] == []
    assert report["unused"] == jreport["unused"] == []
    assert sorted(report["loaded"]) == sorted(jreport["loaded"])
    x = _inputs()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_logits(jmodel, v, x), rtol=0,
                               atol=LOGIT_ATOL)
    _, meta = pti.read_pth(path)
    assert meta == {"epoch": 7, "val_loss": 0.5}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_pth_loads_in_jax(tmp_path, arch):
    """The port's export_pth of the shipped weights imports into JAX's
    model with 0 missing and 0 unused, every array equal to JAX's own load
    of the .npz; the payload carries JAX's keys and framework tag."""
    path = seg_weights_path(arch, "resnet34")
    model = create_model_from_config(_port_cfg(arch))
    load_flax_weights(model, load_npz(path))
    out = str(tmp_path / "port.pth")
    pti.export_pth(out, _port_cfg(arch), model, epoch=3, best_val_loss=0.25,
                   history={"val_loss": [0.25]})
    payload = torch.load(out, weights_only=False)
    assert sorted(payload) == ["best_val_loss", "config", "epoch",
                               "framework", "history", "model_state_dict"]
    assert payload["framework"] == "unet_watermark_tpu"
    assert all(t.dtype == torch.float32
               for t in payload["model_state_dict"].values())
    jmodel = _jax_model(arch)
    imported, report = jti.import_pth(out, jax_init_model(jmodel, 64))
    assert report["missing"] == [] and report["unused"] == []
    want = jship.flatten_tree(_jax_variables(path))
    got = jship.flatten_tree({"params": imported["params"],
                              "batch_stats": imported["batch_stats"]})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_detect_decoder_impl_agrees_with_jax(tmp_path):
    _, smp_path = _randomized_reference_pth(tmp_path)
    canon = str(tmp_path / "canon.pth")
    v = _jax_variables(seg_weights_path("UnetPlusPlus", "resnet34"))
    jti.export_pth(canon, None, v["params"], v["batch_stats"])
    for path, impl in ((smp_path, "smp"), (canon, "canonical")):
        sd = pti.load_pth(path)
        assert pti.detect_decoder_impl(sd) == \
            jti.detect_decoder_impl(jti.load_pth(path)) == impl
    for sd in ({"decoder.blocks.x_0_0.conv1.0.weight": 0},
               {"decoder.block0.conv1.conv.weight": 0}, {}):
        assert pti.detect_decoder_impl(sd) == jti.detect_decoder_impl(sd)


@pytest.mark.parametrize("shape", ["model_state_dict", "state_dict", "bare",
                                   "module."])
def test_file_shapes_and_module_prefix(tmp_path, shape):
    """The three shapes of file JAX reads, and nn.DataParallel's prefix:
    the port's load_pth gives JAX's names and arrays."""
    g = torch.Generator().manual_seed(0)
    sd = {"encoder.conv1.weight": torch.randn(4, 3, 3, 3, generator=g),
          "encoder.bn1.running_var": torch.rand(4, generator=g),
          "encoder.bn1.num_batches_tracked": torch.tensor(5)}
    if shape == "module.":
        obj = {"module." + k: t for k, t in sd.items()}
    elif shape == "bare":
        obj = sd
    else:
        obj = {shape: sd, "epoch": 1}
    path = str(tmp_path / "f.pth")
    torch.save(obj, path)
    got, want = pti.load_pth(path), jti.load_pth(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], want[k])


def test_smp_mirror_imports_and_matches_jax(tmp_path):
    """The reference-layout mirror's .pth imports into the port's smp
    decoder with nothing missing or unused (JAX's list); the logits match
    JAX's SMPModelFactory import and the masks agree."""
    _, path = _randomized_reference_pth(tmp_path)
    jmodel = _jax_model("UnetPlusPlus", "smp")
    jv, jreport = jti.import_pth(path, jax_init_model(jmodel, 64, seed=9))
    model = init_model(create_model_from_config(
        _port_cfg("UnetPlusPlus", "smp")), 0).eval()
    assert isinstance(model.decoder, SMPUnetPlusPlusDecoder)
    model, report = pti.import_pth(path, model)
    assert report["unused"] == jreport["unused"] == []
    assert report["missing"] == jreport["missing"] == []
    assert sorted(report["loaded"]) == sorted(jreport["loaded"])
    for seed in (0, 1):
        x = np.random.default_rng(seed).standard_normal(
            (2, 64, 64, 3)).astype(np.float32) * 0.5
        want = _jax_logits(jmodel, jv, x)
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
        decisive = np.abs(want) > 1e-3
        assert decisive.mean() > 0.999
        assert ((got > 0) == (want > 0))[decisive].mean() >= 0.999


def test_predictor_autodetects_smp_checkpoint(tmp_path):
    """As JAX's test of the same name: the predictor rebuilds the model
    with the smp decoder for a reference .pth, reports its epoch and loss,
    and its masks are those of the JAX predictor's model."""
    _, path = _randomized_reference_pth(tmp_path)
    cfg = _port_cfg("UnetPlusPlus")
    pred = WatermarkPredictor(cfg, weights_path=path, device="cpu")
    assert pred.cfg.MODEL.DECODER_IMPL == "smp"
    assert isinstance(pred.model.decoder, SMPUnetPlusPlusDecoder)
    assert pred.model_info == {"epoch": 42, "val_loss": 0.123}
    x = np.random.default_rng(0).random((1, 64, 64, 3)).astype(np.float32)
    probs = pred._forward_probs(torch.from_numpy(x)).numpy()
    jmodel = _jax_model("UnetPlusPlus", "smp")
    jv, _ = jti.import_pth(path, jax_init_model(jmodel, 64, seed=9))
    norm = (x - np.float32([0.485, 0.456, 0.406])) / \
        np.float32([0.229, 0.224, 0.225])
    want = jax.nn.sigmoid(_jax_logits(jmodel, jv, norm))[..., 0]
    assert probs.shape == (1, 64, 64) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs, np.asarray(want), atol=1e-4)


def test_model_selector_scores_pth_files_as_jax(setup, tmp_path):  # noqa
    """The port's selector lists the .pth files JAX's selector reads and
    scores them as JAX does: the same names, detection rates, best model
    and per-image ratios within RATIO_TOL."""
    from unet_watermark_tpu.scripts.model_selector import ModelSelector

    root, _, _ = setup
    jcfg, pcfg = selector_cfgs()
    models = str(root / "jax_models")
    jres = ModelSelector(models, str(root / "images"), str(tmp_path / "j"),
                         config=jcfg, num_images=4).run_evaluation()
    psel = pms.ModelSelector(models, str(root / "images"),
                             str(tmp_path / "p"), config=pcfg, num_images=4,
                             device="cpu")
    assert [p.rsplit("/", 1)[-1] for p in psel.discover_checkpoints()] == \
        ["m0.pth", "m1.pth"]
    pres = psel.run_evaluation()
    assert pres["summary"]["best_detection_model"]["name"] == \
        jres["summary"]["best_detection_model"]["name"]
    for name in ("m0.pth", "m1.pth"):
        js, ps = jres["models"][name], pres["models"][name]
        assert ps["statistics"]["detection_rate"] == \
            js["statistics"]["detection_rate"]
        for jp, pp in zip(js["predictions"], ps["predictions"]):
            assert abs(jp["metrics"]["watermark_ratio"]
                       - pp["metrics"]["watermark_ratio"]) <= RATIO_TOL


def test_train_best_save_writes_a_pth_jax_reads(tmp_path):
    """train()'s best save writes the reference's .pth at MODEL_SAVE_PATH
    (beside the shipped-format .npz); JAX imports it completely and its
    arrays are the best checkpoint's."""
    from unet_watermark_tpu_torch.utils.shipping import load_variables

    data = tmp_path / "data"
    write_training_folder(data, 8, 64, seed=2, masks=4)
    cfg = _port_cfg("Unet")
    cfg.DATA.ROOT_DIR = str(data)
    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.EPOCHS = 4, 1
    cfg.TRAIN.CHECKPOINT_DIR = str(tmp_path / "ck")
    cfg.TRAIN.OUTPUT_DIR = str(tmp_path / "out")
    cfg.TRAIN.MODEL_SAVE_PATH = str(tmp_path / "models" / "m.pth")
    result = ttrain.train(cfg, device="cpu", max_steps_per_epoch=1)
    assert (tmp_path / "models" / "seg_unet_resnet34.npz").exists()
    payload = torch.load(cfg.TRAIN.MODEL_SAVE_PATH, weights_only=False)
    assert payload["epoch"] == 1 and payload["framework"] == \
        "unet_watermark_tpu"
    assert payload["best_val_loss"] == result["best_val_loss"]
    jmodel = _jax_model("Unet")
    imported, report = jti.import_pth(cfg.TRAIN.MODEL_SAVE_PATH,
                                      jax_init_model(jmodel, 64))
    assert report["missing"] == [] and report["unused"] == []
    best = load_variables(result["best_checkpoint"])
    got = jship.flatten_tree({"params": imported["params"],
                              "batch_stats": imported["batch_stats"]})
    assert sorted(got) == sorted(best)
    for k in best:
        np.testing.assert_array_equal(np.asarray(got[k]), best[k],
                                      err_msg=k)
