"""The text trainer (text/train_text_watermark.py) and the text config's
repair command against the JAX package's, on the CPU at 64²:

  - the trainer's CLI generates its text-heavy data (text 0.7 / mixed 0.3)
    and takes one step with the shipped text config (UNet++ on
    efficientnet-b3, CombinedLoss, AdamW, the text_watermark policy) cut
    to 64² in float32; its result and printed keys are JAX's trainer's on
    the same folder (JAX's model cut to a narrow Unet/resnet18, whose
    compile takes seconds, not minutes: the keys do not depend on it);
  - evaluate_methods writes the three masks and the grid;
  - `repair -c unet_text_watermark.yaml` (MULTI_SCALE_TEST,
    EDGE_REFINEMENT, CONNECTIVITY_CHECK and THRESHOLD 0.4 as shipped;
    DATA.IMG_SIZE 64 and float32 through --opts, push-pull fills) with a
    seeded text model gives the JAX CLI's summary, step-1 masks and final
    masks.
"""
import ast
import contextlib
import importlib
import io
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_zoo import _randomize
from unet_watermark_tpu import cli as jax_cli
from unet_watermark_tpu.inference.predict import \
    WatermarkPredictor as JaxPredictor
from unet_watermark_tpu.models import create_model_from_config as jax_model
from unet_watermark_tpu.models import init_model as jax_init_model
from unet_watermark_tpu.utils.shipping import load_params_npz
from unet_watermark_tpu_torch import cli
from unet_watermark_tpu_torch.configs import get_cfg_defaults, update_config
from unet_watermark_tpu_torch.models import create_model_from_config
from unet_watermark_tpu_torch.models.convert import to_flax
from unet_watermark_tpu_torch.text import TextWatermarkTrainer
from unet_watermark_tpu_torch.text import train_text_watermark as ttw
from unet_watermark_tpu_torch.utils import image_io
from unet_watermark_tpu_torch.utils.shipping import save_params_npz
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

jtext = importlib.import_module("unet_watermark_tpu.text.train_text_watermark")
jtrain = importlib.import_module("unet_watermark_tpu.training.train")

torch.set_num_threads(2)

SIZE = 64
TEXT_YAML = Path(ttw.TEXT_CONFIG)
# 8 samples: 6 train (one step at the config's batch 6) and 2 val
SAMPLES = 8


def _small_yaml(tmp: Path, name: str, extra: str = "") -> Path:
    """The shipped text config at 64² in float32, its outputs under tmp."""
    src = TEXT_YAML.read_text().replace("IMG_SIZE: 512", f"IMG_SIZE: {SIZE}")
    src = src.replace('DTYPE: "bfloat16"', 'DTYPE: "float32"')
    src = src.replace('MODEL_SAVE_PATH: "models/unet_text_watermark.pth"',
                      f'MODEL_SAVE_PATH: "{tmp / name / "m.pth"}"\n'
                      f'  CHECKPOINT_DIR: "{tmp / name / "ckpt"}"')
    path = tmp / f"{name}.yaml"
    path.write_text(src.replace("MODEL:\n", "MODEL:\n" + extra, 1))
    return path


def _one_device_mesh(cfg):
    from unet_watermark_tpu.parallel import make_mesh

    return make_mesh(devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def clean_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("text_clean")
    imgs, _ = watermarked_images(4, 96, seed=31, clean=4)
    for i, im in enumerate(imgs):
        image_io.write_png(d / f"c{i}.png",
                           np.rint(im * 255).astype(np.uint8))
    return d


def test_trainer_cli_takes_a_step_with_jax_keys(clean_dir, tmp_path,
                                                monkeypatch):
    data = tmp_path / "data"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = ttw.main(["--config", str(_small_yaml(tmp_path, "port")),
                           "--data-root", str(data), "--clean-dir",
                           str(clean_dir), "--samples", str(SAMPLES),
                           "--epochs", "1", "--output-dir",
                           str(tmp_path / "logs"), "--device", "cpu"])
    printed = [ast.literal_eval(line)
               for line in out.getvalue().splitlines()]
    counts, summary = printed
    assert counts["text"] + counts["mixed"] == SAMPLES
    assert counts["logo"] == counts["multi"] == 0
    assert len(os.listdir(data / "watermarked")) == SAMPLES
    assert result["epochs_run"] == 1 and np.isfinite(result["best_val_loss"])
    assert (tmp_path / "port" / "m.pth").exists()
    assert (tmp_path / "port" / "seg_unetplusplus_efficientnet-b3.npz"
            ).exists()
    # JAX's trainer on the same folder, for no epoch: its result's keys
    # do not depend on the steps (a JAX step of this model compiles for
    # minutes on the CPU)
    monkeypatch.setattr(jtrain, "mesh_from_config", _one_device_mesh)
    monkeypatch.setattr(jtrain, "init_model", lambda model, size, seed=0:
                        jax.eval_shape(lambda: jax_init_model(model, size,
                                                              seed)))
    jt = jtext.TextWatermarkTrainer(
        config_path=str(_small_yaml(tmp_path, "jax")), data_root=str(data),
        output_dir=str(tmp_path / "jlogs"))
    jres = jt.train(epochs=0)
    assert set(result) == set(jres)
    assert set(result["history"]) == set(jres["history"])
    assert set(summary) == {"best_val_loss", "epochs_run"}
    # the trainer's config is the shipped one but for what the copy cut
    cfg = TextWatermarkTrainer(device="cpu").cfg
    jcfg = jtext.TextWatermarkTrainer().cfg
    assert (cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME, cfg.LOSS.NAME,
            cfg.OPTIMIZER.NAME, cfg.OPTIMIZER.LR_SCHEDULER,
            cfg.DATA.AUGMENTATION_TYPE, cfg.TRAIN.OUTPUT_DIR) == (
        jcfg.MODEL.NAME, jcfg.MODEL.ENCODER_NAME, jcfg.LOSS.NAME,
        jcfg.OPTIMIZER.NAME, jcfg.OPTIMIZER.LR_SCHEDULER,
        jcfg.DATA.AUGMENTATION_TYPE, jcfg.TRAIN.OUTPUT_DIR)


# ---------------------------------------------------------------------------
# the text config's repair command
# ---------------------------------------------------------------------------
FOLDER = (("a", 64, 64, 20), ("b", 80, 96, 106), ("c", 100, 70, 22),
          ("d", 72, 72, None))


@pytest.fixture(scope="module")
def text_model(tmp_path_factory):
    """A seeded text model (UNet++/efficientnet-b3) as a shipped-format
    .npz, its head's bias set so that about a third of the folder's
    pixels pass THRESHOLD 0.4, and the folder."""
    root = tmp_path_factory.mktemp("text_repair")
    folder = root / "in"
    folder.mkdir()
    for name, h, w, seed in FOLDER:
        img = watermarked_images(1, max(h, w), seed=seed or 0,
                                 clean=0 if seed else 1)[0][0, :h, :w]
        image_io.write_png(folder / f"{name}.png",
                           np.rint(img * 255).astype(np.uint8))
    cfg = get_cfg_defaults()
    update_config(cfg, TEXT_YAML)
    cfg.DATA.IMG_SIZE = SIZE
    model = _randomize(create_model_from_config(cfg), 12).eval()
    x = watermarked_images(4, SIZE, seed=40)[0]
    with torch.no_grad():
        logits = model(torch.from_numpy(((x - 0.45) / 0.225).astype(
            np.float32)))
        bias = model.segmentation_head[0].bias
        bias -= float(torch.quantile(logits, 0.66)) - float(
            np.log(0.4 / 0.6))
    npz = root / "text_model.npz"
    save_params_npz(str(npz), to_flax(model))
    return folder, npz


def _jax_text_predictor(config, npz):
    """The JAX predictor of the text config without its eager init (as
    tests/test_torch_repair.py assembles one): the plain decoder (the same
    function as the fused one), the weights from the .npz, the forward
    jitted with the weights as arguments."""
    config.MODEL.FUSED_DECODER = False
    model = jax_model(config)
    tree = {}
    with np.load(npz) as z:
        for k in z.files:
            parts = k.split("::", 1)[-1].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.zeros(z[k].shape, np.float32)
    pred = JaxPredictor.__new__(JaxPredictor)
    pred.cfg = config
    pred.model = model
    pred.variables = load_params_npz(str(npz), tree)
    pred._quant_scales = None
    jitted = jax.jit(lambda v, x: model.apply(v, x, train=False))
    pred._forward = lambda x: jitted(pred.variables, x)
    pred.img_size = config.DATA.IMG_SIZE
    pred._engine_name = None
    pred.device = "cpu"
    return pred


def test_repair_with_the_text_config_equals_jax(text_model, tmp_path,
                                                monkeypatch):
    folder, npz = text_model
    args = ["repair", "-c", str(TEXT_YAML), "--model", str(npz), "--input",
            str(folder), "--no-ocr", "--watermark-model", "telea",
            "--device", "cpu", "--opts", "DATA.IMG_SIZE", str(SIZE),
            "MODEL.DTYPE", "float32"]
    jargs = jax_cli.build_parser().parse_args(
        args[:1] + ["--output", str(tmp_path / "j")] + args[1:])
    monkeypatch.setattr("unet_watermark_tpu.inference.WatermarkPredictor",
                        lambda model_path=None, config=None:
                        _jax_text_predictor(config, npz))
    assert jax_cli.repair_command(jargs) == 0
    assert cli.main(args[:1] + ["--output", str(tmp_path / "t")]
                    + args[1:]) == 0
    j = json.loads((tmp_path / "j" / "repair_summary.json").read_text())
    t = json.loads((tmp_path / "t" / "repair_summary.json").read_text())
    for key in ("processing_time", "avg_processing_time_per_image",
                "engine_failures", "engine_used", "ocr_engine_used",
                "ocr_failures"):
        t.pop(key, None), j.pop(key, None)
    assert t == j and t["status"] == "success"
    seen = 0
    for sub in ("step1_masks", "masks"):
        names = sorted(os.listdir(tmp_path / "t" / sub))
        assert names == sorted(os.listdir(tmp_path / "j" / sub))
        for n in names:
            got = image_io.read_gray(tmp_path / "t" / sub / n)
            want = image_io.read_gray(tmp_path / "j" / sub / n)
            np.testing.assert_array_equal(got, want, err_msg=f"{sub}/{n}")
            seen += int(0 < (got > 0).mean() < 1)
    assert seen >= 2  # masks that are neither empty nor full
    # evaluate_methods on one of the files with the same model
    trainer = TextWatermarkTrainer(str(TEXT_YAML), device="cpu")
    trainer.cfg.DATA.IMG_SIZE = SIZE
    trainer.cfg.MODEL.DTYPE = "float32"
    res = trainer.evaluate_methods(str(folder / "b.png"),
                                   str(tmp_path / "eval"), str(npz))
    h, w = 80, 96
    for method in ("watermark", "text", "mixed"):
        m = image_io.read_gray(res[method]["mask_path"])
        assert m.shape == (h, w)
        assert res[method]["coverage"] == float((m > 0).mean())
    grid = image_io.read_rgb(res["grid"])
    assert grid.shape == (h, 4 * w, 3)
    np.testing.assert_array_equal(grid[:, :w],
                                  image_io.read_rgb(folder / "b.png"))
