"""The port's `auto` loop (training/auto_train.py, cli.py auto) on the CPU,
mirroring the JAX package's tests/test_cli_scripts.py
test_auto_train_single_cycle: one cycle with held-out dirs set, small
config (Unet/resnet18, 64², float32, batch 4).

JAX's own cycle is compile-heavy on the CPU (its test is marked slow), so
the structure of cycle_0_info.json is held to JAX's by running JAX's
run_cycle on the port's step results (its six steps replaced by functions
returning them): the two files must have the same keys at every level.
Step 5's file names are held to JAX's step 5 on copies of one training
folder, and the `auto` parser to JAX's on the same flags.
"""
import json
import os
import shutil

import numpy as np
import pytest

from unet_watermark_tpu_torch import cli
from unet_watermark_tpu_torch.data.gen_data import generate_dataset
from unet_watermark_tpu_torch.utils import image_io, synthetic


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("ws")
    clean, logos, test_dir = (ws / "data" / d for d in ("clean", "logos",
                                                        "test"))
    for d in (clean, logos, test_dir):
        d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    imgs, _ = synthetic.watermarked_images(4, 96, seed=1, clean=4)
    for i in range(4):
        image_io.write_jpeg(clean / f"c{i}.jpg",
                            (imgs[i] * 220).astype(np.uint8))
    logo = np.zeros((24, 40, 4), np.uint8)
    logo[4:20, 4:36] = (250, 250, 250, 200)
    image_io.write_png(logos / "l0.png", logo)
    generate_dataset(str(clean), str(ws / "data" / "train"), str(logos),
                     count=12, seed=2, device="cpu")
    for i in range(3):
        image_io.write_jpeg(test_dir / f"t{i}.jpg", (rng.random(
            (96, 96, 3)) * 255).astype(np.uint8))
    return ws


def _cfg_file(ws):
    p = ws / "cfg.yaml"
    p.write_text(f"""
MODEL:
  NAME: "Unet"
  ENCODER_NAME: "resnet18"
  DTYPE: "float32"
DATA:
  ROOT_DIR: "{ws}/data/train"
  IMG_SIZE: 64
  NUM_WORKERS: 2
TRAIN:
  BATCH_SIZE: 4
  EPOCHS: 1
PREDICT:
  BATCH_SIZE: 4
""")
    return str(p)


AUTO_FLAGS = ["--max-cycles", "1", "--epochs", "1", "--batch-size", "4",
              "--output-dir", "auto_out", "--samples", "4",
              "--prediction-limit", "2", "--learning-rate", "0.002",
              "--transparent-ratio", "0.5", "--text-watermark-ratio", "0.4",
              "--mixed-watermark-ratio", "0.1"]


def _keys(x):
    """The nested key structure of a JSON value."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    return type(x).__name__ if x is None else "value"


def test_one_cycle_through_the_cli(workspace, monkeypatch):
    """`auto` as users type it (plus --device cpu): the cycle succeeds, and
    cycle_0_info.json and final_report.json have JAX's structure."""
    from unet_watermark_tpu.training import auto_train as jat

    from unet_watermark_tpu_torch.training import auto_train as pat

    ws = workspace
    overrides = ws / "overrides.json"
    overrides.write_text(json.dumps({
        "inpaint_model": "pushpull", "generate_video": True,
        "heldout_eval_dir": str(ws / "data" / "train"),
        "heldout_eval_tex_dir": str(ws / "data" / "train"),
        "heldout_eval_limit": 2}))
    results = {}
    loops = []
    real = pat.AutoTrainingLoop

    class Recording(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            loops.append(self)

    for name in ("step1_model_selection", "step2_training",
                 "step3_prediction", "step4_video_generation",
                 "step5_data_augmentation", "step6_heldout_eval"):
        def wrap(fn, name=name):
            def f(self, *a):
                results[name] = fn(self, *a)
                return results[name]
            return f
        setattr(Recording, name, wrap(getattr(real, name)))
    monkeypatch.setattr(pat, "AutoTrainingLoop", Recording)
    before = len(os.listdir(ws / "data" / "train" / "watermarked"))
    assert cli.main(["auto", "-c", _cfg_file(ws), "--project-root", str(ws),
                     "--device", "cpu", "--config-file", str(overrides)]
                    + AUTO_FLAGS) == 0
    out = ws / "auto_out"
    info = json.loads((out / "cycle_0_info.json").read_text())
    report = json.loads((out / "final_report.json").read_text())
    assert info["status"] == "success", info.get("error")
    assert report["cycles_completed"] == 1
    assert report["successful_cycles"] == 1
    loop = loops[0]
    assert loop.config.epochs_per_cycle == 1
    assert loop.config.heldout_eval_limit == 2
    steps = info["steps"]
    assert steps["model_selection"]["best_model"] is None  # no checkpoint
    assert steps["training"]["epochs_run"] >= 1
    assert steps["prediction"]["status"] == "success"
    assert steps["prediction"]["successful_images"] == 2
    assert os.path.getsize(steps["video"]["path"]) > 0
    gen = steps["data_augmentation"]["generated"]
    # max(int(12 * 0.2), 10) draws; a name the folder holds is skipped
    assert gen + steps["data_augmentation"]["skipped"] == 10 and gen > 0
    assert len(os.listdir(ws / "data" / "train" / "watermarked")) == \
        before + gen
    held = steps["heldout_eval"]
    assert held["error"] is None and held["n_images"] == 2
    for tier in ("smooth", "textured"):
        assert 0.0 <= held[tier]["raw"]["iou"] <= 1.0
        assert 0.0 <= held[tier]["pipeline"]["iou"] <= 1.0

    # JAX's run_cycle over the same step results
    jloop = jat.AutoTrainingLoop.__new__(jat.AutoTrainingLoop)
    jloop.output_dir = str(ws / "jax_out")
    os.makedirs(jloop.output_dir)
    for name, value in results.items():
        setattr(jloop, name, lambda *a, v=value: v)
    jinfo = jloop.run_cycle(0)
    jfile = json.loads((ws / "jax_out" / "cycle_0_info.json").read_text())
    assert jinfo["status"] == "success"
    assert _keys(info) == _keys(jfile)


def test_step5_names_equal_jax(workspace, tmp_path):
    """Step 5 of cycle 3 in both packages on copies of one training folder
    and the same clean and logo folders: the same new file names."""
    from unet_watermark_tpu.configs import get_cfg_defaults as jcfg
    from unet_watermark_tpu.training import auto_train as jat

    from unet_watermark_tpu_torch.configs import get_cfg_defaults as pcfg
    from unet_watermark_tpu_torch.training import auto_train as pat

    names = {}
    for tag, mod, cfg, kw in (("jax", jat, jcfg(), {}),
                              ("port", pat, pcfg(), {"device": "cpu"})):
        root = tmp_path / tag
        shutil.copytree(workspace / "data", root / "data")
        ac = mod.AutoTrainConfig(project_root=str(root), output_dir="o",
                                 text_watermark_ratio=0.3)
        loop = mod.AutoTrainingLoop(ac, base_cfg=cfg, **kw)
        before = set(os.listdir(root / "data" / "train" / "watermarked"))
        stats = loop.step5_data_augmentation(3)
        after = set(os.listdir(root / "data" / "train" / "watermarked"))
        names[tag] = (sorted(after - before), stats)
    assert names["port"] == names["jax"]
    new, stats = names["port"]
    assert len(new) == stats["generated"] > 0
    assert stats["generated"] + stats["skipped"] == 10


def test_auto_parser_takes_jax_flags(tmp_path):
    from unet_watermark_tpu import cli as jcli

    argv = ["auto", "--config-file", str(tmp_path / "o.json"), "-c", "x.yaml",
            "--project-root", str(tmp_path), "--device", "cpu"] + AUTO_FLAGS
    j = vars(jcli.build_parser().parse_args(argv))
    p = vars(cli.build_parser().parse_args(argv))
    p.pop("func")
    assert p == j
    defaults = vars(cli.build_parser().parse_args(["auto"]))
    jdefaults = vars(jcli.build_parser().parse_args(["auto"]))
    for key, value in jdefaults.items():
        if key not in ("device", "config"):
            assert defaults[key] == value, key
    assert defaults["device"] == "cuda"


def test_cuda_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["auto", "--project-root", str(tmp_path)])
    from unet_watermark_tpu_torch.training.auto_train import (
        AutoTrainConfig, AutoTrainingLoop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoTrainingLoop(AutoTrainConfig(project_root=str(tmp_path)))
