"""The port's train() against the JAX package's, on the CPU at 64²
(Unet/resnet34, float32; the steps themselves are held in
tests/test_torch_train.py):

  - a 2-epoch train() against JAX's on the same folder, from JAX's
    initial parameters, with the augmentation policy made all-zero in
    both packages through monkeypatch;
  - checkpoints (round trip, slim restore, an orbax directory), resume,
    --init-weights, the async saver, and the exported .npz in the
    predictor.
"""
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from unet_watermark_tpu.configs import get_cfg_defaults as jax_defaults
from unet_watermark_tpu.models import create_model_from_config as jax_model
from unet_watermark_tpu.models import init_model as jax_init_model
from unet_watermark_tpu.ops import augment as jaug
from unet_watermark_tpu.utils import shipping as jship
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.models.convert import to_flax
from unet_watermark_tpu_torch.models.factory import (create_model_from_config,
                                                     init_model)
from unet_watermark_tpu_torch.ops import augment as taug
from unet_watermark_tpu_torch.ops import losses as tlosses
from unet_watermark_tpu_torch.training import checkpoint as tck
from unet_watermark_tpu_torch.training import train as ttrain
from unet_watermark_tpu_torch.utils import shipping as tship
from unet_watermark_tpu_torch.utils.async_ckpt import AsyncSaver
from unet_watermark_tpu_torch.utils.synthetic import (watermarked_images,
                                                      write_training_folder)

# the module (the package's __init__ exports the function train)
jtrain = importlib.import_module("unet_watermark_tpu.training.train")

SIZE, BATCH = 64, 4
ZERO = dict(hflip_p=0.0, vflip_p=0.0, rot90_p=0.0, affine_p=0.0, bc_p=0.0,
            hsv_p=0.0, noise_p=0.0, blur_p=0.0, jpeg_p=0.0)


def _cfgs(tmp=None):
    out = []
    for c in (get_cfg_defaults(), jax_defaults()):
        c.MODEL.NAME, c.MODEL.ENCODER_NAME = "Unet", "resnet34"
        c.MODEL.DTYPE = "float32"
        c.DATA.IMG_SIZE = SIZE
        c.TRAIN.BATCH_SIZE = BATCH
        c.TRAIN.LR = 1e-3
        if tmp is not None:
            c.TRAIN.CHECKPOINT_DIR = str(tmp / "ckpt")
            c.TRAIN.OUTPUT_DIR = str(tmp / "out")
            c.TRAIN.MODEL_SAVE_PATH = str(tmp / "models" / "m.pth")
        out.append(c)
    return out


def _flat(variables) -> dict:
    return {k: np.array(v) for k, v in jship.flatten_tree(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}).items()}


def _batch(seed=0, valid=(1, 1, 1, 0)):
    images, logos = watermarked_images(BATCH, SIZE, seed=seed)
    return {"image": np.rint(images * 255).astype(np.uint8),
            "mask": logos.astype(np.uint8)[..., None],
            "valid": np.asarray(valid, np.float32)}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_folder")
    write_training_folder(root, 14, SIZE, seed=5, masks=7)
    return root


def _one_device_mesh(cfg):
    from unet_watermark_tpu.parallel import make_mesh

    return make_mesh(devices=jax.devices()[:1])


@pytest.mark.parametrize("device_cache", [True, False],
                         ids=["DEVICE_CACHE=True", "DEVICE_CACHE=False"])
def test_two_epochs_match_jax(folder, tmp_path, monkeypatch, device_cache):
    """train() for 2 epochs on the same folder (11 train, 3 val: a padded
    batch each epoch) from JAX's initial parameters, carried across as a
    float32 .npz (--init-weights), SGD at lr 1e-3 with clipping, no
    augmentation: the history's losses and metrics, and the final
    parameters and running statistics, agree. SGD keeps each update
    linear in its gradient (Adam's first steps are held in
    test_train_step_matches_jax). DATA.DEVICE_CACHE picks the pipeline in
    both packages: the card-resident one pads the short batch with
    sample 0, the host one with zero rows (ROADMAP.md §C.13), and the pad
    rows count in BatchNorm's statistics."""
    cfg, _ = _cfgs(tmp_path / "port")
    _, jcfg = _cfgs(tmp_path / "jax")
    for c, name in ((cfg, "port"), (jcfg, "jax")):
        c.DATA.DEVICE_CACHE = device_cache
        c.DATA.ROOT_DIR = str(folder)
        c.DATA.CACHE_DIR = str(tmp_path / name / "cache")
        c.TRAIN.EPOCHS = 2
        c.TRAIN.LOG_INTERVAL = 0
        c.OPTIMIZER.NAME = "SGD"
        c.TRAIN.LR = 1e-3
    jcfg.TRAIN.EPOCH_SCAN = False  # the per-step loop, one compiled step
    zero = dict(ZERO)
    monkeypatch.setitem(jaug.POLICIES, "transparent_watermark",
                        jaug.AugmentPolicy(**zero))
    monkeypatch.setitem(taug.POLICIES, "transparent_watermark",
                        taug.AugmentPolicy(**zero))
    monkeypatch.setattr(jtrain, "mesh_from_config", _one_device_mesh)
    # flax's init compiled (eager, it takes ~10 s a model on the CPU)
    jit_init = jax.jit(jax_init_model, static_argnums=(0, 1, 2))
    monkeypatch.setattr(jtrain, "init_model",
                        lambda model, size, seed=0: jit_init(model, size,
                                                             seed))
    init = tmp_path / "init.npz"
    variables = jit_init(jax_model(jcfg), SIZE, 11)
    jship.save_params_npz(str(init), {"params": variables["params"]},
                          dtype=None)

    jres = jtrain.train(jcfg, init_weights=str(init))
    tres = ttrain.train(cfg, init_weights=str(init), device="cpu")
    jh, th = jres["history"], tres["history"]
    assert tres["epochs_run"] == jres["epochs_run"] == 2
    assert th["lr"] == jh["lr"]
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(th[k], jh[k], rtol=2e-5, err_msg=k)
    for k in ("val_iou", "val_f1", "val_accuracy"):
        # pixel counts: a probability at 0.5 within rounding flips
        np.testing.assert_allclose(th[k], jh[k], rtol=2e-3, err_msg=k)
    want = _flat({"params": jres["state"].params,
                  "batch_stats": jres["state"].batch_stats})
    got = to_flax(tres["state"].model)
    for key in want:
        # this network's float32 gradients at init are ill-conditioned
        # (BatchNorm over few values: ~10 % of a layer's scale from a
        # float64 reference in the worst layer, in either package), so
        # six steps of lr 1e-3 leave the parameters ~2e-3 of their scale
        # apart at most
        scale = max(np.abs(want[key]).max(), 1e-3)
        assert np.abs(got[key] - want[key]).max() <= 5e-3 * scale, key
    # both wrote the same files
    for res, c in ((jres, jcfg), (tres, cfg)):
        assert os.path.exists(os.path.join(c.TRAIN.OUTPUT_DIR,
                                           "training_history.json"))
        assert os.path.exists(os.path.join(
            os.path.dirname(c.TRAIN.MODEL_SAVE_PATH),
            "seg_unet_resnet34.npz"))
        assert sorted(os.listdir(c.TRAIN.CHECKPOINT_DIR))[0] == "best_model"
    # the port's exported .npz loads in the JAX package
    template = {"params": jres["state"].params,
                "batch_stats": jres["state"].batch_stats}
    loaded = jship.load_params_npz(os.path.join(
        os.path.dirname(cfg.TRAIN.MODEL_SAVE_PATH), "seg_unet_resnet34.npz"),
        template)
    assert jax.tree_util.tree_structure(loaded) == \
        jax.tree_util.tree_structure(template)


# ---------------------------------------------------------------------------
# checkpoints, resume, the shipped .npz
# ---------------------------------------------------------------------------

def _stepped_state(cfg, seed=0):
    state = ttrain.create_train_state(cfg, seed=seed, device="cpu")
    step = ttrain.make_train_step(cfg, tlosses.get_loss_function(cfg),
                                  "basic", torch.Generator().manual_seed(0))
    step(state, {k: torch.from_numpy(v) for k, v in _batch().items()})
    return state


def test_checkpoint_round_trip_and_slim_restore(tmp_path):
    cfg, _ = _cfgs()
    state = _stepped_state(cfg)
    meta = {"epoch": 1, "best_val_loss": 0.5, "history": {"x": [1.0]}}
    path = tck.save_checkpoint(str(tmp_path), "checkpoint_epoch_1", state,
                               meta)
    fresh = ttrain.create_train_state(cfg, seed=9, device="cpu")
    restored, meta2 = tck.restore_checkpoint(path, fresh)
    assert meta2 == meta
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    for kind, ts in state.opt.state_tensors().items():
        for a, b in zip(ts, restored.opt.state_tensors()[kind]):
            assert torch.equal(a, b)
    assert int(restored.opt.count) == int(state.opt.count) == 1
    assert int(restored.step) == 1
    # the slim best-model form: parameters, a fresh optimizer
    slim = tck.save_checkpoint(str(tmp_path), "best_model",
                               tck.snapshot(state, with_opt=False), meta)
    tree, _ = tck.restore_raw(slim)
    assert not any(k.startswith("opt_state") for k in tree)
    again, _ = tck.restore_checkpoint(slim, ttrain.create_train_state(
        cfg, seed=9, device="cpu"))
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    assert int(again.opt.count) == 0 and all(
        float(t.abs().max()) == 0 for t in again.opt.mu)
    assert tck.latest_checkpoint(str(tmp_path)).endswith(
        "checkpoint_epoch_1")


def test_orbax_checkpoint_raises(tmp_path):
    """A directory that is neither the port's checkpoint nor an orbax
    store (an empty tree/ folder) raises; JAX's orbax checkpoints resume
    (test_resume_from_a_jax_checkpoint_matches_jax)."""
    (tmp_path / "ck" / "tree").mkdir(parents=True)
    cfg, _ = _cfgs()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tck.restore_checkpoint(str(tmp_path / "ck"),
                               ttrain.create_train_state(cfg, device="cpu"))


def test_resume_from_a_jax_checkpoint_matches_jax(folder, tmp_path,
                                                  monkeypatch):
    """JAX's train() runs 1 epoch and writes its orbax checkpoint
    (tree/ and meta.json); then each package resumes from that directory
    for 2 more epochs (TRAIN.EPOCHS 3): the histories, the learning rate
    and the final parameters agree at test_two_epochs_match_jax's
    tolerances. SGD with gradient clipping on: the momentum comes back
    from opt_state/1/inner_state/1/trace, the injected learning rate from
    opt_state/1/hyperparams/learning_rate (the Adam and AdamW mappings
    are held array for array in tests/test_torch_orbax.py)."""
    cfg, _ = _cfgs(tmp_path / "port")
    _, jcfg = _cfgs(tmp_path / "jax")
    for c in (cfg, jcfg):
        c.DATA.ROOT_DIR = str(folder)
        c.DATA.DEVICE_CACHE = False
        c.TRAIN.LOG_INTERVAL = 0
        c.OPTIMIZER.NAME = "SGD"
        c.TRAIN.GRADIENT_CLIP = 1.0
        c.TRAIN.LR = 1e-3
        c.TRAIN.SAVE_BEST_ONLY = False
        c.TRAIN.SAVE_INTERVAL = 1
    cfg.DATA.CACHE_DIR = str(tmp_path / "port" / "cache")
    jcfg.DATA.CACHE_DIR = str(tmp_path / "jax" / "cache")
    jcfg.TRAIN.EPOCH_SCAN = False
    monkeypatch.setitem(jaug.POLICIES, "transparent_watermark",
                        jaug.AugmentPolicy(**ZERO))
    monkeypatch.setitem(taug.POLICIES, "transparent_watermark",
                        taug.AugmentPolicy(**ZERO))
    monkeypatch.setattr(jtrain, "mesh_from_config", _one_device_mesh)
    jit_init = jax.jit(jax_init_model, static_argnums=(0, 1, 2))
    monkeypatch.setattr(jtrain, "init_model",
                        lambda model, size, seed=0: jit_init(model, size,
                                                             seed))
    jcfg.TRAIN.EPOCHS = 1
    jtrain.train(jcfg)
    ckpt = jtrain.latest_checkpoint(jcfg.TRAIN.CHECKPOINT_DIR)
    assert os.path.isdir(os.path.join(ckpt, "tree"))
    jcfg.TRAIN.EPOCHS = cfg.TRAIN.EPOCHS = 3
    tres = ttrain.train(cfg, resume_from=ckpt, device="cpu")
    jres = jtrain.train(jcfg, resume_from=ckpt)
    jh, th = jres["history"], tres["history"]
    assert tres["epochs_run"] == jres["epochs_run"] == 3
    assert len(th["train_loss"]) == len(jh["train_loss"]) == 3
    assert th["lr"] == jh["lr"]
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(th[k], jh[k], rtol=2e-5, err_msg=k)
    for k in ("val_iou", "val_f1", "val_accuracy"):
        np.testing.assert_allclose(th[k], jh[k], rtol=2e-3, err_msg=k)
    want = _flat({"params": jres["state"].params,
                  "batch_stats": jres["state"].batch_stats})
    got = to_flax(tres["state"].model)
    for key in want:
        scale = max(np.abs(want[key]).max(), 1e-3)
        assert np.abs(got[key] - want[key]).max() <= 5e-3 * scale, key


def test_resume_continues_the_epoch_count(folder, tmp_path):
    cfg, _ = _cfgs(tmp_path)
    cfg.DATA.ROOT_DIR = str(folder)
    cfg.DATA.CACHE_DIR = str(tmp_path / "cache")
    cfg.TRAIN.EPOCHS = 1
    r1 = ttrain.train(cfg, device="cpu", max_steps_per_epoch=1)
    cfg.TRAIN.EPOCHS = 2
    r2 = ttrain.train(cfg, resume_from=r1["best_checkpoint"],
                      device="cpu", max_steps_per_epoch=1)
    assert r1["epochs_run"] == 1 and r2["epochs_run"] == 2
    assert r2["history"]["train_loss"][0] == r1["history"]["train_loss"][0]
    with open(os.path.join(cfg.TRAIN.OUTPUT_DIR,
                           "training_history.json")) as f:
        assert len(json.load(f)["val_loss"]) == 2


def test_warm_start_is_partial_where_keys_miss(tmp_path):
    cfg, _ = _cfgs()
    src = init_model(create_model_from_config(cfg), seed=4)
    flat = {k: v for k, v in to_flax(src).items()
            if "/encoder/" in k}  # the encoder only
    path = tship.save_params_npz(tmp_path / "enc.npz", flat)
    state = ttrain.create_train_state(cfg, seed=0, device="cpu")
    before = {n: p.clone() for n, p in state.model.named_parameters()}
    n = ttrain.warm_start(state, str(path))
    assert n == len([k for k in flat if k.startswith("params/")])
    src_params = dict(src.named_parameters())
    for name, p in state.model.named_parameters():
        if name.startswith("encoder"):
            # the shipped format's bf16 values
            assert torch.equal(p, src_params[name].to(torch.bfloat16)
                               .float())
            if p.ndim == 4:  # a conv kernel: another draw before
                assert not torch.equal(p, before[name])
        else:
            assert torch.equal(p, before[name])
    # batch_stats are never loaded
    assert float(state.model.encoder.bn1.running_var.min()) == 1.0


def test_async_saver_orders_flushes_and_raises():
    saver = AsyncSaver(max_pending=1)
    seen = []
    for i in range(4):
        saver.submit(seen.append, i)
    saver.flush()
    assert seen == [0, 1, 2, 3]

    def boom():
        raise OSError("disk full")

    saver.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        saver.flush()
    saver.close()


def test_predictor_loads_a_trained_npz(tmp_path):
    """The exported .npz serves: WatermarkPredictor on the CPU gives the
    masks of the in-memory model cast to bf16-rounded weights."""
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor

    cfg, _ = _cfgs()
    state = _stepped_state(cfg)
    cfg.TRAIN.MODEL_SAVE_PATH = str(tmp_path / "models" / "m.pth")
    path = ttrain.export_npz(cfg, tck.snapshot(state, with_opt=False))
    assert os.path.basename(path) == "seg_unet_resnet34.npz"
    pred = WatermarkPredictor(cfg, weights_path=path, device="cpu")
    images = torch.from_numpy(watermarked_images(2, SIZE, seed=8)[0])
    masks = pred.predict_masks(images)
    held = create_model_from_config(cfg)
    held.load_state_dict(state.model.state_dict())
    held = held.to(torch.bfloat16).float().eval()
    pred.model = held
    assert torch.equal(pred.predict_masks(images), masks)
