"""Data-parallel training of the port (a gloo group of 2 CPU ranks)
against the JAX package on a 2-device sub-mesh, and against itself in
one process:

  - JAX's test_dp_equivalence recipe (tests/test_training.py: Unet/
    resnet18 at 64², CombinedLoss, SGD, 3 batches of 16, then an eval
    step), no augmentation: the port in 1 process and on 2 ranks against
    JAX on a 1- and a 2-device mesh, at that test's tolerances (losses
    rtol 2e-3 / atol 1e-5, parameters and BatchNorm's running statistics
    rtol 1e-3 / atol 1e-4, confusion counts rtol 0.15);
  - the same recipe with the transparent_watermark augmentation: 2 ranks
    against 1 process of the port (the draws are the global batch's);
  - a global batch of 5 on 2 ranks from the host pipeline: each rank's 3
    rows, zero pad rows included, against JAX's DataPipeline on a 2-device
    mesh;
  - train() for 2 epochs on 2 ranks against JAX's train() on a 2-device
    mesh, with tests/test_torch_train_loop.py's set-up and tolerances;
    rank 1 is given its own output paths and writes nothing there, nor
    does it through the `train` command run in the formed group.

The ranks start first and JAX computes its references meanwhile. JAX is
imported inside the fixtures: the spawned ranks import this module and
need torch only.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_gloo
from unet_watermark_tpu_torch import cli
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.data import pipeline as tpl
from unet_watermark_tpu_torch.models.convert import load_flax_weights, to_flax
from unet_watermark_tpu_torch.models.factory import create_model_from_config
from unet_watermark_tpu_torch.ops import augment as taug
from unet_watermark_tpu_torch.ops import losses as tlosses
from unet_watermark_tpu_torch.parallel import distributed as tdist
from unet_watermark_tpu_torch.parallel import mesh as tmesh
from unet_watermark_tpu_torch.training import state as tstate
from unet_watermark_tpu_torch.training import train as ttrain
from unet_watermark_tpu_torch.utils.synthetic import write_training_folder

WORLD = 2
ZERO = dict(hflip_p=0.0, vflip_p=0.0, rot90_p=0.0, affine_p=0.0, bc_p=0.0,
            hsv_p=0.0, noise_p=0.0, blur_p=0.0, jpeg_p=0.0)
AUG_SEED = 5
# tests/test_torch_train_loop.py's train() set-up
LOOP_SIZE, LOOP_BATCH, LOOP_FILES, LOOP_MASKS = 64, 4, 14, 7
# the host pipeline's check: 12 samples at a global batch of 5
PIPE_N, PIPE_BATCH, PIPE_SIZE = 12, 5, 16


def _recipe_cfg(cfg):
    """tests/test_training.py's small_cfg, as test_dp_equivalence sets it."""
    cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME = "Unet", "resnet18"
    cfg.MODEL.DTYPE = "float32"
    cfg.DATA.IMG_SIZE = 64
    cfg.TRAIN.BATCH_SIZE = 8
    cfg.TRAIN.LR = 1e-3
    cfg.LOSS.NAME = "CombinedLoss"
    cfg.OPTIMIZER.NAME = "SGD"
    return cfg


def _recipe_batches():
    rng = np.random.default_rng(123)
    return [{"image": (rng.random((16, 64, 64, 3)) * 255).astype(np.uint8),
             "mask": (rng.random((16, 64, 64, 1)) > 0.7).astype(np.float32),
             "valid": np.ones((16,), np.float32)} for _ in range(3)]


def _loop_cfg(cfg, root: Path, out: Path, cache: Path):
    """tests/test_torch_train_loop.py::test_two_epochs_match_jax's."""
    cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME = "Unet", "resnet34"
    cfg.MODEL.DTYPE = "float32"
    cfg.DATA.IMG_SIZE = LOOP_SIZE
    cfg.TRAIN.BATCH_SIZE = LOOP_BATCH
    cfg.TRAIN.CHECKPOINT_DIR = str(out / "ckpt")
    cfg.TRAIN.OUTPUT_DIR = str(out / "out")
    cfg.TRAIN.MODEL_SAVE_PATH = str(out / "models" / "m.pth")
    cfg.DATA.ROOT_DIR = str(root)
    cfg.DATA.CACHE_DIR = str(cache)
    cfg.TRAIN.EPOCHS = 2
    cfg.TRAIN.LOG_INTERVAL = 0
    cfg.OPTIMIZER.NAME = "SGD"
    cfg.TRAIN.LR = 1e-3
    return cfg


class Samples:
    """An in-memory dataset: uint8 (S, S, 3) images and (S, S) masks."""

    def __init__(self, n=PIPE_N, size=PIPE_SIZE, seed=9):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(1, 255, (n, size, size, 3),
                                   dtype=np.uint8)
        self.masks = (rng.random((n, size, size)) > 0.6).astype(
            np.uint8) * 255

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.masks[i]


def _port_recipe(flat, batches, policy, mesh=None):
    """The recipe's 3 steps and eval step through the port; in a group,
    each rank on its rows."""
    cfg = _recipe_cfg(get_cfg_defaults())
    model = create_model_from_config(cfg)
    load_flax_weights(model, flat)
    state = tstate.TrainState(model, tstate.make_optimizer(cfg, model))
    tmesh.replicated(state, mesh)
    loss_fn = tlosses.get_loss_function(cfg)
    step = ttrain.make_train_step(cfg, loss_fn, policy,
                                  torch.Generator().manual_seed(AUG_SEED))
    eval_step = ttrain.make_eval_step(cfg, loss_fn)
    place = (lambda b: tmesh.shard_batch(b, mesh)) if mesh is not None \
        else (lambda b: {k: torch.from_numpy(v) for k, v in b.items()})
    losses = [float(step(state, place(b))["loss"]) for b in batches]
    ev = {k: float(v) for k, v in eval_step(state, place(batches[0])).items()}
    return {"losses": losses, "eval": ev, "flat": to_flax(state.model)}


def _ranks(rank, world, flat_path, root, work):
    """What the 2-rank group computes: the recipe without and with
    augmentation, the host pipeline's batches, and a 2-epoch train()."""
    work = Path(work)
    flat = dict(np.load(flat_path))
    mesh = tmesh.mesh_from_config(get_cfg_defaults())
    batches = _recipe_batches()
    out = {"zero": _port_recipe(flat, batches, taug.AugmentPolicy(**ZERO),
                                mesh),
           "augment": _port_recipe(flat, batches, "transparent_watermark",
                                   mesh)}
    pipe = tpl.DataPipeline(Samples(), PIPE_BATCH, "cpu", shuffle=True,
                            seed=3, num_workers=2, mesh=mesh)
    out["pipeline"] = [[{k: v.numpy() for k, v in b.items()} for b in pipe]
                       for _ in range(2)]

    taug.POLICIES["transparent_watermark"] = taug.AugmentPolicy(**ZERO)
    cfg = _loop_cfg(get_cfg_defaults(), Path(root),
                    work / ("port" if rank == 0 else "rank1"),
                    work / "cache")
    res = ttrain.train(cfg, init_weights=str(work / "init.npz"),
                       device="cpu")
    out["train"] = {"history": res["history"],
                    "epochs_run": res["epochs_run"],
                    "best_checkpoint": res["best_checkpoint"],
                    "flat": to_flax(res["state"].model)}
    # the train command in the group the ranks formed (as under torchrun):
    # one epoch, rank 0's files only, the group left to its owner
    argv = ["train", "-c", str(work / "defaults"), "--device", "cpu",
            "--data-dir", str(root), "--epochs", "1",
            "--batch-size", str(LOOP_BATCH),
            "--output-dir", str(work / f"cli{rank}" / "out"),
            "--model-save-path", str(work / f"cli{rank}" / "m.pth"),
            "--opts", "MODEL.NAME", "Unet", "MODEL.DTYPE", "float32",
            "DATA.IMG_SIZE", str(LOOP_SIZE), "DATA.CACHE_DIR",
            str(work / "cache"), "TRAIN.CHECKPOINT_DIR",
            str(work / f"cli{rank}" / "ckpt")]
    out["cli"] = {"rc": cli.main(argv), "in_group": tdist.in_group()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the ranks, then computes JAX's references and the port's
    one-process runs while they work."""
    import importlib

    import jax
    import jax.numpy as jnp
    from unet_watermark_tpu.configs import get_cfg_defaults as jdefaults
    from unet_watermark_tpu.data.pipeline import DataPipeline
    from unet_watermark_tpu.models import create_model_from_config as jmodel
    from unet_watermark_tpu.models import init_model as jinit
    from unet_watermark_tpu.ops import augment as jaug
    from unet_watermark_tpu.ops import losses as jlosses
    from unet_watermark_tpu.parallel import make_mesh, replicated, shard_batch
    from unet_watermark_tpu.utils import shipping as jship

    jtrain = importlib.import_module("unet_watermark_tpu.training.train")
    jstate = importlib.import_module("unet_watermark_tpu.training.state")
    work = tmp_path_factory.mktemp("dp")
    root = work / "folder"
    write_training_folder(root, LOOP_FILES, LOOP_SIZE, seed=5,
                          masks=LOOP_MASKS)
    jit_init = jax.jit(jinit, static_argnums=(0, 1, 2))
    # the recipe's initial state, and the train() test's initial weights
    rcfg = _recipe_cfg(jdefaults())
    # create_train_state(rcfg, seed=0) with its init compiled (flax's
    # eager init takes tens of seconds on the CPU)
    model = jmodel(rcfg)
    variables = jit_init(model, 64, 0)
    tx = jstate.make_optimizer(rcfg)
    state0 = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx, apply_fn=model.apply)
    flat = {k: np.array(v) for k, v in jship.flatten_tree(
        {"params": state0.params,
         "batch_stats": state0.batch_stats}).items()}
    np.savez(work / "flat.npz", **flat)
    lcfg = _loop_cfg(jdefaults(), root, work / "jax", work / "jax_cache")
    variables = jit_init(jmodel(lcfg), LOOP_SIZE, 11)
    jship.save_params_npz(str(work / "init.npz"),
                          {"params": variables["params"]}, dtype=None)

    handle = torch_gloo.start(_ranks, WORLD, work, str(work / "flat.npz"),
                              str(root), str(work))

    # JAX: the recipe on a 1- and a 2-device mesh
    zero = jaug.AugmentPolicy(**ZERO)
    loss_fn = jlosses.get_loss_function(rcfg)
    step = jtrain.make_train_step(model, loss_fn, zero, donate=False)
    eval_step = jtrain.make_eval_step(model, loss_fn)
    batches = _recipe_batches()
    jax_runs = {}
    for n_dev in (1, WORLD):
        mesh = make_mesh(devices=jax.devices()[:n_dev])
        rep = replicated(mesh)
        state = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, rep) if hasattr(x, "shape") else x,
            state0)
        losses = []
        for i, b in enumerate(batches):
            state, m = step(state, shard_batch(b, mesh),
                            jax.random.PRNGKey(7 + i))
            losses.append(float(m["loss"]))
        ev = eval_step(state, shard_batch(batches[0], mesh))
        jax_runs[n_dev] = {
            "losses": losses, "eval": {k: float(v) for k, v in ev.items()},
            "flat": {k: np.array(v) for k, v in jship.flatten_tree(
                {"params": state.params,
                 "batch_stats": state.batch_stats}).items()}}
    # the port in one process, without and with augmentation
    one = {"zero": _port_recipe(flat, batches, taug.AugmentPolicy(**ZERO)),
           "augment": _port_recipe(flat, batches, "transparent_watermark")}
    # JAX's host pipeline on a 2-device mesh, global batch 5
    mesh2 = make_mesh(devices=jax.devices()[:WORLD])
    jpipe = DataPipeline(Samples(), PIPE_BATCH, mesh=mesh2, shuffle=True,
                         seed=3, num_workers=2)
    jax_pipe = [[{k: np.asarray(v) for k, v in b.items()} for b in jpipe]
                for _ in range(2)]
    # JAX's train() on a 2-device mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jaug.POLICIES, "transparent_watermark", zero)
        mp.setattr(jtrain, "mesh_from_config", lambda cfg: mesh2)
        mp.setattr(jtrain, "init_model",
                   lambda model, size, seed=0: jit_init(model, size, seed))
        lcfg.TRAIN.EPOCH_SCAN = False
        jres = jtrain.train(lcfg, init_weights=str(work / "init.npz"))
    ranks = torch_gloo.join(handle, timeout=600)
    return {"jax": jax_runs, "one": one, "ranks": ranks,
            "jax_pipe": jax_pipe, "jax_train": jres, "work": work}


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _check_recipe(got, want):
    """test_dp_equivalence_1_vs_8_devices's comparison."""
    _close(got["losses"], want["losses"], 2e-3, 1e-5, "losses")
    for k in want["eval"]:
        rtol = 0.15 if k in ("tp", "fp", "fn", "tn") else 2e-3
        _close(got["eval"][k], want["eval"][k], rtol, 1e-3, f"eval {k}")
    for key in want["flat"]:  # params and BatchNorm's running statistics
        _close(got["flat"][key], want["flat"][key], 1e-3, 1e-4, key)


@pytest.mark.parametrize("who", ["one_process", "two_ranks"])
def test_dp_recipe_matches_jax(runs, who):
    """The port in one process against JAX on one device, and each of
    the port's 2 ranks against JAX on a 2-device mesh."""
    if who == "one_process":
        _check_recipe(runs["one"]["zero"], runs["jax"][1])
        return
    for res in runs["ranks"]:
        _check_recipe(res["zero"], runs["jax"][WORLD])


def test_dp_ranks_hold_the_same_state(runs):
    a, b = (r["zero"] for r in runs["ranks"])
    assert a["losses"] == b["losses"] and a["eval"] == b["eval"]
    for key in a["flat"]:
        np.testing.assert_array_equal(a["flat"][key], b["flat"][key], key)


@pytest.mark.parametrize("recipe", ["zero", "augment"])
def test_dp_two_ranks_match_one_process(runs, recipe):
    """With augmentation on, each rank keeps its rows of the global
    batch's draws, so 2 ranks step as 1 process does."""
    for res in runs["ranks"]:
        _check_recipe(res[recipe], runs["one"][recipe])
    # the augmentation changed the losses
    assert runs["one"]["augment"]["losses"] != runs["one"]["zero"]["losses"]


def test_host_pipeline_shards_a_padded_global_batch_as_jax(runs):
    """A global batch of 5 over 2 ranks is 6 rows, zero pad rows marked
    in `valid`; rank r holds rows 3r..3r+2 of JAX's batch, byte for byte
    (the last batch of 2: rank 1's rows are all pad)."""
    want = runs["jax_pipe"]
    for epoch in range(2):
        parts = [r["pipeline"][epoch] for r in runs["ranks"]]
        assert len(parts[0]) == len(parts[1]) == len(want[epoch]) == 3
        for i, w in enumerate(want[epoch]):
            assert w["image"].shape[0] == 6
            for k in w:
                got = np.concatenate([p[i][k] for p in parts])
                assert got.dtype == w[k].dtype, k
                np.testing.assert_array_equal(got, w[k], err_msg=k)
    last = [r["pipeline"][0][-1] for r in runs["ranks"]]
    assert last[0]["valid"].tolist() == [1.0, 1.0, 0.0]
    assert last[1]["valid"].tolist() == [0.0] * 3
    assert not last[1]["image"].any() and not last[0]["image"][2].any()


def test_train_on_two_ranks_matches_jax_on_two_devices(runs):
    """test_two_epochs_match_jax's comparison for a 2-rank train(); every
    rank returns the same history and state; rank 1 writes no file."""
    from unet_watermark_tpu.utils.shipping import flatten_tree

    jres = runs["jax_train"]
    jh = jres["history"]
    want = {k: np.array(v) for k, v in flatten_tree(
        {"params": jres["state"].params,
         "batch_stats": jres["state"].batch_stats}).items()}
    for res in runs["ranks"]:
        tr = res["train"]
        th = tr["history"]
        assert tr["epochs_run"] == jres["epochs_run"] == 2
        assert th["lr"] == jh["lr"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(th[k], jh[k], rtol=2e-5, err_msg=k)
        for k in ("val_iou", "val_f1", "val_accuracy"):
            np.testing.assert_allclose(th[k], jh[k], rtol=2e-3, err_msg=k)
        for key in want:
            scale = max(np.abs(want[key]).max(), 1e-3)
            assert np.abs(tr["flat"][key] - want[key]).max() <= \
                5e-3 * scale, key
    a, b = (r["train"] for r in runs["ranks"])
    assert a["history"] == b["history"]
    for key in a["flat"]:
        np.testing.assert_array_equal(a["flat"][key], b["flat"][key], key)
    work = runs["work"]
    assert sorted(os.listdir(work / "port" / "ckpt"))[0] == "best_model"
    assert os.path.exists(work / "port" / "out" / "training_history.json")
    assert os.path.exists(work / "port" / "models" / "seg_unet_resnet34.npz")
    assert os.path.exists(work / "port" / "models" / "m.pth")
    assert not os.path.exists(work / "rank1")


def test_train_command_in_a_group_writes_on_rank_0_only(runs):
    """`train` run by each rank of a formed group (as torchrun starts it):
    rc 0 on both, rank 0's checkpoint, history and exports only, and the
    group still formed (the command leaves a group it did not form)."""
    work = runs["work"]
    for res in runs["ranks"]:
        assert res["cli"] == {"rc": 0, "in_group": True}
    assert os.path.exists(work / "cli0" / "out" / "training_history.json")
    assert os.path.exists(work / "cli0" / "seg_unet_resnet34.npz")
    assert sorted(os.listdir(work / "cli0" / "ckpt"))[0] == "best_model"
    assert not os.path.exists(work / "cli1")
