"""Training of the segmentation model (training/train.py in the JAX
package): the train and eval steps, the epoch loops and train(), with the
same history keys, checkpoints, resume and exports.

A train step is augment (ops/augment on the card) → the forward and
backward pass (bf16 compute under torch.autocast where MODEL.DTYPE says
bfloat16, fp32 parameters, fp32 logits and loss) → the optimizer update
(training/state.Optimizer) → the confusion counts. Padded samples of a
short last batch get logits -20 and zero targets, and the loss is scaled
by n / sum(valid), as in the JAX package. The step's scalars stay on the
card; an epoch syncs once, when it reads their sums.

In a process group (parallel/, `torchrun`) train() is data parallel over
the mesh of PARALLEL.MESH_SHAPE (default: the whole world), as JAX's jit
over a sharded batch: each rank takes its contiguous share of every
(zero-padded) global batch from the host pipeline and of its augmentation
draws; BatchNorm takes the global batch's statistics (models/encoders.py);
each rank's loss is its rows' share of the global mean (the scale is
global_n / global sum(valid)), and the gradients are summed over the
ranks before the optimizer's clip, so the clip sees the global gradient's
norm. The step's scalars and the eval sums are summed over the ranks, so
every rank keeps the same history. Rank 0's state goes to every rank at
the start; rank 0 alone writes the checkpoints, the exports, the plots
and the history file.

The JAX package also has an epoch-scan path (make_train_epoch_scan): one
XLA dispatch an epoch, to hide the dispatch latency of its device link. Its
counterpart here is the per-step loop over the card-resident pipeline
(data/pipeline.DeviceDataPipeline): each batch is a gather on the card and
no step waits for the host.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataset import create_datasets
from ..data.pipeline import make_pipelines
from ..models.convert import flax_name
from ..models.torch_import import export_pth, flax_to_state_dict
from ..models.factory import create_model_from_config, init_model, \
    torch_dtype
from ..ops import augment as aug
from ..ops import losses as losses_lib
from ..ops import metrics as metrics_lib
from ..parallel.distributed import barrier, in_group, rank_and_world
from ..parallel.mesh import mesh_from_config, replicated
from ..utils.async_ckpt import AsyncSaver
from ..utils.device import compute_autocast, resolve_device
from ..utils.shipping import load_npz, save_params_npz, seg_weights_filename
from .checkpoint import (latest_checkpoint, restore_checkpoint,
                         save_checkpoint, snapshot)
from .state import EarlyStopping, LRScheduler, TrainState, make_optimizer

logger = logging.getLogger(__name__)


def _no_part(name: str):
    return contextlib.nullcontext()


def _to_float(batch):
    """uint8 batches scale to [0, 1] on the card."""
    images, masks = batch["image"], batch["mask"]
    if not images.is_floating_point():
        images = images.float() / 255.0
    if not masks.is_floating_point():
        masks = masks.float()
    return images, masks


def _autocast(cfg, device: torch.device):
    """bf16 compute over fp32 parameters where MODEL.DTYPE is bfloat16
    (flax's dtype/param_dtype split); nothing for float32."""
    dtype = torch_dtype(cfg.MODEL.DTYPE)
    return compute_autocast(device, None if dtype == torch.float32
                            else dtype)


def _masked(logits, masks, valid):
    """Pad rows neutralized, and the loss scale n / sum(valid): in a group,
    this rank's n over the global sum, its share of the global scale."""
    n = logits.shape[0]
    vmask = valid.reshape(n, 1, 1, 1)
    logits = torch.where(vmask > 0, logits.float(), -20.0)
    total = valid.sum()
    if in_group():
        dist.all_reduce(total)
    scale = n / torch.clamp(total, min=1.0)
    return logits, masks * vmask, scale


def _sum_over_ranks(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's scalars summed over the group, in one all-reduce."""
    if not in_group():
        return out
    flat = torch.stack([out[k].float() for k in out])
    dist.all_reduce(flat)
    return dict(zip(out, flat.unbind()))


def _sum_grads_over_ranks(params) -> None:
    """Each parameter's .grad summed over the group, in one all-reduce."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def make_train_step(cfg, loss_fn, policy, gen: torch.Generator):
    """step(state, batch, part=...) → {"loss", "tp", "fp", "fn", "tn"} as
    tensors on the card; part(name) wraps the "augment",
    "forward_backward" and "optimizer" stages for a caller that times
    them."""

    def step(state: TrainState, batch, part: Callable = _no_part):
        model = state.model.train()
        device = batch["image"].device
        rank, world = rank_and_world()
        with part("augment"):
            images, masks = _to_float(batch)
            n = images.shape[0]
            images, masks = aug.augment_batch(
                gen, images, masks, policy,
                rows=(n * world, n * rank) if in_group() else None)
            valid = batch["valid"].float()
        with part("forward_backward"):
            with _autocast(cfg, device):
                logits = model(images)
            logits, targets, scale = _masked(logits, masks, valid)
            loss = loss_fn(logits, targets) * scale
            for p in state.opt.params:
                p.grad = None
            loss.backward()
        with part("optimizer"):
            if in_group():
                _sum_grads_over_ranks(state.opt.params)
            state.opt.step()
            state.step += 1
        stats = metrics_lib.confusion_stats(logits.detach(), targets,
                                            valid=valid)
        return _sum_over_ranks({"loss": loss.detach(), **stats})

    return step


def make_eval_step(cfg, loss_fn, threshold: float = 0.5):
    @torch.no_grad()
    def step(state: TrainState, batch):
        model = state.model.eval()
        images, masks = _to_float(batch)
        images = aug.val_preprocess(images)
        valid = batch["valid"].float()
        with _autocast(cfg, images.device):
            logits = model(images)
        logits, targets, scale = _masked(logits, masks, valid)
        stats = metrics_lib.confusion_stats(logits, targets,
                                            threshold=threshold, valid=valid)
        return _sum_over_ranks({"loss": loss_fn(logits, targets) * scale,
                                "weight": valid.sum(), **stats})

    return step


def create_train_state(cfg, seed: int = 0, device="cuda") -> TrainState:
    """A freshly initialized model (init_model) with fp32 parameters on
    `device` and its optimizer."""
    model = init_model(create_model_from_config(cfg), seed)
    model = model.to(resolve_device(device))
    if next(model.parameters()).device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return TrainState(model, make_optimizer(cfg, model))


@torch.no_grad()
def warm_start(state: TrainState, path: str) -> int:
    """--init-weights: the params of a shipped-format .npz into the model
    (batch_stats stay fresh, as the JAX package loads {"params"} only).
    Every param must be there with its shape, else the load is partial:
    the parameters that match take the file's values, the others keep
    their init. Returns the number loaded."""
    flat = load_npz(path)
    params = dict(state.model.named_parameters())
    keys = {flax_name(n): n for n in params}
    complete = all(k in flat for k in keys)
    loaded = 0
    for key, name in keys.items():
        if key not in flat:
            continue
        arr = flat[key]
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            if complete:
                raise ValueError(f"shape mismatch for '{key}': stored "
                                 f"{arr.shape} vs model {tuple(p.shape)}")
            continue
        p.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(p.device,
                                                                 p.dtype))
        loaded += 1
    logger.info("warm-started %d/%d params from %s", loaded, len(keys), path)
    return loaded


def _epoch_metrics(agg: Dict[str, torch.Tensor], batches: int
                   ) -> Dict[str, float]:
    """One host sync: the summed float32 counts → the history's floats."""
    host = {k: v.detach().cpu() for k, v in agg.items()}
    out = metrics_lib.metrics_from_stats(
        {k: host[k] for k in ("tp", "fp", "fn", "tn")})
    out = {k: float(v) for k, v in out.items()}
    out["loss"] = float(host["loss"]) / batches
    return out


def _accumulate(agg, m):
    return dict(m) if agg is None else {k: agg[k] + m[k] for k in agg}


def _max_over_ranks(x: float, device) -> float:
    t = torch.tensor(float(x), dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def run_train_epoch(train_step, state, pipeline, epoch: int,
                    log_interval: int = 0, max_steps: Optional[int] = None):
    """One epoch; returns (mean metrics, seconds). log_interval > 0 logs
    every that many steps (one sync each)."""
    agg, batches = None, 0
    t0 = time.time()
    for batch in pipeline:
        if max_steps is not None and batches >= max_steps:
            break
        m = train_step(state, batch)
        agg = _accumulate(agg, m)
        batches += 1
        if log_interval and batches % log_interval == 0:
            logger.info("epoch %d batch %d: loss=%.4f", epoch + 1, batches,
                        float(m["loss"]))
    if agg is None:
        return {"loss": float("nan")}, 0.0
    out = _epoch_metrics(agg, batches)
    return out, time.time() - t0


def run_eval_epoch(eval_step, state, pipeline) -> Dict[str, float]:
    agg, batches = None, 0
    for batch in pipeline:
        agg = _accumulate(agg, eval_step(state, batch))
        batches += 1
    if agg is None:
        return {"loss": float("nan")}
    return _epoch_metrics(agg, batches)


def save_training_plots(history: Dict[str, list], output_dir: str) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001
        logger.warning("matplotlib unavailable; skipping plots")
        return
    os.makedirs(output_dir, exist_ok=True)
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    epochs = range(1, len(history["train_loss"]) + 1)
    axes[0].plot(epochs, history["train_loss"], label="train")
    axes[0].plot(epochs, history["val_loss"], label="val")
    axes[0].set_title("loss")
    axes[0].legend()
    axes[1].plot(epochs, history["val_iou"], label="IoU")
    axes[1].plot(epochs, history["val_f1"], label="F1")
    axes[1].set_title("metrics")
    axes[1].legend()
    axes[2].plot(epochs, history["lr"], label="lr")
    axes[2].set_yscale("log")
    axes[2].set_title("learning rate")
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "training_curves.png"), dpi=120)
    plt.close(fig)


def export_npz(cfg, tree: Dict[str, np.ndarray]) -> str:
    """The shipped-format .npz (bf16) beside MODEL_SAVE_PATH, named as the
    predictor resolves shipped weights: seg_<arch>_<encoder>.npz."""
    path = os.path.join(
        os.path.dirname(os.path.abspath(cfg.TRAIN.MODEL_SAVE_PATH)),
        seg_weights_filename(cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME))
    flat = {k: v for k, v in tree.items()
            if k.startswith(("params/", "batch_stats/"))}
    return save_params_npz(path, flat)


def _save_best(cfg, ckpt_dir: str, tree, meta) -> None:
    """The best-model job: the slim checkpoint, the reference's .pth at
    MODEL_SAVE_PATH (models/torch_import.export_pth; as in JAX, a failed
    export logs and the job goes on), then the shipped .npz beside it."""
    save_checkpoint(ckpt_dir, "best_model", tree, meta)
    try:
        path = cfg.TRAIN.MODEL_SAVE_PATH
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        export_pth(path, cfg, flax_to_state_dict(tree), epoch=meta["epoch"],
                   best_val_loss=meta["best_val_loss"])
    except Exception as e:  # noqa: BLE001 — JAX's boundary
        logger.warning(".pth export skipped: %s", e)
    path = export_npz(cfg, tree)
    logger.info("best model: %s and %s", cfg.TRAIN.MODEL_SAVE_PATH, path)


def train(cfg, resume_from: Optional[str] = None,
          use_blurred_mask: bool = False, train_ds=None, val_ds=None,
          max_steps_per_epoch: Optional[int] = None,
          init_weights: Optional[str] = None, device="cuda"
          ) -> Dict[str, Any]:
    """The JAX package's train(): returns best_val_loss, epochs_run,
    history, best_checkpoint and the state. `device` is "cuda" unless it
    says "cpu"; in a process group, this rank's device (the group's
    ranks all call train() with the same configuration)."""
    device = resolve_device(device)
    mesh = mesh_from_config(cfg)
    rank = rank_and_world()[0]
    logger.info("mesh: %s", mesh)
    if train_ds is None or val_ds is None:
        # rank 0 first: it writes the decoded cache's files and the masks
        # made from the clean diff, which the other ranks then open
        if rank:
            barrier()
        train_ds, val_ds = create_datasets(cfg, use_blurred_mask, device)
        if not rank:
            barrier()
    train_pipe, val_pipe = make_pipelines(cfg, train_ds, val_ds, device,
                                          mesh=mesh)

    state = create_train_state(cfg, seed=cfg.DATA.SEED, device=device)
    if init_weights:
        warm_start(state, init_weights)
    loss_fn = losses_lib.get_loss_function(cfg)
    policy = cfg.DATA.AUGMENTATION_TYPE
    if policy not in aug.POLICIES:
        policy = "transparent_watermark"
    gen = torch.Generator(device).manual_seed(cfg.DATA.SEED)
    train_step = make_train_step(cfg, loss_fn, policy, gen)
    eval_step = make_eval_step(cfg, loss_fn)

    scheduler = LRScheduler(cfg)
    early = EarlyStopping(cfg.TRAIN.EARLY_STOPPING_PATIENCE)
    history: Dict[str, list] = {
        "train_loss": [], "val_loss": [], "val_iou": [], "val_f1": [],
        "val_accuracy": [], "lr": [], "epoch_time": [],
        "throughput_img_s": []}
    start_epoch = 0
    best_val_loss = float("inf")
    ckpt_dir = cfg.TRAIN.CHECKPOINT_DIR
    if resume_from:
        path = resume_from
        if os.path.isdir(resume_from) and latest_checkpoint(resume_from):
            path = latest_checkpoint(resume_from)
        state, meta = restore_checkpoint(path, state)
        start_epoch = int(meta.get("epoch", 0))
        best_val_loss = float(meta.get("best_val_loss", float("inf")))
        history = meta.get("history", history)
        if "scheduler" in meta:
            scheduler.load_state_dict(meta["scheduler"])
            state.with_lr(scheduler.state_dict()["lr"])
        if "early_stopping" in meta:
            early.load_state_dict(meta["early_stopping"])
        logger.info("resumed from %s at epoch %d", path, start_epoch)
    replicated(state, mesh)  # rank 0's parameters and optimizer state

    n_train = len(train_ds)
    best_path = None
    saver = AsyncSaver(max_pending=1)
    for epoch in range(start_epoch, cfg.TRAIN.EPOCHS):
        train_m, dt = run_train_epoch(
            train_step, state, train_pipe, epoch,
            log_interval=cfg.TRAIN.LOG_INTERVAL,
            max_steps=max_steps_per_epoch)
        val_m = run_eval_epoch(eval_step, state, val_pipe)
        if in_group():  # the epoch takes as long as its slowest rank
            dt = _max_over_ranks(dt, device)
        lr = scheduler.step(val_m["loss"])
        state.with_lr(lr)
        history["train_loss"].append(train_m["loss"])
        history["val_loss"].append(val_m["loss"])
        history["val_iou"].append(val_m.get("iou", 0.0))
        history["val_f1"].append(val_m.get("f1", 0.0))
        history["val_accuracy"].append(val_m.get("accuracy", 0.0))
        history["lr"].append(lr)
        history["epoch_time"].append(dt)
        history["throughput_img_s"].append(n_train / dt if dt > 0 else 0.0)
        logger.info(
            "epoch %d: train_loss=%.4f val_loss=%.4f iou=%.4f f1=%.4f "
            "lr=%.2e (%.1fs, %.1f img/s)", epoch + 1, train_m["loss"],
            val_m["loss"], val_m.get("iou", 0), val_m.get("f1", 0), lr, dt,
            history["throughput_img_s"][-1])
        meta = {
            "epoch": epoch + 1,
            "best_val_loss": min(best_val_loss, val_m["loss"]),
            "history": history,
            "scheduler": scheduler.state_dict(),
            "early_stopping": early.state_dict(),
            "config": cfg.to_dict(),
        }
        # host snapshots (copies) are written by one worker thread while
        # the next epoch trains; rank 0's alone
        if val_m["loss"] < best_val_loss:
            best_val_loss = val_m["loss"]
            best_path = os.path.abspath(os.path.join(ckpt_dir, "best_model"))
            if not rank:
                saver.submit(_save_best, cfg, ckpt_dir,
                             snapshot(state, with_opt=False),
                             json.loads(json.dumps(meta)))
        if not rank and not cfg.TRAIN.SAVE_BEST_ONLY and (
                (epoch + 1) % cfg.TRAIN.SAVE_INTERVAL == 0):
            saver.submit(save_checkpoint, ckpt_dir,
                         f"checkpoint_epoch_{epoch + 1}", snapshot(state),
                         json.loads(json.dumps(meta)))
        if cfg.TRAIN.USE_EARLY_STOPPING and early(val_m["loss"]):
            logger.info("early stopping at epoch %d", epoch + 1)
            break

    saver.flush()  # every checkpoint on disk before the report
    saver.close()
    if not rank:
        save_training_plots(history, cfg.TRAIN.OUTPUT_DIR)
        os.makedirs(cfg.TRAIN.OUTPUT_DIR, exist_ok=True)
        with open(os.path.join(cfg.TRAIN.OUTPUT_DIR,
                               "training_history.json"), "w") as f:
            json.dump(history, f, indent=2)
    barrier()  # the other ranks return once rank 0's files are written
    return {"best_val_loss": best_val_loss,
            "epochs_run": len(history["train_loss"]),
            "history": history, "best_checkpoint": best_path,
            "state": state}

