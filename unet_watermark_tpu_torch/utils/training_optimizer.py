"""A second, self-contained trainer (utils/training_optimizer.py in the
JAX package): TrainingConfig, the learning-rate schedules, the optimizer
and TrainingOptimizer.

  build_schedule(cfg)            a function of the update count with the
                                 values of JAX's optax schedules: warmup
                                 (linear from 0) joined to cosine decay to
                                 min_lr, to a step decay, or to a constant;
                                 "plateau" and "none" are the constant, as
                                 JAX has it. The values are computed in
                                 Python floats (optax's in float32).
  build_optimizer(cfg, params)   training/state.Optimizer over `params`:
                                 adamw (the decay after Adam's scaling),
                                 adam, sgd (momentum 0.9), behind
                                 clip_by_global_norm, with optax.MultiSteps'
                                 accumulation over gradient_accumulation_steps.
                                 JAX's returns a transformation without
                                 parameters; a torch optimizer holds them.
  TrainingOptimizer(model, loss_fn, config)
                                 train(batches_fn, epochs, val_batches_fn)
                                 over an nn.Module taking (N, H, W, 3)
                                 images: JAX's epoch loop, history and
                                 early stopping; the history JSON in
                                 config.output_dir. compute_dtype
                                 "bfloat16" runs the forward under bf16
                                 autocast (fp32 parameters), as the port's
                                 trainer does.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from ..training.state import Optimizer
from .device import compute_autocast, resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainingConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    optimizer: str = "adamw"          # adamw | adam | sgd
    scheduler: str = "cosine"         # cosine | step | plateau | none
    warmup_steps: int = 0
    total_steps: int = 10000
    step_decay_every: int = 1000
    step_decay_factor: float = 0.5
    min_lr: float = 1e-6
    gradient_clip: float = 1.0
    gradient_accumulation_steps: int = 1
    compute_dtype: str = "bfloat16"
    seed: int = 42
    early_stopping_patience: int = 10
    output_dir: str = "training_output"


def build_schedule(cfg: TrainingConfig) -> Callable[[int], float]:
    """lr(count) for count = 0, 1, ... updates (the module's docstring)."""
    base = cfg.learning_rate
    warm = cfg.warmup_steps
    if cfg.scheduler == "cosine":
        decay = max(cfg.total_steps - warm, 1)
        alpha = cfg.min_lr / base

        def main(count):
            c = min(float(count), float(decay))
            cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
            return base * ((1 - alpha) * cosine + alpha)
    elif cfg.scheduler == "step":
        every = max(cfg.step_decay_every, 1)
        bounds = [i * cfg.step_decay_every for i in
                  range(1, max(cfg.total_steps // every, 1) + 1)]

        def main(count):
            v = base
            for b in bounds:  # optax's piecewise_constant: scaled at b
                if count >= b:
                    v *= cfg.step_decay_factor
            return v
    else:  # "plateau" and "none": constant, as JAX builds them
        def main(count):
            return base
    if warm > 0:
        def schedule(count):
            if count < warm:
                return base * min(max(count, 0), warm) / warm
            return main(count - warm)
        return schedule
    return main


def build_optimizer(cfg: TrainingConfig, params: Iterable[torch.Tensor]
                    ) -> Optimizer:
    """training/state.Optimizer with the schedule, clip and accumulation
    of `cfg` (the module's docstring)."""
    if cfg.optimizer not in ("adamw", "adam", "sgd"):
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    return Optimizer(
        params, cfg.optimizer, lr=cfg.learning_rate,
        weight_decay=cfg.weight_decay if cfg.optimizer == "adamw" else 0.0,
        clip=cfg.gradient_clip if cfg.gradient_clip and
        cfg.gradient_clip > 0 else 0.0,
        accumulate=max(cfg.gradient_accumulation_steps, 1),
        schedule=build_schedule(cfg))


class TrainingOptimizer:
    """A generic trainer over an nn.Module and a loss fn(logits, masks)."""

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 config: Optional[TrainingConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.loss_fn = loss_fn
        self.config = config or TrainingConfig()
        self.tx = build_optimizer(self.config, self.model.parameters())
        self.dtype = (torch.bfloat16 if self.config.compute_dtype ==
                      "bfloat16" else None)
        self.history: Dict[str, List[float]] = {
            "train_loss": [], "val_loss": [], "lr": [], "epoch_time": []}

    def init_state(self, example_batch=None) -> Dict[str, Any]:
        """The state train() carries: the model, its optimizer, the step
        count. The model holds its own initial weights (JAX initializes
        its module from config.seed here)."""
        return {"model": self.model, "opt_state": self.tx, "step": 0}

    def _batch(self, batch):
        return (torch.as_tensor(batch["image"]).to(self.device),
                torch.as_tensor(batch["mask"]).to(self.device))

    def step(self, state: Dict[str, Any], batch) -> tuple:
        """One micro-step: forward, loss, backward, the optimizer (which
        applies an update every gradient_accumulation_steps steps).
        Returns (state, loss as a tensor on the device)."""
        images, masks = self._batch(batch)
        model = state["model"].train()
        with compute_autocast(self.device, self.dtype):
            out = model(images)
        loss = self.loss_fn(out.float(), masks)
        grads = torch.autograd.grad(loss, self.tx.params)
        state["opt_state"].step(list(grads))
        state["step"] += 1
        return state, loss.detach()

    @torch.no_grad()
    def _val_loss(self, state, val_batches_fn) -> float:
        model = state["model"].eval()
        losses = []
        for batch in val_batches_fn():
            images, masks = self._batch(batch)
            with compute_autocast(self.device, self.dtype):
                out = model(images)
            losses.append(self.loss_fn(out.float(), masks))
        return (float(torch.stack(losses).mean()) if losses
                else float("nan"))

    def train(self, batches_fn: Callable[[], Any], epochs: int,
              val_batches_fn: Optional[Callable[[], Any]] = None,
              state: Optional[Dict] = None) -> Dict[str, Any]:
        """batches_fn() yields dict batches with 'image' (N, H, W, 3) and
        'mask'; an epoch reads its losses once, at its end."""
        best_val = float("inf")
        bad = 0
        for epoch in range(epochs):
            t0 = time.time()
            losses = []
            for batch in batches_fn():
                if state is None:
                    state = self.init_state(batch)
                state, loss = self.step(state, batch)
                losses.append(loss)
            train_loss = (float(torch.stack(losses).float().mean())
                          if losses else float("nan"))
            self.history["train_loss"].append(train_loss)
            self.history["epoch_time"].append(time.time() - t0)
            val_loss = float("nan")
            if val_batches_fn is not None:
                val_loss = self._val_loss(state, val_batches_fn)
            self.history["val_loss"].append(val_loss)
            logger.info("epoch %d: train=%.4f val=%.4f", epoch + 1,
                        train_loss, val_loss)
            if val_loss < best_val:
                best_val = val_loss
                bad = 0
            else:
                bad += 1
                if bad >= self.config.early_stopping_patience:
                    logger.info("early stop at epoch %d", epoch + 1)
                    break
        self.save_history()
        return {"state": state, "history": self.history,
                "best_val_loss": best_val}

    def save_history(self) -> str:
        os.makedirs(self.config.output_dir, exist_ok=True)
        path = os.path.join(self.config.output_dir,
                            "training_history.json")
        with open(path, "w") as f:
            json.dump(self.history, f, indent=2)
        return path
