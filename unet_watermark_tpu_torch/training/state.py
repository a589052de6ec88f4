"""Train state, the optimizer, the LR scheduler and early stopping
(training/state.py in the JAX package).

Optimizer computes what the JAX package's make_optimizer builds with optax,
in the same order, on the parameters' device with foreach ops and no host
sync:

  clip_by_global_norm(GRADIENT_CLIP)  g / norm · clip where norm ≥ clip
                                      (optax's form; not clip_grad_norm_,
                                      which adds 1e-6 to the norm)
  "adam"   add_decayed_weights(wd) → scale_by_adam → scale(-lr)
  "adamw"  scale_by_adam → add_decayed_weights(wd) → scale(-lr)
  "sgd"    add_decayed_weights(wd) → trace(0.9) → scale(-lr)

scale_by_adam is optax's with b1 0.9, b2 0.999, eps 1e-8, eps_root 0: the
moments (1-b)·g + b·m, an int32 count, bias corrections 1 - b^count in
float32. The learning rate is a float32 tensor on the device that the
epoch loop sets (with_lr), as optax's injected hyperparameter, or, given
`schedule`, schedule(k) before the k-th update (k from 0), as optax's
scale_by_learning_rate(schedule). `accumulate` = k > 1 is optax.MultiSteps
(k): each step folds its gradients into their running mean (acc + (g -
acc) / (n + 1)), and every k-th step applies the update to that mean and
clears it; the other steps leave the parameters as they are.

LRScheduler and EarlyStopping are the JAX package's plain Python classes.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

B1, B2, EPS = 0.9, 0.999, 1e-8
OPTIMIZERS = ("adam", "adamw", "sgd")


class Optimizer:
    def __init__(self, params, name: str = "adam", lr: float = 1e-3,
                 weight_decay: float = 0.0, clip: float = 0.0,
                 accumulate: int = 1,
                 schedule: Optional[Callable[[int], float]] = None):
        self.name = name.lower()
        if self.name not in OPTIMIZERS:
            raise ValueError(f"unsupported optimizer '{name}'")
        self.params: List[torch.Tensor] = list(params)
        self.wd = float(weight_decay)
        self.clip = float(clip or 0.0)
        dev = self.params[0].device
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa
        self.mu = zeros() if self.name != "sgd" else []
        self.nu = zeros() if self.name != "sgd" else []
        self.trace = zeros() if self.name == "sgd" else []
        self.accumulate = int(accumulate)
        if self.accumulate < 1:
            raise ValueError(f"accumulate must be >= 1, got {accumulate}")
        self.acc = zeros() if self.accumulate > 1 else []
        self.mini_step = 0  # steps folded into acc since the last update
        self.updates = 0  # updates applied: the schedule's step
        self.schedule = schedule

    def clip_by_global_norm(self, grads: List[torch.Tensor]) -> None:
        """In place: optax's clip_by_global_norm. The norm sums in float64
        (float32 per-tensor norms lose ~4e-6 of it over a 25 M-parameter
        model; optax's float32 sum of squares is ~4e-7 off)."""
        norms = torch._foreach_norm(grads, 2, dtype=torch.float64)
        norm = torch.stack(norms).square().sum().sqrt().float()
        keep = norm < self.clip
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, self.clip))

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> bool:
        """Update the parameters in place from `grads` (default: each
        parameter's .grad), which this overwrites. Returns whether the
        parameters moved (False on a step that only accumulates)."""
        g = [p.grad for p in self.params] if grads is None else list(grads)
        if self.accumulate > 1:
            diff = torch._foreach_sub(g, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                return False
            self.mini_step = 0
            g = self.acc  # used, then cleared below
        if self.schedule is not None:
            self.lr.fill_(float(self.schedule(self.updates)))
        self._apply(g)
        self.updates += 1
        if self.accumulate > 1:
            torch._foreach_zero_(self.acc)
        return True

    def _apply(self, g: List[torch.Tensor]) -> None:
        if self.clip > 0:
            self.clip_by_global_norm(g)
        if self.wd and self.name in ("adam", "sgd"):
            torch._foreach_add_(g, self.params, alpha=self.wd)
        if self.name == "sgd":
            torch._foreach_mul_(self.trace, 0.9)
            torch._foreach_add_(self.trace, g)
            upd = torch._foreach_mul(self.trace, -self.lr)
        else:
            torch._foreach_mul_(self.mu, B1)
            torch._foreach_add_(self.mu, g, alpha=1.0 - B1)
            torch._foreach_mul_(self.nu, B2)
            torch._foreach_addcmul_(self.nu, g, g, value=1.0 - B2)
            self.count += 1
            t = self.count.float()
            bc1 = 1.0 - torch.pow(B1, t)  # a float32 power on the card
            bc2 = 1.0 - torch.pow(B2, t)
            upd = torch._foreach_div(self.mu, bc1)
            den = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            torch._foreach_div_(upd, den)
            if self.wd and self.name == "adamw":
                torch._foreach_add_(upd, self.params, alpha=self.wd)
            torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(self.params, upd)

    def state_tensors(self) -> Dict[str, List[torch.Tensor]]:
        """The optimizer's state: per-parameter lists and the count."""
        if self.name == "sgd":
            return {"trace": self.trace}
        return {"mu": self.mu, "nu": self.nu}


def make_optimizer(cfg, model: nn.Module) -> Optimizer:
    return Optimizer(model.parameters(), cfg.OPTIMIZER.NAME, cfg.TRAIN.LR,
                     cfg.TRAIN.WEIGHT_DECAY, cfg.TRAIN.GRADIENT_CLIP)


class TrainState:
    """The model (fp32 parameters, BatchNorm running statistics as
    buffers), its optimizer and the step count."""

    def __init__(self, model: nn.Module, opt: Optimizer):
        self.model = model
        self.opt = opt
        self.step = torch.zeros((), dtype=torch.int32,
                                device=opt.count.device)

    def with_lr(self, lr: float) -> "TrainState":
        self.opt.lr.fill_(float(lr))
        return self


class LRScheduler:
    """Epoch-stepped scheduler with torch semantics: step(val_loss) returns
    the new lr. ReduceLROnPlateau watches val_loss (min mode); the others
    are functions of the epoch index."""

    def __init__(self, cfg, base_lr: Optional[float] = None):
        self.kind = cfg.OPTIMIZER.LR_SCHEDULER
        self.base_lr = base_lr if base_lr is not None else cfg.TRAIN.LR
        self.factor = cfg.OPTIMIZER.SCHEDULER_FACTOR
        self.patience = cfg.OPTIMIZER.SCHEDULER_PATIENCE
        self.t0 = cfg.OPTIMIZER.SCHEDULER_T_0
        self.t_mult = cfg.OPTIMIZER.SCHEDULER_T_MULT
        self.eta_min = cfg.OPTIMIZER.SCHEDULER_ETA_MIN
        self.epochs = cfg.TRAIN.EPOCHS
        self._lr = self.base_lr
        self._best = float("inf")
        self._bad_epochs = 0
        self._epoch = 0

    def step(self, val_loss: Optional[float] = None) -> float:
        self._epoch += 1
        kind = (self.kind or "").lower()
        if kind in ("", "none"):
            pass
        elif kind == "reducelronplateau":
            if val_loss is not None:
                if val_loss < self._best - 1e-8:
                    self._best = val_loss
                    self._bad_epochs = 0
                else:
                    self._bad_epochs += 1
                    if self._bad_epochs > self.patience:
                        self._lr *= self.factor
                        self._bad_epochs = 0
        elif kind == "cosineannealingwarmrestarts":
            t_cur, t_i = self._epoch, self.t0
            while t_cur >= t_i:
                t_cur -= t_i
                t_i *= self.t_mult
            self._lr = (self.eta_min + (self.base_lr - self.eta_min) *
                        (1 + math.cos(math.pi * t_cur / t_i)) / 2)
        elif kind == "cosineannealing":
            self._lr = (self.eta_min + (self.base_lr - self.eta_min) *
                        (1 + math.cos(math.pi * self._epoch /
                                      max(self.epochs, 1))) / 2)
        elif kind == "steplr":
            if self._epoch % max(self.patience, 1) == 0:
                self._lr *= self.factor
        else:
            raise ValueError(f"unsupported scheduler '{self.kind}'")
        return self._lr

    def state_dict(self) -> Dict[str, Any]:
        return {"lr": self._lr, "best": self._best,
                "bad_epochs": self._bad_epochs, "epoch": self._epoch}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self._lr = d["lr"]
        self._best = d["best"]
        self._bad_epochs = d["bad_epochs"]
        self._epoch = d["epoch"]


class EarlyStopping:
    """min-mode early stopping."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def __call__(self, val_loss: float) -> bool:
        if self.best is None or val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop

    def state_dict(self):
        return {"best": self.best, "counter": self.counter,
                "should_stop": self.should_stop}

    def load_state_dict(self, d):
        self.best = d["best"]
        self.counter = d["counter"]
        self.should_stop = d["should_stop"]
