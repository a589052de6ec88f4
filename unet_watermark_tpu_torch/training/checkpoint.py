"""Checkpoints (training/checkpoint.py in the JAX package): a directory
per checkpoint with

  tree.npz   params/<flax path>, batch_stats/<flax path>, step, and the
             optimizer state: opt_state/count, opt_state/{mu,nu}/<path>
             (Adam) or opt_state/trace/<path> (SGD); float32, conv
             kernels HWIO as in the flax tree
  meta.json  epoch, best_val_loss, history, scheduler, early_stopping,
             config: the JAX package's keys

A best-model save is slim (no optimizer state), as in the JAX package;
restoring one, or a checkpoint of another optimizer, keeps the parameters
and statistics with a fresh optimizer state (with a warning, as JAX's
fallback gives one).

The port writes tree.npz where the JAX package writes orbax; it reads
both. Beside its own directories it reads the JAX package's: a checkpoint
directory holding the orbax tree in tree/ (and meta.json beside it), and
a bare orbax directory (train_inpaint's and train_latent_diffusion's
outputs), through training/ocdbt.py. Their leaves come out under the
port's flat names, "/".join(key path): params/<flax path>,
batch_stats/<flax path>, step, and the optax state as it is nested
(opt_state/1/inner_state/1/mu/<path> and so on). restore_checkpoint maps
that optax state onto the port's Optimizer for each OPTIMIZER.NAME the
JAX package builds (its make_optimizer): the injected state is
opt_state/1 with TRAIN.GRADIENT_CLIP > 0 (the clip chained in front) and
opt_state itself without; inside it, Adam's moments and count are
inner_state/1, AdamW's inner_state/0, SGD's trace inner_state/1, and the
injected learning rate is hyperparams/learning_rate.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.convert import flax_name
from .ocdbt import is_orbax_dir, read_pytree

logger = logging.getLogger(__name__)

CKPT_RE = re.compile(r"^checkpoint_epoch_(\d+)$")


def _abspath(p: str) -> str:
    return os.path.abspath(os.path.expanduser(p))


def _np(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a


def _torch(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device,
                                                        like.dtype)


def snapshot(state, with_opt: bool = True) -> Dict[str, np.ndarray]:
    """The state as a flat dict of host arrays (a copy: the live state may
    go on training while a worker writes it)."""
    tree = {}
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    for name, t in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            tree[flax_name(name)] = _np(t).copy()
    tree["step"] = _np(state.step).copy()
    if with_opt:
        tree["opt_state/count"] = _np(state.opt.count).copy()
        for kind, tensors in state.opt.state_tensors().items():
            for name, t in zip(names, tensors):
                key = flax_name(name)[len("params/"):]
                tree[f"opt_state/{kind}/{key}"] = _np(t).copy()
    return tree


def save_checkpoint(directory: str, name: str, state, meta: Dict[str, Any]
                    ) -> str:
    """Write tree.npz (from a TrainState or a snapshot) and meta.json under
    directory/name; returns the checkpoint's path."""
    path = _abspath(os.path.join(directory, name))
    os.makedirs(path, exist_ok=True)
    tree = state if isinstance(state, dict) else snapshot(state)
    tmp = os.path.join(path, "tree.tmp.npz")
    np.savez(tmp, **tree)
    os.replace(tmp, os.path.join(path, "tree.npz"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=_json_default)
    return path


def _read_meta(path: str) -> Dict[str, Any]:
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _restore(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any],
                                 bool]:
    """(tree, meta, whether the tree came from orbax) of a checkpoint
    directory of either package. A directory that is neither raises
    FileNotFoundError."""
    path = _abspath(path)
    tree_npz = os.path.join(path, "tree.npz")
    if os.path.exists(tree_npz):
        with np.load(tree_npz) as data:
            tree = {k: data[k] for k in data.files}
        return tree, _read_meta(path), False
    orbax_tree = os.path.join(path, "tree")
    if is_orbax_dir(orbax_tree):
        return read_pytree(orbax_tree), _read_meta(path), True
    if is_orbax_dir(path):
        return read_pytree(path), _read_meta(path), True
    raise FileNotFoundError(
        f"no checkpoint at {path}: neither the port's tree.npz nor an "
        f"orbax tree (a tree/ folder, or _METADATA and manifest.ocdbt)")


def restore_raw(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(tree, meta) of a checkpoint, without a model: the port's tree.npz
    directory, a JAX checkpoint directory (tree/ and meta.json) or a bare
    orbax directory."""
    tree, meta, _ = _restore(path)
    return tree, meta


def _port_opt_keys(tree: Dict[str, np.ndarray], opt
                   ) -> Dict[str, np.ndarray]:
    """An orbax tree's optax state under the port's names for `opt`
    (opt_state/count, opt_state/{mu,nu,trace}/<path>,
    opt_state/learning_rate); where the tree holds no state of this
    optimizer and clip setting, none."""
    base = "opt_state/1" if opt.clip > 0 else "opt_state"
    inner = f"{base}/inner_state/{0 if opt.name == 'adamw' else 1}/"
    out = {k: v for k, v in tree.items() if not k.startswith("opt_state/")}
    for k, v in tree.items():
        if k.startswith(inner):
            out["opt_state/" + k[len(inner):]] = v
    lr = tree.get(f"{base}/hyperparams/learning_rate")
    if lr is not None:
        out["opt_state/learning_rate"] = lr
    return out


@torch.no_grad()
def restore_checkpoint(path: str, state) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint of either package into `state` in place; returns
    (state, meta). The optimizer state comes back where the checkpoint has
    one for this optimizer (and, from orbax, this clip setting), else it
    starts fresh (with a warning)."""
    tree, meta, orbax = _restore(path)
    model, opt = state.model, state.opt
    if orbax:
        tree = _port_opt_keys(tree, opt)
    sd = model.state_dict()
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        key = flax_name(name)
        if key not in tree:
            raise KeyError(f"checkpoint {path} has no '{key}'")
        t.copy_(_torch(tree[key], t))
    state.step.fill_(int(tree.get("step", 0)))
    names = [n for n, _ in model.named_parameters()]
    kinds = opt.state_tensors()
    keys = {kind: [f"opt_state/{kind}/" + flax_name(n)[len("params/"):]
                   for n in names] for kind in kinds}
    has_count = "opt_state/count" in tree or opt.name == "sgd"
    if has_count and all(k in tree for ks in keys.values() for k in ks):
        opt.count.fill_(int(tree.get("opt_state/count", 0)))
        for kind, tensors in kinds.items():
            for key, t in zip(keys[kind], tensors):
                t.copy_(_torch(tree[key], t))
        if "opt_state/learning_rate" in tree:
            opt.lr.fill_(float(tree["opt_state/learning_rate"]))
    else:
        logger.warning("%s holds no %s optimizer state; restoring params "
                       "and batch_stats with a fresh optimizer state", path,
                       opt.name)
        opt.count.zero_()
        for tensors in kinds.values():
            for t in tensors:
                t.zero_()
    return state, meta


def latest_checkpoint(directory: str) -> Optional[str]:
    directory = _abspath(directory)
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    for d in os.listdir(directory):
        m = CKPT_RE.match(d)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(directory, d)
    return best


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
