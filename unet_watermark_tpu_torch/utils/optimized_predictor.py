"""Batched inference around any forward function
(utils/optimized_predictor.py in the JAX package): fixed-size batches on
the card with the remainder padded with zeros to the batch size, pre- and
post-processing hooks, optional batch-size tuning, per-batch timing and
result saving.

forward_fn takes an (N, ...) tensor on the predictor's device and returns
a tensor (N, ...), or a tuple of outputs each with N rows (a tensor, or a
list of N values, as predict_artifact_masks' (masks, types)); each item's
result is its row (a tuple of rows for a tuple). The JAX class jits the
function; here it runs as given (eager, on the card), and its outputs
stay where it puts them.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .batching import BatchSizeOptimizer
from .device import resolve_device
from .profiler import PerformanceMonitor

logger = logging.getLogger(__name__)


def _rows(out, n: int) -> list:
    """The first n rows of a forward's output, one entry a row."""
    if isinstance(out, tuple):
        return list(zip(*(_rows(o, n) for o in out)))
    return list(out[:n])


class OptimizedPredictor:
    def __init__(self, forward_fn: Callable,
                 batch_size: int = 8,
                 preprocess: Optional[Callable[[Any], Any]] = None,
                 postprocess: Optional[Callable[[Any], Any]] = None,
                 auto_tune_batch: bool = False,
                 example_input=None,
                 max_batch_size: int = 128,
                 device="cuda"):
        self.forward = forward_fn
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.preprocess = preprocess or (lambda x: x)
        self.postprocess = postprocess or (lambda x: x)
        self.monitor = PerformanceMonitor()
        self.tuner: Optional[BatchSizeOptimizer] = None
        if auto_tune_batch and example_input is not None:
            self.batch_size = self._tune(example_input, max_batch_size)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _tune(self, example, max_batch: int) -> int:
        """The largest power-of-two batch of `example` whose run fits
        (BatchSizeOptimizer: one run a batch, its measured peak)."""
        one = self._tensor(self.preprocess(example))

        def make(b):
            return self.forward, (one[None].expand((b,) + one.shape)
                                  .contiguous(),)

        self.tuner = BatchSizeOptimizer(make, max_batch=max_batch)
        return self.tuner.find_optimal_batch_size()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, items: Sequence[Any]) -> List[Any]:
        """Batches of batch_size, the last padded with zero rows; each
        item's result, post-processed."""
        outputs: List[Any] = []
        bs = self.batch_size
        for i in range(0, len(items), bs):
            chunk = [self._tensor(self.preprocess(x))
                     for x in items[i:i + bs]]
            n = len(chunk)
            batch = torch.stack(chunk)
            if n < bs:
                batch = torch.cat([batch, batch.new_zeros(
                    (bs - n,) + batch.shape[1:])])
            with self.monitor.track("batch"):
                out = self.forward(batch)
                self._sync()
            outputs.extend(self.postprocess(o) for o in _rows(out, n))
        return outputs

    def predict_and_save(self, items: Sequence[Any], output_dir: str,
                         names: Optional[Sequence[str]] = None,
                         saver: Optional[Callable] = None) -> List[str]:
        """predict, then one file an item: saver(path, result), or np.save
        of the result (a tensor is copied to the host)."""
        os.makedirs(output_dir, exist_ok=True)
        results = self.predict(items)
        paths = []
        for i, r in enumerate(results):
            name = names[i] if names else f"result_{i:06d}.npy"
            path = os.path.join(output_dir, name)
            if saver:
                saver(path, r)
            else:
                np.save(path, r.cpu().numpy() if torch.is_tensor(r)
                        else np.asarray(r))
            paths.append(path)
        return paths

    def get_statistics(self) -> Dict:
        st = self.monitor.stats("batch") or {}
        if st:
            st["images_per_second"] = self.batch_size / st["mean"]
        st["batch_size"] = self.batch_size
        return st
