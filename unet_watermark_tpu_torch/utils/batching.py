"""Batch planning (utils/batching.py in the JAX package).

make_buckets and pad_to_bucket are JAX's: a power-of-two ladder of batch
sizes and the smallest bucket that takes n. AdaptiveBatchProcessor is
JAX's host-job API: a chunk that fails is split in half and retried, down
to the minimum size. BatchSizeOptimizer finds the largest power-of-two
batch whose run fits in the card's memory: JAX asks XLA for each batch's
memory plan ahead of time; the card has no such plan, so each batch runs
once and its peak (TPUMemoryManager.compiled_memory_bytes,
torch.cuda.max_memory_allocated) is held against the card's total memory
× safety. A torch.cuda.OutOfMemoryError ends the ladder there; any other
error raises.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .memory import (TPUMemoryManager, device_of,
                     get_global_memory_manager)

logger = logging.getLogger(__name__)


class BatchSizeOptimizer:
    """The largest power-of-two batch (up to max_batch) whose run fits."""

    def __init__(self, make_fn: Callable[[int], tuple],
                 max_batch: int = 256,
                 memory_manager: Optional[TPUMemoryManager] = None,
                 safety: float = 0.9):
        """make_fn(batch) -> (fn, example_args): fn(*example_args) runs one
        batch. `peaks` keeps each measured batch's peak bytes (None where
        no argument was on a card)."""
        self.make_fn = make_fn
        self.max_batch = max_batch
        self.mm = memory_manager or get_global_memory_manager()
        self.safety = safety
        self.peaks: Dict[int, Optional[int]] = {}

    def find_optimal_batch_size(self) -> int:
        best = 1
        b = 1
        while b <= self.max_batch:
            fn, args = self.make_fn(b)
            try:
                need = self.mm.compiled_memory_bytes(fn, *args)
                if need is None:  # no argument on a card: the run decides
                    fn(*args)
            except torch.cuda.OutOfMemoryError:
                logger.info("batch %d ran out of the card's memory", b)
                torch.cuda.empty_cache()
                break
            self.peaks[b] = need
            if need is not None:
                _, total = torch.cuda.mem_get_info(device_of(args))
                if need > total * self.safety:
                    break
            best = b
            b *= 2
        logger.info("optimal batch size: %d", best)
        return best


class AdaptiveBatchProcessor:
    """Host-side chunked job processor with failure-halving."""

    def __init__(self, process_fn: Callable[[Sequence[Any]], Sequence[Any]],
                 initial_batch_size: int = 8, min_batch_size: int = 1,
                 max_batch_size: int = 64):
        self.process_fn = process_fn
        self.batch_size = initial_batch_size
        self.min_batch_size = min_batch_size
        self.max_batch_size = max_batch_size
        self.stats: Dict[str, float] = {
            "processed": 0, "failed": 0, "batches": 0, "total_time": 0.0}

    def process_batch(self, items: Sequence[Any]) -> List[Any]:
        """Process one chunk; on failure split it in half and retry each
        half; a chunk of min_batch_size that fails is counted and
        dropped. Success grows the chunk size by one, up to the max."""
        t0 = time.time()
        try:
            out = list(self.process_fn(items))
            self.stats["processed"] += len(items)
            self.stats["batches"] += 1
            self.stats["total_time"] += time.time() - t0
            if self.batch_size < self.max_batch_size:
                self.batch_size = min(self.batch_size + 1,
                                      self.max_batch_size)
            return out
        except Exception as e:  # noqa: BLE001 - the halving is the point
            if len(items) <= self.min_batch_size:
                logger.error("item failed at min batch size: %s", e)
                self.stats["failed"] += len(items)
                return []
            logger.warning("batch of %d failed (%s); halving", len(items), e)
            self.batch_size = max(self.batch_size // 2, self.min_batch_size)
            mid = len(items) // 2
            return (self.process_batch(items[:mid]) +
                    self.process_batch(items[mid:]))

    def process_all(self, items: Sequence[Any]) -> List[Any]:
        out: List[Any] = []
        i = 0
        while i < len(items):
            chunk = items[i:i + self.batch_size]
            out.extend(self.process_batch(chunk))
            i += len(chunk)
        return out

    def get_statistics(self) -> Dict[str, float]:
        s = dict(self.stats)
        if s["batches"]:
            s["avg_batch_time"] = s["total_time"] / s["batches"]
        s["current_batch_size"] = self.batch_size
        return s


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest where none is)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


def make_buckets(max_batch: int) -> List[int]:
    """Power-of-two bucket ladder up to max_batch."""
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return sorted(set(out))
