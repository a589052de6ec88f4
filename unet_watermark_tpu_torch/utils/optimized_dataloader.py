"""Dataset caching and loader benchmarking (utils/optimized_dataloader.py
in the JAX package): an LRU cache over an index-addressable dataset, the
loader's parameters from the host's cores and memory, and the throughput
of a pipeline (data/pipeline.py's DataPipeline or DeviceDataPipeline,
whose batches are dicts with a `valid` row flag).
"""
from __future__ import annotations

import collections
import logging
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


class OptimizedDataset:
    """An LRU cache of up to cache_size items over `dataset`."""

    def __init__(self, dataset, cache_size: int = 512):
        self.dataset = dataset
        self.cache_size = cache_size
        self._cache: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        if idx in self._cache:
            self.hits += 1
            self._cache.move_to_end(idx)
            return self._cache[idx]
        self.misses += 1
        item = self.dataset[idx]
        self._cache[idx] = item
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return item

    def cache_stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "cached": len(self._cache)}


def auto_tune_loader_params(sample_bytes: int, batch_size: int
                            ) -> Dict[str, int]:
    """num_workers and prefetch_factor for batches of batch_size samples
    of sample_bytes each (TPUMemoryManager.optimize_dataloader_params)."""
    from .memory import get_global_memory_manager

    return get_global_memory_manager().optimize_dataloader_params(
        sample_bytes, batch_size)


def benchmark_pipeline(pipeline, max_batches: Optional[int] = 20
                       ) -> Dict[str, float]:
    """The pipeline's throughput over up to max_batches batches: real
    (valid) samples a second. The clock stops after the last batch's
    tensors are on their device (a batch on the card is waited for)."""
    t0 = time.time()
    batches = 0
    samples = 0.0
    valid = []
    for batch in pipeline:
        if "valid" in batch:
            valid.append(torch.as_tensor(batch["valid"]).sum())
        else:
            samples += len(next(iter(batch.values())))
        batches += 1
        if max_batches and batches >= max_batches:
            break
    if valid:  # one read, at the end
        samples += float(torch.stack(valid).sum())
    dt = time.time() - t0
    stats = {"batches": batches, "samples": samples, "seconds": dt,
             "samples_per_second": samples / dt if dt > 0 else 0.0}
    logger.info("pipeline benchmark: %.1f samples/s",
                stats["samples_per_second"])
    return stats
