"""Profiling (utils/profiler.py in the JAX package): a timer, a rolling
monitor, a trace of the card and named regions.

The names are JAX's. `timer` waits for the card's queued work
(torch.cuda.synchronize) where JAX waits on its effects barrier.
`xla_trace(log_dir)` keeps its name and writes a torch.profiler trace of
the block (CPU and CUDA activities; a Chrome trace, trace.json, in
log_dir) where JAX writes an XLA profile. `annotate(name)` is
torch.profiler.record_function, a named range in that trace.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def timer(name: str = "block", sync: bool = True, log: bool = True):
    """Wall-clock timer; with sync=True (and a card) it waits for the
    card's queued work, so the time covers asynchronous launches."""
    start = time.perf_counter()
    result = {"name": name, "seconds": None}
    try:
        yield result
    finally:
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        result["seconds"] = time.perf_counter() - start
        if log:
            logger.info("%s: %.4fs", name, result["seconds"])


class PerformanceMonitor:
    """Rolling per-name statistics over the last `window` samples."""

    def __init__(self, window: int = 100):
        self.window = window
        self._samples: Dict[str, collections.deque] = {}

    def record(self, name: str, seconds: float) -> None:
        self._samples.setdefault(
            name, collections.deque(maxlen=self.window)).append(seconds)

    @contextlib.contextmanager
    def track(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def stats(self, name: str) -> Optional[Dict[str, float]]:
        s = self._samples.get(name)
        if not s:
            return None
        vals = sorted(s)
        n = len(vals)
        return {
            "count": n,
            "mean": sum(vals) / n,
            "min": vals[0],
            "max": vals[-1],
            "p50": vals[n // 2],
            "p95": vals[min(int(n * 0.95), n - 1)],
            "p99": vals[min(int(n * 0.99), n - 1)],
        }

    def all_stats(self) -> Dict[str, Dict[str, float]]:
        return {k: self.stats(k) for k in self._samples}


@contextlib.contextmanager
def xla_trace(log_dir: str = "profiler_trace"):
    """A torch.profiler trace of the enclosed block (CPU activities, and
    CUDA's where there is a card), written to log_dir/trace.json. The name
    is the JAX package's, whose trace is XLA's. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("trace written to %s", path)


def annotate(name: str):
    """A named range that shows up in xla_trace's trace."""
    return torch.profiler.record_function(name)
