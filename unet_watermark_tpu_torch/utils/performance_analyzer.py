"""Performance analysis (utils/performance_analyzer.py in the JAX package):

  * SystemMonitor: a background thread sampling the host's CPU percent
    (the change of /proc/stat's counters between two samples), its RAM
    (/proc/meminfo) and the card's memory (torch.cuda.mem_get_info), where
    JAX reads psutil and its devices' memory_stats
  * PerformanceProfiler: per-operation timing with p50/p95/p99 and a
    decorator
  * PerformanceAnalyzer: JAX's recommendation rules (its thresholds in
    its order; the words name the card where JAX's name the TPU) and its
    JSON and Markdown report, with the same keys. JAX also draws a PNG
    plot with matplotlib when it is installed; the port writes none (the
    card's machine has no matplotlib)
"""
from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .memory import device_memory, host_memory
from .profiler import PerformanceMonitor

logger = logging.getLogger(__name__)


def _cpu_times() -> Tuple[int, int]:
    """(busy, total) jiffies over every CPU, from /proc/stat's first line
    (idle and iowait count as not busy)."""
    with open("/proc/stat") as f:
        fields = [int(v) for v in f.readline().split()[1:]]
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0)
    # guest times are already inside user and nice
    total = sum(fields[:8])
    return total - idle, total


@dataclasses.dataclass
class SystemSample:
    timestamp: float
    cpu_percent: float
    ram_percent: float
    device_percent: float
    device_bytes_in_use: int


class SystemMonitor:
    """A sampler at `interval` seconds (1 Hz by default)."""

    def __init__(self, interval: float = 1.0, history: int = 3600):
        self.interval = interval
        self.max_history = history
        self.samples: List[SystemSample] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_cpu = _cpu_times()

    def sample(self) -> SystemSample:
        """One sample; its CPU percent covers the time since the previous
        sample (or since the monitor was made)."""
        busy, total = _cpu_times()
        d_busy = busy - self._last_cpu[0]
        d_total = total - self._last_cpu[1]
        self._last_cpu = (busy, total)
        dev = device_memory()
        s = SystemSample(
            timestamp=time.time(),
            cpu_percent=100.0 * d_busy / d_total if d_total > 0 else 0.0,
            ram_percent=host_memory()["percent"],
            device_percent=(100.0 * dev["in_use"] / dev["limit"]
                            if dev["limit"] else 0.0),
            device_bytes_in_use=dev["in_use"])
        self.samples.append(s)
        if len(self.samples) > self.max_history:
            self.samples = self.samples[-self.max_history // 2:]
        return s

    def start(self):
        if self._thread:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.sample()
                except Exception as e:  # noqa: BLE001 - keep sampling
                    logger.debug("monitor sample failed: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        if not self._thread:
            return
        self._stop.set()
        self._thread.join(timeout=2)
        self._thread = None

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        cpu = [s.cpu_percent for s in self.samples]
        ram = [s.ram_percent for s in self.samples]
        dev = [s.device_percent for s in self.samples]
        return {
            "samples": len(self.samples),
            "cpu_avg": sum(cpu) / len(cpu), "cpu_max": max(cpu),
            "ram_avg": sum(ram) / len(ram), "ram_max": max(ram),
            "device_avg": sum(dev) / len(dev), "device_max": max(dev),
        }


class PerformanceProfiler(PerformanceMonitor):
    """Per-operation profiler with a decorator."""

    def profile(self, name: Optional[str] = None):
        def deco(fn: Callable):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.record(label, time.perf_counter() - t0)

            return wrapper

        return deco


class PerformanceAnalyzer:
    """The monitor and the profiler behind one object."""

    def __init__(self, monitor_interval: float = 1.0):
        self.monitor = SystemMonitor(interval=monitor_interval)
        self.profiler = PerformanceProfiler()

    def start(self):
        self.monitor.start()

    def stop(self):
        self.monitor.stop()

    def performance_profile(self, name: Optional[str] = None):
        """Decorator timing each call under `name`."""
        return self.profiler.profile(name)

    # ---- recommendations: JAX's rules (thresholds, order), naming the card
    # where JAX names the TPU
    def recommendations(self) -> List[str]:
        recs: List[str] = []
        summary = self.monitor.summary()
        if not summary:
            return ["no samples collected — call start() first"]
        if summary["device_avg"] < 30:
            recs.append(
                "device memory utilization is low — increase batch size "
                "or image size to fill the card")
        if summary["device_max"] > 92:
            recs.append(
                "device memory near limit — enable MODEL.REMAT or reduce "
                "batch size")
        if summary["cpu_avg"] > 85:
            recs.append(
                "host CPU saturated — the input pipeline may be starving "
                "the card; raise DATA.NUM_WORKERS or pre-resize images")
        if summary["ram_avg"] > 85:
            recs.append("host RAM pressure — disable DATA.CACHE_IMAGES")
        ops = self.profiler.all_stats()
        for name, st in ops.items():
            if st and st["p95"] > 4 * st["p50"]:
                recs.append(
                    f"'{name}' has heavy tail latency (p95 {st['p95']:.3f}s "
                    f"vs p50 {st['p50']:.3f}s) — look for changing shapes "
                    f"(cuDNN's per-shape set-up) or host sync points")
        if not recs:
            recs.append("no issues detected")
        return recs

    # ---- reports -----------------------------------------------------------
    def export_report(self, output_dir: str) -> Dict[str, str]:
        """performance_report.json (system, operations, recommendations)
        and performance_report.md in output_dir; returns their paths."""
        os.makedirs(output_dir, exist_ok=True)
        data = {
            "system": self.monitor.summary(),
            "operations": self.profiler.all_stats(),
            "recommendations": self.recommendations(),
        }
        json_path = os.path.join(output_dir, "performance_report.json")
        with open(json_path, "w") as f:
            json.dump(data, f, indent=2)
        md_path = os.path.join(output_dir, "performance_report.md")
        with open(md_path, "w") as f:
            f.write("# Performance report\n\n## System\n\n")
            for k, v in (data["system"] or {}).items():
                f.write(f"- {k}: {v:.2f}\n" if isinstance(v, float)
                        else f"- {k}: {v}\n")
            f.write("\n## Operations\n\n")
            for name, st in (data["operations"] or {}).items():
                if st:
                    f.write(f"- **{name}**: n={st['count']} "
                            f"mean={st['mean'] * 1e3:.1f}ms "
                            f"p50={st['p50'] * 1e3:.1f}ms "
                            f"p95={st['p95'] * 1e3:.1f}ms\n")
            f.write("\n## Recommendations\n\n")
            for r in data["recommendations"]:
                f.write(f"- {r}\n")
        return {"json": json_path, "markdown": md_path}
