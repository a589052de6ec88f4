"""Memory management (utils/memory.py in the JAX package), on the card.

The names are JAX's, TPUMemoryManager among them, so that callers import
what they imported there; what they read is the CUDA card's memory and the
host's:

  * snapshots of host RAM (/proc/meminfo: used = MemTotal - MemAvailable)
    and of the process's card (torch.cuda.mem_get_info: in use = total -
    free as CUDA reports it, limit = total; the caching allocator's
    allocated and reserved bytes from torch.cuda.memory_stats beside them)
  * pressure thresholds and a background monitor thread with callbacks
  * fits_on_device / compiled_memory_bytes: the peak of one run. XLA plans
    a compiled program's memory ahead of time and JAX asks it; the card
    has no such plan, so the function runs once and the caching
    allocator's peak (torch.cuda.max_memory_allocated) is its need
  * cleanup / aggressive_cleanup free the caching allocator's unused
    blocks (torch.cuda.empty_cache) where JAX clears its compile caches
  * memory_context and the global manager
"""
from __future__ import annotations

import dataclasses
import gc
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)


def _meminfo() -> Dict[str, int]:
    """/proc/meminfo's fields in bytes (MemTotal, MemAvailable, ...)."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            parts = rest.split()
            if parts:
                out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"]
                                            else 1)
    return out


def host_memory() -> Dict[str, float]:
    """Host RAM: total, available and used bytes, and the used percent (as
    psutil.virtual_memory's percent: (total - available) / total)."""
    info = _meminfo()
    total = info["MemTotal"]
    avail = info.get("MemAvailable", info.get("MemFree", 0))
    used = total - avail
    return {"total": total, "available": avail, "used": used,
            "percent": 100.0 * used / total if total else 0.0}


def physical_cores() -> int:
    """Physical cores (distinct physical id / core id pairs of
    /proc/cpuinfo), else os.cpu_count()."""
    cores = set()
    try:
        with open("/proc/cpuinfo") as f:
            phys = core = None
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key == "physical id":
                    phys = val.strip()
                elif key == "core id":
                    core = val.strip()
                elif not key and core is not None:
                    cores.add((phys, core))
                    phys = core = None
            if core is not None:
                cores.add((phys, core))
    except OSError:
        pass
    return len(cores) or os.cpu_count() or 1


def device_memory() -> Dict[str, int]:
    """The process's card (torch.cuda.current_device(): one card a process,
    as the port runs; reading another card would open a context there):
    in use (total - free, mem_get_info), limit (total), and the caching
    allocator's allocated and reserved bytes; zeros without a card."""
    if not torch.cuda.is_available():
        return {"in_use": 0, "limit": 0, "allocated": 0, "reserved": 0}
    free, total = torch.cuda.mem_get_info()
    stats = torch.cuda.memory_stats()
    return {"in_use": total - free, "limit": total,
            "allocated": stats.get("allocated_bytes.all.current", 0),
            "reserved": stats.get("reserved_bytes.all.current", 0)}


@dataclasses.dataclass
class MemorySnapshot:
    timestamp: float
    host_total: int
    host_used: int
    host_percent: float
    device_bytes_in_use: int
    device_bytes_limit: int
    device_bytes_allocated: int = 0  # the caching allocator's
    device_bytes_reserved: int = 0

    @property
    def device_percent(self) -> float:
        if self.device_bytes_limit <= 0:
            return 0.0
        return 100.0 * self.device_bytes_in_use / self.device_bytes_limit


def device_of(args) -> Optional[torch.device]:
    """The CUDA device of the first CUDA tensor among args, else None."""
    for a in args:
        if torch.is_tensor(a) and a.is_cuda:
            return a.device
    return None


class TPUMemoryManager:
    """The JAX package's memory manager, keeping its name; it reads the
    CUDA cards and the host."""

    def __init__(self, warning_threshold: float = 80.0,
                 critical_threshold: float = 92.0,
                 monitor_interval: float = 5.0):
        self.warning_threshold = warning_threshold
        self.critical_threshold = critical_threshold
        self.monitor_interval = monitor_interval
        self.history: List[MemorySnapshot] = []
        self._callbacks: List[Callable[[MemorySnapshot, str], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- snapshots -------------------------------------------------------
    def snapshot(self) -> MemorySnapshot:
        host = host_memory()
        dev = device_memory()
        snap = MemorySnapshot(
            timestamp=time.time(), host_total=host["total"],
            host_used=host["used"], host_percent=host["percent"],
            device_bytes_in_use=dev["in_use"],
            device_bytes_limit=dev["limit"],
            device_bytes_allocated=dev["allocated"],
            device_bytes_reserved=dev["reserved"])
        self.history.append(snap)
        if len(self.history) > 1000:
            self.history = self.history[-500:]
        return snap

    def check_memory_pressure(self) -> str:
        """'ok' | 'warning' | 'critical', from the larger of the host's and
        the cards' used percent; the callbacks hear every level above
        'ok'."""
        snap = self.snapshot()
        level = "ok"
        worst = max(snap.host_percent, snap.device_percent)
        if worst >= self.critical_threshold:
            level = "critical"
        elif worst >= self.warning_threshold:
            level = "warning"
        if level != "ok":
            for cb in self._callbacks:
                cb(snap, level)
        return level

    def cleanup(self) -> None:
        """Collect the host's cycles, then return the caching allocator's
        unused blocks to CUDA."""
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def aggressive_cleanup(self) -> None:
        """cleanup, plus the inter-process blocks the allocator holds. The
        JAX package clears its compile caches here; the port has none."""
        self.cleanup()
        if torch.cuda.is_available():
            torch.cuda.ipc_collect()
            logger.warning("freed the CUDA caching allocator's unused "
                           "blocks (memory pressure)")

    # ---- planning by one run (JAX: by the compiler's plan) ---------------
    @staticmethod
    def compiled_memory_bytes(fn, *example_args) -> Optional[int]:
        """The caching allocator's peak, in bytes, over one run of
        fn(*example_args) on the card of the first CUDA tensor among the
        arguments (every live tensor counts, the arguments and weights
        too); None where no argument is on a card. A run sets it, not a
        compiler plan: JAX asks XLA for the plan without running."""
        dev = device_of(example_args)
        if dev is None:
            return None
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn(*example_args)
        torch.cuda.synchronize(dev)
        return int(torch.cuda.max_memory_allocated(dev))

    def fits_on_device(self, fn, *example_args,
                       safety: float = 0.9) -> Optional[bool]:
        """Whether one run's peak (compiled_memory_bytes) is at most
        safety × the card's total memory; None where no argument is on a
        card. A torch.cuda.OutOfMemoryError propagates."""
        need = self.compiled_memory_bytes(fn, *example_args)
        if need is None:
            return None
        _, total = torch.cuda.mem_get_info(device_of(example_args))
        return need <= total * safety

    # ---- monitor thread --------------------------------------------------
    def add_callback(self, cb: Callable[[MemorySnapshot, str], None]):
        self._callbacks.append(cb)

    def start_monitoring(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.monitor_interval):
                try:
                    self.check_memory_pressure()
                except Exception as e:  # noqa: BLE001 - keep monitoring
                    logger.debug("monitor error: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop_monitoring(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2)
        self._thread = None

    # ---- dataloader advice -----------------------------------------------
    def optimize_dataloader_params(self, sample_bytes: int,
                                   batch_size: int) -> Dict[str, int]:
        """Workers up to the physical cores (at most 16), and a prefetch
        depth that keeps a fifth of the available host memory."""
        avail = host_memory()["available"]
        per_batch = sample_bytes * batch_size
        prefetch = max(1, min(8, int(avail * 0.2 / max(per_batch, 1))))
        workers = max(1, min(16, physical_cores()))
        return {"num_workers": workers, "prefetch_factor": prefetch}


class memory_context:
    """A snapshot before and after a block; logs the change."""

    def __init__(self, manager: Optional[TPUMemoryManager] = None,
                 name: str = "block"):
        self.manager = manager or get_global_memory_manager()
        self.name = name

    def __enter__(self):
        self.before = self.manager.snapshot()
        return self.manager

    def __exit__(self, *exc):
        after = self.manager.snapshot()
        logger.info(
            "%s: device %.1f%%→%.1f%%, host %.1f%%→%.1f%%", self.name,
            self.before.device_percent, after.device_percent,
            self.before.host_percent, after.host_percent)
        return False


_GLOBAL: Optional[TPUMemoryManager] = None


def get_global_memory_manager() -> TPUMemoryManager:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = TPUMemoryManager()
    return _GLOBAL


def log_memory_usage(prefix: str = "") -> MemorySnapshot:
    """One line at INFO: the cards' memory and the host's RAM, with the
    pressure level where it is above 'ok'. Returns the snapshot."""
    mgr = get_global_memory_manager()
    snap = mgr.snapshot()
    level = mgr.check_memory_pressure()
    logger.info(
        "%smemory: device %.2f/%.2f GB (%.1f%%), host %.1f%%%s",
        f"{prefix} " if prefix else "",
        snap.device_bytes_in_use / 1024**3,
        snap.device_bytes_limit / 1024**3, snap.device_percent,
        snap.host_percent, f" [{level}]" if level != "ok" else "")
    return snap
