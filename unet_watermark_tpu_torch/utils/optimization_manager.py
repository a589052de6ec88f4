"""The optimization manager (utils/optimization_manager.py in the JAX
package): the memory manager, the batch planners, the profiler and the
system monitor behind one object, with the global accessor.

apply_global_settings has no XLA compile cache to set up. It changes no
process setting that moves a result: the port's float convs keep their
precision whatever TF32 flag a caller sets (ROADMAP.md §C.2,
inference/predict.py), and cuDNN's autotuner is left as the caller set
it. It logs the card's settings (name, memory, TF32 and cuDNN flags) and
starts the monitors the config asks for. optimize_model_config maps the
policy onto the port's config keys: compute_dtype onto MODEL.DTYPE (bf16
autocast over fp32 parameters), remat onto MODEL.REMAT, and JAX's other
keys as JAX sets them; channels-last has no key, since the port puts its
models in channels-last on every card.
"""
from __future__ import annotations

import contextlib
import copy
import logging
import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from .batching import AdaptiveBatchProcessor, BatchSizeOptimizer
from .memory import TPUMemoryManager
from .optimization_config import OptimizationConfig
from .performance_analyzer import PerformanceAnalyzer

logger = logging.getLogger(__name__)


class OptimizationManager:
    def __init__(self, config: Optional[OptimizationConfig] = None):
        self.config = config or OptimizationConfig.auto_detect()
        self._lock = threading.Lock()
        self.memory_manager = TPUMemoryManager(
            warning_threshold=self.config.memory.warning_threshold,
            critical_threshold=self.config.memory.critical_threshold,
            monitor_interval=self.config.memory.monitor_interval)
        self.analyzer = PerformanceAnalyzer(
            monitor_interval=self.config.monitoring.monitor_interval)
        self._applied_global = False

    # ---- process settings ---------------------------------------------------
    def _device_settings(self) -> Dict[str, Any]:
        """The card's settings as this process sees them (nothing is
        changed)."""
        out: Dict[str, Any] = {
            "cuda": torch.cuda.is_available(),
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark}
        if out["cuda"]:
            free, total = torch.cuda.mem_get_info()
            out.update(device=torch.cuda.get_device_name(),
                       count=torch.cuda.device_count(),
                       memory_total=total, memory_free=free)
        return out

    def apply_global_settings(self) -> None:
        """Log the card's settings and start the monitors the config asks
        for; no process setting is changed (the module's docstring)."""
        with self._lock:
            if self._applied_global:
                return
            logger.info("device settings: %s", self._device_settings())
            if self.config.memory.enable_monitoring:
                self.memory_manager.start_monitoring()
            if self.config.monitoring.system_monitor:
                self.analyzer.start()
            self._applied_global = True

    # ---- model-level settings ---------------------------------------------
    def optimize_model_config(self, cfg) -> Any:
        """A copy of the port's Config with the policy applied: the compute
        dtype (MODEL.DTYPE: "bfloat16" is autocast over fp32 parameters),
        remat, gradient clip, the loader's workers, prefetch and cache, the
        batch size, and JAX's DONATE_STATE and STEPS_PER_EXEC (stored, as
        the port's config stores them)."""
        cfg = copy.deepcopy(cfg)
        cfg.MODEL.DTYPE = self.config.model.compute_dtype
        cfg.MODEL.REMAT = self.config.memory.remat
        cfg.TRAIN.DONATE_STATE = self.config.model.donate_buffers
        cfg.TRAIN.GRADIENT_CLIP = self.config.training.gradient_clip
        cfg.TRAIN.STEPS_PER_EXEC = self.config.training.steps_per_execution
        cfg.DATA.NUM_WORKERS = self.config.dataloader.num_workers
        cfg.DATA.PREFETCH_FACTOR = self.config.dataloader.prefetch_factor
        cfg.DATA.CACHE_IMAGES = self.config.dataloader.cache_images
        cfg.TRAIN.BATCH_SIZE = self.config.batch.initial_batch_size
        return cfg

    # ---- factories ----------------------------------------------------------
    def create_batch_processor(self, process_fn: Callable
                               ) -> AdaptiveBatchProcessor:
        return AdaptiveBatchProcessor(
            process_fn,
            initial_batch_size=self.config.batch.initial_batch_size,
            max_batch_size=self.config.batch.max_batch_size)

    def create_batch_size_optimizer(self, make_fn) -> BatchSizeOptimizer:
        return BatchSizeOptimizer(
            make_fn, max_batch=self.config.batch.max_batch_size,
            memory_manager=self.memory_manager)

    # ---- context ------------------------------------------------------------
    @contextlib.contextmanager
    def optimization_context(self, name: str = "block"):
        self.apply_global_settings()
        with self.analyzer.profiler.track(name):
            level = self.memory_manager.check_memory_pressure()
            if level == "critical":
                self.memory_manager.cleanup()
            yield self

    # ---- reporting ----------------------------------------------------------
    def get_recommendations(self) -> List[str]:
        return self.analyzer.recommendations()

    def generate_report(self, output_dir: str = "optimization_report"
                        ) -> Dict[str, str]:
        return self.analyzer.export_report(output_dir)

    def shutdown(self) -> None:
        self.memory_manager.stop_monitoring()
        self.analyzer.stop()


_GLOBAL: Optional[OptimizationManager] = None


def get_global_optimization_manager(
        config: Optional[OptimizationConfig] = None) -> OptimizationManager:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = OptimizationManager(config)
    return _GLOBAL
