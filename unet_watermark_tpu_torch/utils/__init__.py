"""The library surface of utils/ (unet_watermark_tpu/utils/__init__.py):
the same 30 names, on the card. The package's other modules (image_io,
jpeg, shipping, native, ...) are imported by their module names.
utils/jaxtools.py (XLA's persistent compile cache) has no counterpart:
the card has no compile cache to set up."""
from .batching import (
    AdaptiveBatchProcessor,
    BatchSizeOptimizer,
    make_buckets,
    pad_to_bucket,
)
from .memory import (
    MemorySnapshot,
    TPUMemoryManager,
    get_global_memory_manager,
    memory_context,
)
from .model_manager import compare_models, list_checkpoints
from .optimization_config import (
    ConfigManager,
    OptimizationConfig,
    OptimizationLevel,
)
from .optimization_manager import (
    OptimizationManager,
    get_global_optimization_manager,
)
from .optimized_dataloader import (
    OptimizedDataset,
    auto_tune_loader_params,
    benchmark_pipeline,
)
from .optimized_predictor import OptimizedPredictor
from .performance_analyzer import (
    PerformanceAnalyzer,
    PerformanceProfiler,
    SystemMonitor,
)
from .profiler import PerformanceMonitor, annotate, timer, xla_trace
from .training_optimizer import (
    TrainingConfig,
    TrainingOptimizer,
    build_optimizer,
    build_schedule,
)

__all__ = [
    "AdaptiveBatchProcessor", "BatchSizeOptimizer", "make_buckets",
    "pad_to_bucket", "MemorySnapshot", "TPUMemoryManager",
    "get_global_memory_manager", "memory_context", "compare_models",
    "list_checkpoints", "ConfigManager", "OptimizationConfig",
    "OptimizationLevel", "OptimizationManager",
    "get_global_optimization_manager", "OptimizedDataset",
    "auto_tune_loader_params", "benchmark_pipeline", "OptimizedPredictor",
    "PerformanceAnalyzer", "PerformanceProfiler", "SystemMonitor",
    "PerformanceMonitor", "annotate", "timer", "xla_trace",
    "TrainingConfig", "TrainingOptimizer", "build_optimizer",
    "build_schedule",
]
