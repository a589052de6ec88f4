"""Optimization configuration (utils/optimization_config.py in the JAX
package): the dataclass tree (Memory/Batch/DataLoader/Model/Training/
Monitoring), the CONSERVATIVE/BALANCED/AGGRESSIVE presets, from_level,
validate, diff and the ConfigManager's preset store, equal to JAX's (the
same fields, defaults and values, so a file either package writes loads in
the other).

auto_detect counts CUDA cards where JAX counts TPU chips: four or more
cards give the aggressive preset, one to three the balanced, none the
conservative; the loader's workers are capped at the host's physical
cores. save/load take .json, or YAML for any other name: the YAML is
written by configs/yaml_subset.dump and read by configs/yaml_subset.load
(the card's machine has no PyYAML). The knobs keep JAX's names; what they
set on the card is optimization_manager's to say.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from ..configs import yaml_subset
from .memory import physical_cores

logger = logging.getLogger(__name__)


class OptimizationLevel(str, enum.Enum):
    CONSERVATIVE = "conservative"
    BALANCED = "balanced"
    AGGRESSIVE = "aggressive"


@dataclass
class MemoryConfig:
    warning_threshold: float = 80.0
    critical_threshold: float = 92.0
    monitor_interval: float = 5.0
    enable_monitoring: bool = True
    remat: bool = False              # MODEL.REMAT: recompute the encoder


@dataclass
class BatchConfig:
    initial_batch_size: int = 8
    max_batch_size: int = 64
    auto_tune: bool = True           # BatchSizeOptimizer at startup
    buckets_power_of_two: bool = True


@dataclass
class DataLoaderConfig:
    num_workers: int = 8
    prefetch_factor: int = 2
    cache_images: bool = False
    auto_tune: bool = True


@dataclass
class ModelOptConfig:
    compute_dtype: str = "bfloat16"
    donate_buffers: bool = True
    persistent_compile_cache: bool = True  # XLA's; none on the card
    compile_cache_dir: str = ""


@dataclass
class TrainingOptConfig:
    gradient_accumulation_steps: int = 1
    gradient_clip: float = 1.0
    steps_per_execution: int = 1     # TRAIN.STEPS_PER_EXEC (stored)


@dataclass
class MonitoringConfig:
    enable_profiling: bool = False
    profile_dir: str = "/tmp/jax_trace"  # JAX's default, kept for parity
    system_monitor: bool = True
    monitor_interval: float = 1.0


@dataclass
class OptimizationConfig:
    level: OptimizationLevel = OptimizationLevel.BALANCED
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    model: ModelOptConfig = field(default_factory=ModelOptConfig)
    training: TrainingOptConfig = field(default_factory=TrainingOptConfig)
    monitoring: MonitoringConfig = field(default_factory=MonitoringConfig)

    # ---- presets ----------------------------------------------------------
    @classmethod
    def conservative(cls) -> "OptimizationConfig":
        c = cls(level=OptimizationLevel.CONSERVATIVE)
        c.batch.initial_batch_size = 4
        c.batch.max_batch_size = 16
        c.batch.auto_tune = False
        c.memory.warning_threshold = 70.0
        c.memory.critical_threshold = 85.0
        c.memory.remat = True
        c.model.compute_dtype = "float32"
        return c

    @classmethod
    def balanced(cls) -> "OptimizationConfig":
        return cls(level=OptimizationLevel.BALANCED)

    @classmethod
    def aggressive(cls) -> "OptimizationConfig":
        c = cls(level=OptimizationLevel.AGGRESSIVE)
        c.batch.initial_batch_size = 32
        c.batch.max_batch_size = 256
        c.memory.warning_threshold = 88.0
        c.memory.critical_threshold = 96.0
        c.dataloader.num_workers = 16
        c.dataloader.prefetch_factor = 4
        c.dataloader.cache_images = True
        c.training.steps_per_execution = 8
        return c

    @classmethod
    def from_level(cls, level) -> "OptimizationConfig":
        level = OptimizationLevel(level)
        return {OptimizationLevel.CONSERVATIVE: cls.conservative,
                OptimizationLevel.BALANCED: cls.balanced,
                OptimizationLevel.AGGRESSIVE: cls.aggressive}[level]()

    # ---- hardware autodetect ----------------------------------------------
    @classmethod
    def auto_detect(cls) -> "OptimizationConfig":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n:
            cfg = cls.aggressive() if n >= 4 else cls.balanced()
        else:
            cfg = cls.conservative()
        cfg.dataloader.num_workers = min(cfg.dataloader.num_workers,
                                         max(physical_cores(), 1))
        logger.info("auto-detected: platform=%s devices=%d level=%s",
                    "cuda" if n else "cpu", max(n, 1), cfg.level.value)
        return cfg

    # ---- validation / io ---------------------------------------------------
    def validate(self) -> List[str]:
        problems = []
        if self.batch.initial_batch_size > self.batch.max_batch_size:
            problems.append("initial_batch_size > max_batch_size")
        if not 0 < self.memory.warning_threshold < \
                self.memory.critical_threshold <= 100:
            problems.append("memory thresholds must satisfy "
                            "0 < warning < critical <= 100")
        if self.model.compute_dtype not in ("bfloat16", "float32"):
            problems.append(f"unknown compute dtype "
                            f"{self.model.compute_dtype}")
        if self.training.gradient_accumulation_steps < 1:
            problems.append("gradient_accumulation_steps must be >= 1")
        return problems

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["level"] = self.level.value
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OptimizationConfig":
        cfg = cls.from_level(d.get("level", "balanced"))
        for section in ("memory", "batch", "dataloader", "model",
                        "training", "monitoring"):
            node = getattr(cfg, section)
            for k, v in (d.get(section) or {}).items():
                if hasattr(node, k):
                    setattr(node, k, v)
        return cfg

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            if path.endswith(".json"):
                json.dump(self.to_dict(), f, indent=2)
            else:
                f.write(yaml_subset.dump(self.to_dict()))

    @classmethod
    def load(cls, path: str) -> "OptimizationConfig":
        with open(path) as f:
            text = f.read()
        d = json.loads(text) if path.endswith(".json") else \
            yaml_subset.load(text)
        return cls.from_dict(d)


class ConfigManager:
    """A store of presets as .yaml files, and the diff of two configs."""

    def __init__(self, store_dir: str = "optimization_configs"):
        self.store_dir = store_dir
        os.makedirs(store_dir, exist_ok=True)

    def save_preset(self, name: str, cfg: OptimizationConfig) -> str:
        path = os.path.join(self.store_dir, f"{name}.yaml")
        cfg.save(path)
        return path

    def load_preset(self, name: str) -> OptimizationConfig:
        return OptimizationConfig.load(
            os.path.join(self.store_dir, f"{name}.yaml"))

    def list_presets(self) -> List[str]:
        return sorted(os.path.splitext(f)[0]
                      for f in os.listdir(self.store_dir)
                      if f.endswith(".yaml"))

    @staticmethod
    def diff(a: OptimizationConfig, b: OptimizationConfig
             ) -> Dict[str, tuple]:
        out = {}

        def walk(da, db, prefix=""):
            for k in da:
                if isinstance(da[k], dict):
                    walk(da[k], db[k], f"{prefix}{k}.")
                elif da[k] != db[k]:
                    out[f"{prefix}{k}"] = (da[k], db[k])

        walk(a.to_dict(), b.to_dict())
        return out
