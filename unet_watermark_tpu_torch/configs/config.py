"""The JAX package's typed config tree, all 109 of its leaf keys, with its
YAML loading and override rules.

Field names and defaults are copied from unet_watermark_tpu/configs/config.py;
the keys JAX stores and never reads are stored here the same way (their
comments say so), so every YAML and --opts JAX accepts, the port accepts.
That module imports PyYAML, which the GPU machine lacks, so the port reads
YAML with yaml_subset.load: the subset that the three shipped files use.
Merging follows the JAX package's _merge_into: keys the tree lacks are
skipped, and each value is coerced to its field's type. The shipped files
are copied beside this module (configs/*.yaml).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, is_dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import yaml_subset

# the port's copy of the shipped default, which the CLI reads
DEFAULT_CONFIG = Path(__file__).resolve().parent / "unet_watermark.yaml"


@dataclass
class ModelConfig:
    NAME: str = "UnetPlusPlus"
    ENCODER_NAME: str = "resnet34"
    ENCODER_WEIGHTS: Optional[str] = "imagenet"  # stored, not read
    ENCODER_DEPTH: int = 5  # stored, not read
    DECODER_CHANNELS: List[int] = field(
        default_factory=lambda: [256, 128, 64, 32, 16])
    IN_CHANNELS: int = 3  # anything else raises NotImplementedError
    CLASSES: int = 1  # the head's output channels
    ACTIVATION: Optional[str] = None  # None/"identity", "sigmoid", "softmax"
    # compute dtype of the network; logits are fp32, and training keeps
    # fp32 parameters (bf16 compute under torch.autocast)
    DTYPE: str = "bfloat16"
    PARAM_DTYPE: str = "float32"  # stored, not read: parameters are fp32
    REMAT: bool = False  # training: recompute the encoder's blocks and the
    # decoder in the backward pass (torch.utils.checkpoint)
    # JAX's fused up-conv computes the function of the plain upsample +
    # concat form the port runs; stored, not read
    FUSED_DECODER: bool = True
    # UNet++ decoder layout: "canonical" (the Zhou grid of the shipped
    # weights) or "smp" (the layout of reference .pth imports,
    # models/unet.SMPUnetPlusPlusDecoder; repair --model X.pth sets it)
    DECODER_IMPL: str = "canonical"


@dataclass
class DataConfig:
    ROOT_DIR: str = "data/train"
    ADDITIONAL_ROOT_DIRS: List[str] = field(default_factory=list)
    IMG_SIZE: int = 512
    GENERATE_MASK_THRESHOLD: int = 30
    TRAIN_RATIO: float = 0.8
    VAL_RATIO: float = 0.2
    SHUFFLE: bool = True
    SEED: int = 42
    NUM_WORKERS: int = 4
    CACHE_IMAGES: bool = False
    # disk memmap of decoded and resized uint8 samples (data/decoded_cache)
    CACHE_DECODED: bool = True
    CACHE_DIR: Optional[str] = None  # default: <ROOT_DIR>/.decoded_cache
    # the whole uint8 corpus resident on the card (data/pipeline
    # DeviceDataPipeline) when it fits DEVICE_CACHE_MB
    DEVICE_CACHE: bool = True
    DEVICE_CACHE_MB: int = 3072
    PREFETCH_FACTOR: int = 2
    AUGMENTATION_TYPE: str = "transparent_watermark"
    # the text configuration's extras (unet_text_watermark.yaml); stored
    TEXT_ENHANCEMENT: bool = False
    EDGE_ENHANCEMENT: bool = False
    CONTRAST_BOOST: float = 1.0


@dataclass
class TrainConfig:
    BATCH_SIZE: int = 16
    EPOCHS: int = 300
    LR: float = 1e-4
    WEIGHT_DECAY: float = 1e-4
    OUTPUT_DIR: str = "logs/output"
    MODEL_SAVE_PATH: str = "models/unet_watermark.pth"
    LOG_INTERVAL: int = 10
    SAVE_INTERVAL: int = 50
    USE_EARLY_STOPPING: bool = True
    EARLY_STOPPING_PATIENCE: int = 10
    CHECKPOINT_DIR: str = "models/checkpoints"
    SAVE_BEST_ONLY: bool = False
    USE_AMP: bool = False  # stored, not read: MODEL.DTYPE sets the compute
    GRADIENT_CLIP: float = 1.0
    # JAX's dispatch knobs (buffer donation, lax.scan over steps and
    # epochs); stored, not read
    DONATE_STATE: bool = True
    STEPS_PER_EXEC: int = 1
    EPOCH_SCAN: bool = True


@dataclass
class LossConfig:
    NAME: str = "DiceLoss"
    MODE: str = "binary"  # stored, not read
    SMOOTH: float = 1e-5
    BCE_WEIGHT: float = 0.5
    DICE_WEIGHT: float = 0.5
    DICE_SMOOTH: float = 1e-5  # stored, not read
    FOCAL_ALPHA: float = 0.25
    FOCAL_GAMMA: float = 2.0
    FOCAL_WEIGHT: float = 0.0
    EDGE_LOSS_WEIGHT: float = 0.0
    CONNECTIVITY_LOSS_WEIGHT: float = 0.0  # stored, not read


@dataclass
class OptimizerConfig:
    NAME: str = "Adam"
    LR_SCHEDULER: str = "ReduceLROnPlateau"
    SCHEDULER_PATIENCE: int = 5
    SCHEDULER_FACTOR: float = 0.5
    SCHEDULER_T_0: int = 50
    SCHEDULER_T_MULT: int = 2
    SCHEDULER_ETA_MIN: float = 1e-6


@dataclass
class PredictConfig:
    INPUT_PATH: str = "data/input"
    OUTPUT_DIR: str = "data/output"
    BATCH_SIZE: int = 8
    AUTO_BATCH_SIZE: bool = True  # stored, not read
    MAX_BATCH_SIZE: int = 32  # stored, not read
    THRESHOLD: float = 0.5  # mask = sigmoid(logit) > THRESHOLD (strict)
    POST_PROCESS: bool = True
    # the text configuration's flags (unet_text_watermark.yaml)
    TEXT_MODE: bool = False  # stored, not read
    MULTI_SCALE_TEST: bool = False
    TEST_SCALES: List[float] = field(default_factory=lambda: [0.8, 1.0, 1.2])
    EDGE_REFINEMENT: bool = False
    CONNECTIVITY_CHECK: bool = False
    # sliding-window inference at native resolution for high-res inputs
    TILED: bool = False
    TILE_SIZE: int = 512
    TILE_OVERLAP: int = 64
    # trained FFC-LaMa weights for the repair engines; None = auto-resolve
    # (env PREDICT_INPAINT_WEIGHTS, then the shipped weights/lama_ffc.npz)
    INPAINT_WEIGHTS: Optional[str] = None
    # the int8 PTQ tier (ops/quant.py): the convs run s8 x s8 -> s32 with
    # the <weights>.quant.json sidecar; without one, a warning and the
    # model dtype
    QUANT: bool = False
    # "parity" = the reference's cv2 chain, "tight" = the
    # precision-preserving chain, "auto" = tight for the repair mask
    # (inference/maskproc.resolve_mask_mode)
    MASK_MODE: str = "auto"


@dataclass
class ValConfig:  # stored, not read, as in JAX
    METRICS: List[str] = field(
        default_factory=lambda: ["dice", "iou", "accuracy"])
    TEXT_METRICS: bool = False
    CHAR_LEVEL_EVAL: bool = False
    EDGE_ACCURACY: bool = False


@dataclass
class TextWatermarkConfig:
    # the text configuration's keys (unet_text_watermark.yaml): the
    # predictor's CONNECTIVITY_CHECK reads CONNECTIVITY and
    # MIN_COMPONENT_AREA; the others are stored, not read, as in JAX
    MIN_TEXT_AREA: int = 50
    MAX_TEXT_AREA: int = 10000
    TEXT_ASPECT_RATIO_MIN: float = 0.2
    TEXT_ASPECT_RATIO_MAX: float = 10.0
    MORPH_KERNEL_SIZE: int = 3
    DILATE_ITERATIONS: int = 1
    ERODE_ITERATIONS: int = 1
    CONNECTIVITY: int = 8
    MIN_COMPONENT_AREA: int = 30
    CLAHE_CLIP_LIMIT: float = 2.5
    CLAHE_TILE_SIZE: int = 8
    CANNY_LOW_THRESHOLD: int = 40
    CANNY_HIGH_THRESHOLD: int = 120
    SHARPEN_STRENGTH: float = 1.2


@dataclass
class ParallelConfig:
    """The mesh of data-parallel training (parallel/mesh.mesh_from_config
    reads MESH_SHAPE and MESH_AXES): MESH_SHAPE None spans the process
    group's world (torchrun's ranks, one card each; JAX's spans the
    process's devices), a shape whose product is not the world size
    raises. DATA_AXIS, SPATIAL_AXIS and SPATIAL_HALO are stored, not read,
    as in JAX."""
    MESH_SHAPE: Optional[List[int]] = None
    MESH_AXES: List[str] = field(default_factory=lambda: ["data"])
    DATA_AXIS: str = "data"
    SPATIAL_AXIS: Optional[str] = None
    SPATIAL_HALO: int = 32


@dataclass
class Config:
    # JAX's platform name; stored, not read: every entry point takes its
    # device from the caller (utils/device.resolve_device, "cuda" default)
    DEVICE: str = "tpu"
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    DATA: DataConfig = field(default_factory=DataConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    LOSS: LossConfig = field(default_factory=LossConfig)
    OPTIMIZER: OptimizerConfig = field(default_factory=OptimizerConfig)
    PREDICT: PredictConfig = field(default_factory=PredictConfig)
    VAL: ValConfig = field(default_factory=ValConfig)
    TEXT_WATERMARK: TextWatermarkConfig = field(
        default_factory=TextWatermarkConfig)
    PARALLEL: ParallelConfig = field(default_factory=ParallelConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def merge_from_dict(self, d: Dict[str, Any]) -> "Config":
        _merge_into(self, d)
        return self

    def merge_from_file(self, path) -> "Config":
        with open(path) as f:
            d = yaml_subset.load(f.read()) or {}
        return self.merge_from_dict(d)

    def merge_from_list(self, opts: List[str]) -> "Config":
        """YACS-style pairwise override list: ["PREDICT.THRESHOLD", "0.4",
        ...]; an unknown key raises AttributeError."""
        if len(opts) % 2 != 0:
            raise ValueError(f"override list must have even length, got "
                             f"{opts}")
        for key, value in zip(opts[::2], opts[1::2]):
            self.set_by_path(key, value)
        return self

    def get_by_path(self, path: str) -> Any:
        node: Any = self
        for part in path.split("."):
            node = getattr(node, part)
        return node

    def set_by_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            node = getattr(node, part)
        leaf = parts[-1]
        if not hasattr(node, leaf):
            raise AttributeError(f"unknown config key: {path}")
        setattr(node, leaf, _coerce(value, getattr(node, leaf)))


def _coerce(value: Any, current: Any) -> Any:
    """A (possibly string) value converted to the type of the field's
    current value, as the JAX package's _coerce: a string is first read as
    a YAML scalar or flow list, and kept as it is where it is none."""
    if isinstance(value, str):
        try:
            value = yaml_subset.load_value(value)
        except ValueError:
            pass
    if current is None or value is None:
        return value
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, list) and not isinstance(value, list):
        raise TypeError(f"expected list for override, got {value!r}")
    return value


def _merge_into(node: Any, d: Dict[str, Any]) -> None:
    for key, value in d.items():
        if not hasattr(node, key):  # a key neither tree has, as JAX skips it
            continue
        current = getattr(node, key)
        if is_dataclass(current) and isinstance(value, dict):
            _merge_into(current, value)
        else:
            setattr(node, key, _coerce(value, current))


def get_cfg_defaults() -> Config:
    return Config()


def update_config(cfg: Config, config_file) -> Config:
    return cfg.merge_from_file(config_file)
