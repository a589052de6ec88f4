"""The port and chip_smoke.py import with jax, flax, optax, orbax,
tensorstore, zstandard, yaml,
PIL, cv2, matplotlib, tqdm, torchvision, requests, easyocr, diffusers,
nunchaku, psutil and the JAX package blocked (the GPU machine has none of
them),
every module of the port among them (ocr/, ops/imgproc.py, the training
path, the `auto` loop's modules, the .pth, big-lama and contour modules,
the zoo's archs, model sizes and text trainer, parallel/, and the WEBP
and TIFF readers and the formats phase too, and the library surface:
utils/, method_compare, diagnose and the library phase), and
chip_smoke.py gives no result without a card."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ["jax", "flax", "optax", "orbax", "tensorstore", "zstandard",
           "yaml", "PIL", "cv2", "matplotlib", "tqdm", "torchvision",
           "requests", "easyocr", "diffusers", "nunchaku", "psutil",
           "unet_watermark_tpu"]
# modules that must be among those imported
MUST = ["unet_watermark_tpu_torch.ops.imgproc",
        "unet_watermark_tpu_torch.ocr.base",
        "unet_watermark_tpu_torch.ocr.builtin",
        "unet_watermark_tpu_torch.ocr.easy_ocr",
        "unet_watermark_tpu_torch.ocr.paddle_ocr",
        "unet_watermark_tpu_torch.utils.jpeg",
        "unet_watermark_tpu_torch.ops.jpeg",
        "unet_watermark_tpu_torch.ops.kernels.jpeg_entropy",
        "unet_watermark_tpu_torch.ops.quant",
        "unet_watermark_tpu_torch.ops.kernels.conv_s8",
        "unet_watermark_tpu_torch.ops.losses",
        "unet_watermark_tpu_torch.ops.metrics",
        "unet_watermark_tpu_torch.ops.augment",
        "unet_watermark_tpu_torch.data.dataset",
        "unet_watermark_tpu_torch.data.decoded_cache",
        "unet_watermark_tpu_torch.data.pipeline",
        "unet_watermark_tpu_torch.training.state",
        "unet_watermark_tpu_torch.training.checkpoint",
        "unet_watermark_tpu_torch.training.ocdbt",
        "unet_watermark_tpu_torch.ops.kernels.zstd",
        "unet_watermark_tpu_torch.utils.bmp",
        "unet_watermark_tpu_torch.training.train",
        "unet_watermark_tpu_torch.utils.async_ckpt",
        "unet_watermark_tpu_torch.training.train_inpaint",
        "unet_watermark_tpu_torch.training.train_latent_diffusion",
        "unet_watermark_tpu_torch.diffusion",
        "unet_watermark_tpu_torch.diffusion.latent_diffusion",
        "unet_watermark_tpu_torch.ops.pil",
        "unet_watermark_tpu_torch.ops.draw",
        "unet_watermark_tpu_torch.utils.mp4v",
        "unet_watermark_tpu_torch.data.gen_data",
        "unet_watermark_tpu_torch.scripts",
        "unet_watermark_tpu_torch.scripts.model_selector",
        "unet_watermark_tpu_torch.scripts.quality_report",
        "unet_watermark_tpu_torch.scripts.video_generator",
        "unet_watermark_tpu_torch.training.auto_train",
        "unet_watermark_tpu_torch.diffusion.sd3_inpaint",
        "unet_watermark_tpu_torch.diffusion.flux_process",
        "unet_watermark_tpu_torch.data.synth_clean",
        "unet_watermark_tpu_torch.scripts.inpaint_quality",
        "unet_watermark_tpu_torch.scripts.calibrate_quant",
        "unet_watermark_tpu_torch.tools.smoke_phases",
        "unet_watermark_tpu_torch.models.torch_import",
        "unet_watermark_tpu_torch.models.lama_import",
        "unet_watermark_tpu_torch.ops.contours",
        "unet_watermark_tpu_torch.models.archs",
        "unet_watermark_tpu_torch.models.model_size",
        "unet_watermark_tpu_torch.text",
        "unet_watermark_tpu_torch.text.train_text_watermark",
        "unet_watermark_tpu_torch.parallel",
        "unet_watermark_tpu_torch.parallel.distributed",
        "unet_watermark_tpu_torch.parallel.mesh",
        "unet_watermark_tpu_torch.parallel.spatial",
        "unet_watermark_tpu_torch.utils.decode_error",
        "unet_watermark_tpu_torch.utils.webp",
        "unet_watermark_tpu_torch.utils.tiff",
        "unet_watermark_tpu_torch.ops.webp",
        "unet_watermark_tpu_torch.ops.kernels.webp",
        "unet_watermark_tpu_torch.ops.kernels.tiff",
        "unet_watermark_tpu_torch.tools.smoke_formats",
        "unet_watermark_tpu_torch.utils.batching",
        "unet_watermark_tpu_torch.utils.memory",
        "unet_watermark_tpu_torch.utils.model_manager",
        "unet_watermark_tpu_torch.utils.native",
        "unet_watermark_tpu_torch.utils.optimization_config",
        "unet_watermark_tpu_torch.utils.optimization_manager",
        "unet_watermark_tpu_torch.utils.optimized_dataloader",
        "unet_watermark_tpu_torch.utils.optimized_predictor",
        "unet_watermark_tpu_torch.utils.performance_analyzer",
        "unet_watermark_tpu_torch.utils.profiler",
        "unet_watermark_tpu_torch.utils.training_optimizer",
        "unet_watermark_tpu_torch.scripts.method_compare",
        "unet_watermark_tpu_torch.text.diagnose",
        "unet_watermark_tpu_torch.tools.smoke_library"]
OK_LINE = '{"ok": true'

IMPORT_ALL = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None
import unet_watermark_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
leaked = sorted(n for n in {blocked!r} if sys.modules.get(n) is not None)
assert not leaked, leaked
missing = sorted(set({must!r}) - set(names))
assert not missing, missing
print(len(names))
"""


def _run(code_or_args, cwd, timeout=120):
    path = os.pathsep.join(filter(None, [str(cwd),
                                         os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, PYTHONPATH=path, CUDA_VISIBLE_DEVICES="")
    args = code_or_args if isinstance(code_or_args, list) else \
        [sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_nothing_of_jax():
    proc = _run(IMPORT_ALL.format(blocked=BLOCKED, must=MUST), REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 66  # every module was imported


def test_chip_smoke_fails_without_a_card():
    proc = _run([sys.executable, "chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert OK_LINE not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run([sys.executable, "chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert OK_LINE not in proc.stdout
