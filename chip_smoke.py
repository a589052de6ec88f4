#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (unet_watermark_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own line:
  0  versions, and the card's name and power limit (nvidia-smi)
  1  build the native sources (nvcc → .so for each .cu, cc for the host
     C: the JPEG entropy coder, the zstd, RLE, WEBP and TIFF decoders,
     the host connected components of utils/native.py;
     all compiler calls started together, before the
     port's imports, phase 0 and the profiler's first session, which run
     meanwhile, as do 4 host workers writing 3d's, 3f's and 3o's input
     files and running 3f's plain entropy decodes; ctypes) and report the
     build time
  2  hold each kernel bit-exactly against its plain PyTorch version on the
     card: random masks (p = 0.2, 0.35, 0.5), masks touching all four
     borders, and blob masks, at the main path's shape (BATCH x SIZE²) and
     at 33² (a partial last word, an image smaller than K1's 48-row halo)
     and 100²; K2 also on uniform noise, and on floats with NaN, ±inf, 0.5
     and its neighbours at SIZE² and 101², where it must equal x > 0.5
  3  the main path: WatermarkPredictor(cfg).make_fused_repair_fn("pushpull")
     with MASK_MODE parity on synthetic watermarked images, Unet/resnet34
     at full width with the shipped weights, bf16. Checks shapes, finite
     [0, 1] output, pixels outside the mask unchanged, the mask equal to the
     plain chain on the same raw mask, and that both kernels were launched
     by that run; then a float32 reference on a small input against the
     port on the CPU
  3b the default configuration, get_cfg_defaults() as it is: UNet++/resnet34
     at full width with the shipped weights, bf16, MASK_MODE auto, on 8
     synthetic images of which the last 2 carry no logo. (a) The repair
     surface, make_fused_repair_fn("pushpull"), whose mask is the tight
     chain run once for the batch: phase 3's checks, the mask equal to the
     plain tight chain image by image, bf16 against float32 raw masks, and
     float32 UNet++ logits on the card against the CPU's at 64². (b) The
     artifact surface in step 1's order, predict_artifact_masks: raw
     masks, each image's type, one strategy per image with the watermark
     strategy of parity mode; both kernels must be launched by that run
     and its masks equal plain optimize_mask image by image; then the same
     partition with codes 0, 1 and 2 fixed, so every strategy runs
  3c the learned fill: the default configuration's make_fused_repair_fn()
     with no argument, whose fill is the FFC-LaMa generator in bf16 with
     the shipped weights/lama_ffc.npz (PREDICT_INPAINT_WEIGHTS cleared), on
     3b's batch. Checks: engine "ffc-lama" (a push-pull fallback fails), the
     mask equal to the plain tight chain image by image, phase 3's output
     checks, the bf16 generator against a float32 one on the card (mean
     over hole pixels ≤ 2e-2), and the float32 generator on the card
     against the CPU's at 2 x 128² (max ≤ 1e-3); prints, without a gate,
     the hole pixels' error against the clean images for LaMa and push-pull
  3d the repair entry point: `cli.main(["repair", "--input", D, "--output",
     O, "--no-ocr"])` in this process, every other flag at its default
     (the default configuration, bf16, the LaMa engine 3 times), on a
     folder the port's encoder writes: 12 images of 512² (the last 2 with
     no logo), 2 of 720 x 1280, 2 of 1080 x 1920 and one 1080 x 1920 file
     with Paeth rows (its decode time printed). Checks: rc 0, status
     "success" and no engine failure in repair_summary.json, K1 and K2
     launched by the run, the 512² images' step-1 masks equal to
     predict_artifact_masks on the same decoded batches, every mask at its
     image's size, repaired pixels outside the step-1 mask equal to the
     input's bytes, merged masks for every detected image. The CLI runs
     once, each stage timed; then the tiled path (TILED, tiles of 512
     with overlap 64) on a 1536 x 2048 image: bf16 against float32 raw
     masks agree on >= 99.9 % of pixels, probabilities within 1e-2 on
     average, the mask at 1536 x 2048
  3e the `repair` command as users type it, OCR on:
     `cli.main(["repair", "--input", D, "--output", O])`, every flag at its
     default (--ocr-engine easy, which is the builtin detector without
     easyocr; --text-model mat, the LaMa generator), on 3d's folder plus 4
     images with lines of block letters (utils/synthetic.text_images): 2 of
     512² (one over a logo), 1 of 720 x 1280, 1 of 1080 x 1920. Checks: the
     detector on the card covers >= 90 % of each drawn line's box on the
     text images as written; then the command: rc 0, "success",
     ocr_engine_used "builtin", no OCR or engine failure, K1 and K2
     launched by its step 1, a text mask with text for every text image,
     every text mask with text and the CPU_DETECT_EMPTY smallest without
     equal to the detector run with device="cpu" on the same step-2 file
     (filled and dilated as step 3 does), and there final pixels
     outside the text mask equal to step 2's bytes, every merged mask equal
     to the plain tight chain of max(step-1 mask, text mask), and
     >= GLYPH_COVER of each line's drawn glyph pixels under max(step-1
     mask, text mask), that is repainted by step 2 or step 4 (step 3 sees
     step 2's files, in which the LaMa fill has already removed the part
     of a line that step 1 masked; each line's cover by each mask is
     logged). The command runs once, each stage timed;
     _enhance_text_features on the 720 x 1280 image on the card equal to
     the CPU's, on the 1080 x 1920 one timed (whole, and split into its
     parts by events in one run whose parts add up to that run's total),
     and
     predict_mask(..., "text") in
     float32 on the card agreeing with the CPU's on >= 99.9 % of pixels
  3f the `repair` command as users type it (OCR on) on a folder of 17 JPEGs
     that utils/synthetic.encode_jpeg writes: 8 of 512² (baseline 4:2:0
     q95, the last 2 with no logo), 720 x 1280 at 4:4:4 q90 with a restart
     interval of 4 MCUs, 720 x 1280 at 4:2:2 q85, 1080 x 1920 progressive,
     1080 x 1920 stored turned with EXIF orientation 6, a gray 512², a
     phone's 3024 x 4032 photo (4032 x 3024 upright, orientation 6), a
     1080 x 1920 file cut 30 % into its entropy data, a progressive 720 x
     1280 one cut so (its blocks smoothed as libjpeg smooths them), and
     one cut before its first scan (skipped, as cv2 gives None). Checks:
     every file decoded on the card's route (the C entropy decoder, the
     pixel stage on the card) equal byte for byte, colour and gray, to the
     plain route
     (the Python entropy decoder, the pixel stage on the CPU); rc 0,
     "success", engine "ffc-lama", no engine or OCR failure, K1 and K2
     launched by its step 1, masks and finals at each image's upright
     size, step 2's pixels outside the step-1 mask equal to the decoded
     input. The command runs once, each stage timed (the decode stage's
     entropy and pixel parts apart); --no-unet on 4 of the files
     (steps 3-4 read the JPEGs copied under .png names), and the decode of
     a 1080 x 1920 baseline, a progressive and the phone file timed by
     part
  3g the int8 tier (PREDICT.QUANT): for Unet and UNet++ at full width
     with the shipped weights and sidecars, one forward at BATCH x SIZE²
     in which every uwt_conv_s8 launch (50 and 68) is held bit for bit
     against its plain version on the card, and every activation quantize
     against float32 x * f32(1/sx), and the masks against the
     bf16 tier's (>= 97 % agreement); the default fused fn with LaMa under
     PREDICT.QUANT (engine "ffc-lama", 68 launches, phase 3's output
     checks, the mask equal to the plain tight chain), timed in turns with
     the bf16 fn, and each network in turns with its bf16 tier; the UNet++
     forward's 68 convs replayed back to back against their bound, their
     plain versions and cuDNN's bf16 conv, and 6 of its shapes one by one
     beside im2col + torch._int_mm; a profile of the UNet++ network in
     each tier; `repair --quant --no-ocr` on 4 of 3d's files (rc 0,
     "success", engine "ffc-lama", 68 launches)
  3h-3n the `train` command, the fill trainers, the `auto` command, the
     quality record (scripts/quality_report.py, calibrate_quant and the
     SD3/FLUX shells), the reference's checkpoint formats with the
     blurred training masks (.pth in and out, the smp-layout UNet++,
     big-lama as the fill, `train --use-blurred-mask`), the model zoo
     (the text trainer and `repair -c` with the text config, the large
     config at 2 x 1024², the eight other archs, UnetTPU's int8 tier),
     the data-parallel path in an NCCL world of one (the group's
     train steps, `train` in the group, predict_tiled_sharded, the
     halo-exchange conv): unet_watermark_tpu_torch/tools/smoke_phases.py,
     whose docstring lists their checks; and every still image the JAX
     package reads with its checkpoints' zstd frames (3o: known answers
     for zstd, WEBP and PNGs read as gray, `repair` over BMP, Adam7 PNG,
     Adobe CMYK JPEG, WEBP and TIFF copies of a PNG folder, 1080p decode
     times): unet_watermark_tpu_torch/tools/smoke_formats.py
  3p the library surface (unet_watermark_tpu_torch.utils and the
     per-type helpers) on 3b's predictor and images: the per-type mask
     helpers equal to the plain chains with K1 and K2 launched, the
     padded OptimizedPredictor over the artifact surface and its batch
     tuning's peaks, the memory manager against mem_get_info and the
     system monitor, utils.native against ops/components, the
     method comparison report, the text diagnosis, and TrainingOptimizer's
     accumulated steps: unet_watermark_tpu_torch/tools/smoke_library.py
  4  timings with CUDA events: the main path (img/s) and its stages, each
     kernel per call (median of 5 rounds of 50 back-to-back calls) beside
     its plain version, its bound and (K2) the one PyTorch expression that
     computes its function, timed in turns with it; each kernel's own
     device time from torch.profiler, and the host time of one wrapper
     call; the default configuration's repair path (img/s) and its stages,
     the tight chain also as the per-image loop it replaced, type
     detection and the artifact stage; the default fn with LaMa (img/s),
     the generator alone and its share of the bf16 tensor-core peak; the
     repair CLI's img/s and its split by stage beside the fused fn's, with
     OCR off (3d) and on (3e), and on the JPEG folder (3f); a profile of
     each path and of the generator alone

The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Any failed check raises, and the script
exits non-zero without that last line; so does a machine without a card.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
PORT = "unet_watermark_tpu_torch"
try:  # phases 3h-3o and the helpers they share with this file
    from unet_watermark_tpu_torch.tools.smoke_phases import (
        BATCH, LAMA_SEGMENTS, PEAK_BF16_FLOPS_PER_S, PEAK_BYTES_PER_S,
        PEAK_INT8_OPS_PER_S, SIZE, auto_phase,
        check_repair, checkpoint_phase, conv_flops, conv_s8_bound,
        conv_s8_library, cuda_ms, fill_training_phase,
        host_ms, host_pool, int8_hooks, log, nvidia_smi_line, profile_window, profiled_ms,
        quality_phase, run_cli, segment_ms, sharded_phase, training_phase,
        zoo_phase, zoo_text_train)
    from unet_watermark_tpu_torch.tools.smoke_formats import (formats_phase,
                                                              write_inputs)
    from unet_watermark_tpu_torch.tools.smoke_library import library_phase
except ImportError:  # outside a checkout: main() says so and gives no result
    pass

# H100 SXM peaks (NVIDIA data sheet; HBM bytes/s and the int8 tensor-core
# peak in tools/smoke_phases.py), and single operations outside the tensor
# cores: the 67 TFLOP/s fp32 peak counts each FMA as two operations, while
# each of the kernels' taps (an OR or AND), products and sums is one
PEAK_SINGLE_OPS_PER_S = 67e12 / 2
# K1: the chain's 664 max-taps a pixel (centre excluded), done 32 pixels to
# a word operation
K1_WORD_OPS = 664 / 32
K2_FLOPS = 10  # separable 3-tap blur: 2 x (3 mul + 2 add) per pixel
# each kernel's __global__ function, as torch.profiler names it
DEVICE_NAMES = {"morph_chain_watermark": "morph_chain_kernel",
                "gaussian_smooth_threshold": "smooth_threshold_kernel"}




def iou(raw, logos) -> float:
    """IoU of the raw masks with the drawn logos, over the batch."""
    a, b = raw > 0.5, logos > 0.5
    return ((a & b).sum() / (a | b).sum().clamp(min=1)).item()


def special_floats(n: int, s: int, seed: int):
    """(n, s, s) float32 noise on [-0.25, 1.25) with NaN, ±inf, 0.5 and its
    two float neighbours spread through it."""
    import numpy as np

    x = (np.random.default_rng(seed).random((n, s, s)) * 1.5
         - 0.25).astype(np.float32)
    half = np.float32(0.5)
    special = np.array([np.nan, np.inf, -np.inf, half,
                        np.nextafter(half, np.float32(1)),
                        np.nextafter(half, np.float32(0))], np.float32)
    x.reshape(-1)[::5] = np.resize(special, x.size)[::5]
    return x


def check_masks(n: int, s: int, seed: int):
    """name → (n, s, s) float32 masks, made with numpy from the seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sets = {f"p{p}": (rng.random((n, s, s)) < p) for p in (0.2, 0.35, 0.5)}
    border = np.zeros((n, s, s), bool)
    for i in range(n):
        w = 4 + 3 * i
        border[i, :w, :s // 3] = border[i, -w:, s // 2:] = True
        border[i, s // 4:s // 2, :w] = border[i, s // 2:, -w:] = True
        border[i] |= rng.random((s, s)) < 0.02 * i
    sets["border"] = border
    yy, xx = np.mgrid[0:s, 0:s]
    blobs = rng.random((n, s, s)) < 0.03
    for i in range(n):
        for _ in range(12):
            cy, cx = rng.integers(0, s, 2)
            r = rng.integers(3, s // 6)
            blobs[i] |= np.hypot(yy - cy, xx - cx) < r
    sets["blobs"] = blobs
    return {k: v.astype(np.float32) for k, v in sets.items()}


# phase 3d's folder: (name prefix, count, height, width); the first 12 are
# 512², the last 2 of them without a logo; the Paeth file is one more
# 1080 x 1920 image
CLI_FOLDER = (("a", 12, 512, 512), ("b", 2, 720, 1280), ("c", 2, 1080, 1920))
PAETH_SHAPE = (1080, 1920)
TILED_SHAPE, TILE, OVERLAP = (1536, 2048), 512, 64  # 20 tiles
STAGES = ("predictor_init", "decode", "upload_resize", "step1_device",
          "engine_load", "step2_device", "step3_detect", "step4_device",
          "step5", "encode")
# phase 3e's text images, (height, width), and which carry a logo
TEXT_SHAPES = ((512, 512), (512, 512), (720, 1280), (1080, 1920))
TEXT_LOGO = (True, False, False, False)
# the least share of each drawn line's glyph pixels that the OCR-on
# command's step-1 and text masks together must cover
GLYPH_COVER = 0.9
# text masks without text that 3e also holds against the CPU's detector
CPU_DETECT_EMPTY = 2


def cropped_images(n: int, h: int, w: int, seed: int, clean: int = 0):
    """n synthetic (h, w, 3) uint8 images: the middle rows of square ones."""
    import numpy as np
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    side = max(h, w)
    imgs, _ = watermarked_images(n, side, seed=seed, clean=clean)
    y0, x0 = (side - h) // 2, (side - w) // 2
    return (imgs[:, y0:y0 + h, x0:x0 + w] * 255).astype(np.uint8)


def write_cli_folder(folder: Path, seed: int, spec=CLI_FOLDER,
                     paeth_shape=PAETH_SHAPE) -> dict:
    """Phase 3d's input folder, written by the port's encoder; returns
    {stem: (h, w)}. Every file has Sub rows (filter 1), as cv2.imwrite
    writes them by default, but p0.png, which has Paeth rows (filter 4)
    only, as an adaptive writer's files mostly do."""
    from unet_watermark_tpu_torch.utils import image_io

    folder.mkdir(parents=True)
    sizes = {}
    for k, (prefix, count, h, w) in enumerate(spec):
        imgs = cropped_images(count, h, w, seed + k,
                              clean=2 if prefix == "a" else 0)
        for i, img in enumerate(imgs):
            sizes[f"{prefix}{i:02d}"] = (h, w)
            image_io.write_png(folder / f"{prefix}{i:02d}.png", img,
                               filters=(1,))
    img = cropped_images(1, *paeth_shape, seed + len(spec))[0]
    image_io.write_png(folder / "p0.png", img, filters=(4,))
    sizes["p0"] = paeth_shape
    return sizes




def check_cli_outputs(folder: Path, out: Path, sizes: dict, pred, dev
                      ) -> dict:
    """Phase 3d's file checks; returns counts for its log line. `pred` is a
    predictor of the same configuration, for predict_artifact_masks."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.ops.resize import resize_linear_u8
    from unet_watermark_tpu_torch.utils import image_io

    summary = json.loads((out / "repair_summary.json").read_text())
    if summary.get("status") != "success" or summary["engine_failures"] \
            or summary["engine_used"] != "ffc-lama":
        raise AssertionError(f"repair summary (step 2 must run the FFC-LaMa "
                             f"fill without failures): {summary}")
    names = sorted(sizes)
    masks = {n: image_io.read_gray(out / "step1_masks" / f"{n}_mask.png")
             for n in names}
    for n in names:
        if masks[n].shape != sizes[n]:
            raise AssertionError(f"{n}'s mask is {masks[n].shape}, its image "
                                 f"{sizes[n]}")
    # step 1's batches, in its order: the same decoded images through
    # predict_artifact_masks give the same masks
    s, bs = pred.img_size, pred.cfg.PREDICT.BATCH_SIZE
    compared = 0
    for i in range(0, len(names), bs):
        chunk = names[i:i + bs]
        batch = torch.stack([resize_linear_u8(torch.from_numpy(
            image_io.read_rgb(folder / f"{n}.png")).to(dev), (s, s))
            for n in chunk]).float() / 255.0
        opt, _ = pred.predict_artifact_masks(batch)
        ref = (opt * 255).to(torch.uint8).cpu().numpy()
        for j, n in enumerate(chunk):
            if sizes[n] == (s, s):
                if not np.array_equal(ref[j], masks[n]):
                    raise AssertionError(f"{n}: the CLI's step-1 mask "
                                         f"differs from "
                                         f"predict_artifact_masks")
                compared += 1
    detected = [n for n in names if masks[n].any()]
    for n in detected:
        src = image_io.read_rgb(folder / f"{n}.png")
        rep = image_io.read_rgb(out / "step2_watermark_repaired" / f"{n}.png")
        keep = masks[n] <= 127
        if not np.array_equal(rep[keep], src[keep]):
            raise AssertionError(f"{n}: repaired pixels outside the step-1 "
                                 f"mask changed")
        for path in (out / "masks" / f"{n}.png", out / f"{n}.png"):
            if not path.is_file():
                raise AssertionError(f"missing {path.name} for {n}")
    return {"images": len(names), "detected": len(detected),
            "masks_equal_predict_artifact_masks": compared,
            "summary": {k: summary[k] for k in (
                "total_images", "successful_images", "avg_watermark_ratio",
                "steps_completed", "engine_failures", "engine_used")}}


def repair_cli_phase(work: Path, pred, seed: int, dev, spec=CLI_FOLDER,
                     paeth_shape=PAETH_SHAPE, tiled_shape=TILED_SHAPE,
                     tile=TILE, overlap=OVERLAP, device="cuda",
                     written=None):
    """Phase 3d: the `repair` CLI on a folder of PNGs, then the tiled path;
    logs the checks of each and returns the CLI's timing fields and kernel
    launches for phase 4's line. `written` is write_folders' (sizes,
    seconds) where the folder is already written."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.configs import get_cfg_defaults
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.inference.tiled import plan_tiles
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.utils import image_io

    folder = work / "in"
    if written is None:
        t0 = time.perf_counter()
        sizes = write_cli_folder(folder, seed, spec, paeth_shape)
        write_s = time.perf_counter() - t0
    else:  # written by host workers while the kernels built
        sizes, write_s = written
    decode_ms = {}  # 1080 x 1920: Paeth rows, and Sub rows as cv2 writes
    for key, name in (("paeth", "p0"), ("sub", f"{spec[-1][0]}00")):
        data = (folder / f"{name}.png").read_bytes()
        decode_ms[key] = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = image_io.decode_png(data)
            decode_ms[key].append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    image_io.encode_png(img)
    encode_ms = (time.perf_counter() - t0) * 1e3
    # one decode of every file of the folder: as written (Sub rows; p0
    # Paeth), and with every file's rows Paeth, as an adaptive writer's
    # files mostly are
    folder_decode_s = {"as_written": 0.0, "all_paeth": 0.0}
    for path in sorted(folder.iterdir()):
        data = path.read_bytes()
        t0 = time.perf_counter()
        img = image_io.decode_png(data)
        folder_decode_s["as_written"] += time.perf_counter() - t0
        data = image_io.encode_png(img, filters=(4,))
        t0 = time.perf_counter()
        image_io.decode_png(data)
        folder_decode_s["all_paeth"] += time.perf_counter() - t0
    argv = ["repair", "--input", str(folder), "--no-ocr"]
    if device != "cuda":  # the flag's default
        argv += ["--device", device]

    # the CLI as a user runs it, every other flag at its default, once,
    # with each stage timed (a sync at the end of each stage)
    kc.reset_launch_counts()
    rc, wall_timed, split = run_cli(argv + ["--output", str(work / "out")],
                                    dev, timer=True)
    launches = {k.__name__: k.launches for k in kc.KERNELS}
    if rc != 0:
        raise AssertionError(f"repair exited {rc}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the CLI's step 1 never launched {name}")
    checks = check_cli_outputs(folder, work / "out", sizes, pred, dev)
    log("repair_cli", argv=argv[:1] + argv[3:], rc=rc, launches=launches,
        step1_batches=-(-len(sizes) // pred.cfg.PREDICT.BATCH_SIZE),
        write_folder_s=round(write_s, 3),
        paeth_1080x1920_decode_ms=decode_ms["paeth"],
        sub_1080x1920_decode_ms=decode_ms["sub"],
        up_1080x1920_encode_ms=encode_ms, folder_decode_s=folder_decode_s,
        **checks,
        repaired_keep_unmasked_bytes=True, merged_masks_for_detected=True)
    n = len(sizes)
    timing = {"images": n, "wall_timed_s": wall_timed,
              "img_per_s_timed": n / wall_timed,
              "split_s": {k: split.get(k, 0.0) for k in STAGES},
              "other_s": wall_timed - sum(split.values()),
              "paeth_1080x1920_decode_ms": float(np.median(
                  decode_ms["paeth"])),
              "sub_1080x1920_decode_ms": float(np.median(decode_ms["sub"])),
              "folder_decode_s": folder_decode_s,
              "launches": launches}

    # the tiled path on one high-res image, bf16 against float32
    cfgs = []
    for dtype in ("bfloat16", "float32"):
        cfg = get_cfg_defaults()
        cfg.MODEL.DTYPE = dtype
        cfg.PREDICT.TILED = True
        cfg.PREDICT.TILE_SIZE, cfg.PREDICT.TILE_OVERLAP = tile, overlap
        cfgs.append(cfg)
    tiled = [WatermarkPredictor(cfg, device=device) for cfg in cfgs]
    rgb = cropped_images(1, *tiled_shape, seed + 7)[0]
    tdir = work / "tiled"
    tdir.mkdir()
    image_io.write_png(tdir / "t0.png", rgb)
    rgb_d = torch.from_numpy(rgb).to(dev)
    p16, p32 = (p._infer_prob_map(rgb_d) for p in tiled)
    agree = ((p16 > 0.5) == (p32 > 0.5)).float().mean().item()
    mad = (p16 - p32).abs().mean().item()
    recs = tiled[0].step1_batch_predict_watermark_masks(str(tdir),
                                                        str(work / "tm"))
    mask = image_io.read_gray(work / "tm" / "t0_mask.png")
    n_tiles = len(plan_tiles(*tiled_shape, tile, overlap))
    log("repair_tiled", shape=list(tiled_shape), tile=tile, overlap=overlap,
        tiles=n_tiles, bf16_vs_fp32_raw_mask_agreement=agree,
        bf16_vs_fp32_prob_mean_abs=mad, mask_shape=list(mask.shape),
        mask_fraction=float((mask > 0).mean()),
        found=[r["mask_type"] for r in recs])
    if agree < 0.999 or mad > 1e-2:
        raise AssertionError(f"tiled bf16 vs float32: masks agree on "
                             f"{agree:.5f}, probabilities differ by {mad} on "
                             f"average")
    if tuple(mask.shape) != tuple(tiled_shape):
        raise AssertionError(f"tiled mask decodes at {mask.shape}")
    return timing


def check_ocr_outputs(out: Path, sizes: dict, text_boxes: dict,
                      text_inks: dict, dev) -> dict:
    """Phase 3e's file checks; returns counts for its log line."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.inference import maskproc
    from unet_watermark_tpu_torch.inference.tiled import pad_to_multiple
    from unet_watermark_tpu_torch.utils import image_io

    summary = json.loads((out / "repair_summary.json").read_text())
    want = {"status": "success", "ocr_engine_used": "builtin",
            "ocr_failures": 0, "engine_failures": 0,
            "engine_used": "ffc-lama"}
    if any(summary.get(k) != v for k, v in want.items()):
        raise AssertionError(f"repair summary (OCR on) is not {want}: "
                             f"{summary}")
    tdir = out / "step3_text_masks"
    text = {}
    for n in sorted(sizes):
        path = tdir / f"{n}_text_mask.png"
        text[n] = image_io.read_gray(path) if path.is_file() else None
    # step 3 sees step 2's files: where step 1's mask took part of a line,
    # the LaMa fill has removed that part, and the detector finds what is
    # left of it. Each line's cover (of its box, and of its drawn glyph
    # pixels) by the text mask, the step-1 mask and the two together is
    # logged; no step repainted a glyph pixel under neither
    coverage, glyphs = {}, {}
    for n, lines in text_boxes.items():
        if text[n] is None or not text[n].any():
            raise AssertionError(f"no text mask for the text image {n}")
        wm = image_io.read_gray(out / "step1_masks" / f"{n}_mask.png")
        both = np.maximum(wm, text[n])
        boxes = [(slice(y, y + h), slice(x, x + w)) for x, y, w, h in lines]
        coverage[n] = {k: [float((mk[b] > 127).mean()) for b in boxes]
                       for k, mk in (("text_mask", text[n]),
                                     ("step1_mask", wm), ("both", both))}
        glyphs[n] = {k: [float((mk[b] > 127)[text_inks[n][b]].mean())
                         for b in boxes]
                     for k, mk in (("text_mask", text[n]),
                                   ("step1_mask", wm), ("both", both))}
    low = min(min(g["both"]) for g in glyphs.values())
    log("repair_cli_ocr_glyph_cover", line_box_cover=coverage,
        glyph_cover=glyphs, least_both=low, gate=GLYPH_COVER)
    if low < GLYPH_COVER:
        raise AssertionError(f"a drawn line keeps {1 - low:.3f} of its glyph "
                             f"pixels outside the step-1 and text masks "
                             f"(gate {GLYPH_COVER}): {glyphs}")
    # the detector on the CPU on the same step-2 files, filled and dilated
    # as step 3 does it (in this process: its torch ops use every core):
    # every file with text, and CPU_DETECT_EMPTY of the others, the
    # smallest (cut from all 17 files to buy phase 3l its time)
    t0 = time.perf_counter()
    empty = sorted((n for n, tm in text.items()
                    if tm is not None and not tm.any()),
                   key=lambda n: (text[n].size, n))[:CPU_DETECT_EMPTY]
    cpu_checked = sorted(n for n, tm in text.items()
                         if tm is not None and (tm.any() or n in empty))
    for n in cpu_checked:
        tm = text[n]
        step2 = out / "step2_watermark_repaired" / f"{n}.png"
        if not np.array_equal(tm, cpu_text_mask(str(step2), tm.shape)):
            raise AssertionError(f"{n}'s text mask differs from the "
                                 f"detector's on the CPU")
        if tm.any():
            keep = tm <= 127
            if not np.array_equal(image_io.read_rgb(out / f"{n}.png")[keep],
                                  image_io.read_rgb(step2)[keep]):
                raise AssertionError(f"{n}: final pixels outside the text "
                                     f"mask differ from step 2's")
    cpu_detect_s = time.perf_counter() - t0
    merged = 0
    for path in sorted((out / "masks").iterdir()):
        n = path.stem
        wm = image_io.read_gray(out / "step1_masks" / f"{n}_mask.png")
        if text[n] is not None:
            wm = np.maximum(wm, text[n])
        padded, (h, w) = pad_to_multiple(
            (torch.from_numpy(wm).to(dev) > 127).float(), 32)
        ref = (maskproc.optimize_watermark_mask_tight(padded)[:h, :w]
               * 255).to(torch.uint8).cpu().numpy()
        if not np.array_equal(image_io.read_gray(path), ref):
            raise AssertionError(f"{n}'s merged mask differs from the plain "
                                 f"tight chain of max(step-1, text mask)")
        merged += 1
    with_text = sorted(n for n, tm in text.items()
                       if tm is not None and tm.any())
    return {"images": len(sizes), "text_masks": len(
        [n for n in text if text[n] is not None]),
        "with_text": with_text, "least_glyph_cover": low,
        "text_masks_equal_cpu_detector": cpu_checked,
        "cpu_detector_s": cpu_detect_s, "merged_masks_equal_plain": merged,
        "summary": {k: summary[k] for k in (
            "total_images", "successful_images", "avg_watermark_ratio",
            "avg_text_pixels", "steps_completed", "engine_failures",
            "engine_used", "ocr_engine_used", "ocr_failures")}}


def repair_cli_ocr_phase(work: Path, seed: int, dev, text_shapes=TEXT_SHAPES,
                         text_logo=TEXT_LOGO, device="cuda"):
    """Phase 3e: the `repair` command with OCR on (every flag at its
    default) on 3d's folder (work / "in") plus the text images, then the
    text surfaces; logs the checks and returns the timing fields and kernel
    launches for phase 4's line."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.configs import get_cfg_defaults
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.ocr import BuiltinTextDetector
    from unet_watermark_tpu_torch.ops import imgproc
    from unet_watermark_tpu_torch.ops import morphology as m
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.utils import image_io
    from unet_watermark_tpu_torch.utils.synthetic import text_images

    folder = work / "in_ocr"
    shutil.copytree(work / "in", folder)
    sizes = {p.stem: image_io.check_image(p) for p in folder.iterdir()}
    imgs, boxes, inks = text_images(text_shapes, seed=seed + 20,
                                    logo=text_logo)
    text_boxes, text_inks = {}, {}
    for i, (img, lines, ink) in enumerate(zip(imgs, boxes, inks)):
        name = f"t{i:02d}"
        image_io.write_png(folder / f"{name}.png", img, filters=(1,))
        sizes[name] = img.shape[:2]
        text_boxes[name] = lines
        text_inks[name] = ink
    argv = ["repair", "--input", str(folder)]
    if device != "cuda":  # the flag's default
        argv += ["--device", device]
    # the detector on the card finds each drawn line of the images as
    # written: its text mask covers >= 90 % of each line's box
    det = BuiltinTextDetector(device=device)
    recall = {n: [float((mask[y:y + h, x:x + w] > 0).mean())
                  for x, y, w, h in text_boxes[n]]
              for n, mask in ((n, det.generate_text_mask(str(
                  folder / f"{n}.png"))) for n in text_boxes)}
    if min(min(v) for v in recall.values()) < 0.9:
        raise AssertionError(f"the builtin detector on the card covers the "
                             f"drawn lines {recall}")

    # the command as users type it, once, each stage timed (one run since
    # phase 3j: the untimed run before it bought 3j its time)
    kc.reset_launch_counts()
    rc, wall_timed, split = run_cli(
        argv + ["--output", str(work / "out_ocr")], dev, timer=True)
    launches = {k.__name__: k.launches for k in kc.KERNELS}
    if rc != 0:
        raise AssertionError(f"repair (OCR on) exited {rc}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the OCR-on run's step 1 never launched "
                                 f"{name}")
    checks = check_ocr_outputs(work / "out_ocr", sizes, text_boxes,
                               text_inks, dev)
    log("repair_cli_ocr", argv=argv[:1] + argv[3:], rc=rc, launches=launches,
        text_shapes=[list(t) for t in text_shapes], text_logo=text_logo,
        text_lines={k: [list(b) for b in v] for k, v in text_boxes.items()},
        detector_line_coverage_as_written=recall, **checks,
        final_keep_step2_outside_text_mask=True)
    n = len(sizes)

    # the text surfaces: _enhance_text_features on a 1080 x 1920 image,
    # and predict_mask's text type in float32, card against CPU
    cfg = get_cfg_defaults()
    cfg.MODEL.DTYPE = "float32"
    pred32 = WatermarkPredictor(cfg, device=device)
    pred_cpu = WatermarkPredictor(cfg, device="cpu")
    big = torch.from_numpy(imgs[-1])
    enh = pred32._enhance_text_features(big.to(dev))
    # card against CPU on the 720 x 1280 image (the CPU's CLAHE and Canny
    # take seconds at 1080 x 1920)
    mid = torch.from_numpy(imgs[-2])
    if not torch.equal(pred32._enhance_text_features(mid.to(dev)).cpu(),
                       pred_cpu._enhance_text_features(mid)):
        raise AssertionError("_enhance_text_features on the card differs "
                             "from the CPU's")
    big_d = big.to(dev)
    enhance_ms = cuda_ms(lambda: pred32._enhance_text_features(big_d), 5,
                         warmup=1)
    # its parts: the method's steps with an event between each two, 5
    # calls in one run, so that the parts add up to that run's "total"
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    enhance_split_ms = dict.fromkeys(
        ("gray_clahe", "canny", "dilate_boost_sharpen", "total"), 0.0)
    for _ in range(5):
        torch.cuda.synchronize()
        marks[0].record()
        eq = imgproc.clahe(imgproc.gray_u8(big_d, "rgb"), 2.0, (8, 8))
        marks[1].record()
        edges = imgproc.canny(eq, 50, 150)
        marks[2].record()
        on = imgproc.grey_dilate(edges, m.ellipse_kernel(2, 2)) > 0
        x = big_d.float()
        x = torch.where(on[..., None],
                        torch.clamp(x * float(np.float32(1.2)), 0, 255), x)
        out = imgproc.filter2d_u8(x.to(torch.uint8), imgproc.SHARPEN)
        marks[3].record()
        torch.cuda.synchronize()
        for k, a, b in (("gray_clahe", 0, 1), ("canny", 1, 2),
                        ("dilate_boost_sharpen", 2, 3), ("total", 0, 3)):
            enhance_split_ms[k] += marks[a].elapsed_time(marks[b]) / 5
    if not torch.equal(out, enh):
        raise AssertionError("the timed parts of _enhance_text_features "
                             "compute another image than the method")
    # the detector on the same image (host clock: its labelling loops sync
    # every round)
    det_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        det.detect_text_regions(imgs[-1])
        torch.cuda.synchronize()
        det_times.append((time.perf_counter() - t0) * 1e3)
    path = str(folder / "t00.png")
    mask_gpu = pred32.predict_mask(path, "text")
    mask_cpu = pred_cpu.predict_mask(path, "text")
    agree = float((mask_gpu == mask_cpu).mean())
    log("text_surfaces", enhance_shape=list(big.shape),
        enhance_gpu_equals_cpu=True,
        enhance_gpu_vs_cpu_shape=list(mid.shape), enhance_ms=enhance_ms,
        enhance_split_ms=enhance_split_ms, detect_ms=det_times,
        predict_mask_text_shape=list(mask_gpu.shape),
        predict_mask_text_fp32_gpu_vs_cpu_agreement=agree,
        predict_mask_text_fraction=float((mask_gpu > 0).mean()))
    if agree < 0.999:
        raise AssertionError(f"predict_mask text: card and CPU agree on "
                             f"{agree:.5f} of pixels")
    return {"images": n, "text_images": len(text_boxes),
            "wall_timed_s": wall_timed, "img_per_s_timed": n / wall_timed,
            "split_s": {k: split.get(k, 0.0) for k in STAGES},
            "other_s": wall_timed - sum(split.values()),
            "enhance_1080x1920_ms": enhance_ms,
            "enhance_split_ms": enhance_split_ms,
            "detect_1080x1920_ms": float(np.median(det_times)),
            "launches": launches,
            "with_text": checks["with_text"]}


# phase 3f's JPEG folder, written by utils/synthetic.encode_jpeg: (name,
# upright height, width, quality, sampling, progressive, restart interval
# in MCUs, EXIF orientation, what is done to the file); the j* files are
# cv2's default form, the last 2 without a logo. A file with orientation 6
# is stored turned a quarter left (its stored height is the upright width)
JPEG_FOLDER = tuple(
    (f"j{i:02d}", 512, 512, 95, "420", False, 0, None, None)
    for i in range(8)) + (
    ("r0", 720, 1280, 90, "444", False, 4, None, None),
    ("s0", 720, 1280, 85, "422", False, 0, None, None),
    ("p0", 1080, 1920, 95, "420", True, 0, None, None),
    ("o0", 1080, 1920, 95, "420", False, 0, 6, None),
    ("g0", 512, 512, 95, "gray", False, 0, None, None),
    ("m0", 4032, 3024, 90, "420", False, 0, 6, None),  # a phone's photo
    ("t0", 1080, 1920, 95, "420", False, 0, None, "cut 30 %"),
    # progressive, cut: libjpeg's block smoothing runs on its coefficients
    ("u0", 720, 1280, 95, "420", True, 0, None, "cut 30 %"),
    ("x0", 512, 512, 95, "420", False, 0, None, "cut before SOS"))
JPEG_CLEAN = 2  # the last j* files carry no logo
JPEG_NO_UNET = ("j00", "j06", "o0", "p0")  # the --no-unet run's files
# the files whose decode is timed: baseline (t0 before its cut),
# progressive, phone-size
JPEG_TIMED = {"baseline_1080x1920": "t0", "progressive_1080x1920": "p0",
              "baseline_3024x4032": "m0"}


def write_jpeg_folder(folder: Path, seed: int, spec=JPEG_FOLDER,
                      clean=JPEG_CLEAN, pool=None) -> dict:
    """Phase 3f's folder, a file a worker process of `pool` (a new
    host_pool without one); returns {name: (file bytes, upright (h, w),
    the uncut file's bytes)}."""
    folder.mkdir(parents=True)
    n_j = sum(1 for f in spec if f[0].startswith("j"))
    no_logo = [f[0].startswith("j") and int(f[0][1:]) >= n_j - clean
               for f in spec]
    with contextlib.ExitStack() as stack:
        if pool is None:
            pool = stack.enter_context(host_pool())
        made = list(pool.map(jpeg_folder_file, spec,
                             [seed + 30 + k for k in range(len(spec))],
                             no_logo))
    files = {}
    for (name, *_), (data, hw, full) in zip(spec, made):
        (folder / f"{name}.jpg").write_bytes(data)
        files[name] = (data, hw, full)
    return files


def write_folders(work: Path, seed: int) -> dict:
    """Phases 3d's, 3f's and 3o's input files, written by host workers while
    the kernels build (phase 1), and 3f's plain entropy decodes of its
    files (plain_scans), run there too: {"png": (write_cli_folder's sizes,
    seconds), "jpeg": (write_jpeg_folder's files, seconds, {name:
    plain_scans}), "formats": smoke_formats.write_inputs' result}."""
    t0 = time.perf_counter()
    with host_pool(4) as pool:
        png = pool.submit(write_cli_folder, work / "in", seed)
        formats = pool.submit(write_inputs, work, seed)
        files = write_jpeg_folder(work / "in_jpeg", seed, pool=pool)
        jpeg_s = time.perf_counter() - t0
        names = sorted(files)
        plains = dict(zip(names, pool.map(plain_scans,
                                          [files[n][0] for n in names])))
        sizes = png.result()
        formats = formats.result()
    return {"png": (sizes, time.perf_counter() - t0),
            "jpeg": (files, jpeg_s, plains), "formats": formats}


def jpeg_folder_file(entry, seed: int, no_logo: bool):
    """One file of phase 3f's folder: (file bytes, upright (h, w), the
    uncut file's bytes)."""
    import numpy as np
    from unet_watermark_tpu_torch.utils import jpeg
    from unet_watermark_tpu_torch.utils.synthetic import encode_jpeg

    name, h, w, q, sampling, prog, rst, orient, cut = entry
    img = cropped_images(1, h, w, seed, clean=int(no_logo))[0]
    if sampling == "gray":
        img, sampling = np.ascontiguousarray(img[..., 1]), "444"
    if orient == 6:  # stored turned left; cv2 turns it back
        img = np.ascontiguousarray(np.rot90(img, 1))
    full = encode_jpeg(img, q, sampling, prog, rst, orient)
    data = full
    if cut == "cut 30 %":
        start = jpeg.parse(full, headers_only=True).scans[0].start
        data = full[:start + (len(full) - start) * 3 // 10]
    elif cut == "cut before SOS":
        data = full[:full.index(b"\xff\xda")]
    return data, (h, w), full


def plain_scans(data: bytes):
    """The plain route's entropy decode of one file (the Python decoder):
    (the header, which the decode marks where a scan was cut, and the
    coefficients, or None twice where the headers do not parse; seconds)."""
    from unet_watermark_tpu_torch.utils import jpeg

    try:
        header = jpeg.parse(data)
    except jpeg.JPEGError:
        return None, None, 0.0
    t0 = time.perf_counter()
    coefs = jpeg.decode_scans(header, data)
    return header, coefs, time.perf_counter() - t0


def cpu_text_mask(step2: str, shape):
    """The builtin detector on the CPU on one step-2 file, its regions
    filled and dilated as step 3 does it."""
    import torch
    from unet_watermark_tpu_torch.ocr.base import rasterize_regions
    from unet_watermark_tpu_torch.ocr.builtin import BuiltinTextDetector
    from unet_watermark_tpu_torch.ops import morphology as m

    det = BuiltinTextDetector(device="cpu")
    ref = rasterize_regions(det.detect_text_regions(step2), *shape)
    if ref.any():
        ref = (m.dilate(torch.from_numpy(ref > 0).float(),
                        m.ellipse_kernel(5, 5), 2) * 255).to(
            torch.uint8).numpy()
    return ref


def jpeg_routes(files: dict, dev, plains: dict = None) -> dict:
    """Every file through the card's route (the C entropy decoder, the
    pixel stage on the card; image_io.decode_jpeg) and the plain one (the
    Python entropy decoder, the pixel stage on the CPU), colour and gray:
    byte for byte equal, or JPEGError from both. `plains` holds each
    file's plain_scans where host workers already ran them (else they run
    here, a file a worker). Returns each file's decoded RGB (from the
    card) and the plain entropy decode's seconds."""
    import torch
    from unet_watermark_tpu_torch.ops import jpeg as jpeg_pixels
    from unet_watermark_tpu_torch.ops.kernels import jpeg_entropy
    from unet_watermark_tpu_torch.utils import image_io, jpeg

    decoded, plain_s = {}, 0.0
    names = sorted(files)
    if plains is None:
        with host_pool() as pool:  # the plain entropy decodes
            plains = dict(zip(names, pool.map(
                plain_scans, [files[n][0] for n in names])))
    for name, (data, hw, _) in sorted(files.items()):
        header, coefs, seconds = plains[name]
        if header is None:
            for device in (dev, "cpu"):
                try:
                    image_io.decode_jpeg(data, device)
                except jpeg.JPEGError:
                    continue
                raise AssertionError(f"{name} decodes on {device}")
            decoded[name] = None
            continue
        plain_s += seconds
        for gray in (False, True):
            calls = jpeg_entropy.decode_scans_c.calls
            card = image_io.decode_jpeg(data, dev, gray)
            if jpeg_entropy.decode_scans_c.calls != calls + 1:
                raise AssertionError("the card's route did not run the C "
                                     "entropy decoder")
            plain = jpeg_pixels.decode(header, [torch.from_numpy(c)
                                                for c in coefs], gray)
            if card.device.type != dev.type or \
                    not torch.equal(card.cpu(), plain):
                raise AssertionError(f"{name} (gray={gray}): the card's "
                                     f"route differs from the plain one")
            if tuple(card.shape[:2]) != hw:
                raise AssertionError(f"{name} decodes at {card.shape}, "
                                     f"upright {hw}")
            if not gray:
                decoded[name] = card.cpu().numpy()
    return {"decoded": decoded, "plain_entropy_s": plain_s}


def jpeg_decode_ms(files: dict, dev, rounds: int = 5) -> dict:
    """The timed files' decodes on the card's route, the median of
    `rounds`: the entropy decode (host clock: parse and C decoder), the
    pixel stage (CUDA events: upload and pixel stage) and both."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.ops import jpeg as jpeg_pixels
    from unet_watermark_tpu_torch.ops.kernels import jpeg_entropy
    from unet_watermark_tpu_torch.utils import jpeg

    out = {}
    for key, name in JPEG_TIMED.items():
        full = files[name][2]
        entropy, pixels = [], []
        for _ in range(rounds + 1):  # the first round warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            header = jpeg.parse(full)
            coefs = jpeg_entropy.decode_scans(header, full, dev)
            entropy.append((time.perf_counter() - t0) * 1e3)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            jpeg_pixels.decode(header, [torch.from_numpy(c).to(dev)
                                        for c in coefs])
            end.record()
            torch.cuda.synchronize()
            pixels.append(start.elapsed_time(end))
        e, p = float(np.median(entropy[1:])), float(np.median(pixels[1:]))
        out[key] = {"file": name, "bytes": len(full), "entropy_ms": e,
                    "pixels_ms": p, "total_ms": e + p,
                    "entropy_rounds_ms": entropy[1:],
                    "pixels_rounds_ms": pixels[1:]}
    return out


def check_jpeg_outputs(out: Path, files: dict, decoded: dict) -> dict:
    """Phase 3f's file checks; returns counts for its log line."""
    import numpy as np
    from unet_watermark_tpu_torch.utils import image_io

    summary = json.loads((out / "repair_summary.json").read_text())
    want = {"status": "success", "ocr_engine_used": "builtin",
            "ocr_failures": 0, "engine_failures": 0,
            "engine_used": "ffc-lama"}
    if any(summary.get(k) != v for k, v in want.items()):
        raise AssertionError(f"repair summary (JPEG folder) is not {want}: "
                             f"{summary}")
    masks = {}
    for name, (_, hw, _) in files.items():
        path = out / "step1_masks" / f"{name}_mask.png"
        if decoded[name] is None:
            if path.exists():
                raise AssertionError(f"a mask for the unreadable {name}")
            continue
        masks[name] = image_io.read_gray(path)
        if masks[name].shape != hw:
            raise AssertionError(f"{name}'s step-1 mask is "
                                 f"{masks[name].shape}, its image {hw}")
    detected = sorted(n for n, mk in masks.items() if mk.any())
    for name in detected:
        hw = files[name][1]
        rep = image_io.read_rgb(out / "step2_watermark_repaired"
                                f"/{name}.png")
        keep = masks[name] <= 127
        if rep.shape[:2] != hw or not np.array_equal(rep[keep],
                                                     decoded[name][keep]):
            raise AssertionError(f"{name}: step 2 changed pixels outside "
                                 f"the step-1 mask (or its size)")
        for path in (out / f"{name}.png", out / "masks" / f"{name}.png"):
            got = image_io.check_image(path)
            if got != hw:
                raise AssertionError(f"{path.name} is {got}, its image {hw}")
    text = sorted(p.name for p in (out / "step3_text_masks").iterdir()) \
        if (out / "step3_text_masks").is_dir() else []
    for tm in text:
        hw = files[tm[:-len("_text_mask.png")]][1]
        if image_io.check_image(out / "step3_text_masks" / tm) != hw:
            raise AssertionError(f"{tm} is not at its image's size {hw}")
    return {"images": len(files), "decodable": len(masks),
            "detected": detected, "text_masks": len(text),
            "summary": {k: summary[k] for k in (
                "total_images", "successful_images", "avg_watermark_ratio",
                "avg_text_pixels", "steps_completed", "engine_failures",
                "engine_used", "ocr_engine_used", "ocr_failures")}}


def repair_cli_jpeg_phase(work: Path, seed: int, dev, spec=JPEG_FOLDER,
                          clean=JPEG_CLEAN, no_unet=JPEG_NO_UNET,
                          device="cuda", written=None):
    """Phase 3f: the `repair` command as users type it on a folder of
    JPEGs, then --no-unet on a few of them; logs the checks and returns the
    timing fields and kernel launches for phase 4's line. `written` is
    write_folders' (files, seconds, plain decodes) where the folder is
    already written."""
    import torch

    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.utils import image_io

    folder = work / "in_jpeg"
    plains = None
    if written is None:
        t0 = time.perf_counter()
        files = write_jpeg_folder(folder, seed, spec, clean)
        write_s = time.perf_counter() - t0
    else:  # written and decoded by host workers while the kernels built
        files, write_s, plains = written
    routes = jpeg_routes(files, dev, plains)
    argv = ["repair", "--input", str(folder)]
    if device != "cuda":  # the flag's default
        argv += ["--device", device]

    # the command as users type it, once, each stage timed (the decode
    # stage's JPEG parts apart) with the card's peak allocation over the
    # run (one run since phase 3j: the untimed run before it bought 3j its
    # time)
    kc.reset_launch_counts()
    parts = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rc, wall_timed, split = run_cli(
        argv + ["--output", str(work / "out_jpeg")], dev, timer=True,
        parts=parts)
    launches = {k.__name__: k.launches for k in kc.KERNELS}
    if rc != 0:
        raise AssertionError(f"repair (JPEG folder) exited {rc}")
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20 \
        if dev.type == "cuda" else None
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the JPEG run's step 1 never launched "
                                 f"{name}")
    checks = check_jpeg_outputs(work / "out_jpeg", files, routes["decoded"])
    log("repair_cli_jpeg", argv=argv[:1] + argv[3:], rc=rc,
        launches=launches,
        files=[{"name": f[0], "upright": [f[1], f[2]], "quality": f[3],
                "sampling": f[4], "progressive": f[5], "restart": f[6],
                "orientation": f[7], "cut": f[8],
                "bytes": len(files[f[0]][0])} for f in spec],
        write_folder_s=write_s, card_route_equals_plain=True,
        plain_entropy_s=routes["plain_entropy_s"], **checks,
        repaired_keep_unmasked_bytes=True)
    # --no-unet: each file copied to step 2's folder as {stem}.png,
    # which steps 3 and 4 read as the JPEG it is
    sub = work / "in_jpeg_no_unet"
    sub.mkdir()
    for name in no_unet:
        (sub / f"{name}.jpg").write_bytes(files[name][0])
    rc = run_cli(argv[:1] + ["--input", str(sub), "--no-unet", "--output",
                             str(work / "out_jpeg_no_unet")] + argv[3:],
                 dev, timer=False)[0]
    out = work / "out_jpeg_no_unet"
    summary = json.loads((out / "repair_summary.json").read_text())
    if rc != 0 or summary["status"] != "success" or summary["ocr_failures"]:
        raise AssertionError(f"repair --no-unet (JPEG) exited {rc}: "
                             f"{summary}")
    for name in no_unet:
        copy = out / "step2_watermark_repaired" / f"{name}.png"
        if copy.read_bytes()[:3] != b"\xff\xd8\xff":
            raise AssertionError(f"{copy.name} is not the JPEG copied")
        if image_io.check_image(out / f"{name}.png") != files[name][1]:
            raise AssertionError(f"--no-unet final {name} is not upright")
    text = sorted(p.name for p in (out / "step3_text_masks").iterdir())
    log("repair_cli_jpeg_no_unet", files=list(no_unet), rc=rc,
        text_masks=text, summary={k: summary[k] for k in (
            "total_images", "successful_images", "steps_completed",
            "ocr_engine_used", "ocr_failures")})
    n = len(files)
    return {"images": n, "jpeg_decode_ms": jpeg_decode_ms(files, dev),
            "wall_timed_s": wall_timed,
            "img_per_s_timed": n / wall_timed,
            "split_s": {k: split.get(k, 0.0) for k in STAGES},
            "decode_parts_s": parts, "peak_alloc_mib": peak_mib,
            "other_s": wall_timed - sum(split.values()),
            "launches": launches}


# phase 3g: the int8 tier's conv count a forward, by arch (the sidecars'
# entries), the convs of the UNet++ forward timed one by one (their sidecar
# paths), and the 3d files the `repair --quant` run takes
INT8_CONVS = {"Unet": 50, "UnetPlusPlus": 68}
INT8_SHAPES = ("encoder/conv1", "encoder/layer1_0/conv1",
               "encoder/layer4_1/conv1", "decoder/x_0_1_conv1/conv:skip",
               "decoder/final_block/conv1/conv:up",
               "decoder/final_block/conv2/conv")
INT8_CLI_FILES = ("a00", "a01", "a02", "a03")


def conv_s8_int_mm(call):
    """im2col (F.unfold on the fp16 copy, the dilated input written out)
    and torch._int_mm on the int8 operands, K padded to a multiple of 8;
    None where _int_mm does not take the shape."""
    import torch
    import torch.nn.functional as F
    from unet_watermark_tpu_torch.ops import quant

    xq, wq, scale, kw = call
    cout, cin, kh, kwid = wq.shape
    k = cin * kh * kwid
    kp = -(-k // 8) * 8
    if cout % 8:
        return None
    x = xq[:, :cin].half()
    b = torch.zeros(kp, cout, dtype=torch.int8, device=xq.device)
    b[:k] = wq.reshape(cout, k).t()

    def run():
        xi = quant.dilate2(x) if kw["dilation"] == 2 else x
        cols = F.unfold(xi, (kh, kwid), padding=kw["padding"],
                        stride=kw["stride"])  # (n, k, L)
        a = cols.transpose(1, 2).reshape(-1, k).to(torch.int8)
        if kp != k:
            a = F.pad(a, (0, kp - k))
        return torch._int_mm(a, b)
    return run


def int8_tier_phase(work: Path, preds: dict, fused_bf16, images, seed: int,
                    dev) -> dict:
    """Phase 3g: the int8 tier (PREDICT.QUANT) through uwt_quantize_s8 and
    uwt_conv_s8. For each arch, one forward at BATCH x SIZE² with every
    launch of both held bit for bit against its plain version on the card,
    and the launch counts; the masks against the bf16 tier's; the default
    fused fn with LaMa under PREDICT.QUANT (checks of phase 3c, timed
    beside the bf16 fn in turns); the network in turns with bf16 for both
    archs; the UNet++ forward's quantizes and convs replayed back to back
    beside their bound and plain versions (the convs also beside cuDNN's
    bf16 conv, and by shape beside im2col + torch._int_mm); `repair --quant
    --no-ocr` on 4 of 3d's files, every launch held as in the forwards.
    Returns the kernel line's two entries and the timing fields."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.configs import get_cfg_defaults
    from unet_watermark_tpu_torch.inference import maskproc
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.ops import quant
    from unet_watermark_tpu_torch.ops.kernels import conv_s8 as k8

    t_phase = time.perf_counter()
    real, real_quantize = k8.conv_s8, k8.quantize_s8
    qpreds, forward_calls, forward_quantizes, agree = {}, {}, {}, {}
    for arch, expect in INT8_CONVS.items():
        cfg = get_cfg_defaults()
        cfg.MODEL.NAME = arch
        cfg.PREDICT.QUANT = True
        pq = WatermarkPredictor(cfg)
        if len(pq._quant_plans) != expect:
            raise AssertionError(f"{arch}: {len(pq._quant_plans)} int8 plans, "
                                 f"not {expect}")
        calls, quantized = [], []
        k8.reset_launch_counts()
        k8.conv_s8, k8.quantize_s8 = int8_hooks(real, real_quantize, calls,
                                                quantized)
        try:
            raw_q = pq.predict_masks(images)
            torch.cuda.synchronize()
        finally:
            k8.conv_s8, k8.quantize_s8 = real, real_quantize
        if real_quantize.launches != expect or len(quantized) != expect:
            raise AssertionError(f"{arch}: {real_quantize.launches} launches "
                                 f"of uwt_quantize_s8 in a forward, not "
                                 f"{expect}")
        if real.launches != expect or len(calls) != expect:
            raise AssertionError(f"{arch}: {real.launches} launches of "
                                 f"uwt_conv_s8 in a forward, not {expect}")
        raw_b = preds[arch].predict_masks(images)
        agree[arch] = (raw_q == raw_b).float().mean().item()
        if agree[arch] < 0.97:  # the JAX package's test_predictor_quant_tier
            raise AssertionError(f"{arch}: int8 and bf16 masks agree on "
                                 f"only {agree[arch]:.4%} of pixels")
        qpreds[arch] = pq
        forward_calls[arch] = calls
        forward_quantizes[arch] = quantized
        log("int8_forward", arch=arch, images=list(images.shape),
            launches=real.launches,
            quantize_launches=real_quantize.launches,
            every_launch_equals_plain=True,
            every_quantize_equals_plain=True,
            int8_vs_bf16_mask_agreement=round(agree[arch], 6),
            scales=len(pq._quant_scales))

    # the default fused fn (UNet++, LaMa) under PREDICT.QUANT
    pq = qpreds["UnetPlusPlus"]
    fused_q = pq.make_fused_repair_fn()
    if fused_q.engine_used != "ffc-lama":
        raise AssertionError(f"int8 fused fn fills with {fused_q.engine_used}")
    k8.reset_launch_counts()
    repaired_q, mask_q = fused_q(images)
    torch.cuda.synchronize()
    fused_launches = (real.launches, real_quantize.launches)
    if fused_launches != (INT8_CONVS["UnetPlusPlus"],) * 2:
        raise AssertionError(f"the int8 fused fn launched uwt_conv_s8 and "
                             f"uwt_quantize_s8 {fused_launches} times")
    check_repair(images, repaired_q, mask_q)
    raw_q = pq.predict_masks(images)
    for i, mk in enumerate(raw_q):
        if not torch.equal(mask_q[i],
                           maskproc.optimize_watermark_mask_tight(mk)):
            raise AssertionError(f"int8 fused fn's mask of image {i} differs "
                                 f"from the plain tight chain")
    # in turns: bf16, int8, int8, bf16 (fused fn with LaMa, then networks)
    n = images.shape[0]
    rounds = {"fused_bf16_ms": [], "fused_int8_ms": []}
    for key in ("fused_bf16_ms", "fused_int8_ms", "fused_int8_ms",
                "fused_bf16_ms"):
        fn = fused_bf16 if key == "fused_bf16_ms" else fused_q
        rounds[key].append(cuda_ms(lambda: fn(images), 5, warmup=2))
    net = {}
    with torch.inference_mode():
        for arch in INT8_CONVS:
            b, q = preds[arch], qpreds[arch]
            r = [cuda_ms(lambda: m.predict_masks(images), 10)
                 for m in (b, q, q, b)]
            net[arch] = {"bf16_network_ms": (r[0] + r[3]) / 2,
                         "int8_network_ms": (r[1] + r[2]) / 2, "rounds": r}
    fused_ms = {k: float(np.mean(v)) for k, v in rounds.items()}
    with torch.inference_mode():
        for tier, m in (("int8", qpreds["UnetPlusPlus"]),
                        ("bf16", preds["UnetPlusPlus"])):
            log(f"profile_{tier}_network", arch="UnetPlusPlus",
                **profile_window(lambda: m.predict_masks(images), 1))

    # the UNet++ forward's convs: the whole set back to back, and by shape
    calls = forward_calls["UnetPlusPlus"]
    by_weight = {id(p.wq): k for k, p in pq._quant_plans.items()}
    paths = [by_weight[id(c[1])] for c in calls]
    work_ops = work_bytes = bound = 0.0
    for c in calls:
        ops, nbytes = conv_s8_bound(c)
        work_ops += ops
        work_bytes += nbytes
        bound += max(ops / PEAK_INT8_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)

    def replay(fn):
        return lambda: [fn(c) for c in calls]

    with torch.inference_mode():
        kernel_all = replay(lambda c: real(c[0], c[1], c[2], **c[3]))
        libs = [conv_s8_library(c) for c in calls]
        timed = {"ms": kernel_all, "library_ms": lambda: [f() for f in libs]}
        t_rounds = {k: [] for k in timed}
        for r in range(4):
            for key in (list(timed) if r % 2 == 0 else list(timed)[::-1]):
                t_rounds[key].append(cuda_ms(timed[key], 5, warmup=1))
        plain_ms = cuda_ms(replay(lambda c: quant.conv_s8_plain(
            c[0], c[1], c[2], c[3]["stride"], c[3]["padding"],
            c[3]["dilation"], c[3]["out_dtype"])), 1, warmup=1)
        conv_device_ms = profiled_ms(kernel_all, "conv_s8_kernel", 5,
                                     per_call=len(calls))
        conv_host_ms = host_ms(kernel_all, 3) / len(calls)
        shapes = []
        for path in INT8_SHAPES:
            c = calls[paths.index(path)]
            ops, nbytes = conv_s8_bound(c)
            mm = conv_s8_int_mm(c)
            shapes.append({
                "path": path, "x": list(c[0].shape), "w": list(c[1].shape),
                "stride": c[3]["stride"], "dilation": c[3]["dilation"],
                "ms": cuda_ms(lambda: real(c[0], c[1], c[2], **c[3]), 20),
                "plain_ms": cuda_ms(lambda: quant.conv_s8_plain(
                    c[0], c[1], c[2], c[3]["stride"], c[3]["padding"],
                    c[3]["dilation"], c[3]["out_dtype"]), 2, warmup=1),
                "cudnn_bf16_ms": cuda_ms(conv_s8_library(c), 20),
                "im2col_int_mm_ms": cuda_ms(mm, 5) if mm else None,
                "bound_ms": max(ops / PEAK_INT8_OPS_PER_S,
                                nbytes / PEAK_BYTES_PER_S) * 1e3,
                "bound_by": "operations" if ops / PEAK_INT8_OPS_PER_S >=
                nbytes / PEAK_BYTES_PER_S else "bytes",
                "gop": ops / 1e9, "mb": nbytes / 1e6})
    # the library call computes the same sums (bf16 output)
    c = calls[paths.index("decoder/final_block/conv1/conv:up")]
    acc = quant.conv_sums_plain(c[0], c[1], 1, 2, 2).float()
    lib = libs[paths.index("decoder/final_block/conv1/conv:up")]().float()
    lib_err = ((lib - acc).abs().max() / acc.abs().max().clamp(min=1)).item()
    if lib_err > 1e-2:
        raise AssertionError(f"the cuDNN yardstick of the up-conv is another "
                             f"function (relative error {lib_err})")
    ms = float(np.median(t_rounds["ms"]))
    library_ms = float(np.median(t_rounds["library_ms"]))
    ops_ms, bytes_ms = (work_ops / PEAK_INT8_OPS_PER_S * 1e3,
                        work_bytes / PEAK_BYTES_PER_S * 1e3)
    log("int8_convs", arch="UnetPlusPlus", launches=len(calls), ms=ms,
        device_ms=conv_device_ms, host_ms_a_call=conv_host_ms,
        plain_ms=plain_ms,
        cudnn_bf16_ms=library_ms, bound_ms=bound * 1e3,
        ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
        gop=work_ops / 1e9, mb=work_bytes / 1e6, rounds_ms=t_rounds,
        cudnn_up_conv_rel_err=lib_err, shapes=shapes)

    # the UNet++ forward's quantizes back to back: the kernel in turns with
    # the torch chain it replaced (quant._quantize, five passes); the plain
    # version (the chain, the stem's operand padded to 16 channels). The
    # bound reads x and writes one byte an element of x: the stem's padding
    # is the conv kernel's need, not the function's.
    qcalls = forward_quantizes["UnetPlusPlus"]
    q_bytes = sum(x.numel() * (x.element_size() + 1) for x, _, _ in qcalls)
    with torch.inference_mode():
        q_timed = {
            "ms": lambda: [real_quantize(*q) for q in qcalls],
            "replaced_torch_chain_ms": lambda: [
                quant._quantize(x, inv) for x, inv, _ in qcalls]}
        q_rounds = {k: [] for k in q_timed}
        for r in range(4):
            for key in (list(q_timed) if r % 2 == 0 else
                        list(q_timed)[::-1]):
                q_rounds[key].append(cuda_ms(q_timed[key], 5, warmup=1))
        q_plain_ms = cuda_ms(lambda: [quant.quantize_s8_plain(*q)
                                      for q in qcalls], 3, warmup=1)
        q_device_ms = profiled_ms(q_timed["ms"], "quantize_s8", 5,
                                  per_call=len(qcalls))
        q_host_ms = host_ms(q_timed["ms"], 3) / len(qcalls)
        stem = next(q for q in qcalls if q[2] and q[2] != q[0].shape[1])
        stem_ms = cuda_ms(lambda: real_quantize(*stem), 20)
    q_ms = float(np.median(q_rounds["ms"]))
    chain_ms = float(np.median(q_rounds["replaced_torch_chain_ms"]))
    log("int8_quantizes", arch="UnetPlusPlus", launches=len(qcalls),
        ms=q_ms, device_ms=q_device_ms, host_ms_a_call=q_host_ms,
        plain_ms=q_plain_ms,
        replaced_torch_chain_ms=chain_ms,
        bound_ms=q_bytes / PEAK_BYTES_PER_S * 1e3, mb=q_bytes / 1e6,
        stem_padded_to_16_ms=stem_ms, stem_shape=list(stem[0].shape),
        rounds_ms=q_rounds)

    # `repair --quant --no-ocr` on 4 of 3d's files
    folder = work / "in_q"
    folder.mkdir()
    for stem in INT8_CLI_FILES:
        shutil.copy(work / "in" / f"{stem}.png", folder / f"{stem}.png")
    argv = ["repair", "--input", str(folder), "--output", str(work / "out_q"),
            "--no-ocr", "--quant"]
    k8.reset_launch_counts()
    cli_convs, cli_quantizes = [], []
    k8.conv_s8, k8.quantize_s8 = int8_hooks(real, real_quantize, cli_convs,
                                            cli_quantizes)
    try:
        rc, wall, _ = run_cli(argv, dev, timer=False)
        torch.cuda.synchronize()
    finally:
        k8.conv_s8, k8.quantize_s8 = real, real_quantize
    del cli_convs, cli_quantizes
    cli_launches = (real.launches, real_quantize.launches)
    summary = json.loads((work / "out_q" / "repair_summary.json").read_text())
    if rc != 0 or summary.get("status") != "success" or \
            summary.get("engine_used") != "ffc-lama" or \
            summary.get("engine_failures"):
        raise AssertionError(f"repair --quant: rc {rc}, {summary}")
    if cli_launches != (INT8_CONVS["UnetPlusPlus"],) * 2:  # one batch
        raise AssertionError(f"repair --quant launched uwt_conv_s8 and "
                             f"uwt_quantize_s8 {cli_launches} times")
    masks = sorted(os.listdir(work / "out_q" / "step1_masks"))
    log("repair_cli_quant", argv=argv[:1] + argv[5:], rc=rc,
        launches=cli_launches[0], quantize_launches=cli_launches[1],
        every_launch_equals_plain=True, wall_s=wall, step1_masks=len(masks),
        status=summary["status"], engine=summary["engine_used"])
    timing = {"batch": n, "size": images.shape[1],
              "fused_lama_bf16_ms": fused_ms["fused_bf16_ms"],
              "fused_lama_int8_ms": fused_ms["fused_int8_ms"],
              "fused_lama_bf16_img_per_s": n / (fused_ms["fused_bf16_ms"]
                                                / 1e3),
              "fused_lama_int8_img_per_s": n / (fused_ms["fused_int8_ms"]
                                                / 1e3),
              "fused_rounds_ms": rounds, "networks": net,
              "int8_vs_bf16_mask_agreement": agree,
              "repair_cli_quant_wall_s": wall,
              "phase_s": time.perf_counter() - t_phase}
    kernel = {
        "name": "uwt_conv_s8", "route": "cuda",
        "source": f"{PORT}/csrc/conv_s8.cu",
        "replaces": "unet_watermark_tpu/ops/quant.py:160",
        "launches": fused_launches[0],
        "unet_forward_launches": INT8_CONVS["Unet"],
        "repair_cli_quant_launches": cli_launches[0],
        "max_abs_err": 0.0, "ms": ms, "device_ms": conv_device_ms,
        "host_ms_a_call": conv_host_ms,
        "plain_ms": plain_ms, "bound_ms": bound * 1e3,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
        "what": "the 68 convs of one UNet++ int8 forward at 8 x 512², "
                "back to back"}
    quantize_kernel = {
        "name": "uwt_quantize_s8", "route": "cuda",
        "source": f"{PORT}/csrc/conv_s8.cu",
        "replaces": "unet_watermark_tpu/ops/quant.py:112",
        "launches": fused_launches[1],
        "unet_forward_launches": INT8_CONVS["Unet"],
        "repair_cli_quant_launches": cli_launches[1],
        "max_abs_err": 0.0, "ms": q_ms, "device_ms": q_device_ms,
        "host_ms_a_call": q_host_ms,
        "plain_ms": q_plain_ms, "replaced_torch_chain_ms": chain_ms,
        "bound_ms": q_bytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "what": "the 68 activation quantizes of one UNet++ int8 forward at "
                "8 x 512², back to back"}
    return {"timing": timing, "kernels": [kernel, quantize_kernel]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU "
              "port and has no CPU mode", file=sys.stderr)
        return 2
    if not (REPO / PORT / "csrc" / "morph_chain.cu").is_file():
        print(f"chip_smoke: {PORT}/ not found beside this script; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from unet_watermark_tpu_torch.ops.kernels import build

    # -- 1 (started): one compiler call a source, all started together;
    # the imports, phase 0 and the profiler's first session run meanwhile
    sources = ("morph_chain.cu", "conv_s8.cu", "jpeg_entropy.c",
               "zstd_decode.c", "bmp_rle.c", "webp_decode.c",
               "tiff_codecs.c", "maskops.c")
    t_build = time.perf_counter()

    def timed_build(source):
        return build.build(source), time.perf_counter() - t_build

    starter = ThreadPoolExecutor(len(sources) + 1)
    building = [starter.submit(timed_build, src) for src in sources]
    # meanwhile host workers write phases 3d's and 3f's input folders
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    atexit.register(shutil.rmtree, work, True)
    folders = starter.submit(write_folders, work, args.seed)
    from torch.profiler import ProfilerActivity, profile

    from unet_watermark_tpu_torch.configs import get_cfg_defaults
    from unet_watermark_tpu_torch.inference import engines, maskproc
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.ops import components as cc
    from unet_watermark_tpu_torch.ops.inpaint import inpaint_pushpull
    from unet_watermark_tpu_torch.ops.kernels import conv_s8 as k8
    from unet_watermark_tpu_torch.ops.kernels import jpeg_entropy
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.ops.kernels import tiff as tiff_c
    from unet_watermark_tpu_torch.ops.kernels import webp as webp_c
    from unet_watermark_tpu_torch.ops.kernels import zstd
    from unet_watermark_tpu_torch.utils import bmp, native, shipping
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    dev = torch.device("cuda")
    n, s = BATCH, SIZE
    # full fp32 for the float32 reference's convs and matmuls (the bf16
    # main path does not use TF32 either way); cuDNN defaults to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 0: versions and card ------------------------------------------------
    card = nvidia_smi_line()
    log("versions", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    print(card, flush=True)

    # the profiler's first session sets CUPTI up: once, here
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=dev).add_(1)
        torch.cuda.synchronize()
    profiler_setup_s = time.perf_counter() - t0

    # -- 1: build ------------------------------------------------------------
    if sources != (kc.SOURCE, k8.SOURCE, jpeg_entropy.SOURCE, zstd.SOURCE,
                   bmp.SOURCE, webp_c.SOURCE, tiff_c.SOURCE, native.SOURCE):
        raise AssertionError(f"the build's sources {sources} are not the "
                             f"kernel modules'")
    built = dict(zip(sources, (f.result() for f in building)))
    build_s = max(done for _, done in built.values())
    for source, ((lib, out), _) in built.items():
        log("build", source=source, library=lib.name,
            seconds_all=round(build_s, 3),
            profiler_setup_s=round(profiler_setup_s, 3),
            ptxas=[ln.strip() for ln in out.splitlines()
                   if "registers" in ln or "smem" in ln or "spill" in ln])

    # -- 2: kernels against their plain versions -----------------------------
    for size in (s, 33, 100):
        for name, masks in check_masks(n, size, args.seed).items():
            x = torch.from_numpy(masks).to(dev)
            k1, k1_ref = kc.morph_chain_watermark(x), kc.morph_chain_plain(x)
            k2, k2_ref = (kc.gaussian_smooth_threshold(x),
                          kc.smooth_threshold_plain(x))
            torch.cuda.synchronize()
            k1_err = (k1 - k1_ref).abs().max().item()
            k2_err = (k2 - k2_ref).abs().max().item()
            log("kernel_check", masks=name, shape=list(x.shape),
                k1_mean=round(k1.mean().item(), 6), k1_max_abs_err=k1_err,
                k2_max_abs_err=k2_err)
            if not (torch.equal(k1, k1_ref) and torch.equal(k2, k2_ref)):
                raise AssertionError(
                    f"kernel differs from its plain version on {name} masks "
                    f"at {size}² (K1 {k1_err}, K2 {k2_err})")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    noise = torch.rand(n, s, s, device=dev, generator=gen)
    if not torch.equal(kc.gaussian_smooth_threshold(noise),
                       kc.smooth_threshold_plain(noise)):
        raise AssertionError("K2 differs from its plain version on [0,1) "
                             "noise")
    log("kernel_check", masks="uniform noise (K2)", shape=[n, s, s],
        k2_max_abs_err=0.0)
    for size in (s, 101):
        x = torch.from_numpy(special_floats(n, size, args.seed)).to(dev)
        k2 = kc.gaussian_smooth_threshold(x)
        if not (torch.equal(k2, kc.smooth_threshold_plain(x))
                and torch.equal(k2, (x > 0.5).float())):
            raise AssertionError(f"K2 differs from its plain version or from "
                                 f"x > 0.5 on NaN/inf/0.5 floats at {size}²")
        log("kernel_check", masks="NaN, ±inf, 0.5 and noise (K2)",
            shape=[n, size, size], k2_max_abs_err=0.0,
            k2_equals_threshold=True)

    # -- 3: the main path ----------------------------------------------------
    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME = "Unet", "resnet34"
    cfg.DATA.IMG_SIZE = s
    cfg.PREDICT.MASK_MODE = "parity"
    t0 = time.perf_counter()
    pred = WatermarkPredictor(cfg, device="cuda")
    fused = pred.make_fused_repair_fn(inpaint_engine="pushpull",
                                      smooth_iterations=32)
    load_s = time.perf_counter() - t0
    images_np, logos = watermarked_images(n, s, seed=args.seed)
    images = torch.from_numpy(images_np).to(dev)

    kc.reset_launch_counts()
    t0 = time.perf_counter()
    repaired, mask = fused(images)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kc.KERNELS}
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the main path never launched {name}")

    check_repair(images, repaired, mask)
    raw = pred.predict_masks(images)
    if not torch.equal(raw, pred.predict_masks(images)):
        raise AssertionError("the network's mask is not deterministic")
    plain = torch.stack([maskproc.optimize_watermark_mask(mk) for mk in raw])
    if not torch.equal(mask, plain):
        raise AssertionError("main-path mask differs from the plain chain "
                             "on the same raw mask")
    raw_iou = iou(raw, torch.from_numpy(logos).to(dev))
    if raw_iou < 0.5:  # the shipped Unet finds 0.66-0.91 of these logos (CPU)
        raise AssertionError(f"raw mask IoU with the drawn logos is "
                             f"{raw_iou:.3f}")
    log("main_path", images=[n, s, s, 3], dtype=cfg.MODEL.DTYPE,
        mask_mode=fused.mask_mode, engine=fused.engine_used,
        weights=Path(pred.weights_path).name, weights_used=pred.n_weights,
        load_s=round(load_s, 3), first_call_s=round(first_call_s, 3),
        launches=launches, raw_mask_fraction=round(raw.mean().item(), 6),
        mask_fraction=round(mask.mean().item(), 6),
        raw_mask_iou_vs_logo=round(raw_iou, 4),
        mask_equals_plain_chain=True, outside_mask_unchanged=True)

    # float32 reference: the bf16 main path's raw mask against float32 on the
    # card, and float32 on the card against the port on the CPU at 64²
    cfg32 = get_cfg_defaults()
    cfg32.MODEL.NAME, cfg32.MODEL.DTYPE = "Unet", "float32"
    cfg32.PREDICT.MASK_MODE = "parity"
    pred32 = WatermarkPredictor(cfg32, device="cuda")
    agree_bf16 = (pred32.predict_masks(images) == raw).float().mean().item()
    if agree_bf16 < 0.99:
        raise AssertionError(f"bf16 and float32 raw masks agree on only "
                             f"{agree_bf16:.4%} of pixels")
    small_np, _ = watermarked_images(2, 64, seed=args.seed + 1)
    small = torch.from_numpy(small_np)
    pred_cpu = WatermarkPredictor(cfg32, device="cpu")
    with torch.inference_mode():
        logits_gpu = pred32.model(
            ((small.to(dev) - pred32._mean) / pred32._std)).cpu()
        logits_cpu = pred_cpu.model((small - pred_cpu._mean) / pred_cpu._std)
    logit_err = (logits_gpu - logits_cpu).abs().max().item()
    if logit_err > 1e-3:  # the tolerance of tests/test_torch_models.py
        raise AssertionError(f"float32 logits on the card differ from the "
                             f"CPU's by {logit_err}")
    raw_cpu = pred_cpu.predict_masks(small)
    mask_gpu = maskproc.optimize_watermark_mask_batch(raw_cpu.to(dev))
    mask_cpu = maskproc.optimize_watermark_mask_batch(raw_cpu)
    if not torch.equal(mask_gpu.cpu(), mask_cpu):
        raise AssertionError("mask chain on the card differs from the CPU's")
    fill_err = (inpaint_pushpull(small.to(dev), mask_gpu[..., None], 32).cpu()
                - inpaint_pushpull(small, mask_cpu[..., None], 32)
                ).abs().max().item()
    if fill_err > 1e-4:
        raise AssertionError(f"push-pull fill on the card differs from the "
                             f"CPU's by {fill_err}")
    log("reference", bf16_vs_fp32_raw_mask_agreement=round(agree_bf16, 6),
        fp32_logits_gpu_vs_cpu_max_abs=logit_err,
        mask_chain_gpu_equals_cpu=True, fill_gpu_vs_cpu_max_abs=fill_err)
    del pred32, pred_cpu

    # -- 3b: the default configuration ---------------------------------------
    cfg_d = get_cfg_defaults()
    got = (cfg_d.MODEL.NAME, cfg_d.MODEL.ENCODER_NAME, cfg_d.MODEL.DTYPE,
           cfg_d.DATA.IMG_SIZE, cfg_d.PREDICT.MASK_MODE)
    if got != ("UnetPlusPlus", "resnet34", "bfloat16", 512, "auto"):
        raise AssertionError(f"the default configuration changed: {got}")
    t0 = time.perf_counter()
    pred_d = WatermarkPredictor(cfg_d)
    fused_d = pred_d.make_fused_repair_fn(inpaint_engine="pushpull",
                                          smooth_iterations=32)
    load_d_s = time.perf_counter() - t0
    # the last 2 images carry no logo; their type is the watermark type, so
    # the artifact surface's watermark strategy (K1 and K2) has images
    images_d_np, logos_d = watermarked_images(n, s, seed=args.seed, clean=2)
    images_d = torch.from_numpy(images_d_np).to(dev)

    # (a) the repair surface
    kc.reset_launch_counts()
    t0 = time.perf_counter()
    repaired_d, mask_d = fused_d(images_d)
    torch.cuda.synchronize()
    first_call_d_s = time.perf_counter() - t0
    repair_launches = {k.__name__: k.launches for k in kc.KERNELS}
    check_repair(images_d, repaired_d, mask_d)
    raw_d = pred_d.predict_masks(images_d)
    if not torch.equal(raw_d, pred_d.predict_masks(images_d)):
        raise AssertionError("UNet++'s mask is not deterministic")
    for i, mk in enumerate(raw_d):
        if not torch.equal(mask_d[i], maskproc.optimize_watermark_mask_tight(mk)):
            raise AssertionError(f"default-config mask of image {i} differs "
                                 f"from the plain tight chain")
    raw_d_iou = iou(raw_d, torch.from_numpy(logos_d).to(dev))
    if raw_d_iou < 0.5:  # UNet++ finds 0.80-0.94 of these logos (CPU, fp32)
        raise AssertionError(f"UNet++ raw mask IoU with the drawn logos is "
                             f"{raw_d_iou:.3f}")
    cfg_d32 = get_cfg_defaults()
    cfg_d32.MODEL.DTYPE = "float32"
    pred_d32 = WatermarkPredictor(cfg_d32)
    agree_d = (pred_d32.predict_masks(images_d) == raw_d).float().mean().item()
    if agree_d < 0.99:
        raise AssertionError(f"UNet++ bf16 and float32 raw masks agree on "
                             f"only {agree_d:.4%} of pixels")
    pred_d_cpu = WatermarkPredictor(cfg_d32, device="cpu")
    with torch.inference_mode():
        logits_gpu = pred_d32.model(
            ((small.to(dev) - pred_d32._mean) / pred_d32._std)).cpu()
        logits_cpu = pred_d_cpu.model(
            (small - pred_d_cpu._mean) / pred_d_cpu._std)
    logit_d_err = (logits_gpu - logits_cpu).abs().max().item()
    if logit_d_err > 1e-3:  # the tolerance of tests/test_torch_models.py
        raise AssertionError(f"float32 UNet++ logits on the card differ from "
                             f"the CPU's by {logit_d_err}")
    del pred_d32, pred_d_cpu
    log("default_repair", images=[n, s, s, 3], arch=cfg_d.MODEL.NAME,
        dtype=cfg_d.MODEL.DTYPE, mask_mode=fused_d.mask_mode,
        engine=fused_d.engine_used, weights=Path(pred_d.weights_path).name,
        weights_used=pred_d.n_weights, load_s=round(load_d_s, 3),
        first_call_s=round(first_call_d_s, 3), launches=repair_launches,
        raw_mask_fraction=round(raw_d.mean().item(), 6),
        mask_fraction=round(mask_d.mean().item(), 6),
        raw_mask_iou_vs_logo=round(raw_d_iou, 4),
        bf16_vs_fp32_raw_mask_agreement=round(agree_d, 6),
        fp32_logits_gpu_vs_cpu_max_abs=logit_d_err,
        mask_equals_plain_tight_chain=True, outside_mask_unchanged=True)

    # (b) the artifact surface, in step 1's order
    art_mode = maskproc.resolve_mask_mode(cfg_d.PREDICT.MASK_MODE, "artifact")
    kc.reset_launch_counts()
    art, types = pred_d.predict_artifact_masks(images_d)
    torch.cuda.synchronize()
    art_launches = {k.__name__: k.launches for k in kc.KERNELS}
    for name, count in art_launches.items():
        if count < 1:
            raise AssertionError(f"the default config's artifact surface "
                                 f"never launched {name} (types {types})")
    fixed_codes = [i % 3 for i in range(n)]
    kc.reset_launch_counts()
    art_fixed = maskproc.optimize_mask_batch_partitioned(raw_d, fixed_codes,
                                                         mode=art_mode)
    torch.cuda.synchronize()
    fixed_launches = {k.__name__: k.launches for k in kc.KERNELS}
    names = {v: k for k, v in maskproc.TYPE_CODES.items()}
    for out, kinds, what in ((art, types, "detected types"),
                             (art_fixed, [names[c] for c in fixed_codes],
                              "codes 0, 1, 2")):
        for i, (mk, kind) in enumerate(zip(raw_d, kinds)):
            if not torch.equal(out[i], maskproc.optimize_mask(mk, kind,
                                                              art_mode)):
                raise AssertionError(f"artifact mask of image {i} ({what}, "
                                     f"{kind}) differs from plain "
                                     f"optimize_mask")
    if min(fixed_launches.values()) < 1:
        raise AssertionError(f"codes 0, 1, 2 launched {fixed_launches}")
    log("default_artifacts", mode=art_mode, types=types,
        launches=art_launches, fixed_codes=fixed_codes,
        fixed_codes_launches=fixed_launches,
        mask_fraction=round(art.mean().item(), 6),
        equals_plain_optimize_mask=True)

    # -- 3c: the learned fill ------------------------------------------------
    os.environ.pop("PREDICT_INPAINT_WEIGHTS", None)
    t0 = time.perf_counter()
    fused_l = pred_d.make_fused_repair_fn()  # the default engine: "lama"
    load_l_s = time.perf_counter() - t0
    if fused_l.engine_used != "ffc-lama":
        raise AssertionError(f"the default fused fn fills with "
                             f"{fused_l.engine_used}, not the FFC-LaMa "
                             f"generator")
    kc.reset_launch_counts()
    t0 = time.perf_counter()
    repaired_l, mask_l = fused_l(images_d)
    torch.cuda.synchronize()
    first_call_l_s = time.perf_counter() - t0
    lama_launches = {k.__name__: k.launches for k in kc.KERNELS}
    check_repair(images_d, repaired_l, mask_l)
    for i, mk in enumerate(raw_d):
        if not torch.equal(mask_l[i],
                           maskproc.optimize_watermark_mask_tight(mk)):
            raise AssertionError(f"LaMa path's mask of image {i} differs from "
                                 f"the plain tight chain")
    lama_path = engines.resolve_inpaint_weights()
    lama_bf16, _ = engines.load_lama(lama_path, "lama", dev, torch.bfloat16)
    lama_32, _ = engines.load_lama(lama_path, "lama", dev, torch.float32)
    hole_l = (mask_l > 0)[..., None].expand_as(images_d)
    with torch.inference_mode():
        diff = (repaired_l
                - lama_32(images_d, mask_l[..., None])).abs()[hole_l]
    bf16_mean, bf16_max = diff.mean().item(), diff.max().item()
    if not bf16_mean <= 2e-2:
        raise AssertionError(f"bf16 and float32 LaMa differ by {bf16_mean} on "
                             f"average over hole pixels")
    small_l_np, logos_l = watermarked_images(2, 128, seed=args.seed + 2)
    small_l = torch.from_numpy(small_l_np)
    holes_l = torch.from_numpy(logos_l)[..., None]
    lama_cpu, _ = engines.load_lama(lama_path, "lama", "cpu", torch.float32)
    with torch.inference_mode():
        lama_gpu_cpu = (lama_32(small_l.to(dev), holes_l.to(dev)).cpu()
                        - lama_cpu(small_l, holes_l)).abs().max().item()
    if lama_gpu_cpu > 1e-3:
        raise AssertionError(f"float32 LaMa on the card differs from the "
                             f"CPU's by {lama_gpu_cpu}")
    clean_d = torch.from_numpy(watermarked_images(n, s, seed=args.seed,
                                                  clean=n)[0]).to(dev)
    hole_d = (mask_d > 0)[..., None].expand_as(images_d)
    log("default_lama", images=[n, s, s, 3], engine=fused_l.engine_used,
        weights=Path(lama_path).name, load_s=round(load_l_s, 3),
        first_call_s=round(first_call_l_s, 3), launches=lama_launches,
        mask_fraction=round(mask_l.mean().item(), 6),
        mask_equals_plain_tight_chain=True, outside_mask_unchanged=True,
        bf16_vs_fp32_hole_mean_abs=bf16_mean,
        bf16_vs_fp32_hole_max_abs=bf16_max,
        fp32_gpu_vs_cpu_128_max_abs=lama_gpu_cpu,
        hole_mae_vs_clean_lama=(repaired_l - clean_d).abs()[hole_l]
        .mean().item(),
        hole_mae_vs_clean_pushpull=(repaired_d - clean_d).abs()[hole_d]
        .mean().item())
    del lama_32, lama_cpu

    # -- 3d: the repair entry point ------------------------------------------
    written = folders.result()
    starter.shutdown()
    try:
        # from here on a weights file is decoded once: the load times inside
        # 3d-3k's walls are warm, as in one long-lived process
        with shipping.keep_loads():
            cli_timing = repair_cli_phase(work, pred_d, args.seed, dev,
                                          written=written["png"])
            # -- 3e: the repair command with OCR on ----------------------
            ocr_timing = repair_cli_ocr_phase(work, args.seed, dev)
            # -- 3f: the repair command on a folder of JPEGs -------------
            jpeg_timing = repair_cli_jpeg_phase(work, args.seed, dev,
                                                written=written["jpeg"])
            # -- 3g: the int8 tier ---------------------------------------
            int8 = int8_tier_phase(
                work, {"Unet": pred, "UnetPlusPlus": pred_d}, fused_l,
                images_d, args.seed, dev)
            # -- 3h: the train command -----------------------------------
            training = training_phase(work, args.seed, dev)
            # -- 3n: the data-parallel path in an NCCL world of one, on
            # 3h's folder while its decoded cache is whole --------------
            sharded_phase(work, args.seed, dev, pred)
            # -- 3i: the fill trainers -----------------------------------
            fill = fill_training_phase(work, args.seed, dev)
            # 3m's text trainer runs in a host worker on the card from here
            # (its first step is ~15 s of host work in cuDNN; its kernels
            # time-slice the card with this process's, which 3j-3l's
            # checks do not time)
            with host_pool(1) as pool:
                text_trained = pool.submit(zoo_text_train, str(work),
                                           args.seed)
                # -- 3j: the auto command --------------------------------
                auto = auto_phase(work, args.seed, dev)
                # -- 3k: the quality record, the calibration, the shells -
                quality = quality_phase(work, dev)
                # -- 3l: .pth in and out, smp UNet++, big-lama, blurred
                # masks
                checkpoints = checkpoint_phase(work, args.seed, dev)
                # -- 3m: the model zoo -----------------------------------
                zoo = zoo_phase(work, args.seed, dev,
                                text_trained.result())
            # -- 3o: every still image the JAX package reads, and zstd
            formats = formats_phase(work, args.seed, dev,
                                    inputs=written["formats"])
            # -- 3p: the library surface ---------------------------------
            surface = library_phase(work, args.seed, dev, pred_d, images_d)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- 4: timings ----------------------------------------------------------
    for _ in range(3):
        fused(images)
    calls = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused(images)
        end.record()
        torch.cuda.synchronize()
        calls.append(start.elapsed_time(end))
    e2e = np.percentile(calls, [50, 90])
    k1_out = kc.morph_chain_watermark(raw)
    cc_out = cc.keep_largest_component(k1_out)
    with torch.inference_mode():
        stages = {
            "network_ms": cuda_ms(lambda: pred.predict_masks(images), 10),
            "k1_ms": cuda_ms(lambda: kc.morph_chain_watermark(raw), 10),
            "components_ms": cuda_ms(
                lambda: cc.keep_largest_component(k1_out), 10),
            "k2_ms": cuda_ms(lambda: kc.gaussian_smooth_threshold(cc_out), 10),
            "mask_stage_ms": cuda_ms(
                lambda: maskproc.optimize_watermark_mask_batch(raw), 10),
            "fill_ms": cuda_ms(
                lambda: inpaint_pushpull(images, mask[..., None], 32), 10)}
    log("timing_main_path", batch=n, size=s, dtype=cfg.MODEL.DTYPE,
        calls=len(calls), e2e_median_ms=e2e[0], e2e_p90_ms=e2e[1],
        e2e_min_ms=min(calls), e2e_max_ms=max(calls),
        img_per_s=n / (e2e[0] / 1e3), **stages, card=card)

    for _ in range(3):
        fused_d(images_d)
    calls_d = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_d(images_d)
        end.record()
        torch.cuda.synchronize()
        calls_d.append(start.elapsed_time(end))
    e2e_d = np.percentile(calls_d, [50, 90])
    rgb_d = torch.round(images_d * 255.0)
    codes_d = [maskproc.type_code(t) for t in types]

    def tight_loop():
        return torch.stack([maskproc.optimize_watermark_mask_tight(mk)
                            for mk in raw_d])

    with torch.inference_mode():
        # the batched tight chain and the per-image loop it replaced, in
        # turns: batched, loop, loop, batched
        tight = [cuda_ms(fn, 10) for fn in (
            lambda: maskproc.optimize_watermark_mask_tight(raw_d), tight_loop,
            tight_loop, lambda: maskproc.optimize_watermark_mask_tight(raw_d))]
        stages_d = {
            "network_ms": cuda_ms(lambda: pred_d.predict_masks(images_d), 10),
            "tight_chain_ms": (tight[0] + tight[3]) / 2,
            "tight_chain_per_image_loop_ms": (tight[1] + tight[2]) / 2,
            "fill_ms": cuda_ms(
                lambda: inpaint_pushpull(images_d, mask_d[..., None], 32), 10),
            "type_detection_ms": cuda_ms(
                lambda: maskproc.detect_watermark_type_scores(rgb_d, raw_d),
                10),
            "artifact_stage_ms": cuda_ms(
                lambda: maskproc.optimize_mask_batch_partitioned(
                    raw_d, codes_d, mode=art_mode), 10),
            "artifact_stage_codes_012_ms": cuda_ms(
                lambda: maskproc.optimize_mask_batch_partitioned(
                    raw_d, fixed_codes, mode=art_mode), 10),
            "artifact_surface_ms": cuda_ms(
                lambda: pred_d.predict_artifact_masks(images_d), 10)}
    log("timing_default_config", batch=n, size=s, arch=cfg_d.MODEL.NAME,
        dtype=cfg_d.MODEL.DTYPE, calls=len(calls_d),
        e2e_median_ms=e2e_d[0], e2e_p90_ms=e2e_d[1],
        e2e_min_ms=min(calls_d), e2e_max_ms=max(calls_d),
        img_per_s=n / (e2e_d[0] / 1e3), types=types,
        tight_rounds_ms=tight, **stages_d, card=card)

    for _ in range(3):
        fused_l(images_d)
    calls_l = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_l(images_d)
        end.record()
        torch.cuda.synchronize()
        calls_l.append(start.elapsed_time(end))
    e2e_l = np.percentile(calls_l, [50, 90])
    holes_d = mask_l[..., None]
    with torch.inference_mode():
        lama_ms = cuda_ms(lambda: lama_bf16(images_d, holes_d), 10)
    seg_flops = conv_flops(lama_bf16, images_d, holes_d)
    lama_flops = sum(seg_flops.values())
    seg_ms = segment_ms(lama_bf16, (images_d, holes_d), 5)
    log("timing_default_lama", batch=n, size=s, arch=cfg_d.MODEL.NAME,
        engine=fused_l.engine_used, calls=len(calls_l),
        e2e_median_ms=e2e_l[0], e2e_p90_ms=e2e_l[1],
        e2e_min_ms=min(calls_l), e2e_max_ms=max(calls_l),
        img_per_s=n / (e2e_l[0] / 1e3), network_ms=stages_d["network_ms"],
        tight_chain_ms=stages_d["tight_chain_ms"], lama_ms=lama_ms,
        lama_conv_gflop=lama_flops / 1e9,
        lama_bound_ms=lama_flops / PEAK_BF16_FLOPS_PER_S * 1e3,
        lama_mfu=lama_flops / (lama_ms * 1e-3 * PEAK_BF16_FLOPS_PER_S),
        lama_segments=[{
            "segment": seg, "ms": seg_ms[seg],
            "conv_gflop": seg_flops[seg] / 1e9,
            "conv_share_of_peak": seg_flops[seg] / (
                seg_ms[seg] * 1e-3 * PEAK_BF16_FLOPS_PER_S)}
            for seg, _ in LAMA_SEGMENTS],
        card=card)

    # the repair entry point beside the fused fn it wraps, on this run
    log("timing_repair_cli", **cli_timing,
        fused_lama_img_per_s=n / (e2e_l[0] / 1e3),
        fused_lama_batch=[n, s, s, 3], card=card)
    log("timing_repair_cli_ocr", **ocr_timing, card=card)
    log("timing_int8_tier", **int8["timing"], card=card)
    log("timing_train", **training["timing"], card=card)
    log("timing_fill_training", **fill["timing"], card=card)
    log("timing_auto", **auto["timing"], card=card)
    log("timing_quality", **quality["timing"], card=card)
    log("timing_checkpoints", **checkpoints["timing"], card=card)
    log("timing_zoo", **zoo["timing"], card=card)
    log("timing_formats", **formats["timing"], card=card)
    log("timing_library", **surface["timing"], card=card)
    log("timing_repair_cli_jpeg", **jpeg_timing,
        paeth_1080x1920_decode_ms=cli_timing["paeth_1080x1920_decode_ms"],
        sub_1080x1920_decode_ms=cli_timing["sub_1080x1920_decode_ms"],
        card=card)

    # one call a window: the profiler's processing of a window's events,
    # not its calls, takes the seconds
    log("profile", **profile_window(lambda: fused(images), 1))
    log("profile_default_repair", **profile_window(lambda: fused_d(images_d), 1))
    log("profile_default_artifacts",
        **profile_window(lambda: pred_d.predict_artifact_masks(images_d), 1))
    log("profile_default_lama", **profile_window(lambda: fused_l(images_d), 1))
    with torch.inference_mode():
        log("profile_lama_generator",
            **profile_window(lambda: lama_bf16(images_d, holes_d), 1))

    # each kernel on the inputs the main path gave it
    k1_in, k2_in = raw, cc_out
    px = k1_in.numel()
    kernels = []
    for fn, plain, library, x, ops, line in (
            (kc.morph_chain_watermark, kc.morph_chain_plain, None, k1_in,
             K1_WORD_OPS * px, 158),
            # K2's output is x > 0.5 for every float x (smooth_threshold_plain)
            (kc.gaussian_smooth_threshold, kc.smooth_threshold_plain,
             lambda x: (x > 0.5).float(), k2_in, K2_FLOPS * px, 167)):
        # per call, back to back: the median of 5 rounds of 50 calls, in
        # turns with the library call where there is one
        timed = {"ms": lambda: fn(x)}
        if library is not None:
            timed["library_ms"] = lambda: library(x)
        rounds = {key: [] for key in timed}
        for r in range(5):
            for key in (list(timed) if r % 2 == 0 else list(timed)[::-1]):
                rounds[key].append(cuda_ms(timed[key], 50))
        ms = float(np.median(rounds["ms"]))
        library_ms = (float(np.median(rounds["library_ms"]))
                      if library is not None else None)
        device_ms = profiled_ms(lambda: fn(x), DEVICE_NAMES[fn.__name__], 50)
        call_host_ms = host_ms(lambda: fn(x), 50)
        plain_ms = cuda_ms(lambda: plain(x), 10)
        log("kernel_timing", name=fn.__name__, rounds_ms=rounds)
        err = (fn(x) - plain(x)).abs().max().item()
        bytes_ms = 2 * x.numel() * 4 / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_SINGLE_OPS_PER_S * 1e3
        kernels.append({
            "name": fn.__name__, "route": "cuda",
            "source": f"{PORT}/csrc/morph_chain.cu",
            "replaces": f"unet_watermark_tpu/ops/pallas/morph_chain.py:{line}",
            "launches": launches[fn.__name__],
            "default_config_launches": art_launches[fn.__name__],
            "repair_cli_launches": cli_timing["launches"][fn.__name__],
            "repair_cli_ocr_launches": ocr_timing["launches"][fn.__name__],
            "repair_cli_jpeg_launches": jpeg_timing["launches"][fn.__name__],
            "trained_weights_launches": training["launches"][fn.__name__],
            "trained_lama_launches":
                fill["launches"]["trained_lama"][fn.__name__],
            "diffusion_repair_launches":
                fill["launches"]["diffusion"][fn.__name__],
            "auto_launches": auto["launches"][fn.__name__],
            "quality_report_launches": quality["launches"][fn.__name__],
            "pth_repair_launches": checkpoints["launches"][fn.__name__],
            **({"blurred_mask_launches": checkpoints["blurred_k1_launches"]}
               if fn is kc.morph_chain_watermark else {}),
            "zoo_launches": zoo["launches"][fn.__name__],
            "formats_launches": formats["launches"][fn.__name__],
            "library_launches": surface["launches"][fn.__name__],
            "library_predictor_launches":
                surface["predictor_launches"][fn.__name__],
            "max_abs_err": err,
            "ms": ms, "device_ms": device_ms, "host_ms": call_host_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms})
        if err != 0.0:
            raise AssertionError(f"{fn.__name__} differs from its plain "
                                 f"version by {err}")
    for k in int8["kernels"]:
        k["quality_report_launches"] = quality["launches"][k["name"]]
        k["zoo_launches"] = zoo["int8_launches"][k["name"]]
    kernels.extend(int8["kernels"])
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
