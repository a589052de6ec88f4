"""Phases 3h-3n of chip_smoke.py, and the helpers they share with it: the
timers (CUDA events, host clock, torch.profiler), the log line, the
in-process CLI call, the LaMa segment accounting and the int8 checks.
chip_smoke.py imports this module; it needs the card, as chip_smoke.py
does.

  3h the `train` command at full width (the yaml: UNet++/resnet34, 512²,
     batch 8, bf16, Adam, the transparent_watermark policy) on 40 files
     it writes (masks for 20, the rest from the clean diff): 3 epochs
     with a checkpoint each (rc 0, finite history, every checkpoint and
     best_model), --resume from epoch 2 to 3; the exported .npz in
     WatermarkPredictor's default fused fn (K1 and K2 launched, masks
     equal to the best checkpoint's weights held in memory); one float32
     step (Unet, 64², batch 4, no augmentation) on the card against the
     CPU from the same state; on one resident batch after 3 full-width
     steps of warmup: one step under torch's sync debug mode (no
     synchronizing call), 10 steps timed as one window (img/s, the loss
     falling), 10 synced steps timed by stage (augment,
     forward+backward, optimizer); a profile of 1 step
  3i the fill trainers at full width on a folder of 16 clean 512² PNGs
     (utils/synthetic): (a) train_inpaint, FFC-LaMa ('lama': 9 FFC
     blocks, 512 channels at /8) against the PatchGAN, 256², batch 8,
     GAN on after 4 warmup steps, 8 steps, a log every 4 (finite g_loss,
     d_loss, hole_psnr); the directory and its .npz through
     get_engine("lama") ("ffc-lama"); `repair --no-ocr --inpaint-weights
     <dir>` on 4 of 3d's files, 2 of them without a logo (rc 0, engine
     "ffc-lama", K1 and K2 launched, pixels outside the step-1 masks the
     input's);
     --resume-from <dir>.npz; one float32 G + D step (2 x 64²) on the
     card against the CPU; on the resident corpus one GAN step under
     torch's sync debug mode (no synchronizing call), 5 steps timed as
     one window (ms a step, img/s, peak MiB, inpaint_train_mfu: the
     convs' operations from their shapes, 3 generator and 7
     discriminator forwards a step, over the window at the bf16 peak), 5
     synced steps split (generator forward+backward, discriminator step,
     both optimizers), a profile of 2 steps. (b) train_latent_diffusion,
     256², batch 16, 8 autoencoder and 8 denoiser steps, shipped to a
     temporary .npz; `repair --no-ocr --watermark-model diffusion` with
     DIFFUSION_WEIGHTS there (rc 0, engine "latent-diffusion": a
     push-pull fallback fails, K1 and K2 launched, pixels outside the
     step-1 masks the input's); the float32 sampler on the card against
     the CPU (1 x 64², 4 steps, the same noise); the engine's 20-step
     fill of 8 x 512² timed with these weights, and its kernel launches
  3j the `auto` command as users type it (`cli.main(["auto", ...])`, one
     cycle, the default configuration with the yaml at full width:
     UNet++/resnet34, 512², batch 8, bf16, 1 epoch) reusing the earlier
     phases: 3h's folder as the training folder and the held-out triads
     (4), 3h's 4 checkpoints in the loop's checkpoint folder, 2 of 3d's
     files as the test folder, 3i's clean folder and 3 RGBA logos for
     step 5. Checks: rc 0 and status "success"; step 1 one vmapped forward
     over the 4 checkpoints, and the vmapped probabilities within twice
     the bf16 forward's own error (each checkpoint's bf16 forward against
     its float32 one, max over pixels) of each checkpoint's own bf16
     forward, their masks agreeing on >= AUTO_VMAP_AGREE; step 5's files
     on the card equal byte for byte to the same generation on the host
     (in a thread beside those card checks: its samples/s is read under
     that load);
     the video's MP4 boxes parsed, 2 x 15 samples and 2 sync samples;
     the held-out evaluation over 4 triads; K1 and K2 launched by the
     cycle. Logs each step's seconds,
     gen_data samples/s on the card and on the host, and video frames/s
  3k the quality record (scripts/quality_report.py) as users run it:
     `quality_report.main(["--workdir", W, "--limit", "4", "--tiers",
     "smooth", "textured"])` on the card at full width (UNet++ and Unet
     with resnet34 at 512², batch 8, the bf16 and the int8 tier with the
     shipped sidecars, LaMa and the latent-diffusion engine; the depth is
     cut from 64 to 4 triads a tier). Checks: 4 segmentation rows a tier,
     the int8 ones too; every number finite; engine "ffc-lama" for LaMa
     in both mask modes; the LaMa repair above the no-op floor on the
     smooth tier in both mask modes; on the textured tier at 512², where
     no JAX reading exists (on its first 6-8 triads both modes land below
     the floor on the H100), the tight LaMa repair above the parity one;
     K1 and K2 launched >= 2 times and uwt_conv_s8 (and
     uwt_quantize_s8) 68 times an int8 UNet++ batch plus 50 an int8 Unet
     batch; the smooth tier's frozen files (16 clean JPEGs, 12 logos, the
     first 2 triads) equal byte for byte to their generation on the host.
     The textured witness: the frozen textured set at 128² (4 triads)
     made on the card and on the host, byte-equal, and equal to its
     known digest (TEX_SET_SHA256: the set does not depend on the
     machine, ROADMAP.md §C.12), and its tight e2e
     repair (segmentation in float32) on each, within TEX_DB_TOL dB, the
     LaMa repair above the no-op floor there, as JAX's and the port's on
     the CPU (tests/test_torch_quality_e2e_tex.py). Then
     calibrate_quant.calibrate("Unet", 8 images, batch 4) on the card
     into the work directory: the sidecar's keys equal the shipped one's,
     every amax finite and > 0, weights_sha256 the weights' hash, and an
     int8 Unet forward under it (50 uwt_conv_s8 launches) on the first 8
     smooth held-out triads agreeing with the shipped sidecar's masks on
     >= CALIB_AGREE of pixels and with an IoU >= CALIB_IOU, which the
     masks under every shipped amax x CALIB_BROKEN must fail. Then the
     shells on 2 of 3d's files, one without a logo:
     SDWatermarkRemover.remove_watermark_auto
     and FluxProcessor.process_batch(mode="text"), the rung each ran
     logged: with the shipped latent_diffusion.npz the native
     latent-diffusion rung, never push-pull, and pixels outside each mask
     unchanged. Logs the report's wall and per-section seconds, the frozen
     set's images/s and the calibration's seconds.
  3l the reference's checkpoint formats and the blurred training masks
     (checkpoint_phase): (a) the shipped UNet++ written by export_pth and
     `repair --no-ocr --model <it>.pth` on 4 of 3d's files, every PNG equal
     byte for byte to the .npz run's, K1 and K2 launched; (b) a seeded
     smp-layout UNet++/resnet34 at full width saved as a bare state_dict,
     detected as "smp" by WatermarkPredictor, its default fused fn on
     BATCH x SIZE² timed in turns with the canonical decoder's, its
     float32 logits on the card against the CPU's (1 x 256²); (c) a seeded
     18-block big-lama saved as a saicinpainting best.ckpt (~195 MiB:
     generator.model.* and a discriminator tensor), loaded through
     PREDICT.INPAINT_WEIGHTS (engine "ffc-big-lama-torch"), the fused fn
     and the generator timed in turns with FFC-LaMa's, its convs' share of
     the fp32 peak, the share of hole pixels its seeded output leaves
     unsaturated, the card against the CPU (1 x 128², in a host worker
     while the card works); (d) WatermarkDataset(use_blurred_mask=True,
     mode="val") over 8 of 3h's pairs on the card and on the CPU (a host
     worker), byte-equal, K1 launched each item, samples/s; `train
     --use-blurred-mask` at full width for one epoch of 2 steps (20 pairs,
     masks made blurred); apply_params with each gather warp
     (nearest_gather, bilinear) on BATCH x SIZE² on the card against the
     CPU.
  3m the model zoo (zoo_phase; the zoo's models have no trained files in
     the repository, so all but the shipped Unet and UNet++ are seeded
     stand-ins: structure and speed, not quality): (a) the text trainer's
     CLI (text/train_text_watermark.main) on the card, in a host worker
     during 3j-3l, with the shipped text config (UNet++ on
     efficientnet-b3, 512², batch 6, bf16, CombinedLoss, AdamW, the
     text_watermark policy; its output paths
     moved) generating TEXT_SAMPLES on TEXT_CLEAN clean images and training
     one epoch of 2 steps; `repair -c unet_text_watermark.yaml --model
     <its .pth> --no-ocr` (MULTI_SCALE_TEST, EDGE_REFINEMENT as shipped) on
     TEXT_CLI_FILES of 3d's folder: rc 0, "success", K1 and K2 launched,
     every mask at its image's size, pixels outside the step-1 masks the
     input's; the same command in float32 with push-pull on
     TEXT_CPU_FILES, its step-1 mask equal byte for byte to the CPU's (a
     host worker). (b) The large config
     (UNet++/resnet50, decoder (1024, ..., 64), REMAT) seeded on the
     card, served from a shipped-format .npz at LARGE_BATCH x
     LARGE_SIZE² in bf16: the fused fn's mask equal to the plain tight
     chain, with MASK_MODE parity equal to the plain chain with K1 and K2
     launched; network_ms and the peak memory; its float32 logits card
     against CPU at ZOO_CHECK_SIZE²; its resnet50 encoder in int8 (every
     1x1 conv, stride 1 and 2, Cin to 2048) with every uwt_conv_s8 and
     uwt_quantize_s8 launch held bit for bit against the plain versions.
     (c) UnetTPU, MAnet, Linknet, FPN, PSPNet, PAN, DeepLabV3 and
     DeepLabV3Plus with resnet34, seeded, bf16, at BATCH x SIZE²:
     network_ms in turns with the shipped Unet's and UNet++'s; each
     one's float32 logits card against CPU within ZOO_LOGIT_RTOL. (d)
     UnetTPU calibrated by calibrate_quant on 3k's calibration set, its
     fused fn under PREDICT.QUANT with every launch held against the
     plain versions (45 convs), the mask equal to the plain tight chain,
     the network in turns with bf16, and the conv shapes new to
     uwt_conv_s8 (resnet50's 1x1 convs, UnetTPU's stride-2 skip2_reduce)
     timed one by one beside cuDNN's bf16 conv and their bounds.
  3n the data-parallel path (sharded_phase) in an NCCL world of one formed
     in this process through parallel.distributed.initialize with a
     file:// store in the work folder, destroyed afterwards (this script
     needs one card; the arithmetic of several ranks is
     tests/test_torch_parallel.py's and test_torch_dp_train.py's, gloo on
     the CPU): 2 train steps of 3h's config (UNet++/resnet34, 512², batch
     8, Adam, transparent_watermark) on 3h's folder inside the group (the
     state broadcast, the gradients all-reduced, BatchNorm's statistics
     from all-reduced sums as a group of several ranks takes them) against
     the same 2 steps from the same state without a group, in float32 (the
     losses, step 1's gradients and running statistics and the parameters
     within the SHARD32_* bounds) and in bf16 (the losses and step 1's
     running statistics within the SHARD_* bounds, the gradients and
     parameters reported, with both steps' seconds); the
     `train` command for one epoch in the group on the host pipeline
     (rc 0, a finite history, rank 0's checkpoint, .npz and .pth);
     predict_tiled_sharded against
     predict_tiled on a 1080 x 1920 image with the shipped Unet in bf16
     (15 tiles of 512, overlap 64; the image is 12 of the training
     batches' images in a 3 x 4 grid, cropped), bit for bit; sharded_conv2d (3x3,
     halos zero at the border) against the unsharded conv. Logs the NCCL
     version and the phase's seconds.
  3o lives in tools/smoke_formats.py (formats_phase), which lists its
     checks.
"""
from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BATCH, SIZE = 8, 512  # the main path's shape: 8 images of 512²
# dense bf16 tensor-core peak (the data sheet's 989.4 TFLOP/s, an FMA
# counted as two operations): the yardstick of the LaMa generator's convs
PEAK_BF16_FLOPS_PER_S = 989.4e12
# dense int8 tensor-core peak (data sheet: 1979 TOP/s, a multiply-add
# counted as two operations) and HBM bytes/s (H100 SXM)
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def host_pool(workers: int = 6):
    """Worker processes for host checks that take seconds a file (spawned,
    never forked from a process that holds the card), all joined on exit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    n = max(1, min(workers, (os.cpu_count() or 2) - 2))
    with ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool


_T0 = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line; t_s is the seconds since this module was imported."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - _T0, 2)}),
          flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host time of one fn() call: the time to enqueue `iters` calls,
    without waiting for the device (the launch queue does not fill)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def profiled_ms(fn, kernel: str, iters: int, per_call: int = 1) -> float:
    """Mean device time of one fn() call's `per_call` launches of the kernel
    named `kernel` over `iters` calls, from torch.profiler's rows of that
    __global__ function (over the launches the profiler recorded). A window
    in which the profiler recorded fewer than half of the launches is
    measured again, up to 3 windows: on a busy host it has dropped most of
    a window's kernel records (17 of 50 in one run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        launches = sum(e.count for e in rows)
        if iters * per_call // 2 <= launches <= iters * per_call:
            return (sum(e.self_device_time_total for e in rows) / 1e3
                    / launches * per_call)
        counts.append(launches)
    raise AssertionError(f"the profiler saw {counts} launches of {kernel} "
                         f"in 3 windows of {iters} calls")


def profile_window(fn, calls: int) -> dict:
    """Device busy share and time by kernel over `calls` calls of fn();
    the profiler's overhead makes this window slower than an unprofiled
    one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an operator's row repeats its kernels' time
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    device_ms = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    return {"calls": calls, "window_ms": window_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / window_ms if device_ms else None,
            "kernel_launches": sum(r[1] for r in rows),
            "top": [{"name": k[:90], "count": c, "ms": round(ms, 4)}
                    for k, c, ms in rows[:15]]}


# the LaMa generator's segments, each named by the module that starts it
# (None: the call's start); a segment ends where the next one starts
LAMA_SEGMENTS = (("input", None), ("stem_down", "stem"),
                 ("ffc_blocks", "blocks.0"), ("up", "up0"),
                 ("head_composite", "head"))


def lama_segment(name: str) -> str:
    """The segment of LAMA_SEGMENTS that the generator's module `name` is in."""
    for prefix, seg in (("stem", "stem_down"), ("down", "stem_down"),
                        ("blocks", "ffc_blocks"), ("up", "up"),
                        ("head", "head_composite")):
        if name.startswith(prefix):
            return seg
    raise KeyError(name)


def conv_flops(model, *inputs, segment=lama_segment) -> dict:
    """Operations (an FMA counts two) of the convolutions of one model(*inputs)
    call by segment (segment(module name); LaMa's by default), from the
    shapes each conv sees; the FFTs and elementwise ops are not counted."""
    import collections

    import torch

    flops = collections.defaultdict(float)

    def count(name):
        def hook(mod, args, out):
            # weight[0] is (cin / groups, kh, kw) of a Conv2d, which every
            # output element takes once, and (cout, kh, kw) of a
            # ConvTranspose2d, which every input element is spread by
            transposed = isinstance(mod, torch.nn.ConvTranspose2d)
            pixels = args[0] if transposed else out
            flops[segment(name)] += 2.0 * pixels.numel() * \
                mod.weight[0].numel()
        return hook

    hooks = [m.register_forward_hook(count(name))
             for name, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return flops


def segment_ms(model, inputs, iters: int) -> dict:
    """Device ms of each LaMa segment of one model(*inputs) call, by CUDA
    events recorded at the call's ends and in the forward pre-hook of each
    segment's first module; the mean over `iters` calls after one warm-up."""
    import torch

    modules = dict(model.named_modules())
    events = []

    def mark(*_):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    hooks = [modules[first].register_forward_pre_hook(mark)
             for _, first in LAMA_SEGMENTS if first]
    totals = [0.0] * len(LAMA_SEGMENTS)
    try:
        with torch.inference_mode():
            for i in range(iters + 1):
                events.clear()
                mark()
                model(*inputs)
                mark()
                torch.cuda.synchronize()
                if i == 0:  # warm-up
                    continue
                for j in range(len(totals)):
                    totals[j] += events[j].elapsed_time(events[j + 1])
    finally:
        for h in hooks:
            h.remove()
    return {seg: t / iters for (seg, _), t in zip(LAMA_SEGMENTS, totals)}


def run_cli(argv, dev, timer: bool, parts: dict = None):
    """cli.main(argv) in this process; (rc, wall seconds, the stage seconds
    of the pipeline's StageTimer, or None without a timer). With a timer,
    `parts` (where given) receives the timer's parts (a JPEG decode's
    entropy and pixel seconds)."""
    from unet_watermark_tpu_torch import cli
    from unet_watermark_tpu_torch.inference import predict as P

    P.STAGE_TIMER = P.StageTimer(dev) if timer else None
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        if timer and parts is not None:
            parts.update(P.STAGE_TIMER.parts)
        return rc, wall, (dict(P.STAGE_TIMER.seconds) if timer else None)
    finally:
        P.STAGE_TIMER = None


# phase 3h: the train command's folder (40 files of SIZE², masks for the
# first 20; 32 train and 8 val at TRAIN_RATIO 0.8, 4 steps an epoch at the
# yaml's batch 8), its epochs, and the full-width step's warmup and timed
# steps (cut from 5 and 20 to 3 and 10 to make room for phase 3i)
TRAIN_FILES, TRAIN_MASKS, TRAIN_EPOCHS = 40, 20, 3
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# the card-against-CPU step: Unet at 64², batch 4, float32, no augmentation
# (the tolerances of tests/test_torch_train.py)
STEP_SIZE, STEP_BATCH = 64, 4
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_STATS_TOL = 1e-4, 1e-4, 1e-4


def training_phase(work: Path, seed: int, dev) -> dict:
    """Phase 3h: the `train` command on the card at full width (the yaml:
    UNet++/resnet34, 512², batch 8, bf16, Adam, DiceLoss, the
    transparent_watermark policy, the card-resident pipeline), 3 epochs
    with a checkpoint each, then --resume from epoch 2; the exported .npz
    served by WatermarkPredictor's default fused fn (masks equal to those
    of the best checkpoint's weights held in memory, K1 and K2 launched);
    one float32 step on the card against the CPU from the same state; the
    full-width step checked for host syncs, timed as a window and by
    stage. Returns the timing fields and the serving run's launches."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.configs import (DEFAULT_CONFIG,
                                                  get_cfg_defaults,
                                                  update_config)
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.models.convert import load_flax_weights
    from unet_watermark_tpu_torch.ops import augment as aug
    from unet_watermark_tpu_torch.ops import losses
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.training import checkpoint as ck
    from unet_watermark_tpu_torch.training import train as tr
    from unet_watermark_tpu_torch.utils.synthetic import (
        watermarked_images, write_training_folder)

    t_phase = time.perf_counter()
    root, out = work / "train_data", work / "train_out"
    write_training_folder(root, TRAIN_FILES, SIZE, seed, masks=TRAIN_MASKS)
    ckpt = out / "checkpoints"
    argv = ["train", "-c", str(DEFAULT_CONFIG), "--data-dir", str(root),
            "--epochs", str(TRAIN_EPOCHS), "--output-dir", str(out / "logs"),
            "--model-save-path", str(out / "models" / "unet_watermark.pth"),
            "--opts", "TRAIN.SAVE_INTERVAL", "1",
            "TRAIN.CHECKPOINT_DIR", str(ckpt), "DATA.IMG_SIZE", str(SIZE)]
    torch.cuda.reset_peak_memory_stats()
    rc, wall, _ = run_cli(argv, dev, timer=False)
    history = json.loads((out / "logs" / "training_history.json").read_text())
    if rc != 0 or len(history["train_loss"]) != TRAIN_EPOCHS or not all(
            np.isfinite(history[k]).all() for k in ("train_loss",
                                                    "val_loss")):
        raise AssertionError(f"train: rc {rc}, history {history}")
    made = sorted(os.listdir(ckpt))
    want = ["best_model"] + [f"checkpoint_epoch_{e + 1}"
                             for e in range(TRAIN_EPOCHS)]
    if made != want:
        raise AssertionError(f"train wrote {made}, not {want}")
    generated = len(os.listdir(root / "masks"))
    if generated != TRAIN_FILES:  # 20 given, 20 cached by the clean diff
        raise AssertionError(f"{generated} mask files after training")
    log("train_cli", argv=argv[:1] + argv[5:7], rc=rc, wall_s=wall,
        epochs=len(history["train_loss"]), history=history,
        checkpoints=made, masks_after=generated,
        peak_allocated_mib=torch.cuda.max_memory_allocated() / 2 ** 20)

    resume = argv + ["--resume", str(ckpt / "checkpoint_epoch_2")]
    rc_r, wall_r, _ = run_cli(resume, dev, timer=False)
    resumed = json.loads((out / "logs" / "training_history.json").read_text())
    if rc_r != 0 or len(resumed["train_loss"]) != TRAIN_EPOCHS or \
            resumed["train_loss"][:2] != history["train_loss"][:2]:
        raise AssertionError(f"resume: rc {rc_r}, history {resumed}")
    log("train_cli_resume", rc=rc_r, wall_s=wall_r,
        epochs=len(resumed["train_loss"]),
        epoch3_train_loss=[history["train_loss"][2],
                           resumed["train_loss"][2]])

    # back to serving: the exported .npz in the predictor's default fused fn
    # (MASK_MODE auto: the tight chain) and in parity mode (the cv2 chain on
    # K1 and K2); each fn again with the best checkpoint's fp32 weights
    # held in memory, cast to the model dtype: the same masks
    npz = out / "models" / "seg_unetplusplus_resnet34.npz"
    tree, _ = ck.restore_raw(str(ckpt / "best_model"))
    held = {k: v for k, v in tree.items()
            if k.startswith(("params/", "batch_stats/"))}
    images_np, _ = watermarked_images(BATCH, SIZE, seed=seed + 7, clean=2)
    images = torch.from_numpy(images_np).to(dev)
    serving = {}
    for mode, engine in (("auto", "lama"), ("parity", "pushpull")):
        cfg = get_cfg_defaults()
        cfg.DATA.IMG_SIZE = SIZE
        cfg.PREDICT.MASK_MODE = mode
        pred = WatermarkPredictor(cfg, weights_path=str(npz), device=dev)
        fused = pred.make_fused_repair_fn(inpaint_engine=engine)
        kc.reset_launch_counts()
        _, mask = fused(images)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kc.KERNELS}
        model = pred.model
        load_flax_weights(model, held)  # fp32 in memory, then the dtype
        pred.model = model.to(dev, pred.dtype).eval().to(
            memory_format=torch.channels_last)
        _, mask_held = fused(images)
        if not torch.equal(mask, mask_held):
            raise AssertionError(f"{mode}: the exported .npz's masks differ "
                                 f"from the best checkpoint's weights held "
                                 f"in memory")
        serving[mode] = {"engine": fused.engine_used, "launches": launches,
                         "mask_fraction": mask.mean().item()}
        del pred, fused, model
    serve_launches = serving["parity"]["launches"]
    if min(serve_launches.values()) < 1 or \
            serving["auto"]["engine"] != "ffc-lama":
        raise AssertionError(f"the trained weights' fused fns: {serving}")
    log("train_serving", weights=npz.name, **serving,
        masks_equal_held_weights=True)

    # one float32 step on the card and on the CPU from the same state
    cfg_s = get_cfg_defaults()
    cfg_s.MODEL.NAME, cfg_s.MODEL.DTYPE = "Unet", "float32"
    cfg_s.DATA.IMG_SIZE = STEP_SIZE
    off = aug.AugmentPolicy(hflip_p=0, vflip_p=0, rot90_p=0, affine_p=0,
                            bc_p=0, hsv_p=0)
    small, logos = watermarked_images(STEP_BATCH, STEP_SIZE, seed=seed + 3)
    host = {"image": torch.from_numpy(np.rint(small * 255).astype(np.uint8)),
            "mask": torch.from_numpy(logos.astype(np.uint8))[..., None],
            "valid": torch.ones(STEP_BATCH)}
    got = []
    for where in (dev, torch.device("cpu")):
        state = tr.create_train_state(cfg_s, seed, where)
        grads = {}

        def part(name, state=state, grads=grads):
            if name == "optimizer":
                grads.update({n: p.grad.detach().clone().cpu() for n, p in
                              state.model.named_parameters()})
            return contextlib.nullcontext()

        step = tr.make_train_step(cfg_s, losses.get_loss_function(cfg_s),
                                  off, torch.Generator(where))
        m = step(state, {k: v.to(where) for k, v in host.items()}, part)
        got.append((float(m["loss"]), grads,
                      {k: v.detach().cpu() for k, v in
                       state.model.state_dict().items()}))
    (lg, gg, sg), (lc, gc, sc) = got
    grad_err = max((gg[k] - gc[k]).abs().max().item() for k in gg)
    stats_err = max((sg[k].float() - sc[k].float()).abs().max().item()
                    for k in sg if "running" in k)
    lr = cfg_s.TRAIN.LR  # Adam's first step: ±lr where a gradient's sign
    moved = max((sg[k] - sc[k]).abs().max().item() for k in sg
                if k in gg)
    if abs(lg - lc) > STEP_LOSS_TOL or grad_err > STEP_GRAD_TOL or \
            stats_err > STEP_STATS_TOL or moved > 2 * lr + 1e-5:
        raise AssertionError(f"float32 step card vs CPU: loss {lg} vs {lc}, "
                             f"grads {grad_err}, stats {stats_err}, params "
                             f"{moved}")
    log("train_step_card_vs_cpu", size=STEP_SIZE, batch=STEP_BATCH,
        loss_card=lg, loss_cpu=lc, grad_max_abs=grad_err,
        batch_stats_max_abs=stats_err, params_max_abs=moved)

    # the full-width step, timed by stage on one resident batch
    cfg_f = get_cfg_defaults()
    update_config(cfg_f, DEFAULT_CONFIG)
    cfg_f.DATA.IMG_SIZE = SIZE
    state = tr.create_train_state(cfg_f, seed, dev)
    step = tr.make_train_step(cfg_f, losses.get_loss_function(cfg_f),
                              cfg_f.DATA.AUGMENTATION_TYPE,
                              torch.Generator(dev).manual_seed(seed))
    big, logos = watermarked_images(cfg_f.TRAIN.BATCH_SIZE, SIZE, seed=seed)
    batch = {"image": torch.from_numpy(np.rint(big * 255).astype(np.uint8)
                                       ).to(dev),
             "mask": torch.from_numpy(logos.astype(np.uint8))[..., None]
             .to(dev),
             "valid": torch.ones(cfg_f.TRAIN.BATCH_SIZE, device=dev)}
    events = []

    @contextlib.contextmanager
    def timed(name):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        events.append((name, a, b))

    for _ in range(TRAIN_WARMUP):
        step(state, batch)
    torch.cuda.synchronize()
    # no stage of a step makes the host wait for the card: one step under
    # torch's sync debug mode, which warns at every synchronizing call
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "synchroniz" in str(w.message)]
    if syncs:
        raise AssertionError(f"a train step synchronizes: {syncs}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the rate: TRAIN_STEPS steps as one window, one sync at its end, so
    # the host queues ahead of the card as in an epoch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    seen = [step(state, batch)["loss"] for _ in range(TRAIN_STEPS)]
    b.record()
    torch.cuda.synchronize()
    window_ms = a.elapsed_time(b)
    losses_seen = torch.stack(seen).tolist()
    # the split: each step alone (synced), with events between its stages
    steps = []
    for _ in range(TRAIN_STEPS):
        events.clear()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(state, batch, timed)
        b.record()
        torch.cuda.synchronize()
        steps.append({"step_ms": a.elapsed_time(b),
                      **{f"{n}_ms": x.elapsed_time(y)
                         for n, x, y in events}})
    med = {k: float(np.median([st[k] for st in steps])) for k in steps[0]}
    first, last = np.mean(losses_seen[:5]), np.mean(losses_seen[-5:])
    if not (np.isfinite(losses_seen).all() and last < first):
        raise AssertionError(f"the loss on one batch did not fall over "
                             f"{TRAIN_STEPS} steps: {losses_seen}")
    n_img = TRAIN_STEPS * cfg_f.TRAIN.BATCH_SIZE
    timing = {"arch": cfg_f.MODEL.NAME, "dtype": cfg_f.MODEL.DTYPE,
              "batch": cfg_f.TRAIN.BATCH_SIZE, "size": SIZE,
              "policy": cfg_f.DATA.AUGMENTATION_TYPE,
              "steps": TRAIN_STEPS, "host_syncs_per_step": len(syncs),
              "window_ms": window_ms,
              "window_step_ms": window_ms / TRAIN_STEPS,
              "img_per_s": n_img / (window_ms / 1e3),
              **{f"median_{k}": v for k, v in med.items()},
              "img_per_s_synced_steps": cfg_f.TRAIN.BATCH_SIZE
              / (med["step_ms"] / 1e3),
              "peak_allocated_mib": torch.cuda.max_memory_allocated()
              / 2 ** 20,
              "loss_first5": first, "loss_last5": last,
              "train_cli_wall_s": wall, "resume_wall_s": wall_r,
              "phase_s": time.perf_counter() - t_phase}
    log("train_step_timing", **timing, step_rounds_ms=[
        round(st["step_ms"], 4) for st in steps])
    log("profile_train_step", **profile_window(lambda: step(state, batch),
                                               1))
    del state
    torch.cuda.empty_cache()
    return {"timing": timing, "launches": serve_launches}


# phase 3i: the fill trainers' clean folder (utils/synthetic, 512²), the
# GAN run (lama at full width, 256², batch 8, warmup 4 of 8 steps, a log
# every 4; cut from 16 steps, and its timed steps from 10 to 5, to buy
# phase 3l its time), its timed steps, the latent-diffusion run (256², batch 16, 8 +
# 8 steps), the diffusion engine's timed call (8 x 512², 20 DDIM steps)
# and the card-against-CPU checks' shapes
FILL_FILES = 16
GAN_SIZE, GAN_BATCH, GAN_STEPS, GAN_WARMUP, GAN_LOG = 256, 8, 8, 4, 4
GAN_TIMED = 5
LD_SIZE, LD_BATCH, LD_AE_STEPS, LD_DN_STEPS = 256, 16, 8, 8
LD_SERVE_STEPS = 20
# the serving runs' files, from 3d's folder: two with logos, and the two
# without, which step 1 types as watermarks in their batch (K1 and K2)
# before it skips them as empty
FILL_CLI_FILES = ("a00", "a01", "a06", "a07")
FILL_CHECK_SIZE, GAN_CHECK_BATCH, LD_CHECK_STEPS = 64, 2, 4
# a G + D step card against CPU, TF32 off, in float32: the losses to rel
# 1e-4, the running statistics to 1e-4, the parameters after Adam's first
# step to 2·lr (each moves by about ±lr, so a gradient near zero may take
# the other sign); the float32 gradients themselves are not held: through
# BatchNorm at init they carry rounding of up to ~14 % of a tensor's
# largest between any two implementations (tests/test_torch_train.py
# finds the same for the segmentation net against float64; the float64
# gradients are tests/test_torch_cuda.py's). The sampler's fill to 1e-3.
GAN_LOSS_RTOL, GAN_STATS_TOL = 1e-4, 1e-4
LD_SAMPLE_TOL = 1e-3


def gan_step_card_vs_cpu(dev, seed: int) -> dict:
    """One G + D step of the full-width trainer from the same init on the
    card and on the CPU (2 x 64², the same images and masks) in float32:
    the losses, the running statistics and the stepped parameters (the
    float64 gradient check is tests/test_torch_cuda.py's
    test_gan_step_on_card_matches_cpu; on the CPU it took 6-15 s of this
    phase)."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.training import train_inpaint as ti

    s, n = FILL_CHECK_SIZE, GAN_CHECK_BATCH
    x = torch.from_numpy(np.random.default_rng(seed).random(
        (n, s, s, 3)).astype(np.float32))
    masks = ti.random_mask_batch(torch.Generator().manual_seed(seed), n, s,
                                 "cpu")
    got = []
    for where in (dev, torch.device("cpu")):
        tr = ti.build_trainer(seed=seed, device=where, compute_dtype=None)
        tr = ti.InpaintTrainer(tr.model.float(), tr.disc.float(),
                               compute_dtype=None)
        xs, ms = x.to(where), masks.to(where)
        gl, fake, g = tr.g_loss_grads(xs, ms, True)
        dl, dg = tr.d_loss_grads(xs, fake)
        tr.opt.step(g)
        tr.d_opt.step(dg)
        got.append((float(gl), float(dl), {
            **tr.weights(), **{"disc/" + k: v for k, v in ti.module_to_flax(
                tr.disc, ti.lama_flax_path).items()}}))
        del tr
    (gl, dl, w), (gl_c, dl_c, w_c) = got
    out = {"size": s, "batch": n, "fp32_g_loss_card": gl,
           "fp32_g_loss_cpu": gl_c, "fp32_d_loss_card": dl,
           "fp32_d_loss_cpu": dl_c,
           "fp32_batch_stats_max_abs": max(
               float(np.abs(w[k] - v).max()) for k, v in w_c.items()
               if k.startswith("batch_stats/")),
           "fp32_params_max_abs": max(
               float(np.abs(w[k] - v).max()) for k, v in w_c.items()
               if not k.startswith("batch_stats/"))}
    lr = 2e-4  # InpaintTrainer's default, the larger of the two
    if not (abs(gl - gl_c) <= GAN_LOSS_RTOL * abs(gl_c)
            and abs(dl - dl_c) <= GAN_LOSS_RTOL * abs(dl_c)
            and out["fp32_batch_stats_max_abs"] <= GAN_STATS_TOL
            and out["fp32_params_max_abs"] <= 2 * lr + 1e-6):
        raise AssertionError(f"fp32 GAN step card vs CPU: {out}")
    return out


def ld_sampler_card_vs_cpu(weights: str, dev, seed: int) -> dict:
    """The float32 DDIM fill on the card against the CPU's with the same
    noise (1 x 64², LD_CHECK_STEPS steps)."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.diffusion.latent_diffusion import \
        LatentInpainter

    s = FILL_CHECK_SIZE
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((1, s, s, 3)).astype(np.float32))
    m = torch.zeros(1, s, s, 1)
    m[:, 12:40, 20:52] = 1
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(1, s // 8, s // 8, 4, generator=g)
    noise = torch.randn(LD_CHECK_STEPS, 1, s // 8, s // 8, 4, generator=g)
    outs = [LatentInpainter(weights, device=where, dtype=None).sample(
        x.to(where), m.to(where), z.to(where), noise.to(where)).cpu()
        for where in (dev, torch.device("cpu"))]
    err = (outs[0] - outs[1]).abs().max().item()
    if err > LD_SAMPLE_TOL:
        raise AssertionError(f"float32 sampler card vs CPU: {err}")
    return {"size": s, "steps": LD_CHECK_STEPS, "max_abs": err}


def check_outside_masks(folder: Path, out: Path) -> int:
    """Every repaired file's pixels outside its step-1 mask equal the
    input's; returns the number of files checked."""
    import numpy as np
    from unet_watermark_tpu_torch.utils.image_io import read_gray, read_rgb

    checked = 0
    for src in sorted(folder.iterdir()):
        final = out / "step2_watermark_repaired" / src.name
        mask = out / "step1_masks" / f"{src.stem}_mask.png"
        if not (final.exists() and mask.exists()):
            continue
        keep = read_gray(mask) <= 127
        if not np.array_equal(read_rgb(final)[keep], read_rgb(src)[keep]):
            raise AssertionError(f"{src.name}: repaired pixels outside the "
                                 f"step-1 mask differ from the input's")
        checked += 1
    if not checked:
        raise AssertionError(f"no repaired file with a mask in {out}")
    return checked


def fill_training_phase(work: Path, seed: int, dev) -> dict:
    """Phase 3i: train_inpaint (FFC-LaMa against the PatchGAN) and
    train_latent_diffusion at full width on the card, each served through
    the `repair` command (K1 and K2 launched by its step 1), the GAN step
    checked for host syncs and timed, and float32 card-against-CPU checks
    of a GAN step and of the DDIM sampler. Returns the timing fields and
    the serving runs' launches."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.diffusion.latent_diffusion import \
        LatentInpainter
    from unet_watermark_tpu_torch.inference import engines
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.training import train_inpaint as ti
    from unet_watermark_tpu_torch.training import train_latent_diffusion \
        as tld
    from unet_watermark_tpu_torch.utils.image_io import write_png
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    t_phase = time.perf_counter()
    clean = work / "fill_clean"
    clean.mkdir()
    imgs, _ = watermarked_images(FILL_FILES, SIZE, seed=seed + 11,
                                 clean=FILL_FILES)
    for i, img in enumerate(imgs):
        write_png(clean / f"c{i:02d}.png",
                  np.rint(img * 255).astype(np.uint8))
    serve_in = work / "in_fill"
    serve_in.mkdir()
    for stem in FILL_CLI_FILES:
        shutil.copy(work / "in" / f"{stem}.png", serve_in / f"{stem}.png")

    # (a) train_inpaint at full width
    out = work / "fill_out" / "lama"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = ti.train_inpaint(str(clean), str(out), "lama", GAN_SIZE, GAN_BATCH,
                         GAN_STEPS, seed=seed, log_every=GAN_LOG,
                         warmup_steps=GAN_WARMUP, device=dev)
    train_s = time.perf_counter() - t0
    hist = r["history"]
    if len(hist) != GAN_STEPS // GAN_LOG or not all(
            np.isfinite([h["g_loss"], h["d_loss"], h["hole_psnr"]]).all()
            for h in hist) or not all(h["d_loss"] > 0 for h in hist
                                      if h["step"] > GAN_WARMUP):
        raise AssertionError(f"train_inpaint history: {hist}")
    log("train_inpaint", variant="lama", size=GAN_SIZE, batch=GAN_BATCH,
        steps=GAN_STEPS, warmup=GAN_WARMUP, wall_s=train_s, history=hist,
        peak_allocated_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    names = {}
    for path in (str(out), str(out) + ".npz"):
        names[Path(path).name] = engines.get_engine(
            "lama", weights_path=path, device=dev).name
    if set(names.values()) != {"ffc-lama"}:
        raise AssertionError(f"the trained weights serve as {names}")
    argv = ["repair", "--input", str(serve_in), "--output",
            str(work / "out_fill_lama"), "--no-ocr", "--inpaint-weights",
            str(out)]
    kc.reset_launch_counts()
    rc, wall, _ = run_cli(argv, dev, timer=False)
    torch.cuda.synchronize()
    lama_launches = {k.__name__: k.launches for k in kc.KERNELS}
    summary = json.loads((work / "out_fill_lama" /
                          "repair_summary.json").read_text())
    if rc != 0 or summary.get("status") != "success" or \
            summary.get("engine_used") != "ffc-lama" or \
            summary.get("engine_failures") or \
            min(lama_launches.values()) < 1:
        raise AssertionError(f"repair --inpaint-weights: rc {rc}, "
                             f"{summary}, launches {lama_launches}")
    checked = check_outside_masks(serve_in, work / "out_fill_lama")
    t0 = time.perf_counter()
    resumed = ti.train_inpaint(str(clean), str(work / "fill_out" / "again"),
                               "lama", GAN_SIZE, GAN_BATCH, 2, seed=seed,
                               log_every=2, warmup_steps=0,
                               resume_from=str(out) + ".npz", device=dev)
    resume_s = time.perf_counter() - t0
    if not np.isfinite(resumed["final_loss"]):
        raise AssertionError(f"--resume-from: {resumed}")
    log("train_inpaint_serving", engines=names, argv=argv[:1] + argv[5:],
        rc=rc, wall_s=wall, engine=summary["engine_used"],
        launches=lama_launches, outside_mask_equal_files=checked,
        resume_from_npz_final_loss=resumed["final_loss"],
        resume_wall_s=resume_s)
    log("gan_step_card_vs_cpu", **gan_step_card_vs_cpu(dev, seed))

    # the GAN step at full width on the resident corpus, from the trained
    # generator
    trainer = ti.build_trainer(seed=seed, device=dev,
                               resume_from=str(out) + ".npz")
    sample, _ = ti.device_clean_sampler(str(clean), GAN_BATCH, GAN_SIZE,
                                        device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    batch = sample(gen)
    for _ in range(3):
        trainer.step(batch, gen, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.step(sample(gen), gen, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "synchroniz" in str(w.message)]
    if syncs:
        raise AssertionError(f"a GAN step synchronizes: {syncs}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(GAN_TIMED):
        trainer.step(sample(gen), gen, True)
    b.record()
    torch.cuda.synchronize()
    window_ms = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    events = []

    @contextlib.contextmanager
    def timed(name):
        x = torch.cuda.Event(enable_timing=True)
        y = torch.cuda.Event(enable_timing=True)
        x.record()
        yield
        y.record()
        events.append((name, x, y))

    steps = []
    for _ in range(GAN_TIMED):
        events.clear()
        x = torch.cuda.Event(enable_timing=True)
        y = torch.cuda.Event(enable_timing=True)
        x.record()
        trainer.step(batch, gen, True, part=timed)
        y.record()
        torch.cuda.synchronize()
        part = {n: p.elapsed_time(q) for n, p, q in events}
        steps.append({"step_ms": x.elapsed_time(y),
                      "generator_ms": part["generator"],
                      "discriminator_ms": part["discriminator"],
                      "optimizers_ms": part["g_optimizer"]
                      + part["d_optimizer"]})
    med = {k: float(np.median([st[k] for st in steps])) for k in steps[0]}
    masks = ti.random_mask_batch(gen, GAN_BATCH, GAN_SIZE, dev)
    whole = lambda name: "all"  # noqa: E731
    g_flops = conv_flops(trainer.model, batch, masks, segment=whole)["all"]
    d_flops = conv_flops(trainer.disc, batch, segment=whole)["all"]
    # a step's convs: the generator forward and backward (3 forwards), the
    # discriminator on the fake with its input gradient (2), on the real
    # image without gradient (1), and both again in its own step with
    # weight gradients (2 + 2)
    step_flops = 3 * g_flops + 7 * d_flops
    step_ms = window_ms / GAN_TIMED
    prof = profile_window(lambda: trainer.step(batch, gen, True), 2)
    gan = {"size": GAN_SIZE, "batch": GAN_BATCH, "steps": GAN_TIMED,
           "host_syncs_per_step": len(syncs), "window_ms": window_ms,
           "gan_step_ms": step_ms,
           "img_per_s": GAN_BATCH * GAN_TIMED / (window_ms / 1e3),
           **{f"median_{k}": v for k, v in med.items()},
           "device_busy_share": prof["device_busy_share"],
           "peak_allocated_mib": peak,
           "generator_forward_conv_tflop": g_flops / 1e12,
           "discriminator_forward_conv_tflop": d_flops / 1e12,
           "step_conv_tflop": step_flops / 1e12,
           "step_bound_ms": step_flops / PEAK_BF16_FLOPS_PER_S * 1e3,
           "inpaint_train_mfu": step_flops / (step_ms * 1e-3
                                              * PEAK_BF16_FLOPS_PER_S)}
    log("gan_step_timing", **gan, step_rounds_ms=[
        round(st["step_ms"], 4) for st in steps])
    log("profile_gan_step", **prof)
    del trainer, sample, batch
    torch.cuda.empty_cache()

    # (b) train_latent_diffusion at full width, its weights served
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r_ld = tld.train_latent_diffusion(
        str(clean), str(work / "fill_out" / "ld"), LD_SIZE, LD_BATCH,
        LD_AE_STEPS, LD_DN_STEPS, seed=seed, log_every=4, device=dev)
    ld_s = time.perf_counter() - t0
    shipped = tld.ship_weights(r_ld["params"],
                               str(work / "fill_out" / "ld_ship.npz"))
    log("train_latent_diffusion", size=LD_SIZE, batch=LD_BATCH,
        ae_steps=LD_AE_STEPS, dn_steps=LD_DN_STEPS, wall_s=ld_s,
        peak_allocated_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    argv = ["repair", "--input", str(serve_in), "--output",
            str(work / "out_fill_ld"), "--no-ocr", "--watermark-model",
            "diffusion"]
    saved_env = os.environ.get("DIFFUSION_WEIGHTS")
    os.environ["DIFFUSION_WEIGHTS"] = shipped
    try:
        kc.reset_launch_counts()
        rc, wall_ld, _ = run_cli(argv, dev, timer=False)
        torch.cuda.synchronize()
    finally:
        if saved_env is None:
            os.environ.pop("DIFFUSION_WEIGHTS", None)
        else:
            os.environ["DIFFUSION_WEIGHTS"] = saved_env
    ld_launches = {k.__name__: k.launches for k in kc.KERNELS}
    summary = json.loads((work / "out_fill_ld" /
                          "repair_summary.json").read_text())
    if rc != 0 or summary.get("status") != "success" or \
            summary.get("engine_used") != "latent-diffusion" or \
            summary.get("engine_failures") or \
            min(ld_launches.values()) < 1:
        raise AssertionError(f"repair --watermark-model diffusion: rc {rc}, "
                             f"{summary}, launches {ld_launches}")
    checked = check_outside_masks(serve_in, work / "out_fill_ld")
    log("diffusion_serving", argv=argv[:1] + argv[5:], rc=rc,
        wall_s=wall_ld, engine=summary["engine_used"], launches=ld_launches,
        outside_mask_equal_files=checked)
    log("diffusion_sampler_card_vs_cpu",
        **ld_sampler_card_vs_cpu(shipped, dev, seed))

    # the engine's 20-step fill of a 512² batch with these weights (the
    # shipped latent_diffusion.npz's time is the same function's: 3k runs
    # that file)
    imgs_t = torch.from_numpy(watermarked_images(BATCH, SIZE, seed=seed)[0]
                              ).to(dev)
    holes = torch.zeros(BATCH, SIZE, SIZE, 1, device=dev)
    holes[:, SIZE // 4:SIZE // 2, SIZE // 3:2 * SIZE // 3] = 1
    engine_ms = {}
    for label, path in (("phase_weights", shipped),):
        if not Path(path).exists():
            engine_ms[label] = None
            continue
        inp = LatentInpainter(str(path), device=dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: inp.inpaint(imgs_t, holes, LD_SERVE_STEPS),
                         3, warmup=1)
        engine_ms[label] = ms
        if label == "phase_weights":
            with torch.inference_mode():
                prof_ld = profile_window(lambda: inp.inpaint(
                    imgs_t, holes, LD_SERVE_STEPS), 1)
        del inp
    log("timing_diffusion_engine", batch=BATCH, size=SIZE,
        ddim_steps=LD_SERVE_STEPS, ms=engine_ms,
        img_per_s=BATCH / (engine_ms["phase_weights"] / 1e3),
        kernel_launches_a_call=prof_ld["kernel_launches"],
        device_busy_share=prof_ld["device_busy_share"])
    log("profile_diffusion_engine", **prof_ld)
    timing = {**{f"gan_{k}": v for k, v in gan.items()},
              "train_inpaint_wall_s": train_s,
              "train_latent_diffusion_wall_s": ld_s,
              "diffusion_engine_ms": engine_ms,
              "diffusion_engine_img_per_s": BATCH / (
                  engine_ms["phase_weights"] / 1e3),
              "diffusion_engine_kernel_launches": prof_ld["kernel_launches"],
              "phase_s": time.perf_counter() - t_phase}
    return {"timing": timing,
            "launches": {"trained_lama": lama_launches,
                         "diffusion": ld_launches}}


# phase 3j: the `auto` loop's test folder (the first files of 3d's
# folder), its logos, its held-out limit, the video's frames an image
# (1.0 s at 15 fps, the loop's VideoGenerator), and the bf16 tolerance of
# the vmapped forward against each checkpoint's own; the test folder cut
# from 4 files to 3 to buy phase 3n its time, then to 2 and the held-out
# triads from 8 to 4 to buy phase 3q its time
AUTO_TEST_FILES, AUTO_LOGOS, AUTO_HELDOUT = 2, 3, 4
AUTO_FRAMES_AN_IMAGE = int(1.0 * 15)
AUTO_VMAP_AGREE = 0.999


def mp4_boxes(data: bytes, start: int = 0, end: int = None) -> list:
    """(kind, offset of the body, size of the body) of each box in
    data[start:end], raising where a size runs past the end."""
    end = len(data) if end is None else end
    out, pos = [], start
    while pos < end:
        size, kind = int.from_bytes(data[pos:pos + 4], "big"), \
            data[pos + 4:pos + 8].decode("latin-1")
        if size < 8 or pos + size > end:
            raise AssertionError(f"box {kind!r} at {pos}: size {size}")
        out.append((kind, pos + 8, size - 8))
        pos += size
    return out


def mp4_sample_count(path: Path) -> tuple:
    """(top-level box kinds, the video track's stsz sample count, its stss
    count) of an MP4 file, every box on the way parsed."""
    data = path.read_bytes()
    top = mp4_boxes(data)
    box = {k: (o, n) for k, o, n in top}

    def child(parent, kind):
        o, n = parent
        for k, co, cn in mp4_boxes(data, o, o + n):
            if k == kind:
                return co, cn
        raise AssertionError(f"no {kind} box")

    stbl = child(child(child(child(box["moov"], "trak"), "mdia"), "minf"),
                 "stbl")
    stsz, stss = child(stbl, "stsz"), child(stbl, "stss")
    count = int.from_bytes(data[stsz[0] + 8:stsz[0] + 12], "big")
    sync = int.from_bytes(data[stss[0] + 4:stss[0] + 8], "big")
    return [k for k, _, _ in top], count, sync


def auto_phase(work: Path, seed: int, dev, test_files=AUTO_TEST_FILES,
               heldout=AUTO_HELDOUT, device="cuda") -> dict:
    """Phase 3j: the `auto` command as users type it (one cycle, the
    default configuration with the yaml, epochs 1) on the card, reusing
    the earlier phases: 3h's folder as the training folder and the
    held-out triads, 3h's checkpoints in the loop's checkpoint folder (step
    1 chooses among them in one vmapped forward), the first files of 3d's
    folder as the test folder, 3i's clean folder with RGBA logos
    (utils/synthetic.logo_images) for step 5. Checks: rc 0 and the cycle's
    status "success", step 1's forward vmapped over >= 2 checkpoints and
    equal to each checkpoint's own forward within the bf16 tolerance,
    step 5's files on the card equal byte for byte to the same generation
    on the host, the MP4's boxes parsed with images x 15 samples, K1 and K2
    launched by the cycle. Returns the timing fields and the launches."""
    import copy

    import torch
    from unet_watermark_tpu_torch import cli
    from unet_watermark_tpu_torch.configs import DEFAULT_CONFIG
    from unet_watermark_tpu_torch.data import gen_data
    from unet_watermark_tpu_torch.ops.augment import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.ops.resize import resize_linear_u8
    from unet_watermark_tpu_torch.scripts import model_selector as ms
    from unet_watermark_tpu_torch.training import auto_train as at
    from unet_watermark_tpu_torch.utils import image_io
    from unet_watermark_tpu_torch.utils.synthetic import logo_images

    t_phase = time.perf_counter()
    root = work / "auto"
    test, logos = root / "data" / "test", root / "data" / "logos"
    test.mkdir(parents=True)
    logos.mkdir()
    for p in sorted((work / "in").iterdir())[:test_files]:
        shutil.copy(p, test / p.name)
    for i, logo in enumerate(logo_images(AUTO_LOGOS, seed + 30)):
        image_io.write_png(logos / f"logo{i}.png", logo)
    train_dir = work / "train_data"
    out = root / "models" / "auto"  # the --output-dir default
    ckpt = out / "checkpoints"
    shutil.copytree(work / "train_out" / "checkpoints", ckpt)
    given = sorted(os.listdir(ckpt))
    existing = len(os.listdir(train_dir / "watermarked"))
    overrides = root / "auto.json"
    overrides.write_text(json.dumps({
        "train_data_dir": str(train_dir),
        "clean_data_dir": str(work / "fill_clean"),
        "heldout_eval_dir": str(train_dir), "heldout_eval_limit": heldout}))
    argv = ["auto", "-c", str(DEFAULT_CONFIG), "--project-root", str(root),
            "--max-cycles", "1", "--epochs", "1",
            "--prediction-limit", str(test_files),
            "--config-file", str(overrides)]
    if device != "cuda":  # the flag's default
        argv += ["--device", device]

    loops, forwards = [], []
    real_loop, real_forward = at.AutoTrainingLoop, ms.ModelSelector.forward_all

    class Loop(real_loop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            loops.append(self)

    def forward_all(self, models, norm, vmap=None):
        out = real_forward(self, models, norm, vmap)
        forwards.append((self.vmapped, len(models)))
        return out

    at.AutoTrainingLoop, ms.ModelSelector.forward_all = Loop, forward_all
    kc.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        at.AutoTrainingLoop, ms.ModelSelector.forward_all = \
            real_loop, real_forward
    launches = {k.__name__: k.launches for k in kc.KERNELS}
    info = json.loads((out / "cycle_0_info.json").read_text())
    if rc != 0 or info["status"] != "success":
        raise AssertionError(f"auto: rc {rc}, cycle {info.get('status')}: "
                             f"{info.get('error')}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the auto cycle never launched {name}")
    loop = loops[0]
    steps = info["steps"]
    if not forwards or forwards[0] != (True, len(given)) or len(given) < 2:
        raise AssertionError(f"step 1's forwards {forwards} over {given}")

    # step 5 again on the host (a thread: CPU work beside the card's
    # checks below): the same files, byte for byte
    new_count = max(int(existing * loop.config.data_growth), 10)
    host_dir = root / "gen_host"

    def host_generation():
        t0 = time.perf_counter()
        stats = gen_data.generate_dataset(
            str(work / "fill_clean"), str(host_dir), str(logos),
            count=new_count, ratios=loop.augmentation_ratios(), seed=1000,
            device="cpu")
        return stats, time.perf_counter() - t0

    host_thread = ThreadPoolExecutor(1)
    host_run = host_thread.submit(host_generation)

    # step 1's forward, vmapped, against each checkpoint's own (bf16)
    sel = ms.ModelSelector(str(ckpt), str(test), str(root / "vmap"),
                           config=loop.cfg, device=device)
    models = [sel._load_model(p) for p in sel.discover_checkpoints()]
    s = loop.cfg.DATA.IMG_SIZE
    x = torch.stack([resize_linear_u8(image_io.read_rgb_tensor(p, dev),
                                      (s, s))
                     for p in sorted(test.iterdir())]).float() / 255.0
    norm = (x - torch.tensor(IMAGENET_MEAN, device=dev)) / torch.tensor(
        IMAGENET_STD, device=dev)
    pv = sel.forward_all(models, norm, vmap=True)
    po = sel.forward_all(models, norm, vmap=False)
    # the bf16 error of the forward itself: each checkpoint in float32
    cfg32 = copy.deepcopy(loop.cfg)
    cfg32.MODEL.DTYPE = "float32"
    sel32 = ms.ModelSelector(str(ckpt), str(test), str(root / "vmap32"),
                             config=cfg32, device=device)
    p32 = sel32.forward_all([sel32._load_model(p) for p in
                             sel32.discover_checkpoints()], norm, vmap=False)
    vmap_err = (pv - po).abs().max().item()
    bf16_err = (po - p32).abs().max().item()
    vmap_agree = ((pv > 0.5) == (po > 0.5)).float().mean().item()
    if vmap_err > 2 * bf16_err or vmap_agree < AUTO_VMAP_AGREE:
        raise AssertionError(f"vmapped probabilities differ from each "
                             f"checkpoint's own by {vmap_err}, over twice "
                             f"the bf16 forward's own error {bf16_err} "
                             f"(masks agree on {vmap_agree})")
    del models, pv, po, p32

    host_stats, host_s = host_run.result()
    host_thread.shutdown()
    made = 0
    for sub in ("watermarked", "clean", "masks"):
        for name in sorted(os.listdir(host_dir / sub)):
            made += 1
            if (host_dir / sub / name).read_bytes() != \
                    (train_dir / sub / name).read_bytes():
                raise AssertionError(f"step 5's {sub}/{name} on the card "
                                     f"differs from the host's")
    gen = steps["data_augmentation"]["generated"]
    if gen < 1 or made != 3 * gen:
        raise AssertionError(f"step 5 made {gen}, the host {made} files")

    video = Path(steps["video"]["path"])
    top, samples, sync = mp4_sample_count(video)
    pairs = len(os.listdir(test))
    if top != ["ftyp", "mdat", "moov"] or \
            samples != pairs * AUTO_FRAMES_AN_IMAGE or sync != pairs:
        raise AssertionError(f"the cycle's MP4: boxes {top}, {samples} "
                             f"samples, {sync} sync")
    held = steps["heldout_eval"]
    if held["error"] is not None or held["n_images"] != heldout:
        raise AssertionError(f"held-out eval {held}")
    sec = loop.step_seconds
    log("auto", argv=argv[:1] + argv[3:], rc=rc, wall_s=wall,
        checkpoints_given=given, step1_forwards=forwards,
        best_model=Path(steps["model_selection"]["best_model"]).name,
        training=steps["training"], prediction=steps["prediction"],
        video_bytes=video.stat().st_size, video_samples=samples,
        video_sync_samples=sync, data_augmentation=steps[
            "data_augmentation"], step5_card_equals_host=True,
        heldout_eval=held, vmap_vs_own_max_abs=vmap_err,
        own_bf16_vs_fp32_max_abs=bf16_err,
        vmap_vs_own_mask_agreement=vmap_agree, launches=launches)
    timing = {"wall_s": wall, "step_s": sec,
              "gen_data_samples_per_s_card": gen / sec["data_augmentation"],
              "gen_data_samples_per_s_host": sum(
                  v for k, v in host_stats.items() if k != "skipped")
              / host_s,
              "video_frames_per_s": samples / sec["video"],
              "video_images_per_s": pairs / sec["video"],
              "phase_s": time.perf_counter() - t_phase}
    return {"timing": timing, "launches": launches}


# phase 3k: the report's depth (--limit; 64 by default), the frozen set's
# indices generated again on the host, the textured witness's size and
# triads (tests/test_torch_quality_e2e_tex.py's) and its card-vs-host
# bound (that test's, in dB), the calibration set, the new sidecar's masks
# against the shipped one's (pixel agreement; IoU, which a sidecar with
# every amax x CALIB_BROKEN must fail), and 3d's files the shells repair;
# the depth cut from 6 to 4 to buy phase 3n's `train` command its time,
# the host's triads from 4 to 2 and the shells' files from 4 to 2 to buy
# phase 3q its time
QUALITY_LIMIT = 4
QUALITY_HOST_TRIADS = 2
TEX_SIZE, TEX_TRIADS, TEX_DB_TOL = 128, 4, 0.1
# the textured 128² set's files (watermarked, clean, masks; _set_digest) as
# made on a CPU with torch 2.13 and numpy 2.0.2: other libraries and other
# installed fonts write the same bytes
TEX_SET_SHA256 = ("6ffc172f352c887459bb6656e3f191004112dc031fe93ca03ce891"
                  "3978d845b2")
CALIB_IMAGES, CALIB_BATCH = 8, 4
CALIB_AGREE, CALIB_IOU, CALIB_BROKEN = 0.99, 0.9, 0.25
SHELL_FILES = ("a00", "a06")
# convs of one int8 forward: UNet++ and Unet (the sidecars' keys)
INT8_CONVS = {"unetplusplus": 68, "unet": 50}


def _non_finite(node, path: str = "") -> list:
    """The paths of the numbers in a report dict that are not finite."""
    if isinstance(node, dict):
        return [p for k, v in node.items()
                for p in _non_finite(v, f"{path}/{k}")]
    if isinstance(node, (list, tuple)):
        return [p for i, v in enumerate(node)
                for p in _non_finite(v, f"{path}/{i}")]
    if isinstance(node, (int, float)) and not isinstance(node, bool):
        return [] if math.isfinite(node) else [path]
    return []


def _set_digest(root: Path) -> str:
    """SHA-256 over a triad set's relative paths and bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for sub in ("watermarked", "clean", "masks"):
        for name in sorted(os.listdir(root / sub)):
            h.update(f"{sub}/{name}".encode())
            h.update((root / sub / name).read_bytes())
    return h.hexdigest()


def _same_files(a: Path, b: Path, names) -> list:
    """The names whose bytes differ between folders a and b."""
    return [n for n in names
            if (a / n).read_bytes() != (b / n).read_bytes()]


def _timed_sections(module, names: dict, seconds: dict, sync):
    """Wrap module.<name> to add its wall seconds (synced) to
    seconds[key] for each name → key; returns the originals."""
    real = {name: getattr(module, name) for name in names}

    def wrap(name, key):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                sync()
                seconds[key] += time.perf_counter() - t0
        return timed

    for name, key in names.items():
        setattr(module, name, wrap(name, key))
    return real


def quality_phase(work: Path, dev, limit: int = QUALITY_LIMIT,
                  size: int = SIZE, host_triads: int = QUALITY_HOST_TRIADS,
                  calib_images: int = CALIB_IMAGES,
                  shell_files=SHELL_FILES, device="cuda") -> dict:
    """Phase 3k (module docstring): the quality report, the calibration
    and the SD3/FLUX shells on the card. Returns the timing fields and the
    kernels' launches for phase 4's lines."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.configs import get_cfg_defaults
    from unet_watermark_tpu_torch.diffusion import (FluxProcessor,
                                                    SDWatermarkRemover)
    from unet_watermark_tpu_torch.diffusion import latent_diffusion
    from unet_watermark_tpu_torch.diffusion.sd3_inpaint import read_bgr
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.ops import quant
    from unet_watermark_tpu_torch.ops.kernels import conv_s8 as k8
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.scripts import calibrate_quant
    from unet_watermark_tpu_torch.scripts import quality_report as qr
    from unet_watermark_tpu_torch.utils import shipping

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    qdir = work / "quality"
    tiers = ["smooth", "textured"]
    argv = ["--workdir", str(qdir), "--limit", str(limit), "--tiers",
            *tiers]
    if size != SIZE:  # the flags' defaults
        argv += ["--img-size", str(size)]
    if device != "cuda":
        argv += ["--device", device]
    # (a) the report as a user runs it, each section timed
    sections = collections.defaultdict(float)
    real = _timed_sections(qr, {
        "ensure_frozen_set": "frozen_set", "eval_segmentation":
        "segmentation", "eval_inpaint_engines": "inpaint",
        "eval_e2e_repair": "e2e_repair"}, sections, sync)
    kc.reset_launch_counts()
    k8.reset_launch_counts()
    out = io.StringIO()  # main prints the report; the JSON file keeps it
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            report = qr.main(argv)
        sync()
        report_s = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(qr, name, fn)
    launches = {k.__name__: k.launches for k in kc.KERNELS}
    launches.update({"uwt_conv_s8": k8.conv_s8.launches,
                     "uwt_quantize_s8": k8.quantize_s8.launches})
    failures = []
    batches = -(-limit // BATCH)
    want_convs = 0
    for tier in tiers:
        seg = report[tier]["segmentation"]
        want = ["unetplusplus_resnet34", "unet_resnet34",
                "unetplusplus_resnet34_int8", "unet_resnet34_int8"]
        if sorted(seg) != sorted(want):
            failures.append(f"{tier}: segmentation rows {sorted(seg)}")
        for key, row in seg.items():
            if "error" in row or row["n_images"] != limit:
                failures.append(f"{tier}/{key}: {row}")
            if key.endswith("_int8"):
                want_convs += INT8_CONVS[key.split("_")[0]] * batches
        for mode in ("e2e_repair", "e2e_repair_tight"):
            e = report[tier][mode]
            if e["lama"]["engine_used"] != "ffc-lama":
                failures.append(f"{tier}/{mode}: LaMa ran as "
                                f"{e['lama']['engine_used']}")
            if tier == "smooth" and not e["lama"]["psnr_to_clean_db"] > \
                    e["floor"]["psnr_to_clean_db"]:
                failures.append(f"{tier}/{mode}: LaMa repair "
                                f"{e['lama']['psnr_to_clean_db']} dB is "
                                f"not above the no-op floor "
                                f"{e['floor']['psnr_to_clean_db']} dB")
        if tier == "textured":  # the floor: (e) below; tight over parity
            tight, parity = (report[tier][m]["lama"]["psnr_to_clean_db"]
                             for m in ("e2e_repair_tight", "e2e_repair"))
            if not tight > parity:
                failures.append(f"textured: tight LaMa repair {tight} dB "
                                f"is not above the parity chain's {parity}")
    bad = _non_finite(report)
    if bad:
        failures.append(f"numbers not finite: {bad}")
    for name in ("morph_chain_watermark", "gaussian_smooth_threshold"):
        if launches[name] < 2:
            failures.append(f"{name} launched {launches[name]} times")
    for name in ("uwt_conv_s8", "uwt_quantize_s8"):
        if launches[name] != want_convs:
            failures.append(f"{name} launched {launches[name]} times, not "
                            f"{want_convs}")
    # (b) the smooth tier's files against the same indices made on the host
    host = work / "quality_host"
    t0 = time.perf_counter()
    qr.ensure_frozen_set(str(host), n=host_triads, img_size=size,
                         device="cpu")
    host_s = time.perf_counter() - t0
    compared, differ = 0, []
    for sub in ("clean_src", "logos", "heldout/watermarked",
                "heldout/clean", "heldout/masks"):
        names = sorted(os.listdir(host / sub))
        missing = sorted(set(names) - set(os.listdir(qdir / sub)))
        if missing:
            differ.append(f"{sub}: not on the card: {missing}")
            continue
        differ += [f"{sub}/{n}" for n in _same_files(host / sub, qdir / sub,
                                                     names)]
        compared += len(names)
    if differ or compared < 28 + 3 * host_triads:
        failures.append(f"frozen set card vs host: {compared} files "
                        f"compared, differing {differ}")
    frozen_files = sum(len(os.listdir(qdir / d)) for d in (
        "clean_src", "clean_src_tex", "logos", "heldout/watermarked",
        "heldout_tex/watermarked"))
    log("quality_report", argv=argv, cut=f"--limit {limit} (64 by "
        "default): the depth only", launches=launches,
        int8_conv_launches_wanted=want_convs, wall_s=report_s,
        section_s=dict(sections),
        frozen_set_files=frozen_files,
        frozen_set_images_per_s=frozen_files / sections["frozen_set"],
        host_frozen_set_s=host_s, card_vs_host_files_equal=compared,
        rows={t: {k: {"raw_iou": v["raw"]["iou"],
                      "pipeline_iou": v["pipeline"]["iou"],
                      "tight_iou": v["pipeline_tight"]["iou"]}
                  for k, v in report[t]["segmentation"].items()}
              for t in tiers},
        inpaint={t: report[t]["inpaint"] for t in tiers},
        e2e={t: {m: report[t][m] for m in ("e2e_repair",
                                            "e2e_repair_tight")}
             for t in tiers})
    # (e) the textured tier's tight repair at the CPU tests' size, where the
    # port on the CPU equals JAX's and LaMa lands above the no-op floor:
    # the set made on the card and on the host, byte-equal, each scored
    # where it was made (the segmentation in float32, as in that test)
    t0 = time.perf_counter()
    get_cfg = qr.get_cfg_defaults

    def f32_defaults():
        cfg = get_cfg()
        cfg.MODEL.DTYPE = "float32"
        return cfg

    tex, tex_roots = {}, {}
    qr.get_cfg_defaults = f32_defaults
    try:
        for where, d in (("card", device), ("host", "cpu")):
            tex_roots[where] = Path(qr.ensure_frozen_set(
                str(work / f"tex_{where}"), n=TEX_TRIADS, img_size=TEX_SIZE,
                textured=True, device=d))
            tex[where] = qr.eval_e2e_repair(
                str(tex_roots[where]), TEX_TRIADS, batch=TEX_TRIADS,
                img_size=TEX_SIZE, mask_mode="tight", device=d)
    finally:
        qr.get_cfg_defaults = get_cfg
    tex_differ = []
    for sub in ("watermarked", "clean", "masks"):
        names = sorted(os.listdir(tex_roots["host"] / sub))
        if sorted(os.listdir(tex_roots["card"] / sub)) != names:
            tex_differ.append(f"{sub}: names")
            continue
        tex_differ += [f"{sub}/{n}" for n in _same_files(
            tex_roots["host"] / sub, tex_roots["card"] / sub, names)]
    if tex_differ:
        failures.append(f"textured {TEX_SIZE}² set card vs host: "
                        f"{tex_differ}")
    tex_digest = _set_digest(tex_roots["card"])
    if tex_digest != TEX_SET_SHA256:
        failures.append(f"textured {TEX_SIZE}² set: digest {tex_digest}, "
                        f"not the known {TEX_SET_SHA256}")
    card, host = tex["card"], tex["host"]
    tex_err = max(abs(card[e][k] - host[e][k])
                  for e in ("floor", "pushpull", "lama")
                  for k in ("psnr_to_clean_db", "region_psnr_db"))
    if tex_err > TEX_DB_TOL:
        failures.append(f"textured {TEX_SIZE}² tight repair: card vs host "
                        f"{tex_err} dB: {card} / {host}")
    if card["lama"]["engine_used"] != "ffc-lama" or not \
            card["lama"]["psnr_to_clean_db"] > \
            card["floor"]["psnr_to_clean_db"]:
        failures.append(f"textured {TEX_SIZE}² tight LaMa repair not above "
                        f"the no-op floor: {card}")
    tex_s = time.perf_counter() - t0
    log("quality_textured_witness", size=TEX_SIZE, triads=TEX_TRIADS,
        mask_mode="tight", seg_dtype="float32", files_equal_host=True,
        set_sha256=tex_digest, set_equals_known=tex_digest ==
        TEX_SET_SHA256,
        card=card, host=host, card_vs_host_max_abs_db=tex_err,
        gate_db=TEX_DB_TOL, seconds=tex_s)
    # (c) the calibration, into the work directory
    cdir = work / "calib"
    sidecar = cdir / "seg_unet_resnet34.quant.json"
    t0 = time.perf_counter()
    calibrate_quant.calibrate("Unet", n_images=calib_images,
                              batch=CALIB_BATCH, img_size=size,
                              workdir=str(cdir), out=str(sidecar),
                              device=device)
    sync()
    calib_s = time.perf_counter() - t0
    weights = shipping.seg_weights_path("Unet", "resnet34")
    new = quant.load_scales(str(sidecar))
    shipped = quant.load_scales(quant.quant_sidecar_path(str(weights)))
    meta = quant.load_sidecar_meta(str(sidecar))
    if sorted(new) != sorted(shipped):
        failures.append(f"calibration keys differ from the shipped "
                        f"sidecar's: {sorted(set(new) ^ set(shipped))}")
    if not all(math.isfinite(v) and v > 0 for v in new.values()):
        failures.append("calibration amax not finite and > 0")
    if meta.get("weights_sha256") != calibrate_quant.file_sha256(
            str(weights)):
        failures.append(f"sidecar sha256 {meta} is not the weights'")
    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.DATA.IMG_SIZE = "Unet", size
    pred = WatermarkPredictor(cfg, device=device)
    # the smooth tier's first held-out triads, where the masks cover a
    # real share of the pixels
    triads = list(qr._load_triads(str(qdir / "heldout"), BATCH, size, dev))
    images = torch.stack([t[1] for t in triads]).float() / 255.0
    gt_fraction = torch.stack([t[3] > 127 for t in triads]).float().mean()

    def int8_masks(scales):
        with torch.inference_mode(), quant.quant_int8(scales):
            logits = pred.model(pred._normalize(images))
        return torch.sigmoid(logits[..., 0]) > cfg.PREDICT.THRESHOLD

    def iou(a, b):
        return ((a & b).sum() / (a | b).sum().clamp(min=1)).item()

    k8.reset_launch_counts()
    mask_new = int8_masks(new)
    calib_convs = k8.conv_s8.launches
    mask_old = int8_masks(shipped)
    mask_broken = int8_masks({k: v * CALIB_BROKEN
                              for k, v in shipped.items()})
    agree = (mask_new == mask_old).float().mean().item()
    iou_new, iou_broken = iou(mask_new, mask_old), iou(mask_broken,
                                                       mask_old)
    ratios = sorted(new[k] / shipped[k] for k in shipped if k in new)
    if calib_convs != INT8_CONVS["unet"]:
        failures.append(f"the int8 Unet forward launched uwt_conv_s8 "
                        f"{calib_convs} times")
    if agree < CALIB_AGREE:
        failures.append(f"new and shipped sidecars' masks agree on "
                        f"{agree:.5f} of pixels")
    if not iou_new >= CALIB_IOU > iou_broken:
        failures.append(f"masks' IoU with the shipped sidecar's: new "
                        f"{iou_new:.4f}, every amax x {CALIB_BROKEN} "
                        f"{iou_broken:.4f} (gate {CALIB_IOU})")
    log("calibrate_quant", images=calib_images, batch=CALIB_BATCH,
        seconds=calib_s, scales=len(new), keys_equal_shipped=sorted(new) ==
        sorted(shipped), weights_sha256_bound=True,
        amax_ratio_to_shipped={"min": ratios[0],
                               "median": ratios[len(ratios) // 2],
                               "max": ratios[-1]},
        int8_forward_conv_launches=calib_convs,
        mask_images=f"heldout, first {len(triads)}",
        mask_agreement_with_shipped=agree,
        mask_iou_with_shipped=iou_new,
        broken_amax_factor=CALIB_BROKEN,
        broken_mask_iou_with_shipped=iou_broken, iou_gate=CALIB_IOU,
        mask_fraction=mask_new.float().mean().item(),
        shipped_mask_fraction=mask_old.float().mean().item(),
        broken_mask_fraction=mask_broken.float().mean().item(),
        gt_mask_fraction=gt_fraction.item())
    del pred
    # (d) the SD3 and FLUX shells on SHELL_FILES of 3d's files
    native = latent_diffusion.default_weights_path() is not None
    sin = work / "shells_in"
    sin.mkdir(exist_ok=True)
    for name in shell_files:
        shutil.copy(work / "in" / f"{name}.png", sin / f"{name}.png")
    sd = SDWatermarkRemover(device=device)
    t0 = time.perf_counter()
    sd_rows = []
    for name in shell_files:
        img = read_bgr(str(sin / f"{name}.png"), dev)
        mask = sd.detect_text_regions(img)
        rep = sd.remove_watermark_auto(img)
        keep = mask <= 127
        sd_rows.append({"file": name, "rung": sd.rung,
                        "mask_fraction": float((mask > 127).mean()),
                        "outside_unchanged": bool(np.array_equal(
                            rep[keep], img[keep]))})
    sd_s = time.perf_counter() - t0
    flux = FluxProcessor(device=device)
    rungs = []
    real_text = flux.remove_text_watermark

    def text_removal(img):  # the rung of each file
        res = real_text(img)
        rungs.append(flux.rung)
        return res

    flux.remove_text_watermark = text_removal
    t0 = time.perf_counter()
    counts = flux.process_batch(str(sin), str(work / "flux_out"),
                                mode="text")
    flux_s = time.perf_counter() - t0
    flux_rows = []
    for name, rung in zip(shell_files, rungs):
        img = read_bgr(str(sin / f"{name}.png"), dev)
        rep = read_bgr(str(work / "flux_out" / f"{name}.png"), dev)
        mask = flux._text_mask(img)
        keep = mask <= 127
        flux_rows.append({"file": name, "rung": rung,
                          "mask_fraction": float((mask > 127).mean()),
                          "outside_unchanged": bool(np.array_equal(
                              rep[keep], img[keep]))})
    for shell, rows in (("sd3", sd_rows), ("flux", flux_rows)):
        for row in rows:
            if not row["outside_unchanged"]:
                failures.append(f"{shell} {row['file']}: pixels outside "
                                f"the mask changed")
            if row["rung"] == "pushpull" and native:
                failures.append(f"{shell} {row['file']}: push-pull ran "
                                f"with latent_diffusion.npz present")
    if counts["processed"] != len(shell_files) or counts["failed"]:
        failures.append(f"flux process_batch: {counts}")
    log("diffusion_shells", files=list(shell_files),
        latent_diffusion_weights=native, sd3=sd_rows, sd3_s=sd_s,
        flux=flux_rows, flux_counts=counts, flux_s=flux_s)
    if failures:
        raise AssertionError("phase 3k: " + "; ".join(failures))
    return {"timing": {"report_wall_s": report_s,
                       "report_section_s": dict(sections),
                       "frozen_set_images_per_s":
                           frozen_files / sections["frozen_set"],
                       "host_frozen_set_s": host_s,
                       "textured_witness_s": tex_s,
                       "calibration_s": calib_s, "sd3_s": sd_s,
                       "flux_s": flux_s,
                       "phase_s": time.perf_counter() - t_phase},
            "launches": launches}


# phase 3l: (a) the .pth round trip's files from 3d's folder; (b) the
# smp-layout UNet++ timed on BATCH x SIZE², its logits card against CPU on
# one SMP_CHECK_SIZE² image; (c) big-lama timed on BATCH x SIZE², card
# against CPU on one LAMA_CHECK_SIZE² image, with its residual branches'
# last BatchNorm scaled by BIG_LAMA_DAMP and its head scaled so the seeded
# logits have the std BIG_LAMA_LOGIT_STD on the first image (an untrained
# 18-block stack otherwise saturates the sigmoid), and the share of hole
# pixels inside (0.01, 0.99) at least BIG_LAMA_UNSATURATED; (d) the blurred
# dataset over BLUR_FILES of 3h's pairs, `train --use-blurred-mask` over
# BLUR_TRAIN_FILES of them (16 train and 4 val at batch 8: 2 steps), and
# augment_sample with each gather warp on BATCH x SIZE²
PTH_CLI_FILES = ("a00", "a01", "a02", "a06")
SMP_CHECK_SIZE, LAMA_CHECK_SIZE = 256, 128
BIG_LAMA_DAMP, BIG_LAMA_LOGIT_STD, BIG_LAMA_UNSATURATED = 0.1, 1.0, 0.9
BLUR_FILES, BLUR_TRAIN_FILES = 8, 20
# float32 card against CPU, TF32 off: the UNet++ logits to 1e-3 of their
# largest magnitude (test_torch_models.py's 1e-3 at logits near 1), the
# big-lama output to 1e-3 (3c's LaMa tolerance); the gather warps' images
# to WARP_ATOL but for a WARP_FLIPS share of values (a grid coordinate at a
# rounding boundary in its last bits takes the neighbour), masks agreeing
# on >= 1 - WARP_FLIPS of pixels
SMP_LOGIT_RTOL, BIG_LAMA_TOL = 1e-3, 1e-3
WARP_ATOL, WARP_FLIPS = 1e-4, 1e-3
PEAK_FP32_FLOPS_PER_S = 67e12  # outside the tensor cores (TF32 is off)


def big_lama_segment(name: str) -> str:
    """The part of BigLamaGenerator that its module `name` ('model.N...')
    is in."""
    i = int(name.split(".")[1])
    return ("stem_down" if i <= 4 else "ffc_blocks" if i <= 22
            else "up" if i <= 32 else "head")


def big_lama_cpu_output(ckpt: str, size: int, seed: int):
    """A host worker's big-lama: the checkpoint loaded on the CPU, one
    size² image and its logo holes (utils/synthetic, seed); returns the
    output as a numpy array."""
    import torch
    from unet_watermark_tpu_torch.inference import engines
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    torch.set_num_threads(3)
    model, name = engines.load_lama(ckpt, "big-lama", "cpu")
    if name != "big-lama-torch":
        raise AssertionError(f"{ckpt} loads as {name} on the CPU")
    imgs, logos = watermarked_images(1, size, seed=seed)
    with torch.inference_mode():
        return model(torch.from_numpy(imgs),
                     torch.from_numpy(logos)[..., None]).numpy()


def blurred_cpu_masks(root: str, masks: str, size: int):
    """A host worker's blurred val-mode dataset on the CPU: every item's
    mask at size² (the generated soft masks cached in `masks`)."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.data.dataset import WatermarkDataset

    torch.set_num_threads(3)
    ds = WatermarkDataset(os.path.join(root, "watermarked"),
                          os.path.join(root, "clean"), masks, img_size=size,
                          mode="val", use_blurred_mask=True, device="cpu")
    return np.stack([ds[i][1] for i in range(len(ds))])


def seeded_big_lama(seed: int, dev, probe):
    """The 18-block generator drawn by factory.init_model (seed), each
    residual branch's last BatchNorm scaled by BIG_LAMA_DAMP, then its head
    scaled so the pre-sigmoid logits of probe = (images, holes) have the
    std BIG_LAMA_LOGIT_STD; float32 on `dev`."""
    import torch
    from unet_watermark_tpu_torch.models.factory import init_model
    from unet_watermark_tpu_torch.models.lama_import import (
        BigLamaGenerator, FFCResnetBlock)

    model = init_model(BigLamaGenerator(), seed).to(dev).eval()
    with torch.no_grad():
        for block in model.model:
            if isinstance(block, FFCResnetBlock):
                block.conv2.bn_l.weight.mul_(BIG_LAMA_DAMP)
                block.conv2.bn_g.weight.mul_(BIG_LAMA_DAMP)
        img, hole = (t.permute(0, 3, 1, 2) for t in probe)
        x = torch.cat([img * (1 - hole), hole], dim=1)
        head = model.model[-2]
        logits = model.model[:-1](x)  # the head's output, before Sigmoid
        head.weight.mul_(BIG_LAMA_LOGIT_STD / logits.std())
        head.bias.zero_()
    return model


def checkpoint_phase(work: Path, seed: int, dev) -> dict:
    """Phase 3l: the reference's checkpoint formats and the blurred
    training masks on the card. (a) The shipped UNet++ written as a .pth
    (export_pth) and `repair --no-ocr --model <it>.pth` on PTH_CLI_FILES of
    3d's folder: every PNG it writes equal byte for byte to the same run
    with the shipped .npz, K1 and K2 launched. (b) An smp-layout
    UNet++/resnet34 (seeded weights, a bare state_dict .pth) detected by
    WatermarkPredictor, its default fused fn timed in turns with the
    canonical decoder's, its float32 logits on the card against the CPU's.
    (c) A seeded 18-block big-lama saved as a saicinpainting best.ckpt
    (generator.model.* keys and one discriminator tensor, dropped on load),
    loaded through PREDICT.INPAINT_WEIGHTS (engine "ffc-big-lama-torch"),
    the fused fn and the generator timed beside FFC-LaMa's, its share of
    the fp32 peak, the card against the CPU (a host worker). (d) The
    blurred val-mode dataset on the card against the CPU (a host worker)
    byte for byte, K1 launched; `train --use-blurred-mask` for one epoch
    of 2 steps; apply_params with each gather warp on the card against the
    CPU."""
    import copy
    import filecmp

    import numpy as np
    import torch
    from unet_watermark_tpu_torch.configs import (DEFAULT_CONFIG,
                                                  get_cfg_defaults)
    from unet_watermark_tpu_torch.data.dataset import WatermarkDataset
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.models import torch_import
    from unet_watermark_tpu_torch.models.convert import load_flax_weights
    from unet_watermark_tpu_torch.models.factory import (
        create_model_from_config, init_model)
    from unet_watermark_tpu_torch.models.unet import SMPUnetPlusPlusDecoder
    from unet_watermark_tpu_torch.inference import engines
    from unet_watermark_tpu_torch.ops import augment as aug
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.utils.shipping import load_npz, resolve
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    t_phase = time.perf_counter()
    root = work / "ckpt_phase"
    root.mkdir()
    images_np, logos_np = watermarked_images(BATCH, SIZE, seed=seed + 41,
                                             clean=2)
    images = torch.from_numpy(images_np).to(dev)

    # (c, first) the seeded big-lama, written where the host worker reads
    # it while the card works
    probe = tuple(torch.from_numpy(a).to(dev) for a in (
        images_np[:1], logos_np[:1, ..., None].astype(np.float32)))
    t0 = time.perf_counter()
    lama = seeded_big_lama(seed, dev, probe)
    ckpt = root / "best.ckpt"
    sd = {"generator." + k: v.cpu() for k, v in lama.state_dict().items()}
    sd["discriminator.model0.0.weight"] = torch.zeros(64, 3, 4, 4)
    torch.save({"state_dict": sd, "epoch": 0}, str(ckpt))
    ckpt_s = time.perf_counter() - t0
    ckpt_mib = ckpt.stat().st_size / 2 ** 20
    del sd
    blur_root = root / "blur"
    for sub in ("watermarked", "clean"):
        (blur_root / sub).mkdir(parents=True)
        for p in sorted((work / "train_data" / sub).iterdir())[:BLUR_FILES]:
            shutil.copy(p, blur_root / sub / p.name)
    with host_pool(2) as pool:
        lama_cpu = pool.submit(big_lama_cpu_output, str(ckpt),
                               LAMA_CHECK_SIZE, seed + 43)
        blur_cpu = pool.submit(blurred_cpu_masks, str(blur_root),
                               str(root / "blur_masks_cpu"), SIZE)

        # (a) the .pth round trip through the repair command
        cfg = get_cfg_defaults()
        shipped = resolve("seg", cfg=cfg)
        model = create_model_from_config(cfg)
        load_flax_weights(model, load_npz(shipped))
        pth = root / "unet_watermark.pth"
        torch_import.export_pth(str(pth), cfg, model, epoch=0)
        del model
        pin = root / "pth_in"
        pin.mkdir()
        for stem in PTH_CLI_FILES:
            shutil.copy(work / "in" / f"{stem}.png", pin / f"{stem}.png")
        runs = {}
        for name, extra in (("npz", []), ("pth", ["--model", str(pth)])):
            kc.reset_launch_counts()
            argv = ["repair", "--input", str(pin), "--output",
                    str(root / f"out_{name}"), "--no-ocr"] + extra
            rc, wall, _ = run_cli(argv, dev, timer=False)
            summary = json.loads((root / f"out_{name}" /
                                  "repair_summary.json").read_text())
            runs[name] = {"rc": rc, "wall_s": wall,
                          "status": summary.get("status"),
                          "launches": {k.__name__: k.launches
                                       for k in kc.KERNELS}}
        a, b = root / "out_npz", root / "out_pth"
        pngs = sorted(p.relative_to(a) for p in a.rglob("*.png"))
        if [p.relative_to(b) for p in sorted(b.rglob("*.png"))] != pngs:
            raise AssertionError(f"the .pth run wrote other files: "
                                 f"{sorted(b.rglob('*.png'))}")
        differ = [str(p) for p in pngs
                  if not filecmp.cmp(a / p, b / p, shallow=False)]
        if differ or any(r["rc"] or r["status"] != "success"
                         for r in runs.values()) or \
                min(runs["pth"]["launches"].values()) < 1:
            raise AssertionError(f"repair --model .pth: {runs}, files "
                                 f"differing from the .npz run's: {differ}")
        log("pth_repair", weights=Path(shipped).name,
            pth_mib=pth.stat().st_size / 2 ** 20, files=list(PTH_CLI_FILES),
            runs=runs, pngs_equal=len(pngs))

        # (b) the smp-layout UNet++ at full width, seeded
        g = torch.Generator().manual_seed(seed + 42)
        cfg_s = get_cfg_defaults()
        cfg_s.MODEL.DECODER_IMPL = "smp"
        smp = init_model(create_model_from_config(cfg_s), seed + 42)
        with torch.no_grad():
            for m in smp.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.copy_(0.1 * torch.randn(
                        m.running_mean.shape, generator=g))
                    m.running_var.copy_(1.0 + 0.3 * torch.rand(
                        m.running_var.shape, generator=g))
        smp_pth = root / "smp_unetplusplus.pth"
        torch.save(smp.state_dict(), str(smp_pth))  # a bare state_dict
        pred_s = WatermarkPredictor(get_cfg_defaults(),
                                    weights_path=str(smp_pth), device=dev)
        if pred_s.cfg.MODEL.DECODER_IMPL != "smp" or not isinstance(
                pred_s.model.decoder, SMPUnetPlusPlusDecoder) or \
                pred_s.n_weights != len([k for k in smp.state_dict()
                                         if "num_batches" not in k]):
            raise AssertionError("the smp-layout .pth was not detected and "
                                 "loaded whole")
        pred_c = WatermarkPredictor(get_cfg_defaults(), device=dev)
        fused_s, fused_c = (p.make_fused_repair_fn() for p in
                            (pred_s, pred_c))
        # the fused fn's mask stage depends on the masks (the labelling's
        # rounds): the seeded weights' are not a trained model's, so the
        # networks are timed alone too
        turns = {"canonical": [], "smp": []}
        net_turns = {"canonical": [], "smp": []}
        with torch.inference_mode():
            for name in ("canonical", "smp", "smp", "canonical"):
                p = pred_s if name == "smp" else pred_c
                fn = fused_s if name == "smp" else fused_c
                # the seeded weights mark ~half the pixels, whose labelling
                # takes ~0.3 s a call: one call a turn, warmed once
                turns[name].append(cuda_ms(lambda: fn(images), 1,
                                           0 if turns[name] else 1))
                net_turns[name].append(cuda_ms(
                    lambda: p._forward_probs(images), 5))
            mask_fraction = {name: p.predict_masks(images).mean().item()
                             for name, p in (("canonical", pred_c),
                                             ("smp", pred_s))}
        fused_ms = {k: float(np.mean(v)) for k, v in turns.items()}
        network_ms = {k: float(np.mean(v)) for k, v in net_turns.items()}
        small = torch.from_numpy(watermarked_images(
            1, SMP_CHECK_SIZE, seed=seed + 44)[0])
        smp.eval()
        smp_gpu = copy.deepcopy(smp).to(dev)
        with torch.inference_mode():
            want = smp(small)
            got = smp_gpu(small.to(dev)).cpu()
        scale = max(1.0, want.abs().max().item())
        smp_err = (got - want).abs().max().item()
        if smp_err > SMP_LOGIT_RTOL * scale:
            raise AssertionError(f"float32 smp UNet++ logits card vs CPU: "
                                 f"{smp_err} (largest {scale})")
        log("smp_unetplusplus", weights="seeded (a stand-in: it shows the "
            "structure and the speed, not detection quality)",
            detected=pred_s.cfg.MODEL.DECODER_IMPL,
            tensors=pred_s.n_weights, engine=fused_s.engine_used,
            images=[BATCH, SIZE, SIZE, 3], fused_ms=fused_ms,
            fused_turns_ms=turns, img_per_s={k: BATCH / (v / 1e3)
                                             for k, v in fused_ms.items()},
            network_ms=network_ms, network_turns_ms=net_turns,
            raw_mask_fraction=mask_fraction,
            fp32_logits_card_vs_cpu_max_abs=smp_err,
            fp32_logits_largest=scale, check_size=SMP_CHECK_SIZE)
        del pred_s, pred_c, fused_s, fused_c, smp, smp_gpu

        # (c) big-lama through PREDICT.INPAINT_WEIGHTS
        cfg_l = get_cfg_defaults()
        cfg_l.PREDICT.INPAINT_WEIGHTS = str(ckpt)
        t0 = time.perf_counter()
        pred_l = WatermarkPredictor(cfg_l, device=dev)
        fused_big = pred_l.make_fused_repair_fn()
        load_s = time.perf_counter() - t0
        if fused_big.engine_used != "ffc-big-lama-torch":
            raise AssertionError(f"the big-lama .ckpt fills with "
                                 f"{fused_big.engine_used}")
        fused_lama = WatermarkPredictor(get_cfg_defaults(), device=dev) \
            .make_fused_repair_fn()
        big, _ = engines.load_lama(str(ckpt), "big-lama", dev)
        ffc, _ = engines.load_lama(resolve("inpaint"), "lama", dev,
                                   torch.bfloat16)
        holes = torch.from_numpy(logos_np[..., None].astype(np.float32)).to(
            dev)
        with torch.inference_mode():
            repaired, mask = fused_big(images)
            hole = mask > 0
            raw = big.model(torch.cat([
                images.permute(0, 3, 1, 2) * (1 - holes.permute(0, 3, 1, 2)),
                holes.permute(0, 3, 1, 2)], 1))
        keep = ~hole[..., None].expand_as(images)
        if not (torch.isfinite(repaired).all() and torch.equal(
                repaired[keep], images[keep])):
            raise AssertionError("big-lama's fused output: non-finite, or "
                                 "pixels outside the mask changed")
        in_hole = raw[(holes.permute(0, 3, 1, 2) > 0).expand_as(raw)]
        unsat = ((in_hole > 0.01) & (in_hole < 0.99)).float().mean().item() \
            if in_hole.numel() else 0.0
        if unsat < BIG_LAMA_UNSATURATED:
            raise AssertionError(f"big-lama's seeded output is saturated: "
                                 f"{unsat:.3f} of hole pixels in (0.01, "
                                 f"0.99)")
        turns = {"ffc-lama": [], "big-lama": []}
        gen = {"ffc-lama": [], "big-lama": []}
        # big-lama's calls take ~0.4 s and ran above: one call a turn and
        # no warm-up
        with torch.inference_mode():
            for name in ("ffc-lama", "big-lama", "big-lama", "ffc-lama"):
                fn = fused_big if name == "big-lama" else fused_lama
                net = big if name == "big-lama" else ffc
                n_calls, warm = (1, 0) if name == "big-lama" else (3, 3)
                turns[name].append(cuda_ms(lambda: fn(images), n_calls,
                                           warm))
                gen[name].append(cuda_ms(lambda: net(images, holes),
                                         n_calls, warm))
        flops = conv_flops(big, images, holes, segment=big_lama_segment)
        big_ms = float(np.mean(gen["big-lama"]))
        total = sum(flops.values())
        timing = {
            "fused_ms": {k: float(np.mean(v)) for k, v in turns.items()},
            "generator_ms": {k: float(np.mean(v)) for k, v in gen.items()},
            "fused_turns_ms": turns, "generator_turns_ms": gen,
            "big_lama_conv_tflop": total / 1e12,
            "big_lama_conv_tflop_by_part": {k: v / 1e12
                                            for k, v in flops.items()},
            "big_lama_fp32_peak_share": total / (big_ms / 1e3)
            / PEAK_FP32_FLOPS_PER_S}
        timing["img_per_s"] = {k: BATCH / (v / 1e3) for k, v in
                               timing["fused_ms"].items()}
        small_np, logos_s = watermarked_images(1, LAMA_CHECK_SIZE,
                                               seed=seed + 43)
        with torch.inference_mode():
            got = big(torch.from_numpy(small_np).to(dev), torch.from_numpy(
                logos_s)[..., None].to(dev)).cpu().numpy()
        lama_err = float(np.abs(got - lama_cpu.result()).max())
        if lama_err > BIG_LAMA_TOL:
            raise AssertionError(f"float32 big-lama card vs CPU: {lama_err}")
        log("big_lama", checkpoint_mib=ckpt_mib, seed_and_save_s=ckpt_s,
            load_s=load_s, engine=fused_big.engine_used,
            images=[BATCH, SIZE, SIZE, 3],
            parameters=sum(p.numel() for p in big.parameters()),
            hole_unsaturated_share=unsat, **timing,
            fp32_card_vs_cpu_max_abs=lama_err, check_size=LAMA_CHECK_SIZE,
            tf32=torch.backends.cudnn.allow_tf32)
        del pred_l, fused_big, fused_lama, big, ffc, lama

        # (d) the blurred masks: the dataset on the card against the CPU
        kc.reset_launch_counts()
        t0 = time.perf_counter()
        ds = WatermarkDataset(str(blur_root / "watermarked"),
                              str(blur_root / "clean"),
                              str(root / "blur_masks_card"), img_size=SIZE,
                              mode="val", use_blurred_mask=True, device=dev)
        card = np.stack([ds[i][1] for i in range(len(ds))])
        blur_s = time.perf_counter() - t0
        k1 = kc.morph_chain_watermark.launches
        cpu = blur_cpu.result()
    if k1 < len(ds) or not np.array_equal(card, cpu):
        raise AssertionError(f"blurred masks: K1 launched {k1} times for "
                             f"{len(ds)} items; card equals CPU: "
                             f"{np.array_equal(card, cpu)}")
    soft = float(((card > 0) & (card < 255)).mean())
    log("blurred_dataset", items=len(ds), k1_launches=k1,
        card_equals_cpu=True, soft_share=soft, wall_s=blur_s,
        samples_per_s=len(ds) / blur_s)

    # `train --use-blurred-mask`: one epoch of 2 steps at full width
    troot = root / "blur_train"
    for sub in ("watermarked", "clean"):
        (troot / sub).mkdir(parents=True)
        for p in sorted((work / "train_data" / sub).iterdir())[
                :BLUR_TRAIN_FILES]:
            shutil.copy(p, troot / sub / p.name)
    kc.reset_launch_counts()
    tout = root / "blur_train_out"
    argv = ["train", "-c", str(DEFAULT_CONFIG), "--data-dir", str(troot),
            "--epochs", "1", "--use-blurred-mask", "--output-dir",
            str(tout / "logs"), "--model-save-path",
            str(tout / "models" / "m.pth"), "--opts",
            "TRAIN.CHECKPOINT_DIR", str(tout / "ck"),
            "DATA.IMG_SIZE", str(SIZE)]
    rc, wall, _ = run_cli(argv, dev, timer=False)
    history = json.loads((tout / "logs" / "training_history.json")
                         .read_text())
    made = sorted(os.listdir(troot / "masks"))
    train_k1 = kc.morph_chain_watermark.launches  # a mask made, a launch
    if rc != 0 or len(made) != BLUR_TRAIN_FILES or not np.isfinite(
            history["train_loss"]).all() or train_k1 < len(made) or \
            not (tout / "models" / "m.pth").exists():
        raise AssertionError(f"train --use-blurred-mask: rc {rc}, "
                             f"{len(made)} masks, K1 {train_k1}, history "
                             f"{history}")
    log("train_blurred", argv=["train", "--use-blurred-mask"], rc=rc,
        wall_s=wall, masks_made=len(made), k1_launches=train_k1,
        train_loss=history["train_loss"], val_loss=history["val_loss"])

    # augment_sample with each gather warp, card against CPU
    warps = {}
    masks = torch.from_numpy(logos_np[..., None].astype(np.float32))
    for interp in ("nearest_gather", "bilinear"):
        pol = aug.AugmentPolicy(affine_p=1.0, shear_limit=4.0,
                                interpolation=interp)
        params = aug.draw_params(torch.Generator().manual_seed(seed), BATCH,
                                 SIZE, SIZE, pol)
        outs = [aug.apply_params(images.to(where), masks.to(where),
                                 {k: v.to(where) for k, v in params.items()},
                                 pol)
                for where in (dev, torch.device("cpu"))]
        (ig, mg), (ic, mc) = [(a.cpu(), b.cpu()) for a, b in outs]
        far = ((ig - ic).abs() > WARP_ATOL).float().mean().item()
        agree = (mg == mc).float().mean().item()
        warps[interp] = {"max_abs": (ig - ic).abs().max().item(),
                         "share_beyond_atol": far, "mask_agreement": agree}
        if far > WARP_FLIPS or agree < 1 - WARP_FLIPS:
            raise AssertionError(f"{interp} warp card vs CPU: "
                                 f"{warps[interp]}")
    log("augment_warps", images=[BATCH, SIZE, SIZE, 3], **warps)
    return {"timing": {"fused_smp_ms": fused_ms,
                       "network_smp_ms": network_ms, **timing,
                       "blurred_samples_per_s": len(ds) / blur_s,
                       "train_blurred_wall_s": wall,
                       "phase_s": time.perf_counter() - t_phase},
            "launches": runs["pth"]["launches"],
            "blurred_k1_launches": k1 + train_k1}


def check_repair(images, repaired, mask) -> None:
    """The fused fn's output: shapes, finite pixels in [0, 1], a binary mask,
    and every pixel outside the mask unchanged."""
    import torch

    n, s = images.shape[:2]
    if tuple(repaired.shape) != (n, s, s, 3) or tuple(mask.shape) != (n, s, s):
        raise AssertionError(f"shapes {tuple(repaired.shape)}, "
                             f"{tuple(mask.shape)}")
    if not torch.isfinite(repaired).all():
        raise AssertionError("non-finite repaired pixels")
    if repaired.min() < 0 or repaired.max() > 1:
        raise AssertionError("repaired pixels outside [0, 1]")
    if not set(mask.unique().tolist()) <= {0.0, 1.0}:
        raise AssertionError("mask is not binary")
    keep = (mask == 0)[..., None].expand_as(images)
    if not torch.equal(repaired[keep], images[keep]):
        raise AssertionError("pixels outside the mask changed")


def conv_s8_bound(call) -> tuple:
    """(operations, bytes) of one int8 conv that the function must do: 2 per
    multiply-add of its non-zero taps (the lhs-dilated 4x4 conv has 4 an
    output) over the weight's input channels, each input read once (the
    activation at the weight's input channels: the stem's 3, not the 16 of
    its padded operand; weight, scale) and the output written once."""
    from unet_watermark_tpu_torch.ops.kernels import conv_s8 as k8

    xq, wq, scale, kw = call
    n, _, h, w = xq.shape
    cout, cin, kh, kwid = wq.shape
    ho = k8.out_size(h, kh, kw["stride"], kw["padding"], kw["dilation"])
    wo = k8.out_size(w, kwid, kw["stride"], kw["padding"], kw["dilation"])
    taps = 4 if kw["dilation"] == 2 else kh * kwid
    out_bytes = 2 if kw["out_dtype"].is_floating_point and \
        kw["out_dtype"].itemsize == 2 else 4
    ops = 2 * n * ho * wo * cout * cin * taps
    return ops, n * h * w * cin + wq.numel() + 4 * cout + \
        n * ho * wo * cout * out_bytes


def conv_s8_library(call):
    """The one cuDNN call that computes the conv in bf16 on the same
    (integer-valued) operands: conv2d, or for the lhs-dilated conv
    conv_transpose2d with the kernel flipped (stride 2, padding 1)."""
    import torch.nn.functional as F

    xq, wq, scale, kw = call
    xb, wb = xq[:, :wq.shape[1]].bfloat16(), wq.bfloat16()
    if kw["dilation"] == 2:
        wt = wb.flip(2, 3).transpose(0, 1).contiguous()
        return lambda: F.conv_transpose2d(xb, wt, stride=2, padding=1)
    return lambda: F.conv2d(xb, wb, stride=kw["stride"],
                            padding=kw["padding"])


def int8_hooks(real_conv, real_quantize, convs: list, quantizes: list):
    """Wrappers of conv_s8.conv_s8 and conv_s8.quantize_s8 that hold each
    launch bit for bit against its plain version on the card
    (quant.conv_s8_plain, quant.quantize_s8_plain) and record its inputs
    in `convs` and `quantizes`."""
    import torch
    from unet_watermark_tpu_torch.ops import quant

    def conv(xq, wq, scale, **kw):
        y = real_conv(xq, wq, scale, **kw)
        ref = quant.conv_s8_plain(xq, wq, scale, kw["stride"],
                                  kw["padding"], kw["dilation"],
                                  kw["out_dtype"])
        if not torch.equal(y, ref):
            err = (y.float() - ref.float()).abs().max().item()
            raise AssertionError(f"uwt_conv_s8 differs from its plain "
                                 f"version by {err} on {tuple(xq.shape)}"
                                 f" x {tuple(wq.shape)} {kw}")
        convs.append((xq, wq, scale, dict(kw)))
        return y

    def quantize(x, inv, channels=None):
        xq = real_quantize(x, inv, channels)
        if not torch.equal(xq, quant.quantize_s8_plain(x, inv, channels)):
            raise AssertionError(f"uwt_quantize_s8 differs from its plain "
                                 f"version on {tuple(x.shape)} {x.dtype}")
        quantizes.append((x, inv, channels))
        return xq
    return conv, quantize


# phase 3m: the model zoo. (a) the text config as shipped (UNet++ on
# efficientnet-b3, 512², batch 6): TEXT_SAMPLES generated on TEXT_CLEAN
# clean images (12 train and 4 val at TRAIN_RATIO 0.8: one epoch of 2
# steps), `repair -c` on
# TEXT_CLI_FILES (2 of them without a logo); float32 on TEXT_CPU_FILES
# against the same command on the CPU (a host worker). (b) the large
# config (UNet++/resnet50, decoder (1024, ..., 64)) at LARGE_BATCH x
# LARGE_SIZE². (c) the eight other archs with resnet34 at BATCH x SIZE²,
# timed in turns with the shipped Unet and UNet++ (ZOO_WARMUP, ZOO_CALLS a
# turn). (d) UnetTPU's int8 tier, calibrated on ZOO_CALIB_IMAGES.
ZOO_ARCHS = ("UnetTPU", "MAnet", "Linknet", "FPN", "PSPNet", "PAN",
             "DeepLabV3", "DeepLabV3Plus")
TEXT_SAMPLES, TEXT_CLEAN = 16, 8
TEXT_CLI_FILES = ("a00", "a01", "a06", "a07")
TEXT_CPU_FILES = ("a00",)
LARGE_BATCH, LARGE_SIZE = 2, 1024
ZOO_WARMUP, ZOO_CALLS = 1, 3
ZOO_CALIB_IMAGES, ZOO_CALIB_BATCH = 8, 4
# float32 logits card against CPU (TF32 off) at ZOO_CHECK_SIZE², within
# ZOO_LOGIT_RTOL of the largest logit magnitude (at least 1): 3l's
# tolerance for UNet++; the zoo's decoders add no reduction longer than
# a conv's
ZOO_CHECK_SIZE, ZOO_LOGIT_RTOL = 64, 1e-3
# the int8 convs of a forward: resnet50's encoder (the stem, 16
# bottlenecks of 3, 4 downsamples) and UnetTPU (resnet34's 36, the three
# up-blocks' :up and :skip, the refine conv, skip2_reduce, fuse_conv1)
RESNET50_INT8_CONVS, UNETTPU_INT8_CONVS = 53, 45


def _text_cpu_masks(argv):
    """A host worker's `repair` on the CPU: {file: step-1 mask bytes}."""
    import torch
    from unet_watermark_tpu_torch import cli

    torch.set_num_threads(4)
    if cli.main(argv + ["--device", "cpu"]) != 0:
        raise AssertionError(f"repair on the CPU: {argv}")
    out = Path(argv[argv.index("--output") + 1]) / "step1_masks"
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())}


def _zoo_logits_err(model, dev, seed: int) -> tuple:
    """(max |card - CPU|, largest |logit|) of a float32 model's logits at
    2 x ZOO_CHECK_SIZE²."""
    import copy

    import numpy as np
    import torch

    x = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (2, ZOO_CHECK_SIZE, ZOO_CHECK_SIZE, 3)).astype(np.float32))
    model = model.float().eval()
    card = copy.deepcopy(model).to(dev)
    with torch.inference_mode():
        want = model(x)
        got = card(x.to(dev)).cpu()
    return (got - want).abs().max().item(), want.abs().max().item()


def _normalized(images):
    import torch
    from unet_watermark_tpu_torch.ops.augment import (IMAGENET_MEAN,
                                                      IMAGENET_STD)

    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images - mean) / std


def _counts(kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def zoo_text_train(work: str, seed: int) -> dict:
    """3m(a), training (chip_smoke.py runs it in a host worker on the card
    during 3j-3l: its first step pays ~15 s of cuDNN's one-time set-up
    for the channels-last depthwise convs, host work): the text trainer's
    CLI with the shipped text config, its output paths moved into
    work/zoo_phase/text, on TEXT_CLEAN clean images of SIZE² it writes
    (utils/synthetic). Returns the .pth and the fields of its log line."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.text import train_text_watermark as ttw
    from unet_watermark_tpu_torch.utils.image_io import write_png
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    work = Path(work)
    text = work / "zoo_phase" / "text"
    clean = text / "clean"
    clean.mkdir(parents=True)
    imgs, _ = watermarked_images(TEXT_CLEAN, SIZE, seed=seed + 80,
                                 clean=TEXT_CLEAN)
    for i, img in enumerate(imgs):
        write_png(clean / f"c{i:02d}.png", np.rint(img * 255).astype(
            np.uint8))
    yaml = text / "unet_text_watermark.yaml"
    pth = text / "models" / "unet_text_watermark.pth"
    shipped_yaml = Path(ttw.TEXT_CONFIG).read_text()
    key = 'MODEL_SAVE_PATH: "models/unet_text_watermark.pth"'
    if key not in shipped_yaml:
        raise AssertionError(f"the text config changed: no {key}")
    yaml.write_text(shipped_yaml.replace(
        key, f'MODEL_SAVE_PATH: "{pth}"\n  CHECKPOINT_DIR: '
             f'"{text / "checkpoints"}"'))
    cfg = ttw.TextWatermarkTrainer(str(yaml), device="cpu").cfg
    shipped = (cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME, cfg.DATA.IMG_SIZE,
               cfg.TRAIN.BATCH_SIZE, cfg.MODEL.DTYPE, cfg.LOSS.NAME,
               cfg.OPTIMIZER.NAME, cfg.DATA.AUGMENTATION_TYPE)
    if shipped != ("UnetPlusPlus", "efficientnet-b3", SIZE, 6, "bfloat16",
                   "CombinedLoss", "AdamW", "text_watermark"):
        raise AssertionError(f"the text config changed: {shipped}")
    t0 = time.perf_counter()
    result = ttw.main(["--config", str(yaml), "--data-root",
                       str(text / "data"), "--clean-dir", str(clean),
                       "--samples",
                       str(TEXT_SAMPLES), "--epochs", "1", "--output-dir",
                       str(text / "logs")])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    hist = result["history"]
    if result["epochs_run"] != 1 or not np.isfinite(
            hist["train_loss"] + hist["val_loss"]).all() or \
            not pth.exists() or len(os.listdir(
                text / "data" / "watermarked")) != TEXT_SAMPLES:
        raise AssertionError(f"the text trainer: {result['epochs_run']} "
                             f"epochs, history {hist}, {pth} written: "
                             f"{pth.exists()}")
    return {"pth": str(pth), "train_s": train_s, "log": dict(
        config="unet_text_watermark.yaml (paths moved)",
        arch=shipped[0], encoder=shipped[1], size=SIZE, batch=shipped[3],
        samples=TEXT_SAMPLES, steps=int(TEXT_SAMPLES * 0.8) // shipped[3],
        wall_s=train_s, epoch_time_s=hist["epoch_time"],
        train_loss=hist["train_loss"], val_loss=hist["val_loss"],
        where="a host worker on the card, during 3j-3l")}


def _zoo_text_repair(text: Path, work: Path, pth: Path, configs: Path,
                     dev) -> dict:
    """3m(a), serving: `repair -c unet_text_watermark.yaml --model <it>`
    on TEXT_CLI_FILES, then the float32 command on TEXT_CPU_FILES (whose
    CPU twin a host worker runs); returns the card's float32 masks."""
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.utils.image_io import read_gray, read_rgb

    pin = text / "in"
    kc.reset_launch_counts()
    argv = ["repair", "-c", str(configs / "unet_text_watermark.yaml"),
            "--model", str(pth), "--input", str(pin), "--output",
            str(text / "out"), "--no-ocr"]
    rc, wall, _ = run_cli(argv, dev, timer=False)
    launches = _counts(kc.KERNELS)
    summary = json.loads((text / "out" / "repair_summary.json").read_text())
    if rc or summary.get("status") != "success" or \
            min(launches.values()) < 1:
        raise AssertionError(f"repair -c unet_text_watermark.yaml: rc {rc}, "
                             f"{summary.get('status')}, launches {launches}")
    for src in sorted(pin.iterdir()):
        shape = read_rgb(src).shape[:2]
        for sub in ("step1_masks", "masks"):
            p = text / "out" / sub / f"{src.stem}_mask.png"
            if p.exists() and read_gray(p).shape != shape:
                raise AssertionError(f"{p}: {read_gray(p).shape}, the image "
                                     f"{shape}")
    outside = check_outside_masks(pin, text / "out")
    kc.reset_launch_counts()
    rc32, _, _ = run_cli(_text_f32_argv(text, pth, configs, "out_f32"), dev,
                         timer=False)
    f32_launches = _counts(kc.KERNELS)
    card32 = {p.name: p.read_bytes() for p in sorted(
        (text / "out_f32" / "step1_masks").iterdir())}
    if rc32:
        raise AssertionError(f"the float32 text command: rc {rc32}")
    return {"wall_s": wall, "status": summary.get("status"),
            "launches": launches, "f32_launches": f32_launches,
            "outside": outside, "card32": card32}


def _text_f32_argv(text: Path, pth: Path, configs: Path, out: str) -> list:
    """The float32 text command on TEXT_CPU_FILES (the fill push-pull:
    the step-1 masks are compared)."""
    return ["repair", "-c", str(configs / "unet_text_watermark.yaml"),
            "--model", str(pth), "--input", str(text / "in_cpu"),
            "--output", str(text / out), "--no-ocr", "--watermark-model",
            "telea", "--opts", "MODEL.DTYPE", "float32"]


def _zoo_large(root: Path, configs: Path, seed: int, dev) -> dict:
    """3m(b): the large config (module docstring), seeded on the card,
    served from a shipped-format .npz; then its resnet50 encoder in int8
    with every launch held against the plain version."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.configs import (get_cfg_defaults,
                                                  update_config)
    from unet_watermark_tpu_torch.inference import maskproc
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.models.convert import to_flax
    from unet_watermark_tpu_torch.models.factory import (
        count_parameters, create_model_from_config, init_model)
    from unet_watermark_tpu_torch.ops import quant
    from unet_watermark_tpu_torch.ops.kernels import conv_s8 as k8
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.utils.shipping import (save_params_npz,
                                                         seg_weights_filename)
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    cfg = get_cfg_defaults()
    update_config(cfg, configs / "unet_watermark_large.yaml")
    got = (cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME,
           list(cfg.MODEL.DECODER_CHANNELS), cfg.DATA.IMG_SIZE,
           cfg.MODEL.REMAT, cfg.MODEL.DTYPE)
    if got != ("UnetPlusPlus", "resnet50", [1024, 512, 256, 128, 64], 1024,
               True, "bfloat16"):
        raise AssertionError(f"the large config changed: {got}")
    t0 = time.perf_counter()
    with torch.device("meta"):
        seeded = create_model_from_config(cfg)
    # drawn on the card: 94 M draws take ~15 s on the host
    seeded = init_model(seeded.to_empty(device=dev), seed + 51, dev)
    npz = root / seg_weights_filename(cfg.MODEL.NAME, cfg.MODEL.ENCODER_NAME)
    save_params_npz(npz, to_flax(seeded))
    seeded = seeded.cpu()
    pred = WatermarkPredictor(cfg, weights_path=str(npz), device=dev)
    load_s = time.perf_counter() - t0
    fused = pred.make_fused_repair_fn("pushpull")
    images_np, _ = watermarked_images(LARGE_BATCH, LARGE_SIZE, seed=seed + 52)
    images = torch.from_numpy(images_np).to(dev)
    torch.cuda.reset_peak_memory_stats()
    kc.reset_launch_counts()
    with torch.inference_mode():
        repaired, mask = fused(images)
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        tight_launches = _counts(kc.KERNELS)
        check_repair(images, repaired, mask)
        raw = pred.predict_masks(images)
        pred.cfg.PREDICT.MASK_MODE = "parity"
        fused_p = pred.make_fused_repair_fn("pushpull")
        kc.reset_launch_counts()
        repaired_p, mask_p = fused_p(images)
        torch.cuda.synchronize()
        parity_launches = _counts(kc.KERNELS)
        check_repair(images, repaired_p, mask_p)
        for i, mk in enumerate(raw):
            if not (torch.equal(mask[i],
                                maskproc.optimize_watermark_mask_tight(mk))
                    and torch.equal(mask_p[i],
                                    maskproc.optimize_watermark_mask(mk))):
                raise AssertionError(f"large config: mask {i} differs from "
                                     f"the plain chains")
        if min(parity_launches.values()) < 1:
            raise AssertionError(f"large config: K1/K2 {parity_launches}")
        net = [cuda_ms(lambda: pred._forward_probs(images), ZOO_CALLS,
                       ZOO_WARMUP) for _ in range(2)]
    err, scale = _zoo_logits_err(seeded, dev, seed + 54)
    if err > ZOO_LOGIT_RTOL * max(1.0, scale):
        raise AssertionError(f"large config float32 logits card vs CPU: "
                             f"{err} (largest {scale})")
    del seeded, fused, fused_p, repaired, repaired_p

    # the resnet50 encoder alone in int8 (the decoder's convs are the
    # shape classes of UNet++/resnet34): its 1x1 convs at stride 1 and 2
    # (Cin to 2048) are new to uwt_conv_s8
    x = _normalized(images).permute(0, 3, 1, 2).to(torch.bfloat16)
    store: dict = {}
    with torch.inference_mode(), quant.quant_observe(store):
        pred.model.encoder(x)
    scales = {k: v for k, v in store.items() if k.startswith("encoder/")}
    plans = quant.build_plans(pred.model.encoder, scales)
    real, real_quantize = k8.conv_s8, k8.quantize_s8
    calls, quantized = [], []
    k8.reset_launch_counts()
    k8.conv_s8, k8.quantize_s8 = int8_hooks(real, real_quantize, calls,
                                            quantized)
    try:
        with torch.inference_mode(), quant.quant_int8(scales, plans):
            pred.model.encoder(x)
        torch.cuda.synchronize()
    finally:
        k8.conv_s8, k8.quantize_s8 = real, real_quantize
    int8 = (real.launches, real_quantize.launches)
    if int8 + (len(scales), len(plans)) != (RESNET50_INT8_CONVS,) * 4:
        raise AssertionError(f"resnet50 int8: {int8} launches, {len(plans)} "
                             f"plans")
    log("large_config", config="unet_watermark_large.yaml",
        weights="seeded (a stand-in: structure and speed, not quality)",
        parameters=count_parameters(pred.model), load_s=load_s,
        images=[LARGE_BATCH, LARGE_SIZE, LARGE_SIZE, 3],
        dtype=cfg.MODEL.DTYPE, network_ms=float(np.mean(net)),
        network_turns_ms=net, peak_mib=peak_mib,
        raw_mask_fraction=raw.mean().item(), tight_launches=tight_launches,
        parity_launches=parity_launches, masks_equal_plain_chains=True,
        fp32_logits_card_vs_cpu_max_abs=err, fp32_logits_largest=scale,
        check_size=ZOO_CHECK_SIZE, resnet50_int8_convs=int8[0],
        every_launch_equals_plain=True)
    return {"network_ms": float(np.mean(net)), "peak_mib": peak_mib,
            "k1k2": parity_launches, "int8": int8, "calls": calls}


def _zoo_archs(seed: int, dev) -> dict:
    """3m(c): the other archs with resnet34, seeded, bf16, at BATCH x
    SIZE², timed in turns with the shipped Unet and UNet++ (ZOO_WARMUP,
    then ZOO_CALLS a turn); each one's float32 logits card against CPU."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.configs import get_cfg_defaults
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.models.factory import (
        count_parameters, create_model_from_config, init_model)
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    images_np, _ = watermarked_images(BATCH, SIZE, seed=seed + 53)
    images = torch.from_numpy(images_np).to(dev)
    x = _normalized(images)
    nets, checks, params = {}, {}, {}
    for name in ("Unet", "UnetPlusPlus"):
        cfg = get_cfg_defaults()
        cfg.MODEL.NAME = name
        nets[name] = WatermarkPredictor(cfg, device=dev).model
    for i, arch in enumerate(ZOO_ARCHS):
        cfg = get_cfg_defaults()
        cfg.MODEL.NAME = arch
        with torch.device("meta"):
            model = create_model_from_config(cfg)
        model = init_model(model.to_empty(device=dev), seed + 60 + i,
                           dev).cpu()
        params[arch] = count_parameters(model)
        err, scale = _zoo_logits_err(model, dev, seed + 70 + i)
        checks[arch] = {"max_abs": err, "largest": scale}
        if err > ZOO_LOGIT_RTOL * max(1.0, scale):
            raise AssertionError(f"{arch} float32 logits card vs CPU: {err} "
                                 f"(largest {scale})")
        nets[arch] = model.to(dev, torch.bfloat16).to(
            memory_format=torch.channels_last).eval()
    order = list(nets)
    turns = {name: [] for name in order}
    with torch.inference_mode():
        for name in order + order[::-1]:
            turns[name].append(cuda_ms(lambda: nets[name](x), ZOO_CALLS,
                                       ZOO_WARMUP))
    network_ms = {k: float(np.mean(v)) for k, v in turns.items()}
    log("zoo_networks", images=[BATCH, SIZE, SIZE, 3], dtype="bfloat16",
        encoder="resnet34", weights="seeded; Unet and UnetPlusPlus shipped",
        network_ms=network_ms, network_turns_ms=turns, parameters=params,
        fp32_logits_card_vs_cpu=checks, check_size=ZOO_CHECK_SIZE)
    return {"network_ms": network_ms, "unettpu": nets["UnetTPU"],
            "images": images, "x": x}


def _zoo_int8(root: Path, work: Path, tpu_model, images, x, r50_calls,
              dev) -> dict:
    """3m(d): UnetTPU calibrated (calibrate_quant on ZOO_CALIB_IMAGES of
    3k's calibration set), its fused fn under PREDICT.QUANT with every
    launch held against the plain version, the network in turns with
    bf16, and the conv shapes new to uwt_conv_s8 (resnet50's 1x1 convs,
    UnetTPU's stride-2 skip2_reduce) one by one beside cuDNN's bf16 conv
    and their bounds."""
    import numpy as np
    import torch
    from unet_watermark_tpu_torch.configs import get_cfg_defaults
    from unet_watermark_tpu_torch.inference import maskproc
    from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
    from unet_watermark_tpu_torch.models.convert import to_flax
    from unet_watermark_tpu_torch.ops import quant
    from unet_watermark_tpu_torch.ops.kernels import conv_s8 as k8
    from unet_watermark_tpu_torch.scripts import calibrate_quant
    from unet_watermark_tpu_torch.utils.shipping import (save_params_npz,
                                                         seg_weights_filename)

    tpu = root / seg_weights_filename("UnetTPU", "resnet34")
    save_params_npz(tpu, to_flax(tpu_model))
    sidecar = Path(quant.quant_sidecar_path(str(tpu)))
    t0 = time.perf_counter()
    calibrate_quant.calibrate("UnetTPU", "resnet34", weights=str(tpu),
                              img_size=SIZE, n_images=ZOO_CALIB_IMAGES,
                              batch=ZOO_CALIB_BATCH,
                              workdir=str(work / "calib"), out=str(sidecar),
                              device=dev)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    cfg = get_cfg_defaults()
    cfg.MODEL.NAME, cfg.PREDICT.QUANT = "UnetTPU", True
    pq = WatermarkPredictor(cfg, weights_path=str(tpu), device=dev)
    if len(pq._quant_plans or {}) != UNETTPU_INT8_CONVS:
        raise AssertionError(f"UnetTPU: {len(pq._quant_plans or {})} int8 "
                             f"plans")
    fused = pq.make_fused_repair_fn("pushpull")
    real, real_quantize = k8.conv_s8, k8.quantize_s8
    calls, quantized = [], []
    k8.reset_launch_counts()
    k8.conv_s8, k8.quantize_s8 = int8_hooks(real, real_quantize, calls,
                                            quantized)
    try:
        repaired, mask = fused(images)
        torch.cuda.synchronize()
    finally:
        k8.conv_s8, k8.quantize_s8 = real, real_quantize
    int8 = (real.launches, real_quantize.launches)
    if int8 != (UNETTPU_INT8_CONVS,) * 2:
        raise AssertionError(f"UnetTPU int8 fused fn: {int8} launches")
    check_repair(images, repaired, mask)
    with torch.inference_mode():
        raw = pq.predict_masks(images)
        raw_b = (torch.sigmoid(tpu_model(x)[..., 0])
                 > cfg.PREDICT.THRESHOLD).float()
        ms = {"bf16": [], "int8": []}
        for tier in ("bf16", "int8", "int8", "bf16"):
            fn = (lambda: pq._forward_probs(images)) if tier == "int8" \
                else (lambda: tpu_model(x))
            ms[tier].append(cuda_ms(fn, ZOO_CALLS, ZOO_WARMUP))
    for i, mk in enumerate(raw):
        if not torch.equal(mask[i],
                           maskproc.optimize_watermark_mask_tight(mk)):
            raise AssertionError(f"UnetTPU int8 mask {i} differs from the "
                                 f"plain tight chain")
    shapes = {}
    for model, c in [("resnet50", c) for c in r50_calls] + [
            ("UnetTPU", c) for c in calls]:
        xq, wq, scale, kw = c
        cout, cin, kh, kwid = wq.shape
        cls = f"{kh}x{kwid}/s{kw['stride']}"
        # resnet50's 1x1 convs and UnetTPU's skip2_reduce
        if not (kh == 1 if model == "resnet50" else (
                kh == 3 and kw["stride"] == 2
                and xq.shape[2] == SIZE // 2 and cout == 64)):
            continue
        key = (model, cls, cin, cout, tuple(xq.shape[2:]))
        if key in shapes:
            continue
        ops, nbytes = conv_s8_bound(c)
        shapes[key] = {
            "class": cls, "model": model, "cin": cin, "cout": cout,
            "input": [xq.shape[0], *xq.shape[2:]],
            "ms": cuda_ms(lambda: real(xq, wq, scale, **kw), 20),
            "cudnn_bf16_ms": cuda_ms(conv_s8_library(c), 20),
            "bound_ms": max(ops / PEAK_INT8_OPS_PER_S,
                            nbytes / PEAK_BYTES_PER_S) * 1e3}
    log("zoo_int8", arch="UnetTPU", images=[BATCH, SIZE, SIZE, 3],
        calibration_images=ZOO_CALIB_IMAGES, calibration_s=calib_s,
        scales=len(pq._quant_scales), launches=UNETTPU_INT8_CONVS,
        every_launch_equals_plain=True, every_quantize_equals_plain=True,
        int8_vs_bf16_mask_agreement=(raw == raw_b).float().mean().item(),
        network_turns_ms=ms, new_shapes=list(shapes.values()))
    return {"int8": int8, "bf16_ms": float(np.mean(ms["bf16"])),
            "int8_ms": float(np.mean(ms["int8"]))}


def zoo_phase(work: Path, seed: int, dev, trained=None) -> dict:
    """Phase 3m: the model zoo on the card (module docstring); `trained`
    is zoo_text_train's result (chip_smoke.py trains in a host worker
    during 3j-3l), or None to train here. Returns the K1/K2 and int8 launches and the
    timing fields."""
    from unet_watermark_tpu_torch.text import train_text_watermark as ttw

    t_phase = time.perf_counter()
    if trained is None:
        trained = zoo_text_train(str(work), seed)
    log("text_trainer", **trained["log"])
    root = work / "zoo_phase"
    text = root / "text"
    for d in (text / "in", text / "in_cpu"):
        d.mkdir(parents=True)
    for stem in TEXT_CLI_FILES:
        shutil.copy(work / "in" / f"{stem}.png", text / "in" / f"{stem}.png")
        if stem in TEXT_CPU_FILES:
            shutil.copy(work / "in" / f"{stem}.png",
                        text / "in_cpu" / f"{stem}.png")
    configs = Path(ttw.TEXT_CONFIG).parent
    # the CPU's float32 text command in a host worker while the card works
    with host_pool(1) as pool:
        pth = Path(trained["pth"])
        cpu_masks = pool.submit(_text_cpu_masks, _text_f32_argv(
            text, pth, configs, "out_cpu"))
        served = _zoo_text_repair(text, work, pth, configs, dev)
        large = _zoo_large(root, configs, seed, dev)
        archs = _zoo_archs(seed, dev)
        int8 = _zoo_int8(root, work, archs["unettpu"], archs["images"],
                         archs["x"], large["calls"], dev)
        cpu = cpu_masks.result()
    cfg = ttw.TextWatermarkTrainer(device="cpu").cfg  # the shipped text
    card32 = served["card32"]
    equal = sorted(k for k in card32 if cpu.get(k) == card32[k])
    if sorted(cpu) != sorted(card32) or not equal:
        raise AssertionError(f"float32 text masks card against CPU: files "
                             f"{sorted(card32)} / {sorted(cpu)}, equal "
                             f"{equal}")
    log("repair_text_config", argv=["repair", "-c",
                                    "unet_text_watermark.yaml", "--model",
                                    "<trained>.pth", "--no-ocr"],
        files=list(TEXT_CLI_FILES), wall_s=served["wall_s"],
        status=served["status"], launches=served["launches"],
        outside_mask_unchanged_files=served["outside"],
        multi_scale=cfg.PREDICT.MULTI_SCALE_TEST,
        edge_refinement=cfg.PREDICT.EDGE_REFINEMENT,
        float32_masks_equal_cpu=equal, float32_files=sorted(card32))
    k1k2 = {k: served["launches"][k] + served["f32_launches"][k]
            + large["k1k2"][k] for k in served["launches"]}
    return {"launches": k1k2,
            "int8_launches": {
                "uwt_conv_s8": large["int8"][0] + int8["int8"][0],
                "uwt_quantize_s8": large["int8"][1] + int8["int8"][1]},
            "timing": {"large_network_ms": large["network_ms"],
                       "large_peak_mib": large["peak_mib"],
                       "zoo_network_ms": archs["network_ms"],
                       "unettpu_int8_network_ms": int8["int8_ms"],
                       "unettpu_bf16_network_ms": int8["bf16_ms"],
                       "text_train_s": trained["train_s"],
                       "text_repair_s": served["wall_s"],
                       "phase_s": time.perf_counter() - t_phase}}


# phase 3n: the data-parallel path in an NCCL world of one. Inside the group
# BatchNorm takes the path a group of more than one rank takes
# (models/encoders.global_batch_stats: flax's mean(x²) - mean(x)² in float32
# from the sums an all-reduce adds) where the step without a group runs the
# library's batch norm. The group's train steps against the steps without a
# group: 3h's config and folder, 2 steps from one seeded state, in float32 and
# in the config's bf16. bf16 gates: step 1's loss within SHARD_LOSS1_RTOL,
# every loss within SHARD_LOSS_RTOL, step 1's running statistics within
# SHARD_STATS_RTOL of each buffer's largest value; its gradients and parameters
# are reported (the two bf16 forwards round a BatchNorm output 1 ulp apart here
# and there, and the network carries that on). Float32 gates: every step's loss
# within SHARD32_LOSS_RTOL, step 1's gradients within SHARD32_GRAD_RTOL of
# their global norm, step 1's running statistics within SHARD32_STATS_RTOL of
# each buffer's largest value, and the parameters after the steps within
# SHARD32_UPDATE_RTOL of the update's norm (their distance over the distance
# the steps moved them). The bounds are 3-15x the H100's readings at this seed
# (float32: losses 0 and 1.7e-5, gradients 5.2e-3, statistics 6.9e-7,
# parameters 0.030; bf16 step 1's loss 3.1e-6, step 2's 1.1e-3, statistics
# 1.7e-3). Float32 differs at all because flax's variance cancels where a
# channel's mean is large against its spread (cuDNN's does not), and Adam turns
# the sign of a near-zero gradient into a whole step; a gradient summed twice
# or cut off at the statistics reads of order 1. Then the `train` command runs
# one epoch in the group on the host pipeline (DATA.DEVICE_CACHE off: a mesh,
# pinned copies, the broadcast state, the barriers, rank 0's files). The tiled
# map of a 1080 x 1920 image through predict_tiled_sharded equals
# predict_tiled's bit for bit (the same tiles in the same calls, the same
# blend, then the all-gather); the sharded conv equals the unsharded one within
# SHARD_CONV_RTOL of its largest value (cuDNN may pick another algorithm for
# the padded shard).
SHARD_STEPS = 2
SHARD_LOSS1_RTOL, SHARD_LOSS_RTOL, SHARD_STATS_RTOL = 3e-5, 5e-3, 5e-3
SHARD32_LOSS_RTOL, SHARD32_GRAD_RTOL = 1e-4, 2e-2
SHARD32_STATS_RTOL, SHARD32_UPDATE_RTOL = 1e-5, 0.1
SHARD_CONV_RTOL = 1e-5
SHARD_TILED_SHAPE = (1080, 1920)
SHARD_CONV_SHAPE = (2, 256, 256, 16)


def _shard_steps(cfg, batches, model, gen_seed: int, dev) -> dict:
    """SHARD_STEPS train steps of a TrainState over `model` (replicated
    from rank 0 in a group); the losses, step 1's gradients and running
    statistics, the final parameters (on the card) and the steps'
    seconds."""
    import torch
    from unet_watermark_tpu_torch.ops import losses
    from unet_watermark_tpu_torch.parallel import mesh as pmesh
    from unet_watermark_tpu_torch.training import train as tr
    from unet_watermark_tpu_torch.training.state import TrainState, \
        make_optimizer

    state = TrainState(model, make_optimizer(cfg, model))
    pmesh.replicated(state)
    step = tr.make_train_step(cfg, losses.get_loss_function(cfg),
                              cfg.DATA.AUGMENTATION_TYPE,
                              torch.Generator(dev).manual_seed(gen_seed))
    grads = {}

    def part(name):
        if name == "optimizer" and not grads:
            grads.update({n: p.grad.detach().clone() for n, p in
                          state.model.named_parameters()})
        return contextlib.nullcontext()

    seen, stats = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[:SHARD_STEPS]:
        seen.append(float(step(state, b, part)["loss"]))
        if stats is None:
            stats = {k: v.detach().clone() for k, v in
                     state.model.state_dict().items() if "running" in k}
    torch.cuda.synchronize()
    return {"losses": seen, "grads": grads, "stats": stats,
            "params": {k: v.detach().clone() for k, v in
                       state.model.named_parameters()},
            "steps_s": time.perf_counter() - t0}


def _shard_compare(grouped: dict, alone: dict, start: dict) -> dict:
    """The group's steps against the steps without one: each loss's
    relative distance, step 1's gradients' distance over their norm, the
    running statistics' over each buffer's largest value, the parameters'
    over the distance the steps moved them."""
    import torch

    def rel_norm(a, b, ref):
        diff = sum(((a[n].float() - b[n].float()) ** 2).sum() for n in b)
        norm = sum((ref[n].float() ** 2).sum() for n in b)
        return torch.sqrt(diff / norm.clamp(min=1e-30)).item()

    sa, sb = grouped["stats"], alone["stats"]
    moved = {n: alone["params"][n] - start[n] for n in start}
    return {"losses_group": grouped["losses"],
            "losses_alone": alone["losses"],
            "loss_rel": [abs(a - b) / max(abs(b), 1e-6) for a, b in
                         zip(grouped["losses"], alone["losses"])],
            "grad_rel_norm": rel_norm(grouped["grads"], alone["grads"],
                                      alone["grads"]),
            "step1_running_stats_max_rel": max(
                ((sa[n] - sb[n]).abs().max()
                 / sb[n].abs().max().clamp(min=1e-6)).item() for n in sb),
            "params_rel_update": rel_norm(grouped["params"],
                                          alone["params"], moved),
            "params_max_abs": max((grouped["params"][n] - alone["params"][n]
                                   ).abs().max().item() for n in start),
            "steps_s_group": grouped["steps_s"],
            "steps_s_alone": alone["steps_s"]}


def sharded_phase(work: Path, seed: int, dev, pred) -> dict:
    """Phase 3n: an NCCL world of one in this process (a file:// store in
    the work folder), then destroyed. The group's train steps against the
    steps without a group (float32 and bf16), the `train` command in the
    group, predict_tiled_sharded against predict_tiled with `pred`'s model
    (the shipped Unet, bf16), sharded_conv2d against the unsharded conv.
    Returns the timing fields."""
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F
    from unet_watermark_tpu_torch.configs import (DEFAULT_CONFIG,
                                                  get_cfg_defaults,
                                                  update_config)
    from unet_watermark_tpu_torch.data.dataset import create_datasets
    from unet_watermark_tpu_torch.inference.tiled import (
        pad_to_multiple, plan_tiles, predict_tiled, predict_tiled_sharded)
    from unet_watermark_tpu_torch.models.encoders import global_batch_stats
    from unet_watermark_tpu_torch.parallel import distributed
    from unet_watermark_tpu_torch.parallel import mesh as pmesh
    from unet_watermark_tpu_torch.parallel import spatial
    from unet_watermark_tpu_torch.training import train as tr

    t_phase = time.perf_counter()
    cfg = get_cfg_defaults()
    update_config(cfg, DEFAULT_CONFIG)
    cfg.DATA.IMG_SIZE = SIZE
    cfg.DATA.ROOT_DIR = str(work / "train_data")  # 3h's folder, cached
    cfg32 = copy.deepcopy(cfg)
    cfg32.MODEL.DTYPE = "float32"
    train_ds, _ = create_datasets(cfg, device=dev)
    bs = cfg.TRAIN.BATCH_SIZE
    batches = []
    for b in range(SHARD_STEPS):
        items = [train_ds[i] for i in range(b * bs, (b + 1) * bs)]
        batches.append({
            "image": torch.from_numpy(np.stack([im for im, _ in items])
                                      ).to(dev),
            "mask": torch.from_numpy(np.stack(
                [(np.asarray(m) > 127).astype(np.uint8) for _, m in items])
                )[..., None].to(dev),
            "valid": torch.ones(bs, device=dev)})
    base = tr.create_train_state(cfg, seed, dev).model
    start = {k: v.detach().clone() for k, v in base.named_parameters()}
    copies = [copy.deepcopy(base) for _ in range(3)]
    alone = {"bf16": _shard_steps(cfg, batches, base, seed, dev),
             "f32": _shard_steps(cfg32, batches, copies[0], seed, dev)}
    del base

    out, ckpt = work / "dp_out", work / "dp_out" / "checkpoints"
    argv = ["train", "-c", str(DEFAULT_CONFIG), "--data-dir",
            cfg.DATA.ROOT_DIR, "--epochs", "1", "--output-dir",
            str(out / "logs"), "--model-save-path",
            str(out / "models" / "unet_watermark.pth"),
            "--opts", "DATA.DEVICE_CACHE", "False",
            "TRAIN.CHECKPOINT_DIR", str(ckpt), "DATA.IMG_SIZE", str(SIZE)]
    t_group = time.perf_counter()
    rank, world = distributed.initialize(
        f"file://{work / 'nccl_store'}", 1, 0, device=dev)
    try:
        init_s = time.perf_counter() - t_group
        mesh = pmesh.mesh_from_config(cfg)
        with global_batch_stats():
            grouped = {
                "bf16": _shard_steps(cfg, batches, copies[1], seed, dev),
                "f32": _shard_steps(cfg32, batches, copies[2], seed, dev)}
            rc, cli_s, _ = run_cli(argv, dev, timer=False)
        del copies
        history = json.loads(
            (out / "logs" / "training_history.json").read_text())
        written = sorted(os.listdir(ckpt)) + sorted(
            os.listdir(out / "models"))
        if rc != 0 or len(history["train_loss"]) != 1 or not all(
                np.isfinite(history[k]).all() for k in ("train_loss",
                                                        "val_loss")) or \
                not distributed.in_group() or written != [
                    "best_model", "seg_unetplusplus_resnet34.npz",
                    "unet_watermark.pth"]:
            raise AssertionError(f"train in the group: rc {rc}, history "
                                 f"{history}, wrote {written}")

        # the tiled map of a 1080p image (the batches' images in a grid),
        # bf16 Unet, sharded and not
        h, w = SHARD_TILED_SHAPE
        tiles_u8 = torch.cat([b["image"] for b in batches])
        rows, cols = -(-h // SIZE), -(-w // SIZE)
        grid = tiles_u8[:rows * cols].reshape(rows, cols, SIZE, SIZE, 3)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(rows * SIZE,
                                                   cols * SIZE, 3)
        y0, x0 = (rows * SIZE - h) // 2, (cols * SIZE - w) // 2
        rgb = grid[y0:y0 + h, x0:x0 + w].float() / 255.0
        p = pred.cfg.PREDICT
        padded, _ = pad_to_multiple(rgb, 32, min_size=p.TILE_SIZE)
        x = pred._normalize(padded)
        with torch.inference_mode():
            t0 = time.perf_counter()
            plain = predict_tiled(pred._apply_model, x, p.TILE_SIZE,
                                  p.TILE_OVERLAP, batch=p.BATCH_SIZE)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sharded = predict_tiled_sharded(
                pred._apply_model, x, mesh, p.TILE_SIZE, p.TILE_OVERLAP,
                batch=p.BATCH_SIZE)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        tiles = len(plan_tiles(x.shape[0], x.shape[1], p.TILE_SIZE,
                               p.TILE_OVERLAP))
        if not torch.equal(plain, sharded):
            raise AssertionError(
                f"predict_tiled_sharded differs from predict_tiled by "
                f"{(plain - sharded).abs().max().item()}")

        # the halo-exchange conv against the unsharded one
        gen = torch.Generator(dev).manual_seed(seed)
        xc = torch.randn(SHARD_CONV_SHAPE, generator=gen, device=dev)
        k = torch.randn((3, 3, SHARD_CONV_SHAPE[-1], SHARD_CONV_SHAPE[-1]),
                        generator=gen, device=dev)
        halo = spatial.halo_exchange(spatial.shard_spatial(xc, mesh), 1,
                                     mesh)
        conv = spatial.gather_spatial(spatial.sharded_conv2d(
            spatial.shard_spatial(xc, mesh), k, mesh), mesh)
        ref = F.conv2d(xc.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                       padding=1).permute(0, 2, 3, 1)
        conv_err = (conv - ref).abs().max().item()
        conv_scale = ref.abs().max().item()
        if conv_err > SHARD_CONV_RTOL * conv_scale or \
                halo[:, :1].any() or halo[:, -1:].any():
            raise AssertionError(f"sharded_conv2d against the unsharded "
                                 f"conv: {conv_err} of {conv_scale}")
        nccl = torch.cuda.nccl.version()
        nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) \
            else str(nccl)
    finally:
        distributed.shutdown()
    group_s = time.perf_counter() - t_group

    f32 = _shard_compare(grouped["f32"], alone["f32"], start)
    bf16 = _shard_compare(grouped["bf16"], alone["bf16"], start)
    bf16["grad_rel_norm_vs_float32"] = _shard_compare(
        alone["bf16"], alone["f32"], start)["grad_rel_norm"]
    fields = {
        "world": world, "rank": rank, "backend": "nccl", "nccl": nccl,
        "steps": SHARD_STEPS, "arch": cfg.MODEL.NAME, "batch": bs,
        "size": SIZE, "float32": f32, "bfloat16": bf16,
        "train_cli": {"rc": rc, "wall_s": cli_s, "history": history,
                      "wrote": written},
        "tiled_shape": list(SHARD_TILED_SHAPE), "tiles": tiles,
        "tiled_equal": True, "tiled_ms": (t1 - t0) * 1e3,
        "tiled_sharded_ms": (t2 - t1) * 1e3,
        "conv_shape": list(SHARD_CONV_SHAPE), "conv_max_abs": conv_err,
        "conv_scale": conv_scale, "group_init_s": init_s,
        "group_s": group_s, "phase_s": time.perf_counter() - t_phase}
    log("sharded", **fields)
    finite = all(np.isfinite(v).all() for v in (
        bf16["losses_group"], f32["losses_group"]))
    if not finite or bf16["loss_rel"][0] > SHARD_LOSS1_RTOL or \
            max(bf16["loss_rel"]) > SHARD_LOSS_RTOL or \
            bf16["step1_running_stats_max_rel"] > SHARD_STATS_RTOL or \
            max(f32["loss_rel"]) > SHARD32_LOSS_RTOL or \
            f32["grad_rel_norm"] > SHARD32_GRAD_RTOL or \
            f32["step1_running_stats_max_rel"] > SHARD32_STATS_RTOL or \
            f32["params_rel_update"] > SHARD32_UPDATE_RTOL:
        raise AssertionError(f"the group's steps against the steps without "
                             f"a group: {fields}")
    return fields
