"""Phase 3p of chip_smoke.py: the library surface on the card
(library_phase). chip_smoke.py imports this module; it needs the card, as
chip_smoke.py does (on the CPU it rehearses with device "cpu", where the
launch checks are skipped).

  3p (a) maskproc.optimize_mask_by_type for codes 0, 1, 2 on one raw
         SIZE² mask of the default configuration's predictor (3b's), and
         optimize_mask_batch_by_type on its BATCH raw masks with codes
         0, 1, 2, ...: each mask equal to the plain optimize_mask of its
         type (parity), K1 and K2 launched (counted from 0 around the
         helpers alone)
     (b) utils.OptimizedPredictor around predict_artifact_masks over
         LIB_IMAGES images at batch BATCH (the remainder padded with zero
         images): every image's mask and type equal to those of
         predict_artifact_masks on its batch's images without the pad, K1
         and K2 launched; then the predictor's batch tuning
         (BatchSizeOptimizer) up to TUNE_MAX at SIZE², each batch's peak
         allocated MiB logged
     (c) utils.TPUMemoryManager.snapshot() against torch.cuda.mem_get_info
         and memory_allocated; utils.SystemMonitor, two samples
     (d) utils.native (csrc/maskops.c, built with cc beside the kernels)
         on the card's raw masks copied to the host against
         ops/components on the card: the component count, the stats rows
         (left, top, width, height, area) as sets, and the
         largest-component rule's mask
     (e) scripts.method_compare.compare_methods on one SIZE² synthetic
         image with its logo mask beside it as the ground truth (found by
         name): five masks, finite scores, the grid PNG decoded by the
         port's reader at its expected size
     (f) text.diagnose.run_all() on the card: the builtin detector finds
         the block-font line
     (g) utils.TrainingOptimizer with gradient_accumulation_steps 2 on
         the default configuration's model (UNet++/resnet34, bf16
         autocast) at BATCH × SIZE², the shape 3h set cuDNN up for: 4
         steps, every loss finite, the parameters unchanged after steps 1
         and 3 and changed after steps 2 and 4
Logs each part's seconds and the phase's; returns {"launches" (a),
"predictor_launches" (b), "timing"}. The inputs of (e) are written by
write_inputs at the phase's start (about 0.1 s on the host), not by
chip_smoke.py's startup host workers: as one more task there, that
pool's other files took 3-16 s longer on the card's host.
"""
from __future__ import annotations

import math
import time
from pathlib import Path

from .smoke_phases import BATCH, SIZE, log

LIB_IMAGES = 11  # (b): a batch of BATCH and a remainder of 3
TUNE_MAX = 16
TRAIN_STEPS, ACCUMULATE = 4, 2
MEMORY_SLACK = 2 << 20  # bytes mem_get_info may move between two reads


def write_inputs(work: Path, seed: int, size: int = SIZE) -> dict:
    """(e)'s image and its ground-truth mask, methods/photo.png and
    methods/photo_mask.png (host only)."""
    import numpy as np

    from unet_watermark_tpu_torch.utils import image_io
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    t0 = time.perf_counter()
    d = work / "methods"
    d.mkdir(parents=True, exist_ok=True)
    img, logos = watermarked_images(1, size, seed=seed + 41)
    image_io.write_png(d / "photo.png", (img[0] * 255).astype(np.uint8))
    image_io.write_png(d / "photo_mask.png",
                       (logos[0] > 0.5).astype(np.uint8) * 255)
    return {"write_s": time.perf_counter() - t0}


def _launches():
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc

    return {k.__name__: k.launches for k in kc.KERNELS}


def _need_launches(launches: dict, what: str, dev) -> None:
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"{what} launched {launches}")


def per_type(pred, raw, dev) -> dict:
    """(a): returns the helpers' launches."""
    import torch

    from unet_watermark_tpu_torch.inference import maskproc
    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc

    names = {v: k for k, v in maskproc.TYPE_CODES.items()}
    codes = [i % 3 for i in range(raw.shape[0])]
    kc.reset_launch_counts()
    single = [maskproc.optimize_mask_by_type(raw[0], c) for c in (0, 1, 2)]
    batched = maskproc.optimize_mask_batch_by_type(raw, codes)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = _launches()
    _need_launches(launches, "the per-type helpers", dev)
    for c, mk in enumerate(single):
        if not torch.equal(mk, maskproc.optimize_mask(raw[0], names[c])):
            raise AssertionError(f"optimize_mask_by_type code {c} differs "
                                 f"from the plain optimize_mask")
    for i, c in enumerate(codes):
        if not torch.equal(batched[i], maskproc.optimize_mask(raw[i],
                                                              names[c])):
            raise AssertionError(f"optimize_mask_batch_by_type image {i} "
                                 f"(code {c}) differs from optimize_mask")
    log("library_per_type", codes=codes, launches=launches,
        mask_fraction=[round(m.mean().item(), 6) for m in single],
        equals_plain_optimize_mask=True)
    return launches


def predictor(pred, images, dev, batch: int, tune_max: int) -> dict:
    """(b): returns the wrapped surface's launches and the tuner's
    peaks."""
    import torch

    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.utils import OptimizedPredictor

    op = OptimizedPredictor(pred.predict_artifact_masks, batch_size=batch,
                            device=dev)
    kc.reset_launch_counts()
    out = op.predict(list(images))
    launches = _launches()
    _need_launches(launches, "OptimizedPredictor(predict_artifact_masks)",
                   dev)
    for lo in range(0, len(images), batch):
        masks, types = pred.predict_artifact_masks(images[lo:lo + batch])
        for i, (mk, kind) in enumerate(zip(masks, types)):
            got_mk, got_kind = out[lo + i]
            if kind != got_kind or not torch.equal(mk, got_mk):
                raise AssertionError(f"OptimizedPredictor's image {lo + i} "
                                     f"({got_kind}) differs from the "
                                     f"unpadded call's ({kind})")
    stats = op.get_statistics()
    tuned = OptimizedPredictor(pred.predict_artifact_masks, batch_size=1,
                               device=dev, auto_tune_batch=True,
                               example_input=images[0],
                               max_batch_size=tune_max)
    peaks = {b: (None if v is None else round(v / 2 ** 20, 1))
             for b, v in tuned.tuner.peaks.items()}
    if dev.type == "cuda" and (tuned.batch_size != tune_max or
                               any(v is None for v in peaks.values())):
        raise AssertionError(f"batch tuning chose {tuned.batch_size} with "
                             f"peaks {peaks} MiB")
    log("library_predictor", images=len(images), batch=batch,
        types=[kind for _, kind in out], launches=launches,
        equals_unpadded_call=True,
        batch_mean_s=stats.get("mean"), tuned_batch=tuned.batch_size,
        peak_allocated_mib=peaks)
    return {"launches": launches, "peaks_mib": peaks}


def memory(dev) -> dict:
    """(c)."""
    import torch

    from unet_watermark_tpu_torch.utils import SystemMonitor, TPUMemoryManager

    snap = TPUMemoryManager().snapshot()
    out = {"host_percent": snap.host_percent,
           "device_percent": snap.device_percent}
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info()
        allocated = torch.cuda.memory_allocated()
        if snap.device_bytes_limit != total or abs(
                snap.device_bytes_in_use - (total - free)) > MEMORY_SLACK \
                or snap.device_bytes_allocated != allocated:
            raise AssertionError(f"snapshot {snap} against mem_get_info "
                                 f"({free}, {total}), allocated {allocated}")
        out["in_use_vs_mem_get_info"] = (snap.device_bytes_in_use
                                         - (total - free))
    monitor = SystemMonitor(interval=0.1)
    samples = [monitor.sample()]
    time.sleep(0.2)
    samples.append(monitor.sample())
    for s in samples:
        if not (0.0 <= s.cpu_percent <= 100.0 and 0.0 < s.ram_percent <= 100.0
                and (dev.type != "cuda" or s.device_percent > 0.0)):
            raise AssertionError(f"SystemMonitor sample {s}")
    out["samples"] = [vars(s) for s in samples]
    log("library_memory", **out)
    return out


def native(raw, dev) -> dict:
    """(d)."""
    import numpy as np
    import torch

    from unet_watermark_tpu_torch.ops import components as cc
    from unet_watermark_tpu_torch.utils import native as nat

    labels = cc.label_components(raw)
    stats = cc.component_stats(labels)
    kept = cc.keep_largest_component(raw)
    host = raw.cpu().numpy()
    counts = []
    for i in range(raw.shape[0]):
        n, _, rows = nat.connected_components_with_stats(host[i], 8)
        exists = stats["exists"][i].clone()
        exists[0] = False
        card = torch.stack([stats[k][i][exists] for k in
                            ("x0", "y0", "width", "height", "area")], 1)
        card_rows = sorted(map(tuple, card.cpu().tolist()))
        if n - 1 != len(card_rows) or \
                sorted(map(tuple, rows[1:].tolist())) != card_rows:
            raise AssertionError(f"mask {i}: utils.native finds {n - 1} "
                                 f"components, ops/components "
                                 f"{len(card_rows)}, or their stats differ")
        largest = nat.keep_largest_component(host[i]) > 0
        if not np.array_equal(largest, kept[i].cpu().numpy() > 0.5):
            raise AssertionError(f"mask {i}: the largest-component rule "
                                 f"differs between utils.native and "
                                 f"ops/components")
        counts.append(n - 1)
    log("library_native", components=counts, stats_equal=True,
        keep_largest_equal=True)
    return {"components": counts}


def methods(work: Path, pred, size: int) -> dict:
    """(e)."""
    from unet_watermark_tpu_torch.scripts import method_compare as mc
    from unet_watermark_tpu_torch.utils import image_io

    d = work / "methods"
    r = mc.compare_methods(str(d / "photo.png"), str(d / "report"),
                           predictor=pred)
    if list(r["masks"]) != list(mc.METHODS) or any(
            m.shape != (size, size) for m in r["masks"].values()):
        raise AssertionError(f"compare_methods gave "
                             f"{ {k: m.shape for k, m in r['masks'].items()} }")
    if r["scores"] is None or not all(
            math.isfinite(v) for s in r["scores"].values()
            for v in s.values()):
        raise AssertionError(f"compare_methods' scores: {r['scores']}")
    grid = image_io.read_rgb(r["grid"])
    want = (mc.GAP + 2 * (mc.TITLE_H + size + mc.GAP),
            mc.GAP + mc.GRID_COLS * (size + mc.GAP), 3)
    if grid.shape != want:
        raise AssertionError(f"the grid is {grid.shape}, not {want}")
    log("library_methods", scores=r["scores"], grid_shape=list(grid.shape))
    return r["scores"]


def diagnosis(dev) -> dict:
    """(f)."""
    from unet_watermark_tpu_torch.text import diagnose

    r = diagnose.run_all(dev)
    if not r["pipeline"]["builtin_ocr_found_text"]:
        raise AssertionError(f"diagnose found no text: {r['pipeline']}")
    log("library_diagnose", fonts_found=r["fonts"]["fonts_found"],
        ocr=r["ocr"], pipeline=r["pipeline"])
    return r


def training(work: Path, seed: int, dev, images, logos, size: int) -> dict:
    """(g)."""
    import torch

    from unet_watermark_tpu_torch.configs import get_cfg_defaults
    from unet_watermark_tpu_torch.models.factory import (
        create_model_from_config, init_model)
    from unet_watermark_tpu_torch.ops import losses
    from unet_watermark_tpu_torch.utils import (TrainingConfig,
                                                TrainingOptimizer)

    cfg = get_cfg_defaults()
    cfg.DATA.IMG_SIZE = size
    model = init_model(create_model_from_config(cfg), seed)
    topt = TrainingOptimizer(model, losses.bce_loss, TrainingConfig(
        learning_rate=1e-3, scheduler="none",
        gradient_accumulation_steps=ACCUMULATE, compute_dtype="bfloat16",
        output_dir=str(work / "training_optimizer")), device=dev)
    batch = {"image": images, "mask": logos[..., None]}
    state = topt.init_state(batch)
    params = list(topt.model.parameters())
    before = [p.detach().clone() for p in params]
    losses_seen, moved = [], []
    for _ in range(TRAIN_STEPS):
        state, loss = topt.step(state, batch)
        now = [p.detach().clone() for p in params]
        moved.append(any(not torch.equal(a, b) for a, b in zip(before, now)))
        losses_seen.append(loss.item())
        before = now
    want = [(k + 1) % ACCUMULATE == 0 for k in range(TRAIN_STEPS)]
    if moved != want or not all(math.isfinite(v) for v in losses_seen):
        raise AssertionError(f"TrainingOptimizer: parameters moved "
                             f"{moved} (want {want}), losses {losses_seen}")
    log("library_training", arch=cfg.MODEL.NAME, batch=list(images.shape),
        accumulate=ACCUMULATE, losses=losses_seen, moved=moved)
    return {"losses": losses_seen}


def library_phase(work: Path, seed: int, dev, pred, images,
                  size: int = SIZE, batch: int = BATCH,
                  lib_images: int = LIB_IMAGES,
                  tune_max: int = TUNE_MAX) -> dict:
    """Phase 3p (the module's docstring). `pred` is the default
    configuration's WatermarkPredictor and `images` its (BATCH, SIZE,
    SIZE, 3) batch (3b's); `work` an empty-enough directory for (e)'s
    files."""
    import torch

    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    t_phase = time.perf_counter()
    parts = {"write_inputs": write_inputs(work, seed, size)["write_s"]}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        parts[name] = round(time.perf_counter() - t0, 3)
        return out

    raw = pred.predict_masks(images)
    launches = part("per_type", per_type, pred, raw, dev)
    lib_np, _ = watermarked_images(lib_images, size, seed=seed + 43,
                                   clean=2)
    pred_out = part("predictor", predictor, pred,
                    torch.from_numpy(lib_np).to(dev), dev, batch, tune_max)
    part("memory", memory, dev)
    part("native", native, raw, dev)
    part("methods", methods, work, pred, size)
    part("diagnose", diagnosis, dev)
    train_np, logos_np = watermarked_images(batch, size, seed=seed + 44)
    part("training", training, work, seed, dev,
         torch.from_numpy(train_np).to(dev),
         torch.from_numpy(logos_np).to(dev), size)
    timing = {"phase_s": time.perf_counter() - t_phase, "parts_s": parts,
              "launches": launches,
              "predictor_launches": pred_out["launches"],
              "tuner_peak_mib": pred_out["peaks_mib"]}
    log("library", **timing)
    return {"launches": launches,
            "predictor_launches": pred_out["launches"], "timing": timing}
