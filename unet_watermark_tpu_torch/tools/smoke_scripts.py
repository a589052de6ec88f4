"""Phase 3q of chip_smoke.py: the dataset tools of scripts/ and car_logo/
on the card (scripts_phase), each driven through its main(argv) as a user
runs it, on folders that write_inputs makes with utils/synthetic.py at
full size (512² and 1080 × 1920). chip_smoke.py writes them in a startup
host worker while the kernels build, and imports this module; it needs
the card, as chip_smoke.py does (on the CPU it rehearses with device
"cpu", where the launch checks are skipped).

  3q (a) check on a triad folder with planted black, fragmented, missing,
         orphaned and corrupted files, in move mode: the expected problem
         counts, 3 affected triads, their 8 files moved to the quarantine
     (b) enhance_masks on a 1080 × 1920 PNG, a 512² gray JPEG and a 512²
         BMP mask: each output equal byte for byte to the CPU run's
     (c) image_fixer --fix on planted files: each file's stage and fix as
         FIX_EXPECTED says (a truncated 1080p JPEG fixed from its partial
         decode, a bad CRC and a missing IEND fixed, a cut PNG, an empty
         file and random bytes not), the fixed files readable
     (d) watermark_filter with the shipped UNet++ (the default
         configuration, bf16) on 8 × 512² images, 4 with a logo: the
         copied set is the 4 without
     (e) batch_repair_optimizer in chunks of 4 over 12 × 512² images (steps
         1-2, push-pull): 3 chunks, K1 and K2 launched, every step-1 mask
         equal to one process_folder_batch over the folder at step 1's
         batch of 4
     (f) extract_watermarks on 3 × 512² pairs and a 1080 × 1920 one: the
         card's assets equal byte for byte to the CPU's
     (g) classify_image: the random small DINOv2's clusters of 12 × 512²
         images; on 3 of them the histogram features card against CPU
         within HIST_ATOL and the CLS features within CLS_ATOL (float32,
         TF32 off), and KMeans' and DBSCAN's labels of all 12 equal card
         against CPU
     (h) logo_process on 4 logos and logo_placement on 3 × 512² cars and a
         1080 × 1920 one: the card's files equal byte for byte to the
         CPU's
Logs each part's seconds and the phase's; returns {"launches" (e),
"timing"}.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

from .smoke_phases import SIZE, log

BIG = (1080, 1920)
HIST_ATOL = 1e-6
CLS_ATOL = 1e-3
REPAIR_FILES, CHUNK = 12, 4
FILTER_FILES, FILTER_CLEAN = 8, 4
# (a): the planted problems of write_inputs' triad folder
CHECK_EXPECTED = {"missing_clean": 1, "missing_mask": 1, "black_mask": 1,
                  "fragmented_mask": 1, "orphan_clean": 1, "orphan_mask": 1,
                  "corrupted": 1}
# (c): each planted file's stage (None: healthy) and whether --fix fixes it
FIX_EXPECTED = {"ok.png": (None, None), "ok.jpg": (None, None),
                "cut.jpg": ("pil_load", True),
                "cut.png": ("pil_verify", False),
                "crc.png": ("pil_verify", True),
                "noiend.png": ("pil_verify", True),
                "empty.jpg": ("pil_verify", False),
                "random.jpg": ("pil_verify", False)}


def _u8(img):
    import numpy as np

    return (np.asarray(img) * 255).astype(np.uint8)


def _stamped(base, logo, y: int, x: int):
    """base (H, W, 3) uint8 with an RGBA logo blended in at (y, x)."""
    import numpy as np

    out = base.copy()
    h, w = logo.shape[:2]
    a = logo[..., 3:].astype(np.float32) / 255
    region = out[y:y + h, x:x + w].astype(np.float32)
    out[y:y + h, x:x + w] = (logo[..., :3] * a + region * (1 - a)).astype(
        np.uint8)
    return out


def _triad_mask(name: str, rng, size: int):
    """A box of 80-120 px (over 1 % of a 512² mask), none (b*), or 100
    separate 6 × 6 specks (f*: 1.4 % of a 512² mask)."""
    import numpy as np

    mask = np.zeros((size, size), np.uint8)
    if name.startswith("f"):
        for i in range(10):
            for j in range(10):
                mask[20 + 12 * i:26 + 12 * i, 20 + 12 * j:26 + 12 * j] = 255
    elif not name.startswith("b"):
        h, w = (int(v) for v in rng.integers(80, 121, 2))
        y, x = (int(v) for v in rng.integers(0, size - 121, 2))
        mask[y:y + h, x:x + w] = 255
    return mask


def _big(seed: int):
    """A 1080 × 1920 synthetic image: a 512² one's gradient, resized."""
    import torch

    from unet_watermark_tpu_torch.ops.resize import resize_linear_u8
    from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

    img, _ = watermarked_images(1, SIZE, seed=seed, clean=1)
    return resize_linear_u8(torch.from_numpy(_u8(img[0])), BIG).numpy()


def write_inputs(work: Path, seed: int, size: int = SIZE) -> dict:
    """3q's folders under work/q (host only). Returns {"write_s"}."""
    import numpy as np

    from unet_watermark_tpu_torch.utils import bmp, image_io, synthetic

    t0 = time.perf_counter()
    q = work / "q"
    rng = np.random.default_rng(seed + 71)
    png = image_io.write_png

    # (a) triads: g0-g3 whole; b0 a black mask, f0 a fragmented one; m0
    # without a mask, c0 without a clean image; o0, o1 orphans; x0 corrupt
    tri = q / "triads"
    for d in ("watermarked", "clean", "masks"):
        (tri / d).mkdir(parents=True)
    imgs, logos = synthetic.watermarked_images(8, size, seed=seed + 72)
    for i, name in enumerate(("g0", "g1", "g2", "g3", "b0", "f0", "m0",
                              "c0")):
        png(tri / "watermarked" / f"{name}.png", _u8(imgs[i]))
        if name != "c0":
            png(tri / "clean" / f"{name}.png", _u8(imgs[(i + 1) % 8]))
        if name != "m0":
            png(tri / "masks" / f"{name}.png", _triad_mask(name, rng, size))
    png(tri / "clean" / "o0.png", _u8(imgs[0]))
    png(tri / "masks" / "o1.png", _triad_mask("o1", rng, size))
    good = image_io.encode_png(_u8(imgs[2]))
    (tri / "watermarked" / "x0.png").write_bytes(good[:len(good) // 3])
    png(tri / "clean" / "x0.png", _u8(imgs[3]))
    png(tri / "masks" / "x0.png", _triad_mask("x0", rng, size))

    # (b) masks: a 1080p PNG, a 512² gray JPEG, a 512² BMP
    masks = q / "masks"
    masks.mkdir()
    big_mask = (_big(seed + 73)[..., 0] > 128).astype(np.uint8) * 255
    png(masks / "m_a.png", big_mask)
    (masks / "m_b.jpg").write_bytes(image_io.encode_jpeg(_u8(logos[0])))
    (masks / "m_c.bmp").write_bytes(bmp.encode(_u8(logos[1])))

    # (c) files to fix
    fix = q / "fix"
    fix.mkdir()
    png(fix / "ok.png", _u8(imgs[4]))
    (fix / "ok.jpg").write_bytes(image_io.encode_jpeg(_u8(imgs[5])))
    big_jpeg = image_io.encode_jpeg(_big(seed + 74))
    (fix / "cut.jpg").write_bytes(big_jpeg[:len(big_jpeg) // 2])
    ok = image_io.encode_png(_u8(imgs[6]))
    (fix / "cut.png").write_bytes(ok[:len(ok) // 2])
    (fix / "noiend.png").write_bytes(ok[:-12])
    i = ok.index(b"IDAT")
    bad = bytearray(ok)
    bad[i + 4 + int.from_bytes(ok[i - 4:i], "big")] ^= 1
    (fix / "crc.png").write_bytes(bytes(bad))
    (fix / "empty.jpg").write_bytes(b"")
    (fix / "random.jpg").write_bytes(rng.integers(0, 256, 4096,
                                                  dtype=np.uint8).tobytes())

    # (d) the filter's folder: FILTER_CLEAN of the images carry no logo
    filt = q / "filter"
    filt.mkdir()
    f_imgs, _ = synthetic.watermarked_images(FILTER_FILES, size,
                                             seed=seed + 62,
                                             clean=FILTER_CLEAN)
    for i, img in enumerate(f_imgs):
        png(filt / f"w{i}.png", _u8(img))

    # (e) the repair job's folder
    rep = q / "repair"
    rep.mkdir()
    r_imgs, _ = synthetic.watermarked_images(REPAIR_FILES, size,
                                             seed=seed + 75, clean=2)
    for i, img in enumerate(r_imgs):
        png(rep / f"r{i:02d}.png", _u8(img))

    # (f) pairs: each clean image and the same with a logo stamped in
    for d in ("pw", "pc"):
        (q / d).mkdir()
    cleans, _ = synthetic.watermarked_images(3, size, seed=seed + 76,
                                             clean=3)
    pair_logos = synthetic.logo_images(6, seed=seed + 77)
    bases = [_u8(c) for c in cleans] + [_big(seed + 78)]
    for i, base in enumerate(bases):
        h, w = base.shape[:2]
        wm = base
        for j in (2 * i % 6, (2 * i + 1) % 6):
            lg = pair_logos[j]
            y = int(rng.integers(0, h - lg.shape[0]))
            x = int(rng.integers(0, w - lg.shape[1]))
            wm = _stamped(wm, lg, y, x)
        png(q / "pw" / f"p{i}.png", wm)
        png(q / "pc" / f"p{i}.png", base)

    # (g) the classifier's folder
    cls = q / "classify"
    cls.mkdir()
    c_imgs, _ = synthetic.watermarked_images(12, size, seed=seed + 79,
                                             clean=6)
    for i, img in enumerate(c_imgs):
        png(cls / f"k{i:02d}.png", _u8(img))

    # (h) logos on white (PNG, JPEG, and one RGBA PNG kept as it is) and
    # cars
    lin = q / "logos_in"
    lin.mkdir()
    for i, lg in enumerate(synthetic.logo_images(4, seed=seed + 80)):
        white = np.full(lg.shape[:2] + (3,), 250, np.uint8)
        flat = _stamped(white, lg, 0, 0)
        if i == 0:
            (lin / "l0.jpg").write_bytes(image_io.encode_jpeg(flat))
        elif i == 1:
            png(lin / "l1.png", lg)
        else:
            png(lin / f"l{i}.png", flat)
    cars = q / "cars"
    cars.mkdir()
    car_imgs, _ = synthetic.watermarked_images(3, size, seed=seed + 81,
                                               clean=3)
    for i, img in enumerate(car_imgs):
        png(cars / f"car{i}.png", _u8(img))
    (cars / "car3.jpg").write_bytes(image_io.encode_jpeg(_big(seed + 82)))
    return {"write_s": time.perf_counter() - t0}


def _on(dev) -> list:
    """The CLIs' --device: nothing on the card (their default)."""
    return [] if dev.type == "cuda" else ["--device", str(dev)]


@contextlib.contextmanager
def _c_entropy():
    """The CPU runs' JPEG entropy decode in C (the card's route) where the
    CPU takes the plain Python decoder (seconds at 1080p); tests hold the
    two equal. The pixel stage stays the CPU's."""
    from unet_watermark_tpu_torch.ops.kernels import jpeg_entropy

    real = jpeg_entropy.decode_scans
    jpeg_entropy.decode_scans = lambda header, data, device: \
        jpeg_entropy.decode_scans_c(header, data)
    try:
        yield
    finally:
        jpeg_entropy.decode_scans = real


def _same_files(a: Path, b: Path) -> int:
    """Every file under a equal byte for byte to b's; returns the count."""
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    theirs = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    if names != theirs:
        raise AssertionError(f"{a} holds {names}, {b} {theirs}")
    for n in names:
        if (a / n).read_bytes() != (b / n).read_bytes():
            raise AssertionError(f"{a / n} differs from {b / n}")
    return len(names)


def check_part(q: Path, dev) -> dict:
    from unet_watermark_tpu_torch.scripts import check

    s = check.main(["--root", str(q / "triads"), "--mode", "move",
                    *_on(dev)])
    quarantined = sorted(os.listdir(q / "triads" / "quarantine"))
    if s["problems"] != CHECK_EXPECTED or s["affected_triads"] != 3 or \
            len(s["handled"]) != 8 or \
            quarantined != ["b0.png", "m0.png", "x0.png"]:
        raise AssertionError(f"check: {s['problems']}, "
                             f"{s['affected_triads']} affected, "
                             f"quarantine {quarantined}")
    return {"problems": s["problems"], "mask_stats": s["mask_stats"]}


def enhance_part(q: Path, dev) -> dict:
    from unet_watermark_tpu_torch.scripts import enhance_masks

    n = enhance_masks.main(["--input", str(q / "masks"), "--output",
                            str(q / "masks_card"), *_on(dev)])
    with _c_entropy():
        enhance_masks.enhance_folder(str(q / "masks"), str(q / "masks_cpu"),
                                     device="cpu")
    same = _same_files(q / "masks_card", q / "masks_cpu")
    if n != 3 or same != 3:
        raise AssertionError(f"enhance_masks wrote {n} masks")
    return {"masks": n}


def fix_part(q: Path, dev) -> dict:
    from unet_watermark_tpu_torch.scripts import image_fixer
    from unet_watermark_tpu_torch.utils import image_io

    s = image_fixer.main(["--folder", str(q / "fix"), "--fix", *_on(dev)])
    got = {os.path.basename(d["path"]): (d["problem"].split(":")[0],
                                         d["fixed"]) for d in s["details"]}
    want = {k: v for k, v in FIX_EXPECTED.items() if v[0] is not None}
    if got != want or s["checked"] != len(FIX_EXPECTED):
        raise AssertionError(f"image_fixer: {got}")
    for name, (_, fixed) in want.items():
        if fixed:  # a fixed file reads, and checks healthy now
            image_io.read_rgb_tensor(str(q / "fix" / name), dev)
    return {"details": got}


def filter_part(q: Path, weights: str, dev, config=None) -> dict:
    from unet_watermark_tpu_torch.scripts import watermark_filter

    s = watermark_filter.main(["--model", weights, "--input",
                               str(q / "filter"), "--clean-output",
                               str(q / "filter_clean"), "--copy", *_on(dev),
                               *(["--config", config] if config else [])])
    moved = sorted(os.path.basename(p) for p in s["moved_files"])
    want = [f"w{i}.png" for i in range(FILTER_FILES - FILTER_CLEAN,
                                       FILTER_FILES)]
    if moved != want:
        raise AssertionError(f"watermark_filter moved {moved}, not {want}")
    return {"moved": moved}


def repair_part(q: Path, weights: str, pred, dev, config=None) -> dict:
    import numpy as np

    from unet_watermark_tpu_torch.ops.kernels import morph_chain as kc
    from unet_watermark_tpu_torch.scripts import batch_repair_optimizer
    from unet_watermark_tpu_torch.utils import image_io

    kc.reset_launch_counts()
    out = batch_repair_optimizer.main(
        ["--model", weights, "--input", str(q / "repair"), "--output",
         str(q / "repair_chunks"), "--chunk-size", str(CHUNK), *_on(dev),
         *(["--config", config] if config else [])])
    launches = {k.__name__: k.launches for k in kc.KERNELS}
    if len(out["chunks"]) != REPAIR_FILES // CHUNK or \
            out["total_images"] != REPAIR_FILES or \
            any(c["status"] != "success" for c in out["chunks"]):
        raise AssertionError(f"batch_repair_optimizer: {out}")
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"the chunked repair launched {launches}")
    saved = pred.cfg.PREDICT.BATCH_SIZE
    pred.cfg.PREDICT.BATCH_SIZE = CHUNK  # the chunks' batch
    try:
        pred.process_folder_batch(str(q / "repair"), str(q / "repair_once"),
                                  watermark_model="pushpull", use_ocr=False,
                                  steps=1)
    finally:
        pred.cfg.PREDICT.BATCH_SIZE = saved
    a, b = q / "repair_chunks" / "step1_masks", q / "repair_once" / \
        "step1_masks"
    names = sorted(os.listdir(b))
    if sorted(os.listdir(a)) != names or not names:
        raise AssertionError(f"step 1's masks: {sorted(os.listdir(a))} "
                             f"against {names}")
    for n in names:
        if not np.array_equal(image_io.read_gray(a / n),
                              image_io.read_gray(b / n)):
            raise AssertionError(f"chunked step-1 mask {n} differs")
    return {"chunks": [c["images"] for c in out["chunks"]],
            "masks": len(names), "launches": launches}


def extract_part(q: Path, dev) -> dict:
    from unet_watermark_tpu_torch.scripts import extract_watermarks as ew

    out = ew.main(["--watermarked", str(q / "pw"), "--clean", str(q / "pc"),
                   "--output", str(q / "assets_card"), *_on(dev)])
    ew.WatermarkExtractor(device="cpu").batch_extract(
        str(q / "pw"), str(q / "pc"), str(q / "assets_cpu"))
    same = _same_files(q / "assets_card", q / "assets_cpu")
    if out["pairs"] != 4 or out["assets"] < 4 or same != out["assets"]:
        raise AssertionError(f"extract_watermarks: {out}")
    return out


def classify_part(q: Path, dev) -> dict:
    import numpy as np
    import torch

    from unet_watermark_tpu_torch.ops import cluster
    from unet_watermark_tpu_torch.scripts import classify_image as ci
    from unet_watermark_tpu_torch.utils import image_io

    assignment = ci.main(["--input", str(q / "classify"), "--output",
                          str(q / "clusters"), *_on(dev)])
    if len(assignment) != 12 or not (q / "clusters").is_dir():
        raise AssertionError(f"classify_image: {assignment}")
    card = ci.StableImageClassifier(ci.FeatureExtractor(device=dev))
    cpu = ci.StableImageClassifier(ci.FeatureExtractor(device="cpu"))
    if card.extractor.backend != "dinov2-random":
        raise AssertionError(f"feature backend {card.extractor.backend}")
    paths = sorted(str(p) for p in (q / "classify").iterdir())
    hist_err = 0.0
    for p in paths[:3]:
        img = image_io.read_rgb_tensor(p, dev)
        hist_err = max(hist_err, float(
            (ci._hist_features(img).cpu()
             - ci._hist_features(img.cpu())).abs().max()))
    f_card = card._features_for(paths)
    f_cpu = cpu._features_for(paths)
    cls_err = float(np.abs(f_card - f_cpu).max())
    labels = {}
    for name, f, d in (("card", f_card, dev), ("cpu", f_cpu, "cpu")):
        x = torch.from_numpy(f).to(d)
        labels[name] = (cluster.kmeans(x, 5, 42)[0].tolist(),
                        cluster.dbscan(cluster.l2_normalize(x), 0.05, 2,
                                       "cosine").tolist())
    if hist_err > HIST_ATOL or cls_err > CLS_ATOL or \
            labels["card"] != labels["cpu"]:
        raise AssertionError(f"classify card vs CPU: hist {hist_err}, cls "
                             f"{cls_err}, labels {labels}")
    return {"clusters": sorted(set(assignment.values())),
            "hist_max_abs_err": hist_err, "cls_max_abs_err": cls_err,
            "kmeans": labels["card"][0], "dbscan": labels["card"][1]}


def logo_part(q: Path, dev) -> dict:
    from unet_watermark_tpu_torch.car_logo import logo_placement
    from unet_watermark_tpu_torch.car_logo import logo_process

    n = logo_process.main(["--input", str(q / "logos_in"), "--output",
                           str(q / "logos_card"), *_on(dev)])
    stats = logo_placement.main(["--cars", str(q / "cars"), "--logos",
                                 str(q / "logos_card"), "--output",
                                 str(q / "placed_card"), *_on(dev)])
    with _c_entropy():
        logo_process.process_folder(str(q / "logos_in"),
                                    str(q / "logos_cpu"), device="cpu")
        logo_placement.LogoPlacer(device="cpu").batch_process(
            str(q / "cars"), str(q / "logos_cpu"), str(q / "placed_cpu"))
    _same_files(q / "logos_card", q / "logos_cpu")
    files = _same_files(q / "placed_card", q / "placed_cpu")
    if n != 4 or stats["random"] != 4 or files != 12:
        raise AssertionError(f"car_logo: {n} logos, {stats}, {files} files")
    return {"logos": n, "placed": stats}


def scripts_phase(work: Path, seed: int, dev, pred, weights: str,
                  written: dict = None, config: str = None) -> dict:
    """Phase 3q (the module's docstring). `pred` is the default
    configuration's WatermarkPredictor (3b's), `weights` its weights file
    (`config` a YAML for the CLIs that build their own predictor: the
    default configuration where None); `written` write_inputs' result
    where a startup worker wrote the folders (else they are written
    here)."""
    import torch

    t_phase = time.perf_counter()
    if written is None:
        written = write_inputs(work, seed)
    q = work / "q"
    parts = {}
    results = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        results[name] = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        parts[name] = round(time.perf_counter() - t0, 3)

    part("check", check_part, q, dev)
    part("enhance_masks", enhance_part, q, dev)
    part("image_fixer", fix_part, q, dev)
    part("watermark_filter", filter_part, q, weights, dev, config)
    part("batch_repair", repair_part, q, weights, pred, dev, config)
    part("extract_watermarks", extract_part, q, dev)
    part("classify", classify_part, q, dev)
    part("car_logo", logo_part, q, dev)
    launches = results["batch_repair"]["launches"]
    timing = {"phase_s": time.perf_counter() - t_phase, "parts_s": parts,
              "write_s": written["write_s"], "launches": launches,
              "classify_errors": {
                  k: results["classify"][k]
                  for k in ("hist_max_abs_err", "cls_max_abs_err")},
              "repair_chunks": results["batch_repair"]["chunks"]}
    log("scripts", **timing, results={k: v for k, v in results.items()
                                      if k != "batch_repair"})
    return {"launches": launches, "timing": timing}
