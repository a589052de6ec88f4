"""The frozen quality protocol (scripts/quality_report.py of the JAX
package): one reproducible table of every shipped configuration on a
seed-frozen held-out set, regenerated bit for bit from the procedural
generators (data/synth_clean.py, data/gen_data.py), scoring

  * each segmentation checkpoint (eval_segmentation): the raw network mask
    at PREDICT.THRESHOLD, the parity pipeline and the tight pipeline, each
    as IoU, F1, precision and recall; the `_int8` rows run the int8 tier
    with the weights' shipped .quant.json sidecar (ops/quant.py);
  * each fill engine (eval_inpaint_engines, scripts/inpaint_quality.py):
    hole PSNR and SSIM on LaMa-recipe random holes at 256²;
  * the fused detect→optimize→inpaint repair (eval_e2e_repair), push-pull
    and LaMa, in the parity and the tight mask modes, as PSNR to the clean
    image against the no-op floor PSNR(watermarked, clean).

Seeds 7700/7701 (smooth tier) and 7800/7801 (textured tier) are reserved
for this protocol. Everything runs on `device` ("cuda" unless the caller
asks for the CPU). JAX scores its two segmentation pipelines with host cv2
mirrors of the device chains; the port runs the chains they mirror:
`pipeline` is inference/maskproc.optimize_watermark_mask_batch (K1, the
largest-component rule, K2: the hand-written kernels on the card) and
`pipeline_tight` is optimize_watermark_mask_tight; the e2e repair runs the
predictor's fused fn, whose parity mode is the same chain.

    python -m unet_watermark_tpu_torch.scripts.quality_report \
        --workdir workspace/quality --limit 64 [--device cpu]

writes <workdir>/quality_report.json; --docs (JAX's meaning) refreshes the
table between the AUTOGEN markers of the repository's docs/QUALITY.md.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..configs import get_cfg_defaults
from ..inference import maskproc
from ..ops import quant as quant_ops
from ..ops.resize import resize_linear_u8, resize_nearest
from ..utils import image_io
from ..utils.device import resolve_device
from ..utils.shipping import WEIGHTS_DIR, keep_loads, resolve

logger = logging.getLogger(__name__)

CLEAN_SEED = 7700
COMPOSE_SEED = 7701
# the textured tier (data/synth_clean.synth_textured_image)
TEX_CLEAN_SEED = 7800
TEX_COMPOSE_SEED = 7801
IMG_SIZE = 512


def ensure_frozen_set(workdir: str, n: int = 64,
                      img_size: int = IMG_SIZE,
                      textured: bool = False, device="cuda") -> str:
    """The frozen triad set under <workdir>/heldout (or heldout_tex):
    watermarked/ clean/ masks/, n samples, made on first use (the clean
    sources under clean_src[_tex], 12 logos under logos) and reused once
    complete; the generators' per-index streams make a re-run's files
    equal, and the set's bytes do not depend on the machine (its text
    samples take no font draws)."""
    from ..data.gen_data import generate_dataset
    from ..data.synth_clean import generate_clean_dataset, generate_logo_set

    suffix = "_tex" if textured else ""
    root = os.path.join(workdir, "heldout" + suffix)
    wm_dir = os.path.join(root, "watermarked")
    if os.path.isdir(wm_dir) and len(os.listdir(wm_dir)) >= n:
        return root
    device = resolve_device(device)
    clean_src = os.path.join(workdir, "clean_src" + suffix)
    logos = os.path.join(workdir, "logos")
    cseed = TEX_CLEAN_SEED if textured else CLEAN_SEED
    generate_clean_dataset(clean_src, count=max(16, n // 2),
                           size=img_size, seed=cseed,
                           texture_ratio=1.0 if textured else 0.0,
                           device=device)
    generate_logo_set(logos, count=12, seed=CLEAN_SEED + 1)
    # no fonts: JAX's generator takes draws for the font files it finds,
    # so its set depends on the machine's fonts (ROADMAP.md §C.12); this
    # one draws as JAX's does on a machine without any, everywhere
    stats = generate_dataset(
        clean_src, root, logos_dir=logos, count=n,
        seed=TEX_COMPOSE_SEED if textured else COMPOSE_SEED, device=device,
        fonts=())
    logger.info("frozen held-out set%s: %s", suffix, stats)
    return root


def _load_triads(root: str, limit: int, img_size: int = IMG_SIZE,
                 device="cuda") -> Iterator[Tuple[str, torch.Tensor,
                                                  torch.Tensor,
                                                  torch.Tensor]]:
    """(name, watermarked RGB, clean RGB, mask) uint8 tensors on `device`,
    the first `limit` names in sorted order; an image whose height is not
    img_size is resized to img_size² (the mask by nearest), as JAX does."""
    device = resolve_device(device)
    wm_dir = os.path.join(root, "watermarked")
    cl_dir = os.path.join(root, "clean")
    mk_dir = os.path.join(root, "masks")
    for name in sorted(os.listdir(wm_dir))[:limit]:
        stem = os.path.splitext(name)[0]
        wm = image_io.read_rgb_tensor(os.path.join(wm_dir, name), device)
        cl = image_io.read_rgb_tensor(os.path.join(cl_dir, name), device)
        mk = torch.from_numpy(image_io.read_gray(
            os.path.join(mk_dir, stem + ".png"))).to(device)
        if wm.shape[0] != img_size:
            wm = resize_linear_u8(wm, (img_size, img_size))
            cl = resize_linear_u8(cl, (img_size, img_size))
            mk = resize_nearest(mk, (img_size, img_size))
        yield name, wm, cl, mk


def _stats(t: float, f_p: float, f_n: float) -> Dict[str, float]:
    iou = t / max(t + f_p + f_n, 1e-7)
    prec = t / max(t + f_p, 1e-7)
    rec = t / max(t + f_n, 1e-7)
    f1 = 2 * prec * rec / max(prec + rec, 1e-7)
    return {"iou": round(iou, 4), "f1": round(f1, 4),
            "precision": round(prec, 4), "recall": round(rec, 4)}


def eval_segmentation(root: str, limit: int, batch: int = 8,
                      weights: Optional[str] = None,
                      model_name: Optional[str] = None,
                      encoder: Optional[str] = None,
                      img_size: int = IMG_SIZE,
                      quant: bool = False, device="cuda") -> Dict:
    """Raw-network and pipeline mask quality of one segmentation
    checkpoint, with JAX's keys."""
    from ..inference.predict import WatermarkPredictor

    device = resolve_device(device)
    cfg = get_cfg_defaults()
    cfg.DATA.IMG_SIZE = img_size
    if model_name:
        cfg.MODEL.NAME = model_name
    if encoder:
        cfg.MODEL.ENCODER_NAME = encoder
    path = resolve("seg", cfg=cfg, explicit=weights)
    if not path or not os.path.exists(path):
        return {"error": f"no weights resolve for {cfg.MODEL.NAME}/"
                         f"{cfg.MODEL.ENCODER_NAME}"}
    if quant:
        sidecar = quant_ops.quant_sidecar_path(path)
        if not os.path.exists(sidecar):
            return {"error": f"no calibration sidecar at {sidecar}"}
        cfg.PREDICT.QUANT = True
    pred = WatermarkPredictor(cfg, weights_path=path, device=device)

    counts = {k: torch.zeros(3, dtype=torch.float64, device=device)
              for k in ("raw", "pipeline", "pipeline_tight")}
    buf_img, buf_msk = [], []

    def flush():
        if not buf_img:
            return
        x = torch.stack(buf_img).to(torch.float32) / 255.0
        raw = pred.predict_masks(x)
        gt = torch.stack(buf_msk) > 127
        outs = {"raw": raw,
                "pipeline": maskproc.optimize_watermark_mask_batch(raw),
                "pipeline_tight": maskproc.optimize_watermark_mask_tight(
                    raw)}
        for key, out in outs.items():
            p = out > 0.5
            counts[key] += torch.stack([
                (p & gt).sum(), (p & ~gt).sum(),
                (~p & gt).sum()]).to(torch.float64)
        buf_img.clear()
        buf_msk.clear()

    n = 0
    for _, wm, _, mk in _load_triads(root, limit, img_size, device):
        buf_img.append(wm)
        buf_msk.append(mk)
        n += 1
        if len(buf_img) == batch:
            flush()
    flush()
    c = {k: [float(v) for v in t.tolist()] for k, t in counts.items()}
    return {"weights": path, "model": cfg.MODEL.NAME,
            "encoder": cfg.MODEL.ENCODER_NAME, "n_images": n,
            "quant": bool(pred._quant_scales),
            "raw": _stats(*c["raw"]), "pipeline": _stats(*c["pipeline"]),
            "pipeline_tight": _stats(*c["pipeline_tight"])}


# ---------------------------------------------------------------------------
# inpaint + e2e eval
# ---------------------------------------------------------------------------
def eval_inpaint_engines(workdir: str, limit: int, engines: List[str],
                         textured: bool = False, device="cuda") -> Dict:
    """Hole quality per engine on the frozen clean images
    (inpaint_quality.evaluate_engines at 256², up to 32 images)."""
    from .inpaint_quality import evaluate_engines

    clean_src = os.path.join(workdir,
                             "clean_src_tex" if textured else "clean_src")
    return evaluate_engines(
        clean_src, engines, img_size=256, batch_size=8,
        limit=min(limit, 32),
        seed=TEX_CLEAN_SEED if textured else CLEAN_SEED, device=device)


def eval_e2e_repair(root: str, limit: int, batch: int = 16,
                    seg_weights: Optional[str] = None,
                    img_size: int = IMG_SIZE,
                    mask_mode: str = "parity", device="cuda") -> Dict:
    """Watermarked → the default config's fused detect→optimize→inpaint
    under `mask_mode` → PSNR to clean, whole-image and in the watermark
    region, for push-pull and LaMa, against the no-op floor."""
    from ..inference.predict import WatermarkPredictor

    device = resolve_device(device)
    cfg = get_cfg_defaults()
    cfg.DATA.IMG_SIZE = img_size
    cfg.PREDICT.MASK_MODE = mask_mode
    predictor = WatermarkPredictor(cfg, weights_path=seg_weights,
                                   device=device)
    wms, cls, mks = [], [], []
    for _, wm, cl, mk in _load_triads(root, limit, img_size, device):
        wms.append(wm)
        cls.append(cl)
        mks.append(mk)
    wm01 = torch.stack(wms).float() / 255.0
    cl01 = torch.stack(cls).float() / 255.0
    gt = (torch.stack(mks) > 127).float()[..., None]
    out: Dict = {"n_images": len(wms)}
    out["floor"] = {"psnr_to_clean_db": _mean_psnr(wm01, cl01),
                    "region_psnr_db": _mean_psnr(wm01, cl01, gt)}
    for engine in ("pushpull", "lama"):
        fused = predictor.make_fused_repair_fn(inpaint_engine=engine)
        rep01 = torch.cat([fused(wm01[i:i + batch])[0]
                           for i in range(0, len(wms), batch)])
        out[engine] = {
            "engine_used": fused.engine_used,
            "psnr_to_clean_db": _mean_psnr(rep01, cl01),
            "region_psnr_db": _mean_psnr(rep01, cl01, gt),
        }
    return out


def _mean_psnr(a: torch.Tensor, b: torch.Tensor,
               region: Optional[torch.Tensor] = None) -> float:
    """Mean over images of 10 log10(1 / MSE) (MSE floored at 1e-10), the
    MSE in `region` where one is given; rounded to 2 decimals."""
    a, b = a.float(), b.float()
    if region is None:
        se = ((a - b) ** 2).mean(dim=(1, 2, 3))
    else:
        w = torch.broadcast_to(region.float(), a.shape)
        se = (((a - b) ** 2) * w).sum(dim=(1, 2, 3)) / torch.clamp(
            w.sum(dim=(1, 2, 3)), min=1.0)
    db = 10.0 * torch.log10(1.0 / torch.clamp(se.double(), min=1e-10))
    return round(float(db.mean()), 2)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
def build_report(workdir: str, limit: int = 64,
                 seg_configs: Optional[List[Dict]] = None,
                 img_size: int = IMG_SIZE,
                 tiers: Optional[List[str]] = None, device="cuda") -> Dict:
    """JAX's report dict: per tier, the segmentation rows (the int8 rows
    only where a sidecar ships), the fill engines (the diffusion engine
    where its weights resolve) and the e2e repair in both mask modes."""
    device = resolve_device(device)
    if seg_configs is None:
        seg_configs = [
            {"model_name": "UnetPlusPlus", "encoder": "resnet34"},
            {"model_name": "Unet", "encoder": "resnet34"},
            {"model_name": "UnetPlusPlus", "encoder": "resnet34",
             "quant": True},
            {"model_name": "Unet", "encoder": "resnet34", "quant": True},
        ]
        if os.path.exists(os.path.join(WEIGHTS_DIR,
                                       "seg_unettpu_resnet34.npz")):
            seg_configs += [
                {"model_name": "UnetTPU", "encoder": "resnet34"},
                {"model_name": "UnetTPU", "encoder": "resnet34",
                 "quant": True},
            ]
    tiers = tiers or ["smooth", "textured"]
    report: Dict = {
        "protocol": {"clean_seed": CLEAN_SEED, "compose_seed": COMPOSE_SEED,
                     "tex_clean_seed": TEX_CLEAN_SEED,
                     "tex_compose_seed": TEX_COMPOSE_SEED,
                     "img_size": img_size, "n_images": limit,
                     "tiers": tiers},
    }
    engines = ["pushpull", "lama"]
    if resolve("diffusion"):
        engines.append("diffusion")
    with keep_loads():  # each weights file decoded once for the report
        for tier in tiers:
            textured = tier == "textured"
            root = ensure_frozen_set(workdir, n=limit, img_size=img_size,
                                     textured=textured, device=device)
            tr: Dict = {"segmentation": {}}
            for sc in seg_configs:
                key = f"{sc['model_name'].lower()}_{sc['encoder']}"
                if sc.get("quant"):
                    key += "_int8"
                logger.info("[%s] seg eval: %s", tier, key)
                res = eval_segmentation(
                    root, limit, weights=sc.get("weights"),
                    model_name=sc["model_name"], encoder=sc["encoder"],
                    img_size=img_size, quant=sc.get("quant", False),
                    device=device)
                if sc.get("quant") and "error" in res:
                    logger.info("skipping %s: %s", key, res["error"])
                    continue
                tr["segmentation"][key] = res
            logger.info("[%s] inpaint engine eval", tier)
            tr["inpaint"] = eval_inpaint_engines(
                workdir, limit, engines, textured=textured, device=device)
            logger.info("[%s] e2e repair eval", tier)
            tr["e2e_repair"] = eval_e2e_repair(
                root, limit, img_size=img_size, device=device)
            logger.info("[%s] e2e repair eval (tight mask mode)", tier)
            tr["e2e_repair_tight"] = eval_e2e_repair(
                root, limit, img_size=img_size, mask_mode="tight",
                device=device)
            report[tier] = tr
    if "smooth" in report:  # JAX's flat keys for its round-3 readers
        report.update({k: report["smooth"][k]
                       for k in ("segmentation", "inpaint", "e2e_repair")})
    return report


def _render_tier(tier_report: Dict, heading_suffix: str = "") -> List[str]:
    lines: List[str] = []
    lines.append(f"### Segmentation (held-out masks){heading_suffix}")
    lines.append("")
    lines.append("| config | raw IoU | raw F1 | pipeline IoU | "
                 "tight IoU | tight recall | precision | recall |")
    lines.append("|---|---|---|---|---|---|---|---|")
    for key, s in tier_report["segmentation"].items():
        if "error" in s:
            lines.append(f"| {key} | — | — | — | — | — | — | — | "
                         f"({s['error']}) ")
            continue
        t = s.get("pipeline_tight")
        t_iou = f"{t['iou']:.3f}" if t else "—"
        t_rec = f"{t['recall']:.3f}" if t else "—"
        lines.append(
            f"| {key} | {s['raw']['iou']:.3f} | {s['raw']['f1']:.3f} | "
            f"{s['pipeline']['iou']:.3f} | {t_iou} | {t_rec} | "
            f"{s['raw']['precision']:.3f} | "
            f"{s['raw']['recall']:.3f} |")
    lines.append("")
    lines.append("### Inpainting (LaMa-protocol random holes, 256²)"
                 f"{heading_suffix}")
    lines.append("")
    lines.append("| engine | hole PSNR (dB) | SSIM |")
    lines.append("|---|---|---|")
    for k, v in tier_report["inpaint"].items():
        if not isinstance(v, dict):
            continue
        lines.append(f"| {k} | {v['hole_psnr_db']} | {v['ssim']} |")
    lines.append("")
    lines.append("### End-to-end repair (fused detect→optimize→inpaint)"
                 f"{heading_suffix}")
    lines.append("")
    lines.append("| path | PSNR to clean (dB) | watermark-region PSNR |")
    lines.append("|---|---|---|")
    e = tier_report["e2e_repair"]
    lines.append(f"| no-op floor (watermarked) | "
                 f"{e['floor']['psnr_to_clean_db']} | "
                 f"{e['floor']['region_psnr_db']} |")
    for k in ("pushpull", "lama"):
        v = e.get(k)
        if v:
            lines.append(f"| {k} [{v['engine_used']}] | "
                         f"{v['psnr_to_clean_db']} | {v['region_psnr_db']} |")
    et = tier_report.get("e2e_repair_tight")
    if et:
        for k in ("pushpull", "lama"):
            v = et.get(k)
            if v:
                lines.append(
                    f"| {k} [{v['engine_used']}], tight mask | "
                    f"{v['psnr_to_clean_db']} | {v['region_psnr_db']} |")
    return lines


def render_markdown(report: Dict) -> str:
    lines = []
    p = report["protocol"]
    lines.append(f"Protocol: {p['n_images']} held-out 512² triads per tier. "
                 f"Smooth tier seeds {p['clean_seed']}/{p['compose_seed']}; "
                 f"textured tier seeds {p.get('tex_clean_seed', '—')}/"
                 f"{p.get('tex_compose_seed', '—')} (all reserved; disjoint "
                 f"from every training seed).")
    lines.append("")
    if "smooth" in report:
        lines.append("## Smooth tier (round-1-3 protocol corpus)")
        lines.append("")
        lines.extend(_render_tier(report["smooth"]))
        if "textured" in report:
            lines.append("")
            lines.append("## Textured tier (natural-statistics corpus, "
                         "round 4)")
            lines.append("")
            lines.extend(_render_tier(report["textured"]))
    else:
        lines.extend(_render_tier(report))
    return "\n".join(lines)


AUTOGEN_BEGIN = "<!-- AUTOGEN:quality_report BEGIN -->"
AUTOGEN_END = "<!-- AUTOGEN:quality_report END -->"


def update_docs(report: Dict, docs_path: str) -> None:
    """The rendered tables between the AUTOGEN markers of docs_path (the
    block appended where the markers are missing; a new file with JAX's
    heading where the file is)."""
    block = f"{AUTOGEN_BEGIN}\n{render_markdown(report)}\n{AUTOGEN_END}"
    if os.path.exists(docs_path):
        with open(docs_path) as f:
            text = f.read()
        if AUTOGEN_BEGIN in text:
            text = (text.split(AUTOGEN_BEGIN)[0] + block
                    + text.split(AUTOGEN_END)[-1])
        else:
            text += "\n" + block + "\n"
    else:
        text = ("# Quality record\n\nRegenerated per round by "
                "`python -m unet_watermark_tpu.scripts.quality_report "
                "--docs`.\n\n" + block + "\n")
    with open(docs_path, "w") as f:
        f.write(text)


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO, force=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="workspace/quality")
    ap.add_argument("--limit", type=int, default=64)
    ap.add_argument("--img-size", type=int, default=IMG_SIZE)
    ap.add_argument("--docs", action="store_true",
                    help="refresh docs/QUALITY.md AUTOGEN block")
    ap.add_argument("--tiers", nargs="+", default=["smooth", "textured"],
                    choices=["smooth", "textured"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report = build_report(args.workdir, args.limit, img_size=args.img_size,
                          tiers=args.tiers, device=args.device)
    os.makedirs(args.workdir, exist_ok=True)
    with open(os.path.join(args.workdir, "quality_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    if args.docs:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        update_docs(report, os.path.join(repo, "docs", "QUALITY.md"))
    return report


if __name__ == "__main__":
    main()
