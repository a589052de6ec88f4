"""Inpainting-model training, the FFC-LaMa generator against a PatchGAN
(training/train_inpaint.py in the JAX package): self-supervised hole
filling on any folder of clean images, with LaMa's random masks (boxes
and thick strokes), hole-weighted L1 + gradient loss, and after an
L1-only warmup the non-saturating adversarial term and discriminator
feature matching, the discriminator on the hinge loss.

    python -m unet_watermark_tpu_torch.training.train_inpaint \\
        --clean-dir data/clean --output models/lama_ckpt --steps 2000 \\
        [--device cpu]

The parameters are float32 and the convs run in bf16 under autocast (the
JAX package's dtype=bf16 modules keep float32 parameters); the spectral
path, the losses and the feature matching are float32. A step draws its
crops and masks on the device from one torch.Generator and makes no
synchronizing call; only the log steps read values back.

Outputs: a port checkpoint directory at `output` (tree.npz with
params/... and batch_stats/..., meta.json), `output + ".npz"` in the
shipped format the JAX package's loader reads, and `output + ".snap.npz"`
snapshots. engines.get_engine("lama", weights_path=...) serves either.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import math
import os
import shutil
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import lama_flax_path, load_lama_weights, module_to_flax
from ..models.factory import init_model
from ..models.lama import LamaDiscriminator, LamaGenerator, create_lama
from ..ops.metrics import psnr
from ..ops.resize import resize_linear_u8
from ..utils import image_io
from ..utils.device import compute_autocast, resolve_device
from ..utils.shipping import load_variables, save_params_npz
from .checkpoint import save_checkpoint
from .state import Optimizer

logger = logging.getLogger(__name__)

CLEAN_EXTS = (".jpg", ".jpeg", ".png", ".webp")


# ---------------------------------------------------------------------------
# LaMa-style random masks (strokes + boxes), drawn and rastered on device
# ---------------------------------------------------------------------------

def draw_masks(gen: torch.Generator, n: int, size: int, device,
               max_boxes: int = 3, max_strokes: int = 4
               ) -> Dict[str, torch.Tensor]:
    """The random draws of random_mask_batch, each (n, k) on `device`:
    per box whether it is used (p 0.7), its width, height and corner;
    per stroke whether it is used (p 0.6), its start, angle, length and
    half-width. The ranges are JAX's; the streams are the generator's."""
    def u(k):
        return torch.rand((n, k), generator=gen, device=device)

    def ints(lo, hi, k):
        return torch.randint(lo, hi, (n, k), generator=gen, device=device,
                             dtype=torch.int32)

    b, s = max_boxes, max_strokes
    return {"box_use": u(b) < 0.7,
            "bw": ints(size // 8, size // 3, b),
            "bh": ints(size // 8, size // 3, b),
            "bx": ints(0, size - size // 3, b),
            "by": ints(0, size - size // 3, b),
            "stroke_use": u(s) < 0.6,
            "x0": u(s) * float(size), "y0": u(s) * float(size),
            "ang": u(s) * (2 * math.pi),
            "ln": size / 8 + u(s) * (size / 2 - size / 8),
            "wd": size / 64 + u(s) * (size / 16 - size / 64)}


def raster_masks(d: Dict[str, torch.Tensor], size: int) -> torch.Tensor:
    """(n, size, size, 1) float32 {0, 1} masks from draw_masks' draws, in
    one batched pass: the union of the used boxes and of the pixels
    nearer than a used stroke's half-width to its segment, in JAX's
    float32 arithmetic."""
    dev = d["bx"].device
    ys = torch.arange(size, device=dev, dtype=torch.int32).view(1, 1, -1, 1)
    xs = torch.arange(size, device=dev, dtype=torch.int32).view(1, 1, 1, -1)
    e = lambda k: d[k][..., None, None]  # noqa: E731 (n, k, 1, 1)
    boxes = ((ys >= e("by")) & (ys < e("by") + e("bh")) & (xs >= e("bx"))
             & (xs < e("bx") + e("bw")) & e("box_use")).any(1)
    px, py = xs.float(), ys.float()
    x0, y0 = e("x0"), e("y0")
    x1 = x0 + torch.cos(e("ang")) * e("ln")
    y1 = y0 + torch.sin(e("ang")) * e("ln")
    dx, dy = x1 - x0, y1 - y0
    t = torch.clamp(((px - x0) * dx + (py - y0) * dy)
                    / torch.clamp(dx * dx + dy * dy, min=1e-6), 0, 1)
    dist = torch.sqrt((px - (x0 + t * dx)) ** 2 + (py - (y0 + t * dy)) ** 2)
    strokes = ((dist < e("wd")) & e("stroke_use")).any(1)
    return (boxes | strokes).float()[..., None]


def random_mask_batch(gen: torch.Generator, n: int, size: int, device,
                      max_boxes: int = 3, max_strokes: int = 4
                      ) -> torch.Tensor:
    """(n, size, size, 1) random hole masks: rectangles + thick line
    strokes, 5-35 % coverage typical (the big-lama mask recipe's shape)."""
    return raster_masks(draw_masks(gen, n, size, device, max_boxes,
                                   max_strokes), size)


def _gradient(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return x[:, 1:] - x[:, :-1], x[:, :, 1:] - x[:, :, :-1]


def inpaint_loss(pred: torch.Tensor, target: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """L1 (hole-weighted) + gradient-consistency loss, NHWC."""
    hole_w = 1.0 + 9.0 * mask  # focus on the hole
    l1 = torch.mean(torch.abs(pred - target) * hole_w)
    gy_p, gx_p = _gradient(pred)
    gy_t, gx_t = _gradient(target)
    grad = torch.mean(torch.abs(gy_p - gy_t)) + \
        torch.mean(torch.abs(gx_p - gx_t))
    return l1 + 0.5 * grad


# ---------------------------------------------------------------------------
# clean images: the corpus on the device, or the host iterator
# ---------------------------------------------------------------------------

def clean_files(clean_dir: str) -> List[str]:
    """The folder's image files (JPEG, PNG, WEBP), sorted. Raises
    FileNotFoundError for a folder without any, and NotImplementedError
    (ROADMAP.md §A.5) for a form the port cannot decode where cv2 could
    (an animated WEBP), before any work; a file cv2 cannot read is
    skipped by the readers, as JAX skips it."""
    files = sorted(os.path.join(clean_dir, f) for f in os.listdir(clean_dir)
                   if f.lower().endswith(CLEAN_EXTS))
    if not files:
        raise FileNotFoundError(f"no images in {clean_dir}")
    for p in files:
        image_io.require_decodable(p)
    return files


def device_clean_sampler(clean_dir: str, batch: int, size: int,
                         seed: int = 0, max_mb: int = 2048, device="cuda"):
    """The clean corpus resident on `device` (uint8, uploaded once):
    returns (sample, n_images) where sample(gen) gives (batch, size, size,
    3) float32 random crops in [0, 1], one gather a call, drawn from the
    torch.Generator `gen` on the device. None when the corpus has mixed
    shapes, an image smaller than the crop, or more than `max_mb` (the
    caller falls back to load_clean_batches). Files that cv2 could not
    read are skipped, as in the JAX package."""
    dev = resolve_device(device)
    imgs, shape, total = [], None, 0
    for p in clean_files(clean_dir):
        try:
            img = image_io.read_rgb_tensor(p, dev)
        except image_io.UNREADABLE:
            continue
        if min(img.shape[:2]) < size:
            return None
        if shape is None:
            shape = img.shape
        if img.shape != shape:
            return None
        total += img.numel()
        if total > max_mb * (1 << 20):
            return None
        imgs.append(img)
    if not imgs:
        return None
    corpus = torch.stack(imgs)
    del imgs
    n, h, w = corpus.shape[:3]
    offs = torch.arange(size, device=dev)

    def sample(gen: torch.Generator) -> torch.Tensor:
        idx = torch.randint(0, n, (batch,), generator=gen, device=dev)
        ys = torch.randint(0, h - size + 1, (batch,), generator=gen,
                           device=dev)
        xs = torch.randint(0, w - size + 1, (batch,), generator=gen,
                           device=dev)
        rows = (ys[:, None] + offs)[:, :, None]
        cols = (xs[:, None] + offs)[:, None, :]
        return corpus[idx[:, None, None], rows, cols].float() / 255.0

    logger.info("device-resident clean corpus: %d images (%.2f GB uint8)",
                n, total / 2 ** 30)
    return sample, n


def load_clean_batches(clean_dir: str, batch: int, size: int,
                       seed: int = 0, cache_mb: int = 4096
                       ) -> Iterator[np.ndarray]:
    """Endless host iterator of (batch, size, size, 3) float32 [0, 1]
    crops, JAX's: the same numpy draws, decoded images kept up to
    `cache_mb`, an image smaller than the crop resized up by cv2's
    INTER_LINEAR (ops/resize.py)."""
    files = clean_files(clean_dir)
    rng = np.random.default_rng(seed)
    cache: dict = {}
    cache_bytes = 0
    budget = cache_mb * (1 << 20)

    def decoded(p: str):
        nonlocal cache_bytes
        img = cache.get(p)
        if img is not None:
            return img
        try:
            img = image_io.read_rgb(p)
        except image_io.UNREADABLE:
            return None
        h, w = img.shape[:2]
        if min(h, w) < size:
            img = resize_linear_u8(torch.from_numpy(img),
                                   (max(size, h), max(size, w))).numpy()
        if cache_bytes + img.nbytes <= budget:
            cache[p] = img
            cache_bytes += img.nbytes
        return img

    while True:
        out = []
        for _ in range(batch):
            img = decoded(files[rng.integers(len(files))])
            if img is None:
                continue
            h, w = img.shape[:2]
            y0 = rng.integers(0, h - size + 1)
            x0 = rng.integers(0, w - size + 1)
            out.append(img[y0:y0 + size, x0:x0 + size].astype(
                np.float32) / 255.0)
        while len(out) < batch:
            out.append(out[-1])
        yield np.stack(out)


# ---------------------------------------------------------------------------
# the GAN step
# ---------------------------------------------------------------------------

def _no_part(name: str):
    return contextlib.nullcontext()


class InpaintTrainer:
    """The generator and the discriminator (both in train mode, on one
    device), their optimizers (optax's clip_by_global_norm(1.0) + adam,
    training/state.Optimizer) and the step of the JAX package's
    train_inpaint. `compute_dtype` is the convs' autocast dtype; None runs
    them in the parameters' dtype (float32 or float64 in checks)."""

    def __init__(self, model: LamaGenerator, disc: LamaDiscriminator,
                 lr: float = 2e-4, d_lr: float = 1e-4,
                 adv_weight: float = 0.05, fm_weight: float = 10.0,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        self.model, self.disc = model.train(), disc.train()
        self.opt = Optimizer(model.parameters(), "adam", lr, 0.0, clip=1.0)
        self.d_opt = Optimizer(disc.parameters(), "adam", d_lr, 0.0,
                               clip=1.0)
        self.adv_weight, self.fm_weight = adv_weight, fm_weight
        self.compute_dtype = compute_dtype

    def g_loss_grads(self, images, masks, use_gan: bool):
        """JAX's g_loss_of and its gradient in the generator's parameters:
        (loss, the generator's output detached, the gradients). The
        running statistics move as the forward runs in train mode."""
        with compute_autocast(images.device, self.compute_dtype):
            out = self.model(images, masks)
        loss = inpaint_loss(out, images, masks)
        if use_gan:
            with compute_autocast(images.device, self.compute_dtype):
                fake_logits, fake_feats = self.disc(out)
                with torch.no_grad():  # no path to the generator
                    _, real_feats = self.disc(images)
            # non-saturating generator term + feature matching, float32
            adv = -torch.mean(fake_logits)
            fm = sum(torch.mean(torch.abs(f.float() - r.float()))
                     for f, r in zip(fake_feats, real_feats))
            loss = loss + self.adv_weight * adv + self.fm_weight * fm
        grads = torch.autograd.grad(loss, self.opt.params)
        return loss.detach(), out.detach(), grads

    def d_loss_grads(self, images, fake):
        """The hinge discriminator loss on real images and the generator's
        output (held fixed), and its gradient in the discriminator's
        parameters."""
        with compute_autocast(images.device, self.compute_dtype):
            real_logits, _ = self.disc(images)
            fake_logits, _ = self.disc(fake)
        loss = torch.mean(F.relu(1.0 - real_logits)) + \
            torch.mean(F.relu(1.0 + fake_logits))
        return loss.detach(), torch.autograd.grad(loss, self.d_opt.params)

    def step(self, images: torch.Tensor, gen: Optional[torch.Generator],
             use_gan: bool, masks: Optional[torch.Tensor] = None,
             part: Callable = _no_part):
        """One step on `images` (N, S, S, 3) float32: masks drawn from
        `gen` unless given; the generator updated, then (use_gan) the
        discriminator on the generator's output of this step, with the
        discriminator as it was. Returns (g_loss, d_loss) on the device.
        part(name) wraps the "generator", "g_optimizer", "discriminator"
        and "d_optimizer" stages for a caller that times them."""
        if masks is None:
            masks = random_mask_batch(gen, images.shape[0], images.shape[1],
                                      images.device)
        with part("generator"):
            g_loss, fake, grads = self.g_loss_grads(images, masks, use_gan)
        with part("g_optimizer"):
            self.opt.step(grads)
        if not use_gan:
            return g_loss, torch.zeros((), device=images.device)
        with part("discriminator"):
            d_loss, d_grads = self.d_loss_grads(images, fake)
        with part("d_optimizer"):
            self.d_opt.step(d_grads)
        return g_loss, d_loss

    @torch.no_grad()
    def val_psnr(self, images, masks) -> torch.Tensor:
        """Hole PSNR of the generator in eval mode (running statistics)."""
        self.model.eval()
        try:
            with compute_autocast(images.device, self.compute_dtype):
                out = self.model(images, masks)
        finally:
            self.model.train()
        return psnr(out, images, mask=masks)

    def weights(self) -> Dict[str, np.ndarray]:
        """The generator as flat flax float32 arrays (params/...,
        batch_stats/...)."""
        return module_to_flax(self.model, lama_flax_path)


def build_trainer(variant: str = "lama", seed: int = 0, device="cuda",
                  resume_from: Optional[str] = None,
                  **kwargs) -> InpaintTrainer:
    """The generator (flax-initialized from `seed`, or the weights of
    `resume_from`: a shipped-format .npz, a port checkpoint directory or
    the JAX package's orbax output directory)
    and the discriminator (from seed + 1) on `device`, with their
    optimizers; kwargs go to InpaintTrainer."""
    dev = resolve_device(device)
    if resume_from:
        flat = load_variables(resume_from)
        with torch.device("meta"):  # shapes only: the weights replace them
            model = create_lama(variant, torch.float32)
        load_lama_weights(model, flat)
        logger.info("resumed generator from %s", resume_from)
    else:
        model = init_model(create_lama(variant, torch.float32), seed)
    disc = init_model(LamaDiscriminator(), seed + 1)
    model, disc = model.to(dev), disc.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
        disc = disc.to(memory_format=torch.channels_last)
    return InpaintTrainer(model, disc, **kwargs)


def save_generator(path: str, flat: Dict[str, np.ndarray],
                   meta: Dict) -> Tuple[str, str]:
    """The port checkpoint directory at `path` (replaced if it exists) and
    the shipped-format `path + ".npz"`; returns both paths."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    save_checkpoint(os.path.dirname(path), os.path.basename(path), flat,
                    meta)
    return path, save_params_npz(path + ".npz", flat)


def train_inpaint(clean_dir: str, output_dir: str,
                  variant: str = "lama", img_size: int = 256,
                  batch_size: int = 8, steps: int = 2000,
                  lr: float = 2e-4, seed: int = 0,
                  log_every: int = 50,
                  gan: bool = True, warmup_steps: int = 500,
                  adv_weight: float = 0.05, fm_weight: float = 10.0,
                  d_lr: float = 1e-4,
                  resume_from: Optional[str] = None,
                  snapshot_every: int = 0, device="cuda") -> Dict:
    """Adversarially-trained FFC inpainting on `device` ("cuda" unless the
    caller asks for the CPU). Returns JAX's dict: final_loss,
    final_hole_psnr, history (g_loss, d_loss, hole_psnr every
    `log_every` steps) and checkpoint (the directory)."""
    dev = resolve_device(device)
    clean_files(clean_dir)  # refuses what cannot be read before any work
    trainer = build_trainer(variant, seed, dev, resume_from, lr=lr,
                            d_lr=d_lr, adv_weight=adv_weight,
                            fm_weight=fm_weight)

    # fixed validation batch + masks for hole-PSNR tracking
    val_iter = load_clean_batches(clean_dir, batch_size, img_size, seed + 99)
    val_images = torch.from_numpy(next(val_iter)).to(dev)
    val_masks = random_mask_batch(torch.Generator(dev).manual_seed(seed + 7),
                                  batch_size, img_size, dev)

    gen = torch.Generator(dev).manual_seed(seed)
    # device-resident corpus when it fits: random crops on the device; the
    # host iterator is the fallback for oversized or mixed corpora
    sampler = device_clean_sampler(clean_dir, batch_size, img_size, seed,
                                   device=dev)
    if sampler is None:
        batches = load_clean_batches(clean_dir, batch_size, img_size, seed)
        sample = lambda g: torch.from_numpy(next(batches)).to(dev)  # noqa
    else:
        sample, _ = sampler
    history = []
    t0 = time.time()
    for i in range(steps):
        use_gan = bool(gan) and i >= warmup_steps
        g_loss, d_loss = trainer.step(sample(gen), gen, use_gan)
        if (i + 1) % log_every == 0:
            gl, dl = float(g_loss), float(d_loss)
            pv = float(trainer.val_psnr(val_images, val_masks))
            history.append({"step": i + 1, "g_loss": gl, "d_loss": dl,
                            "hole_psnr": pv})
            rate = (i + 1) * batch_size / (time.time() - t0)
            logger.info(
                "step %d: g_loss=%.4f d_loss=%.4f hole_psnr=%.2f dB "
                "(%.1f img/s)%s", i + 1, gl, dl, pv, rate,
                " [gan]" if use_gan else " [warmup]")
        if snapshot_every and (i + 1) % snapshot_every == 0:
            save_params_npz(os.path.abspath(output_dir) + ".snap.npz",
                            trainer.weights())
            logger.info("snapshot at step %d", i + 1)

    meta = {"variant": variant, "img_size": img_size, "steps": steps,
            "seed": seed, "history": history}
    path, npz_path = save_generator(output_dir, trainer.weights(), meta)
    logger.info("inpaint weights saved: %s, shipping copy %s", path,
                npz_path)
    final = history[-1] if history else {}
    return {"final_loss": final.get("g_loss"),
            "final_hole_psnr": final.get("hole_psnr"),
            "history": history, "checkpoint": path}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description="train FFC inpainting model")
    p.add_argument("--clean-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--variant", default="lama",
                   choices=["lama", "big-lama", "mat"])
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--no-gan", action="store_true",
                   help="L1+gradient only (round-1 recipe)")
    p.add_argument("--warmup-steps", type=int, default=500)
    p.add_argument("--adv-weight", type=float, default=0.05)
    p.add_argument("--fm-weight", type=float, default=10.0)
    p.add_argument("--d-lr", type=float, default=1e-4)
    p.add_argument("--resume-from", type=str, default=None)
    p.add_argument("--snapshot-every", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    r = train_inpaint(args.clean_dir, args.output, args.variant,
                      args.img_size, args.batch_size, args.steps, args.lr,
                      gan=not args.no_gan, warmup_steps=args.warmup_steps,
                      adv_weight=args.adv_weight, fm_weight=args.fm_weight,
                      d_lr=args.d_lr, resume_from=args.resume_from,
                      snapshot_every=args.snapshot_every, device=args.device)
    print({"final_loss": r["final_loss"],
           "final_hole_psnr": r["final_hole_psnr"],
           "checkpoint": r["checkpoint"]})
    return 0


if __name__ == "__main__":
    main()
