"""Trainer of the latent-diffusion inpainter
(training/train_latent_diffusion.py in the JAX package). Two stages in one
run: (1) the autoencoder learns a /8 latent by L1 reconstruction (adam,
no clipping); (2) with the autoencoder frozen, the denoiser learns
eps-prediction on cosine-schedule noised latents, conditioned on the
masked image's latent and the hole mask (train_inpaint's random masks;
clip_by_global_norm(1.0) + adam). Both on train_inpaint's clean-image
crops, bf16 convs under autocast over float32 parameters.

    python -m unet_watermark_tpu_torch.training.train_latent_diffusion \\
        --clean-dir workspace/train/clean --output models/latent_diffusion \\
        --img-size 256 --ae-steps 2000 --dn-steps 6000 [--device cpu]

Writes a port checkpoint directory at `output` (tree.npz with ae/... and
denoiser/..., meta.json); --ship also writes the shipped-format .npz
(ship_weights), which the JAX package's LatentInpainter reads too.
"""
from __future__ import annotations

import argparse
import functools
import logging
import os
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..diffusion.latent_diffusion import (T_TRAIN, LatentDenoiser,
                                          TinyAutoencoder, alpha_bars,
                                          downsample_mask, init_ld_modules,
                                          ld_weights)
from ..utils.device import compute_autocast, resolve_device
from ..utils.shipping import WEIGHTS_DIR, save_params_npz
from .checkpoint import save_checkpoint
from .state import Optimizer
from .train_inpaint import (clean_files, device_clean_sampler,
                            load_clean_batches, random_mask_batch)

logger = logging.getLogger(__name__)


@functools.lru_cache(maxsize=8)
def _alpha_bars_on(device: torch.device) -> torch.Tensor:
    """The schedule on the device, uploaded once per device (an upload in
    the step would block the host)."""
    return torch.from_numpy(alpha_bars()).to(device)


class LatentDiffusionTrainer:
    """The autoencoder and denoiser on one device, their optimizers, and
    the two steps of the JAX trainer. `compute_dtype` is the convs'
    autocast dtype; None runs them in the parameters' dtype."""

    def __init__(self, ae: TinyAutoencoder, denoiser: LatentDenoiser,
                 lr: float = 2e-4,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        self.ae, self.denoiser = ae, denoiser
        self.ae_opt = Optimizer(ae.parameters(), "adam", lr, 0.0, clip=0.0)
        self.dn_opt = Optimizer(denoiser.parameters(), "adam", lr, 0.0,
                                clip=1.0)
        self.compute_dtype = compute_dtype

    def ae_loss_grads(self, images):
        """The L1 reconstruction loss and its gradient in the
        autoencoder's parameters."""
        with compute_autocast(images.device, self.compute_dtype):
            recon = self.ae(images)
        loss = torch.mean(torch.abs(recon - images))
        return loss.detach(), torch.autograd.grad(loss, self.ae_opt.params)

    def ae_step(self, images) -> torch.Tensor:
        loss, grads = self.ae_loss_grads(images)
        self.ae_opt.step(grads)
        return loss

    def dn_inputs(self, images, gen: Optional[torch.Generator] = None,
                  masks=None, t=None, eps=None):
        """The denoiser's training inputs: (z_t, z_masked, mask_lat, t,
        eps), with the masks, timesteps in [0, T) and noise drawn from
        `gen` unless given; the latent from the frozen autoencoder."""
        dev = images.device
        n, size = images.shape[:2]
        if masks is None:
            masks = random_mask_batch(gen, n, size, dev)
        with torch.no_grad(), compute_autocast(dev, self.compute_dtype):
            z0 = self.ae.encode(images)
        mask_lat = downsample_mask(masks, z0.shape[1], z0.shape[2])
        z_masked = z0 * (1.0 - mask_lat)
        if t is None:
            t = torch.randint(0, T_TRAIN, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        if eps is None:
            eps = torch.randn(z0.shape, generator=gen, device=dev)
        a = _alpha_bars_on(dev)[t.long() + 1].to(z0.dtype)[:, None, None,
                                                             None]
        z_t = torch.sqrt(a) * z0 + torch.sqrt(1.0 - a) * eps
        return z_t, z_masked, mask_lat, t, eps

    def dn_loss_grads(self, images, gen=None, masks=None, t=None, eps=None):
        """The eps-prediction MSE and its gradient in the denoiser's
        parameters."""
        z_t, z_masked, mask_lat, t, eps = self.dn_inputs(images, gen, masks,
                                                         t, eps)
        with compute_autocast(images.device, self.compute_dtype):
            pred = self.denoiser(z_t, z_masked, mask_lat, t)
        loss = torch.mean((pred - eps) ** 2)
        return loss.detach(), torch.autograd.grad(loss, self.dn_opt.params)

    def dn_step(self, images, gen) -> torch.Tensor:
        loss, grads = self.dn_loss_grads(images, gen)
        self.dn_opt.step(grads)
        return loss

    def weights(self) -> Dict[str, np.ndarray]:
        return ld_weights(self.ae, self.denoiser)


def build_ld_trainer(seed: int = 0, device="cuda", lr: float = 2e-4,
                     compute_dtype: Optional[torch.dtype] = torch.bfloat16
                     ) -> LatentDiffusionTrainer:
    dev = resolve_device(device)
    ae, denoiser = init_ld_modules(seed)
    ae, denoiser = ae.to(dev), denoiser.to(dev)
    if dev.type == "cuda":
        ae = ae.to(memory_format=torch.channels_last)
        denoiser = denoiser.to(memory_format=torch.channels_last)
    return LatentDiffusionTrainer(ae, denoiser, lr, compute_dtype)


def train_latent_diffusion(clean_dir: str, output_dir: str,
                           img_size: int = 256, batch_size: int = 16,
                           ae_steps: int = 2000, dn_steps: int = 6000,
                           lr: float = 2e-4, seed: int = 0,
                           log_every: int = 100, device="cuda") -> Dict:
    """Both stages on `device` ("cuda" unless the caller asks for the
    CPU). Returns {"checkpoint": the directory, "params": the flat
    weights}."""
    dev = resolve_device(device)
    clean_files(clean_dir)  # refuses what cannot be read before any work
    trainer = build_ld_trainer(seed, dev, lr)

    sampler = device_clean_sampler(clean_dir, batch_size, img_size, seed,
                                   device=dev)
    gen = torch.Generator(dev).manual_seed(seed + 11)
    if sampler is not None:
        sample, _ = sampler
        next_images = lambda: sample(gen)  # noqa: E731
    else:
        batches = load_clean_batches(clean_dir, batch_size, img_size, seed)
        next_images = lambda: torch.from_numpy(next(batches)).to(dev)  # noqa

    t0 = time.time()
    for i in range(ae_steps):
        loss = trainer.ae_step(next_images())
        if (i + 1) % log_every == 0:
            logger.info("[ae] step %d: l1=%.4f (%.1f img/s)", i + 1,
                        float(loss),
                        (i + 1) * batch_size / (time.time() - t0))

    t0 = time.time()
    for i in range(dn_steps):
        loss = trainer.dn_step(next_images(), gen)
        if (i + 1) % log_every == 0:
            logger.info("[denoiser] step %d: mse=%.4f (%.1f img/s)", i + 1,
                        float(loss),
                        (i + 1) * batch_size / (time.time() - t0))

    params = trainer.weights()
    path = os.path.abspath(output_dir)
    if os.path.exists(path):
        shutil.rmtree(path)
    save_checkpoint(os.path.dirname(path), os.path.basename(path), params,
                    {"img_size": img_size, "ae_steps": ae_steps,
                     "dn_steps": dn_steps, "seed": seed})
    logger.info("latent-diffusion weights saved: %s", path)
    return {"checkpoint": path, "params": params}


def ship_weights(params: Dict[str, np.ndarray], dest: str = None) -> str:
    """Write the trained weights as the shipped bf16 .npz (default:
    unet_watermark_tpu/weights/latent_diffusion.npz, the path
    utils/shipping.resolve('diffusion') finds first)."""
    dest = dest or str(WEIGHTS_DIR / "latent_diffusion.npz")
    save_params_npz(dest, params)
    logger.info("shipped diffusion weights: %s", dest)
    return dest


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser()
    p.add_argument("--clean-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--ae-steps", type=int, default=2000)
    p.add_argument("--dn-steps", type=int, default=6000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--ship", action="store_true",
                   help="also write the bf16 .npz distribution file "
                        "under unet_watermark_tpu/weights/")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    r = train_latent_diffusion(args.clean_dir, args.output, args.img_size,
                               args.batch_size, args.ae_steps, args.dn_steps,
                               args.lr, device=args.device)
    if args.ship:
        r["shipped"] = ship_weights(r.pop("params"))
    else:
        r.pop("params", None)
    print({k: v for k, v in r.items() if k != "params"})
    return 0


if __name__ == "__main__":
    main()
