"""Latent-diffusion inpainting (diffusion/latent_diffusion.py in the JAX
package): a conv autoencoder to a /8 latent, a denoiser UNet over latents
conditioned on the masked image's latent, the hole mask and the timestep,
and a DDIM sampler whose known region follows the forward process of the
image's latent at every step.

The modules keep float32 parameters; the engine runs their convs in bf16
under autocast, as the JAX package's dtype=bf16 modules do, with the
latent, the timestep embedding and its two dense layers, the schedule and
the outputs in float32. NHWC at each module's boundary, NCHW inside. The
sampler is a Python loop of `steps` denoiser calls on the device; its
noise comes from a torch.Generator on the device (the JAX package's
jax.random stream cannot be reproduced), or from the caller (`sample`).
"""
from __future__ import annotations

import functools
import logging
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..inference.tiled import pad_to_multiple
from ..models.convert import ld_flax_path, ld_torch_name, load_flax_weights
from ..models.convert import module_to_flax
from ..utils.device import compute_autocast, resolve_device
from ..utils.shipping import load_variables, resolve

logger = logging.getLogger(__name__)

LATENT_CHANNELS = 4
DOWN_FACTOR = 8
T_TRAIN = 1000
GN_EPS = 1e-6  # flax.linen.GroupNorm's epsilon
EMB_DIM = 128


# ---------------------------------------------------------------------------
# schedule (cosine, Nichol & Dhariwal 2021)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def alpha_bars(T: int = T_TRAIN) -> np.ndarray:
    t = np.linspace(0, 1, T + 1)
    f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    ab = np.clip(f / f[0], 1e-5, 1.0)
    return ab.astype(np.float32)  # length T+1, ab[0] = 1


def ddim_timesteps(steps: int) -> np.ndarray:
    """The sampler's timesteps, T-1 down to 1: jnp.linspace in float32,
    truncated to int32, as the JAX sampler makes them."""
    return np.linspace(T_TRAIN - 1, 1, steps, dtype=np.float32).astype(
        np.int32)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(8, ch, eps=GN_EPS)


def _compute_dtype(x: torch.Tensor, weight: torch.Tensor) -> torch.dtype:
    """The dtype a flax module with dtype=<the autocast dtype> casts its
    input to: autocast's where it is on, else the parameters'."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return weight.dtype


class Encoder(nn.Module):
    """3 stride-2 convs (GroupNorm(8), SiLU) to a /8 latent of 4 channels,
    tanh-bounded in float32."""

    def __init__(self, base: int = 64):
        super().__init__()
        cin, ch = 3, base
        for i in range(3):
            setattr(self, f"down{i}", nn.Conv2d(cin, ch, 3, 2, 1))
            setattr(self, f"norm{i}", _gn(ch))
            cin, ch = ch, min(ch * 2, 256)
        self.to_latent = nn.Conv2d(cin, LATENT_CHANNELS, 3, 1, 1)

    def forward(self, x):
        """(N, H, W, 3) in [0, 1] → (N, H/8, W/8, 4) float32."""
        y = x.permute(0, 3, 1, 2)
        y = y.to(_compute_dtype(y, self.down0.weight)) * 2.0 - 1.0
        for i in range(3):
            y = F.silu(getattr(self, f"norm{i}")(getattr(self, f"down{i}")(y)))
        z = self.to_latent(y)
        return torch.tanh(z.float()).permute(0, 2, 3, 1)


class Decoder(nn.Module):
    """A conv from the latent, 3 transposed convs (4x4, stride 2, flax's
    SAME), GroupNorm(8) and SiLU, a conv to RGB, sigmoid in float32."""

    def __init__(self, base: int = 64):
        super().__init__()
        chs = [min(base * 2 ** i, 256) for i in range(3)][::-1]
        self.from_latent = nn.Conv2d(LATENT_CHANNELS, chs[0], 3, 1, 1)
        cin = chs[0]
        for i, ch in enumerate(chs):
            setattr(self, f"up{i}", nn.ConvTranspose2d(cin, ch, 4, 2, 1))
            setattr(self, f"norm{i}", _gn(ch))
            cin = ch
        self.to_rgb = nn.Conv2d(cin, 3, 3, 1, 1)

    def forward(self, z):
        """(N, h, w, 4) → (N, 8h, 8w, 3) float32 in [0, 1]."""
        y = z.permute(0, 3, 1, 2)
        y = self.from_latent(y.to(_compute_dtype(y, self.from_latent.weight)))
        for i in range(3):
            y = F.silu(getattr(self, f"norm{i}")(getattr(self, f"up{i}")(y)))
        return torch.sigmoid(self.to_rgb(y).float()).permute(0, 2, 3, 1)


class TinyAutoencoder(nn.Module):
    """The plain (no KL) autoencoder to a /8 latent."""

    def __init__(self, base: int = 64):
        super().__init__()
        self.enc = Encoder(base)
        self.dec = Decoder(base)

    def encode(self, x):
        return self.enc(x)

    def decode(self, z):
        return self.dec(z)

    def forward(self, x):
        return self.decode(self.encode(x))


def timestep_embedding(t: torch.Tensor, dim: int = EMB_DIM,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal embedding of integer timesteps (N,) → (N, dim), in
    float32 (float64 where the JAX package runs with 64-bit floats on)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, device=t.device, dtype=dtype) / half)
    ang = t.to(torch.float32).to(dtype)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class ResBlock(nn.Module):
    """GroupNorm, SiLU, 3x3 conv; FiLM from the timestep embedding;
    GroupNorm, SiLU, 3x3 conv; a 1x1 skip conv where the width changes."""

    def __init__(self, cin: int, ch: int, emb_dim: int = 256):
        super().__init__()
        self.ch = ch
        self.n1 = _gn(cin)
        self.c1 = nn.Conv2d(cin, ch, 3, 1, 1)
        self.emb = nn.Linear(emb_dim, ch * 2)
        self.n2 = _gn(ch)
        self.c2 = nn.Conv2d(ch, ch, 3, 1, 1)
        self.skip = nn.Conv2d(cin, ch, 1) if cin != ch else None

    def forward(self, x, emb):
        h = self.c1(F.silu(self.n1(x)))
        scale_shift = self.emb(F.silu(emb))[:, :, None, None]
        scale, shift = scale_shift[:, :self.ch], scale_shift[:, self.ch:]
        h = h * (1.0 + scale) + shift
        h = self.c2(F.silu(self.n2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class LatentDenoiser(nn.Module):
    """Small UNet over latents, conditioned on the masked image's latent
    and the downsampled hole mask (SD-inpaint's 9-channel input) and on
    the timestep (two float32 dense layers, FiLM in each ResBlock)."""

    def __init__(self, base: int = 64):
        super().__init__()
        self.emb1 = nn.Linear(EMB_DIM, 256)
        self.emb2 = nn.Linear(256, 256)
        self.stem = nn.Conv2d(2 * LATENT_CHANNELS + 1, base, 3, 1, 1)
        ch = base
        for i in range(2):  # two downsamples: latent /8 → /32 of pixels
            setattr(self, f"down{i}a", ResBlock(ch, ch))
            setattr(self, f"down{i}", nn.Conv2d(ch, ch * 2, 3, 2, 1))
            ch *= 2
        self.mid1 = ResBlock(ch, ch)
        self.mid2 = ResBlock(ch, ch)
        for i in range(2):
            setattr(self, f"up{i}", nn.ConvTranspose2d(ch, ch // 2, 4, 2, 1))
            setattr(self, f"up{i}a", ResBlock(ch, ch // 2))
            ch //= 2
        self.out_norm = _gn(ch)
        self.out = nn.Conv2d(ch, LATENT_CHANNELS, 3, 1, 1)

    def forward(self, z_t, z_masked, mask_lat, t):
        """Latents (N, h, w, 4), mask (N, h, w, 1), timesteps (N,) int →
        the predicted noise (N, h, w, 4) float32."""
        w = self.emb1.weight
        with torch.autocast(z_t.device.type, enabled=False):
            emb = timestep_embedding(t, EMB_DIM, torch.promote_types(
                torch.float32, w.dtype))
            emb = self.emb2(F.silu(self.emb1(emb.to(w.dtype))))
        x = torch.cat([z_t, z_masked, mask_lat], dim=-1).permute(0, 3, 1, 2)
        x = self.stem(x.to(_compute_dtype(x, self.stem.weight)))
        skips = []
        for i in range(2):
            x = getattr(self, f"down{i}a")(x, emb)
            skips.append(x)
            x = getattr(self, f"down{i}")(x)
        x = self.mid2(self.mid1(x, emb), emb)
        for i in range(2):
            x = getattr(self, f"up{i}")(x)
            x = torch.cat([x, skips.pop().to(x.dtype)], dim=1)
            x = getattr(self, f"up{i}a")(x, emb)
        eps = self.out(F.silu(self.out_norm(x)))
        return eps.float().permute(0, 2, 3, 1)


def load_ld_weights(ae: TinyAutoencoder, denoiser: LatentDenoiser,
                    flat: Dict[str, np.ndarray]) -> int:
    """The flat {"ae/...", "denoiser/..."} weights (the shipped .npz's
    keys) into the two modules in place; every key used once. Returns the
    number loaded."""
    n = 0
    for prefix, module in (("ae/", ae), ("denoiser/", denoiser)):
        n += load_flax_weights(module, {k[len(prefix):]: v for k, v in
                                        flat.items() if k.startswith(prefix)},
                               ld_torch_name)
    if n != len(flat):
        raise KeyError(f"{len(flat) - n} weights are neither ae/ nor "
                       f"denoiser/")
    return n


def ld_weights(ae: TinyAutoencoder, denoiser: LatentDenoiser
               ) -> Dict[str, np.ndarray]:
    """The two modules as flat flax float32 arrays, the shipped .npz's
    keys: the inverse of load_ld_weights."""
    return {**module_to_flax(ae, ld_flax_path, params="ae/"),
            **module_to_flax(denoiser, ld_flax_path, params="denoiser/")}


def downsample_mask(masks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """jax.image.resize(masks, (n, h, w, 1), "nearest") of (N, H, W, 1)
    masks: output row i takes input row floor((i + 0.5) · H / h), which is
    8i + 4 at /8 (F.interpolate's nearest takes 8i)."""
    H, W = masks.shape[1:3]
    iy = np.minimum(np.floor((np.arange(h) + 0.5) * H / h), H - 1)
    ix = np.minimum(np.floor((np.arange(w) + 0.5) * W / w), W - 1)
    iy = torch.as_tensor(iy.astype(np.int64), device=masks.device)
    ix = torch.as_tensor(ix.astype(np.int64), device=masks.device)
    return masks.index_select(1, iy).index_select(2, ix)


# ---------------------------------------------------------------------------
# the inpainter
# ---------------------------------------------------------------------------

def default_weights_path() -> Optional[str]:
    """DIFFUSION_WEIGHTS, the shipped latent_diffusion.npz, then the legacy
    <repo>/models/latent_diffusion (utils/shipping.resolve)."""
    return resolve("diffusion")


class LatentInpainter:
    """Trained autoencoder and denoiser weights on `device` ("cuda" unless
    the caller asks for the CPU); `inpaint` runs the DDIM hole fill.
    `dtype` is the convs' autocast dtype (None: float32 throughout)."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda",
                 dtype: Optional[torch.dtype] = torch.bfloat16):
        path = resolve("diffusion", explicit=weights_path)
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "no latent-diffusion weights; train with "
                "training/train_latent_diffusion.py")
        self.device = resolve_device(device)
        self.dtype = dtype
        with torch.device("meta"):  # shapes only: the weights replace them
            ae, denoiser = TinyAutoencoder(), LatentDenoiser()
        load_ld_weights(ae, denoiser, load_variables(path))
        self.ae = ae.eval().to(self.device)
        self.denoiser = denoiser.eval().to(self.device)
        if self.device.type == "cuda":
            self.ae = self.ae.to(memory_format=torch.channels_last)
            self.denoiser = self.denoiser.to(
                memory_format=torch.channels_last)

    @torch.no_grad()
    def sample(self, images: torch.Tensor, masks: torch.Tensor,
               z_init: torch.Tensor, step_noise: torch.Tensor
               ) -> torch.Tensor:
        """The DDIM fill of `images` (N, H, W, 3) float32 under `masks`
        (N, H, W, 1), 1 = hole, on this device, with the initial latent
        noise z_init (N, H/8, W/8, 4) and the known region's noise of each
        step, step_noise (steps, N, H/8, W/8, 4). Known pixels are the
        input's."""
        with compute_autocast(self.device, self.dtype):
            z0 = self.ae.encode(images)
        n, h, w, _ = z0.shape
        mask_lat = downsample_mask(masks, h, w)
        z_masked = z0 * (1.0 - mask_lat)
        ab = alpha_bars()
        ts = ddim_timesteps(step_noise.shape[0])
        steps = len(ts)
        one = np.float32(1)
        z_t = z_init
        for i in range(steps):
            t = int(ts[i])
            t_next = int(ts[i + 1]) if i + 1 < steps else 0
            a_t, a_n = ab[t + 1], ab[t_next + 1]
            # float32 coefficients, as the JAX sampler computes them
            sa_t, s1a_t = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
            sa_n, s1a_n = float(np.sqrt(a_n)), float(np.sqrt(one - a_n))
            # the known region follows the forward process of z0 exactly
            z_known = sa_t * z0 + s1a_t * step_noise[i]
            z_in = z_known * (1 - mask_lat) + z_t * mask_lat
            with compute_autocast(self.device, self.dtype):
                eps = self.denoiser(z_in, z_masked, mask_lat, torch.full(
                    (n,), t, dtype=torch.int32, device=z0.device))
            z0_hat = torch.clamp((z_in - s1a_t * eps) / sa_t, -1.5, 1.5)
            z_t = sa_n * z0_hat + s1a_n * eps
        z_fill = z0 * (1 - mask_lat) + z_t * mask_lat
        with compute_autocast(self.device, self.dtype):
            out = self.ae.decode(z_fill)
        m3 = masks.expand_as(images)
        return out * m3 + images * (1 - m3)

    def inpaint(self, images, masks, steps: int = 20,
                seed: int = 0) -> torch.Tensor:
        """images (N, H, W, 3) float [0, 1]; masks (N, H, W, 1) {0, 1},
        1 = hole; H and W multiples of 32. The noise comes from a
        torch.Generator on the device seeded with `seed`. Returns the
        filled images on the device."""
        dev = self.device
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
        n, hh, ww = images.shape[:3]
        if hh % 32 or ww % 32:
            raise ValueError(f"H and W must be multiples of 32; got "
                             f"{hh}x{ww}")
        shape = (n, hh // DOWN_FACTOR, ww // DOWN_FACTOR, LATENT_CHANNELS)
        gen = torch.Generator(dev).manual_seed(int(seed))
        z_init = torch.randn(shape, generator=gen, device=dev)
        noise = torch.randn((int(steps),) + shape, generator=gen, device=dev)
        return self.sample(images, masks, z_init, noise)


def init_ld_modules(seed: int = 0) -> Tuple[TinyAutoencoder,
                                             LatentDenoiser]:
    """Fresh float32 modules from flax's initializers (models/factory
    init_model): the autoencoder from `seed`, the denoiser from seed + 1."""
    from ..models.factory import init_model

    return (init_model(TinyAutoencoder(), seed),
            init_model(LatentDenoiser(), seed + 1))


def available() -> bool:
    """True if trained latent-diffusion weights resolve."""
    path = default_weights_path()
    return bool(path and os.path.exists(path))


_inpainters: Dict[str, Optional[LatentInpainter]] = {}


def get_inpainter(device="cuda") -> Optional[LatentInpainter]:
    """The cached LatentInpainter on `device`, or None when no weights
    are trained yet (or they fail to load, logged)."""
    key = str(resolve_device(device))
    if key in _inpainters:
        return _inpainters[key]
    inp = None
    if available():
        try:
            inp = LatentInpainter(device=device)
        except Exception as e:  # noqa: BLE001 - None is the fallback rung
            logger.warning("native latent diffusion unavailable: %s", e)
    _inpainters[key] = inp
    return inp


def diffusion_inpaint_bgr(image_bgr: np.ndarray, mask: np.ndarray,
                          steps: int = 20, device="cuda"
                          ) -> Optional[np.ndarray]:
    """BGR uint8 image + uint8 mask (> 127 = hole) → inpainted BGR uint8,
    through the latent-diffusion engine; None if it is not available."""
    inp = get_inpainter(device)
    if inp is None:
        return None
    dev = inp.device
    rgb = torch.from_numpy(np.ascontiguousarray(image_bgr[..., ::-1])).to(
        dev).float() / 255.0
    padded, (h, w) = pad_to_multiple(rgb, 32)
    hole = torch.from_numpy(np.ascontiguousarray(mask > 127)).to(dev).float()
    pmask, _ = pad_to_multiple(hole, 32)
    out = inp.inpaint(padded[None], pmask[None, ..., None], steps=steps)
    out = (torch.clamp(out[0, :h, :w], 0, 1) * 255).to(torch.uint8)
    return np.ascontiguousarray(out.cpu().numpy()[..., ::-1])
