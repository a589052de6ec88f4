"""Diffusion repair backends (diffusion/ in the JAX package): the native
latent-diffusion inpainter, and the SD3 and FLUX Kontext shells, gated on
diffusers (without it, their first rung returns None and every call takes
the native engine, or push-pull without its weights)."""
from .flux_process import FluxProcessor
from .sd3_inpaint import SDWatermarkRemover, diffusers_available

__all__ = ["SDWatermarkRemover", "FluxProcessor", "diffusers_available"]
