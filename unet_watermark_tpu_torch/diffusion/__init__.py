"""Diffusion repair backends (diffusion/ in the JAX package): the native
latent-diffusion inpainter. The SD3 and FLUX shells are not ported yet
(ROADMAP.md §A.8)."""
