"""Training of the segmentation model (training/ in the JAX package)."""
