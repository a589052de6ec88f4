"""PyTorch/CUDA port of unet_watermark_tpu for one NVIDIA H100.

Same module layout and public names as the JAX package, which stays the
reference: each module here is checked against its JAX counterpart by a
test under tests/test_torch_*.py. The two TPU (Pallas) kernels of the
mask stage are hand-written CUDA kernels (csrc/morph_chain.cu) built with
nvcc on first use and bound with ctypes (ops/kernels/).

Entry point: inference.predict.WatermarkPredictor(cfg).make_fused_repair_fn().
Everything runs on "cuda" unless the caller passes device="cpu".
"""
