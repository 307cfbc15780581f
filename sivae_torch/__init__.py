"""PyTorch + CUDA port of sivae_tpu for NVIDIA Hopper (H100).

The JAX package `sivae_tpu` is the reference; this package imports none of it.
"""
