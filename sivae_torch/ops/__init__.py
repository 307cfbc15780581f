"""Tensor ops outside the kernels: fused upsample-conv, metrics."""
