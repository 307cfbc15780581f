"""Fused nearest-upsample(2) + 3x3x3 SAME conv, exact, as one transposed conv.

Port of `sivae_tpu/ops/fused_upconv.py:59-76`. With u[2i+a] = x[i], the
3-tap window at an output of parity a touches two low-res voxels per axis,
so upsample-then-conv equals a stride-2 transposed conv with a derived
4x4x4 kernel, per axis K = [w0, w0+w1, w1+w2, w2] (the selection matrix M4).
JAX runs it as an lhs-dilated conv with padding 2; the transposed conv
needs the kernel flipped over its three spatial axes, its I/O axes swapped
to (Ci, Co, 4, 4, 4), and padding 1. This op was XLA in JAX, outside any
Pallas kernel, so the port leaves it to the library (`conv_transpose3d`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sivae_torch.utils.dtypes import widen

# (4, 3) selection: derived tap m sums original taps t; per axis
# K = [w0, w0+w1, w1+w2, w2]
_M4 = torch.tensor([[1, 0, 0],
                    [1, 1, 0],
                    [0, 1, 1],
                    [0, 0, 1]], dtype=torch.float32)


def upconv_kernel(w: torch.Tensor) -> torch.Tensor:
    """OIDHW (Co, Ci, 3, 3, 3) conv weight -> the (Ci, Co, 4, 4, 4)
    `conv_transpose3d` weight of the fused op, in fp32 (float64 for float64
    weights)."""
    w = widen(w)
    m4 = _M4.to(w.device, w.dtype)
    k = torch.einsum("ad,bh,cw,oidhw->abcio", m4, m4, m4, w)  # (4,4,4,Ci,Co)
    return k.flip((0, 1, 2)).permute(3, 4, 0, 1, 2)


def upsampled_conv3x3(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, Ci, D, H, W) low-res, w (Co, Ci, 3, 3, 3) ->
    conv3x3x3_SAME(nearest_upsample2(x), w) of shape (N, Co, 2D, 2H, 2W)."""
    k = upconv_kernel(w).to(x.dtype)
    if x.is_cuda:
        k = k.contiguous(memory_format=torch.channels_last_3d)
    b = None if bias is None else bias.to(x.dtype)
    return F.conv_transpose3d(x, k, b, stride=2, padding=1)
