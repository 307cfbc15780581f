"""Fused [affine + LeakyReLU] -> 3x3x3 SAME conv -> [per-plane statistics].

Replaces the Pallas kernel `sivae_tpu/kernels/conv3d_fused.py:
conv3d_fused_stats` (`_fused_kernel`), with `conv3d_v2` and the
differentiable `conv3d_stats` around it. As in the JAX package it is on no
model path (the routing lost its A/B there and was removed); its path is
the stage benchmark: one fused stage forward, and conv + statistics forward
and backward.

    y, psum, psumsq = conv3d_fused_stats(x, w, in_a, in_b, slope)

y = conv3d_same(g(x), w) in x.dtype, with g the identity, or
g(x) = leaky_relu(x * in_a + in_b, slope) computed in fp32 and rounded once
to x.dtype when the per-channel fp32 vectors in_a / in_b are given (the
previous BatchNorm folded to an affine). The zero padding comes after g.
psum / psumsq (B, D, Co) are fp32 sums over (H, W) of the ROUNDED y and of
its square: reduce over (B, D) and divide by B*D*H*W for the batch stats.

The kernel (`csrc/conv3d_fused.cu`) is the implicit GEMM of
`csrc/conv3d.cu` with the prologue applied to the input before it is
multiplied and the sums taken from the output tile before it leaves.
`conv3d_fused_stats_body` names the body a call runs:
- "wgmma", bf16 with Ci and Co multiples of 64: `conv3d_same`'s wgmma body
  (`csrc/conv3d_wgmma.cuh`) with both parts switched on, the prologue
  rewriting the line buffer in shared memory;
- "tf32x3", fp32 with Ci and Co multiples of 32: `conv3d_same`'s
  three-product TF32 body (`csrc/conv3d_tf32x3.cuh`), the prologue applied
  in registers to each fp32 A fragment before its split, the sums reduced
  from the fp32 accumulators; `conv3d_fused_stats_tf32x3_plain` is its
  algorithm in PyTorch;
- "mma" and "fma" (`csrc/conv3d_body.cuh`): the other shapes (bf16 with
  Ci % 32 == 0 and Co % 64 == 0 on mma.sync, the rest on CUDA cores).
Bound on an H100 SXM at the flagship site (64->64 at 80x96x80, batch 8):
the conv's 1.09 TFLOP at the tensor-core rate, ~1.10 ms in bf16 and
~6.6 ms in fp32 (165 TF/s, the three products fp32 accuracy takes);
prologue and sums add no device-memory bytes. The sums are added with
atomics, so their last bits change from run to run (~1e-6 relative).

`conv3d_fused_stats` takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor; nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sivae_torch.kernels import build
from sivae_torch.kernels.conv3d import (BODIES, conv3d_same_plain, conv3d_same_tf32x3_plain,
                                        flip_swap, weight_scratch, wgrad)

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def prologue_plain(x: torch.Tensor, in_a: torch.Tensor, in_b: torch.Tensor,
                   slope: float) -> torch.Tensor:
    """g(x) = leaky_relu(x * a + b) in fp32, rounded once to x.dtype."""
    v = x.float() * in_a.float() + in_b.float()
    return torch.where(v >= 0, v, slope * v).to(x.dtype)


def conv3d_fused_stats_plain(x: torch.Tensor, w: torch.Tensor,
                             in_a: Optional[torch.Tensor] = None,
                             in_b: Optional[torch.Tensor] = None, slope: float = 0.01) -> Stats:
    """Plain version: prologue in fp32 -> round -> `conv3d_same_plain` ->
    fp32 sums of the rounded y over (H, W)."""
    if in_a is not None:
        x = prologue_plain(x, in_a, in_b, slope)
    y = conv3d_same_plain(x, w)
    yf = y.float()
    return y, yf.sum(dim=(2, 3)), (yf * yf).sum(dim=(2, 3))


def conv3d_fused_stats_tf32x3_plain(x: torch.Tensor, w: torch.Tensor,
                                    in_a: Optional[torch.Tensor] = None,
                                    in_b: Optional[torch.Tensor] = None,
                                    slope: float = 0.01) -> Stats:
    """The fp32 "tf32x3" body's algorithm in PyTorch, for the tests: the
    prologue in fp32 (`prologue_plain`; the rounding to fp32 is the
    identity), then `conv3d_same_tf32x3_plain` on its output, zero-padded
    after the prologue, then the fp32 sums of y over (H, W). fp32 in and
    out."""
    if in_a is not None:
        x = prologue_plain(x, in_a, in_b, slope)
    y = conv3d_same_tf32x3_plain(x, w)
    return y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))


def conv3d_fused_stats(x: torch.Tensor, w: torch.Tensor, in_a: Optional[torch.Tensor] = None,
                       in_b: Optional[torch.Tensor] = None, slope: float = 0.01) -> Stats:
    """x (B, D, H, W, C), w (3, 3, 3, C, Co), in_a / in_b (C,) fp32 or None ->
    (y (B, D, H, W, Co), psum (B, D, Co) fp32, psumsq (B, D, Co) fp32).
    Not differentiable; `conv3d_stats` is."""
    _check(x, w, in_a, in_b)
    if x.device.type == "cpu":
        return conv3d_fused_stats_plain(x, w, in_a, in_b, slope)
    scratch = weight_scratch(x, w)
    out = _launch("sivae_conv3d_fused_stats", x, w, in_a, in_b, slope,
                  None if scratch is None else scratch.data_ptr())
    build.launches["conv3d_fused_stats"] += 1
    return out


def _check(x: torch.Tensor, w: torch.Tensor, in_a: Optional[torch.Tensor],
           in_b: Optional[torch.Tensor]) -> None:
    if x.dim() != 5 or w.dim() != 5 or w.shape[:3] != (3, 3, 3) or w.shape[3] != x.shape[-1]:
        raise ValueError(f"conv3d_fused_stats: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if (in_a is None) != (in_b is None):
        raise ValueError("conv3d_fused_stats: give both in_a and in_b, or neither")
    c = x.shape[-1]
    if in_a is not None and (tuple(in_a.shape) != (c,) or tuple(in_b.shape) != (c,)):
        raise ValueError(f"conv3d_fused_stats: in_a / in_b must be ({c},), got "
                         f"{tuple(in_a.shape)} / {tuple(in_b.shape)}")


def conv3d_fused_stats_earlier_body(x: torch.Tensor, w: torch.Tensor,
                                    in_a: Optional[torch.Tensor] = None,
                                    in_b: Optional[torch.Tensor] = None,
                                    slope: float = 0.01) -> Stats:
    """`conv3d_fused_stats` on CUDA tensors through the body that the
    dispatch's choice superseded: "mma" on the operands the "wgmma" body
    takes, "fma" on those the "tf32x3" body takes (whatever the dispatch
    would choose, never one of those two): for timing the two bodies side
    by side and for the card tests. No model path calls it and it counts no
    launch."""
    _check(x, w, in_a, in_b)
    return _launch("sivae_conv3d_fused_stats_mma", x, w, in_a, in_b, slope)


def conv3d_fused_stats_wgmma_blocks(x: torch.Tensor, w: torch.Tensor,
                                    in_a: Optional[torch.Tensor] = None,
                                    in_b: Optional[torch.Tensor] = None, slope: float = 0.01, *,
                                    shape: int) -> Stats:
    """`conv3d_fused_stats` on CUDA tensors the wgmma body takes, in a given
    block shape (one of `conv3d.WGMMA_SHAPES`). For measuring the shapes
    against each other (`tools/torch_conv_blocks.py --fused`) and for the card
    tests; no model path calls it and it counts no launch."""
    _check(x, w, in_a, in_b)
    return _launch("sivae_conv3d_fused_stats_wgmma", x, w, in_a, in_b, slope, shape)


def conv3d_fused_stats_wgmma_shape(x: torch.Tensor, co: int) -> int:
    """The block shape the fused kernel's wgmma body takes for a call on x with
    co output channels."""
    b, d, h, wd, _ = x.shape
    return build.library().sivae_conv3d_fused_stats_wgmma_shape(b, d, h, wd, co)


def conv3d_fused_stats_body(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel body a CUDA `conv3d_fused_stats` call on x and w runs:
    "wgmma", "tf32x3", "mma" or "fma" (the same choice with and without the
    prologue)."""
    used = build.library().sivae_conv3d_fused_stats_body(
        x.data_ptr(), w.data_ptr(), x.shape[-1], w.shape[-1], build.dtype_code(x))
    return BODIES[used]


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor, in_a: Optional[torch.Tensor],
            in_b: Optional[torch.Tensor], slope: float, *more) -> Stats:
    """`entry` on x and w: its arguments up to the dtype, then `more` (the
    scratch pointer, or the block shape), then the stream."""
    build.require_cuda(x, w)
    b, d, h, wd, c = x.shape
    co = w.shape[-1]
    build.require_voxels(b, d, h, wd)
    ab = None
    if in_a is not None:
        ab = torch.stack((in_a, in_b)).to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty((b, d, h, wd, co), dtype=x.dtype, device=x.device)
    sums = torch.zeros((2, b, d, co), dtype=torch.float32, device=x.device)  # the kernel adds
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), w.data_ptr(), None if ab is None else ab[0].data_ptr(),
            None if ab is None else ab[1].data_ptr(), float(slope), y.data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(), b, d, h, wd, c, co, build.dtype_code(x),
            *more, build.stream_of(x))
    build.check(rc, entry)
    return y, sums[0], sums[1]


def conv3d_v2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv alone through the fused kernel (statistics discarded)."""
    return conv3d_fused_stats(x, w)[0]


class _Conv3dStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        y, s1, s2 = conv3d_fused_stats(x, w)
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None, y)
        ctx.w_dtype = w.dtype
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, w, y = ctx.saved_tensors
        # s1 = sum_hw y, s2 = sum_hw y^2: every cotangent lands on y
        dy = (gy.float() + gs1[:, :, None, None, :]
              + 2.0 * y.float() * gs2[:, :, None, None, :]).to(y.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:  # this kernel again, statistics discarded
            dx = conv3d_fused_stats(dy.to(w.dtype), flip_swap(w))[0]
        if ctx.needs_input_grad[1]:
            dw = wgrad(x, dy, ctx.w_dtype)
        return dx, dw


def conv3d_stats(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """Differentiable conv + statistics (`conv3d_stats`,
    `sivae_tpu/kernels/conv3d_fused.py:314-368`): cotangents of all three
    outputs flow back, `dy = gy + gs1 + 2 y gs2` (broadcast over H, W) in
    fp32 cast to x.dtype; dx is this kernel on the flipped, IO-swapped
    weights; dw is the library's correlation. The prologue form has no
    gradient, as in the JAX package."""
    return _Conv3dStats.apply(x, w)
