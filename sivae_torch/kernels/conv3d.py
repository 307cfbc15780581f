"""3x3x3 SAME stride-1 3D convolution, NDHWC x DHWIO -> NDHWC.

Replaces the Pallas kernel `sivae_tpu/kernels/conv3d.py:_conv3d_impl`
(`_conv_tap_kernel`) in both its uses: the forward, and the input gradient,
which is the same kernel on the flipped, IO-swapped weights (`_bwd`,
`sivae_tpu/kernels/conv3d.py:134-149`).

The kernel (`csrc/conv3d.cu`) is an implicit GEMM over M = B*D*H*W voxels,
N = Co, K = 27*Ci. Bound on an H100 SXM at the flagship site (64->64 at
80x96x80, batch 8, bf16): 1.09 TFLOP is ~1.10 ms at 989 TF/s, ~1.26 GB
in+out is ~0.38 ms at 3.35 TB/s, so the tensor cores bound it. bf16 with
Ci % 32 == 0 and Co % 64 == 0 runs a tensor-core body (mma.sync on
ldmatrix fragments; one line buffer of input rows per (kd, kh) serves its 3
kw taps, which cuts the input's L2 traffic 3x); fp32 and odd channel counts
run an fp32 FMA body. Both apply SAME padding by bounds checks (no padded
copy), sum all 27 taps in fp32 and round once. The Pallas v1 rounds after
each depth tap, so bf16 comparisons against it allow for that.

`conv3d_same` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; nothing falls back. It is differentiable: a
`torch.autograd.Function` whose dx goes through the same dispatch (so the
CPU tests run the very backward the card runs, with the plain version
inside) and whose dw is the library's weight-gradient correlation, as the
JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sivae_torch.kernels import build


def _taps():
    return [(kd, kh, kw) for kd in range(3) for kh in range(3) for kw in range(3)]


def conv3d_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: pad, then 27 shifted slices, each contracted against
    its (Ci, Co) weight slice into an fp32 accumulator, rounded once."""
    b, d, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, d, h, wd, w.shape[-1]), dtype=torch.float32, device=x.device)
    for kd, kh, kw in _taps():
        sl = xp[:, kd:kd + d, kh:kh + h, kw:kw + wd, :].float()
        acc += torch.matmul(sl, w[kd, kh, kw].float())
    return acc.to(x.dtype)


def flip_swap(w: torch.Tensor) -> torch.Tensor:
    """DHWIO weights of the input-gradient conv: taps flipped, I and O swapped."""
    return w.flip((0, 1, 2)).transpose(3, 4).contiguous()


def wgrad(x: torch.Tensor, g: torch.Tensor, w_dtype: torch.dtype) -> torch.Tensor:
    """dw (3, 3, 3, Ci, Co) of a 3x3x3 SAME conv, NDHWC x and g: the
    correlation of x with g over (B, D, H, W), by the library
    (`torch.nn.grad.conv3d_weight`, cuDNN on the card), accumulated in fp32
    and cast to `w_dtype`. The card's bf16 call accumulates in fp32 inside
    cuDNN; on the CPU the operands are widened first."""
    xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)  # NCDHW views
    if not x.is_cuda:
        xc, gc = xc.float(), gc.float()
    shape = (g.shape[-1], x.shape[-1], 3, 3, 3)                  # OIDHW
    dw = torch.nn.grad.conv3d_weight(xc, shape, gc.to(xc.dtype), padding=1)
    return dw.permute(2, 3, 4, 1, 0).to(w_dtype)


class _Conv3dSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        # dx needs only w, dw only x: a frozen half keeps no activations here
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        ctx.w_dtype = w.dtype
        return conv3d_same_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_same_forward(g.to(w.dtype), flip_swap(w))
        if ctx.needs_input_grad[1]:
            dw = wgrad(x, g.to(x.dtype), ctx.w_dtype)
        return dx, dw


def conv3d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, Ci), w (3, 3, 3, Ci, Co) -> (B, D, H, W, Co), differentiable."""
    return _Conv3dSame.apply(x, w)


def conv3d_same_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv itself, outside autograd: plain version or kernel launch."""
    if x.dim() != 5 or w.shape[:3] != (3, 3, 3) or w.dim() != 5 or w.shape[3] != x.shape[-1]:
        raise ValueError(f"conv3d_same: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3d_same_plain(x, w)
    build.require_cuda(x, w)
    b, d, h, wd, ci = x.shape
    co = w.shape[-1]
    build.require_voxels(b, d, h, wd)
    y = torch.empty((b, d, h, wd, co), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = lib.sivae_conv3d_same(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, d, h, wd, ci, co,
                                   build.dtype_code(x), build.stream_of(x))
    build.check(rc, "conv3d_same")
    build.launches["conv3d_same"] += 1
    return y


def conv3d_same_body(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> str:
    """Which kernel body a CUDA call on these tensors runs ("mma" or "fma")."""
    used = build.library().sivae_conv3d_same_body(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[-1], w.shape[-1], build.dtype_code(x))
    return "mma" if used else "fma"
