"""3x3x3 SAME stride-1 3D convolution, NDHWC x DHWIO -> NDHWC.

Replaces the Pallas kernel `sivae_tpu/kernels/conv3d.py:_conv3d_impl`
(`_conv_tap_kernel`), forward only; its dgrad use comes with training.

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
kernel for a CUDA tensor; nothing falls back.
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


def conv3d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, Ci), w (3, 3, 3, Ci, Co) -> (B, D, H, W, Co)."""
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
