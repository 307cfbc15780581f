"""3x3x3 SAME stride-1 convolutions with a 1-channel side.

- `conv3d_to1` (C -> 1, the decoder tail) replaces the Pallas kernel
  `sivae_tpu/kernels/conv3d_small.py:_small_out_impl` (`_small_out_kernel`).
- `conv3d_from1` (1 -> C, the encoder stem) replaces `_small_in_impl`
  (`_small_in_kernel`).

Forward only; each is the other's input gradient, which comes with training.
A 1-channel side makes the conv a 27-tap stencil, not a matrix product. At
64 channels, 80x96x80, batch 8, bf16 both move ~629 MB on their C-wide side
(~0.19 ms at 3.35 TB/s on an H100 SXM) and do ~1.7e10 FMAs on CUDA cores
(~0.25 ms at 67 TF/s), so each is bound by whichever of the two is larger
at its shapes; `csrc/conv3d_small.cu` says how each kernel meets it. Both
accumulate in fp32 and round once.

The wrappers take the plain version for a CPU tensor and launch the kernel
for a CUDA tensor; nothing falls back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sivae_torch.kernels import build
from sivae_torch.kernels.conv3d import _taps

# the kernels keep the 27 x C weights in 48 KB of static shared memory
MAX_CHANNELS = 48 * 1024 // (27 * 4)


def conv3d_to1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, D, H, W, C), w (3, 3, 3, C, 1) -> (B, D, H, W, 1)."""
    b, d, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, d, h, wd), dtype=torch.float32, device=x.device)
    for kd, kh, kw in _taps():
        sl = xp[:, kd:kd + d, kh:kh + h, kw:kw + wd, :].float()
        acc += torch.matmul(sl, w[kd, kh, kw, :, 0].float())
    return acc.to(x.dtype)[..., None]


def conv3d_from1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, D, H, W, 1), w (3, 3, 3, 1, C) -> (B, D, H, W, C)."""
    b, d, h, wd, _ = x.shape
    xp = F.pad(x[..., 0], (1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, d, h, wd, w.shape[-1]), dtype=torch.float32, device=x.device)
    for kd, kh, kw in _taps():
        sl = xp[:, kd:kd + d, kh:kh + h, kw:kw + wd].float()
        acc += sl[..., None] * w[kd, kh, kw, 0].float()
    return acc.to(x.dtype)


def _launch(name: str, x: torch.Tensor, w27: torch.Tensor, y: torch.Tensor, c: int) -> None:
    b, d, h, wd = y.shape[:4]
    build.require_voxels(b, d, h, wd)
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = getattr(lib, "sivae_" + name)(x.data_ptr(), w27.data_ptr(), y.data_ptr(),
                                           b, d, h, wd, c, build.dtype_code(x),
                                           build.stream_of(x))
    build.check(rc, name)
    build.launches[name] += 1


def conv3d_to1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, C), w (3, 3, 3, C, 1) -> (B, D, H, W, 1)."""
    if x.dim() != 5 or tuple(w.shape) != (3, 3, 3, x.shape[-1], 1):
        raise ValueError(f"conv3d_to1: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3d_to1_plain(x, w)
    c = x.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"conv3d_to1 takes at most {MAX_CHANNELS} channels, got {c}")
    w27 = w[..., 0].contiguous()
    build.require_cuda(x, w27)
    y = torch.empty(x.shape[:4] + (1,), dtype=x.dtype, device=x.device)
    _launch("conv3d_to1", x, w27, y, c)
    return y


def conv3d_from1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, 1), w (3, 3, 3, 1, C) -> (B, D, H, W, C)."""
    if x.dim() != 5 or x.shape[-1] != 1 or w.shape[:4] != (3, 3, 3, 1) or w.dim() != 5:
        raise ValueError(f"conv3d_from1: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3d_from1_plain(x, w)
    c = w.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"conv3d_from1 takes at most {MAX_CHANNELS} channels, got {c}")
    w27 = w[:, :, :, 0, :].contiguous()
    build.require_cuda(x, w27)
    y = torch.empty(x.shape[:4] + (c,), dtype=x.dtype, device=x.device)
    _launch("conv3d_from1", x, w27, y, c)
    return y
