"""3x3x3 SAME stride-1 convolutions with a 1-channel side.

- `conv3d_to1` (C -> 1, the decoder tail) replaces the Pallas kernel
  `sivae_tpu/kernels/conv3d_small.py:_small_out_impl` (`_small_out_kernel`).
- `conv3d_from1` (1 -> C, the encoder stem) replaces `_small_in_impl`
  (`_small_in_kernel`).

Each is the other's input gradient (`_to1_bwd`, `_from1_bwd`,
`sivae_tpu/kernels/conv3d_small.py:281-288`, `:309-314`): dx of `conv3d_to1`
is `conv3d_from1` of the cotangent on tap-flipped weights and the reverse,
so both directions run these two kernels. dw is the library's, as the JAX
package leaves it to XLA, written as ONE matrix product: the 1-channel
operand is unfolded into its 27 shifted copies (N voxels x 27, small) and
contracted over the voxels against the C-channel operand, which is read
once. (cuDNN's weight-gradient call for a 1-channel side took ~75 ms at the
flagship shape on an H100, batch 8, bf16.)

A 1-channel side makes the conv a 27-tap stencil with a channel reduction or
broadcast. Both are bound by the bytes of their C-wide side: at 64 channels,
80x96x80, batch 8, bf16 that side is ~629 MB, ~0.19 ms at 3.35 TB/s on an
H100 SXM (`chip_smoke.py` computes the same bound from each call's shapes).
In bf16 with C = 16, 32 or 64 both run on the tensor cores ("mma" bodies):
`conv3d_to1` contracts the channels once per input voxel and sums the 27
taps from shared memory (`conv3d_to1_contract_first_plain` is that algorithm
in PyTorch); `conv3d_from1` multiplies each output voxel's 27-tap window
(padded to 32) by the 32 x C weights held in registers, so its own output
stream is what is left (`conv3d_from1_gemm_plain`). Their fp32 and odd-C
bodies ("fma") do the ~1.7e10 multiply-adds on CUDA cores (~0.5 ms at 67
TF/s counting 2 per FMA); the 1 -> C one is held there by its shared-memory
weight reads, one per FMA. `csrc/conv3d_small.cu` says how each body is laid
out. All accumulate in fp32 and round once.

The wrappers take the plain version for a CPU tensor and launch the kernel
for a CUDA tensor; nothing falls back. `conv3d_to1` and `conv3d_from1` are
differentiable `torch.autograd.Function`s over the same dispatch.
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


def conv3d_to1_contract_first_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core body's algorithm in PyTorch, for the tests: contract
    the channels once per input voxel, Z[v, t] = sum_c x[v, c] w[t, c] in
    fp32, then sum the 27 shifted taps of Z and round once. Same function as
    `conv3d_to1_plain`, another order of the fp32 sums."""
    b, d, h, wd, c = x.shape
    z = torch.matmul(x.float(), w[..., 0].reshape(27, c).float().t())   # (B, D, H, W, 27)
    zp = F.pad(z, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, d, h, wd), dtype=torch.float32, device=x.device)
    for t, (kd, kh, kw) in enumerate(_taps()):
        acc += zp[:, kd:kd + d, kh:kh + h, kw:kw + wd, t]
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


def conv3d_from1_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core body's algorithm in PyTorch, for the tests: each output
    voxel's 27-tap window of the 1-channel input, padded to 32 columns, times
    the (32, C) weights (rows 27-31 zero) in fp32, rounded once. Same
    function as `conv3d_from1_plain`, another order of the fp32 sums."""
    c = w.shape[-1]
    cols = _unfold27(x[..., 0].float())                             # (N, 32)
    w32 = torch.zeros((32, c), dtype=torch.float32, device=x.device)
    w32[:27] = w[:, :, :, 0, :].reshape(27, c).float()
    return (cols @ w32).reshape(x.shape[:4] + (c,)).to(x.dtype)


def _unfold27(v: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """v (B, D, H, W) -> (B*D*H*W, 32): column t holds v at the input voxel
    of tap t (0 outside the volume), taps in `_taps()` order, or in reverse
    order with `flip`; columns 27-31 are zero (a 16-byte aligned row for the
    card's matrix product). fp32 on the CPU; the card's bf16 product
    accumulates in fp32 itself."""
    if not v.is_cuda:
        v = v.float()
    b, d, h, w = v.shape
    vp = F.pad(v, (1, 1, 1, 1, 1, 1))
    cols = v.new_zeros((b, d, h, w, 32))
    for t, (kd, kh, kw) in enumerate(_taps()):
        cols[..., 26 - t if flip else t] = vp[:, kd:kd + d, kh:kh + h, kw:kw + w]
    return cols.reshape(-1, 32)


def wgrad_to1(x: torch.Tensor, g: torch.Tensor, w_dtype: torch.dtype) -> torch.Tensor:
    """dw (3, 3, 3, C, 1) of `conv3d_to1`: dw[t, c] = sum_u x[u, c] g[u - off_t],
    one (C, N) x (N, 27) product over the unfolded cotangent (flipped taps)."""
    c = x.shape[-1]
    cols = _unfold27(g[..., 0], flip=True)
    dw = x.reshape(-1, c).to(cols.dtype).t() @ cols               # (C, 32)
    return dw[:, :27].t().reshape(3, 3, 3, c, 1).to(w_dtype)


def wgrad_from1(x: torch.Tensor, g: torch.Tensor, w_dtype: torch.dtype) -> torch.Tensor:
    """dw (3, 3, 3, 1, C) of `conv3d_from1`: dw[t, c] = sum_v x[v + off_t] g[v, c],
    one (27, N) x (N, C) product over the unfolded input."""
    c = g.shape[-1]
    cols = _unfold27(x[..., 0])
    dw = cols.t() @ g.reshape(-1, c).to(cols.dtype)               # (32, C)
    return dw[:27].reshape(3, 3, 3, 1, c).to(w_dtype)


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


class _Conv3dTo1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        ctx.w_dtype = w.dtype
        return conv3d_to1_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:  # (3,3,3,C,1) flipped, as the (3,3,3,1,C) of from1
            dx = conv3d_from1_forward(g.to(w.dtype), w.flip((0, 1, 2)).transpose(3, 4))
        if ctx.needs_input_grad[1]:
            dw = wgrad_to1(x, g.to(x.dtype), ctx.w_dtype)
        return dx, dw


class _Conv3dFrom1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        ctx.w_dtype = w.dtype
        return conv3d_from1_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_to1_forward(g.to(w.dtype), w.flip((0, 1, 2)).transpose(3, 4))
        if ctx.needs_input_grad[1]:
            dw = wgrad_from1(x, g.to(x.dtype), ctx.w_dtype)
        return dx, dw


def conv3d_to1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, C), w (3, 3, 3, C, 1) -> (B, D, H, W, 1), differentiable."""
    return _Conv3dTo1.apply(x, w)


def conv3d_from1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, 1), w (3, 3, 3, 1, C) -> (B, D, H, W, C), differentiable."""
    return _Conv3dFrom1.apply(x, w)


def conv3d_to1_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The C -> 1 stencil itself, outside autograd: plain version or kernel."""
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


def conv3d_from1_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 1 -> C stencil itself, outside autograd: plain version or kernel."""
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


def conv3d_from1_body(x: torch.Tensor, c: int) -> str:
    """Which kernel body a CUDA `conv3d_from1` call on x with c output
    channels runs (into the output it allocates, which is aligned): "mma"
    (tensor-core tap product) or "fma"."""
    used = build.library().sivae_conv3d_from1_body(None, c, build.dtype_code(x))
    return "mma" if used else "fma"


def conv3d_to1_body(x: torch.Tensor) -> str:
    """Which kernel body a CUDA `conv3d_to1` call on x runs: "mma" (tensor-core
    channel contraction) or "fma"."""
    used = build.library().sivae_conv3d_to1_body(x.data_ptr(), x.shape[-1], build.dtype_code(x))
    return "mma" if used else "fma"
