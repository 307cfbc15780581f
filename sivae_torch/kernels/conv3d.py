"""3x3x3 SAME stride-1 3D convolution, NDHWC x DHWIO -> NDHWC.

Replaces the Pallas kernel `sivae_tpu/kernels/conv3d.py:_conv3d_impl`
(`_conv_tap_kernel`) in both its uses: the forward, and the input gradient,
which is the same kernel on the flipped, IO-swapped weights (`_bwd`,
`sivae_tpu/kernels/conv3d.py:134-149`).

The kernel (`csrc/conv3d.cu`) is an implicit GEMM over M = B*D*H*W voxels,
N = Co, K = 27*Ci. Six bodies, chosen in C by shape, type and alignment
(`conv3d_same_body` names the one a call runs):
- "wgmma", bf16 with Ci % 64 == 0 and Co % 64 == 0 (the spatial_1200
  sites). At the flagship site (64->64 at 80x96x80, batch 8) 1.09 TFLOP is
  ~1.10 ms at 989 TF/s and ~1.26 GB in+out ~0.38 ms at 3.35 TB/s: the tensor
  cores bound it. Warp-specialised: a producer thread feeds a ring of
  shared-memory stages by TMA, two consumer warpgroups multiply with
  `wgmma.mma_async`, synchronised by mbarriers; the weight tile is read from
  shared memory once per warpgroup.
- "mma", the other bf16 shapes with Ci % 32 == 0 and Co % 64 == 0:
  `mma.sync` on `ldmatrix` fragments over a `cp.async` ring.
- "narrow", the other bf16 shapes with Ci and Co multiples of 4 up to 64:
  the FC family's and spatial_150's 12/16/24/32/48 channels
  (`csrc/conv3d_narrow.cuh`). There the bytes bound it (12->12 at 80x96x80,
  batch 8: 236 MB, 0.070 ms at 3.35 TB/s, against ~0.07 ms of padded
  tensor work). A block marches a 16-wide in-plane patch along d, copies
  each haloed input plane into shared memory once (`cp.async`, 8-byte pieces
  where a row is not a multiple of 16 bytes), keeps its weights resident in
  the `mma.sync` fragment order, pads K to 16 and N to 8 with zeros in
  shared memory, and reuses each input row's A fragment for every kh that
  needs it. On an H100 80GB HBM3 at 700 W (`chip_smoke.py` phase 3):
  0.37 ms at 12->12 and 0.35 ms at 16->16 (80x96x80, batch 8), against
  cuDNN's 1.9 / 1.2 ms and the CUDA-core body's 8.9 / 8.9 ms;
  `conv3d_same_narrow_plain` is its algorithm in PyTorch.
- "tf32x3", fp32 with Ci % 32 == 0 and Co % 32 == 0 (every fp32 site of
  spatial_1200 and spatial_1200_fullsize; `csrc/conv3d_tf32x3.cuh`): the
  "wgmma" body's structure on `wgmma` TF32, the weights split and
  transposed into a scratch tensor per call. One TF32 product keeps
  11 significand bits and misses the fp32 tolerance (~3e-4 of the largest
  output at K = 1728, `tests/test_torch_kernels.py` pins it); each operand
  is split into big = tf32(v) and small = tf32(v - big) and three products,
  small*big + big*small + big*big, hold fp32 accuracy (~2e-7 there) at a
  third of the 495 TF/s TF32 rate, against the 67 TF/s of the CUDA cores
  that held the "fma" body. `conv3d_same_tf32x3_plain` is its algorithm in
  PyTorch.
- "narrow_tf32x3", the other fp32 shapes with Ci and Co multiples of 4 up
  to 64 (the fp32 convs of the FC family and spatial_150: 12/16/24/32/48
  channels, the eval CLI's default; `csrc/conv3d_narrow_tf32x3.cuh`):
  tf32x3's split products and warp roles, K = Ci rounded up to 8, and where
  Co <= 32 the 3 kw taps in N (one wgmma m64n48k8 for three m64n16k8: at
  N <= 64 a wgmma costs about the same whatever N), the kw shifts summed
  after the loop. At 12->12, 80x96x80, batch 8, the bound is 0.23 ms
  (3.8e10 fp32 flops at 165 TF/s; 472 MB is 0.14 ms);
  `conv3d_same_narrow_tf32x3_plain` is its algorithm in PyTorch.
- "fma", the channel counts the others do not take, on the CUDA cores.
All apply SAME padding without a padded copy, sum all 27 taps in fp32 and
round once. The Pallas v1 rounds after each depth tap, so bf16 comparisons
against it allow for that.

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
from sivae_torch.utils.dtypes import wide_dtype, widen


def _taps():
    return [(kd, kh, kw) for kd in range(3) for kh in range(3) for kw in range(3)]


def conv3d_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: pad, then 27 shifted slices, each contracted against
    its (Ci, Co) weight slice into an fp32 accumulator (float64 for a
    float64 input), rounded once."""
    b, d, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, d, h, wd, w.shape[-1]), dtype=wide_dtype(x), device=x.device)
    for kd, kh, kw in _taps():
        sl = widen(xp[:, kd:kd + d, kh:kh + h, kw:kw + wd, :])
        acc += torch.matmul(sl, w[kd, kh, kw].to(acc.dtype))
    return acc.to(x.dtype)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 stored mantissa bits), ties away
    from zero, as `cvt.rna.tf32.f32`: integer ops on the bits, the 13 dropped
    bits rounded on the magnitude. Zero, denormals and signs round the same
    way; inf and NaN pass unchanged; a value that rounds past the largest
    finite one becomes inf."""
    bits = v.float().contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    rounded = ((mag + 0x1000) & ~0x1FFF) | (bits & ~0x7FFFFFFF)
    return torch.where(mag >= 0x7F800000, bits, rounded).view(torch.float32)


def tf32_split(v: torch.Tensor):
    """(big, small, cross), the kernels' `split_tf32`: v = big + small, both
    TF32, big = tf32(v), small = tf32(v - big) (the difference is exact in
    fp32); where big is not finite small is 0 and cross (big elsewhere) is
    0, so that the cross products small * cross' + cross * small' of an
    infinite value are 0 and not inf - inf or inf * 0."""
    big = tf32_round(v)
    finite = torch.isfinite(big)
    small = torch.where(finite, tf32_round(v.float() - big), 0.0)
    return big, small, torch.where(finite, big, 0.0)


def conv3d_same_tf32x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The "tf32x3" body's algorithm in PyTorch, for the tests: x and w split
    into TF32 parts (`tf32_split`), and for each tap small*cross' +
    cross*small' + big*big' (each product of two TF32 values is exact in
    fp32) summed in fp32; small*small' is dropped. fp32 in and out. Same
    function as `conv3d_same_plain` to ~fp32 accuracy, where one TF32
    product (`tf32_round` of both operands) is off by ~3e-4 of the largest
    output at K = 1728."""
    b, d, h, wd, _ = x.shape
    xb, xs, xc = (F.pad(p, (0, 0, 1, 1, 1, 1, 1, 1)) for p in tf32_split(x))
    wb, ws, wc = tf32_split(w)
    acc = torch.zeros((b, d, h, wd, w.shape[-1]), dtype=torch.float32, device=x.device)
    for kd, kh, kw in _taps():
        sl = (slice(None), slice(kd, kd + d), slice(kh, kh + h), slice(kw, kw + wd))
        acc += torch.matmul(xs[sl], wc[kd, kh, kw])
        acc += torch.matmul(xc[sl], ws[kd, kh, kw])
        acc += torch.matmul(xb[sl], wb[kd, kh, kw])
    return acc


def conv3d_same_narrow_tf32x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The "narrow_tf32x3" body's algorithm in PyTorch, for the tests: x and
    w split into TF32 parts (`tf32_split`), the input channels zero-padded to
    Kp (Ci rounded up to 8), and per k8 step small*cross' + cross*small' +
    big*big' (exact products of TF32 values) summed in fp32; small*small' is
    dropped. Where Co <= 32 (the kernel's kw taps in N) each kw's sum Z_kw
    runs over (kd, kh), 32-channel chunk and k8 step, and the output is Z_1
    + Z_0 + Z_2; where Co > 32 one sum runs over (kd, kh), chunk, kw and k8
    step in that order. fp32 in and out. Same function as
    `conv3d_same_plain` to ~fp32 accuracy."""
    b, d, h, wd, ci = x.shape
    co = w.shape[-1]
    kp = -(-ci // 8) * 8
    xs = [F.pad(p, (0, kp - ci, 1, 1, 1, 1, 1, 1)) for p in tf32_split(x)]
    ws = [F.pad(p, (0, 0, 0, kp - ci)) for p in tf32_split(w)]
    pairs = ((xs[1], ws[2]), (xs[2], ws[1]), (xs[0], ws[0]))  # s*c', c*s', b*b'

    def taps_sum(kws):
        acc = torch.zeros((b, d, h, wd, co), dtype=torch.float32, device=x.device)
        for kd in range(3):
            for kh in range(3):
                for c0 in range(0, kp, 32):
                    for kw in kws:
                        for k0 in range(c0, min(c0 + 32, kp), 8):
                            sl = (slice(None), slice(kd, kd + d), slice(kh, kh + h),
                                  slice(kw, kw + wd), slice(k0, k0 + 8))
                            for xa, wa in pairs:
                                acc += torch.matmul(xa[sl], wa[kd, kh, kw, k0:k0 + 8])
        return acc

    if co <= 32:
        z = [taps_sum((kw,)) for kw in range(3)]
        return z[1] + z[0] + z[2]
    return taps_sum((0, 1, 2))


def conv3d_same_narrow_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The "narrow" body's algorithm in PyTorch, for the tests: the input
    channels zero-padded to Kp (Ci rounded up to 16), the output channels cut
    into the kernel's blocks (at most 32 a block, Co > 32 in two halves of a
    multiple of 4) and each block's zero-padded to a multiple of 8; each tap's
    16-channel products summed in fp32 in the kernel's order (kd, kw, channel
    step, kh), rounded once. Same function as `conv3d_same_plain`, another
    order of the fp32 sums."""
    def round_up(a, m):
        return -(-a // m) * m

    b, d, h, wd, ci = x.shape
    co = w.shape[-1]
    kp = round_up(ci, 16)
    n_chunks = -(-co // 32)                 # output channels in chunks of at most 32
    cw = round_up(-(-co // n_chunks), 4)    # output channels a chunk (a block)
    xp = F.pad(widen(x), (0, kp - ci, 1, 1, 1, 1, 1, 1))
    blocks = []
    for n0 in range(0, co, cw):
        n_real = min(cw, co - n0)
        wp = xp.new_zeros((3, 3, 3, kp, round_up(cw, 8)))
        wp[..., :ci, :n_real] = w[..., n0:n0 + n_real].to(wp.dtype)
        acc = xp.new_zeros((b, d, h, wd, wp.shape[-1]))
        for kd in range(3):
            for kw in range(3):
                for k0 in range(0, kp, 16):
                    for kh in range(3):
                        sl = xp[:, kd:kd + d, kh:kh + h, kw:kw + wd, k0:k0 + 16]
                        acc += torch.matmul(sl, wp[kd, kh, kw, k0:k0 + 16])
        blocks.append(acc[..., :n_real])
    return torch.cat(blocks, dim=-1).to(x.dtype)


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
        xc, gc = widen(xc), widen(gc)
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
    if x.device.type == "cpu":
        _check_shapes(x, w)
        return conv3d_same_plain(x, w)
    # fp32: room for the weights' three TF32 parts, laid out as the B operand
    # of the tf32x3 forms, which the launch fills before its conv
    n = build.library().sivae_conv3d_same_scratch(x.shape[-1], w.shape[-1], build.dtype_code(x))
    scratch = torch.empty(n, dtype=torch.float32, device=x.device) if n else None
    y = _launch("sivae_conv3d_same", x, w, None if scratch is None else scratch.data_ptr())
    build.launches["conv3d_same"] += 1
    build.count_site(build.conv3d_same_sites, x, x.shape[-1], w.shape[-1])
    return y


def conv3d_same_earlier_body(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv on a CUDA tensor through the body that the dispatch's choice
    superseded: "mma" on the operands the "wgmma" body takes, "fma" on those
    the "narrow", "tf32x3" and "narrow_tf32x3" bodies take (whatever the
    dispatch would choose, never one of those four): for timing the two
    bodies side by side and for the card tests. No model path calls it and
    it counts no launch."""
    return _launch("sivae_conv3d_same_mma", x, w)


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5 or w.shape[:3] != (3, 3, 3) or w.dim() != 5 or w.shape[3] != x.shape[-1]:
        raise ValueError(f"conv3d_same: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")


def conv3d_same_wgmma_blocks(x: torch.Tensor, w: torch.Tensor, shape: int) -> torch.Tensor:
    """The conv on CUDA tensors the wgmma body takes, in a given block shape:
    10 * (rows / 128) + (columns / 64), one of `WGMMA_SHAPES`. For measuring the
    shapes against each other (`tools/torch_conv_blocks.py`) and for the card
    tests; no model path calls it and it counts no launch."""
    return _launch("sivae_conv3d_same_wgmma", x, w, shape)


def conv3d_same_wgmma_shape(x: torch.Tensor, co: int) -> int:
    """The block shape the wgmma body takes for a call on x with co output channels."""
    b, d, h, wd, _ = x.shape
    return build.library().sivae_conv3d_same_wgmma_shape(b, d, h, wd, co)


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor, *more: int) -> torch.Tensor:
    _check_shapes(x, w)
    build.require_cuda(x, w)
    b, d, h, wd, ci = x.shape
    co = w.shape[-1]
    build.require_voxels(b, d, h, wd)
    y = torch.empty((b, d, h, wd, co), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, d, h, wd, ci, co,
                                 build.dtype_code(x), *more, build.stream_of(x))
    build.check(rc, entry)
    return y


BODIES = ("fma", "mma", "wgmma", "narrow", "tf32x3", "narrow_tf32x3")
WGMMA_SHAPES = (11, 21, 12, 22)   # 128x64, 256x64, 128x128, 256x128 outputs a block


def conv3d_same_body(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> str:
    """Which kernel body a CUDA call on these tensors runs: "wgmma", "mma",
    "narrow", "tf32x3", "narrow_tf32x3" or "fma"."""
    used = build.library().sivae_conv3d_same_body(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[-1], w.shape[-1], build.dtype_code(x))
    return BODIES[used]
