"""Train-mode BatchNorm + activation: statistics, normalisation and gradient.

Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which fuses
it. Written as eager ATen ops (`batchnorm_train_plain`,
`batchnorm_train_backward_plain`), one BN site ran ~20 passes forward and
~25 backward, most of them over fp32 temporaries of the whole tensor: ~54
bytes of traffic an element forward and ~124 backward, where the work needs
6 and 10 in bf16. Those passes held ~60% of a spatial_1200 training step's
device time on an H100. Normalisation does a few operations a byte, far below
the card's ~295 (bf16 tensor rate over memory bandwidth), so bytes bound it.

The kernels (`csrc/batchnorm.cu`) read a channels-last tensor as a row-major
[M, C] matrix (M = N*D*H*W; the batch for `FeatureBatchNorm`'s features):
- forward: `bn_stats` (per-block partial sums of x and x^2, read x once),
  `bn_finalize` (the partial rows summed in a fixed order; mean, flax's fast
  variance E[x^2] - mean^2, its clamp at 0, rstd, rstd * weight and the tie
  factor k), `bn_apply` (y = act(round((x - mean) * mul + bias)), read x and
  write y once);
- backward: `bn_bwd_reduce` (per-block sums of gf and gf * xhat from x and g,
  where gf is g behind the activation, recomputed from the fp32
  pre-activation), `bn_bwd_finalize` (their fixed-order sum), `bn_bwd_apply`
  (dx = ((xhat * A + gf) - B) * mul, A = -k sum(gf xhat) / n, B = sum(gf) / n;
  read x and g, write dx once; skipped where x needs no gradient).
No atomics: the same inputs give the same bits. Each elementwise step keeps
the plain version's fp32 operations and their order, rounding each
separately; only the order of the fp32 sums differs.

One algorithm, two launch shapes chosen from [M, C] by `bn_grid`: "rows"
(M >> C, every conv site) and "cols" (small M, large C). Under several ranks
the kernels' sums feed the same float64 all-reduce as the plain version's
(the `reduce_sums` and `reduce_grads` callables of the caller,
`models/blocks.py` `_BatchNormTrain`), and a remat replay's given statistics
skip `bn_stats`.

`batchnorm_train` and `batchnorm_train_backward` take the plain version for a
CPU tensor and launch the kernels for a CUDA tensor (float32 or bfloat16;
anything else raises); nothing falls back.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from sivae_torch.kernels import build
from sivae_torch.utils.dtypes import widen

BN_AXES = (0, 2, 3, 4)
BN_VIEW = (1, -1, 1, 1, 1)

LAYOUTS = ("rows", "cols")       # layout codes of csrc/batchnorm.cu
ROW_MAX_THREADS = 512
ROW_MAX_PERIOD = 1024            # lcm(V, C): six period-long parameter arrays in 24 KB
COL_CHANNELS, COL_ROWS = 32, 8   # a "cols" block: 32 channels x 8 row lanes
THREADS_PER_SM = 2048           # resident threads an SM holds at most (Hopper)

# forward and backward modes of the C entries
FWD_SUMS, FWD_LOCAL, FWD_GIVEN = 0, 1, 2
BWD_SUMS, BWD_ALL, BWD_APPLY = 0, 1, 2

# (sum x, sum x^2, local count) -> (mean, raw variance, count) over every rank
ReduceSums = Callable[[torch.Tensor, torch.Tensor, int], tuple]
# [sum gf * xhat, sum gf] -> the same summed over every rank
ReduceGrads = Callable[[torch.Tensor], torch.Tensor]


def act(y: torch.Tensor, slope: Optional[float]) -> torch.Tensor:
    """The activation a BatchNorm applies: none, ReLU (slope 0) or LeakyReLU."""
    if slope is None:
        return y
    return F.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)


def act_code(slope: Optional[float]) -> int:
    """csrc/batchnorm.cu's activation code: 0 none, 1 ReLU, 2 LeakyReLU."""
    return 0 if slope is None else 1 if slope == 0.0 else 2


# ---- the plain version ----

def batchnorm_train_plain(x, weight, bias, eps, slope, out_dtype, stats=None,
                          reduce_sums: Optional[ReduceSums] = None):
    """Plain version of the forward: (y, mean, var, rstd, k, n, x) in eager
    ops, statistics in fp32 (float64 for a float64 x). `stats`, when given,
    is a list: an empty one receives [mean, raw variance, n], a filled one
    stands for the batch's. With `reduce_sums` the statistics are every
    rank's (its count a tensor); without, this tensor's (its count an int)."""
    if stats:
        mean, raw_var, n = stats
    else:
        xf = widen(x)
        if reduce_sums is None:
            n = x.numel() // x.shape[1]
            mean = xf.mean(dim=BN_AXES)
            raw_var = (xf * xf).mean(dim=BN_AXES) - mean * mean
        else:
            mean, raw_var, n = reduce_sums(xf.sum(dim=BN_AXES), (xf * xf).sum(dim=BN_AXES),
                                           x.numel() // x.shape[1])
        del xf
        if stats is not None:
            stats += [mean, raw_var, n]
    var = raw_var.clamp_min(0.0)  # flax's fast variance: max(0, E[x^2] - mean^2)
    rstd = torch.rsqrt(var + eps)
    # same op order as the eval branch (flax `_normalize`)
    y = x - mean.view(BN_VIEW)
    y = y.mul_((rstd * weight.to(rstd.dtype)).view(BN_VIEW))
    y = y.add_(bias.to(rstd.dtype).view(BN_VIEW))
    y = act(y.to(out_dtype), slope)
    # d max(0, v) / dv: 1 above 0, 0 below, 1/2 at the tie (as jnp.maximum)
    k = (raw_var > 0).to(rstd.dtype) + 0.5 * (raw_var == 0).to(rstd.dtype)
    return y, mean, var, rstd, k, n, x


def batchnorm_train_backward_plain(g, x, weight, bias, mean, rstd, k, n, slope, need_dx,
                                   reduce_grads: Optional[ReduceGrads] = None):
    """Plain version of the backward: (dx or None, dweight, dbias). It
    recomputes x - mean, the pre-activation's sign and xhat from x in fp32;
    dx takes every rank's sums through `reduce_grads` where given."""
    d = x - mean.view(BN_VIEW)                       # fp32, a new tensor
    mul = rstd * weight.to(rstd.dtype)
    gf = g.to(rstd.dtype)
    if slope is not None:                            # the forward's own pre-activation
        pos = (d * mul.view(BN_VIEW) + bias.to(rstd.dtype).view(BN_VIEW)) > 0
        gf = torch.where(pos, gf, gf * slope)
        del pos
    xhat = d.mul_(rstd.view(BN_VIEW))
    dbias = gf.sum(dim=BN_AXES)
    dweight = (gf * xhat).sum(dim=BN_AXES)
    dx = None
    if need_dx:
        sum_gx, sum_g = dweight, dbias
        if reduce_grads is not None:
            sum_gx, sum_g = reduce_grads(torch.cat([dweight, dbias])).chunk(2)
        dx = xhat.mul_((-k * sum_gx / n).view(BN_VIEW)).add_(gf)
        dx = dx.sub_((sum_g / n).view(BN_VIEW)).mul_(mul.view(BN_VIEW)).to(x.dtype)
    return dx, dweight.to(weight.dtype), dbias.to(bias.dtype)


# ---- the launch shape ----

class BnGrid(NamedTuple):
    layout: str    # "rows" or "cols"
    threads: int   # a "rows" block's threads (a "cols" block is 32 x 8)
    blocks: int    # "rows": the most blocks (the partial sums' rows); "cols": row groups


def bn_grid(m: int, c: int, elem_bytes: int, sms: int) -> BnGrid:
    """The kernels' launch shape for an [m, c] matrix of `elem_bytes`-byte
    elements on a card of `sms` multiprocessors (its operands 16-byte
    aligned: `_matrix`).

    "rows" where a block can hold whole channel phases: a thread's 16-byte
    vectors (V elements) keep their channels when the grid stride is a
    multiple of the period lcm(V, c) elements (at most 1024: the kernels
    keep their parameters over one period in shared memory), so a block is
    a multiple of lcm(32, period / V) threads (at most 512; about 256).
    `blocks` is the rows of partial sums to allocate: as many blocks as the
    card could hold at once (THREADS_PER_SM, the hardware's limit); the C
    side launches fewer where the kernel's occupancy is lower. Otherwise
    "cols": 32 channels a block, row groups to give the card ~8 blocks an
    SM."""
    v = 16 // elem_bytes
    period = math.lcm(v, c)
    unit = math.lcm(32, period // v)
    if period <= ROW_MAX_PERIOD and unit <= ROW_MAX_THREADS:
        threads = unit * max(1, 256 // unit)
        vecs = -(-m * c // v)
        return BnGrid("rows", threads,
                      max(1, min(-(-vecs // threads), sms * (THREADS_PER_SM // threads))))
    col_blocks = -(-c // COL_CHANNELS)
    return BnGrid("cols", COL_CHANNELS * COL_ROWS,
                  max(1, min(-(-m // COL_ROWS), -(-8 * sms // col_blocks))))


_SMS = {}


def _sms(dev: torch.device) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


# ---- the kernels ----

def _matrix(t: torch.Tensor) -> torch.Tensor:
    """The [M, C] view of an NCDHW tensor in channels-last memory, 16-byte
    aligned (the kernels' vector loads); a tensor in another layout or off
    that alignment is copied once (counted in `bn_layout_copies`)."""
    v = t.permute(0, 2, 3, 4, 1)
    if not v.is_contiguous() or v.data_ptr() % 16:
        v = v.clone(memory_format=torch.contiguous_format)
        build.bn_layout_copies += 1
    return v.reshape(-1, t.shape[1])


def _ncdhw(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    n, c, d, h, w = like.shape
    return m.view(n, d, h, w, c).permute(0, 4, 1, 2, 3)


def _check(x: torch.Tensor, out_dtype: torch.dtype, *params: torch.Tensor) -> None:
    build.dtype_code(x)
    if out_dtype != x.dtype:
        raise ValueError(f"batchnorm kernels write x's dtype {x.dtype}, asked for {out_dtype}")
    if x.dim() != 5:
        raise ValueError(f"batchnorm kernels take an NCDHW tensor, got {tuple(x.shape)}")
    for p in params:
        if p.device != x.device:
            raise ValueError(f"batchnorm operands differ: {p.device} vs {x.device}")


def _grid(x2: torch.Tensor) -> BnGrid:
    m, c = x2.shape
    return bn_grid(m, c, x2.element_size(), _sms(x2.device))


def _f32(p: torch.Tensor) -> torch.Tensor:
    return p.to(torch.float32).contiguous()


def _bn_forward_kernels(x, weight, bias, eps, slope, out_dtype, stats, reduce_sums):
    _check(x, out_dtype, weight, bias)
    x2 = _matrix(x)
    m, c = x2.shape
    y2 = torch.empty_like(x2)
    grid = _grid(x2)
    w32, b32 = _f32(weight), _f32(bias)
    st = torch.empty((6, c), dtype=torch.float32, device=x.device)
    partials = torch.empty((grid.blocks, 2, c), dtype=torch.float32, device=x.device)
    lib = build.library()

    def launch(mode, n=0.0, mean_in=None, raw_in=None):
        with torch.cuda.device(x.device):
            rc = lib.sivae_bn_forward(
                x2.data_ptr(), y2.data_ptr(), m, c, build.dtype_code(x2),
                LAYOUTS.index(grid.layout), grid.threads, grid.blocks, partials.data_ptr(), mode,
                float(n), w32.data_ptr(), b32.data_ptr(), float(eps), act_code(slope),
                float(slope or 0.0), None if mean_in is None else mean_in.data_ptr(),
                None if raw_in is None else raw_in.data_ptr(), st.data_ptr(),
                build.stream_of(x2))
        build.check(rc, "bn_forward")
        if mode != FWD_GIVEN:
            build.launches["bn_stats"] += 1
        build.launches["bn_finalize"] += 1
        if mode != FWD_SUMS:
            build.launches["bn_apply"] += 1

    if stats:
        mean, raw_var, n = stats
        launch(FWD_GIVEN, mean_in=_f32(mean), raw_in=_f32(raw_var))
    elif reduce_sums is None:
        n = m
        launch(FWD_LOCAL, n=n)
    else:
        launch(FWD_SUMS)
        mean, raw_var, n = reduce_sums(st[0], st[1], m)
        launch(FWD_GIVEN, mean_in=mean.contiguous(), raw_in=raw_var.contiguous())
    if stats is not None and not stats:
        stats += [st[0], st[1], n]
    key = f"{c}@{m} {str(x.dtype).replace('torch.', '')}"
    build.bn_sites[key] = build.bn_sites.get(key, 0) + 1
    return _ncdhw(y2, x), st[0], st[2], st[3], st[5], n, _ncdhw(x2, x)


def _bn_backward_kernels(g, x, weight, bias, mean, rstd, k, n, slope, need_dx, reduce_grads):
    _check(x, x.dtype, weight, bias)
    if g.dtype != x.dtype:
        raise ValueError(f"batchnorm backward: g is {g.dtype}, x {x.dtype}")
    x2, g2 = _matrix(x), _matrix(g)
    m, c = x2.shape
    grid = _grid(x2)
    w32, b32 = _f32(weight), _f32(bias)
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    partials = torch.empty((grid.blocks, 2, c), dtype=torch.float32, device=x.device)
    dx2 = torch.empty_like(x2) if need_dx else None
    n_dev = n.to(torch.float32).contiguous() if torch.is_tensor(n) else None
    lib = build.library()

    def launch(mode, s):
        with torch.cuda.device(x.device):
            rc = lib.sivae_bn_backward(
                x2.data_ptr(), g2.data_ptr(), None if dx2 is None else dx2.data_ptr(), m, c,
                build.dtype_code(x2), LAYOUTS.index(grid.layout), grid.threads, grid.blocks,
                partials.data_ptr(), mode, mean.data_ptr(), rstd.data_ptr(), k.data_ptr(),
                w32.data_ptr(), b32.data_ptr(), act_code(slope), float(slope or 0.0),
                0.0 if n_dev is not None else float(n),
                None if n_dev is None else n_dev.data_ptr(), s.data_ptr(), build.stream_of(x2))
        build.check(rc, "bn_backward")
        if mode != BWD_APPLY:
            build.launches["bn_bwd_reduce"] += 1
            build.launches["bn_bwd_finalize"] += 1
        if mode != BWD_SUMS:
            build.launches["bn_bwd_apply"] += 1

    if need_dx and reduce_grads is None:
        launch(BWD_ALL, sums)
    else:
        launch(BWD_SUMS, sums)
        if need_dx:
            launch(BWD_APPLY, reduce_grads(torch.cat([sums[0], sums[1]])).contiguous())
    dx = None if dx2 is None else _ncdhw(dx2, x)
    return dx, sums[0].to(weight.dtype), sums[1].to(bias.dtype)


# ---- dispatch ----

def batchnorm_train(x, weight, bias, eps, slope, out_dtype, stats=None,
                    reduce_sums: Optional[ReduceSums] = None):
    """Train-mode BatchNorm of x (NCDHW) over (N, D, H, W) with its
    activation: (y, mean, var, rstd, k, n, x_saved), where var is the clamped
    biased variance, rstd and k (the tie factor of the clamp) go to the
    backward with x_saved (x, or its channels-last copy). Plain version for a
    CPU tensor, kernels for a CUDA tensor."""
    if x.device.type == "cpu":
        return batchnorm_train_plain(x, weight, bias, eps, slope, out_dtype, stats, reduce_sums)
    return _bn_forward_kernels(x, weight, bias, eps, slope, out_dtype, stats, reduce_sums)


def batchnorm_train_backward(g, x, weight, bias, mean, rstd, k, n, slope, need_dx,
                             reduce_grads: Optional[ReduceGrads] = None):
    """(dx or None, dweight, dbias) of `batchnorm_train`; dweight and dbias
    are this tensor's own sums. Plain version for a CPU tensor, kernels for
    a CUDA tensor."""
    if x.device.type == "cpu":
        return batchnorm_train_backward_plain(g, x, weight, bias, mean, rstd, k, n, slope,
                                              need_dx, reduce_grads)
    return _bn_backward_kernels(g, x, weight, bias, mean, rstd, k, n, slope, need_dx,
                                reduce_grads)
