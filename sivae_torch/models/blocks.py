"""Core 3D conv building blocks (PyTorch, NCDHW API, channels_last_3d inside).

Port of `sivae_tpu/models/blocks.py` (`make_act`, `avg_pool3d`,
`upsample_nearest3d`, `Conv3d`, `BatchNorm` in both modes, `ConvBlock`,
`UpBlock`, `ConvBNAct`), and flax's `Dense` as `Linear`. The convs,
BatchNorm and Dropout take part in activation rematerialisation through
`models/remat.py`'s tape (a no-op outside a rematerialised region). Under
depth sharding (`parallel/mesh.py`) every tensor is this rank's depth slab:
the 3x3x3 convs pad it with their neighbours' halo planes
(`parallel/halo.py`) and BatchNorm takes the whole grid's statistics. Module and
parameter names follow the reference torch `state_dict` (reference
models/models.py:8-80): `block.{0,1,4,5}` inside a
residual block, `shortcut` for its 1x1 projection, `{0,1}` inside a
conv-BN-act unit. A reference checkpoint therefore loads with
`load_state_dict`.

Tensors are NCDHW at every module's interface and live in
`torch.channels_last_3d` memory, so `x.permute(0, 2, 3, 4, 1)` is the
contiguous NDHWC view the conv kernels take.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sivae_torch.config import ActivationConfig
from sivae_torch.kernels.batchnorm import BN_VIEW as _BN_VIEW
from sivae_torch.kernels.batchnorm import act as _act
from sivae_torch.kernels.batchnorm import batchnorm_train, batchnorm_train_backward
from sivae_torch.kernels.conv3d import conv3d_same
from sivae_torch.kernels.conv3d_small import conv3d_from1, conv3d_to1
from sivae_torch.models import remat
from sivae_torch.ops.fused_upconv import upsampled_conv3x3
from sivae_torch.parallel import halo
from sivae_torch.parallel.distributed import grid, spatial_ranks, world_size
from sivae_torch.parallel.mesh import all_reduce_, slab_features, whole_features

CL = torch.channels_last_3d


def ndhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NDHWC view of an NCDHW tensor (a copy unless channels-last)."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def ncdhw(y: torch.Tensor) -> torch.Tensor:
    """NCDHW view of a contiguous NDHWC tensor (channels_last_3d memory)."""
    return y.permute(0, 4, 1, 2, 3)


def make_act(cfg: ActivationConfig, which: str = "body") -> nn.Module:
    name = cfg.body_act if which == "body" else cfg.decoder_tail_act
    if name == "leaky_relu":
        return nn.LeakyReLU(cfg.negative_slope)
    if name == "relu":
        return nn.ReLU()
    raise ValueError(f"unknown activation {name!r}")


def act_slope(cfg: ActivationConfig, which: str = "body") -> float:
    """The activation as a LeakyReLU slope (ReLU is slope 0), for the
    `BatchNorm` that applies it itself."""
    act = make_act(cfg, which)
    return act.negative_slope if isinstance(act, nn.LeakyReLU) else 0.0


def avg_pool3d(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Non-overlapping 3D average pool (torch AvgPool3d(kernel_size=s)),
    taken on the NDHWC view so the result stays channels-last."""
    if stride == 1:
        return x
    n, c, d, h, w = x.shape
    s = stride
    v = x[:, :, :d // s * s, :h // s * s, :w // s * s].permute(0, 2, 3, 4, 1)
    v = v.reshape(n, d // s, s, h // s, s, w // s, s, c).mean(dim=(2, 4, 6))
    return ncdhw(v)


def upsample_nearest3d(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour 3D upsample (torch nn.Upsample(scale_factor=s))."""
    if scale == 1:
        return x
    y = ndhwc(x)
    for axis in (1, 2, 3):
        y = y.repeat_interleave(scale, dim=axis)
    return ncdhw(y)


class AvgPool(nn.Module):
    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        return avg_pool3d(x, self.stride)


class Upsample(nn.Module):
    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return upsample_nearest3d(x, self.scale)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default kernel init (`lecun_normal`): a normal truncated at 2
    standard deviations, scaled so that its variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Linear(nn.Module):
    """Dense layer, torch's (out, in) weight layout, flax's init: lecun-normal
    weights from `generator` and a zero bias (torch's `nn.Linear` draws
    both uniformly). Parameters in `param_dtype`; the product runs in the
    compute `dtype`."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32,
                 param_dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(lecun_normal_(
            torch.empty((out_features, in_features), dtype=param_dtype), in_features, generator))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit `torch.Generator`.

    Identity in eval mode or at rate 0. In training the caller sets
    `generator` (on the activations' device) before the forward; without one
    it raises rather than draw from the global generator. In a
    rematerialised region's rerun the mask comes from the state the first
    forward drew it at (`remat._Tape.generator`).
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        gen = self.generator
        tape = remat.active_tape()
        if tape is not None:
            gen = tape.generator(gen)
        if gen is None:
            raise RuntimeError("Dropout in training needs an explicit generator")
        u = torch.empty_like(x, dtype=torch.float32).uniform_(generator=gen)
        keep = 1.0 - self.rate
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


_KERNELS = {"conv3d_same": conv3d_same, "conv3d_to1": conv3d_to1, "conv3d_from1": conv3d_from1}


def kernel_kind(ci: int, co: int) -> str:
    """The kernel a 3x3x3 `Conv3d` of ci -> co channels routes to."""
    return "conv3d_to1" if co == 1 else "conv3d_from1" if ci == 1 else "conv3d_same"


def halo_padded(x: torch.Tensor) -> torch.Tensor:
    """NDHWC slab `x` with one halo plane of each depth neighbour on either
    side (zeros at the grid's edges), the planes taped inside a
    rematerialised region so that its rerun exchanges nothing."""
    tape = remat.active_tape()
    if tape is None:
        received = halo.exchange_planes(x)
    else:
        received = tape.received(lambda: halo.exchange_planes(x))
    return halo.pad_depth(x, received)


class Conv3d(nn.Module):
    """k x k x k SAME stride-1 conv (k in {1, 3}) with He-normal init.

    3x3x3 convs go to the port's kernels, in the routing order of the JAX
    package (`sivae_tpu/models/blocks.py:268-290`): Co == 1 -> `conv3d_to1`,
    Ci == 1 -> `conv3d_from1`, otherwise `conv3d_same`. Each wrapper takes
    its kernel for a CUDA tensor and its plain version for a CPU tensor.
    1x1 convs are a matrix product over the channel axis, as XLA's conv is
    in JAX. Bias is added here, after the kernel (`blocks.py:158-161`).
    Weights are stored OIDHW (torch layout) in `param_dtype`; the forward
    casts input and weights to the compute `dtype`.

    Under depth sharding a 3x3x3 conv runs the same kernel on its slab
    padded with one halo plane each side (`halo_padded`) and crops the first
    and last output planes: the kernel's own SAME padding in depth only
    reaches those two. 1x1 convs stay local.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, use_bias: bool = False,
                 zero_init: bool = False, dtype=torch.float32, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kernel_size not in (1, 3):
            raise ValueError(f"kernel_size must be 1 or 3, got {kernel_size}")
        self.in_ch, self.out_ch, self.kernel_size = in_ch, out_ch, kernel_size
        self.dtype = dtype
        k = kernel_size
        w = torch.zeros((out_ch, in_ch, k, k, k), dtype=param_dtype)
        if not zero_init:
            # He-normal, gain 2 over fan_in (reference kaiming_normal_, JAX
            # variance_scaling(2.0, "fan_in", "normal"))
            std = math.sqrt(2.0 / (in_ch * k ** 3))
            w.normal_(0.0, std, generator=generator)
        self.weight = nn.Parameter(w)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_ch, dtype=param_dtype))
        else:
            self.register_parameter("bias", None)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.kernel_size == 1:
            return ncdhw(torch.matmul(ndhwc(x), w.reshape(self.out_ch, self.in_ch).t()))
        wk = w.permute(2, 3, 4, 1, 0).contiguous()  # OIDHW -> DHWIO
        fn = _KERNELS[kernel_kind(self.in_ch, self.out_ch)]
        if spatial_ranks() == 1:
            return ncdhw(remat.kernel_conv(fn, ndhwc(x), wk))
        d, h, w_ = x.shape[2:]
        y = remat.kernel_conv(fn, halo_padded(ndhwc(x)), wk, d * h * w_)
        return ncdhw(y[:, 1:-1].contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1, 1)
        return y


class UpsampleConv3d(Conv3d):
    """nearest-upsample(2) + 3x3x3 SAME conv, fused exactly into one stride-2
    transposed conv (`ops/fused_upconv.py`). Same parameters as `Conv3d`.

    Under depth sharding the low-resolution slab gets one halo plane each
    side; of the 2 (d + 2) output planes the first and last two are cropped
    (those the padded tensor's own edges reach), which leaves the slab's
    2d."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype)
        voxels = 8 * x.shape[2] * x.shape[3] * x.shape[4]
        if spatial_ranks() == 1:
            return remat.library_conv(lambda: upsampled_conv3x3(x, self.weight, b), voxels)
        xp = ncdhw(halo_padded(ndhwc(x)))
        y = remat.library_conv(lambda: upsampled_conv3x3(xp, self.weight, b), voxels)
        return y[:, :, 2:-2].contiguous(memory_format=CL)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm (+ optional LeakyReLU / ReLU) that keeps only its
    input and the per-channel fp32 statistics (float64 for a float64 input)
    for the backward pass (`kernels/batchnorm.py`: the kernels for a CUDA
    tensor, the plain version for a CPU tensor).

    Written as separate eager ops under autograd, it would keep `x.float()`,
    `x - mean` and the scaled product alive for every BN site of every
    forward of the two-phase step: several GB per full-resolution site. Here
    the backward recomputes them from `x` in fp32, the gradient through the
    batch mean and variance included.

    Returns (y, mean, var); mean and var (biased) are not differentiable and
    feed the running statistics. `stats`, when given, is a list: an empty
    one receives [mean, E[x^2] - mean^2 (before the clamp), the count], and
    a filled one stands for the batch's, so that a rematerialised region's rerun
    normalises with its first forward's statistics and reduces nothing
    (`models/remat.py`).

    Under data parallelism and depth sharding (a process group of more than
    one rank, each with its rows of the global batch and its depth slab) the
    statistics are the whole grid's, as GSPMD makes them in the JAX package
    (`sivae_tpu/parallel/mesh.py:4-10`): the forward all-reduces
    `[sum x, sum x^2]` once and divides by the global count, and the
    backward all-reduces `[sum g, sum g * xhat]` once for `dx`. The count
    joins the forward's sums (depth slabs may differ in size), all in
    float64 (a count past 2**24 stays exact). With `rows_only` (the
    features of a depth-sharded Linear, `FeatureBatchNorm`) each spatial rank
    holds other features, and the statistics are taken over the data ranks
    of this rank's slab alone. The weight
    and bias gradients it returns stay this rank's own sums: the step's
    gradient all-reduce adds them up with every other gradient. In one
    process no collective runs and the arithmetic is the one above.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, slope, out_dtype, stats=None, rows_only=False):
        world, group = (grid().data, grid().data_group) if rows_only else (world_size(), None)
        ctx.reduce_grads = None
        reduce_sums = None
        if world > 1:
            ctx.reduce_grads = lambda t: all_reduce_(t, "bn_grad", group)

            def reduce_sums(sum_x, sum_xx, count):
                local = sum_x.new_full((1,), count, dtype=torch.float64)
                sums = all_reduce_(torch.cat([sum_x.double(), sum_xx.double(), local]), "bn",
                                   group)
                mean, ex2 = (sums[:-1] / sums[-1]).to(sum_x.dtype).chunk(2)
                return mean, ex2 - mean * mean, sums[-1:].to(sum_x.dtype)
        y, mean, var, rstd, k, ctx.n, x_saved = batchnorm_train(
            x, weight, bias, eps, slope, out_dtype, stats, reduce_sums)
        ctx.save_for_backward(x_saved, weight, bias, mean, rstd, k)
        ctx.slope = slope
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, weight, bias, mean, rstd, k = ctx.saved_tensors
        dx, dweight, dbias = batchnorm_train_backward(
            g, x, weight, bias, mean, rstd, k, ctx.n, ctx.slope, ctx.needs_input_grad[0],
            ctx.reduce_grads)
        return dx, dweight, dbias, None, None, None, None, None


class BatchNorm(nn.Module):
    """BatchNorm over (N, D, H, W) in flax's op order,
    `(x - mean) * (rsqrt(var + eps) * weight) + bias`, cast to the compute
    dtype, then the activation when `act_slope` is given (LeakyReLU slope;
    0 is ReLU; None is no activation). Port of `_BNCore`
    (`sivae_tpu/models/blocks.py:313-361`).

    Eval mode takes the running statistics. Training mode takes the batch's:
    mean and mean of squares in fp32 (float64 for a float64 input),
    `var = max(0, E[x^2] - mean^2)`, and moves the running statistics by
    `0.9 * old + 0.1 * new` with the BIASED variance, as flax does (torch's
    `BatchNorm3d` stores the unbiased one). Under data parallelism the batch
    is the global one (`_BatchNormTrain`), so the running statistics move
    alike on every rank. torch's `SyncBatchNorm` is not used: it stores the
    unbiased variance and has neither the fused activation nor flax's order.
    Buffer names are torch's (`num_batches_tracked` included), so reference
    checkpoints load. A rematerialised region's rerun takes the statistics
    its first forward took and moves no running statistic.
    """

    momentum = 0.9  # share of the old running statistic that is kept

    def __init__(self, ch: int, dtype=torch.float32, param_dtype=torch.float32,
                 eps: float = 1e-5, act_slope: Optional[float] = None):
        super().__init__()
        self.dtype, self.eps, self.act_slope = dtype, eps, act_slope
        self.weight = nn.Parameter(torch.ones(ch, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(ch, dtype=param_dtype))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            tape = remat.active_tape()
            stats = None if tape is None else tape.bn_stats()
            y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps,
                                                 self.act_slope, self.dtype, stats)
            if tape is not None and tape.replaying:
                return y
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
                self.num_batches_tracked += 1
            return y
        return self._normalise(x, self.running_mean, self.running_var, self.weight, self.bias)

    def _normalise(self, x, mean, var, weight, bias) -> torch.Tensor:
        """Eval mode: by the running statistics `mean` and `var`."""
        y = x - mean.view(_BN_VIEW)
        mul = torch.rsqrt(var.view(_BN_VIEW) + self.eps) * weight.view(_BN_VIEW)
        y = y * mul
        y = y + bias.view(_BN_VIEW)
        return _act(y.to(self.dtype), self.act_slope)


class FeatureBatchNorm(BatchNorm):
    """`BatchNorm` over the features of a Linear's output whose features are
    a (C, D, H, W) volume `whole` flattened in that order (the lucky
    decoder's `fc_bn`), applied to a (B, F) tensor through a (B, F, 1, 1, 1)
    view: statistics over the batch alone, as flax's BatchNorm over a
    Dense's output. Under depth sharding the input holds this rank's slab of
    the features (`linear_to_slab`): the parameters and running statistics
    stay whole and each rank uses its slab of them (`slab_features`), the
    batch statistics are reduced over the data ranks of its slab alone (the
    other spatial ranks hold other features), and the running statistics
    move by the whole features' statistics, joined over the spatial ranks
    (`whole_features`), so they stay the same on every rank."""

    def __init__(self, whole, dtype=torch.float32, param_dtype=torch.float32,
                 eps: float = 1e-5, act_slope: Optional[float] = None):
        self.whole = tuple(whole)
        super().__init__(math.prod(self.whole), dtype=dtype, param_dtype=param_dtype, eps=eps,
                         act_slope=act_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.reshape(x.shape[0], -1, 1, 1, 1)
        if spatial_ranks() == 1:
            return super().forward(v).reshape(x.shape)
        weight, bias = (slab_features(p, self.whole) for p in (self.weight, self.bias))
        if not self.training:
            mean, var = (slab_features(t, self.whole)
                         for t in (self.running_mean, self.running_var))
            return self._normalise(v, mean, var, weight, bias).reshape(x.shape)
        y, mean, var = _BatchNormTrain.apply(v, weight, bias, self.eps, self.act_slope,
                                             self.dtype, None, True)
        with torch.no_grad():
            mean, var = whole_features(torch.stack([mean, var]), self.whole)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
            self.num_batches_tracked += 1
        return y.reshape(x.shape)


class ConvBNAct(nn.Sequential):
    """conv -> BN -> act [-> dropout]: the stem / plain-stage unit
    (reference `blocks.0` = Sequential(conv, bn, act, dropout)). The BN
    applies the activation itself; index 2 stays as an identity so the
    module indices match the reference."""

    def __init__(self, in_ch: int, out_ch: int, act: ActivationConfig, dropout: float = 0.0,
                 use_bias: bool = True, kernel_size: int = 3, dtype=torch.float32,
                 param_dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__(
            Conv3d(in_ch, out_ch, kernel_size, use_bias=use_bias, dtype=dtype,
                   param_dtype=param_dtype, generator=generator),
            BatchNorm(out_ch, dtype=dtype, param_dtype=param_dtype, act_slope=act_slope(act)),
            nn.Identity(),
            Dropout(dropout),
        )


class ConvBlock(nn.Module):
    """Downsampling residual block (reference models/models.py:8-43).

    conv3 -> BN -> act -> AvgPool(stride) -> conv3 -> BN; when stride == 1
    the input is added back (1x1 projection if channel counts differ) before
    the output activation. Each BN applies the activation that follows it
    directly (`block.2`, and the output activation when there is no
    residual); `block.2` stays as an identity.
    """

    def __init__(self, in_ch: int, out_ch: int, stride: int, act: ActivationConfig,
                 use_bias: bool = False, dtype=torch.float32, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.stride = stride
        slope = act_slope(act)
        self.block = nn.Sequential(
            Conv3d(in_ch, out_ch, use_bias=use_bias, generator=generator, **kw),
            BatchNorm(out_ch, act_slope=slope, **kw),
            nn.Identity(),
            AvgPool(stride),
            Conv3d(out_ch, out_ch, use_bias=use_bias, generator=generator, **kw),
            BatchNorm(out_ch, act_slope=None if stride == 1 else slope, **kw),
        )
        self.shortcut = (Conv3d(in_ch, out_ch, 1, use_bias=True, generator=generator, **kw)
                         if stride == 1 and in_ch != out_ch else None)
        self.act = make_act(act) if stride == 1 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block(x)
        if self.stride == 1:
            h = h + (x if self.shortcut is None else self.shortcut(x))
        return self.act(h)


class UpBlock(nn.Module):
    """Upsampling residual block (reference models/models.py:46-80).

    conv3 (keeps in_ch) -> BN -> act -> nearest-upsample(stride) ->
    conv3 (to out_ch) -> BN; residual iff stride == 1. At stride 2 the
    upsample and the second conv run as one fused op (`UpsampleConv3d`);
    `block.3` stays an identity so the parameter names match the reference.
    The BNs apply their activations as in `ConvBlock`.
    """

    def __init__(self, in_ch: int, out_ch: int, stride: int, act: ActivationConfig,
                 use_bias: bool = False, dtype=torch.float32, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"UpBlock stride must be 1 or 2, got {stride}")
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.stride = stride
        conv2 = UpsampleConv3d if stride == 2 else Conv3d
        slope = act_slope(act)
        self.block = nn.Sequential(
            Conv3d(in_ch, in_ch, use_bias=use_bias, generator=generator, **kw),
            BatchNorm(in_ch, act_slope=slope, **kw),
            nn.Identity(),
            nn.Identity(),
            conv2(in_ch, out_ch, use_bias=use_bias, generator=generator, **kw),
            BatchNorm(out_ch, act_slope=None if stride == 1 else slope, **kw),
        )
        self.shortcut = (Conv3d(in_ch, out_ch, 1, use_bias=True, generator=generator, **kw)
                         if stride == 1 and in_ch != out_ch else None)
        self.act = make_act(act) if stride == 1 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block(x)
        if self.stride == 1:
            h = h + (x if self.shortcut is None else self.shortcut(x))
        return self.act(h)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=CL)

