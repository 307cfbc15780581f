"""Core 3D conv building blocks (PyTorch, NCDHW API, channels_last_3d inside).

Port of `sivae_tpu/models/blocks.py` (`make_act`, `avg_pool3d`,
`upsample_nearest3d`, `Conv3d`, `BatchNorm`, `ConvBlock`, `UpBlock`,
`ConvBNAct`). Module and parameter names follow the reference torch
`state_dict` (reference models/models.py:8-80): `block.{0,1,4,5}` inside a
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

from sivae_torch.config import ActivationConfig
from sivae_torch.kernels.conv3d import conv3d_same
from sivae_torch.kernels.conv3d_small import conv3d_from1, conv3d_to1
from sivae_torch.ops.fused_upconv import upsampled_conv3x3

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


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit `torch.Generator`.

    Identity in eval mode or at rate 0. In training the caller sets
    `generator` (on the activations' device) before the forward; without one
    it raises rather than draw from the global generator.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training needs an explicit generator")
        u = torch.empty_like(x, dtype=torch.float32).uniform_(generator=self.generator)
        keep = 1.0 - self.rate
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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
        if self.out_ch == 1:
            return ncdhw(conv3d_to1(ndhwc(x), wk))
        if self.in_ch == 1:
            return ncdhw(conv3d_from1(ndhwc(x), wk))
        return ncdhw(conv3d_same(ndhwc(x), wk))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1, 1)
        return y


class UpsampleConv3d(Conv3d):
    """nearest-upsample(2) + 3x3x3 SAME conv, fused exactly into one stride-2
    transposed conv (`ops/fused_upconv.py`). Same parameters as `Conv3d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return upsampled_conv3x3(x.to(self.dtype), self.weight, b)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over (N, D, H, W) with running stats, in flax's
    op order: `(x - mean) * (rsqrt(var + eps) * weight) + bias`, cast to the
    compute dtype (`sivae_tpu/models/blocks.py:349-361`). Buffer names are
    torch's (`num_batches_tracked` included), so reference checkpoints load.
    Batch statistics come with the training step; until then a forward in
    training mode raises.
    """

    def __init__(self, ch: int, dtype=torch.float32, param_dtype=torch.float32,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(ch, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(ch, dtype=param_dtype))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("BatchNorm batch statistics come with the training step; "
                                      "call .eval() first")
        mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1, 1)
        y = x - mean.view(shape)
        mul = torch.rsqrt(var.view(shape) + self.eps) * self.weight.view(shape)
        y = y * mul
        y = y + self.bias.view(shape)
        return y.to(self.dtype)


class ConvBNAct(nn.Sequential):
    """conv -> BN -> act [-> dropout]: the stem / plain-stage unit
    (reference `blocks.0` = Sequential(conv, bn, act, dropout))."""

    def __init__(self, in_ch: int, out_ch: int, act: ActivationConfig, dropout: float = 0.0,
                 use_bias: bool = True, kernel_size: int = 3, dtype=torch.float32,
                 param_dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__(
            Conv3d(in_ch, out_ch, kernel_size, use_bias=use_bias, dtype=dtype,
                   param_dtype=param_dtype, generator=generator),
            BatchNorm(out_ch, dtype=dtype, param_dtype=param_dtype),
            make_act(act),
            Dropout(dropout),
        )


class ConvBlock(nn.Module):
    """Downsampling residual block (reference models/models.py:8-43).

    conv3 -> BN -> act -> AvgPool(stride) -> conv3 -> BN; when stride == 1
    the input is added back (1x1 projection if channel counts differ) before
    the output activation.
    """

    def __init__(self, in_ch: int, out_ch: int, stride: int, act: ActivationConfig,
                 use_bias: bool = False, dtype=torch.float32, param_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.stride = stride
        self.block = nn.Sequential(
            Conv3d(in_ch, out_ch, use_bias=use_bias, generator=generator, **kw),
            BatchNorm(out_ch, **kw),
            make_act(act),
            AvgPool(stride),
            Conv3d(out_ch, out_ch, use_bias=use_bias, generator=generator, **kw),
            BatchNorm(out_ch, **kw),
        )
        self.shortcut = (Conv3d(in_ch, out_ch, 1, use_bias=True, generator=generator, **kw)
                         if stride == 1 and in_ch != out_ch else None)
        self.act = make_act(act)

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
        self.block = nn.Sequential(
            Conv3d(in_ch, in_ch, use_bias=use_bias, generator=generator, **kw),
            BatchNorm(in_ch, **kw),
            make_act(act),
            nn.Identity(),
            conv2(in_ch, out_ch, use_bias=use_bias, generator=generator, **kw),
            BatchNorm(out_ch, **kw),
        )
        self.shortcut = (Conv3d(in_ch, out_ch, 1, use_bias=True, generator=generator, **kw)
                         if stride == 1 and in_ch != out_ch else None)
        self.act = make_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block(x)
        if self.stride == 1:
            h = h + (x if self.shortcut is None else self.shortcut(x))
        return self.act(h)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=CL)

