""""Lucky" autoencoder: the hand-written conv + pool FC-512 AE variant.

Port of `sivae_tpu/models/lucky_ae.py:36-85` (reference models/model.py
Encoder_lucky / Decoder_lucky :148-223). The encoder is 4 convs with
MaxPool x3 down to (D/8, H/8, W/8, 64), then Linear -> 512 and ReLU (the
reference declares a conv5 its forward never uses). The decoder is Linear
+ BatchNorm over its features + ReLU, three nearest upsamples with 3x3x3
convs, and a sigmoid. Its stride-1 SAME ConvTranspose3d(k=3, padding=1) is
a stride-1 SAME conv with a flipped kernel, so it is a `Conv3d` here, and
every 3x3x3 conv goes through the port's conv routing (1 -> C, C -> 1 and
the general kernel). Weights are drawn with flax's initialisers, as the
JAX package's: lecun-normal kernels and zero biases.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sivae_torch.models.blocks import (BatchNorm, Conv3d, Linear, lecun_normal_,
                                       to_channels_last, upsample_nearest3d)


def _conv(ci: int, co: int, dtype, generator) -> Conv3d:
    conv = Conv3d(ci, co, use_bias=True, dtype=dtype, generator=generator)
    lecun_normal_(conv.weight, ci * 27, generator)
    return conv


class LuckyEncoder(nn.Module):
    def __init__(self, input_shape: Tuple[int, int, int] = (80, 96, 80), dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList([_conv(ci, co, dtype, generator)
                                    for ci, co in ((1, 3), (3, 3), (3, 32), (32, 64))])
        self.bns = nn.ModuleList([BatchNorm(c, dtype=dtype, act_slope=0.0) for c in (3, 3, 32, 64)])
        d, h, w = (s // 8 for s in input_shape)
        self.fc = Linear(64 * d * h * w, 512, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 1, D, H, W) -> (B, 512)."""
        h = to_channels_last(x)
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            h = bn(conv(h))                      # conv -> BN -> ReLU
            if i != 2:
                h = F.max_pool3d(h, 2)
        return F.relu(self.fc(h.reshape(h.shape[0], -1)))


class LuckyDecoder(nn.Module):
    def __init__(self, bottleneck: Tuple[int, int, int] = (10, 12, 10), dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bottleneck = tuple(bottleneck)
        d, h, w = self.bottleneck
        self.fc = Linear(512, d * h * w * 64, dtype=dtype, generator=generator)
        self.fc_bn = BatchNorm(d * h * w * 64, dtype=dtype, act_slope=0.0)
        self.convs = nn.ModuleList([_conv(ci, co, dtype, generator)
                                    for ci, co in ((64, 32), (32, 3), (3, 3), (3, 1))])
        self.bns = nn.ModuleList([BatchNorm(c, dtype=dtype, act_slope=0.0) for c in (32, 3, 3)])

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, 512) -> (B, 1, 8d, 8h, 8w) in (0, 1)."""
        b = z.shape[0]
        # BatchNorm over the dense features: a (B, F, 1, 1, 1) view reduces
        # over the batch alone
        y = self.fc_bn(self.fc(z).reshape(b, -1, 1, 1, 1))
        y = to_channels_last(y.reshape((b, 64) + self.bottleneck))
        for i, (conv, bn) in enumerate(zip(self.convs[:3], self.bns)):
            if i != 1:
                y = upsample_nearest3d(y, 2)
            y = bn(conv(y))                      # conv -> BN -> ReLU
        return torch.sigmoid(self.convs[3](upsample_nearest3d(y, 2)))
