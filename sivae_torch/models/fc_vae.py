"""FC-latent ("vector z") Soft-IntroVAE family (PyTorch, NCDHW).

Port of `sivae_tpu/models/fc_vae.py:38-151` (reference models/mymodel.py:
the encoder `ResNetVAEencoder` :51-143, the decoder `ResNetDecoder`
:146-230). A hand-placed 4-stage encoder (AvgPool x4: 80x96x80 -> 5x6x5)
with two skip connections and one Linear(forth_ch*150 -> 2*z_ch) head
split into (mu, logvar); the mirrored decoder has Linear(z_ch ->
forth_ch*150) + ReLU, conv / upsample stages with skips, and a conv -> ReLU
output.

Module names follow the reference `state_dict`, so a reference FC `.pth`
loads with `load_state_dict`: `encoder.block{1,2,3}.{0,1,3,4}`,
`block4short.{0,1}`, `block5.{0,1}`, `block6.{0,1,4,5}`,
`block7.{0,1,3,4}`, `encoder.fc`; `decoder.dfc.0`,
`decoder.block{1,3}.{0,1,3,4}`, `block{2,4,5,6}u.{0,1,4,5}`,
`decoder.last_block.0`. Indices that hold an activation, a pool or an
upsample in the reference hold an identity (the BN applies the activation
itself) or the parameter-free op.

The head flattens the NCDHW tensor in (C, D, H, W) order, as the reference
does; the JAX package flattens (D, H, W, C), so carrying its weights over
permutes the `fc` input features and the `dfc` output features
(`utils/jax_import.py`). The one `encoder.fc` Linear stands for the JAX
package's two Dense heads: `logvar_head_zero_init` zeroes its rows
z_ch:2*z_ch, `logvar_clip` clamps its second half.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sivae_torch.config import FCVAEConfig
from sivae_torch.models.blocks import (AvgPool, BatchNorm, Conv3d, Linear, UpsampleConv3d,
                                       Upsample, act_slope, avg_pool3d, make_act,
                                       to_channels_last)
from sivae_torch.models.resnet_vae import SoftIntroVAE


class _Parts:
    """The conv and BN factories of one FC model."""

    def __init__(self, cfg: FCVAEConfig, generator: Optional[torch.Generator]):
        self.kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.slope = act_slope(cfg.act)
        self.generator = generator
        self.fuse_upconv = cfg.fuse_upconv

    def conv(self, ci: int, co: int, cls=Conv3d) -> Conv3d:
        return cls(ci, co, use_bias=True, generator=self.generator, **self.kw)

    def bn(self, c: int, act: bool = True) -> BatchNorm:
        return BatchNorm(c, act_slope=self.slope if act else None, **self.kw)

    def unit2(self, ci: int, cm: int, co: int) -> nn.Sequential:
        """conv-BN-act, conv-BN-act (indices 0, 1, 3, 4)."""
        return nn.Sequential(self.conv(ci, cm), self.bn(cm), nn.Identity(),
                             self.conv(cm, co), self.bn(co))

    def skip(self, c: int) -> nn.Sequential:
        """conv-BN-act, conv-BN (no activation before the residual add)."""
        return nn.Sequential(self.conv(c, c), self.bn(c), nn.Identity(),
                             self.conv(c, c), self.bn(c, act=False))

    def up(self, ci: int, co: int) -> nn.Sequential:
        """conv-BN-act, nearest-up(2), conv-BN-act (indices 0, 1, 4, 5); the
        upsample and the second conv fuse into one transposed conv unless
        `fuse_upconv` is off."""
        if self.fuse_upconv:
            return nn.Sequential(self.conv(ci, ci), self.bn(ci), nn.Identity(), nn.Identity(),
                                 self.conv(ci, co, UpsampleConv3d), self.bn(co))
        return nn.Sequential(self.conv(ci, ci), self.bn(ci), nn.Identity(), Upsample(2),
                             self.conv(ci, co), self.bn(co))


class FCEncoder(nn.Module):
    """Reference models/mymodel.py:51-143 (`ResNetVAEencoder`)."""

    def __init__(self, cfg: FCVAEConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        p = _Parts(cfg, generator)
        f, s, t, fo = cfg.first_ch, cfg.second_ch, cfg.third_ch, cfg.forth_ch
        self.block1 = p.unit2(1, f, f)
        self.block2 = p.unit2(f, f, s)
        self.block3 = p.unit2(s, s, t)
        self.block4short = nn.Sequential(p.conv(t, t), p.bn(t))
        self.block5 = nn.Sequential(p.conv(t, t), p.bn(t))
        # conv -> pool -> channel up t -> fo (mymodel.py:91-99)
        self.block6 = nn.Sequential(p.conv(t, t), p.bn(t), nn.Identity(), AvgPool(2),
                                    p.conv(t, fo), p.bn(fo))
        self.block7 = p.skip(fo)
        self.act = make_act(cfg.act)
        d, h, w = cfg.bottleneck_spatial_shape
        self.fc = Linear(fo * d * h * w, 2 * cfg.z_ch, generator=generator, **p.kw)
        if cfg.logvar_head_zero_init:
            with torch.no_grad():
                self.fc.weight[cfg.z_ch:].zero_()

    def forward(self, x: torch.Tensor):
        """x (B, 1, D, H, W) -> (mu, logvar), each (B, z_ch)."""
        h = to_channels_last(x)
        for block in (self.block1, self.block2, self.block3):
            h = avg_pool3d(block(h), 2)
        h = self.block4short(h)
        h = self.act(h + self.block5(h))   # mymodel.py:135-136
        h = self.block6(h)
        h = self.act(h + self.block7(h))
        mu, logvar = self.fc(h.reshape(h.shape[0], -1)).chunk(2, dim=1)
        if self.cfg.logvar_clip is not None:
            logvar = torch.clamp(logvar, *self.cfg.logvar_clip)
        return mu, logvar


class FCDecoder(nn.Module):
    """Reference models/mymodel.py:146-230 (`ResNetDecoder`)."""

    def __init__(self, cfg: FCVAEConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        p = _Parts(cfg, generator)
        f, s, t, fo = cfg.first_ch, cfg.second_ch, cfg.third_ch, cfg.forth_ch
        d, h, w = cfg.bottleneck_spatial_shape
        self.dfc = nn.Sequential(Linear(cfg.z_ch, fo * d * h * w, generator=generator, **p.kw))
        self.block1 = p.skip(fo)
        self.block2u = p.up(fo, t)
        self.block3 = p.skip(t)
        self.block4u = p.up(t, s)
        self.block5u = p.up(s, f)
        self.block6u = p.up(f, f)
        self.last_block = nn.Sequential(p.conv(f, 1))
        self.act = make_act(cfg.act)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, z_ch) -> (B, 1, D, H, W)."""
        b = z.shape[0]
        # the dfc tail is a ReLU, not the body activation (mymodel.py:150-153)
        y = F.relu(self.dfc(z.reshape(b, -1)))
        y = to_channels_last(y.reshape((b, self.cfg.forth_ch) + self.cfg.bottleneck_spatial_shape))
        y = self.act(y + self.block1(y))   # mymodel.py:221-222
        y = self.block2u(y)
        y = self.act(y + self.block3(y))
        y = self.block6u(self.block5u(self.block4u(y)))
        # the output conv is followed by a ReLU (mymodel.py:210-213)
        return F.relu(self.last_block(y))


def make_fc_soft_intro_vae(cfg: FCVAEConfig,
                           generator: Optional[torch.Generator] = None) -> SoftIntroVAE:
    return SoftIntroVAE(cfg, FCEncoder(cfg, generator), FCDecoder(cfg, generator))
