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

Under depth sharding (`parallel/mesh.py`; the input split at `depth_levels`,
the four pools', so a slab keeps whole planes down to the bottleneck) the
conv trunk runs on this rank's slab with halo exchanges and the grid's
BatchNorm (`models/blocks.py`); `encoder.fc` takes the slab's columns of its
weight and sums the ranks' partial products (`linear_from_slab`), and
`decoder.dfc.0` computes the slab's rows of its output from the whole `z`
(`linear_to_slab`). (mu, logvar) and `z` are whole on every spatial rank.

With `cfg.remat` each conv-BN-act unit (JAX's `cba`,
`sivae_tpu/models/fc_vae.py:49` and `:105`) rematerialises in training
(`models/remat.py`; `UNIT2`, `SKIP` and `UP` give them as index ranges of
the Sequentials `_Parts` makes). The conv-BN that closes a skip block, the
output conv and the Linears are not wrapped, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sivae_torch.config import FCVAEConfig
from sivae_torch.models.blocks import (AvgPool, BatchNorm, Conv3d, Linear, UpsampleConv3d,
                                       Upsample, act_slope, avg_pool3d, kernel_kind, make_act,
                                       to_channels_last)
from sivae_torch.models.remat import ConvSite, Remat, run_units
from sivae_torch.models.resnet_vae import SoftIntroVAE
from sivae_torch.parallel.mesh import depth_scale, linear_from_slab, linear_to_slab

# the conv-BN-act units of each Sequential `_Parts` makes, as index ranges
UNIT2 = ((0, 2), (3, 5))  # unit2: conv-BN-act, conv-BN-act
SKIP = ((0, 2),)          # skip (its closing conv-BN is not a unit), block4short, block5
UP = ((0, 2), (4, 6))     # up and block6: conv-BN-act, upsample / pool, conv-BN-act


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
        self.remat = Remat(cfg.remat, cfg.remat_policy, "enc")
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
        bottleneck = (self.cfg.forth_ch,) + self.cfg.bottleneck_spatial_shape
        scale = depth_scale(bottleneck[1])

        def run(seq, units, t):
            return run_units(seq, units, t, self.remat, self.training, depth_scale=scale)

        h = to_channels_last(x)
        for block in (self.block1, self.block2, self.block3):
            h = avg_pool3d(run(block, UNIT2, h), 2)
        h = run(self.block4short, SKIP, h)
        h = self.act(h + run(self.block5, SKIP, h))   # mymodel.py:135-136
        h = run(self.block6, UP, h)
        h = self.act(h + run(self.block7, SKIP, h))
        mu, logvar = linear_from_slab(self.fc, h, bottleneck).chunk(2, dim=1)
        if self.cfg.logvar_clip is not None:
            logvar = torch.clamp(logvar, *self.cfg.logvar_clip)
        return mu, logvar


class FCDecoder(nn.Module):
    """Reference models/mymodel.py:146-230 (`ResNetDecoder`)."""

    def __init__(self, cfg: FCVAEConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.remat = Remat(cfg.remat, cfg.remat_policy, "dec")
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
        """z (B, z_ch) -> (B, 1, D, H, W); under depth sharding this
        rank's slab of the volume."""
        bottleneck = (self.cfg.forth_ch,) + self.cfg.bottleneck_spatial_shape
        scale = depth_scale(bottleneck[1])

        def run(seq, units, t):
            return run_units(seq, units, t, self.remat, self.training, depth_scale=scale)

        # the dfc tail is a ReLU, not the body activation (mymodel.py:150-153)
        y = F.relu(linear_to_slab(self.dfc[0], z.reshape(z.shape[0], -1), bottleneck))
        y = to_channels_last(y)
        y = self.act(y + run(self.block1, SKIP, y))   # mymodel.py:221-222
        y = run(self.block2u, UP, y)
        y = self.act(y + run(self.block3, SKIP, y))
        for block in (self.block4u, self.block5u, self.block6u):
            y = run(block, UP, y)
        # the output conv is followed by a ReLU (mymodel.py:210-213)
        return F.relu(self.last_block(y))


def fc_conv_sites(cfg: FCVAEConfig):
    """(encoder sites, decoder sites): every conv of one forward of each
    half, in the JAX modules' order, with the conv-BN-act unit it runs in
    (`models/remat.py` `ConvSite`), read from the config without a forward."""
    f, s, t, fo = cfg.first_ch, cfg.second_ch, cfg.third_ch, cfg.forth_ch
    r = tuple(cfg.input_shape)
    vox = [r[0] * r[1] * r[2]]
    for _ in range(4):                      # the four stride-2 pools
        r = tuple(d // 2 for d in r)
        vox.append(r[0] * r[1] * r[2])

    def site(ci, co, lvl, scope, name, unit):
        half = "encoder" if scope == "enc" else "decoder"
        return ConvSite(kernel_kind(ci, co), scope, vox[lvl], f"{half}.{name}.{unit}")

    enc = []
    for lvl, (name, ci, cm, co) in enumerate((("block1", 1, f, f), ("block2", f, f, s),
                                              ("block3", s, s, t))):
        enc += [site(ci, cm, lvl, "enc", name, "0:2"), site(cm, co, lvl, "enc", name, "3:5")]
    enc += [site(t, t, 3, "enc", "block4short", "0:2"), site(t, t, 3, "enc", "block5", "0:2"),
            site(t, t, 3, "enc", "block6", "0:2"), site(t, fo, 4, "enc", "block6", "4:6"),
            site(fo, fo, 4, "enc", "block7", "0:2"),
            ConvSite(kernel_kind(fo, fo), "enc", vox[4], None)]

    def up(ci, co, lvl, name):
        kind = "upconv" if cfg.fuse_upconv else kernel_kind(ci, co)
        return [site(ci, ci, lvl, "dec", name, "0:2"),
                ConvSite(kind, "dec", vox[lvl - 1], f"decoder.{name}.4:6")]

    dec = [site(fo, fo, 4, "dec", "block1", "0:2"),
           ConvSite(kernel_kind(fo, fo), "dec", vox[4], None)]
    dec += up(fo, t, 4, "block2u")
    dec += [site(t, t, 3, "dec", "block3", "0:2"),
            ConvSite(kernel_kind(t, t), "dec", vox[3], None)]
    dec += up(t, s, 3, "block4u") + up(s, f, 2, "block5u") + up(f, f, 1, "block6u")
    dec.append(ConvSite(kernel_kind(f, 1), "dec", vox[0], None))
    return enc, dec


def make_fc_soft_intro_vae(cfg: FCVAEConfig,
                           generator: Optional[torch.Generator] = None) -> SoftIntroVAE:
    return SoftIntroVAE(cfg, FCEncoder(cfg, generator), FCDecoder(cfg, generator))
