"""Spatial-latent ResNet VAE / CAE / Soft-IntroVAE family (PyTorch, NCDHW).

Port of `sivae_tpu/models/resnet_vae.py:42-214` (reference
models/models.py: ResNetEncoder :83-108, ResNetDecoder :110-145,
SoftIntroVAE :257-300). Module names follow the reference `state_dict`:
`encoder.blocks.0.{0,1}` (stem), `encoder.blocks.k.0.block.{0,1,4,5}`,
`encoder.mu` / `encoder.var` (or `encoder.conv.0` for the CAE head),
`decoder.blocks.0.{0,1}`, `decoder.blocks.k.0.block.{...}` and
`decoder.blocks.{last}.0` (output conv).

The latent is a 1-channel spatial map (B, 1, d, h, w) with
(d, h, w) = input_shape / prod(strides), e.g. (10, 12, 10) -> 1200-d.
Parameters are fp32; `cfg.dtype` is the compute dtype. In eval mode BN
takes its running statistics and dropout is the identity; in training mode
(`train/step.py` switches it) BN takes the batch's statistics and moves the
running ones, and every `Dropout` draws from the generator it was given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from sivae_torch.config import SpatialVAEConfig
from sivae_torch.models.blocks import (Conv3d, ConvBlock, ConvBNAct, Dropout, UpBlock, make_act,
                                       to_channels_last)


class SpatialEncoder(nn.Module):
    """Stem + ConvBlock stack + 1x1 head(s)."""

    def __init__(self, cfg: SpatialVAEConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, generator=generator)
        blocks = [ConvBNAct(1, cfg.in_ch, cfg.act, dropout=cfg.act.stem_dropout, **kw)]
        ch = cfg.in_ch
        for c, n, s in cfg.block_setting:
            for i in range(n):
                blocks.append(nn.Sequential(ConvBlock(ch, c, s if i == 0 else 1, cfg.act, **kw)))
                ch = c
        self.blocks = nn.ModuleList(blocks)
        if cfg.variational:
            self.mu = Conv3d(ch, 1, 1, use_bias=True, **kw)
            self.var = Conv3d(ch, 1, 1, use_bias=True, zero_init=cfg.logvar_head_zero_init, **kw)
        else:
            self.conv = nn.Sequential(Conv3d(ch, 1, 1, use_bias=True, **kw))

    def forward(self, x: torch.Tensor):
        h = to_channels_last(x)
        for block in self.blocks:
            h = block(h)
        if not self.cfg.variational:
            return self.conv(h)
        mu, logvar = self.mu(h), self.var(h)
        if self.cfg.logvar_clip is not None:
            logvar = torch.clamp(logvar, *self.cfg.logvar_clip)
        return mu, logvar


class SpatialDecoder(nn.Module):
    """Mirror of the encoder: 1x1 expand + UpBlock walk + output conv.

    The channel schedule walks `block_setting` in reverse, switching to the
    next line's channel count (or the stem width at the end) on the last
    block of each line (reference models/models.py:110-145).
    """

    def __init__(self, cfg: SpatialVAEConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, generator=generator)
        ch = cfg.block_setting[-1][0]
        blocks = [ConvBNAct(1, ch, cfg.act, dropout=cfg.act.dec_in_dropout, kernel_size=1, **kw)]
        rev = cfg.block_setting[::-1]
        for i, (c, n, s) in enumerate(rev):
            nc = cfg.in_ch if i == len(rev) - 1 else rev[i + 1][0]
            for j in range(n):
                last = j == n - 1
                out_c = nc if last else c
                blocks.append(nn.Sequential(UpBlock(ch, out_c, s if last else 1, cfg.act, **kw)))
                ch = out_c
        blocks.append(nn.Sequential(Conv3d(ch, 1, 3, use_bias=True, **kw)))
        self.blocks = nn.ModuleList(blocks)
        self.tail_act = make_act(cfg.act, which="tail")
        self.dropout = Dropout(cfg.act.dec_out_dropout)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = to_channels_last(z.reshape((z.shape[0],) + self.cfg.latent_shape))
        for block in self.blocks:
            h = block(h)
        return self.dropout(self.tail_act(h))


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, val_eps: Optional[float] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """z = mu + eps * std in fp32. Validation uses the reference's fixed eps
    (models/models.py:263-271, default 0.1); training draws eps ~ N(0, I)
    from `generator`, which must then be given."""
    std = torch.exp(0.5 * logvar.float())
    if val_eps is not None:
        return mu.float() + val_eps * std
    if generator is None:
        raise ValueError("reparameterize draws noise: pass a torch.Generator")
    eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=torch.float32)
    return mu.float() + eps * std


class SoftIntroVAE(nn.Module):
    """Encoder + decoder, under the reference's `encoder.` / `decoder.` keys."""

    def __init__(self, cfg: SpatialVAEConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = SpatialEncoder(cfg, generator)
        self.decoder = SpatialDecoder(cfg, generator)

    def encode(self, x: torch.Tensor):
        """x (B, 1, D, H, W) -> (mu, logvar), each (B, 1, d, h, w)."""
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent_dim) or (B, 1, d, h, w) -> (B, 1, D, H, W)."""
        return self.decoder(z)

    @torch.no_grad()
    def sample_with_noise(self, num_samples: int, generator: torch.Generator) -> torch.Tensor:
        """Decode N(0, I) noise drawn from `generator`, on its device
        (reference models/models.py:298-300), in the model's current mode
        (the JAX package decodes with train=False: call it in eval mode)."""
        z = torch.randn((num_samples,) + self.cfg.latent_shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return self.decode(z)

    def sample(self, z: torch.Tensor) -> torch.Tensor:
        """Decode given flat latents (reference models/models.py:292-296)."""
        return self.decode(z.reshape((-1,) + self.cfg.latent_shape))
