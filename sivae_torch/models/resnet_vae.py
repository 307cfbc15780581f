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
With `cfg.remat` the regions of `sivae_tpu/models/resnet_vae.py:56-57` and
`:90-91` rematerialise in training (`models/remat.py`): the encoder's stem
and each `ConvBlock`, the decoder's head and each `UpBlock`; not the
encoder's heads nor the decoder's output conv, its activation and dropout.

Under depth sharding (`parallel/mesh.py`) both halves run on this rank's
depth slab: the encoder takes a volume slab (`shard_batch` at `depth_levels`)
and returns the latent's slab, the decoder takes a latent slab (flat or
shaped, `slab_shape(latent_shape)`) and returns the volume's slab.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from sivae_torch.config import SpatialVAEConfig
from sivae_torch.models.blocks import (Conv3d, ConvBlock, ConvBNAct, Dropout, UpBlock,
                                       kernel_kind, make_act, to_channels_last)
from sivae_torch.models.remat import ConvSite, Remat
from sivae_torch.parallel.mesh import depth_scale, slab_shape, volume_slab
from sivae_torch.utils.dtypes import widen


def bottom_depth(cfg) -> int:
    """The depth at a model's coarsest resolution: the latent's of a spatial
    config, the bottleneck's of an FC one (its Linears' volume)."""
    if isinstance(cfg, SpatialVAEConfig):
        return cfg.latent_spatial_shape[0]
    return cfg.bottleneck_spatial_shape[0]


def depth_levels(cfg) -> int:
    """The number of stride-2 stages in depth from the input to the coarsest
    resolution (`bottom_depth`): the `levels` a volume's depth slabs are
    split at (`parallel.mesh.volume_slab`), 3 for spatial_1200, 4 for the FC
    family (80 -> 5). `cfg` is a spatial or FC config, or a model part that
    names its own (`depth_levels`: the lucky AE's 3 max-pools). A grid with
    more spatial ranks than planes at that resolution is refused where the
    slabs are cut (`slab_bounds`)."""
    own = getattr(cfg, "depth_levels", None)
    if own is not None:
        return own
    return (cfg.input_shape[0] // bottom_depth(cfg)).bit_length() - 1


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
        self.remat = Remat(cfg.remat, cfg.remat_policy, "enc")

    def forward(self, x: torch.Tensor):
        h = to_channels_last(x)
        scale = depth_scale(self.cfg.latent_spatial_shape[0])
        for block in self.blocks:
            h = self.remat(self.training, block, h, depth_scale=scale)
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
        self.remat = Remat(cfg.remat, cfg.remat_policy, "dec")

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = to_channels_last(z.reshape((z.shape[0],) + slab_shape(self.cfg.latent_shape)))
        scale = depth_scale(self.cfg.latent_spatial_shape[0])
        tail = len(self.blocks) - 1
        for i, block in enumerate(self.blocks):
            h = block(h) if i == tail else self.remat(self.training, block, h,
                                                      depth_scale=scale)
        return self.dropout(self.tail_act(h))


def spatial_conv_sites(cfg: SpatialVAEConfig):
    """(encoder sites, decoder sites): every conv of one forward of each
    half, in the JAX modules' order, with the block-remat region it runs in
    (`models/remat.py` `ConvSite`), read from the config without a forward."""
    def vox(r):
        return r[0] * r[1] * r[2]

    r = tuple(cfg.input_shape)
    enc = [ConvSite(kernel_kind(1, cfg.in_ch), "enc", vox(r), "encoder.blocks.0")]
    ch, k = cfg.in_ch, 1
    for c, n, s in cfg.block_setting:
        for i in range(n):
            stride, name = (s if i == 0 else 1), f"encoder.blocks.{k}"
            low = tuple(d // stride for d in r)
            enc += [ConvSite(kernel_kind(ch, c), "enc", vox(r), name),
                    ConvSite(kernel_kind(c, c), "enc", vox(low), name)]
            if stride == 1 and ch != c:
                enc.append(ConvSite("1x1", "enc", vox(r), name))
            r, ch, k = low, c, k + 1
    enc += [ConvSite("1x1", "enc", vox(r), None)] * (2 if cfg.variational else 1)

    r = cfg.latent_spatial_shape
    ch = cfg.block_setting[-1][0]
    dec = [ConvSite("1x1", "dec", vox(r), "decoder.blocks.0")]
    rev, k = cfg.block_setting[::-1], 1
    for i, (c, n, s) in enumerate(rev):
        nc = cfg.in_ch if i == len(rev) - 1 else rev[i + 1][0]
        for j in range(n):
            last, name = j == n - 1, f"decoder.blocks.{k}"
            stride, out_c = (s, nc) if last else (1, c)
            high = tuple(d * stride for d in r)
            dec += [ConvSite(kernel_kind(ch, ch), "dec", vox(r), name),
                    ConvSite("upconv" if stride == 2 else kernel_kind(ch, out_c), "dec",
                             vox(high), name)]
            if stride == 1 and ch != out_c:
                dec.append(ConvSite("1x1", "dec", vox(r), name))
            r, ch, k = high, out_c, k + 1
    dec.append(ConvSite(kernel_kind(ch, 1), "dec", vox(r), None))
    return enc, dec


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, val_eps: Optional[float] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """z = mu + eps * std in fp32. Validation uses the reference's fixed eps
    (models/models.py:263-271, default 0.1); training draws eps ~ N(0, I)
    from `generator`, which must then be given."""
    std = torch.exp(0.5 * widen(logvar))
    if val_eps is not None:
        return widen(mu) + val_eps * std
    if generator is None:
        raise ValueError("reparameterize draws noise: pass a torch.Generator")
    eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=torch.float32)
    return widen(mu) + eps * std


class SoftIntroVAE(nn.Module):
    """Encoder + decoder of either family, under the reference's `encoder.` /
    `decoder.` keys (`sivae_tpu/models/resnet_vae.py:129-204`). `cfg` is the
    family's config: everything downstream reads its `latent_shape` and
    `input_shape`. Also the container of the plain VAE and of the CAE
    (whose encoder returns the latent itself)."""

    def __init__(self, cfg, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.encoder = encoder
        self.decoder = decoder

    def encode(self, x: torch.Tensor):
        """x (B, 1, D, H, W) -> (mu, logvar), each (B,) + latent_shape."""
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent_dim) or (B,) + latent_shape -> (B, 1, D, H, W)."""
        return self.decoder(z)

    @torch.no_grad()
    def sample_with_noise(self, num_samples: int, generator: torch.Generator) -> torch.Tensor:
        """Decode N(0, I) noise drawn from `generator`, on its device
        (reference models/models.py:298-300), in the model's current mode
        (the JAX package decodes with train=False: call it in eval mode)."""
        z = torch.randn((num_samples,) + self.cfg.latent_shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        if len(self.cfg.latent_shape) == 4:   # a spatial latent: this rank's depth slab
            z = z[:, :, volume_slab(self.cfg.latent_shape[1])]
        return self.decode(z)

    def sample(self, z: torch.Tensor) -> torch.Tensor:
        """Decode given flat latents (reference models/models.py:292-296);
        under depth sharding, this rank's slab of each."""
        shape = self.cfg.latent_shape
        return self.decode(z.reshape((-1,) + (slab_shape(shape) if len(shape) == 4 else shape)))


def make_spatial_soft_intro_vae(cfg: SpatialVAEConfig,
                                generator: Optional[torch.Generator] = None) -> SoftIntroVAE:
    """The encoder's weights are drawn from `generator` first, then the
    decoder's."""
    return SoftIntroVAE(cfg, SpatialEncoder(cfg, generator), SpatialDecoder(cfg, generator))
