"""3D CNN classifier: the spatial ResNet encoder's trunk + global average
pool + a dense head.

Port of `sivae_tpu/models/classifier.py:20-37`. The reference trains
arbitrary CNNs with CrossEntropy through its generic `train` loop
(utils/my_trainer.py:829-910) and evaluates them with a confusion matrix
(utils/confusion.py); the JAX package's classifier reuses the spatial
encoder's stem (with its dropout) and `ConvBlock`s without the VAE heads.
Module names follow the spatial encoder's: `blocks.0.{0,1}` (stem),
`blocks.k.0.block.{0,1,4,5}`, then `fc`. With `cfg.remat` the stem and each
block rematerialise in training, keeping their boundaries only (policy
None, whatever `cfg.remat_policy` says: `sivae_tpu/models/classifier.py:28-29`).

Under depth sharding (`parallel/mesh.py`, the input split at the trunk's
`depth_levels`) the trunk runs on this rank's slab; the pool is the slab's
voxel sum over the whole volume's voxel count, and `fc` takes those partial
means and sums its products over the spatial ranks, the bias once
(`linear_of_partial_sums`), so its weight takes its gradient once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from sivae_torch.config import SpatialVAEConfig
from sivae_torch.models.blocks import ConvBlock, ConvBNAct, Linear, to_channels_last
from sivae_torch.models.remat import Remat
from sivae_torch.parallel.distributed import spatial_ranks
from sivae_torch.parallel.mesh import depth_scale, linear_of_partial_sums


class ResNetClassifier(nn.Module):
    def __init__(self, cfg: SpatialVAEConfig, num_classes: int = 2,
                 generator: Optional[torch.Generator] = None):
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
        self.fc = Linear(ch, num_classes, **kw)
        self.remat = Remat(cfg.remat, None, "enc")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 1, D, H, W) -> logits (B, num_classes), fp32 whatever the
        compute dtype (as the JAX classifier's)."""
        h = to_channels_last(x)
        bottom = self.cfg.latent_spatial_shape
        scale = depth_scale(bottom[0])
        for block in self.blocks:
            h = self.remat(self.training, block, h, depth_scale=scale)
        if spatial_ranks() == 1:
            return self.fc(h.mean(dim=(2, 3, 4))).float()   # global average pool
        pooled = h.sum(dim=(2, 3, 4), dtype=torch.promote_types(h.dtype, torch.float32))
        return linear_of_partial_sums(self.fc, pooled / math.prod(bottom)).float()
