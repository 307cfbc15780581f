"""Configuration dataclasses for the spatial-latent model family.

Port of `sivae_tpu/config.py:27-129` with torch dtypes. The JAX package's
TPU tactics (`remat*`, `use_pallas_*`, `PACK_SAVES`) have no counterpart:
the port routes every 3x3x3 stride-1 conv the same way, to its CUDA kernel
for a CUDA tensor and to the plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch

# A block line is (channels, num_blocks, stride), the reference's
# `block_setting` encoding (reference models/models.py:97-102).
BlockLine = Tuple[int, int, int]


@dataclass(frozen=True)
class ActivationConfig:
    """Activation/dropout scheme distinguishing the reference model variants.

    - models.py    : leaky_relu(0.2) body, relu decoder tail, dropout on
    - models-conv-b-ReLU.py : leaky_relu everywhere, no dropout
    - vaemodel.py  : relu body, relu tail, no dropout
    """

    body_act: str = "leaky_relu"      # "leaky_relu" | "relu"
    negative_slope: float = 0.2
    decoder_tail_act: str = "relu"    # activation on the decoder output conv
    stem_dropout: float = 0.35        # encoder stem (reference models/models.py:95)
    dec_in_dropout: float = 0.25      # decoder input block (models.py:122)
    dec_out_dropout: float = 0.35     # decoder output block (models.py:140)

    def with_no_dropout(self) -> "ActivationConfig":
        return dataclasses.replace(
            self, stem_dropout=0.0, dec_in_dropout=0.0, dec_out_dropout=0.0
        )


@dataclass(frozen=True)
class SpatialVAEConfig:
    """Spatial-latent ResNet S-IntroVAE/VAE/CAE family.

    The latent is a 1-channel spatial map, e.g. 10x12x10 = 1200-d for
    `SoftIntroVAE(64, [[64,1,2],[128,1,2],[256,2,2]])` (reference
    z-1200main.py:158).
    """

    in_ch: int = 64
    block_setting: Tuple[BlockLine, ...] = ((64, 1, 2), (128, 1, 2), (256, 2, 2))
    input_shape: Tuple[int, int, int] = (80, 96, 80)  # D, H, W
    act: ActivationConfig = field(default_factory=ActivationConfig)
    variational: bool = True   # False => CAE (single 1x1 head, no mu/var)
    dtype: Any = torch.float32        # compute dtype (bfloat16 on the GPU hot path)
    param_dtype: Any = torch.float32
    # Early-training stability (deviations from the reference, kept from the
    # JAX package): zero-init the logvar head so e^logvar starts at 1, and
    # hard-clip logvar as a NaN rail.
    logvar_head_zero_init: bool = True
    logvar_clip: Optional[Tuple[float, float]] = (-30.0, 20.0)

    @property
    def latent_spatial_shape(self) -> Tuple[int, int, int]:
        d, h, w = self.input_shape
        for _, _, s in self.block_setting:
            d, h, w = d // s, h // s, w // s
        return (d, h, w)

    @property
    def latent_shape(self) -> Tuple[int, int, int, int]:
        """Per-sample latent shape in NCDHW (leading channel of 1)."""
        return (1,) + self.latent_spatial_shape

    @property
    def latent_dim(self) -> int:
        d, h, w = self.latent_spatial_shape
        return d * h * w

