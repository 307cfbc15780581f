"""Configuration dataclasses for the spatial-latent and FC-latent model
families.

Port of `sivae_tpu/config.py:27-170`, `:178-260` (the loss, optimizer and
trainer configs) and `to_json`, with torch dtypes. The JAX package's TPU
tactics (`remat*`, `use_pallas_*`, `PACK_SAVES`) have no counterpart:
the port routes every 3x3x3 stride-1 conv the same way, to its CUDA kernel
for a CUDA tensor and to the plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

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


@dataclass(frozen=True)
class FCVAEConfig:
    """FC-latent ("vector z") family, reference models/mymodel.py
    (`sivae_tpu/config.py:133-170`).

    Four stages of stride-2 AvgPool with hand-placed skip connections down to
    a (5,6,5) grid, then Linear(forth_ch*150 -> 2*z_ch) split into (mu,
    logvar); z_ch in {150, 300, 600} (reference 600z_main.py:176).
    `fuse_upconv=False` runs each decoder upsample as a nearest upsample
    followed by a 3x3x3 conv (the reference's op structure) instead of the
    fused transposed conv.
    """

    first_ch: int = 12
    second_ch: int = 24
    third_ch: int = 32
    forth_ch: int = 48
    z_ch: int = 150
    input_shape: Tuple[int, int, int] = (80, 96, 80)
    act: ActivationConfig = field(
        default_factory=lambda: ActivationConfig().with_no_dropout()
    )
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    logvar_head_zero_init: bool = True
    logvar_clip: Optional[Tuple[float, float]] = (-30.0, 20.0)
    fuse_upconv: bool = True

    @property
    def bottleneck_spatial_shape(self) -> Tuple[int, int, int]:
        d, h, w = self.input_shape
        return (d // 16, h // 16, w // 16)

    @property
    def latent_shape(self) -> Tuple[int, ...]:
        return (self.z_ch,)

    @property
    def latent_dim(self) -> int:
        return self.z_ch


@dataclass(frozen=True)
class SoftIntroLossConfig:
    """Soft-IntroVAE loss hyper-parameters (reference utils/my_trainer.py:188-198).

    `scale` is the paper's normalizing constant s; the reference uses
    8 / (80*96*80). `loss_multiplier` is the x10 applied to both lossE and
    lossD (my_trainer.py:284,321); the DataParallel variant uses multiplier
    1.0 and expELBO weight 0.25 (main_DataParallel.py:470).

    `dp_semantics` selects the DataParallel trainer's step, which differs
    from my_trainer in four ways: (1) every KL is per position (its calc_kl
    sums the singleton channel only); (2) its reconstruction loss ignores
    `reduction`, so the expELBO recon terms are batch-mean scalars; (3) phase
    D's loss_rec uses rec.detach(); (4) phase D re-decodes z_rec / z_fake
    without detaching them.
    """

    beta_rec: float = 1.0
    beta_neg: float = 1024.0
    beta_kl: float = 0.75
    gamma_r: float = 1e-8
    scale: Optional[float] = None  # None => 8 / prod(input_shape)
    exp_elbo_weight: float = 0.5
    loss_multiplier: float = 10.0
    dp_semantics: bool = False

    def resolved_scale(self, input_shape: Sequence[int]) -> float:
        if self.scale is not None:
            return self.scale
        n = 1
        for s in input_shape:
            n *= s
        return 8.0 / n


@dataclass(frozen=True)
class OptimConfig:
    """Adam + MultiStep LR (reference my_trainer.py:183-186)."""

    lr: float = 2e-4
    milestones: Tuple[int, ...] = (350,)  # in epochs
    gamma: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclass(frozen=True)
class TrainConfig:
    """Epoch-loop settings (`sivae_tpu/config.py:234-246`). The JAX config's
    mesh fields come with data parallelism."""

    epochs: int = 500
    batch_size: int = 8
    seed: int = 77                 # trainer seed (my_trainer.py:160)
    steps_per_epoch: Optional[int] = None  # None => derived from dataset
    num_epochs_warm_start: int = 0
    checkpoint_every_epochs: int = 1
    eval_every_epochs: int = 1
    val_eps: float = 0.1           # fixed val-reparam eps (models/models.py:269)
    log_images_every_epochs: int = 20


def to_json(cfg: Any) -> str:
    """Serialize any config dataclass tree to JSON (run provenance, the
    reference's `my_args.txt`, main.py:152-153); dtypes become their names."""
    return json.dumps(dataclasses.asdict(cfg), default=str, indent=2)
