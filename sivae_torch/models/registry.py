"""Named model configs (port of `sivae_tpu/models/registry.py:25-74`).

| name              | reference ctor                                               |
|-------------------|--------------------------------------------------------------|
| spatial_150       | models.SoftIntroVAE(12,[[12,1,2],[24,1,2],[32,2,2],[48,2,2]])|
| spatial_1200      | models.SoftIntroVAE(64,[[64,1,2],[128,1,2],[256,2,2]])       |
| fc_150 / fc_600   | mymodel.SoftIntroVAE(12,24,32,48,z) (600z_main.py:176) and   |
|                   | the documented (16,32,64,128,600) variant (600z_main.py:54)  |
| vae_150           | vaemodel.ResNetVAE: ReLU body, no dropout                    |
| cae_150           | models.ResNetCAE                                             |
| *_noreg           | models-conv-b-ReLU.py: LeakyReLU tail, no dropout            |
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from sivae_torch.config import ActivationConfig, FCVAEConfig, SpatialVAEConfig
from sivae_torch.models.fc_vae import make_fc_soft_intro_vae
from sivae_torch.models.resnet_vae import make_spatial_soft_intro_vae
from sivae_torch.utils.device import resolve_device

ModelConfig = Union[SpatialVAEConfig, FCVAEConfig]

_LEAKY = ActivationConfig()
_LEAKY_NODROP = ActivationConfig().with_no_dropout()
_ALL_LEAKY_NODROP = dataclasses.replace(_LEAKY_NODROP, decoder_tail_act="leaky_relu")
_RELU_NODROP = dataclasses.replace(_LEAKY_NODROP, body_act="relu")

_SMALL_BLOCKS = ((12, 1, 2), (24, 1, 2), (32, 2, 2), (48, 2, 2))
_LARGE_BLOCKS = ((64, 1, 2), (128, 1, 2), (256, 2, 2))

MODEL_REGISTRY = {
    "spatial_150": SpatialVAEConfig(in_ch=12, block_setting=_SMALL_BLOCKS, act=_LEAKY),
    "spatial_1200": SpatialVAEConfig(in_ch=64, block_setting=_LARGE_BLOCKS, act=_LEAKY),
    "spatial_1200_noreg": SpatialVAEConfig(
        in_ch=64, block_setting=_LARGE_BLOCKS, act=_ALL_LEAKY_NODROP
    ),
    "vae_150": SpatialVAEConfig(in_ch=12, block_setting=_SMALL_BLOCKS, act=_RELU_NODROP),
    "cae_150": SpatialVAEConfig(
        in_ch=12, block_setting=_SMALL_BLOCKS, act=_LEAKY, variational=False
    ),
    "fc_150": FCVAEConfig(first_ch=12, second_ch=24, third_ch=32, forth_ch=48, z_ch=150),
    "fc_300": FCVAEConfig(first_ch=12, second_ch=24, third_ch=32, forth_ch=48, z_ch=300),
    "fc_600": FCVAEConfig(first_ch=16, second_ch=32, third_ch=64, forth_ch=128, z_ch=600),
    # "fullsize" (~5M voxel) volumes: 4 stride-2 stages -> z map (10,12,10)
    "spatial_1200_fullsize": SpatialVAEConfig(
        in_ch=32,
        block_setting=((32, 1, 2), (64, 1, 2), (128, 1, 2), (256, 2, 2)),
        input_shape=(160, 192, 160), act=_LEAKY),
    # tiny configs for tests / CPU smoke runs (16x16x16 input)
    "tiny_spatial": SpatialVAEConfig(
        in_ch=4, block_setting=((4, 1, 2), (8, 2, 2)), input_shape=(16, 16, 16), act=_LEAKY
    ),
    "tiny_fc": FCVAEConfig(
        first_ch=2, second_ch=3, third_ch=4, forth_ch=5, z_ch=7, input_shape=(16, 16, 16)
    ),
}


def get_model_config(name: str) -> ModelConfig:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}") from None


def make_model(cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None,
               seed: int = 0):
    """Build the model of the config's family with weights drawn from `seed`
    (on the CPU, so the same seed gives the same weights on every device),
    move it to `device` (CUDA unless "cpu" is asked for) and put it in eval
    mode."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    make = make_fc_soft_intro_vae if isinstance(cfg, FCVAEConfig) else make_spatial_soft_intro_vae
    return make(cfg, gen).to(dev).eval()
