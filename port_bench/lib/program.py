"""The system under test, as the benchmark builds it: `sivae_torch`'s
configuration of a configuration file, and its model with the benchmark's
weights. Everything else the entries call is the program's own public
path (the train step, the pipeline, the eval functions)."""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: dict, traffic: dict) -> str:
    """The compute type the configuration states for the traffic's entry."""
    return cfg["dtype"][traffic["entry"]]


def model_config(cfg: dict, dtype: str):
    """The program's config dataclass for configuration file `cfg`, with
    compute type `dtype` and float32 parameters."""
    from sivae_torch.config import ActivationConfig, FCVAEConfig, SpatialVAEConfig

    common = dict(input_shape=tuple(cfg["input_shape"]), act=ActivationConfig(**cfg["act"]),
                  dtype=DTYPES[dtype], param_dtype=DTYPES[cfg["param_dtype"]],
                  logvar_head_zero_init=cfg["logvar_head_zero_init"],
                  logvar_clip=tuple(cfg["logvar_clip"]) if cfg["logvar_clip"] else None)
    if cfg["family"] == "spatial":
        return SpatialVAEConfig(in_ch=cfg["in_ch"],
                                block_setting=tuple(tuple(b) for b in cfg["block_setting"]),
                                variational=True, **common)
    return FCVAEConfig(first_ch=cfg["first_ch"], second_ch=cfg["second_ch"],
                       third_ch=cfg["third_ch"], forth_ch=cfg["forth_ch"], z_ch=cfg["z_ch"],
                       **common)


def program_model(cfg: dict, dtype: str, state: Dict[str, torch.Tensor], device):
    """`make_model` of the config, with `state` loaded (every key must match)."""
    from sivae_torch.models.registry import make_model

    model = make_model(model_config(cfg, dtype), device=device)
    model.load_state_dict(state, strict=True)
    return model
