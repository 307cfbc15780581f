"""Carry weights into the port: from JAX variables, or from a reference .pth.

`jax_to_state_dict` is the inverse of `sivae_tpu/utils/torch_import.py:84-142`:
it takes the JAX package's spatial-model variables
`{"enc"|"dec": {"params": ..., "batch_stats": ...}}` (nested dicts of numpy
arrays, with or without the `Checkpoint` prefix that remat adds to module
names) and returns the port's `state_dict`:

  enc ConvBNAct_0/{Conv3d_0,BatchNorm_0}    -> encoder.blocks.0.{0,1}
  enc ConvBlock_{k-1}/{Conv3d_0,BatchNorm_0,Conv3d_1,BatchNorm_1,Conv3d_2}
                                            -> encoder.blocks.k.0.{block.0,block.1,
                                               block.4,block.5,shortcut}
  enc mu / logvar / head                    -> encoder.mu / encoder.var / encoder.conv.0
  dec ConvBNAct_0                           -> decoder.blocks.0.{0,1}
  dec UpBlock_{k-1}/...                     -> decoder.blocks.k.0.{...}
  dec Conv3d_0 (output conv)                -> decoder.blocks.{last}.0

Conv kernels go DHWIO -> OIDHW; BN scale/bias/mean/var go to
weight/bias/running_mean/running_var. flax keeps no BN step counter, so
`num_batches_tracked` is set to 0. Any JAX leaf without a port tensor, or
port tensor without a JAX leaf, raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

_BLOCK_SUB = {"Conv3d_0": "block.0", "BatchNorm_0": "block.1", "Conv3d_1": "block.4",
              "BatchNorm_1": "block.5", "Conv3d_2": "shortcut"}
_UNIT_SUB = {"Conv3d_0": "0", "BatchNorm_0": "1"}
_LEAF = {("params", "kernel"): "weight", ("params", "bias"): "bias",
         ("params", "scale"): "weight", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _module_key(side: str, path: Tuple[str, ...], n_dec_blocks: int) -> str:
    """Port module prefix for the JAX module path (leaf names removed)."""
    head = path[0][len("Checkpoint"):] if path[0].startswith("Checkpoint") else path[0]
    rest = path[1:]
    m = re.fullmatch(r"(ConvBNAct|ConvBlock|UpBlock)_(\d+)", head)
    if m and m.group(1) == "ConvBNAct" and m.group(2) == "0" and rest[0] in _UNIT_SUB:
        return f"{side}.blocks.0.{_UNIT_SUB[rest[0]]}"
    if m and m.group(1) in ("ConvBlock", "UpBlock") and rest[0] in _BLOCK_SUB:
        want = "ConvBlock" if side == "encoder" else "UpBlock"
        if m.group(1) == want:
            return f"{side}.blocks.{int(m.group(2)) + 1}.0.{_BLOCK_SUB[rest[0]]}"
    if side == "encoder" and not rest and head in ("mu", "logvar", "head"):
        return {"mu": "encoder.mu", "logvar": "encoder.var", "head": "encoder.conv.0"}[head]
    if side == "decoder" and head == "Conv3d_0" and not rest:
        return f"decoder.blocks.{n_dec_blocks + 1}.0"
    raise KeyError(f"JAX leaf {side}:{'/'.join(path)} has no port tensor")


def jax_to_state_dict(variables: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX spatial-model variables -> the port model's full `state_dict`."""
    n_dec = sum(n for _, n, _ in model.cfg.block_setting)
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for jside, side in (("enc", "encoder"), ("dec", "decoder")):
        for col in ("params", "batch_stats"):
            for path, arr in _flatten(variables[jside].get(col, {})).items():
                # module path = all but the last two names (".../Conv_0/kernel",
                # ".../BatchNorm_0/scale"): the wrapper's inner module and the leaf
                leaf = _LEAF.get((col, path[-1]))
                if leaf is None:
                    raise KeyError(f"JAX leaf {jside}/{col}/{'/'.join(path)} has no port tensor")
                key = f"{_module_key(side, path[:-2], n_dec)}.{leaf}"
                if key not in target:
                    raise KeyError(f"JAX leaf {jside}/{col}/{'/'.join(path)} -> {key}: "
                                   "no such port tensor")
                if arr.ndim == 5:
                    arr = arr.transpose(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
                t = torch.tensor(arr, dtype=target[key].dtype)
                if t.shape != target[key].shape:
                    raise ValueError(f"shape mismatch at {key}: {tuple(t.shape)} vs "
                                     f"{tuple(target[key].shape)}")
                out[key] = t
    for key, t in target.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(t)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port tensors without a JAX leaf: {missing}")
    return out


def _is_orphan(key: str, model_keys) -> bool:
    """Reference weights the model never uses: torch's BuildingBlock builds a
    projection conv even when the residual path is unused (stride != 1,
    reference models.py:28-35), and the reference's variational encoder
    also carries the CAE head `encoder.conv.0`."""
    return key not in model_keys and (".shortcut." in key or key.startswith("encoder.conv."))


def load_reference_pth(model: nn.Module,
                       source: Union[str, Mapping[str, torch.Tensor]]) -> nn.Module:
    """Load a reference `SoftIntroVAE` checkpoint (a path or a state_dict)
    into the port model with `load_state_dict(strict=True)`, after dropping
    the orphan weights the model has no place for."""
    sd = source
    if isinstance(source, str):
        sd = torch.load(source, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
            sd = sd["model"]  # save_checkpoint format (my_trainer.py:135-143)
    keys = set(model.state_dict())
    sd = {k: torch.as_tensor(v) for k, v in sd.items() if not _is_orphan(k, keys)}
    model.load_state_dict(sd)
    return model
