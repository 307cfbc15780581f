"""The benchmark's weights: one state dict, in the reference checkpoints'
keys, made on the device from the seed in one normal draw, loaded into the
program's model and into the reference alike.

- conv weights He-normal (std sqrt(2 / fan_in)), Linear weights
  LeCun-normal (std sqrt(1 / fan_in)); conv and Linear biases 0; the
  configuration's zero-initialised logvar head 0;
- BatchNorm as a trained checkpoint holds it, so that evaluation's running
  statistics matter: weight 1 + 0.1 n, bias 0.05 n, running mean 0.05 n,
  running variance exp(0.3 n).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench.reference.model import fan_in, leaf_kind

SALT = 0x5EED_BE7C  # keeps the weights' draw apart from the volumes'


def benchmark_state(ref_model, seed: int, device) -> Dict[str, torch.Tensor]:
    entries = list(ref_model.state_dict().items())
    drawn = [(k, t) for k, t in entries if leaf_kind(ref_model, k) != "count"]
    total = sum(t.numel() for _, t in drawn)
    g = torch.Generator(device=device).manual_seed((seed ^ SALT) % (1 << 63))
    normal = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for key, t in entries:
        kind = leaf_kind(ref_model, key)
        if kind == "count":
            out[key] = torch.zeros((), dtype=torch.long, device=device)
            continue
        n = normal[off:off + t.numel()].view(t.shape)
        off += t.numel()
        if kind == "conv":
            v = n * math.sqrt(2.0 / fan_in(t.shape))
        elif kind == "linear":
            v = n * math.sqrt(1.0 / fan_in(t.shape))
        elif kind == "bias":
            v = torch.zeros_like(n)
        elif kind == "bn_weight":
            v = 1.0 + 0.1 * n
        elif kind in ("bn_bias", "running_mean"):
            v = 0.05 * n
        else:  # running_var
            v = torch.exp(0.3 * n)
        out[key] = v.clone()
    for spec in ref_model.zero_init:
        key, _, part = spec.partition(":")
        if part == "rows_second_half":
            out[key][out[key].shape[0] // 2:] = 0.0
        else:
            out[key].zero_()
    return out
