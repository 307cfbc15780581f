"""Plain reference of what the train pipeline hands the step: the seeded
epoch order, the on-device random affine augmentation (TorchIO's
RandomAffine as the z600 preset runs it, 600z_main.py:115-135) and the
preprocessing (clip to [0, 4 sigma], per-volume min-max; reference
utils/data_load.py:25-30).

The augmentation's draws for step `k` of epoch `e` come from a generator on
the device seeded with `seed * 100003 + e * steps_per_epoch + k`: seven
uniforms per volume of the global batch (apply, three angles, three
scales). The volume is resampled through R^-1 S^-1 about its centre,
trilinear with zero fill, here by gathering the eight neighbours of each
source point.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SCALE_JITTER = 0.1


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    return order


def batch_rows(n: int, batch: int, seed: int, epoch: int, step: int) -> np.ndarray:
    """The volumes of global batch `step` of epoch `epoch`."""
    return epoch_order(n, seed, epoch)[step * batch:(step + 1) * batch]


def rotation(angles: torch.Tensor) -> torch.Tensor:
    """Rz @ Ry @ Rx of angles (B, 3), as (B, 3, 3)."""
    out = []
    for a in angles.double().tolist():
        cx, cy, cz = (math.cos(v) for v in a)
        sx, sy, sz = (math.sin(v) for v in a)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        out.append(rz @ ry @ rx)
    return torch.tensor(np.stack(out))


def trilinear(vol: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """vol (D, H, W) resampled at inv @ (x - c) + c for every index x,
    trilinear, neighbours outside the volume read as 0."""
    d, h, w = vol.shape
    dev = vol.device
    size = torch.tensor([d, h, w], dtype=torch.float64, device=dev)
    c = (size - 1) / 2
    idx = torch.stack(torch.meshgrid(*(torch.arange(n, dtype=torch.float64, device=dev)
                                       for n in (d, h, w)), indexing="ij"), dim=-1)
    src = (idx.reshape(-1, 3) - c) @ inv.to(dev, torch.float64).T + c
    base = torch.floor(src)
    frac = src - base
    base = base.long()
    flat = vol.reshape(-1).double()
    out = torch.zeros(src.shape[0], dtype=torch.float64, device=dev)
    for corner in range(8):
        off = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1], device=dev)
        pt = base + off
        wgt = torch.where(off.bool(), frac, 1 - frac).prod(dim=1)
        inside = ((pt >= 0) & (pt < size.long())).all(dim=1)
        pt = torch.minimum(pt.clamp_min(0), size.long() - 1)
        lin = (pt[:, 0] * h + pt[:, 1]) * w + pt[:, 2]
        out += torch.where(inside, wgt * flat[lin], torch.zeros_like(wgt))
    return out.reshape(d, h, w).float()


def random_affine(raw: torch.Tensor, gen_seed: int, degrees: float, p: float,
                  world: int = 1, rank: int = 0) -> torch.Tensor:
    """raw (B, D, H, W), this rank's rows of a global batch of B * world."""
    b = raw.shape[0]
    gen = torch.Generator(device=raw.device).manual_seed(gen_seed)
    u = torch.rand((b * world, 7), generator=gen, device=raw.device, dtype=torch.float32)
    u = u[rank * b:(rank + 1) * b].cpu()
    angles = (2 * u[:, 1:4] - 1) * (degrees * math.pi / 180.0)
    scales = 1.0 + (2 * u[:, 4:7] - 1) * SCALE_JITTER
    rot = rotation(angles)
    out = []
    for i in range(b):
        if u[i, 0] < p:
            inv = rot[i].T / scales[i].double()[None, :]
            out.append(trilinear(raw[i].float(), inv))
        else:
            out.append(raw[i].float())
    return torch.stack(out)


def preprocess(raw: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W) -> (B, 1, D, H, W) in [0, 1]: clip to [0, 4 std] and
    min-max normalise each volume, in float64, rounded once to float32."""
    v = raw.double().reshape(raw.shape[0], -1)
    cut = 4.0 * v.std(dim=1, correction=0)
    v = torch.minimum(v.clamp_min(0.0), cut[:, None])
    lo, hi = v.amin(dim=1, keepdim=True), v.amax(dim=1, keepdim=True)
    return ((v - lo) / (hi - lo)).float().reshape(raw.shape)[:, None]
