"""The benchmark's inputs: synthetic brain volumes made on the device from
the run's seed (the recipe of `sivae_torch/data/synthetic.py`, in torch,
with one generator on the device): a bright ellipsoid with dark
"ventricles" larger for label 1, a smooth 4x4x4 intensity field and
half-normal noise, 255 x raw intensity. The labels and the grouping into
patients (two volumes each) come from the same seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

CHUNK = 32  # volumes made at once


def synthetic_volumes(n: int, shape: Tuple[int, int, int], seed: int,
                      device) -> Tuple[torch.Tensor, np.ndarray]:
    """(volumes (n, D, H, W) float32 on `device`, labels (n,) int32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    d, h, w = shape
    f32 = dict(device=device, dtype=torch.float32)
    labels = torch.randint(0, 2, (n,), generator=g, device=device)
    u = torch.rand((n, 7), generator=g, **f32)
    center = (2 * u[:, 0:3] - 1) * 0.08
    radii = torch.stack([0.55 + 0.15 * u[:, 3], 0.7 + 0.15 * u[:, 4], 0.55 + 0.15 * u[:, 5]], 1)
    vent = 0.12 + 0.10 * labels.float() + 0.03 * u[:, 6]
    field = torch.randn((n, 4, 4, 4), generator=g, **f32)
    zz, yy, xx = torch.meshgrid(torch.linspace(-1, 1, d, **f32), torch.linspace(-1, 1, h, **f32),
                                torch.linspace(-1, 1, w, **f32), indexing="ij")
    out = torch.empty((n, d, h, w), **f32)
    for i in range(0, n, CHUNK):
        j = min(n, i + CHUNK)

        def col(t, k):
            return t[i:j, k].view(-1, 1, 1, 1)

        cz, cy, cx = col(center, 0), col(center, 1), col(center, 2)
        r2 = ((zz - cz) / col(radii, 0)) ** 2 + ((yy - cy) / col(radii, 1)) ** 2 \
            + ((xx - cx) / col(radii, 2)) ** 2
        brain = (1.0 - r2).clamp_min(0.0)
        v = vent[i:j].view(-1, 1, 1, 1)
        v2 = ((zz - cz) / v) ** 2 + ((yy - cy) / (1.8 * v)) ** 2 + ((xx - cx) / v) ** 2
        tissue = brain * (1.0 - 0.8 * torch.exp(-v2))
        fz = field[i:j]
        for axis, size in zip((1, 2, 3), (d, h, w)):
            fz = fz.repeat_interleave(size // 4 + 1, dim=axis)
        fz = fz[:, :d, :h, :w]
        peak = fz.abs().amax(dim=(1, 2, 3), keepdim=True) + 1e-6
        tissue = tissue * (1.0 + 0.15 * fz / peak)
        noise = torch.randn((j - i, d, h, w), generator=g, **f32).abs() * 0.02
        out[i:j] = 255.0 * tissue.clamp_min(0.0) + 255.0 * noise
    return out, labels.to(torch.int32).cpu().numpy()


def patient_split(n: int, seed: int, held_out: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """(train indices, held-out indices): volumes 2p and 2p + 1 belong to
    patient p, and a seeded fifth of the patients is held out whole, so no
    patient spans both sides (the eval CLI's grouped split, which needs
    scikit-learn, makes the same kind of split)."""
    patients = n // 2
    perm = np.random.RandomState(seed % (1 << 32)).permutation(patients)
    out = np.zeros(n, bool)
    for p in perm[:int(round(patients * held_out))]:
        out[2 * p:2 * p + 2] = True
    return np.flatnonzero(~out), np.flatnonzero(out)
