"""Synthetic 3D "brain" volumes for tests and benchmarks.

A numpy copy of `sivae_tpu/data/synthetic.py`: the same seed gives
bit-identical volumes and labels, so port runs and JAX runs see the same
data. Brain-like structure: a bright ellipsoidal mass, internal low-intensity
"ventricles", a smooth intensity field and Rician-ish noise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_brain_batch(
    n: int,
    shape: Tuple[int, int, int] = (80, 96, 80),
    seed: int = 0,
    labels: bool = True,
):
    """Returns (voxels [n, D, H, W] float32 raw-intensity, labels [n] int32).

    Class 0/1 differ by ventricle size (a crude CN-vs-AD atrophy analogue) so
    latent-separability eval code has signal to find.
    """
    rng = np.random.RandomState(seed)
    d, h, w = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, d), np.linspace(-1, 1, h), np.linspace(-1, 1, w),
        indexing="ij",
    )
    vox = np.empty((n,) + shape, np.float32)
    labs = rng.randint(0, 2, size=n).astype(np.int32)
    for i in range(n):
        cx, cy, cz = rng.uniform(-0.08, 0.08, 3)
        rx, ry, rz = rng.uniform(0.55, 0.7), rng.uniform(0.7, 0.85), rng.uniform(0.55, 0.7)
        r2 = ((zz - cz) / rx) ** 2 + ((yy - cy) / ry) ** 2 + ((xx - cx) / rz) ** 2
        brain = np.clip(1.0 - r2, 0.0, None)
        # ventricles: central dark cavity, larger for label 1
        vent_scale = 0.12 + 0.10 * labs[i] + rng.uniform(0, 0.03)
        v2 = ((zz - cz) / vent_scale) ** 2 + ((yy - cy) / (1.8 * vent_scale)) ** 2 + (
            (xx - cx) / vent_scale) ** 2
        vent = np.exp(-v2)
        tissue = brain * (1.0 - 0.8 * vent)
        # smooth intensity inhomogeneity field
        g = rng.randn(4, 4, 4).astype(np.float32)
        gz = np.kron(g, np.ones((d // 4 + 1, h // 4 + 1, w // 4 + 1), np.float32))
        gz = gz[:d, :h, :w]
        tissue = tissue * (1.0 + 0.15 * gz / (np.abs(gz).max() + 1e-6))
        noise = np.abs(rng.randn(*shape).astype(np.float32)) * 0.02
        vox[i] = 255.0 * np.clip(tissue, 0, None) + 255.0 * noise
    return vox, labs


class SyntheticBrainSource:
    """Iterable source with the same record schema as the real catalog."""

    def __init__(self, n: int, shape=(80, 96, 80), seed: int = 0):
        voxels, labs = synthetic_brain_batch(n, shape, seed)
        self.records = [
            {"uid": i, "pid": f"synt{i % max(1, n // 2):04d}", "label": "CN" if l == 0 else "AD",
             "nu_label": int(l), "path": None, "voxel": voxels[i]}
            for i, l in enumerate(labs)
        ]

    def __len__(self):
        return len(self.records)

    def __iter__(self):
        return iter(self.records)
