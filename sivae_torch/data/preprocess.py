"""Voxel preprocessing: clip to [0, 4*sigma], min-max normalize to [0, 1].

Port of `sivae_tpu/data/preprocess.py:21-46` (reference
utils/data_load.py:25-30), run on the tensor's device over a whole batch,
with per-volume statistics as the reference's per-item preprocessing.
"""

from __future__ import annotations

import numpy as np
import torch


def preprocess_voxel_np(voxel: np.ndarray) -> np.ndarray:
    """Host/numpy reference implementation (per volume, no channel axis)."""
    cut = 4.0 * np.std(voxel)
    v = np.clip(voxel, 0.0, cut)
    lo, hi = np.min(v), np.max(v)
    return ((v - lo) / (hi - lo)).astype(np.float32)


def preprocess_batch(voxels: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W) raw -> (B, 1, D, H, W) float32 in [0, 1]."""
    v32 = voxels.float()
    flat = v32.reshape(v32.shape[0], -1)
    cut = 4.0 * flat.std(dim=1, correction=0)
    v = torch.minimum(torch.clamp(flat, min=0.0), cut[:, None])
    lo = v.amin(dim=1, keepdim=True)
    hi = v.amax(dim=1, keepdim=True)
    return ((v - lo) / (hi - lo)).reshape(v32.shape)[:, None]
