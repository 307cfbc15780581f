"""Reconstruction-quality report: per-volume RMSE / PSNR / SSIM means.

Port of `sivae_tpu/eval/recon_quality.py` (testshow.ipynb): reconstruct a
set of volumes in eval mode (encode, fixed-eps reparameterization, decode)
and average per-volume fidelity. The metrics run on the device and the host
reads them once at the end. The image panel comes later.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from sivae_torch.models.resnet_vae import reparameterize
from sivae_torch.ops.metrics import psnr, rmse, ssim


@torch.no_grad()
def reconstruct(model, x: torch.Tensor, val_eps: float = 0.1) -> torch.Tensor:
    mu, logvar = model.encode(x)
    return model.decode(reparameterize(mu, logvar, val_eps=val_eps))


@torch.no_grad()
def reconstruction_report(
    model,
    voxels: Union[np.ndarray, torch.Tensor],
    batch_size: int = 8,
    val_eps: float = 0.1,
) -> Dict[str, float]:
    """(N, 1, D, H, W) volumes -> {'rmse', 'psnr', 'ssim3d',
    'ssim_center_slice', 'n'}. The tail batch is zero-padded to one shape
    and the padding is left out of the metrics."""
    dev = next(model.parameters()).device
    vox = torch.as_tensor(voxels)
    n = vox.shape[0]
    per_volume = []
    for i in range(0, n, batch_size):
        x = vox[i:i + batch_size].to(dev, torch.float32)
        keep = x.shape[0]
        if keep < batch_size:
            x = torch.cat([x, torch.zeros((batch_size - keep,) + tuple(x.shape[1:]), device=dev)])
        y = reconstruct(model, x, val_eps).float()
        for j in range(keep):
            a, b = x[j, 0], y[j, 0]
            mid = a.shape[0] // 2
            per_volume.append(torch.stack([rmse(a, b), psnr(a, b), ssim(a, b),
                                           ssim(a[mid], b[mid])]))
    means = torch.stack(per_volume).mean(dim=0).tolist()
    return {"rmse": means[0], "psnr": means[1], "ssim3d": means[2],
            "ssim_center_slice": means[3], "n": len(per_volume)}
