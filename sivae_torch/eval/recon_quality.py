"""Reconstruction-quality report: per-volume RMSE / PSNR / SSIM means, and
the original / reconstruction panel.

Port of `sivae_tpu/eval/recon_quality.py` (testshow.ipynb): reconstruct a
set of volumes in eval mode (encode, fixed-eps reparameterization, decode)
and average per-volume fidelity. Each batch's metrics are a few batched
tensor ops on the device (`ops/metrics.py`), and the host reads the means
once at the end.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

import numpy as np
import torch

from sivae_torch.models.resnet_vae import reparameterize
from sivae_torch.ops.metrics import batch_psnr, batch_rmse, batch_ssim


@contextlib.contextmanager
def eval_mode(model):
    """`model` in eval mode for the block; the mode it came in is put back
    afterwards, so a model in training stays in training."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


@torch.no_grad()
def reconstruct(model, x: torch.Tensor, val_eps: float = 0.1) -> torch.Tensor:
    """Encode, fixed-eps reparameterize, decode, in eval mode."""
    with eval_mode(model):
        mu, logvar = model.encode(x)
        return model.decode(reparameterize(mu, logvar, val_eps=val_eps))


@torch.no_grad()
def reconstruction_report(
    model,
    voxels: Union[np.ndarray, torch.Tensor],
    batch_size: int = 8,
    val_eps: float = 0.1,
    panel_path: Optional[str] = None,
) -> Dict[str, float]:
    """(N, 1, D, H, W) volumes -> {'rmse', 'psnr', 'ssim3d',
    'ssim_center_slice', 'n'}, in eval mode. The tail batch is zero-padded to
    one shape and the padding is left out of the metrics. With `panel_path`,
    the first batch's original / reconstruction panel is written there
    (needs matplotlib)."""
    dev = next(model.parameters()).device
    vox = torch.as_tensor(voxels)
    n = vox.shape[0]
    per_volume = []
    first_batch = None
    for i in range(0, n, batch_size):
        x = vox[i:i + batch_size].to(dev, torch.float32)
        keep = x.shape[0]
        if keep < batch_size:
            x = torch.cat([x, torch.zeros((batch_size - keep,) + tuple(x.shape[1:]), device=dev)])
        y = reconstruct(model, x, val_eps).float()  # in eval mode
        a, b = x[:keep, 0], y[:keep, 0]
        if first_batch is None:
            first_batch = (a, b)
        mid = a.shape[1] // 2
        per_volume.append(torch.stack([batch_rmse(a, b), batch_psnr(a, b), batch_ssim(a, b),
                                       batch_ssim(a[:, mid], b[:, mid])], dim=1))
    if panel_path and first_batch is not None:
        from sivae_torch.utils.plots import save_recon_panel

        save_recon_panel(first_batch[0], first_batch[1], panel_path)
    metrics = torch.cat(per_volume)
    means = metrics.mean(dim=0).tolist()
    return {"rmse": means[0], "psnr": means[1], "ssim3d": means[2],
            "ssim_center_slice": means[3], "n": metrics.shape[0]}
