"""Plain reference of the evaluation pass: posterior means, reconstructions
with the fixed eps 0.1 (reference models/models.py:263-271), per-volume
RMSE / PSNR / SSIM (skimage's defaults: a 7-wide uniform window, K1 0.01,
K2 0.03, sample covariance, the (7 - 1) / 2 border cropped) and the
precision@k of cosine neighbours. Everything in eval mode: BatchNorm by
its running statistics, no dropout.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.model import Precision, Run


@torch.no_grad()
def encode_mu(model, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(B, 1, D, H, W) -> (B, latent_dim) posterior means."""
    mu, _ = model.encode(x, Run(train=False, prec=prec))
    return mu.reshape(mu.shape[0], -1).float()


@torch.no_grad()
def reconstruct(model, x: torch.Tensor, prec: Precision, val_eps: float = 0.1) -> torch.Tensor:
    run = Run(train=False, prec=prec)
    mu, logvar = model.encode(x, run)
    return model.decode(mu + val_eps * torch.exp(0.5 * logvar), run)


def _uniform_mean(x: torch.Tensor, win: int, dims: int) -> torch.Tensor:
    """Mean over every win^dims window ('valid'), x (N, *spatial)."""
    pool = F.avg_pool3d if dims == 3 else F.avg_pool2d
    # a bfloat16 pool sums in float32 and rounds once (so it runs on the CPU too)
    y = x[:, None] if x.dtype == torch.float64 else x[:, None].float()
    return pool(y, win, stride=1)[:, 0].to(x.dtype)


def ssim(a: torch.Tensor, b: torch.Tensor, dims: int, win: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """(N, *spatial) pairs in [0, 1] -> (N,) mean SSIM, in their dtype."""
    n = win ** dims
    cov = n / (n - 1.0)
    ux, uy = _uniform_mean(a, win, dims), _uniform_mean(b, win, dims)
    vx = cov * (_uniform_mean(a * a, win, dims) - ux * ux)
    vy = cov * (_uniform_mean(b * b, win, dims) - uy * uy)
    vxy = cov * (_uniform_mean(a * b, win, dims) - ux * uy)
    c1, c2 = k1 ** 2, k2 ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win - 1) // 2
    crop = (slice(None),) + tuple(slice(pad, m - pad) for m in s.shape[1:])
    return s[crop].reshape(s.shape[0], -1).mean(dim=1)


def volume_metrics(x: torch.Tensor, y: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(N, D, H, W) originals and reconstructions -> (N, 4): RMSE, PSNR
    (data range 1), 3-D SSIM, SSIM of the centre depth slice, computed in
    `dtype`."""
    x, y = x.to(dtype), y.to(dtype)
    mse = ((x - y) ** 2).reshape(x.shape[0], -1).mean(dim=1)
    mid = x.shape[1] // 2
    return torch.stack([mse.sqrt(), 10 * torch.log10(1.0 / mse.clamp_min(1e-12)),
                        ssim(x, y, 3), ssim(x[:, mid], y[:, mid], 2)], dim=1)


def precision_at_k(query_z: np.ndarray, query_labels: Sequence[int], db_z: np.ndarray,
                   db_labels: Sequence[int], k: int) -> float:
    """Share of each query's k nearest database latents (cosine, float64)
    that carry its label, averaged over the queries."""
    q = np.asarray(query_z, np.float64)
    d = np.asarray(db_z, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    nearest = np.argsort(-(q @ d.T), axis=1, kind="stable")[:, :k]
    hits = np.asarray(db_labels)[nearest] == np.asarray(query_labels)[:, None]
    return float(hits.mean())
