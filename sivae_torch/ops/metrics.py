"""Image quality metrics: RMSE, PSNR, SSIM (2D slices and 3D volumes).

Port of `sivae_tpu/ops/metrics.py:19-93`. SSIM follows skimage's defaults
(7-wide uniform window, K1=0.01, K2=0.03, sample covariance N/(N-1)), with
the uniform mean taken as a separable cumulative-sum filter so it runs on
the device over whole volumes. All metrics compute in fp32.
"""

from __future__ import annotations

import torch


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((a.float() - b.float()) ** 2))


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _separable_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    """Separable uniform mean filter via cumulative sums ('valid' output)."""
    out = x
    for axis in range(x.dim()):
        n = out.shape[axis]
        if n < win:
            raise ValueError(f"window {win} larger than axis {axis} ({n})")
        c = torch.cumsum(out, dim=axis)
        zshape = list(c.shape)
        zshape[axis] = 1
        cpad = torch.cat([torch.zeros(zshape, dtype=c.dtype, device=c.device), c], dim=axis)
        hi = cpad.narrow(axis, win, n - win + 1)
        lo = cpad.narrow(axis, 0, n - win + 1)
        out = (hi - lo) / win
    return out


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over an N-d image pair (skimage-default semantics)."""
    a, b = a.float(), b.float()
    npts = win_size ** a.dim()
    cov_norm = npts / (npts - 1.0)

    ux = _separable_mean(a, win_size)
    uy = _separable_mean(b, win_size)
    uxx = _separable_mean(a * a, win_size)
    uyy = _separable_mean(b * b, win_size)
    uxy = _separable_mean(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)
    s = num / den
    # skimage crops (win_size-1)//2 off each side of the valid region
    pad = (win_size - 1) // 2
    if all(dim > 2 * pad for dim in s.shape):
        s = s[tuple(slice(pad, dim - pad) for dim in s.shape)]
    return torch.mean(s)
