"""Image quality metrics: RMSE, PSNR, SSIM (2D slices and 3D volumes).

Port of `sivae_tpu/ops/metrics.py:19-93`. SSIM follows skimage's defaults
(7-wide uniform window, K1=0.01, K2=0.03, sample covariance N/(N-1)), with
the uniform mean taken as a separable cumulative-sum filter so it runs on
the device over whole volumes. All metrics compute in fp32.

`batch_rmse`, `batch_psnr` and `batch_ssim` take a leading batch axis and
return one value per sample, with the per-image arithmetic (the filter runs
over the spatial axes only), so a batch costs a few launches and not a few
per sample.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def _mse(a: torch.Tensor, b: torch.Tensor, dims) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2, dim=dims)


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_mse(a, b, None))


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(_mse(a, b, None), min=1e-12))


def _sample_dims(x: torch.Tensor) -> tuple:
    return tuple(range(1, x.dim()))


def batch_rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, ...) pairs -> (B,) RMSE of each."""
    return torch.sqrt(_mse(a, b, _sample_dims(a)))


def batch_psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """(B, ...) pairs -> (B,) PSNR of each."""
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(_mse(a, b, _sample_dims(a)),
                                                           min=1e-12))


def _separable_mean(x: torch.Tensor, win: int, axes: Sequence[int]) -> torch.Tensor:
    """Separable uniform mean filter over `axes` via cumulative sums ('valid'
    output)."""
    out = x
    for axis in axes:
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


def _ssim_map(a: torch.Tensor, b: torch.Tensor, axes: Sequence[int], data_range: float,
              win_size: int, k1: float, k2: float) -> torch.Tensor:
    """The SSIM map over the image axes `axes`, cropped as skimage crops it."""
    a, b = a.float(), b.float()
    npts = win_size ** len(axes)
    cov_norm = npts / (npts - 1.0)

    ux = _separable_mean(a, win_size, axes)
    uy = _separable_mean(b, win_size, axes)
    uxx = _separable_mean(a * a, win_size, axes)
    uyy = _separable_mean(b * b, win_size, axes)
    uxy = _separable_mean(a * b, win_size, axes)
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
    if all(s.shape[ax] > 2 * pad for ax in axes):
        s = s[tuple(slice(pad, n - pad) if ax in axes else slice(None)
                    for ax, n in enumerate(s.shape))]
    return s


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over an N-d image pair (skimage-default semantics)."""
    return torch.mean(_ssim_map(a, b, tuple(range(a.dim())), data_range, win_size, k1, k2))


def batch_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, win_size: int = 7,
               k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """(B, ...) image pairs -> (B,) mean SSIM of each, as `ssim` takes it."""
    axes = _sample_dims(a)
    return torch.mean(_ssim_map(a, b, axes, data_range, win_size, k1, k2), dim=axes)


def batch_ssim_center_slice(x: Union[np.ndarray, torch.Tensor], y: Union[np.ndarray, torch.Tensor],
                            data_range: float = 1.0) -> np.ndarray:
    """Per-sample SSIM of the axial center slice (the reference panels use
    slice [50] of the (H, W, D)-transposed volume, my_trainer.py:100-110).
    Volumes NCDHW with one channel, or (N, D, H, W)."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    if x.dim() == 5:
        x, y = x[:, 0], y[:, 0]
    mid = x.shape[1] // 2
    return batch_ssim(x[:, mid], y[:, mid], data_range).cpu().numpy()
