"""On-device 3-D augmentation: random affine (rotation + scale) and noise.

Port of `sivae_tpu/data/augment.py:23-120`. The reference augments each item
on the host with TorchIO inside its DataLoader workers:
- RandomAffine(degrees=15) in a OneOf with p=0.6 (600z_main.py:115-135)
- RandomAffine(degrees=10) in a OneOf with p=0.35 (aug-z-1200main.py:106-119)
- RandomNoise(mean=0.03, std=0.03) with p=0.5 (vae_main.py:130-139)

Here the whole batch is resampled on its device: angles U(-deg, +deg) per
axis, scales 1 + U(-0.1, +0.1) per axis (TorchIO's default), rotation and
scaling about the volume centre, trilinear, zero fill.

The draws come from a `torch.Generator` on the batch's device, which the
pipeline seeds per (seed, epoch, step) with the JAX package's formula, so a
run is deterministic in the same way as the JAX one; the draws themselves
differ from `jax.random`'s. Under data parallelism the batch is this rank's
rows of a global batch: every draw is taken for the global batch and the
rank's rows kept (`parallel.mesh.rand_rows` / `normal_rows`), so each
volume gets the draw it gets in one process.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sivae_torch.parallel.mesh import normal_rows, rand_rows

SCALE_JITTER = 0.1   # TorchIO RandomAffine's default scales=0.1


def _rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """R = Rz @ Ry @ Rx for angles (..., 3) in radians about the 3 axes;
    returns (..., 3, 3)."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    cx, cy, cz, sx, sy, sz = c[..., 0], c[..., 1], c[..., 2], s[..., 0], s[..., 1], s[..., 2]
    rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return rz @ ry @ rx


def _affine_resample(vol: torch.Tensor, matrix: torch.Tensor,
                     translation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Resample vol (B, D, H, W) through the inverse affine `matrix` (B, 3, 3)
    or (3, 3), about the volume centre, trilinear, zero fill.

    `translation` (B, 3) or (3,) is the forward shift t in voxels:
    output(x) = input at matrix @ (x - center - t) + center, with x the
    (d, h, w) index, as `_affine_resample` in the JAX package (held against
    it and against scipy.ndimage.affine_transform in the tests).

    `F.grid_sample` takes the source points normalised to [-1, 1], with
    align_corners=True mapping -1 / +1 to index 0 / n - 1, and its grid's
    last axis in (x, y, z) = (w, h, d) order, the reverse of the matrix's.
    Points outside the volume read zeros for their missing neighbours.
    """
    b, d, h, w = vol.shape
    dev = vol.device
    size = torch.tensor([d, h, w], dtype=torch.float32, device=dev)
    center = (size - 1) / 2
    matrix = matrix.to(device=dev, dtype=torch.float32).expand(b, 3, 3)
    shift = center if translation is None else center + translation.to(dev, torch.float32)
    shift = shift.expand(b, 3)
    idx = torch.stack(torch.meshgrid(
        torch.arange(d, dtype=torch.float32, device=dev),
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij"), dim=-1)
    rel = idx.reshape(1, -1, 3) - shift[:, None, :]                 # (B, DHW, 3)
    src = rel @ matrix.transpose(1, 2) + center                     # (B, DHW, 3)
    grid = (2 * src / (size - 1) - 1).flip(-1).reshape(b, d, h, w, 3)
    out = F.grid_sample(vol[:, None].float(), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out[:, 0]


def random_affine_batch(generator: torch.Generator, voxels: torch.Tensor,
                        degrees: float = 15.0, p: float = 0.6) -> torch.Tensor:
    """Random affine per volume with probability p. voxels: (B, D, H, W) or
    (B, 1, D, H, W) on the generator's device; returns the same shape, float32."""
    squeeze = voxels.dim() == 5
    v = voxels[:, 0] if squeeze else voxels
    b = v.shape[0]
    # one draw for the batch: apply, 3 angles, 3 scales per volume
    u = rand_rows((b, 7), generator, v.device)
    angles = (2 * u[:, 1:4] - 1) * (degrees * torch.pi / 180.0)
    scales = 1.0 + (2 * u[:, 4:7] - 1) * SCALE_JITTER
    # inverse map, output -> input coordinates: R^-1 @ S^-1 (R orthonormal)
    inv = _rotation_matrix(angles).transpose(1, 2) / scales[:, None, :]
    out = torch.where((u[:, 0] < p)[:, None, None, None], _affine_resample(v, inv), v.float())
    return out[:, None] if squeeze else out


def random_noise_batch(generator: torch.Generator, voxels: torch.Tensor, mean: float = 0.03,
                       std: float = 0.03, p: float = 0.5) -> torch.Tensor:
    """Additive Gaussian noise per volume with probability p (TorchIO
    RandomNoise, vae_main.py:130-139)."""
    dev = voxels.device
    apply = rand_rows((voxels.shape[0],) + (1,) * (voxels.dim() - 1), generator, dev) < p
    noise = mean + std * normal_rows(voxels.shape, generator, dev)
    return torch.where(apply, voxels.float() + noise, voxels.float())
