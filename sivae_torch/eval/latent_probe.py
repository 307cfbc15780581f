"""Latent-quality evaluation: batch encoding and the CN-vs-AD logistic AUC.

Port of `sivae_tpu/eval/latent_probe.py:20-85` (logistic1.ipynb: encode,
then an L1 LogisticRegression on the flattened latents). The t-SNE/UMAP
embedding comes later.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from sivae_torch.models.resnet_vae import reparameterize


@torch.no_grad()
def encode_dataset(
    model,
    voxels: Union[np.ndarray, torch.Tensor],
    batch_size: int = 16,
    representation: str = "mu",
    val_eps: float = 0.1,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """Encode (N, 1, D, H, W) volumes to (N, latent_dim) float32, in eval mode.

    representation:
      - "mu": posterior mean (deterministic; recommended for retrieval)
      - "z_val": mu + val_eps*std (the reference's fixed-eps eval reparam)
      - "z": sampled z like logistic1.ipynb cell 7 (needs `generator`)
    The tail batch is zero-padded to `batch_size`, as in the JAX package,
    so every batch has one shape; the padding rows are dropped.
    """
    if representation not in ("mu", "z_val", "z"):
        raise ValueError(f"unknown representation {representation!r}")
    if representation == "z" and generator is None:
        raise ValueError("representation='z' draws noise: pass a torch.Generator")
    dev = next(model.parameters()).device
    vox = torch.as_tensor(voxels)
    n = vox.shape[0]
    out = []
    for i in range(0, n, batch_size):
        chunk = vox[i:i + batch_size].to(dev, torch.float32)
        keep = chunk.shape[0]
        if keep < batch_size:
            pad = torch.zeros((batch_size - keep,) + tuple(chunk.shape[1:]), device=dev)
            chunk = torch.cat([chunk, pad])
        mu, logvar = model.encode(chunk)
        if representation == "mu":
            z = mu.float()
        elif representation == "z_val":
            z = reparameterize(mu, logvar, val_eps=val_eps)
        else:
            z = reparameterize(mu, logvar, generator=generator)
        out.append(z.reshape(z.shape[0], -1)[:keep])
    return torch.cat(out).cpu().numpy()


def logistic_auc(
    train_z: np.ndarray,
    train_y: np.ndarray,
    val_z: np.ndarray,
    val_y: np.ndarray,
) -> Tuple[float, float]:
    """L1 LogisticRegression CN-vs-AD probe (logistic1.ipynb cells 9-13).

    Returns (train_auc, val_auc).
    """
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import roc_auc_score

    try:  # sklearn >= 1.8 spells L1 as l1_ratio=1
        clf = LogisticRegression(l1_ratio=1.0, solver="liblinear", max_iter=1000)
        clf.fit(train_z, train_y)
    except (TypeError, ValueError):
        clf = LogisticRegression(penalty="l1", solver="liblinear", max_iter=1000)
        clf.fit(train_z, train_y)
    train_auc = roc_auc_score(train_y, clf.predict_proba(train_z)[:, 1])
    val_auc = roc_auc_score(val_y, clf.predict_proba(val_z)[:, 1])
    return float(train_auc), float(val_auc)
