"""Latent-quality evaluation: batch encoding, the CN-vs-AD logistic AUC and
the 2D / 3D latent maps.

Port of `sivae_tpu/eval/latent_probe.py:20-157` (logistic1.ipynb: encode,
then an L1 LogisticRegression on the flattened latents, then PCA -> t-SNE /
UMAP scatters). scikit-learn, matplotlib and umap are imported inside the
functions that need them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from sivae_torch.eval.recon_quality import eval_mode
from sivae_torch.models.resnet_vae import depth_levels, reparameterize
from sivae_torch.parallel.distributed import spatial_ranks
from sivae_torch.parallel.mesh import gather_depth, volume_slab


@torch.no_grad()
def encode_dataset(
    model,
    voxels: Union[np.ndarray, torch.Tensor],
    batch_size: int = 16,
    representation: str = "mu",
    val_eps: float = 0.1,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """Encode (N, 1, D, H, W) volumes to (N, latent_dim) float32, in eval mode
    (the model's own mode is put back afterwards).

    representation:
      - "mu": posterior mean (deterministic; recommended for retrieval)
      - "z_val": mu + val_eps*std (the reference's fixed-eps eval reparam)
      - "z": sampled z like logistic1.ipynb cell 7 (needs `generator`)
    The tail batch is zero-padded to `batch_size`, as in the JAX package,
    so every batch has one shape; the padding rows are dropped.

    Under depth sharding (a `1 x P` grid, `parallel.mesh.make_mesh`) every
    spatial rank passes the whole volumes, encodes its depth slab
    (`volume_slab` at the model's `depth_levels`) and gets the whole latents
    back (`gather_depth`), as JAX's encode on a `volume_sharding` does
    (tests/test_spatial_sharding.py); a flat latent (the FC family) comes
    out of the encoder whole, with nothing to gather.
    """
    if representation not in ("mu", "z_val", "z"):
        raise ValueError(f"unknown representation {representation!r}")
    if representation == "z" and generator is None:
        raise ValueError("representation='z' draws noise: pass a torch.Generator")
    dev = next(model.parameters()).device
    vox = torch.as_tensor(voxels)
    n = vox.shape[0]
    out = []
    with eval_mode(model):
        for i in range(0, n, batch_size):
            chunk = vox[i:i + batch_size].to(dev, torch.float32)
            keep = chunk.shape[0]
            if keep < batch_size:
                pad = torch.zeros((batch_size - keep,) + tuple(chunk.shape[1:]), device=dev)
                chunk = torch.cat([chunk, pad])
            sharded = spatial_ranks() > 1
            if sharded:
                chunk = chunk[:, :, volume_slab(chunk.shape[2], levels=depth_levels(model.cfg))]
            mu, logvar = model.encode(chunk)
            if sharded and len(model.cfg.latent_shape) == 4:
                depth = model.cfg.latent_shape[1]
                mu = gather_depth(mu, depth)
                logvar = logvar if representation == "mu" else gather_depth(logvar, depth)
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


def latent_embedding(z: np.ndarray, method: str = "tsne", n_components: int = 2,
                     pca_dim: int = 50, seed: int = 0,
                     return_method: bool = False):
    """PCA(50) -> t-SNE/UMAP 2D or 3D map (logistic1.ipynb cells 17-24
    render both dimensionalities).

    umap is optional (not a dependency); when it does not import the
    function falls back to t-SNE, warns, and with return_method=True returns
    (embedding, method actually used) so callers can record which method
    produced the figure.
    """
    import warnings

    from sklearn.decomposition import PCA

    if n_components not in (2, 3):
        raise ValueError(f"n_components must be 2 or 3, got {n_components}")
    x = z
    if pca_dim and z.shape[1] > pca_dim and z.shape[0] > pca_dim:
        x = PCA(n_components=pca_dim, random_state=seed).fit_transform(z)
    if method == "umap":
        try:
            import umap  # type: ignore

            emb = umap.UMAP(n_components=n_components, random_state=seed).fit_transform(x)
            return (emb, "umap") if return_method else emb
        except ImportError:
            warnings.warn("umap-learn is not installed; falling back to "
                          "t-SNE for the latent embedding", stacklevel=2)
            method = "tsne"
    from sklearn.manifold import TSNE

    perplexity = min(30.0, max(2.0, x.shape[0] / 4.0 - 1.0))
    emb = TSNE(n_components=n_components, random_state=seed,
               perplexity=perplexity).fit_transform(x)
    return (emb, "tsne") if return_method else emb


def latent_2d_embedding(z: np.ndarray, method: str = "tsne",
                        pca_dim: int = 50, seed: int = 0) -> np.ndarray:
    """The 2D case of `latent_embedding`."""
    return latent_embedding(z, method=method, n_components=2, pca_dim=pca_dim, seed=seed)


def save_embedding_scatter(emb: np.ndarray, labels: np.ndarray, path: str,
                           class_names=None, title: str = "") -> None:
    """2D / 3D latent scatter coloured by class (logistic1 cells 17-24
    panels). Needs matplotlib."""
    import os

    from sivae_torch.utils.plots import _pyplot

    plt = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig = plt.figure(figsize=(7, 6))
    is3d = emb.shape[1] == 3
    ax = fig.add_subplot(111, projection="3d") if is3d else fig.add_subplot(111)
    for lab in np.unique(labels):
        pts = emb[labels == lab]
        name = class_names[int(lab)] if class_names is not None else str(lab)
        ax.scatter(*(pts[:, i] for i in range(emb.shape[1])), s=8, label=name)
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
