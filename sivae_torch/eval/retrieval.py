"""CBIR retrieval: cosine-kNN over latent vectors, on the device.

Port of `sivae_tpu/eval/retrieval.py`: one (Q, Z) x (Z, N) product of
L2-normalized latents, then `torch.topk`. fp32 throughout (on CUDA the
entry points keep matrix products in full fp32).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]


def cosine_knn(queries: torch.Tensor, database: torch.Tensor, k: int = 10
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine neighbours. queries (Q, Z), database (N, Z) ->
    (scores (Q, k), indices (Q, k))."""
    q = queries.float()
    d = database.float()
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-12)
    return torch.topk(q @ d.t(), k, dim=1)


def retrieval_precision_at_k(
    query_z: ArrayLike,
    query_labels: ArrayLike,
    db_z: ArrayLike,
    db_labels: ArrayLike,
    k: int = 10,
    exclude_self: bool = False,
    device: Optional[torch.device] = None,
) -> float:
    """Mean fraction of the top-k neighbours sharing the query's label.

    k is clamped to the database size (minus the query itself when
    exclude_self). The kNN runs on `device` (default: where `db_z` lies)."""
    kk = k + 1 if exclude_self else k
    kk = min(kk, len(db_z))
    if kk <= (1 if exclude_self else 0):
        raise ValueError(f"database of {len(db_z)} latents is too small "
                         f"for retrieval (exclude_self={exclude_self})")
    db = torch.as_tensor(db_z)
    dev = device if device is not None else db.device
    _, idx = cosine_knn(torch.as_tensor(query_z).to(dev), db.to(dev), k=kk)
    idx = idx.cpu().numpy()
    if exclude_self:
        idx = idx[:, 1:]
    neighbour_labels = np.asarray(db_labels)[idx]
    hits = neighbour_labels == np.asarray(query_labels)[:, None]
    return float(hits.mean())
