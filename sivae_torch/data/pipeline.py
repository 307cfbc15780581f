"""Host data plumbing: the patient-grouped split and the record arrays.

Port of `sivae_tpu/data/pipeline.py:28-59`. The split is the reference's
scikit-learn StratifiedGroupKFold (main.py:84-98): fold 4 of 5, grouped by
pid so no patient spans train/val. The prefetching batch pipeline comes
with training.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def grouped_split(
    labels: Sequence[int],
    groups: Sequence[str],
    n_splits: int = 5,
    split_index: int = 4,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """StratifiedGroupKFold split (reference main.py:84-98) -> (train_idx, val_idx)."""
    from sklearn.model_selection import StratifiedGroupKFold

    sgkf = StratifiedGroupKFold(n_splits=n_splits, shuffle=True, random_state=seed)
    splits = list(sgkf.split(np.zeros(len(labels)), labels, groups))
    return splits[split_index]


class BrainDataSource:
    """Records -> contiguous (voxels, labels) arrays."""

    def __init__(self, records: Sequence[dict]):
        self.voxels = np.stack([r["voxel"] for r in records]).astype(np.float32)
        self.labels = np.asarray([r["nu_label"] for r in records], np.int32)
        self.pids = [r["pid"] for r in records]

    def __len__(self) -> int:
        return len(self.labels)
