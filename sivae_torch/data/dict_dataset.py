"""Dict-style dataset view over catalog records.

Port of `sivae_tpu/data/dict_dataset.py:27-70`. The reference exposes
`utils/data_class.py:BrainData` (:63-92): a torch Dataset over
`load_data()` records whose samples are dicts {"voxel": (1, D, H, W)
tensor, "label": int}; its consumers are the smoke script and the recon
viewer (test.py, testshow.ipynb). Here the samples are plain numpy,
channel-first (1, D, H, W): the reference's layout and the port models'
NCDHW one. The view is indexable, sliceable and iterable, and `as_arrays()`
stacks it into batch arrays.

Documented deviation (the JAX package's too): the reference constructor
loops `for sample in data: sample = transform(sample)`, rebinding the loop
variable, so its transform is silently a no-op (data_class.py:76-78). Here
`transform` applies, lazily at access time, to the (D, H, W) volume.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from sivae_torch.data.catalog import CLASS_MAP


class BrainData:
    """Dict-sample dataset: BrainData(load_data(...))[i] ->
    {"voxel": float32 (1, D, H, W), "label": int, "uid": ..., "pid": ...}.
    """

    def __init__(
        self,
        records: Sequence[dict],
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        class_map: Dict[str, int] = CLASS_MAP,
    ):
        self.records = list(records)
        self.transform = transform
        self.class_map = class_map

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        rec = self.records[idx]
        voxel = np.asarray(rec["voxel"], np.float32)
        if self.transform is not None:
            voxel = np.asarray(self.transform(voxel), np.float32)
        if voxel.ndim == 3:  # channel-first, the port's model layout
            voxel = voxel[None]
        return {"voxel": voxel, "label": self.class_map[rec["label"]],
                "uid": rec.get("uid"), "pid": rec.get("pid")}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def labels(self) -> np.ndarray:
        return np.asarray([self.class_map[r["label"]] for r in self.records], np.int32)

    def as_arrays(self):
        """(voxels (N, 1, D, H, W) float32, labels (N,) int32): the models'
        NCDHW batch form (`voxels[:, 0]` is what `preprocess_batch` takes)."""
        samples = [self[i] for i in range(len(self))]
        return (np.stack([s["voxel"] for s in samples]),
                np.asarray([s["label"] for s in samples], np.int32))
