"""Classifier evaluation: prediction loop and confusion matrix with its
heatmap.

Port of `sivae_tpu/eval/confusion.py` (reference utils/confusion.py:
`testing` :10-29, `make_confusion_matrix` :32-45). The matrix is counted
with numpy (as scikit-learn's `confusion_matrix` with `labels=` counts it),
so it needs neither scikit-learn nor matplotlib; the heatmap PNG is drawn
where matplotlib imports (`utils/plots.py`).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from sivae_torch.utils.plots import _pyplot, matplotlib_missing


def predict_all(eval_step, state, pipeline) -> Tuple[np.ndarray, np.ndarray, float]:
    """Run the classifier eval step over one pass of a pipeline; the
    predictions stay on the device until the end. Returns (predictions,
    labels, accuracy)."""
    preds, labs = [], []
    for vox, lab in pipeline.epoch(0):
        _, p = eval_step(state, vox, lab)
        preds.append(p)
        labs.append(np.asarray(lab))
    preds_c = torch.cat(preds).cpu().numpy()
    labs_c = np.concatenate(labs)
    return preds_c, labs_c, float((preds_c == labs_c).mean())


def _confusion_counts(preds: Sequence[int], labels: Sequence[int],
                      classes: Sequence[int]) -> np.ndarray:
    """cm[i, j] = how many of true class classes[i] were predicted
    classes[j]; pairs with a class outside `classes` are not counted."""
    index = {c: i for i, c in enumerate(classes)}
    cm = np.zeros((len(classes), len(classes)), np.int64)
    for t, p in zip(np.asarray(labels).tolist(), np.asarray(preds).tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def make_confusion_matrix(
    preds: Sequence[int],
    labels: Sequence[int],
    class_map: Dict[str, int],
    path: str,
) -> np.ndarray:
    """The confusion matrix over the classes of `class_map` (name -> index),
    and its heatmap at `path` where matplotlib imports (reference
    confusion.py:32-45)."""
    names = [k for k, _ in sorted(class_map.items(), key=lambda kv: kv[1])]
    cm = _confusion_counts(preds, labels, sorted(set(class_map.values())))
    if matplotlib_missing() is not None:
        return cm
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(1.2 * len(names) + 2, 1.0 * len(names) + 2))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(names)), names, rotation=45, ha="right")
    ax.set_yticks(range(len(names)), names)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="black" if cm[i, j] < cm.max() / 2 else "white")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.colorbar(im)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return cm
