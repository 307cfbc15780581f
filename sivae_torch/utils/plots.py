"""Plot writers: loss curves, KL-statistic curves, reconstruction panels.

Port of `sivae_tpu/utils/plots.py:23-94` (reference utils/train_result.py:
result_S_IntroVAE :49-62, result_rec_kls_loss :65-78, result_ae :35-46, and
the original / reconstruction slice panels with RMSE + SSIM of
utils/my_trainer.py:92-127), with the SSIM of `sivae_torch.ops.metrics`.

matplotlib is imported inside the functions, so the package imports where
it is not installed; `matplotlib_missing` says whether it is, for callers
that skip the figures then (the CSV / JSONL / txt logs hold every curve, and
`tools/plot_run.py` draws them later).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from sivae_torch.ops.metrics import rmse, ssim


def matplotlib_missing() -> Optional[str]:
    """None when matplotlib imports, else why it does not."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        return str(e)
    return None


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_curves(history: Dict[str, List[float]], keys, path: str, name: str,
                 ylabel: Optional[str]) -> None:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for key in keys:
        if key in history:
            ax.plot(history[key], label=key)
    ax.set_xlabel("epoch")
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.legend()
    fig.savefig(os.path.join(path, name), dpi=100)
    plt.close(fig)


def plot_soft_intro_losses(history: Dict[str, List[float]], path: str) -> None:
    """4-curve trainE/valE/trainD/valD figure (train_result.py:49-62)."""
    _plot_curves(history, ("train_lossE", "val_lossE", "train_lossD", "val_lossD"), path,
                 "soft_intro_losses.png", "loss")


def plot_kl_stats(history: Dict[str, List[float]], path: str) -> None:
    """kls_real/fake/rec + rec_errs curves (train_result.py:65-78)."""
    _plot_curves(history, ("kls_real", "kls_fake", "kls_rec", "rec_errs"), path,
                 "kl_stats.png", None)


def plot_ae_losses(history: Dict[str, List[float]], path: str) -> None:
    _plot_curves(history, ("train_loss", "val_loss"), path, "ae_losses.png", "loss")


def save_recon_panel(
    originals,
    outputs,
    filename: str,
    n: int = 8,
    slice_axis_frac: float = 0.625,  # slice 50 of 80 in the reference
) -> None:
    """2xN panel: originals on top, reconstructions below, per-pair RMSE and
    SSIM annotated (my_trainer.py:92-127). Volumes are NCDHW with one channel,
    or (N, D, H, W); tensors or arrays."""
    originals = np.asarray(torch.as_tensor(originals).detach().float().cpu())
    outputs = np.asarray(torch.as_tensor(outputs).detach().float().cpu())
    if originals.ndim == 5:
        originals, outputs = originals[:, 0], outputs[:, 0]
    n = min(n, originals.shape[0])
    # reference view: volume.transpose(1,2,0)[50] then vertical flip
    # (my_trainer.py:100): slice 50/80 of the H axis after transpose
    k = min(int(originals.shape[2] * slice_axis_frac), originals.shape[2] - 1)
    plt = _pyplot()
    fig = plt.figure(figsize=(2.2 * n, 6))
    for i in range(n):
        img = np.ascontiguousarray(np.flip(originals[i].transpose(1, 2, 0)[k], 0))
        out = np.ascontiguousarray(np.flip(outputs[i].transpose(1, 2, 0)[k], 0))
        ax1 = fig.add_subplot(2, n, i + 1)
        ax1.set_title(f"original{i + 1}", fontsize=10)
        ax1.imshow(img, cmap="gray")
        ax1.axis("off")
        ax2 = fig.add_subplot(2, n, n + i + 1)
        a, b = torch.from_numpy(img), torch.from_numpy(out)
        r = float(rmse(a, b))
        s = float(ssim(a, b, data_range=max(1e-6, float(img.max() - img.min()))))
        ax2.set_title(f"rmse:{r:.3f} ssim:{s:.3f}", fontsize=9)
        ax2.imshow(out, cmap="gray")
        ax2.axis("off")
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    fig.savefig(filename, dpi=90)
    plt.close(fig)
