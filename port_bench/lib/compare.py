"""The numbers that decide `correct`, each a gap between what the program's
timed path produced and what the plain reference works out from the same
inputs. A cell's limits live in `port_bench/limits/<cell>.json`; the
numbers it names there are the ones compared, the others are readings for
`calibrate.py`.

Leaves are compared by the norm of their difference: for each leaf
||program - reference|| over the larger of the reference's norm and the
median leaf's (some gradients are all but zero), so a gradient or an
update of the wrong direction reads about 1 (unmoved) to 2 (reversed)
whatever its size; the median leaf's gap is the number. A leaf whose first
gradient in the reference is under a thousandth of the median leaf's (a
conv bias ahead of a BatchNorm) has a gradient of round-off alone and
moves under Adam by round-off alone: it is left out of both.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

ZERO_GRADIENT = 1e-3   # of the median leaf's gradient norm


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              by_norms: bool = False) -> List[Tuple[float, str]]:
    """||prog - ref|| / max(||ref||, median ||ref||) of every leaf, the worst
    first; with `by_norms`, | ||prog|| - ||ref|| | in its place (blind to
    direction: a reading, not compared)."""
    ref_n = {k: _norm(v) for k, v in ref.items()}
    med = float(np.median(list(ref_n.values())))

    def gap(k):
        if by_norms:
            d = abs(_norm(prog[k]) - ref_n[k])
        else:
            d = _norm(prog[k].double() - ref[k].double())
        return d / max(ref_n[k], med, 1e-30)

    return sorted(((gap(k), k) for k in ref), reverse=True)


def _median(gaps: List[Tuple[float, str]]) -> float:
    return float(np.median([g for g, _ in gaps]))


def train_numbers(prog_batches: Sequence[torch.Tensor], prog_losses: Sequence[tuple],
                  prog_grads: Dict[str, torch.Tensor], prog_after: Dict[str, torch.Tensor],
                  ref_batches: Sequence[torch.Tensor], ref_losses: Sequence[tuple],
                  ref_grads: Dict[str, torch.Tensor], ref_after: Dict[str, torch.Tensor],
                  before: Dict[str, torch.Tensor], verbose: bool = True) -> Dict[str, float]:
    """batch_gap: the largest absolute difference of a batch's voxels (in
    [0, 1]); loss1_gap: the larger relative gap of the first step's lossE
    and lossD; loss_gap: the same over every step; grad_gap: the median
    leaf's gap of the first gradient; change_gap: the median leaf's gap of
    the change over the steps (parameters and running statistics);
    grad_norm_gap, change_norm_gap: the same by the gap of the norms.

    The worst leaves are printed, not compared: on sound bfloat16 runs they
    carry the round-off of single leaves (the gradient's component along a
    weight that BatchNorm makes the loss blind to) and read as high as the
    float8 control does (PERF.md)."""
    batch_gap = max(float((p.float() - r.float()).abs().max())
                    for p, r in zip(prog_batches, ref_batches))

    def rel(p, r):
        return abs(p - r) / max(abs(r), 1e-30)

    loss1_gap = max(rel(p, r) for p, r in zip(prog_losses[0], ref_losses[0]))
    loss_gap = max(rel(p, r) for ps, rs in zip(prog_losses, ref_losses) for p, r in zip(ps, rs))
    g_norms = {k: _norm(v) for k, v in ref_grads.items()}
    med = float(np.median(list(g_norms.values())))
    still = {k for k, v in g_norms.items() if v < ZERO_GRADIENT * med}
    g_ref = {k: v for k, v in ref_grads.items() if k not in still}
    g_prog = {k: prog_grads[k] for k in g_ref}
    moved = [k for k, v in before.items() if v.is_floating_point() and k not in still]
    c_ref = {k: ref_after[k].float() - before[k].float() for k in moved}
    c_prog = {k: prog_after[k].float() - before[k].float() for k in moved}
    grad, change = leaf_gaps(g_prog, g_ref), leaf_gaps(c_prog, c_ref)
    if verbose:
        print(f"port_bench: losses program {list(prog_losses)} reference {list(ref_losses)}; "
              f"worst gradient leaves {grad[:3]}, worst change leaves {change[:3]}; "
              f"{len(still)} leaves with no gradient left out", file=sys.stderr)
    return {"batch_gap": batch_gap, "loss1_gap": loss1_gap, "loss_gap": loss_gap,
            "grad_gap": _median(grad), "change_gap": _median(change),
            "grad_norm_gap": _median(leaf_gaps(g_prog, g_ref, by_norms=True)),
            "change_norm_gap": _median(leaf_gaps(c_prog, c_ref, by_norms=True))}


def cosine(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """(Q, Z), (N, Z) -> (Q, N) cosine similarities in float64."""
    q = np.asarray(q, np.float64)
    d = np.asarray(d, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    return q @ d.T


def knn_shortfall(prog_idx: np.ndarray, sim: np.ndarray) -> float:
    """The widest gap by which a neighbour the program chose lies below the
    k-th best of the reference's similarities `sim` (Q, N) for its query; 0
    where every chosen set is a top-k of the reference (ties either way).
    A set with a repeated or missing index reads 2, past any gap."""
    q, k = prog_idx.shape
    if ((prog_idx < 0) | (prog_idx >= sim.shape[1])).any() or \
            any(len(set(row)) < k for row in prog_idx.tolist()):
        return 2.0
    kth = -np.partition(-sim, k - 1, axis=1)[:, k - 1]
    chosen = np.take_along_axis(sim, prog_idx, axis=1).min(axis=1)
    return float(np.maximum(kth - chosen, 0.0).max())


def eval_numbers(prog_latents: np.ndarray, ref_latents: np.ndarray, prog_recon: np.ndarray,
                 ref_recon: np.ndarray, prog_report: Dict[str, float],
                 ref_report: Dict[str, float], prog_idx: np.ndarray, ref_sim: np.ndarray,
                 prog_p_at_k: float, ref_p_at_k: float) -> Dict[str, float]:
    """latent_gap and recon_gap: the largest absolute difference of a latent
    and of a reconstructed voxel over the reference's largest magnitude;
    report_gap: the program's report against the reference's arithmetic on
    the program's reconstructions (RMSE relative, PSNR as the relative gap
    of the mean squared error it stands for, |dB| ln 10 / 10, the SSIMs,
    in [-1, 1] and near 0 for a poor reconstruction, absolute); knn_gap:
    the program's nearest neighbours against the reference's similarities
    on its own latents (`knn_shortfall`); precision_gap: the program's
    precision@k against the reference's arithmetic on the program's
    latents."""
    def widest(p, r):
        r = np.asarray(r, np.float64)
        return float(np.abs(np.asarray(p, np.float64) - r).max() / max(np.abs(r).max(), 1e-30))

    def gap(k, v):
        d = abs(prog_report[k] - v)
        if k == "psnr":
            return d * math.log(10) / 10
        return d if k.startswith("ssim") else d / max(abs(v), 1e-30)

    report_gap = max(gap(k, v) for k, v in ref_report.items())
    print(f"port_bench: report program {prog_report} reference {ref_report}", file=sys.stderr)
    return {"latent_gap": widest(prog_latents, ref_latents),
            "recon_gap": widest(prog_recon, ref_recon), "report_gap": float(report_gap),
            "knn_gap": knn_shortfall(np.asarray(prog_idx), ref_sim),
            "precision_gap": abs(float(prog_p_at_k) - float(ref_p_at_k))}
