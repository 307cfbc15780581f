"""Checkpoint-sweep evaluation: reconstruction quality across epochs, and
the run-health criterion.

Port of `sivae_tpu/eval/sweep.py:19-156` (testshow.ipynb cells 18-22: the
reference loads each epoch's .pth and renders panels to eyeball
convergence). The sweep walks the port's checkpoint directory
(`utils/checkpoint.py`) and / or reference .pth files and returns each
one's RMSE / PSNR / SSIM over the given volumes, optionally writing each
one's original / reconstruction panel; `run_health` applies the frozen r4
criterion to the rows.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from sivae_torch.eval.recon_quality import reconstruction_report
from sivae_torch.utils.checkpoint import CheckpointManager
from sivae_torch.utils.jax_import import load_reference_pth


def sweep_checkpoints(
    model,
    voxels,
    ckpt_dir: Optional[str] = None,
    torch_paths: Sequence[str] = (),
    batch_size: int = 8,
    panel_dir: Optional[str] = None,
) -> List[Dict[str, float]]:
    """Evaluate every checkpoint, oldest first, then every .pth in order;
    returns [{'rmse', 'psnr', 'ssim3d', 'ssim_center_slice', 'n',
    'checkpoint'}]. Each checkpoint's weights are loaded into `model` (its
    own weights are overwritten), which is left with the last one; the
    reports run in eval mode and leave the model's mode as it was.
    `voxels` (N, 1, D, H, W) preprocessed. With `panel_dir`, each
    checkpoint's first-batch panel is written to `recon_<tag>.jpg` there
    (needs matplotlib)."""
    paths = []
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        paths += [(str(step), mgr.path(step)) for step in mgr.all_steps()]
    paths += [(os.path.basename(p), p) for p in torch_paths]
    results: List[Dict[str, float]] = []
    for tag, path in paths:
        # a port checkpoint keeps the model under "model", in the
        # reference .pth layout, which load_reference_pth reads
        load_reference_pth(model, path)
        panel = os.path.join(panel_dir, f"recon_{tag}.jpg") if panel_dir else None
        rep = reconstruction_report(model, voxels, batch_size=batch_size, panel_path=panel)
        rep["checkpoint"] = tag
        results.append(rep)
    return results


def select_best_checkpoint(sweep: Sequence[Dict[str, float]],
                           metric: str = "rmse",
                           minimize: bool = True) -> Dict[str, float]:
    """Best sweep row by val metric — the committed answer to "which epoch
    do I deploy": the reference eyeballs testshow panels; here best-epoch
    selection is a function of the sweep."""
    if not sweep:
        raise ValueError("empty sweep")
    key = (lambda r: r[metric]) if minimize else (lambda r: -r[metric])
    return min(sweep, key=key)


def run_health(sweep: Sequence[Dict[str, float]],
               drift_frac: float = 0.3,
               min_ssim3d: float = 0.2) -> Dict[str, object]:
    """Quantified long-run health criterion (VERDICT r3 weak-#5 / next-#8).

    Soft-IntroVAE's adversarial phase is EXPECTED to drift val RMSE up
    slowly after the best epoch (the decoder keeps sharpening fakes — same
    dynamics family as the reference's long runs); what must NOT happen is
    collapse. The bound is scale-free (an absolute RMSE margin would mean
    different things on differently normalized data): the run must RETAIN
    at least (1 - drift_frac) of its total val-RMSE improvement at every
    post-best checkpoint. The committed criterion:

      1. converged: best-epoch val RMSE improves on the first checkpoint;
      2. quality: best ssim3d >= `min_ssim3d`;
      3. bounded drift: for every post-best checkpoint t,
         rmse_t <= best + drift_frac * (first - best) — i.e. the model
         never gives back more than `drift_frac` of what it learned.

    Calibration (150-epoch flagship run, runs_e2e/z1200_synth_r3): best
    epoch 68 RMSE 0.0672 (first 0.366, improvement 0.299); the slow
    adversarial drift reaches +0.0715 by epoch 148 = 24% of the
    improvement given back, ssim3d still 0.275. drift_frac=0.3 passes that
    healthy run with modest margin; a decoder collapse (giving back >30%)
    fails. Returns {"healthy": bool, ...evidence...}.
    """
    best = select_best_checkpoint(sweep, "rmse")
    rows = list(sweep)
    best_i = rows.index(best)
    post = rows[best_i + 1:]
    max_drift = max((r["rmse"] - best["rmse"] for r in post), default=0.0)
    improvement = rows[0]["rmse"] - best["rmse"]
    converged = improvement > 0
    quality_ok = best.get("ssim3d", 1.0) >= min_ssim3d
    bounded = max_drift <= drift_frac * max(improvement, 0.0)
    return {
        "healthy": bool(converged and quality_ok and bounded),
        "converged": bool(converged),
        "quality_ok": bool(quality_ok),
        "drift_bounded": bool(bounded),
        "best_checkpoint": best["checkpoint"],
        "best_rmse": float(best["rmse"]),
        "best_ssim3d": float(best.get("ssim3d", float("nan"))),
        "first_rmse": float(rows[0]["rmse"]),
        "final_rmse": float(rows[-1]["rmse"]),
        "max_post_best_rmse_drift": float(max_drift),
        "improvement": float(improvement),
        "drift_given_back_frac": float(max_drift / improvement
                                       if improvement > 0 else float("inf")),
        # Informational (NOT gated): final/best RMSE ratio. Stable across
        # the two observed seeds (1.9-2.1) where drift_given_back_frac is
        # not (0.24 vs 1.82) — the improvement denominator collapses when
        # a run converges before its first checkpoint (seed-1234 run,
        # docs/STATUS.md round-5 health-criterion note). Candidate gate
        # statistic for a future >=3-seed recalibration.
        "final_best_ratio": float(rows[-1]["rmse"] / best["rmse"]
                                  if best["rmse"] > 0 else float("inf")),
        "criterion": {"drift_frac": drift_frac, "min_ssim3d": min_ssim3d},
    }
