"""Evaluation CLI of the port: latent AUC, CBIR retrieval, reconstruction.

Port of `cli/eval.py`. Encodes the volumes in batches on the GPU, then
reports (same JSON keys as the JAX CLI):
- CN-vs-AD L1-logistic ROC-AUC on latents (`train_auc`, `val_auc`, when the
  split has enough of both classes)
- cosine-kNN retrieval precision@k (`retrieval_p_at_k`)
- reconstruction `rmse`, `psnr`, `ssim3d`, `ssim_center_slice`, `n` over the
  validation split

Usage:
  python -m sivae_torch.cli.eval --model spatial_1200 --synthetic 64 [--bf16]
  python -m sivae_torch.cli.eval --model spatial_1200 --synthetic 64 --ckpt epoch819.pth
  python -m sivae_torch.cli.eval --model spatial_1200 --ckpt runs/z1200/ckpt \
      --data-root /data/radiology_datas
  python -m sivae_torch.cli.eval --model tiny_spatial --synthetic 12 --device cpu
  python -m sivae_torch.cli.eval --model fc_150 --ckpt runs/z600/ckpt --synthetic 64

`--model` takes every model of the registry, spatial or FC (an FC latent is
its z_ch-vector, a spatial one its flattened map).

Runs on CUDA unless `--device cpu` is given, and fails without CUDA
otherwise. Weights come from `--ckpt`: a reference `.pth`, a port checkpoint
file (`<run>/ckpt/<epoch>.pth`) or a port run's `ckpt/` directory (its
latest epoch); without it, from the random init of seed 0. Volumes are N
synthetic ones (`--synthetic N`, seed 7) or the catalog under `--data-root`.
Reading the JAX package's orbax checkpoints and the latent embedding come
later.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="sivae_torch evaluation (latent AUC / "
                                             "retrieval / reconstruction)")
    ap.add_argument("--model", default="spatial_1200")
    ap.add_argument("--ckpt", default=None,
                    help="reference .pth, port checkpoint file or port ckpt/ directory")
    ap.add_argument("--data-root", default="/data/radiology_datas")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="evaluate N synthetic volumes (seed 7) instead of the dataset")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--bf16", action="store_true", default=False)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sivae_torch.data.pipeline import BrainDataSource, grouped_split
    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.data.synthetic import SyntheticBrainSource
    from sivae_torch.eval.latent_probe import encode_dataset, logistic_auc
    from sivae_torch.eval.recon_quality import reconstruction_report
    from sivae_torch.eval.retrieval import retrieval_precision_at_k
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_model_config(args.model)
    if args.bf16:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    ckpt = args.ckpt
    if ckpt and os.path.isdir(ckpt):
        from sivae_torch.utils.checkpoint import CheckpointManager

        mgr = CheckpointManager(ckpt)
        if mgr.latest_step() is None:
            raise SystemExit(f"--ckpt {ckpt}: no port checkpoint (<epoch>.pth) there; reading "
                             "the JAX package's orbax checkpoints is not ported yet "
                             "(ROADMAP A.6)")
        ckpt = mgr.path(mgr.latest_step())
    model = make_model(cfg, device=dev)
    if ckpt:
        from sivae_torch.utils.jax_import import load_reference_pth

        load_reference_pth(model, ckpt)  # a port checkpoint's "model" entry, or a .pth

    if args.synthetic:
        records = list(SyntheticBrainSource(args.synthetic, cfg.input_shape, seed=7))
    else:
        from sivae_torch.data.catalog import load_data

        records = load_data(kinds=["ADNI2", "ADNI2-2"],
                            classes=["CN", "AD", "EMCI", "LMCI", "SMC", "MCI"],
                            blacklist=True, root=args.data_root)
    src = BrainDataSource(records)
    tid, vid = grouped_split(src.labels, src.pids, 5, 4, 103)
    vox = preprocess_batch(torch.from_numpy(src.voxels).to(dev))
    labels = src.labels

    z = encode_dataset(model, vox, batch_size=args.batch)
    report = {}
    # CN-vs-AD probe restricted to binary labels, like logistic1 cells 9-13
    binary = np.isin(labels, (0, 1))
    tmask = np.zeros(len(labels), bool)
    tmask[tid] = True
    tb, vb = binary & tmask, binary & ~tmask
    if tb.sum() > 4 and vb.sum() > 4 and len(set(labels[vb])) == 2:
        report["train_auc"], report["val_auc"] = logistic_auc(z[tb], labels[tb], z[vb], labels[vb])
    report["retrieval_p_at_k"] = retrieval_precision_at_k(
        z[vid], labels[vid], z[tid], labels[tid], k=args.k, device=dev)
    report.update(reconstruction_report(
        model, vox[torch.as_tensor(vid, device=dev)], batch_size=min(8, args.batch)))

    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
