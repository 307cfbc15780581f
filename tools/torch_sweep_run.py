"""Checkpoint-sweep a port training run directory.

    python tools/torch_sweep_run.py <run_dir> [--panels] [--batch N] [--device cpu]

Rebuilds the run's model and its validation split from `args.json` (the
preset's model or `--model`, `--bf16`, the synthetic records or the
catalog, grouped by patient with the run's `--seed-split`: needs
scikit-learn), then sweeps every `ckpt/<epoch>.pth` through
`reconstruction_report` (`sivae_torch.eval.run_dir.sweep_run`): writes
sweep.json into the run directory and prints each checkpoint's RMSE / PSNR
/ SSIM. `--panels` also writes each checkpoint's original / reconstruction
panel to `<run_dir>/sweep_panels/recon_<epoch>.jpg` (skipped with one line
where matplotlib does not import). Runs on CUDA unless `--device cpu` is
given (not the device saved in `args.json`).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--panels", action="store_true")
    ap.add_argument("--batch", type=int, default=None, help="default: the run's batch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sivae_torch.eval.run_dir import load_run_args, run_val_source, sweep_run
    from sivae_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    val = run_val_source(load_run_args(args.run_dir))
    rows = sweep_run(args.run_dir, val, dev, batch=args.batch, panels=args.panels)
    for r in rows:
        print(f"ckpt {r['checkpoint']:>4}: rmse {r['rmse']:.4f} psnr {r['psnr']:.2f} "
              f"ssim3d {r['ssim3d']:.4f}")
    print("wrote", os.path.join(args.run_dir, "sweep.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
