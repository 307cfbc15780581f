"""Apply the health gate to a port training run that stopped before `fit`
returned.

    python tools/torch_posthoc_health.py <run_dir> [--batch N] [--panels] [--device cpu]

`python -m sivae_torch.cli.train --health-gate` sweeps and gates only when
`fit` returns; a run stopped early leaves `args.json` and `ckpt/<epoch>.pth`
but no sweep.json / health.json. This rebuilds the run's model and its
validation split from `args.json` (the preset's model or `--model`, `--bf16`,
the synthetic records or the catalog, grouped by patient with the run's
`--seed-split`: needs scikit-learn) and applies the train CLI's gate
(`sivae_torch.eval.run_dir.posthoc_health`) over the checkpoints that exist:
writes sweep.json and health.json into the run directory, prints the
verdict and exits 1 if the run is unhealthy. `--panels` also writes each
checkpoint's reconstruction panel into `<run_dir>/sweep_panels` (skipped
with one line where matplotlib does not import). Runs on CUDA unless
`--device cpu` is given (not the device saved in `args.json`).
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
    ap.add_argument("--batch", type=int, default=None, help="default: the run's batch")
    ap.add_argument("--panels", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sivae_torch.eval.run_dir import load_run_args, posthoc_health, run_val_source
    from sivae_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    val = run_val_source(load_run_args(args.run_dir))
    try:
        _, health = posthoc_health(args.run_dir, val, dev, batch=args.batch, panels=args.panels)
    except ValueError as e:
        ap.exit(2, f"{e}\n")
    return 0 if health["healthy"] else 1


if __name__ == "__main__":
    sys.exit(main())
