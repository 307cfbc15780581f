"""A port training run rebuilt from its run directory: the checkpoint sweep
and the health gate over whatever checkpoints it holds.

`python -m sivae_torch.cli.train --health-gate` sweeps and gates only when
`fit` returns. A run stopped earlier leaves `args.json` and `ckpt/<epoch>.pth`
but no sweep.json / health.json. These functions rebuild its model config
from `args.json` (the preset's model or `--model`, `--bf16`) and take the
validation volumes as a `BrainDataSource`: `run_val_source` rebuilds the
run's own split (its synthetic records or its catalog, grouped by patient
with its `--seed-split`, which needs scikit-learn); a caller may pass any
other. `tools/torch_sweep_run.py` and `tools/torch_posthoc_health.py` are
their command lines; the train CLI's gate is `health_gate`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import torch


def load_run_args(run_dir: str) -> argparse.Namespace:
    """The train CLI's arguments as the run saved them in `args.json`."""
    with open(os.path.join(run_dir, "args.json")) as f:
        saved = json.load(f)
    saved.pop("model_config", None)
    args = argparse.Namespace(**saved)
    args.run_dir = run_dir
    return args


def run_model_config(args: argparse.Namespace):
    """The run's model config: `--model` or its preset's, in bf16 when the
    run trained in bf16."""
    from sivae_torch.cli.train import PRESETS
    from sivae_torch.models.registry import get_model_config

    cfg = get_model_config(args.model or PRESETS[args.preset]["model"])
    return dataclasses.replace(cfg, dtype=torch.bfloat16) if args.bf16 else cfg


def run_val_source(args: argparse.Namespace):
    """The run's validation split, as the train CLI made it (needs
    scikit-learn)."""
    from sivae_torch.cli.train import load_records
    from sivae_torch.data.pipeline import BrainDataSource, grouped_split

    src = BrainDataSource(load_records(args, run_model_config(args).input_shape))
    _, vid = grouped_split(src.labels, src.pids, n_splits=5, split_index=4,
                           seed=args.seed_split)
    return src.subset(vid)


def write_sweep(cfg, val_source, run_dir: str, batch: int, device,
                panel_dir: Optional[str] = None) -> List[Dict[str, float]]:
    """Sweep every checkpoint under `<run_dir>/ckpt` over the validation
    volumes and write the rows to `<run_dir>/sweep.json`; with `panel_dir`,
    each checkpoint's panel too, or, where matplotlib does not import, one
    line saying they are skipped."""
    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.eval.sweep import sweep_checkpoints
    from sivae_torch.models.registry import make_model
    from sivae_torch.utils.plots import matplotlib_missing

    if panel_dir:
        why = matplotlib_missing()
        if why is not None:
            print(f"[plots] sweep panels skipped: matplotlib does not import ({why}); "
                  f"sweep.json is written", flush=True)
            panel_dir = None
    vox = preprocess_batch(torch.from_numpy(val_source.voxels).to(device))
    sweep = sweep_checkpoints(make_model(cfg, device=device), vox,
                              ckpt_dir=os.path.join(run_dir, "ckpt"), batch_size=batch,
                              panel_dir=panel_dir)
    with open(os.path.join(run_dir, "sweep.json"), "w") as f:
        json.dump(sweep, f, indent=2)
    return sweep


def health_gate(cfg, val_source, run_dir: str, batch: int, device,
                panel_dir: Optional[str] = None) -> Tuple[List[Dict[str, float]], dict]:
    """`write_sweep`, then the frozen r4 criterion (`eval.sweep.run_health`
    with its defaults) over the rows, written to `<run_dir>/health.json` and
    printed. Returns (rows, health)."""
    from sivae_torch.eval.sweep import run_health

    sweep = write_sweep(cfg, val_source, run_dir, batch, device, panel_dir)
    health = run_health(sweep)
    with open(os.path.join(run_dir, "health.json"), "w") as f:
        json.dump(health, f, indent=2)
    print("health gate:", json.dumps(health))
    return sweep, health


def _panel_dir(run_dir: str, panels: bool) -> Optional[str]:
    return os.path.join(run_dir, "sweep_panels") if panels else None


def sweep_run(run_dir: str, val_source, device, batch: Optional[int] = None,
              panels: bool = False) -> List[Dict[str, float]]:
    """The run's checkpoint sweep (`write_sweep`) with the model of its
    `args.json`, at `batch` (default: the run's), panels in
    `<run_dir>/sweep_panels`."""
    args = load_run_args(run_dir)
    return write_sweep(run_model_config(args), val_source, run_dir, batch or args.batch, device,
                       _panel_dir(run_dir, panels))


def posthoc_health(run_dir: str, val_source, device, batch: Optional[int] = None,
                   panels: bool = False) -> Tuple[List[Dict[str, float]], dict]:
    """The train CLI's health gate (`health_gate`) over the checkpoints the
    run holds, with the model of its `args.json`. Returns (rows, health)."""
    from sivae_torch.cli.train import PRESETS

    args = load_run_args(run_dir)
    if PRESETS[args.preset]["trainer"] in ("vae", "cae"):
        raise ValueError(f"{run_dir}: the health gate applies to the soft-intro trainers only "
                         f"(the criterion is calibrated on adversarial drift), not to "
                         f"{args.preset!r}")
    return health_gate(run_model_config(args), val_source, run_dir, batch or args.batch, device,
                       _panel_dir(run_dir, panels))
