"""Convert a JAX run's orbax checkpoints into the port's checkpoints.

    python tools/torch_from_orbax.py <ckpt_dir> <out_dir> [--step N] [--model NAME]
        [--seed S] [--generator-device cuda|cpu]

Needs JAX and orbax (the JAX package's environment) and runs on the CPU.
Each step of the orbax directory `<ckpt_dir>` (the one `--step`, or every
step) is restored without a template, as plain trees, and loaded through
`sivae_torch.utils.jax_import.load_jax_train_state` into a port train state
of `--model` (default: the model of the run's `args.json` beside
`<ckpt_dir>`): parameters, BN running statistics, both Adams' moments and
update counts (one joint Adam for a VAE / vae2soft-stage state, whose
`opt_d` is empty) and the step. It is written as `<out_dir>/<step>.pth`,
the layout of `sivae_torch/utils/checkpoint.py`, which
`python -m sivae_torch.cli.eval --ckpt <out_dir>`, `python -m
sivae_torch.cli.train --pretrained <out_dir>` and the port's
`CheckpointManager.restore` read.

The JAX state's PRNG key cannot carry across: torch draws its noise from a
`torch.Generator`, another generator altogether. Each converted checkpoint
holds instead a new generator seeded with `--seed` (default 0), of the
device type `--generator-device` (default cuda, where the port trains;
`cpu` for a state restored on the CPU); the state is made without that
device. A resumed run therefore draws other noise and dropout masks than the
JAX run would have.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _np_tree(tree):
    import numpy as np

    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def _adam(opt) -> Dict[str, Any]:
    """optax's adam state, (ScaleByAdamState, ScaleByScheduleState), as
    restored without a template: a list whose first entry holds the moments."""
    return {"mu": _np_tree(opt[0]["mu"]), "nu": _np_tree(opt[0]["nu"]),
            "count": int(opt[0]["count"])}


def restore_trees(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """One orbax step of a `SIVAETrainState` as the numpy trees that
    `load_jax_train_state` takes (the rng key left out)."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(ckpt_dir))
    raw = mgr.restore(step, args=ocp.args.StandardRestore())
    trees = {k: _np_tree(raw[k]) for k in ("enc_params", "dec_params", "enc_stats", "dec_stats")}
    trees["opt_e"] = _adam(raw["opt_e"])
    if raw.get("opt_d"):
        trees["opt_d"] = _adam(raw["opt_d"])
    trees["step"] = int(raw["step"])
    return trees


def run_model_name(ckpt_dir: str) -> Optional[str]:
    """The model of the run whose `args.json` sits beside `ckpt_dir`."""
    path = os.path.join(os.path.dirname(os.path.abspath(ckpt_dir)), "args.json")
    if not os.path.exists(path):
        return None
    from sivae_torch.cli.train import PRESETS

    with open(path) as f:
        saved = json.load(f)
    return saved.get("model") or PRESETS[saved["preset"]]["model"]


class _SeededGenerator:
    """What `CheckpointManager.save` reads of a generator: the state of a new
    generator of a device type that need not be present here."""

    def __init__(self, device_type: str, seed: int):
        import torch

        from sivae_torch.utils.checkpoint import seeded_generator_state

        self.device = torch.device(device_type)
        self._state = seeded_generator_state(device_type, seed)

    def get_state(self):
        return self._state


def convert(ckpt_dir: str, out_dir: str, model: str, steps: Optional[List[int]] = None,
            seed: int = 0, generator_device: str = "cuda") -> List[int]:
    """Write `<out_dir>/<step>.pth` for each step (default: every step of
    `ckpt_dir`, oldest first). Returns the steps written."""
    import orbax.checkpoint as ocp

    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.train.state import create_train_state
    from sivae_torch.utils.checkpoint import CheckpointManager
    from sivae_torch.utils.jax_import import load_jax_train_state

    if steps is None:
        steps = sorted(ocp.CheckpointManager(os.path.abspath(ckpt_dir)).all_steps())
    if not steps:
        raise FileNotFoundError(f"no orbax checkpoint in {ckpt_dir}")
    cfg = get_model_config(model)
    out = CheckpointManager(out_dir)
    for step in sorted(steps):
        trees = restore_trees(ckpt_dir, step)
        state = create_train_state(make_model(cfg, device="cpu"), seed=seed,
                                   joint_optimizer="opt_d" not in trees)
        load_jax_train_state(state, trees)
        state.generator = _SeededGenerator(generator_device, seed)
        if not out.save(step, state):
            raise FileExistsError(f"{out_dir} already holds step {out.latest_step()} >= {step}")
    return sorted(steps)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt_dir", help="the JAX run's orbax checkpoint directory")
    ap.add_argument("out_dir", help="where the port checkpoints <step>.pth go")
    ap.add_argument("--step", type=int, default=None, help="one step (default: every step)")
    ap.add_argument("--model", default=None,
                    help="registry name of the run's model (default: from its args.json)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the new generator")
    ap.add_argument("--generator-device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    from sivae_tpu.utils.platform import force_cpu

    force_cpu()
    model = args.model or run_model_name(args.ckpt_dir)
    if model is None:
        ap.exit(2, f"no args.json beside {args.ckpt_dir}: pass --model\n")
    steps = convert(args.ckpt_dir, args.out_dir, model,
                    None if args.step is None else [args.step], args.seed,
                    args.generator_device)
    print(f"wrote {len(steps)} port checkpoints of {model} to {args.out_dir}: steps {steps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
