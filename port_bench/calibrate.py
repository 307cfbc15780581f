"""Readings that the limits of `port_bench/limits/<cell>.json` are set from.

    python3 port_bench/calibrate.py --workload <cell> --program-seeds S ... --control-seeds S ...

For each program seed, a cell's set-up and its checked work (a train
cell's first three steps, an eval cell's pass) and the check against the
reference: the program's readings, no window. For each control seed the
reference itself in the program's place, computed one precision below the
configuration's (bfloat16 -> float8 e4m3 operands; float32 -> TF32; the
float32 data path and report arithmetic -> bfloat16), and,
for a train cell, the reference with half of each batch left out (the
mean over the rest) and, on several cards, with nothing exchanged between
the ranks: the faults' readings. One JSON line per reading, with
`correct` as the cell's limits judge it, then the program's largest
reading of every number (the lower reading) and the smallest of the
control's and of each fault's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def _print(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _record(ctx, kind: str, seed: int, numbers: dict) -> dict:
    """A reading, with `correct` as the cell's limits judge it."""
    from port_bench.harness import checks_of, judge

    return {"kind": kind, "seed": seed, **numbers,
            "correct": judge(checks_of(numbers, ctx.limits))}


def train_readings(ctx, rank: int, world: int, program_seeds, control_seeds):
    """A train cell's readings on this rank (the largest over the ranks, on
    rank 0, of a cell on several cards)."""
    import dataclasses

    import torch

    from port_bench.entries.train_step import TrainCell, _max_over_ranks
    from port_bench.lib import compare
    from port_bench.lib.program import compute_dtype
    from port_bench.reference.model import Precision

    out = []

    def emit(cell, kind, seed, numbers):
        rec = _record(ctx, kind, seed, _max_over_ranks(numbers, world, cell.dev))
        if rank == 0:
            _print(rec)
        out.append(rec)

    for seed in program_seeds:
        cell = TrainCell(dataclasses.replace(ctx, seed=seed), rank, world)
        cell.setup()
        cell.check_steps()
        cell.close_program()
        emit(cell, "program", seed, cell.numbers(cell.reference()))
    control = CONTROL[compute_dtype(ctx.cfg, ctx.traffic)]
    for seed in control_seeds:
        cell = TrainCell(dataclasses.replace(ctx, seed=seed), rank, world)
        cell.setup()
        cell.close_program()
        exact = cell.reference()
        low = cell.reference(Precision(control))
        # the data path one precision down: the batches in bfloat16
        low = ([x.to(torch.bfloat16).float() for x in low[0]],) + tuple(low[1:])
        faults = [(control, low),
                  ("half_batch", cell.reference(half_batch=True))]
        if world > 1:
            faults.append(("no_exchange", cell.reference(exchange=False)))
        for kind, got in faults:
            emit(cell, kind, seed, compare.train_numbers(*got, *exact, cell.state0))
    return out


def eval_readings(ctx, program_seeds, control_seeds):
    import dataclasses

    import numpy as np
    import torch

    from port_bench.entries.eval_pass import EvalCell, _stack
    from port_bench.lib import compare
    from port_bench.lib.program import compute_dtype
    from port_bench.reference.model import Precision

    out = []
    for seed in program_seeds:
        cell = EvalCell(dataclasses.replace(ctx, seed=seed))
        cell.setup()
        cell.last = cell.one_pass({})
        cell.close_program()
        rec = _record(ctx, "program", seed, cell.numbers(cell.reference()))
        _print(rec)
        out.append(rec)
    control = CONTROL[compute_dtype(ctx.cfg, ctx.traffic)]
    k = int(ctx.traffic["k"])
    for seed in control_seeds:
        cell = EvalCell(dataclasses.replace(ctx, seed=seed))
        cell.setup()
        cell.close_program()
        z, recons = cell.reference()
        zc, recons_c = cell.reference(Precision(control))
        # the control's neighbours, from its own latents
        idx = np.argsort(-compare.cosine(zc[cell.vid], zc[cell.tid]), axis=1,
                         kind="stable")[:, :k]
        # the report's arithmetic one precision down: bfloat16 for float32
        numbers = compare.eval_numbers(zc, z, _stack(recons_c), _stack(recons),
                                       cell.report_of(recons, torch.bfloat16),
                                       cell.report_of(recons), idx,
                                       compare.cosine(z[cell.vid], z[cell.tid]), 0.0, 0.0)
        rec = _record(ctx, control, seed, numbers)
        _print(rec)
        out.append(rec)
    return out


def main(argv=None) -> int:
    from port_bench import calibrate   # by its package name, for the spawned ranks
    from port_bench.entries.train_step import with_ranks
    from port_bench.harness import make_context, parse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = ap.parse_args(argv)
    args = parse(["--workload", a.workload, "--seed", "0", "--seconds", "0"])
    ctx = make_context(ROOT, args, time.perf_counter())
    entry = ctx.traffic["entry"]
    if entry == "train_step":
        recs = with_ranks(ctx, calibrate.train_readings, a.program_seeds, a.control_seeds)
    elif entry == "eval_pass":
        recs = eval_readings(ctx, a.program_seeds, a.control_seeds)
    else:
        print(f"no readings for entry {entry!r}", file=sys.stderr)
        return 2
    numbers = [k for k in recs[0] if k not in ("kind", "seed", "correct")]
    summary = {}
    for kind in sorted({r["kind"] for r in recs}):
        got = [r for r in recs if r["kind"] == kind]
        pick = max if kind == "program" else min   # the lower reading; each upper one
        summary[kind] = {k: pick(r[k] for r in got) for k in numbers}
        summary[kind]["correct"] = [r["correct"] for r in got]
    _print({"kind": "summary", "workload": a.workload, **summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
