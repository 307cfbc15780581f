"""The benchmark's driver, shared by every cell.

Everything that belongs to one cell, configuration, traffic mix or metric
is found by name:
- the cell (its configuration, traffic and chips) in `BENCHMARK.json`;
- the configuration in `port_bench/configs/<config>.json`;
- the traffic mix in `port_bench/traffic/<traffic>.json`, whose "entry"
  names the generator that runs it, `port_bench/entries/<entry>.py`;
- the limits of the cell's correctness numbers in
  `port_bench/limits/<cell>.json`;
- each metric's reader in `port_bench/metrics/<metric>.py`, a function
  `read(obs)` that returns a number or None (nothing to read).

With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (and `busy_s`, `window_s` and the
breakdown), each only where `BENCHMARK.json` lists the cell for it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

# the JAX package and its libraries: none may be loaded where the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sivae_tpu")


@dataclass
class Observation:
    """What one run saw, for the metric readers. Times in seconds."""

    cell: dict
    chips: int
    setup_s: float = math.nan
    window_s: float = math.nan         # the timed window, host clock
    units: int = 0                     # train steps or eval passes completed in it
    volumes: int = 0                   # volumes they completed
    spans: Dict[str, float] = field(default_factory=dict)     # host-clock totals in the window
    counters: Dict[str, float] = field(default_factory=dict)  # program counters in the window
    peak_window_bytes: int = 0         # rank 0's peak allocation in the window
    flops_per_unit: Optional[float] = None   # the algorithm's, all chips together
    peak_flops: Optional[float] = None       # one chip's, for the compute type
    trace: Any = None                  # lib.trace.TraceSummary of rank 0's profiled window
    trace_units: int = 0
    sites: Dict[str, int] = field(default_factory=dict)       # conv sites in the profiled window


@dataclass
class Outcome:
    """What an entry hands back on the rank that prints."""

    obs: Observation
    checks: Dict[str, Tuple[float, float]]     # name -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: Optional[float] = None     # averaged over the chips
    window_s: Optional[float] = None
    forbidden_ranks: int = 0           # other ranks that loaded a FORBIDDEN module


@dataclass
class Context:
    root: str
    cell: dict
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: str = "cuda"
    rank_target: Optional[Callable] = None


def bench_dir(root: Path) -> Path:
    return Path(root) / "port_bench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[c['name'] for c in bench['workloads']]}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: end to end without tracing,
    per layer with it; a metric with a "workloads" list only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(root: Path, metrics: List[dict], obs: Observation) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        reader = load_module(bench_dir(root) / "metrics" / f"{m['name']}.py",
                             "port_bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """The FORBIDDEN top-level names this process has loaded, named on
    standard error."""
    found = sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
    if found:
        print(f"port_bench: the run loaded {found}: the JAX package or its libraries",
              file=sys.stderr, flush=True)
    return found


def checks_of(numbers: Dict[str, float], limits: dict) -> Dict[str, Tuple[float, float]]:
    """The numbers a cell's limits name, each beside its limit (the others
    are readings, not compared)."""
    return {k: (float(numbers[k]), float(lim)) for k, lim in limits.items()}


def judge(checks: Dict[str, Tuple[float, float]], failed: int = 0) -> bool:
    """`correct`: every number compared within its limit, nothing failed."""
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values()) and failed == 0


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="The benchmark of sivae_torch on the H100")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def make_context(root: Path, args, t0: float, device: str = "cuda",
                 rank_target: Optional[Callable] = None) -> Context:
    bench = load_json(Path(root) / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    b = bench_dir(root)
    return Context(root=str(root), cell=cell,
                   cfg=load_json(b / "configs" / f"{cell['config']}.json"),
                   traffic=load_json(b / "traffic" / f"{cell['traffic']}.json"),
                   limits=load_json(b / "limits" / f"{cell['name']}.json"), seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace), t0=t0, device=device,
                   rank_target=rank_target)


def run_entry(ctx: Context) -> Optional[Outcome]:
    """The traffic's entry, `port_bench/entries/<entry>.py`, imported by its
    module name (spawned ranks import it again)."""
    import importlib

    return importlib.import_module(f"port_bench.entries.{ctx.traffic['entry']}").run(ctx)


def checks_text(checks: Dict[str, Tuple[float, float]]) -> List[str]:
    return [f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}"
            for k, (v, lim) in checks.items()]


def result_line(root: Path, ctx: Context, out: Outcome, device: dict) -> dict:
    bench = load_json(Path(root) / "BENCHMARK.json")
    metrics = read_metrics(root, cell_metrics(bench, ctx.cell["name"], ctx.trace), out.obs)
    line = {"correct": judge(out.checks, out.failed), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.trace and out.obs.trace is not None:
        t = out.obs.trace
        line["breakdown"] = {"device_ops": [[n, s] for n, s in t.device_ops],
                             "idle_gaps": [[n, s] for n, s in t.idle_gaps]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def run_cell(ctx: Context) -> Tuple[int, Optional[dict]]:
    """Everything after the look for the cards: run the entry, refuse a run
    in which any rank's process loaded the JAX package, build the line.
    (exit code, line)."""
    import torch

    out = run_entry(ctx)
    if forbidden_modules() or out.forbidden_ranks:
        if out.forbidden_ranks:
            print(f"port_bench: {out.forbidden_ranks} other rank(s) loaded the JAX package "
                  f"or its libraries", file=sys.stderr, flush=True)
        return 3, None
    cuda = ctx.device == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(ctx.cell["chips"]), "memory_peak_bytes": int(out.memory_peak_bytes)}
    if ctx.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    line = result_line(Path(ctx.root), ctx, out, device)
    for text in checks_text(out.checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    return 0, line


def main(argv=None, root=None, t0: float = 0.0) -> int:
    """Run one cell on its cards and print its line; the exit code."""
    import torch

    args = parse(argv)
    ctx = make_context(Path(root), args, t0)
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    rc, line = run_cell(ctx)
    if line is not None:
        print(json.dumps(line), flush=True)
    return rc
