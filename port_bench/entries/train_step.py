"""Entry "train_step": the Soft-IntroVAE two-phase step of `sivae_torch`,
driven as `SoftIntroTrainer.fit` drives it, on one card or on one process
per card (the train CLI's data parallelism).

Set-up: the volumes (made on the card from the seed, then held on the host
as the train CLI holds a dataset), the benchmark's weights, the program's
model, train state and step, and its `DataPipeline` (prefetch thread,
side-stream copy, on-device augmentation and preprocessing). The first
`CHECK_STEPS` steps go through the same pipeline and step; they warm every
shape up, and what they produce is kept for the check.

The window: steps until `--seconds` have passed, the metrics summed on the
card and read at each epoch's end, as `fit` reads them. With `--trace 1`
`trace_steps` more steps run under the profiler.

The check, after the window, with the program's state freed: the plain
reference (`port_bench/reference/`) takes the same initial weights, makes
the same batches from the raw volumes, follows the first three steps, and
is compared with the program (`lib/compare.py`): the batches, the first
step's two losses, and, by the norm of their difference, the median leaf
of the first gradient (from Adam's first moment after step 1) and of the
change over the three steps (BatchNorm's running statistics included).
"""

from __future__ import annotations

import gc
import math
import os
import socket
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from port_bench.harness import Observation, Outcome
from port_bench.lib import compare
from port_bench.lib.program import compute_dtype, program_model
from port_bench.lib.volumes import synthetic_volumes
from port_bench.lib.weights import benchmark_state
from port_bench.reference import data as ref_data
from port_bench.reference.model import Precision, make_reference, precision_flags
from port_bench.reference.step import RefTrainer, StepHyper

CHECK_STEPS = 3
STOP_EVERY = 4   # steps between the ranks' agreements on the window's end


@dataclass
class HostVolumes:
    """The train split as the pipeline reads it."""

    voxels: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)


def pipeline_seed(seed: int) -> int:
    return seed % (1 << 31)


def hyper(traffic: dict) -> StepHyper:
    return StepHyper(**traffic["loss"], lr=traffic["lr"])


class TrainCell:
    """One rank's run of a train cell."""

    def __init__(self, ctx, rank: int = 0, world: int = 1):
        self.ctx, self.rank, self.world = ctx, rank, world
        self.cfg, self.traffic = ctx.cfg, ctx.traffic
        self.batch = int(self.traffic["global_batch"])
        self.local = self.batch // world
        self.shape = tuple(self.cfg["input_shape"])

    # -- set-up -------------------------------------------------------------
    def setup(self):
        import sivae_torch.cli.train as cli
        from sivae_torch.config import OptimConfig, SoftIntroLossConfig
        from sivae_torch.data.pipeline import DataPipeline
        from sivae_torch.train.state import create_train_state
        from sivae_torch.train.step import make_soft_intro_train_step

        ctx, t = self.ctx, self.traffic
        self.dev = self._device()
        raw, labels = synthetic_volumes(int(t["volumes"]), self.shape, ctx.seed, self.dev)
        self.host = raw.cpu().numpy()
        del raw
        state = benchmark_state(make_reference(self.cfg, "meta"), ctx.seed, self.dev)
        self.state0 = {k: v.detach().cpu().clone() for k, v in state.items()}
        self.model = program_model(self.cfg, compute_dtype(self.cfg, t), state, self.dev)
        del state
        loss = t["loss"]
        self.loss_cfg = SoftIntroLossConfig(beta_rec=loss["beta_rec"], beta_neg=loss["beta_neg"],
                                            beta_kl=loss["beta_kl"], gamma_r=loss["gamma_r"],
                                            exp_elbo_weight=loss["exp_elbo_weight"],
                                            loss_multiplier=loss["loss_multiplier"])
        self.optim_cfg = OptimConfig(lr=t["lr"])
        aug = t.get("augment")
        self.pipe = DataPipeline(HostVolumes(self.host, labels), self.batch, device=self.dev,
                                 seed=pipeline_seed(ctx.seed),
                                 augment=cli.make_augment_fn(tuple(aug) if aug else None))
        self.state = create_train_state(self.model, seed=ctx.seed, optim_cfg=self.optim_cfg)
        if self.world > 1:
            import torch.distributed as dist

            from sivae_torch.parallel import replicate_state

            replicate_state(self.state)
            self.control = dist.new_group(backend="gloo")
        self.step_fn = make_soft_intro_train_step(self.model, self.loss_cfg, self.optim_cfg,
                                                  self.pipe.steps_per_epoch, self.shape)
        self.feed = self._feed()
        self.sums = None
        self.nan_steps = 0

    def _device(self) -> torch.device:
        if self.world > 1:
            from sivae_torch.parallel.distributed import init_distributed, initialized

            if initialized():   # a later cell set up in the same process
                return torch.device("cpu") if self.ctx.device == "cpu" else \
                    torch.device("cuda", torch.cuda.current_device())
            return init_distributed(device=self.ctx.device)
        if self.ctx.device == "cpu":
            return torch.device("cpu")
        torch.cuda.set_device(0)
        return torch.device("cuda", 0)

    def _feed(self):
        """The pipeline's batches across epochs; None marks an epoch's end."""
        epoch = 0
        while True:
            for vox, _ in self.pipe.epoch(epoch):
                yield vox
            yield None
            epoch += 1

    def _next(self):
        vox = next(self.feed)
        if vox is None:   # an epoch ended: fit reads the epoch's sums here
            self._read_sums()
            vox = next(self.feed)
        return vox

    def _read_sums(self):
        if self.sums is None:
            return
        from sivae_torch.parallel.mesh import mean_across

        values = mean_across(torch.stack(list(self.sums.values()))).cpu().tolist()
        self.nan_steps += int(round(dict(zip(self.sums, values))["nan"] * self.world))
        self.sums = None

    def _step(self, vox):
        self.state, m = self.step_fn(self.state, vox)
        m = {k: v.float() for k, v in m.items()}
        self.sums = m if self.sums is None else {k: self.sums[k] + m[k] for k in self.sums}
        return m

    def check_steps(self):
        """The first steps, kept for the check: the batches, the losses,
        Adam's first moments after step 1 and the state after the last."""
        self.batches, self.losses = [], []
        for k in range(CHECK_STEPS):
            vox = self._next()
            self.batches.append(vox.detach().cpu())
            m = self._step(vox)
            self.losses.append((m["lossE"].item(), m["lossD"].item()))
            if k == 0:
                self.moments = self._moments()
        self.after = {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}

    def _moments(self) -> Dict[str, torch.Tensor]:
        by_param = {}
        for opt in (self.state.opt_e, self.state.opt_d):
            for p, st in opt.state.items():
                by_param[id(p)] = st["exp_avg"]
        # a parameter Adam holds no moment for has not been updated: 0
        return {k: by_param.get(id(p), torch.zeros_like(p)).detach().cpu().clone()
                for k, p in self.model.named_parameters()}

    # -- the window ---------------------------------------------------------
    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, obs: Observation):
        from sivae_torch.parallel.mesh import collectives, reset_collectives

        self._sync()
        self._barrier()
        if self.dev.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        reset_collectives()
        obs.setup_s = time.perf_counter() - self.ctx.t0
        wait, steps = 0.0, 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            vox = self._next()
            wait += time.perf_counter() - a
            self._step(vox)
            steps += 1
            if (self.world == 1 or steps % STOP_EVERY == 0) and \
                    self._agree(time.perf_counter() - t0 >= self.ctx.seconds):
                break
        self._sync()
        obs.window_s = time.perf_counter() - t0
        obs.units, obs.volumes = steps, steps * self.batch
        obs.spans["data_wait"] = wait
        obs.counters["collective_calls"] = float(sum(c[0] for c in collectives.values()))
        if self.dev.type == "cuda":
            obs.peak_window_bytes = torch.cuda.max_memory_allocated(self.dev)
        self.window_steps = steps

    def traced(self, obs: Observation):
        from torch.profiler import ProfilerActivity, profile, record_function

        from sivae_torch.kernels import build
        from port_bench.lib.trace import WINDOW_SPAN, from_profiler

        k = int(self.traffic["trace_steps"])
        self._sync()
        build.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                for _ in range(k):
                    with record_function("port_bench.next_batch"):
                        vox = self._next()
                    with record_function("port_bench.train_step"):
                        self._step(vox)
                self._sync()
        obs.trace = from_profiler(prof)
        obs.trace_units = k
        obs.sites = {**build.conv3d_same_sites, **build.conv3d_to1_sites,
                     **build.conv3d_from1_sites}
        self.window_steps += k

    def close_program(self):
        """End the pipeline's thread and free the program's state."""
        self._read_sums()
        self.feed.close()
        self.peak = max(getattr(self, "setup_peak", 0),
                        torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0)
        del self.feed, self.pipe, self.state, self.step_fn, self.model
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def reference(self, prec: Precision = Precision(), half_batch: bool = False,
                  exchange: bool = True):
        """The reference's three steps from the same weights and raw
        volumes: (its batches, losses, first gradients, state after).
        Faults to plant: `half_batch`, each step takes the first half of its
        rows only; `exchange=False`, the ranks exchange nothing (BatchNorm's
        statistics and the gradients stay each rank's own)."""
        ctx, t = self.ctx, self.traffic
        ref = make_reference(self.cfg, self.dev)
        ref.load_state_dict({k: v.to(self.dev) for k, v in self.state0.items()})
        n = len(self.host)
        spe = n // self.batch
        seed = pipeline_seed(ctx.seed)
        trainer = RefTrainer(ref, hyper(t), seed=ctx.seed, steps_per_epoch=spe,
                             scale=8.0 / math.prod(self.shape), prec=prec, world=self.world,
                             rank=self.rank, exchange=exchange)
        aug = t.get("augment")
        batches, losses = [], []
        with precision_flags(prec):
            for k in range(CHECK_STEPS):
                rows = ref_data.batch_rows(n, self.batch, seed, 0, k)
                rows = rows[self.rank * self.local:(self.rank + 1) * self.local]
                raw = torch.from_numpy(self.host[rows]).to(self.dev)
                if aug:
                    raw = ref_data.random_affine(raw, seed * 100003 + k, aug[1], aug[2],
                                                 self.world, self.rank)
                x = ref_data.preprocess(raw)
                batches.append(x.cpu())
                out = trainer.step(x[:len(x) // 2] if half_batch else x)
                losses.append((out["lossE"].item(), out["lossD"].item()))
        grads = {k: v.cpu() for k, v in trainer.grads[0].items()}
        after = {k: v.detach().cpu().clone() for k, v in ref.state_dict().items()}
        del trainer, ref
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return batches, losses, grads, after

    def numbers(self, ref) -> Dict[str, float]:
        """The program's first steps against the reference's."""
        batches, losses, grads, after = ref
        b1 = self.optim_cfg.b1
        prog_grads = {k: v / (1.0 - b1) for k, v in self.moments.items()}
        return compare.train_numbers(self.batches, self.losses, prog_grads, self.after,
                                     batches, losses, grads, after, self.state0)

    def _agree(self, stop: bool) -> bool:
        """Rank 0's decision on every rank, over a host-side (gloo) group,
        so that no rank waits on the card for it; on several ranks taken
        every STOP_EVERY steps only."""
        if self.world == 1:
            return stop
        import torch.distributed as dist

        flag = torch.tensor([int(stop)], dtype=torch.int32)
        dist.broadcast(flag, 0, group=self.control)
        return bool(flag.item())

    def _barrier(self):
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()


def _max_over_ranks(values: Dict[str, float], world: int, dev) -> Dict[str, float]:
    if world == 1:
        return values
    import torch.distributed as dist

    t = torch.tensor([values[k] for k in values], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return dict(zip(values, t.tolist()))


def _mean_over_ranks(value: float, world: int, dev) -> float:
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return float(t.item()) / world


def rank_run(ctx, rank: int, world: int) -> Optional[Outcome]:
    """The whole run on one rank; rank 0 returns the outcome. Every rank
    looks for the JAX package in its own process once its window and its
    check are over."""
    from port_bench.harness import checks_of, forbidden_modules
    from port_bench.lib.flops import train_step_flops
    from port_bench.lib.roofline import PEAK_FLOPS

    cell = TrainCell(ctx, rank, world)
    cell.setup()
    cell.check_steps()
    obs = Observation(cell=ctx.cell, chips=world)
    cell.window(obs)
    busy = window = None
    if ctx.trace:
        cell.traced(obs)
        busy, window = obs.trace.busy_s, obs.trace.window_s
        obs.flops_per_unit = train_step_flops(ctx.cfg, hyper(ctx.traffic), cell.local) * world
        obs.peak_flops = PEAK_FLOPS[compute_dtype(ctx.cfg, ctx.traffic)]
    cell.close_program()
    numbers = _max_over_ranks(cell.numbers(cell.reference()), world, cell.dev)
    shared = _max_over_ranks({"peak": float(cell.peak), "nan": float(cell.nan_steps)}, world,
                             cell.dev)
    forbidden = 0.0
    if world > 1:
        # rank 0's own process is looked at where the line is printed
        forbidden = _mean_over_ranks(float(rank != 0 and bool(forbidden_modules())), world,
                                     cell.dev) * world
        if ctx.trace:
            busy = _mean_over_ranks(busy, world, cell.dev)
        from sivae_torch.parallel.distributed import shutdown

        shutdown()
    if rank != 0:
        return None
    return Outcome(obs=obs, checks=checks_of(numbers, ctx.limits),
                   attempted=CHECK_STEPS + cell.window_steps, failed=int(shared["nan"]),
                   memory_peak_bytes=int(shared["peak"]), busy_s=busy, window_s=window,
                   forbidden_ranks=int(round(forbidden)))


# -- one process per card ------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> None:
    """A rank's rendezvous, and its share of the host's cores (as the train
    CLI gives each of its processes)."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), NCCL_SHM_DISABLE="1")
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))


def rank_child(ctx, rank: int, world: int, port: int, fn: Callable, args: tuple) -> None:
    """A spawned rank (ranks 1 .. world - 1): `fn(ctx, rank, world, *args)`."""
    if ctx.root not in sys.path:
        sys.path.insert(0, ctx.root)
    _rank_env(rank, world, port)
    fn(ctx, rank, world, *args)


def _watch(procs, stop: threading.Event) -> None:
    """Stop the run as soon as a rank fails: the others would wait on it in
    a collective."""
    while not stop.wait(1.0):
        for p in procs:
            if p.exitcode not in (None, 0):
                print(f"port_bench: rank process {p.name} failed (exit code {p.exitcode})",
                      file=sys.stderr, flush=True)
                for q in procs:
                    if q.is_alive():
                        q.terminate()
                os._exit(1)


def with_ranks(ctx, fn: Callable, *args):
    """`fn(ctx, rank, world, *args)` on one process per card of the cell
    (`ctx.rank_target`, where set, in place of `rank_child` for the spawned
    ones); rank 0 runs here and its result is returned."""
    world = int(ctx.cell["chips"])
    if world == 1:
        return fn(ctx, 0, 1, *args)
    import multiprocessing as mp

    if ctx.device == "cuda":
        from sivae_torch.kernels.build import build

        build()   # once, before the ranks start
    port = _free_port()
    spawn = mp.get_context("spawn")
    target = ctx.rank_target or rank_child
    procs = [spawn.Process(target=target, args=(ctx, r, world, port, fn, args), name=f"rank{r}")
             for r in range(1, world)]
    for p in procs:
        p.start()
    stop = threading.Event()
    watcher = threading.Thread(target=_watch, args=(procs, stop), daemon=True)
    watcher.start()
    threads = torch.get_num_threads()
    try:
        _rank_env(0, world, port)
        out = fn(ctx, 0, world, *args)
    finally:
        torch.set_num_threads(threads)
        stop.set()
        watcher.join()
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank processes failed: exit codes {bad}")
    return out


def run(ctx) -> Outcome:
    return with_ranks(ctx, rank_run)
