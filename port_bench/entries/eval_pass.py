"""Entry "eval_pass": the eval CLI's device pass of `sivae_torch`, repeated
whole through the window.

The volumes are made on the card from the seed and stay there, raw; the
held-out fifth is a seeded patient split. One pass is what the eval CLI
does on the card after loading: `preprocess_batch` of every volume,
`encode_dataset` (batch `encode_batch`), `retrieval_precision_at_k` of the
held-out latents against the rest, and `reconstruction_report` of the
held-out volumes (batch `report_batch`). The scikit-learn AUC and the
latent map are host library code and are left out.

Set-up runs one pass (every shape warmed up). The window runs passes until
`--seconds` have passed; with `--trace 1` one more pass runs under the
profiler. The check of the window's last pass, with the program's model
freed: the plain reference in float32 (TF32 off), on the same raw volumes
and weights, gives the latents of every volume and the reconstructions of
every held-out one. The program's latents, reconstructions and nearest
neighbours (the indices its kNN chose) are held against them; its report
and precision@k against the reference's arithmetic on the program's own
reconstructions and latents.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from port_bench.harness import Observation, Outcome, checks_of
from port_bench.lib import compare
from port_bench.lib.program import compute_dtype, program_model
from port_bench.lib.volumes import patient_split, synthetic_volumes
from port_bench.lib.weights import benchmark_state
from port_bench.reference import data as ref_data
from port_bench.reference import evaluate as ref_eval
from port_bench.reference.model import Precision, make_reference, precision_flags


class EvalCell:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.traffic = ctx, ctx.cfg, ctx.traffic
        self.shape = tuple(self.cfg["input_shape"])

    def setup(self):
        ctx, t = self.ctx, self.traffic
        if ctx.device == "cpu":
            self.dev = torch.device("cpu")
        else:
            torch.cuda.set_device(0)
            self.dev = torch.device("cuda", 0)
        self.raw, self.labels = synthetic_volumes(int(t["volumes"]), self.shape, ctx.seed,
                                                  self.dev)
        self.tid, self.vid = patient_split(int(t["volumes"]), ctx.seed)
        state = benchmark_state(make_reference(self.cfg, "meta"), ctx.seed, self.dev)
        self.state0 = {k: v.detach().cpu().clone() for k, v in state.items()}
        self.model = program_model(self.cfg, compute_dtype(self.cfg, t), state, self.dev)
        del state
        self.vid_dev = torch.as_tensor(self.vid, device=self.dev)

    def one_pass(self, spans: Dict[str, float]):
        """One pass of the eval CLI's device work; host-clock spans around
        each call (each ends in a read of its result on the host). Returns
        the latents, precision@k, the report, the report's reconstructions
        and the kNN's indices (kept as the program's calls made them, for
        the check)."""
        import sivae_torch.eval.recon_quality as recon_quality
        import sivae_torch.eval.retrieval as retrieval
        from sivae_torch.data.preprocess import preprocess_batch
        from sivae_torch.eval.latent_probe import encode_dataset

        t = self.traffic
        kept, knn = [], []
        reconstruct, cosine_knn = recon_quality.reconstruct, retrieval.cosine_knn

        def keep(fn, into, pick=lambda y: y):
            def wrapped(*args, **kwargs):
                y = fn(*args, **kwargs)
                into.append(pick(y))
                return y
            return wrapped

        a = time.perf_counter()
        vox = preprocess_batch(self.raw)
        z = encode_dataset(self.model, vox, batch_size=int(t["encode_batch"]))
        b = time.perf_counter()
        retrieval.cosine_knn = keep(cosine_knn, knn, pick=lambda y: y[1])
        try:
            p = retrieval.retrieval_precision_at_k(z[self.vid], self.labels[self.vid], z[self.tid],
                                                   self.labels[self.tid], k=int(t["k"]),
                                                   device=self.dev)
        finally:
            retrieval.cosine_knn = cosine_knn
        c = time.perf_counter()
        recon_quality.reconstruct = keep(reconstruct, kept)
        try:
            rep = recon_quality.reconstruction_report(self.model, vox[self.vid_dev],
                                                      batch_size=int(t["report_batch"]))
        finally:
            recon_quality.reconstruct = reconstruct
        d = time.perf_counter()
        for name, s in (("encode", b - a), ("retrieval", c - b), ("report", d - c),
                        ("pass", d - a)):
            spans[name] = spans.get(name, 0.0) + s
        return z, p, rep, kept, knn

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, obs: Observation):
        self._sync()
        if self.dev.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        obs.setup_s = time.perf_counter() - self.ctx.t0
        spans: Dict[str, float] = {}
        passes = 0
        t0 = time.perf_counter()
        while True:
            self.last = self.one_pass(spans)
            passes += 1
            if time.perf_counter() - t0 >= self.ctx.seconds:
                break
        self._sync()
        obs.window_s = time.perf_counter() - t0
        obs.units, obs.volumes = passes, passes * int(self.traffic["volumes"])
        obs.spans.update(spans)
        if self.dev.type == "cuda":
            obs.peak_window_bytes = torch.cuda.max_memory_allocated(self.dev)
        self.passes = passes

    def traced(self, obs: Observation):
        from torch.profiler import ProfilerActivity, profile, record_function

        from sivae_torch.kernels import build
        from port_bench.lib.trace import WINDOW_SPAN, from_profiler

        self._sync()
        build.reset_launches()
        spans: Dict[str, float] = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                self.one_pass(spans)
                self._sync()
        obs.trace = from_profiler(prof)
        obs.trace_units = 1
        obs.sites = {**build.conv3d_same_sites, **build.conv3d_to1_sites,
                     **build.conv3d_from1_sites}

    def close_program(self):
        """Free the model; the last pass's outputs stay for the check."""
        self.peak = max(getattr(self, "setup_peak", 0),
                        torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0)
        del self.model
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _originals(self, rows) -> torch.Tensor:
        return ref_data.preprocess(self.raw[torch.as_tensor(rows, device=self.dev)])

    def reference(self, prec: Precision = Precision()):
        """The reference's latents of every volume and its reconstructions
        of the held-out volumes (in report batches, on the card)."""
        t = self.traffic
        ref = make_reference(self.cfg, self.dev)
        ref.load_state_dict({k: v.to(self.dev) for k, v in self.state0.items()})
        ref.eval()
        bs, rb = int(t["encode_batch"]), int(t["report_batch"])
        with precision_flags(prec):
            rows = np.arange(int(t["volumes"]))
            z = torch.cat([ref_eval.encode_mu(ref, self._originals(rows[i:i + bs]), prec)
                           for i in range(0, len(rows), bs)]).cpu().numpy()
            recons = [ref_eval.reconstruct(ref, self._originals(self.vid[i:i + rb]), prec)
                      for i in range(0, len(self.vid), rb)]
        del ref
        gc.collect()
        return z, recons

    def report_of(self, recons, dtype=torch.float64) -> Dict[str, float]:
        """The reference's arithmetic of the report: the mean metrics of
        the held-out originals against `recons`, in `dtype`."""
        rb, per = int(self.traffic["report_batch"]), []
        for i, y in zip(range(0, len(self.vid), rb), recons):
            x = self._originals(self.vid[i:i + rb])[:, 0]
            per.append(ref_eval.volume_metrics(x, y[:, 0].float(), dtype))
        m = torch.cat(per).double().mean(dim=0).tolist()
        return {"rmse": m[0], "psnr": m[1], "ssim3d": m[2], "ssim_center_slice": m[3]}

    def numbers(self, ref) -> Dict[str, float]:
        """The program's last pass against the reference's."""
        z_ref, recons_ref = ref
        z, p, rep, kept, knn = self.last
        p_ref = ref_eval.precision_at_k(z[self.vid], self.labels[self.vid], z[self.tid],
                                        self.labels[self.tid], int(self.traffic["k"]))
        return compare.eval_numbers(z, z_ref, _stack(kept), _stack(recons_ref), rep,
                                    self.report_of(kept), knn[-1].cpu().numpy(),
                                    compare.cosine(z_ref[self.vid], z_ref[self.tid]), p, p_ref)


def _stack(recons) -> np.ndarray:
    return torch.cat(recons).double().cpu().numpy()


def run(ctx) -> Outcome:
    from port_bench.lib.flops import eval_pass_flops
    from port_bench.lib.roofline import PEAK_FLOPS

    cell = EvalCell(ctx)
    cell.setup()
    cell.one_pass({})   # warm-up
    obs = Observation(cell=ctx.cell, chips=1)
    cell.window(obs)
    busy = window = None
    if ctx.trace:
        cell.traced(obs)
        busy, window = obs.trace.busy_s, obs.trace.window_s
        t = ctx.traffic
        obs.flops_per_unit = eval_pass_flops(ctx.cfg, int(t["volumes"]), int(t["encode_batch"]),
                                             len(cell.vid), int(t["report_batch"]))
        obs.peak_flops = PEAK_FLOPS[compute_dtype(ctx.cfg, t)]
    cell.close_program()
    numbers = cell.numbers(cell.reference())
    return Outcome(obs=obs, checks=checks_of(numbers, ctx.limits), attempted=cell.passes, failed=0,
                   memory_peak_bytes=int(cell.peak), busy_s=busy, window_s=window)
