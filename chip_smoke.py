"""GPU smoke run of the PyTorch + CUDA port (`sivae_torch`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; fails without them. Phases, in order (any
failure exits non-zero and prints no result):

1. Device: the card's name, and name + power limit from nvidia-smi.
2. Build: compile `sivae_torch/csrc/*.cu` for sm_90a, print the build time.
3. Kernels against their plain PyTorch versions on the card, at every conv
   site of the spatial_1200 encode + decode path and the two sites only the
   input gradient sees (128->64 and 256->128), batch 2, plus odd shapes
   (conv 3->4 and 1->5, stencils with 5 channels), in fp32 (TF32 off) and
   bf16: the body the dispatch chose, max error, kernel / plain / library
   (`library_ms`, a yardstick only) times, and the roofline bound; for
   `conv3d_same` rows that the wgmma body takes, its block shape and the
   earlier mma.sync body's error and time on the same operands. Times are
   device times: the timed calls wait on the card behind other queued work,
   so a kernel shorter than its launch path is not timed by that path. The
   flagship sites of `conv3d_same`, `conv3d_to1` and `conv3d_from1` are also
   run at batch 8, the batch both main paths run, and the two stencils at
   C = 16 and 32. The fused conv +
   statistics kernel runs with and without its prologue at the flagship site
   (with it also at batch 8) and at two shapes whose tiles straddle (b, d)
   planes; its library yardstick is the unfused stage (elementwise prologue,
   cuDNN conv, two reductions). `conv3d_to1`, `conv3d_from1` and
   `conv3d_fused_stats` rows also name their body; the fused kernel's wgmma
   rows show the earlier mma.sync body's error and time beside it.
   fp32 tolerance 1e-4 * max(1, max|plain|) (reassociation over K <= 6912);
   bf16 tolerance 1e-2 * max(1, max|plain|) (one output rounding; the plain
   version takes the same bf16 inputs and accumulates in fp32); plane sums
   1e-3 * max(1, max|plain sum|) (fp32 sums of H*W rounded values in another
   order, a few of which differ by one rounding).
4. Gradients: each of the four differentiable wrappers (`conv3d_same`,
   `conv3d_to1`, `conv3d_from1`, `conv3d_stats`) at 64 channels, 80x96x80,
   batch 2: dx and dw on the card against fp32 autograd through the plain
   version on the same values. dx: the forward tolerances. dw sums 1.2e6
   products per element: fp32 1e-3, bf16 1e-2, of max(1, max|reference|).
5. The eval / CBIR path end to end at full width: spatial_1200 at 80x96x80,
   seeded random weights, 32 synthetic volumes (seed 7), all bf16. The main
   path runs once with the launch counters set to 0: encode every volume at
   batch 8, cosine-kNN retrieval (every fifth patient's volumes as queries),
   reconstruction report of every volume at batch 8. The counters must grow
   by exactly 8 conv3d + 1 from1 per encoded batch and 13 conv3d + 1 to1 +
   1 from1 per reconstructed batch. Then encode and reconstruct throughput
   over the same 4 full batches, 5 windows each (median, min, max). Then
   one volume in fp32 on the card (every conv through the kernels) against
   the same model and volume on the CPU (plain versions): relative error of
   mu and of the reconstruction <= 1e-3. A torch.profiler window over one
   batch through each entry point (encode, reconstruction report) prints
   device time by kernel and the idle share.
6. The fused stage (the path of the fused conv + statistics kernel, which is
   on no model path): at the flagship site, batch 8, bf16, with the counters
   at 0, one fused stage forward (prologue -> conv -> batch statistics from
   the plane sums) and one conv + statistics forward and backward through
   `conv3d_stats`; 3 launches expected. Both are held against the unfused
   stage in library calls and timed beside it.
7. Training at full width: spatial_1200 at 80x96x80, batch 8, bf16 compute,
   fp32 parameters, dropout on, default loss config, the first 8 synthetic
   volumes. One warm-up step; one step with the counters at 0 (155
   conv3d_same, 10 conv3d_to1, 12 conv3d_from1 launches expected, forward
   and backward together; conv3d_same's are also printed by site); 5 timed
   steps (median, min, max s/step, vol/s);
   the last step's metrics must be finite and `nan` unset; encoder and
   decoder parameters and both halves' BN running statistics must have
   moved; peak memory; one validation step with finite metrics; a
   torch.profiler window over one step. Then one fp32 step of `tiny_spatial`
   (no dropout, zero_noise, a fixed numpy noise batch) on the card through
   the kernels against the same step on the CPU through the plain versions:
   lossE and lossD within 1e-4 relative, both Adams' first moments within
   1e-3 * max|m| per tensor (max|m| not below 1e-2 of the model's largest:
   gradients that are zero in exact arithmetic hold cancellation noise).

8. The training entry point at full width (`sivae_torch/cli/train.py`,
   below its split): the z1200 preset (spatial_1200 at 80x96x80, bf16
   compute, batch 8), 24 synthetic volumes of seed 82, the CLI's seed, split
   by patient rank without scikit-learn (every third patient's volumes to
   validation: 16 train volumes, 2 steps an epoch, and 8 validation
   volumes). First the pipeline: one train epoch on the card and on the CPU
   must give the same bits (augmentation off), and a fixed affine resample of
   one volume on the card must match the CPU's within 1e-5. Then, with the
   counters at 0, 2 epochs with a checkpoint each: the run files must exist
   (2 CSV rows, 2 JSONL lines), every metric must be finite, and the launches
   must equal 4 train steps x (155, 10, 12) plus 2 validation steps x
   (54, 6, 3). A new trainer's `try_resume` must return epoch 1 with the
   state bit for bit as the fit left it. Printed: s/epoch, the loop's
   overhead over steps x the median step time, checkpoint bytes and save
   time, one aug-z1200 epoch with its augmentation time per batch, the
   checkpoint sweep and `run_health` over the 2 checkpoints (not gated),
   and a torch.profiler window over one epoch.

`--only kernels,grad,path,stage,train,trainer` runs a subset while working on
one phase; it ends with `{"ok": false, "partial": ...}`, never with the result.

The next-to-last line is the per-kernel JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

PEAK_BYTES = 3.35e12         # H100 SXM HBM3, bytes/s
# the card's peak FLOP/s for the inputs' type (published, dense): bf16 on the
# tensor cores; fp32 (TF32 off) outside them
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
REPEATS = 5                  # timed windows per end-to-end measurement

# (Ci, Co, (D, H, W)) of every 3x3x3 stride-1 conv of spatial_1200 encode +
# decode at 80x96x80 (decoder sites repeat encoder ones), the two sites that
# only the input gradient runs (the IO swap of 64->128 and 128->256), then
# two odd shapes
CONV_SITES = [
    (64, 64, (80, 96, 80)), (64, 64, (40, 48, 40)), (64, 128, (40, 48, 40)),
    (128, 128, (20, 24, 20)), (128, 256, (20, 24, 20)), (256, 256, (10, 12, 10)),
    (128, 64, (40, 48, 40)), (256, 128, (20, 24, 20)),
    (3, 4, (8, 10, 12)), (1, 5, (8, 10, 12)),
]
# decoder tail 64 -> 1 and encoder stem 1 -> 64, then an odd channel count
# (the stencils' scalar bodies)
SMALL_SITES = [(64, (80, 96, 80)), (5, (8, 10, 12))]
# the fused conv + statistics: the flagship site (a 128-voxel tile lies in
# one (b, d) plane: 96 * 80 = 60 * 128), and two whose tiles straddle planes
# (7 * 9 = 63 voxels a plane), one for each body
FUSED_SITES = [(64, 64, (80, 96, 80)), (64, 64, (6, 7, 9)), (3, 5, (6, 7, 9))]
FLAGSHIP = (64, (80, 96, 80))
FLAGSHIP_CONV = (64, 64, (80, 96, 80))
# bf16 only, (batch, C, grid), for both stencils: the decoder tail / encoder
# stem at the main paths' batch, and the other channel counts of their
# tensor-core bodies at a grid no patch divides
STENCIL_BF16_SITES = [(8, 64, (80, 96, 80)), (2, 32, (20, 23, 37)), (2, 16, (20, 23, 37))]
# bf16 only, (batch, Ci, Co, grid): the fused kernel with its prologue at the
# stage phase's batch
FUSED_BF16_SITES = [(8, 64, 64, (80, 96, 80))]
SLOPE = 0.2                  # the model's LeakyReLU
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_SUMS = 1e-3
TOL_DW = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
TRAIN_LAUNCHES = {"conv3d_same": 155, "conv3d_to1": 10, "conv3d_from1": 12,
                  "conv3d_fused_stats": 0}
REPLACES = {
    "conv3d_same": "sivae_tpu/kernels/conv3d.py:91",
    "conv3d_to1": "sivae_tpu/kernels/conv3d_small.py:180",
    "conv3d_from1": "sivae_tpu/kernels/conv3d_small.py:213",
    "conv3d_fused_stats": "sivae_tpu/kernels/conv3d_fused.py:213",
}
SOURCES = {
    "conv3d_same": "sivae_torch/csrc/conv3d.cu",
    "conv3d_to1": "sivae_torch/csrc/conv3d_small.cu",
    "conv3d_from1": "sivae_torch/csrc/conv3d_small.cu",
    "conv3d_fused_stats": "sivae_torch/csrc/conv3d_fused.cu",
}
# launches of one validation step (make_soft_intro_eval_step): 3 encodes
# (8 conv3d_same + 1 conv3d_from1 each) and 6 decodes (5 conv3d_same + 1
# conv3d_to1 each)
VAL_LAUNCHES = {"conv3d_same": 54, "conv3d_to1": 6, "conv3d_from1": 3, "conv3d_fused_stats": 0}
PHASES = ("kernels", "grad", "path", "stage", "train", "trainer")


def log(msg: str) -> None:
    print(msg, flush=True)


_BUSY_MS: list = []   # measured once: the time of one of the matrix products below


def _keep_device_busy(ms: float) -> None:
    """Queue about `ms` of unrelated device work (matrix products); their
    operand lives only for the call, so no phase's peak memory holds it."""
    a = torch.ones((4096, 4096), device="cuda", dtype=torch.bfloat16)
    if not _BUSY_MS:
        torch.mm(a, a)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            torch.mm(a, a)
        end.record()
        torch.cuda.synchronize()
        _BUSY_MS.append(start.elapsed_time(end) / 10)
    for _ in range(int(ms / _BUSY_MS[0]) + 1):
        torch.mm(a, a)


def time_ms(fn, reps: int) -> float:
    """Device time of one call. The timed calls are queued behind other device
    work that lasts longer than the host needs to queue them, so a kernel that
    is shorter than its launch path (Python wrapper, tensor maps, the launch) is
    timed on the card and not by that path."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3   # to queue one call
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _keep_device_busy(1.5 * reps * host_ms + 0.5)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def grid_name(sp) -> str:
    return "x".join(map(str, sp))


def _batch_tag(b: int) -> str:
    """Phase 3 runs at batch 2 unless a row says otherwise."""
    return "" if b == 2 else f" batch {b}"


# ---------------------------------------------------------------------------
# phases 1 and 2
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        raise SystemExit(f"chip_smoke: nvidia-smi failed: {smi.stderr}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return name, card


def phase_build():
    from sivae_torch.kernels import build

    t0 = time.perf_counter()
    path, nvcc_log = build.build()
    build.library()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("[ptxas] " + line.strip())


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def _compare(k: torch.Tensor, p: torch.Tensor, tol: float) -> tuple:
    err = (k.float() - p.float()).abs().max().item()
    scale = max(1.0, p.float().abs().max().item())
    return err, err / scale, err <= tol * scale


def _he(shape, fan_in, gen, dev, dtype):
    return (torch.randn(shape, generator=gen, device=dev) * math.sqrt(2.0 / fan_in)).to(dtype)


def unfused_stage(x, w_cl, in_a, in_b, slope):
    """The fused kernel's function in library calls: elementwise prologue,
    cuDNN conv, two reductions over (H, W). NDHWC x, OIDHW channels-last w."""
    if in_a is not None:
        x = F.leaky_relu(x.float() * in_a + in_b, slope).to(x.dtype)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w_cl, padding=1).permute(0, 2, 3, 4, 1)
    yf = y.float()
    return y, yf.sum(dim=(2, 3)), (yf * yf).sum(dim=(2, 3))


def phase_kernels(dev) -> dict:
    from sivae_torch.kernels import build
    from sivae_torch.kernels.conv3d import (conv3d_same, conv3d_same_body,
                                            conv3d_same_earlier_body, conv3d_same_plain,
                                            conv3d_same_wgmma_shape)
    from sivae_torch.kernels.conv3d_fused import (conv3d_fused_stats, conv3d_fused_stats_body,
                                                  conv3d_fused_stats_earlier_body,
                                                  conv3d_fused_stats_plain)
    from sivae_torch.kernels.conv3d_small import (conv3d_from1, conv3d_from1_body,
                                                  conv3d_from1_plain, conv3d_to1, conv3d_to1_body,
                                                  conv3d_to1_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    failures, rows = [], {}

    def run(name, site, dtype, kern, plain, lib_fn, nbytes, flops, numel, body="", earlier=None,
            note=""):
        """kern / plain return a tensor or a tuple (y, sums...); `earlier` is
        the body the dispatch's choice superseded, held to the same plain."""
        k = kern()
        torch.cuda.synchronize()
        p = plain()
        k, p = (k, p) if isinstance(k, tuple) else ((k,), (p,))
        err, rel, ok = _compare(k[0], p[0], TOL[dtype])
        sums = ""
        if earlier is not None:
            e = earlier()
            e = e if isinstance(e, tuple) else (e,)
            e_err, e_rel, e_ok = _compare(e[0], p[0], TOL[dtype])
            ok = ok and e_ok and all(_compare(es, ps, TOL_SUMS)[2] for es, ps in zip(e[1:], p[1:]))
            del e
        for ks, ps in zip(k[1:], p[1:]):
            s_err, s_rel, s_ok = _compare(ks, ps, TOL_SUMS)
            ok = ok and s_ok
            sums += f" sum_rel {s_rel:.2e}"
        del k, p
        reps = 5 if numel > 2e7 else 20
        ms = time_ms(kern, reps)
        plain_ms = time_ms(plain, max(2, reps // 5))
        lib_ms = time_ms(lib_fn, reps)
        b_ms, b_by = bound(nbytes, flops, PEAK_FLOPS[dtype])
        old = note
        if earlier is not None:
            old += f" | earlier body max_rel {e_rel:.3e} {time_ms(earlier, reps):.3f} ms"
        tag = f"{name} {site} {dtype_name(dtype)}"
        log(f"[kernel] {tag:52s} {body:5s} max_abs {err:.3e} max_rel {rel:.3e}{sums} "
            f"{'ok' if ok else 'FAIL'} | kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"library {lib_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}){old}")
        if not ok:
            failures.append(tag)
        rows[(name, site, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    for dtype in (torch.float32, torch.bfloat16):
        isz = 4 if dtype == torch.float32 else 2
        flagship8 = [(8,) + FLAGSHIP_CONV] if dtype == torch.bfloat16 else []
        for b, ci, co, sp in [(2,) + site for site in CONV_SITES] + flagship8:
            x = torch.randn((b,) + sp + (ci,), generator=gen, device=dev).to(dtype)
            w = _he((3, 3, 3, ci, co), 27 * ci, gen, dev, dtype)
            x_cl = x.permute(0, 4, 1, 2, 3)                    # NCDHW view, channels_last_3d
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            n_vox = b * sp[0] * sp[1] * sp[2]
            body = conv3d_same_body(x, w, torch.empty((b,) + sp + (co,), dtype=dtype, device=dev))
            blocks = ""
            if body == "wgmma":
                shape = conv3d_same_wgmma_shape(x, co)
                blocks = f" | blocks {128 * (shape // 10)}x{64 * (shape % 10)}"
            run("conv3d_same", f"{ci}->{co}@{grid_name(sp)}" + _batch_tag(b), dtype,
                lambda: conv3d_same(x, w), lambda: conv3d_same_plain(x, w),
                lambda: F.conv3d(x_cl, w_cl, padding=1),
                (x.numel() + w.numel() + n_vox * co) * isz, 2.0 * n_vox * 27 * ci * co,
                x.numel(), body,
                (lambda: conv3d_same_earlier_body(x, w)) if body == "wgmma" else None, blocks)

        to1_more = STENCIL_BF16_SITES if dtype == torch.bfloat16 else []
        for b, c, sp in [(2,) + site for site in SMALL_SITES] + to1_more:
            n_vox = b * sp[0] * sp[1] * sp[2]
            x = torch.randn((b,) + sp + (c,), generator=gen, device=dev).to(dtype)
            w = _he((3, 3, 3, c, 1), 27 * c, gen, dev, dtype)
            x_cl = x.permute(0, 4, 1, 2, 3)
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous()
            run("conv3d_to1", f"{c}->1@{grid_name(sp)}" + _batch_tag(b), dtype,
                lambda: conv3d_to1(x, w), lambda: conv3d_to1_plain(x, w),
                lambda: F.conv3d(x_cl, w_cl, padding=1),
                (x.numel() + w.numel() + n_vox) * isz, 2.0 * n_vox * 27 * c, x.numel(),
                conv3d_to1_body(x))

        from1_more = STENCIL_BF16_SITES if dtype == torch.bfloat16 else []
        for b, c, sp in [(2,) + site for site in SMALL_SITES] + from1_more:
            n_vox = b * sp[0] * sp[1] * sp[2]
            x = torch.randn((b,) + sp + (1,), generator=gen, device=dev).to(dtype)
            w = _he((3, 3, 3, 1, c), 27, gen, dev, dtype)
            x_cl = x.permute(0, 4, 1, 2, 3)
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous()
            run("conv3d_from1", f"1->{c}@{grid_name(sp)}" + _batch_tag(b), dtype,
                lambda: conv3d_from1(x, w), lambda: conv3d_from1_plain(x, w),
                lambda: F.conv3d(x_cl, w_cl, padding=1),
                (x.numel() + w.numel() + n_vox * c) * isz, 2.0 * n_vox * 27 * c, x.numel(),
                conv3d_from1_body(x, c))

        fused_more = FUSED_BF16_SITES if dtype == torch.bfloat16 else []
        for b, ci, co, sp in [(2,) + site for site in FUSED_SITES] + fused_more:
            n_vox = b * sp[0] * sp[1] * sp[2]
            x = torch.randn((b,) + sp + (ci,), generator=gen, device=dev).to(dtype)
            w = _he((3, 3, 3, ci, co), 27 * ci, gen, dev, dtype)
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            # the previous BN folded to an affine, with a shift well off 0 so
            # that padding before the prologue would show
            in_a = 0.5 + torch.rand(ci, generator=gen, device=dev)
            in_b = 0.3 + 0.3 * torch.rand(ci, generator=gen, device=dev)
            body = conv3d_fused_stats_body(x, w)
            for pro in (False, True) if b == 2 else (True,):
                a_, b_ = (in_a, in_b) if pro else (None, None)
                # bytes: x, w, y once each, the two (B, D, Co) fp32 sums, a and b
                nbytes = ((x.numel() + w.numel() + n_vox * co) * isz
                          + 2 * b * sp[0] * co * 4 + (2 * ci * 4 if pro else 0))
                # operations: the conv's, the prologue's 3 per input value,
                # the statistics' 3 per output value
                flops = (2.0 * n_vox * 27 * ci * co + (3.0 * x.numel() if pro else 0.0)
                         + 3.0 * n_vox * co)
                run("conv3d_fused_stats",
                    f"{ci}->{co}@{grid_name(sp)}{' prologue' if pro else ''}" + _batch_tag(b),
                    dtype, lambda: conv3d_fused_stats(x, w, a_, b_, SLOPE),
                    lambda: conv3d_fused_stats_plain(x, w, a_, b_, SLOPE),
                    lambda: unfused_stage(x, w_cl, a_, b_, SLOPE), nbytes, flops, x.numel(),
                    body, (lambda: conv3d_fused_stats_earlier_body(x, w, a_, b_, SLOPE))
                    if body == "wgmma" else None)

    if failures:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failures}")
    build.reset_launches()  # comparison launches do not count for the main path
    return rows


# ---------------------------------------------------------------------------
# phase 4: the four gradients against autograd through the plain versions
# ---------------------------------------------------------------------------


def phase_gradients(dev) -> None:
    from sivae_torch.kernels import build
    from sivae_torch.kernels.conv3d import conv3d_same, conv3d_same_plain
    from sivae_torch.kernels.conv3d_fused import conv3d_stats
    from sivae_torch.kernels.conv3d_small import (conv3d_from1, conv3d_from1_plain, conv3d_to1,
                                                  conv3d_to1_plain)

    def stats_plain(x, w):
        y = conv3d_same_plain(x, w)
        return y, y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))

    c, sp = FLAGSHIP
    b = 2
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [("conv3d_same", conv3d_same, conv3d_same_plain, c, c),
             ("conv3d_to1", conv3d_to1, conv3d_to1_plain, c, 1),
             ("conv3d_from1", conv3d_from1, conv3d_from1_plain, 1, c),
             ("conv3d_stats", conv3d_stats, stats_plain, c, c)]
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, fn, plain, ci, co in cases:
            x = torch.randn((b,) + sp + (ci,), generator=gen, device=dev).to(dtype)
            w = _he((3, 3, 3, ci, co), 27 * ci, gen, dev, dtype)
            cot = [torch.randn((b,) + sp + (co,), generator=gen, device=dev).to(dtype)]
            if name == "conv3d_stats":  # cotangents of the two plane sums, fp32
                cot += [torch.randn((b, sp[0], co), generator=gen, device=dev),
                        1e-2 * torch.randn((b, sp[0], co), generator=gen, device=dev)]
            xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
            out = fn(xk, wk)
            out = out if isinstance(out, tuple) else (out,)
            dx, dw = torch.autograd.grad(out, (xk, wk), cot)
            torch.cuda.synchronize()
            del out
            # the reference: fp32 autograd through the plain version on the
            # same (possibly bf16-rounded) values
            xp, wp = x.float().requires_grad_(), w.float().requires_grad_()
            ref = plain(xp, wp)
            ref = ref if isinstance(ref, tuple) else (ref,)
            dx_p, dw_p = torch.autograd.grad(ref, (xp, wp), [g.float() for g in cot])
            del ref
            ex, rx, okx = _compare(dx, dx_p, TOL[dtype])
            ew, rw, okw = _compare(dw, dw_p, TOL_DW[dtype])
            ok = okx and okw and dx.dtype == dtype and dw.dtype == dtype
            tag = f"{name} {ci}->{co}@{grid_name(sp)} {dtype_name(dtype)}"
            log(f"[grad] {tag:44s} dx max_abs {ex:.3e} max_rel {rx:.3e} | dw max_abs {ew:.3e} "
                f"max_rel {rw:.3e} (max|dw| {dw_p.abs().max().item():.3e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(tag)
            del dx, dw, dx_p, dw_p, xp, wp, xk, wk
    if failures:
        raise SystemExit(f"chip_smoke: gradients disagree with the plain versions': {failures}")
    build.reset_launches()


# ---------------------------------------------------------------------------
# phase 5: the eval / CBIR path end to end
# ---------------------------------------------------------------------------


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def synthetic_volumes(dev, n_vol: int = 32):
    """(source, preprocessed volumes (n, 1, D, H, W) fp32 on the card)."""
    from sivae_torch.data.pipeline import BrainDataSource
    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.data.synthetic import SyntheticBrainSource
    from sivae_torch.models.registry import get_model_config

    shape = get_model_config("spatial_1200").input_shape
    src = BrainDataSource(list(SyntheticBrainSource(n_vol, shape, seed=7)))
    return src, preprocess_batch(torch.from_numpy(src.voxels).to(dev))


def phase_path(dev, src, vox) -> dict:
    import numpy as np

    from sivae_torch.eval.latent_probe import encode_dataset
    from sivae_torch.eval.recon_quality import reconstruction_report
    from sivae_torch.eval.retrieval import retrieval_precision_at_k
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.models.resnet_vae import reparameterize

    cfg32 = get_model_config("spatial_1200")
    cfg = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    batch, n_vol = 8, vox.shape[0]
    model = make_model(cfg, device=dev, seed=0)
    # fold 4 of 5 by patient, without scikit-learn (not on every card's
    # machine): the volumes of every fifth patient id are the queries
    pids = sorted(set(src.pids))
    is_val = np.array([pids.index(p) % 5 == 4 for p in src.pids])
    vid, tid = np.flatnonzero(is_val), np.flatnonzero(~is_val)
    log(f"[path] spatial_1200 {cfg.input_shape} bf16, {n_vol} volumes in {n_vol // batch} "
        f"full batches of {batch}; retrieval {len(vid)} queries against {len(tid)}")

    # warm-up of both paths (cuDNN plans the transposed convs on first use);
    # its launches are not counted
    encode_dataset(model, vox[:batch], batch_size=batch)
    reconstruction_report(model, vox[:batch], batch_size=batch)
    torch.cuda.synchronize()

    # the main path, counted: encode every volume, retrieve, reconstruct
    # every volume with its report
    n_b = n_vol // batch
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    z = encode_dataset(model, vox, batch_size=batch)
    torch.cuda.synchronize()
    enc_counts = dict(build.launches)
    p_at_k = retrieval_precision_at_k(z[vid], src.labels[vid], z[tid], src.labels[tid], k=10,
                                      device=dev)
    report = reconstruction_report(model, vox, batch_size=batch)
    torch.cuda.synchronize()
    counts = dict(build.launches)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    rec_counts = {k: counts[k] - enc_counts[k] for k in counts}
    want = {"conv3d_same": 8 * n_b, "conv3d_to1": 0, "conv3d_from1": n_b,
            "conv3d_fused_stats": 0}
    if enc_counts != want:
        raise SystemExit(f"chip_smoke: encode launches {enc_counts}, expected {want}")
    want = {"conv3d_same": 13 * n_b, "conv3d_to1": n_b, "conv3d_from1": n_b,
            "conv3d_fused_stats": 0}
    if rec_counts != want:
        raise SystemExit(f"chip_smoke: reconstruct launches {rec_counts}, expected {want}")

    if not (np.all(np.isfinite(z)) and z.shape == (n_vol, cfg.latent_dim)):
        raise SystemExit(f"chip_smoke: bad latents {z.shape}")
    if not (all(math.isfinite(v) for v in report.values()) and report["n"] == n_vol):
        raise SystemExit(f"chip_smoke: bad report {report}")
    report["retrieval_p_at_k"] = p_at_k
    log(f"[path] launches encode {enc_counts} reconstruct {rec_counts}; "
        f"peak memory {peak_gib:.2f} GiB")
    log(f"[path] report {json.dumps(report)}")

    # throughput: REPEATS windows of each over the same full batches (the
    # host reads the latents / the report at the end of each window)
    for what, fn in (("encode", lambda: encode_dataset(model, vox, batch_size=batch)),
                     ("reconstruct", lambda: reconstruction_report(model, vox,
                                                                   batch_size=batch))):
        rates = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rates.append(n_vol / (time.perf_counter() - t0))
        rates.sort()
        log(f"[path] {what} {n_vol} vols x {REPEATS} windows: median "
            f"{rates[REPEATS // 2]:.2f} vol/s, min {rates[0]:.2f}, max {rates[-1]:.2f}")

    x8 = vox[:batch]
    profile_window(f"encode of {batch} volumes",
                   lambda: encode_dataset(model, x8, batch_size=batch))
    profile_window(f"reconstruction report of {batch} volumes",
                   lambda: reconstruction_report(model, x8, batch_size=batch))

    # kernel path (fp32, TF32 off, card) against the plain path (CPU)
    model32 = make_model(cfg32, device=dev, seed=0)
    x1 = vox[:1]
    with torch.no_grad():
        mu_k, lv_k = model32.encode(x1)
        rec_k = model32.decode(reparameterize(mu_k, lv_k, val_eps=0.1))
        torch.cuda.synchronize()
        cpu_model = copy.deepcopy(model32).to("cpu")
        x1c = x1.cpu()
        t0 = time.perf_counter()
        mu_p, lv_p = cpu_model.encode(x1c)
        rec_p = cpu_model.decode(reparameterize(mu_p, lv_p, val_eps=0.1))
        t_cpu = time.perf_counter() - t0
    e_mu, e_rec = _rel(mu_k, mu_p), _rel(rec_k, rec_p)
    log(f"[path] fp32 kernels vs plain (CPU, {t_cpu:.1f} s): mu rel {e_mu:.3e}, "
        f"reconstruction rel {e_rec:.3e} (limit 1e-3)")
    if not (e_mu <= 1e-3 and e_rec <= 1e-3):
        raise SystemExit("chip_smoke: kernel path disagrees with the plain path")
    return {k: enc_counts[k] + rec_counts[k] for k in enc_counts}


def profile_window(what: str, fn, top: int = 10) -> None:
    """Device time by kernel (torch.profiler) over one call of `fn`, the
    device's idle share of the window (the profiler's own overhead is in
    the window), the launch count, and every library convolution kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type ==
               torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        log(f"[profile] {what}: no device time recorded: not measured")
        return
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}, "
        f"{sum(e.count for e in kernels)} kernel launches")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:top]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x "
            f"{100 * e.self_device_time_total / busy_us:5.1f}%  {e.key[:110]}")
    marks = ("cudnn", "xmma", "cutlass", "wgrad", "dgrad", "fprop", "implicit_gemm", "convolve")
    for e in ranked[top:]:
        if "sivae::" in e.key:
            log(f"[profile] (port kernel)  {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:4d}x  {e.key[:110]}")
        elif any(m in e.key.lower() for m in marks):
            log(f"[profile] (library conv) {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:4d}x  {e.key[:110]}")


# ---------------------------------------------------------------------------
# phase 6: the fused stage, the path of the fused conv + statistics kernel
# ---------------------------------------------------------------------------


def phase_stage(dev) -> dict:
    """One fused stage forward and one conv + statistics forward + backward
    at the flagship site, batch 8, bf16, counted, each beside the same stage
    in library calls (the yardstick, not a gate on speed)."""
    from sivae_torch.kernels import build
    from sivae_torch.kernels.conv3d_fused import conv3d_fused_stats, conv3d_stats

    c, sp = FLAGSHIP
    b, dtype, eps = 8, torch.bfloat16, 1e-5
    n = b * sp[0] * sp[1] * sp[2]
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((b,) + sp + (c,), generator=gen, device=dev).to(dtype)
    w = _he((3, 3, 3, c, c), 27 * c, gen, dev, dtype)
    w_cl = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    in_a = 0.8 + 0.4 * torch.rand(c, generator=gen, device=dev)
    in_b = 0.05 * torch.randn(c, generator=gen, device=dev)

    def moments(s1, s2):
        mean = s1.sum(dim=(0, 1)) / n
        return mean, s2.sum(dim=(0, 1)) / n - mean * mean

    def fused_stage():
        y, s1, s2 = conv3d_fused_stats(x, w, in_a, in_b, SLOPE)
        return (y,) + moments(s1, s2)

    def library_stage():
        y, s1, s2 = unfused_stage(x, w_cl, in_a, in_b, SLOPE)
        return (y,) + moments(s1, s2)

    def stage_loss(y, s1, s2):
        mean, var = moments(s1, s2)
        yn = (y.float() - mean) * torch.rsqrt(var + eps)
        return (F.leaky_relu(yn, SLOPE) ** 2).sum()

    def fused_grad():
        xk, wk = x.detach().requires_grad_(), w.detach().requires_grad_()
        return torch.autograd.grad(stage_loss(*conv3d_stats(xk, wk)), (xk, wk))

    def library_grad():
        xk, wk = x.detach().requires_grad_(), w_cl.detach().requires_grad_()
        y = F.conv3d(xk.permute(0, 4, 1, 2, 3), wk, padding=1).permute(0, 2, 3, 4, 1)
        yf = y.float()
        dx, dw = torch.autograd.grad(
            stage_loss(y, yf.sum(dim=(2, 3)), (yf * yf).sum(dim=(2, 3))), (xk, wk))
        return dx, dw.permute(2, 3, 4, 1, 0)  # OIDHW -> DHWIO

    fused_stage()
    fused_grad()
    torch.cuda.synchronize()  # warm-up, not counted

    build.reset_launches()
    y, mean, var = fused_stage()
    dx, dw = fused_grad()
    torch.cuda.synchronize()
    counts = dict(build.launches)
    want = {"conv3d_same": 0, "conv3d_to1": 0, "conv3d_from1": 0, "conv3d_fused_stats": 3}
    if counts != want:
        raise SystemExit(f"chip_smoke: stage launches {counts}, expected {want}")

    y_l, mean_l, var_l = library_stage()
    dx_l, dw_l = library_grad()
    # the gradients are held to their plain versions in the gradient phase;
    # here they only have to be the library's up to bf16's handling of dy: the
    # Function receives gy already rounded to bf16 and then adds the sums'
    # cotangents, the library path adds all three in fp32 and rounds once, and
    # the three nearly cancel (the loss normalizes y), so 5e-2 of the largest
    checks = {"y": _compare(y, y_l, TOL[dtype]), "mean": _compare(mean, mean_l, TOL_SUMS),
              "var": _compare(var, var_l, TOL_SUMS), "dx": _compare(dx, dx_l, 5e-2),
              "dw": _compare(dw, dw_l, 5e-2)}
    finite = all(torch.isfinite(t.float()).all().item() for t in (y, mean, var, dx, dw))
    log("[stage] fused vs library stage, 64->64@80x96x80 batch 8 bf16: " + ", ".join(
        f"{k} max_rel {v[1]:.2e}" for k, v in checks.items()) + f"; launches {counts}")
    if not finite or not all(v[2] for v in checks.values()):
        raise SystemExit(f"chip_smoke: the fused stage disagrees with the library stage: {checks}")
    del y, dx, dw, y_l, dx_l, dw_l

    t = {"fused stage": time_ms(fused_stage, 5), "library stage": time_ms(library_stage, 5),
         "fused stage grad": time_ms(fused_grad, 3), "library stage grad": time_ms(library_grad, 3)}
    log("[stage] " + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    build.reset_launches()
    return counts


# ---------------------------------------------------------------------------
# phase 7: the two-phase train step
# ---------------------------------------------------------------------------


def _metrics_line(metrics) -> dict:
    return {k: (bool(v) if v.dtype == torch.bool else float(v)) for k, v in metrics.items()}


def phase_train(dev, real) -> dict:
    import numpy as np

    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.kernels import build
    from sivae_torch.models.blocks import BatchNorm
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.train.state import create_train_state, param_count
    from sivae_torch.train.step import make_soft_intro_eval_step, make_soft_intro_train_step

    cfg = dataclasses.replace(get_model_config("spatial_1200"), dtype=torch.bfloat16)
    batch = real.shape[0]
    model = make_model(cfg, device=dev, seed=0)
    state = create_train_state(model, seed=0, optim_cfg=OptimConfig())
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape)
    log(f"[train] spatial_1200 {cfg.input_shape} batch {batch} bf16 compute, fp32 parameters "
        f"({param_count(state)}), dropout on")

    def snapshot():
        out = {}
        for half in ("encoder", "decoder"):
            mod = getattr(model, half)
            out[half + " parameters"] = [p.detach().clone() for p in mod.parameters()]
            out[half + " BN running statistics"] = [
                t.clone() for m in mod.modules() if isinstance(m, BatchNorm)
                for t in (m.running_mean, m.running_var)]
        return out

    before = snapshot()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step(state, real)  # warm-up: cuDNN picks its weight-gradient algorithms
    torch.cuda.synchronize()
    log(f"[train] warm-up step {time.perf_counter() - t0:.2f} s")

    build.reset_launches()
    step(state, real)
    torch.cuda.synchronize()
    counts = dict(build.launches)
    log(f"[train] launches in one step {counts}")
    log(f"[train] conv3d_same launches by site {json.dumps(build.conv3d_same_sites)}")
    if counts != TRAIN_LAUNCHES:
        raise SystemExit(f"chip_smoke: train-step launches {counts}, expected {TRAIN_LAUNCHES}")

    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, real)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    median = times[REPEATS // 2]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[train] {REPEATS} steps: median {median:.4f} s/step, min {times[0]:.4f}, "
        f"max {times[-1]:.4f}; {batch / median:.2f} vol/s; peak memory {peak_gib:.2f} GiB")
    m = _metrics_line(metrics)
    log(f"[train] step {state.step} metrics {json.dumps(m)}")
    if m["nan"] or not all(math.isfinite(v) for k, v in m.items() if k != "nan"):
        raise SystemExit(f"chip_smoke: train metrics not finite: {m}")
    after = snapshot()
    for what in before:
        moved = sum(not torch.equal(p, q) for p, q in zip(before[what], after[what]))
        log(f"[train] {moved} of {len(before[what])} {what} tensors changed")
        # a conv bias that feeds a BN has a gradient of rounding noise, which
        # may come out exactly 0: the stem's bias of either half may stay
        if moved < len(before[what]) - ("parameters" in what):
            raise SystemExit(f"chip_smoke: only {moved} of {len(before[what])} {what} changed")
    del before, after

    eval_step = make_soft_intro_eval_step(model, SoftIntroLossConfig(), cfg.input_shape)
    em = _metrics_line(eval_step(state, real, torch.Generator(device=dev).manual_seed(1)))
    log(f"[train] validation step metrics {json.dumps(em)}")
    if not all(math.isfinite(v) for v in em.values()):
        raise SystemExit(f"chip_smoke: validation metrics not finite: {em}")

    profile_window(f"train step, batch {batch}", lambda: step(state, real), top=25)
    del state, step, eval_step, model
    torch.cuda.empty_cache()

    # one fp32 step through the kernels (card) against the plain versions (CPU)
    tiny = get_model_config("tiny_spatial")
    tiny = dataclasses.replace(tiny, act=tiny.act.with_no_dropout())
    rng = np.random.RandomState(11)
    real_t = torch.from_numpy(rng.rand(4, 1, *tiny.input_shape).astype(np.float32))
    fixed = rng.randn(4, tiny.latent_dim).astype(np.float32)
    done = {}
    for where in (dev, torch.device("cpu")):
        m_t = make_model(tiny, device=where, seed=3)
        s_t = create_train_state(m_t, seed=0)
        f_t = make_soft_intro_train_step(m_t, SoftIntroLossConfig(), OptimConfig(), 1,
                                         tiny.input_shape, zero_noise=True, fixed_noise=fixed)
        build.reset_launches()
        _, met = f_t(s_t, real_t.to(where))
        names = {p: k for k, p in m_t.named_parameters()}
        moments = {names[p]: s["exp_avg"].detach().cpu()
                   for opt in (s_t.opt_e, s_t.opt_d) for p, s in opt.state.items()}
        done[where.type] = (_metrics_line(met), moments, dict(build.launches))
    (m_k, mom_k, n_k), (m_p, mom_p, n_p) = done["cuda"], done["cpu"]
    if n_k["conv3d_same"] == 0 or any(n_p.values()):
        raise SystemExit(f"chip_smoke: fp32 step launches card {n_k} CPU {n_p}")
    # per tensor, 1e-3 of its largest moment; a tensor whose gradient is zero
    # or nearly so in exact arithmetic (a conv bias or a 1-channel conv weight
    # in front of a BN, which cancels shift and scale; the zero-initialised
    # logvar head under zero_noise) holds only cancellation noise, so the
    # scale has a floor of 1e-2 of the largest moment in the model
    floor = 1e-2 * max(m.abs().max().item() for m in mom_p.values())
    bad, worst, floored = [], (0.0, ""), []
    for k, want in mom_p.items():
        scale = want.abs().max().item()
        if scale < floor:
            floored.append(k)
        rel = (mom_k[k] - want).abs().max().item() / max(scale, floor)
        worst = max(worst, (rel, k))
        if rel > 1e-3:
            bad.append((k, rel))
    rel_e = abs(m_k["lossE"] - m_p["lossE"]) / abs(m_p["lossE"])
    rel_d = abs(m_k["lossD"] - m_p["lossD"]) / abs(m_p["lossD"])
    log(f"[train] fp32 tiny_spatial step, kernels (card) vs plain (CPU): lossE rel {rel_e:.2e}, "
        f"lossD rel {rel_d:.2e} (limit 1e-4); first moments of {len(mom_p)} tensors worst "
        f"{worst[0]:.2e} of max|m| at {worst[1]} (limit 1e-3); held to the floor {floor:.2e}: "
        f"{floored}; card launches {n_k}")
    if rel_e > 1e-4 or rel_d > 1e-4 or bad or len(floored) > 6:
        raise SystemExit(f"chip_smoke: the card's fp32 step disagrees with the CPU's: {bad}")
    build.reset_launches()
    return counts


# ---------------------------------------------------------------------------
# phase 8: the training entry point
# ---------------------------------------------------------------------------


def _state_tensors(state) -> dict:
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for name in ("opt_e", "opt_d"):
        for i, st in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}/{i}/{k}": torch.as_tensor(v) for k, v in st.items()})
    out["generator"] = state.generator.get_state()
    out["step"] = torch.tensor(state.step)
    return {k: v.detach().cpu() for k, v in out.items()}


def phase_trainer(dev) -> dict:
    import os
    import tempfile

    import numpy as np

    from sivae_torch.cli import train as cli_train
    from sivae_torch.config import OptimConfig
    from sivae_torch.data.augment import _affine_resample, _rotation_matrix
    from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.eval.sweep import run_health, sweep_checkpoints
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.train.loop import SoftIntroTrainer
    from sivae_torch.utils.checkpoint import CheckpointManager

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_")
    run_dir = os.path.join(tmp.name, "z1200")
    common = ["--synthetic", "24", "--batch", "8", "--device", str(dev)]
    args = cli_train.parse_args(["--preset", "z1200", "--epochs", "2", "--run-dir", run_dir]
                                + common)
    shape = get_model_config("spatial_1200").input_shape
    t0 = time.perf_counter()
    src = BrainDataSource(cli_train.load_records(args, shape))
    pids = sorted(set(src.pids))
    is_val = np.array([pids.index(p) % 3 == 2 for p in src.pids])
    train_src, val_src = src.subset(np.flatnonzero(~is_val)), src.subset(np.flatnonzero(is_val))
    log(f"[trainer] z1200 preset, spatial_1200 {shape} bf16 batch 8: {len(src)} synthetic "
        f"volumes (seed 82, {time.perf_counter() - t0:.1f} s to make), {len(train_src)} train "
        f"/ {len(val_src)} validation by patient rank")

    # the pipeline on the card against the CPU, and the resample
    epochs = {d: [v.cpu() for v, _ in DataPipeline(train_src, 8, device=d, seed=103).epoch(0)]
              for d in (dev, "cpu")}
    same = len(epochs[dev]) == 2 and all(torch.equal(a, b) for a, b in
                                         zip(epochs[dev], epochs["cpu"]))
    x = epochs["cpu"][0][:1, 0]
    inv = _rotation_matrix(torch.deg2rad(torch.tensor([8.0, -5.0, 10.0]))).T / \
        torch.tensor([1.05, 0.95, 1.0])[None, :]
    shift = torch.tensor([1.5, -2.0, 0.5])
    err = (_affine_resample(x.to(dev), inv, shift).cpu() - _affine_resample(x, inv, shift)
           ).abs().max().item()
    log(f"[trainer] pipeline epoch card vs CPU bit-identical: {same}; affine resample card vs "
        f"CPU max_abs {err:.2e} (limit 1e-5)")
    if not same or err > 1e-5:
        raise SystemExit("chip_smoke: the pipeline on the card disagrees with the CPU's")
    del epochs

    # the main path: 2 epochs through the CLI's code below its split. The fit
    # draws no panels wherever it runs, as on the card's machine, which has no
    # matplotlib: its import fails here too, and the trainer skips the figures
    sys.modules["matplotlib"] = None
    build.reset_launches()
    t0 = time.perf_counter()
    trainer = cli_train.train_on_split(args, train_src, val_src)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = dict(build.launches)
    want = {k: 4 * TRAIN_LAUNCHES[k] + 2 * VAL_LAUNCHES[k] for k in TRAIN_LAUNCHES}
    log(f"[trainer] fit of 2 epochs {fit_s:.2f} s; launches {counts} (expected {want})")
    if counts != want:
        raise SystemExit(f"chip_smoke: trainer launches {counts}, expected {want}")

    with open(os.path.join(run_dir, "train_result.csv")) as f:
        rows = f.read().splitlines()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f.read().splitlines()]
    files = ["args.json", "train_result.csv", "metrics.jsonl", "loss.txt", "kl_losses.txt"]
    missing = [n for n in files if not os.path.exists(os.path.join(run_dir, n))]
    hist = trainer.logger.history
    finite = all(math.isfinite(v) for vals in hist.values() for v in vals)
    steps = trainer.ckpt.all_steps()
    log(f"[trainer] run files present {not missing}, {len(rows) - 1} CSV rows, {len(records)} "
        f"JSONL lines, checkpoints {steps}; last epoch {json.dumps(records[-1])}")
    if missing or len(rows) != 3 or len(records) != 2 or not finite or steps != [0, 1]:
        raise SystemExit(f"chip_smoke: bad run output: missing {missing}, {len(rows)} CSV lines, "
                         f"{len(records)} JSONL lines, finite {finite}, checkpoints {steps}")
    epoch_s = records[1]["time"] - records[0]["time"]

    # resume: a new trainer picks the state up bit for bit
    end = _state_tensors(trainer.state)
    again = SoftIntroTrainer(make_model(trainer.model_cfg, device=dev), trainer.loss_cfg,
                             OptimConfig(), trainer.train_cfg, run_dir=run_dir,
                             steps_per_epoch=2)
    resumed = again.try_resume()
    got = _state_tensors(again.state)
    equal = set(got) == set(end) and all(torch.equal(got[k], end[k]) for k in end)
    log(f"[trainer] try_resume -> epoch {resumed}; state bit-identical to the fit's end over "
        f"{len(end)} tensors: {equal}")
    if resumed != 1 or not equal:
        raise SystemExit("chip_smoke: the resumed state differs from the saved one")
    del again, got, end

    # the loop's cost beside its steps
    train, val = cli_train.build_pipelines(args, train_src, val_src)
    vox, _ = train.first_batch()
    step_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._step(trainer.state, vox)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    median = sorted(step_s)[1]
    val_gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._eval(trainer.state, vox, val_gen)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    side = CheckpointManager(os.path.join(tmp.name, "timed"))
    t0 = time.perf_counter()
    side.save(0, trainer.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = os.path.getsize(side.path(0))
    log(f"[trainer] epoch 1 (2 train steps, 1 validation step, checkpoint, logs) "
        f"{epoch_s:.3f} s/epoch; median step {median:.4f} s (of {len(step_s)}); loop overhead "
        f"over 2 x median {epoch_s - 2 * median:.3f} s, of which validation step "
        f"{val_s:.3f} s, checkpoint save {save_ms / 1e3:.3f} s, the rest (pipeline, sums, "
        f"logs) {epoch_s - 2 * median - val_s - save_ms / 1e3:.3f} s; checkpoint {nbytes} "
        f"bytes ({nbytes / 1e6:.1f} MB)")

    def one_epoch():
        trainer.train_epoch(train, 2)
        trainer.eval_epoch(val, 2)
        side.save(1, trainer.state)

    profile_window("trainer epoch (2 train steps, 1 validation step, checkpoint)", one_epoch)

    # the checkpoint sweep and the health criterion (printed, not gated)
    val_vox = preprocess_batch(torch.from_numpy(val_src.voxels).to(dev))
    sweep = sweep_checkpoints(make_model(trainer.model_cfg, device=dev), val_vox,
                              ckpt_dir=trainer.ckpt.directory, batch_size=8)
    log(f"[trainer] sweep {json.dumps(sweep)}")
    log(f"[trainer] run_health {json.dumps(run_health(sweep))}")
    del trainer, train, val, vox, val_vox
    torch.cuda.empty_cache()

    # one aug-z1200 epoch, and its augmentation alone per batch
    aug_args = cli_train.parse_args(["--preset", "aug-z1200", "--epochs", "1", "--run-dir",
                                     os.path.join(tmp.name, "aug")] + common)
    t0 = time.perf_counter()
    aug_trainer = cli_train.train_on_split(aug_args, train_src, val_src)
    torch.cuda.synchronize()
    aug_s = time.perf_counter() - t0
    augment = cli_train.make_augment_fn(cli_train.PRESETS["aug-z1200"]["augment"])
    raw = torch.from_numpy(train_src.voxels[:8]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    aug_ms = time_ms(lambda: augment(gen, raw), 5)
    finite = all(math.isfinite(v[0]) for v in aug_trainer.logger.history.values())
    log(f"[trainer] aug-z1200 epoch (with the model's build) {aug_s:.2f} s, metrics finite "
        f"{finite}; random affine of a batch of 8 {aug_ms:.3f} ms")
    if not finite:
        raise SystemExit("chip_smoke: aug-z1200 epoch metrics not finite")
    del aug_trainer, raw
    torch.cuda.empty_cache()
    tmp.cleanup()
    build.reset_launches()
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    if any(p not in PHASES for p in only):
        ap.error(f"--only takes {PHASES}")
    want = set(only or PHASES)

    name, card = phase_device()
    from sivae_torch.utils.device import resolve_device

    dev = resolve_device("cuda")  # also turns TF32 off for the fp32 checks
    phase_build()
    rows = phase_kernels(dev) if "kernels" in want else {}
    if "grad" in want:
        phase_gradients(dev)
    src, vox = synthetic_volumes(dev) if want & {"path", "train"} else (None, None)
    path_n = phase_path(dev, src, vox) if "path" in want else {}
    stage_n = phase_stage(dev) if "stage" in want else {}
    train_n = phase_train(dev, vox[:8]) if "train" in want else {}
    del src, vox
    trainer_n = phase_trainer(dev) if "trainer" in want else {}
    log(card)
    if only:
        print(json.dumps({"ok": False, "partial": only}))
        return 0

    flag = f"{FLAGSHIP[0]}->{{}}@{grid_name(FLAGSHIP[1])}"
    head = {"conv3d_same": flag.format(64), "conv3d_to1": flag.format(1),
            "conv3d_from1": f"1->64@{grid_name(FLAGSHIP[1])}",
            "conv3d_fused_stats": flag.format(64) + " prologue"}
    kernels = []
    for kname, site in head.items():
        r = rows[(kname, site, torch.bfloat16)]
        per_path = {"eval_path": path_n[kname], "fused_stage": stage_n[kname],
                    "train_step": train_n[kname], "trainer": trainer_n[kname]}
        launches = sum(per_path.values())
        if launches == 0:
            raise SystemExit(f"chip_smoke: no counted path launched {kname}")
        kernels.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                        "replaces": REPLACES[kname], "launches": launches,
                        "launches_by_path": per_path,
                        "max_abs_err": max(v["max_abs_err"] for k, v in rows.items()
                                           if k[0] == kname),
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "site": f"{site} batch 2 bf16"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
