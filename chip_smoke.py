"""GPU smoke run of the PyTorch + CUDA port (`sivae_torch`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; fails without them. Phases, in order (any
failure exits non-zero and prints no result):

1. Device: the card's name, and name + power limit from nvidia-smi.
2. Build: compile `sivae_torch/csrc/*.cu` for sm_90a, print the build time.
3. Kernels against their plain PyTorch versions on the card, at every conv
   site of the spatial_1200 encode + decode path (batch 2) plus odd shapes
   (conv 3->4 and 1->5, stencils with 5 channels), in fp32 (TF32 off) and
   bf16: max error, kernel / plain /
   cuDNN (`library_ms`, a yardstick only) times, and the roofline bound.
   fp32 tolerance 1e-4 * max(1, max|plain|) (reassociation over K <= 6912);
   bf16 tolerance 1e-2 * max(1, max|plain|) (one output rounding; the plain
   version takes the same bf16 inputs and accumulates in fp32).
4. The eval / CBIR path end to end at full width: spatial_1200 at 80x96x80,
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

The next-to-last line is the per-kernel JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

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
# decode at 80x96x80 (decoder sites repeat encoder ones), then two odd shapes
CONV_SITES = [
    (64, 64, (80, 96, 80)), (64, 64, (40, 48, 40)), (64, 128, (40, 48, 40)),
    (128, 128, (20, 24, 20)), (128, 256, (20, 24, 20)), (256, 256, (10, 12, 10)),
    (3, 4, (8, 10, 12)), (1, 5, (8, 10, 12)),
]
# decoder tail 64 -> 1 and encoder stem 1 -> 64, then an odd channel count
# (the stencils' scalar bodies)
SMALL_SITES = [(64, (80, 96, 80)), (5, (8, 10, 12))]
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
REPLACES = {
    "conv3d_same": "sivae_tpu/kernels/conv3d.py:91",
    "conv3d_to1": "sivae_tpu/kernels/conv3d_small.py:180",
    "conv3d_from1": "sivae_tpu/kernels/conv3d_small.py:213",
}
SOURCES = {
    "conv3d_same": "sivae_torch/csrc/conv3d.cu",
    "conv3d_to1": "sivae_torch/csrc/conv3d_small.cu",
    "conv3d_from1": "sivae_torch/csrc/conv3d_small.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    log(smi.stdout.strip().splitlines()[0])
    return name


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


def _compare(k: torch.Tensor, p: torch.Tensor, dtype) -> tuple:
    err = (k.float() - p.float()).abs().max().item()
    scale = max(1.0, p.float().abs().max().item())
    return err, err / scale, err <= TOL[dtype] * scale


def phase_kernels(dev) -> dict:
    from sivae_torch.kernels import build
    from sivae_torch.kernels.conv3d import conv3d_same, conv3d_same_body, conv3d_same_plain
    from sivae_torch.kernels.conv3d_small import (conv3d_from1, conv3d_from1_plain, conv3d_to1,
                                                  conv3d_to1_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    failures, rows = [], {}

    def run(name, site, dtype, x, w, kern, plain, lib_fn, flops, out_numel, body=""):
        k = kern(x, w)
        torch.cuda.synchronize()
        p = plain(x, w)
        err, rel, ok = _compare(k, p, dtype)
        reps = 5 if x.numel() > 2e7 else 20
        ms = time_ms(lambda: kern(x, w), reps)
        plain_ms = time_ms(lambda: plain(x, w), max(2, reps // 5))
        lib_ms = time_ms(lib_fn, reps)
        isz = x.element_size()
        b_ms, b_by = bound((x.numel() + w.numel() + out_numel) * isz, flops, PEAK_FLOPS[dtype])
        tag = f"{name} {site} {str(dtype).replace('torch.', '')}"
        log(f"[kernel] {tag:44s} {body:4s} max_abs {err:.3e} max_rel {rel:.3e} "
            f"{'ok' if ok else 'FAIL'} | kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"cudnn {lib_ms:.3f} ms bound {b_ms:.3f} ms ({b_by})")
        if not ok:
            failures.append(tag)
        rows[(name, site, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    for dtype in (torch.float32, torch.bfloat16):
        for ci, co, sp in CONV_SITES:
            b = 2
            x = torch.randn((b,) + sp + (ci,), generator=gen, device=dev).to(dtype)
            w = (torch.randn((3, 3, 3, ci, co), generator=gen, device=dev)
                 * math.sqrt(2.0 / (27 * ci))).to(dtype)
            x_cl = x.permute(0, 4, 1, 2, 3)                    # NCDHW view, channels_last_3d
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            n_vox = b * sp[0] * sp[1] * sp[2]
            body = conv3d_same_body(x, w, torch.empty((b,) + sp + (co,), dtype=dtype, device=dev))
            run("conv3d_same", f"{ci}->{co}@{'x'.join(map(str, sp))}", dtype, x, w,
                conv3d_same, conv3d_same_plain,
                lambda: F.conv3d(x_cl, w_cl, padding=1), 2.0 * n_vox * 27 * ci * co,
                n_vox * co, body)

        for c, sp in SMALL_SITES:
            b = 2
            n_vox = b * sp[0] * sp[1] * sp[2]
            grid = "x".join(map(str, sp))
            x = torch.randn((b,) + sp + (c,), generator=gen, device=dev).to(dtype)
            w = (torch.randn((3, 3, 3, c, 1), generator=gen, device=dev)
                 * math.sqrt(2.0 / (27 * c))).to(dtype)
            x_cl = x.permute(0, 4, 1, 2, 3)
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous()
            run("conv3d_to1", f"{c}->1@{grid}", dtype, x, w, conv3d_to1, conv3d_to1_plain,
                lambda: F.conv3d(x_cl, w_cl, padding=1), 2.0 * n_vox * 27 * c, n_vox)

            x = torch.randn((b,) + sp + (1,), generator=gen, device=dev).to(dtype)
            w = (torch.randn((3, 3, 3, 1, c), generator=gen, device=dev)
                 * math.sqrt(2.0 / 27)).to(dtype)
            x_cl = x.permute(0, 4, 1, 2, 3)
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous()
            run("conv3d_from1", f"1->{c}@{grid}", dtype, x, w, conv3d_from1,
                conv3d_from1_plain, lambda: F.conv3d(x_cl, w_cl, padding=1),
                2.0 * n_vox * 27 * c, n_vox * c)

    if failures:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failures}")
    build.reset_launches()  # comparison launches do not count for the main path
    return rows


# ---------------------------------------------------------------------------
# phase 4: the eval / CBIR path end to end
# ---------------------------------------------------------------------------


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def phase_path(dev) -> dict:
    import numpy as np

    from sivae_torch.data.pipeline import BrainDataSource
    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.data.synthetic import SyntheticBrainSource
    from sivae_torch.eval.latent_probe import encode_dataset
    from sivae_torch.eval.recon_quality import reconstruction_report
    from sivae_torch.eval.retrieval import retrieval_precision_at_k
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.models.resnet_vae import reparameterize

    cfg32 = get_model_config("spatial_1200")
    cfg = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    batch, n_vol = 8, 32
    model = make_model(cfg, device=dev, seed=0)
    src = BrainDataSource(list(SyntheticBrainSource(n_vol, cfg.input_shape, seed=7)))
    # fold 4 of 5 by patient, without scikit-learn (not on every card's
    # machine): the volumes of every fifth patient id are the queries
    pids = sorted(set(src.pids))
    is_val = np.array([pids.index(p) % 5 == 4 for p in src.pids])
    vid, tid = np.flatnonzero(is_val), np.flatnonzero(~is_val)
    vox = preprocess_batch(torch.from_numpy(src.voxels).to(dev))
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
    want = {"conv3d_same": 8 * n_b, "conv3d_to1": 0, "conv3d_from1": n_b}
    if enc_counts != want:
        raise SystemExit(f"chip_smoke: encode launches {enc_counts}, expected {want}")
    want = {"conv3d_same": 13 * n_b, "conv3d_to1": n_b, "conv3d_from1": n_b}
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

    phase_profile(model, vox[:batch])

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


def phase_profile(model, x: torch.Tensor) -> None:
    """Device time by kernel (torch.profiler) over one batch through each
    entry point, encode and the reconstruction report, and the device's idle
    share of each window (the profiler's own overhead is in the window)."""
    from torch.profiler import ProfilerActivity, profile

    from sivae_torch.eval.latent_probe import encode_dataset
    from sivae_torch.eval.recon_quality import reconstruction_report

    n = x.shape[0]
    for what, fn in (("encode", lambda: encode_dataset(model, x, batch_size=n)),
                     ("reconstruction report", lambda: reconstruction_report(model, x,
                                                                             batch_size=n))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages() if e.device_type ==
                   torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        if not kernels:
            log(f"[profile] {what}: no device time recorded: not measured")
            continue
        busy_us = sum(e.self_device_time_total for e in kernels)
        log(f"[profile] {what} of {n} volumes: wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}, "
            f"{sum(e.count for e in kernels)} kernel launches")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x "
                f"{100 * e.self_device_time_total / busy_us:5.1f}%  {e.key[:110]}")


def main():
    name = phase_device()
    from sivae_torch.utils.device import resolve_device

    dev = resolve_device("cuda")  # also turns TF32 off for the fp32 checks
    phase_build()
    rows = phase_kernels(dev)
    launches = phase_path(dev)

    head = {"conv3d_same": ("conv3d_same", "64->64@80x96x80", torch.bfloat16),
            "conv3d_to1": ("conv3d_to1", "64->1@80x96x80", torch.bfloat16),
            "conv3d_from1": ("conv3d_from1", "1->64@80x96x80", torch.bfloat16)}
    kernels = []
    for kname, key in head.items():
        r = rows[key]
        kernels.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                        "replaces": REPLACES[kname], "launches": launches[kname],
                        "max_abs_err": max(v["max_abs_err"] for k, v in rows.items()
                                           if k[0] == kname),
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "site": f"{key[1]} batch 2 bf16"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
