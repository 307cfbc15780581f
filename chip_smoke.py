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
   (`library_ms`, a yardstick only) times, and the roofline bound (fp32 at
   165 TF/s, a third of the TF32 rate: what fp32-accurate work costs on the
   tensor cores); for `conv3d_same` rows that the wgmma body takes, its
   block shape and the superseded mma.sync body's error and time on the same
   operands, for rows that the narrow, tf32x3 or narrow_tf32x3 body takes
   the superseded "fma" body's, and for `conv3d_to1` and `conv3d_from1` rows on a
   tensor-core body ("mma", "tf32x3") their "fma" body's. Times are
   device times: the timed calls wait on the card behind other queued work,
   so a kernel shorter than its launch path is not timed by that path. The
   flagship sites of `conv3d_same`, `conv3d_to1` and `conv3d_from1` are also
   run at batch 8, the batch both main paths run, in bf16 and fp32 (both
   stencils also at C = 12 in fp32, the stem at C = 24 in bf16), and the two
   stencils at C = 16 and 32. In fp32 at batch 8, `conv3d_same` also runs
   at the FC and spatial_150 sites of the "narrow_tf32x3" body (12->12 and
   16->16 at 80x96x80; 12->12, 12->24, 24->12, 16->32 at 40x48x40; 24->32
   at 20x24x20; 48->48 at 5x6x5). Each row prints its share of the bound
   (bound / kernel ms). In bf16 at batch 1, `conv3d_same` also runs at
   spatial_1200_fullsize's encoder conv 32->64 at 80x96x80 (the wgmma body
   in 32-channel chunks, as at fc_600's 32->64 at 20x24x20) and its input
   gradient 64->32 ("narrow"). The fused conv + statistics kernel runs, in
   bf16 ("wgmma") and fp32 ("tf32x3"), with and without its prologue at the
   flagship site (with it also at batch 8) and at two shapes whose tiles
   straddle (b, d) planes; its library yardstick is the unfused stage
   (elementwise prologue, cuDNN conv with TF32 off in fp32, two reductions).
   `conv3d_to1`, `conv3d_from1` and `conv3d_fused_stats` rows also name
   their body; the fused kernel's wgmma rows show the earlier mma.sync
   body's error and time beside it, its tf32x3 rows the "fma" body's.
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
   seeded random weights, 32 synthetic volumes (seed 7), in bf16 (the eval
   CLI's `--bf16`) and then in fp32 (its default). For each, the main path
   runs once with the launch counters set to 0: encode every volume at
   batch 8, cosine-kNN retrieval (every fifth patient's volumes as queries),
   reconstruction report of every volume at batch 8. The counters must grow
   by exactly the counts derived from the model's modules (8 conv3d + 1
   from1 per encoded batch and 13 conv3d + 1 to1 + 1 from1 per
   reconstructed batch), and each kernel's body at every site the run
   launched is printed; the run fails if one of them is "fma" where every
   channel count is a multiple of 4. Then encode and reconstruct throughput
   over the same 4 full batches, 5 windows each (median, min, max), peak
   memory, and a torch.profiler window over one batch through each entry
   point (encode, reconstruction report) and through the reconstruction
   with its metrics taken one volume at a time (the yardstick the batched
   report replaced): device time by kernel, the idle share and the launches
   of each. The report's batched metrics are held to the per-volume ones on
   the same reconstructions on the card (rmse and psnr within 1e-5
   relative, each SSIM within 1e-5 absolute, `batch_ssim_center_slice`
   against the per-volume centre-slice SSIM), and the counted report's means
   to the per-volume means. For the fp32 spatial_1200 model,
   `encode_dataset` and `reconstruction_report` over the first batch on the
   model put into training mode must give the eval-mode calls' results
   within 1e-6 of the largest value, leave every buffer unchanged and the
   model in training mode. Then one volume in fp32 on the card (every conv
   through the kernels) against the same model and volume on the CPU (plain
   versions): relative error of mu and of the reconstruction <= 1e-3. Then
   the same fp32 eval path (counted, bodies, throughput, profiles, the
   batched-report check, the CPU check) for fc_150, the z600 preset's model
   (seed 0 weights, the same volumes): the eval CLI's usage line `--model
   fc_150`, whose convs run the "narrow_tf32x3" body and its C -> 1 tail the
   fp32 "tf32x3" one.
6. The fused stage (the path of the fused conv + statistics kernel, which is
   on no model path): at the flagship site, batch 8, in bf16 and then in
   fp32, each with the counters at 0, one fused stage forward (prologue ->
   conv -> batch statistics from the plane sums) and one conv + statistics
   forward and backward through `conv3d_stats`; 3 launches expected each.
   Both are held against the unfused stage in library calls (cuDNN with
   TF32 off in fp32) and timed beside it.
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
   the kernels against the same step on the CPU through the plain versions,
   the card's ReLU / LeakyReLU branches replayed on the CPU (`KinkReplay`;
   each element whose branch flips must be a rounding tie): lossE and lossD
   within 1e-4 relative, both Adams' first moments within 1e-3 * max|m| per
   tensor (max|m| not below 1e-2 of the model's largest: gradients that are
   zero in exact arithmetic hold cancellation noise).

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
   and a torch.profiler window over one epoch. Then the run-directory
   tool's function (`sivae_torch.eval.run_dir.posthoc_health`, as
   `tools/torch_posthoc_health.py` runs it) over the phase's run directory
   and its 8 validation volumes, counted: its rows must equal the
   in-process sweep within 1e-6, its launches 2 checkpoints x one
   validation batch x the reconstruct counts derived from the model, and
   sweep.json and health.json must exist; matplotlib does not import here,
   so it skips the panels with one line. And the CUDA generator state that
   `tools/torch_from_orbax.py` writes must equal a seeded CUDA generator's.

9. The other model families and trainers (phase `families`), bf16 at
   80x96x80, batch 8, the first 8 volumes of phase 5: the z600 and
   z600-wide presets' models (fc_150, fc_600) with their loss weights, one
   warm-up step, one step with the counters at 0 whose launches must equal
   the counts derived from the model's modules (`soft_intro_launches`), 5
   timed steps (median, min, max s/step, vol/s), peak memory, finite
   metrics and every parameter and BN statistic moved (conv biases in front
   of a BN aside), and a torch.profiler window over one fc_150 step. Then
   one fp32 tiny_fc step on the card against the CPU at phase 7's
   tolerances. Then one epoch of 2 steps of the vae, cae and vae2soft
   presets through `train_on_split` on phase 8's 24 volumes: run files,
   finite metrics, a checkpoint and the derived launch counts. Then the
   spatial_150 `ResNetClassifier`: 3 steps on the volumes' labels and
   `predict_all` over them, counted. Phase 3 also holds the kernels at this
   phase's sites (conv3d_same on the narrow body at 80x96x80 and 40x48x40:
   12->12, 12->24, 24->12, 16->16, 16->32, 32->16; 64->32 at 20x24x20 on the
   narrow body and 32->64 on "wgmma"; both stencils at C = 12), bf16, batch 8.
   Before the steps, one whole fc_150 forward (eval mode, encode, and decode
   of the fp32 forward's mu) in bf16 against the same weights in fp32 on the
   card, which share no kernel body: relative error <= 5e-2 of the largest
   fp32 value (`TOL_FC_FORWARD` says why). Every counted run of the phase
   prints the body of each `conv3d_same`, `conv3d_to1` and `conv3d_from1`
   site it launched, forward and input gradient, and fails if one is
   "fma", or if a bf16 `conv3d_same` site with Ci % 32 == 0 and Co % 64 == 0
   (fc_600's 32->64) runs the superseded "mma" body and not "wgmma".

10. Data parallelism (phase `ddp`) on the one card, and the fullsize step.
   NCCL does not take two ranks on one device, so two processes join a gloo
   group (`sivae_torch.parallel.init_distributed(backend="gloo")`, both on
   cuda:0; gloo all-reduces the CUDA tensors) and run (a), (b), (c) below;
   each has a 600 s limit and is killed at it.
   (a) Equality: one fp32 spatial_1200 step at 80x96x80, TF32 off, no
   dropout, global batch 4 of phase 5's volumes (2 a rank), the fixed
   numpy noise batch of seed 11, `zero_noise` (as phase 7's card-vs-CPU
   step) and a learning rate of 0 (`ddp_equality_step` says why); the same
   step in one process on the card first, and once more with the batch's
   rows reversed (the same step in exact arithmetic). The mean of the
   ranks' lossE / lossD within 1e-4 relative of one process's, every first
   moment within 1e-3 of its tensor's max|m| or within twice the reversed
   batch's difference (fp32's sum order alone moves the weight gradients
   of convs in front of a BN by up to ~6e-3 at this width), the 3 whose
   exact gradient is 0 below 1e-2 of the largest moment, BN running
   statistics within 1e-5 of the largest running statistic, the ranks'
   state digests equal.
   (b) The bf16 flagship under data parallelism: spatial_1200, dropout on,
   2 ranks x 4 = global 8; a warm-up step, one step with the counters at 0
   on each rank (its launches must equal phase 7's 155 / 10 / 12; the
   all-reduces it made and their bytes, BN statistics, their cotangents
   and gradient buckets, are printed), 5 timed steps: s/step (median, min,
   max, the slower rank), global vol/s, peak GiB per rank; the digests must
   be equal after the steps; then one step with rank 0's under the
   profiler (its own kernels: the idle share holds the other rank's turns
   on the card and the waits). Two ranks share one card: not a scaling
   figure.
   (c) The entry point: `train_on_split` (z1200) on both ranks for 2 epochs
   over phase 8's 24 volumes, global batch 8, counted (each rank's launches
   4 x (155, 10, 12) + 2 x (54, 6, 3), as phase 8's); one set of run files
   (2 CSV rows, 2 JSONL lines, checkpoints 0 and 1, as every rank reads
   them), a new trainer's `try_resume` on each rank to epoch 1 with the
   state digest of the fit's end, equal on both ranks. Then
   `python -m sivae_torch.cli.train` (tiny_spatial, 1 epoch) as a
   subprocess with `WORLD_SIZE=1`, which joins an NCCL group of one on the
   card, must exit 0 with its run files (where scikit-learn does not
   import, a patient-rank split stands in for its StratifiedGroupKFold on
   that subprocess's path).
   (d) spatial_1200_fullsize (160x192x160) in bf16 at batch 1, dropout on:
   a warm-up step, one counted step (launches equal to the counts derived
   from the model), 3 timed steps (median, min, max s/step), peak memory
   against the card's, finite metrics. Its launches and the ranks' counted
   ones enter the kernel record as `launches_by_path.fullsize` and
   `ddp_ranks`.

11. Rematerialisation (`sivae_torch/models/remat.py`), bf16, dropout on
   where the family has it:
   (a) spatial_1200 at batch 8 on phase 7's volumes, weights of seed 0, in
   each mode: off, `remat=True` with each of the five policies, and the
   step's `remat_calls` (no policy). Per mode from the same seeded state: a
   warm-up step, whose metrics and Adam first moments must match the off
   mode's (losses 1e-4 relative, moments 1e-3 of a tensor's max|m| with
   phase 7's floor), one step with the counters at 0 (launches equal to
   the off counts derived from the model, 155 / 10 / 12, plus the reruns'
   derived from its conv sites and the policy), 5 timed steps (median,
   min, max s/step) and the peak memory since the mode began, which must
   be below the off mode's.
   (b) Batches that do not fit an 80 GB card without remat: spatial_1200
   at batch 48 with `remat_calls` and with policy None, and
   spatial_1200_fullsize at batch 16 with `remat_calls`: a warm-up step,
   then two timed steps, the first counted (launches against the derived
   counts); finite metrics, the peak beside the no-remat peak scaled from
   (a)'s off mode and phase 10 (d). No run without remat is tried there.
   (c) fc_150 at batch 8, `remat=True` with the default policy against
   off, as in (a).

12. Depth sharding (phase `depth`, `sivae_torch/parallel/mesh.py` and
   `halo.py`): processes on a `data x spatial` grid, gloo ranks sharing the
   one card (each 600 s limit; gloo sends host memory only, so each halo
   exchange is copied through the host, counted apart). The spatial
   family in (a)-(c), the FC family, the classifier, the plain steps and
   the lucky AE in (d)-(f).
   (a) spatial_1200_fullsize at its published widths and 160x192x160, fp32,
   TF32 off, no dropout, global batch 2 (2 synthetic volumes of seed 7), the
   fixed noise batch of seed 11, `zero_noise`, lr 0 (phase 10 (a) says
   why): one process's step on the card, the same on the reversed batch,
   the same in float64 with every conv by cuDNN in float64 (the yardstick),
   then a 1 x 2 grid (slabs of 80 planes). Losses within 1e-4 relative of
   one process's, BN running statistics within 1e-5 of the largest, first
   moments by step 0's rule (`_compare_depth`: the grid's distance from the
   float64 moment at most twice the farther of one process's two fp32
   steps', plus 1e-4 of the tensor's largest and 1e-6 of the largest
   moment; the exactly-zero gradients below 1e-4 of the largest moment);
   the same rule must refuse two controls made from the grid's moments, P
   times them (what a `spatial_sum` backward through a differentiable
   all-reduce gives) and their negation; launches per rank and per step
   against the counts derived from the model.
   (b) the same model in bf16, dropout on, global batch 2: one process's
   step first (s/step, peak, launches, a profile), then a 1 x 4 grid
   (slabs 48/48/32/32): a warm-up step, one counted step (launches against
   the derived counts, halo exchanges against `soft_intro_step_halos`, their
   bytes and the host copies, the all-reduces, the body of every kernel
   site), 5 timed steps (median, min, max s/step of the slower rank), peak
   GiB a rank, equal digests, finite metrics. Four ranks share one card:
   not a scaling figure.
   (c) `encode_dataset` of phase 5's first 8 volumes by spatial_1200 fp32
   (seed 0) on the 1 x 2 grid of (a) against one process: mu within 1e-3
   relative, the same launches.
   (d) fc_600 (the z600-wide preset's model) at its published widths and
   80x96x80, fp32, TF32 off, global batch 2 (phase 5's first 2 volumes),
   its own fixed noise batch (seed 13), `zero_noise`, lr 0: one process,
   the reversed batch, float64 with cuDNN's convs, then the 1 x 2 grid of
   (a) (slabs 48/32: the bottleneck's 5 planes split 3/2), held by (a)'s
   rule (`TOL_DEPTH_ZERO_GRAD` for the 24 conv biases in front of a BN),
   launches against the derived counts, halo exchanges against
   `soft_intro_step_halos` (312 a step).
   (e) fc_600 in bf16 (the FC family has no dropout), global batch 2: one
   process's step, then the 1 x 4 grid of (b) (slabs 32/16/16/16), as (b):
   launches and halo exchanges on every rank against the derived counts,
   equal digests, tensor-core bodies at every sharded site on every rank,
   s/step and peak GiB a rank beside one process's.
   (f) On the 1 x 2 grid against one process, fp32, no dropout, weights of
   seed 0, lr 0: one step each of the spatial_150 classifier, the VAE
   (vae_150) and the CAE (cae_150) on phase 5's first 2 volumes (losses
   within 1e-4 relative, each rank's launches one process's, equal
   digests), and the lucky AE's train-mode forward on all 8 (code and
   output within 1e-3 of their largest).
   The ranks' counted launches of (a), (b), (d), (e) and (f) enter the
   kernel record as `launches_by_path.depth_ranks`. `python3 chip_smoke.py
   --depth-cards`, on a machine with 4 cards, runs phase 12 alone with its
   ranks on a card each, joined by NCCL (the halo planes card to card); it
   ends with `{"ok": false, "partial": ["depth-cards"]}`.

`--only kernels,grad,path,stage,train,trainer,families,ddp,remat,depth` runs a
subset while working on one phase; it ends with `{"ok": false, "partial":
...}`, never with the result.

The next-to-last line is the per-kernel JSON record (with every phase-3 row
of each kernel under "rows"); the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from typing import Optional

import torch
import torch.nn.functional as F

PEAK_BYTES = 3.35e12         # H100 SXM HBM3, bytes/s
# the card's peak FLOP/s for the inputs' type (published, dense): bf16 on the
# tensor cores; fp32-accurate work at a third of the 495 TF/s TF32 rate,
# since one TF32 product misses the fp32 tolerance and three (the split big
# and small operands of the "tf32x3" bodies) hold it. That is above the CUDA
# cores' 67 TF/s, so it is the least time the card takes for the same fp32
# work, whichever body does it.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
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
# (batch, Ci, Co, grid), bf16 and fp32: the fused kernel with its prologue at
# the stage phase's batch
FUSED_B8_SITES = [(8, 64, 64, (80, 96, 80))]
# bf16 only, at the families phase's batch: conv3d_same sites that no
# earlier path reaches, those of the "narrow" body at 80x96x80 and 40x48x40
# (fc_150 and spatial_150: 12->12, 12->24 and its input gradient 24->12;
# fc_600: 16->16, 16->32 and its input gradient 32->16), fc_600's 64->32
# (narrow, the input gradient of its 32->64) and 32->64 (wgmma in 32-channel
# chunks); and the two stencils at fc_150's C = 12
FAMILY_CONV_SITES = [(8, 12, 12, (80, 96, 80)), (8, 12, 12, (40, 48, 40)),
                     (8, 12, 24, (40, 48, 40)), (8, 24, 12, (40, 48, 40)),
                     (8, 16, 16, (80, 96, 80)), (8, 16, 16, (40, 48, 40)),
                     (8, 16, 32, (40, 48, 40)), (8, 32, 16, (40, 48, 40)),
                     (8, 64, 32, (20, 24, 20)), (8, 32, 64, (20, 24, 20))]
FAMILY_STENCIL_SITES = [(8, 12, (80, 96, 80))]
# bf16 only, batch 1: spatial_1200_fullsize's encoder conv 32->64 at
# 80x96x80 (wgmma in 32-channel chunks) and its input gradient 64->32 (narrow)
FULLSIZE_CONV_SITES = [(1, 32, 64, (80, 96, 80)), (1, 64, 32, (80, 96, 80))]
# fp32 only (the eval CLI's default, `--no-bf16` training), at the eval
# path's batch: the flagship conv, then the FC and spatial_150 sites of the
# "narrow_tf32x3" body (fc_150 / spatial_150: 12->12, 12->24 and its input
# gradient 24->12, 24->32, 48->48; fc_600: 16->16, 16->32); both stencils
# at spatial_1200's C = 64 and the FC families' C = 12
FP32_CONV_SITES = [(8, 64, 64, (80, 96, 80)), (8, 12, 12, (80, 96, 80)), (8, 16, 16, (80, 96, 80)),
                   (8, 12, 12, (40, 48, 40)), (8, 12, 24, (40, 48, 40)), (8, 24, 12, (40, 48, 40)),
                   (8, 16, 32, (40, 48, 40)), (8, 24, 32, (20, 24, 20)), (8, 48, 48, (5, 6, 5))]
FP32_STENCIL_SITES = [(8, 64, (80, 96, 80)), (8, 12, (80, 96, 80))]
# bf16 only: the stem at C = 24, another width of the tap product's padded N
FROM1_BF16_SITES = [(8, 24, (80, 96, 80))]
SLOPE = 0.2                  # the model's LeakyReLU
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the body each tensor-core body superseded, which phase 3 runs beside it on
# the same operands (`conv3d_to1`'s and `conv3d_from1`'s "mma" superseded
# their "fma" bodies, as the fp32 "tf32x3" bodies did)
SUPERSEDED = {"wgmma": "mma", "narrow": "fma", "mma": "fma", "tf32x3": "fma",
              "narrow_tf32x3": "fma"}
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
PHASES = ("kernels", "grad", "path", "stage", "train", "trainer", "families", "ddp", "remat",
          "depth")


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
                                                  conv3d_from1_earlier_body, conv3d_from1_plain,
                                                  conv3d_to1, conv3d_to1_body,
                                                  conv3d_to1_earlier_body, conv3d_to1_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    failures, rows = [], {}

    def run(name, site, dtype, kern, plain, lib_fn, nbytes, flops, numel, body="", earlier=None,
            note=""):
        """kern / plain return a tensor or a tuple (y, sums...); `earlier` is
        the body the dispatch's choice superseded (`SUPERSEDED[body]`), held
        to the same plain version and timed in the same run."""
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
        old, e_ms = note, None
        if earlier is not None:
            e_ms = time_ms(earlier, reps)
            old += f" | superseded {SUPERSEDED[body]} body max_rel {e_rel:.3e} {e_ms:.3f} ms"
        tag = f"{name} {site} {dtype_name(dtype)}"
        log(f"[kernel] {tag:52s} {body:5s} max_abs {err:.3e} max_rel {rel:.3e}{sums} "
            f"{'ok' if ok else 'FAIL'} | kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"library {lib_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}, {b_ms / ms:.0%} of it){old}")
        if not ok:
            failures.append(tag)
        rows[(name, site, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                                         body=body, superseded_ms=e_ms)

    for dtype in (torch.float32, torch.bfloat16):
        isz = 4 if dtype == torch.float32 else 2
        flagship8 = ([(8,) + FLAGSHIP_CONV] + FAMILY_CONV_SITES + FULLSIZE_CONV_SITES
                     if dtype == torch.bfloat16 else FP32_CONV_SITES)
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
                (lambda: conv3d_same_earlier_body(x, w)) if body in SUPERSEDED else None,
                blocks)

        to1_more = (STENCIL_BF16_SITES + FAMILY_STENCIL_SITES if dtype == torch.bfloat16
                    else FP32_STENCIL_SITES)
        for b, c, sp in [(2,) + site for site in SMALL_SITES] + to1_more:
            n_vox = b * sp[0] * sp[1] * sp[2]
            x = torch.randn((b,) + sp + (c,), generator=gen, device=dev).to(dtype)
            w = _he((3, 3, 3, c, 1), 27 * c, gen, dev, dtype)
            x_cl = x.permute(0, 4, 1, 2, 3)
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous()
            body = conv3d_to1_body(x)
            run("conv3d_to1", f"{c}->1@{grid_name(sp)}" + _batch_tag(b), dtype,
                lambda: conv3d_to1(x, w), lambda: conv3d_to1_plain(x, w),
                lambda: F.conv3d(x_cl, w_cl, padding=1),
                (x.numel() + w.numel() + n_vox) * isz, 2.0 * n_vox * 27 * c, x.numel(),
                body, (lambda: conv3d_to1_earlier_body(x, w)) if body in SUPERSEDED else None)

        from1_more = (STENCIL_BF16_SITES + FAMILY_STENCIL_SITES + FROM1_BF16_SITES
                      if dtype == torch.bfloat16 else FP32_STENCIL_SITES)
        for b, c, sp in [(2,) + site for site in SMALL_SITES] + from1_more:
            n_vox = b * sp[0] * sp[1] * sp[2]
            x = torch.randn((b,) + sp + (1,), generator=gen, device=dev).to(dtype)
            w = _he((3, 3, 3, 1, c), 27, gen, dev, dtype)
            x_cl = x.permute(0, 4, 1, 2, 3)
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous()
            body = conv3d_from1_body(x, c)
            run("conv3d_from1", f"1->{c}@{grid_name(sp)}" + _batch_tag(b), dtype,
                lambda: conv3d_from1(x, w), lambda: conv3d_from1_plain(x, w),
                lambda: F.conv3d(x_cl, w_cl, padding=1),
                (x.numel() + w.numel() + n_vox * c) * isz, 2.0 * n_vox * 27 * c, x.numel(),
                body, (lambda: conv3d_from1_earlier_body(x, w)) if body in SUPERSEDED else None)

        for b, ci, co, sp in [(2,) + site for site in FUSED_SITES] + FUSED_B8_SITES:
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
                    if body in SUPERSEDED else None)

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


def eval_path(dev, model, vox, labels, vid, tid, tag: str) -> dict:
    """The eval / CBIR main path through `model` at batch 8, counted: encode
    every volume, retrieve, reconstruct every volume with its report; the
    launches asserted against the counts derived from the model's modules
    and each site's body checked, then throughput windows and one profile
    window of each entry point. Returns the counted launches."""
    import numpy as np

    from sivae_torch.eval.latent_probe import encode_dataset
    from sivae_torch.eval.recon_quality import reconstruction_report
    from sivae_torch.eval.retrieval import retrieval_precision_at_k
    from sivae_torch.kernels import build

    batch, n_vol = 8, vox.shape[0]
    # warm-up of both entry points (cuDNN plans the transposed convs on first
    # use); its launches are not counted
    encode_dataset(model, vox[:batch], batch_size=batch)
    reconstruction_report(model, vox[:batch], batch_size=batch)
    torch.cuda.synchronize()

    n_b = n_vol // batch
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    z = encode_dataset(model, vox, batch_size=batch)
    torch.cuda.synchronize()
    enc_counts = dict(build.launches)
    p_at_k = retrieval_precision_at_k(z[vid], labels[vid], z[tid], labels[tid], k=10, device=dev)
    report = reconstruction_report(model, vox, batch_size=batch)
    torch.cuda.synchronize()
    counts = dict(build.launches)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    rec_counts = {k: counts[k] - enc_counts[k] for k in counts}
    bodies = site_bodies(dev)
    e, d = conv_sites(model.encoder), conv_sites(model.decoder)
    want = {k: n_b * e[k] for k in e}
    if enc_counts != want:
        raise SystemExit(f"chip_smoke: {tag} encode launches {enc_counts}, expected {want}")
    want = {k: n_b * (e[k] + d[k]) for k in e}
    if rec_counts != want:
        raise SystemExit(f"chip_smoke: {tag} reconstruct launches {rec_counts}, expected {want}")

    if not (np.all(np.isfinite(z)) and z.shape == (n_vol, model.cfg.latent_dim)):
        raise SystemExit(f"chip_smoke: {tag} bad latents {z.shape}")
    if not (all(math.isfinite(v) for v in report.values()) and report["n"] == n_vol):
        raise SystemExit(f"chip_smoke: {tag} bad report {report}")
    report["retrieval_p_at_k"] = p_at_k
    log(f"[path] {tag} launches encode {enc_counts} reconstruct {rec_counts}; "
        f"peak memory {peak_gib:.2f} GiB; bodies {json.dumps(bodies)}")
    _require_tensor_core_bodies(f"the {tag} eval path", bodies)
    log(f"[path] {tag} report {json.dumps(report)}")
    check_batched_report(model, vox, report, tag, batch)

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
        log(f"[path] {tag} {what} {n_vol} vols x {REPEATS} windows: median "
            f"{rates[REPEATS // 2]:.2f} vol/s, min {rates[0]:.2f}, max {rates[-1]:.2f}")

    x8 = vox[:batch]
    profile_window(f"{tag} encode of {batch} volumes",
                   lambda: encode_dataset(model, x8, batch_size=batch))
    rep = profile_window(f"{tag} reconstruction report of {batch} volumes",
                         lambda: reconstruction_report(model, x8, batch_size=batch))
    yard = profile_window(f"{tag} reconstruction with per-volume metrics (the yardstick) of "
                          f"{batch} volumes",
                          lambda: per_volume_report(model, x8, batch).tolist())
    if rep is not None and yard is not None:
        log(f"[path] {tag} report of {batch} volumes: {rep['launches']} launches, idle share "
            f"{rep['idle']:.3f}; with per-volume metrics {yard['launches']} launches, idle share "
            f"{yard['idle']:.3f}")
    return {k: enc_counts[k] + rec_counts[k] for k in enc_counts}


# batched metrics against the per-volume ones: rmse and psnr relative, SSIM
# absolute (the same fp32 arithmetic; only the final means' order differs)
TOL_REPORT = 1e-5


def per_volume_metrics(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, 4): RMSE, PSNR, 3D SSIM and centre-slice SSIM of each volume of
    the NCDHW pair, one volume at a time: the yardstick the batched report is
    held to."""
    from sivae_torch.ops.metrics import psnr, rmse, ssim

    rows = []
    for j in range(x.shape[0]):
        a, b = x[j, 0], y[j, 0]
        mid = a.shape[0] // 2
        rows.append(torch.stack([rmse(a, b), psnr(a, b), ssim(a, b), ssim(a[mid], b[mid])]))
    return torch.stack(rows)


def per_volume_report(model, vox, batch: int) -> torch.Tensor:
    """Reconstruct `vox` (whole batches) and take the metrics one volume at
    a time: (N, 4) rows of `per_volume_metrics`."""
    from sivae_torch.eval.recon_quality import reconstruct

    return torch.cat([per_volume_metrics(vox[i:i + batch],
                                         reconstruct(model, vox[i:i + batch]).float())
                      for i in range(0, vox.shape[0], batch)])


def check_batched_report(model, vox, report: dict, tag: str, batch: int) -> None:
    """The batched metrics of each batch's reconstructions against the
    per-volume ones on the same reconstructions, `batch_ssim_center_slice`
    against the per-volume centre-slice SSIM, and the counted report's
    means against the per-volume means, within `TOL_REPORT`."""
    from sivae_torch.eval.recon_quality import reconstruct
    from sivae_torch.ops.metrics import (batch_psnr, batch_rmse, batch_ssim,
                                         batch_ssim_center_slice)

    keys = ("rmse", "psnr", "ssim3d", "ssim_center_slice")
    err = dict.fromkeys(keys + ("batch_ssim_center_slice",), 0.0)
    per_all = []
    with torch.no_grad():
        for i in range(0, vox.shape[0], batch):
            x = vox[i:i + batch]
            y = reconstruct(model, x).float()
            per = per_volume_metrics(x, y)
            a, b = x[:, 0], y[:, 0]
            mid = a.shape[1] // 2
            got = torch.stack([batch_rmse(a, b), batch_psnr(a, b), batch_ssim(a, b),
                               batch_ssim(a[:, mid], b[:, mid])], dim=1)
            for c, k in enumerate(keys):
                d = (got[:, c] - per[:, c]).abs()
                if c < 2:
                    d = d / per[:, c].abs()
                err[k] = max(err[k], d.max().item())
            slices = torch.from_numpy(batch_ssim_center_slice(x, y))
            err["batch_ssim_center_slice"] = max(err["batch_ssim_center_slice"],
                                                 (slices - per[:, 3].cpu()).abs().max().item())
            per_all.append(per)
    means = torch.cat(per_all).mean(dim=0).tolist()
    mean_err = {k: abs(report[k] - m) / (abs(m) if c < 2 else 1.0)
                for c, (k, m) in enumerate(zip(keys, means))}
    log(f"[path] {tag} batched metrics vs per-volume on the same reconstructions (rmse, psnr "
        f"relative; SSIM absolute; limit {TOL_REPORT}): per volume "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in err.items()})}; the report's means "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in mean_err.items()})}")
    if max(max(err.values()), max(mean_err.values())) > TOL_REPORT:
        raise SystemExit(f"chip_smoke: the {tag} batched report disagrees with the per-volume "
                         f"metrics")


def eval_mode_check(model, x, tag: str) -> None:
    """`encode_dataset` and `reconstruction_report` on a model in training
    mode give the eval-mode calls' results (within 1e-6 of the largest
    value; bit for bit expected), leave every buffer unchanged and the model
    in training mode."""
    import numpy as np

    from sivae_torch.eval.latent_probe import encode_dataset
    from sivae_torch.eval.recon_quality import reconstruction_report

    batch = x.shape[0]
    z_eval = encode_dataset(model, x, batch_size=batch)
    rep_eval = reconstruction_report(model, x, batch_size=batch)
    # two eval-mode calls: what the card's own run-to-run variation is
    again = (np.array_equal(encode_dataset(model, x, batch_size=batch), z_eval)
             and reconstruction_report(model, x, batch_size=batch) == rep_eval)
    model.train()
    before = {k: v.clone() for k, v in model.named_buffers()}
    z = encode_dataset(model, x, batch_size=batch)
    rep = reconstruction_report(model, x, batch_size=batch)
    training = model.training
    same_buffers = all(torch.equal(v, before[k]) for k, v in model.named_buffers())
    model.eval()
    z_err = float(np.abs(z - z_eval).max() / max(np.abs(z_eval).max(), 1e-30))
    rep_scale = max(abs(v) for v in rep_eval.values())
    rep_err = max(abs(rep[k] - rep_eval[k]) for k in rep_eval) / rep_scale
    log(f"[path] {tag} on a model in training mode: encode {z_err:.3e} and report {rep_err:.3e} "
        f"of the largest eval-mode value (limit 1e-6; bit for bit: "
        f"{np.array_equal(z, z_eval) and rep == rep_eval}; two eval-mode calls bit for bit: "
        f"{again}), {len(before)} buffers unchanged: {same_buffers}, still in training mode: "
        f"{training}")
    if not (z_err <= 1e-6 and rep_err <= 1e-6 and same_buffers and training):
        raise SystemExit(f"chip_smoke: the {tag} eval functions do not run in eval mode")


def phase_path(dev, src, vox) -> tuple:
    """The eval path of spatial_1200 in bf16 (`--bf16`) and in fp32 (the
    eval CLI's default), then of fc_150 in fp32, each fp32 model's kernel
    path against its plain path on the CPU. Returns the counted launches of
    each."""
    import numpy as np

    from sivae_torch.models.registry import get_model_config, make_model

    cfg32 = get_model_config("spatial_1200")
    n_vol = vox.shape[0]
    # fold 4 of 5 by patient, without scikit-learn (not on every card's
    # machine): the volumes of every fifth patient id are the queries
    pids = sorted(set(src.pids))
    is_val = np.array([pids.index(p) % 5 == 4 for p in src.pids])
    vid, tid = np.flatnonzero(is_val), np.flatnonzero(~is_val)
    log(f"[path] spatial_1200 {cfg32.input_shape}, {n_vol} volumes in {n_vol // 8} full batches "
        f"of 8; retrieval {len(vid)} queries against {len(tid)}")
    model = make_model(dataclasses.replace(cfg32, dtype=torch.bfloat16), device=dev, seed=0)
    counts16 = eval_path(dev, model, vox, src.labels, vid, tid, "bf16")
    del model
    counts32 = {}
    for name, tag in (("spatial_1200", "fp32"), ("fc_150", "fc_150 fp32")):
        model32 = make_model(get_model_config(name), device=dev, seed=0)
        counts32[tag] = eval_path(dev, model32, vox, src.labels, vid, tid, tag)
        if name == "spatial_1200":
            eval_mode_check(model32, vox[:8], tag)
        card_vs_cpu_eval(model32, vox[:1], tag)
        del model32
        torch.cuda.empty_cache()
    return counts16, counts32["fp32"], counts32["fc_150 fp32"]


def card_vs_cpu_eval(model32, x1, tag: str) -> None:
    """One volume's encode and reconstruction in fp32 through the kernels
    (TF32 off, card) against the same model on the CPU (plain versions):
    relative error of mu and of the reconstruction <= 1e-3."""
    from sivae_torch.models.resnet_vae import reparameterize

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
    log(f"[path] {tag} kernels vs plain (CPU, {t_cpu:.1f} s): mu rel {e_mu:.3e}, "
        f"reconstruction rel {e_rec:.3e} (limit 1e-3)")
    if not (e_mu <= 1e-3 and e_rec <= 1e-3):
        raise SystemExit(f"chip_smoke: the {tag} kernel path disagrees with the plain path")


def profile_window(what: str, fn, top: int = 10) -> Optional[dict]:
    """Device time by kernel (torch.profiler) over one call of `fn`, the
    device's idle share of the window (the profiler's own overhead is in
    the window), the launch count, and every library convolution kernel.
    Returns {"launches", "idle"}, or None where no device time was
    recorded."""
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
        return None
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}, "
        f"{launches} kernel launches")
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
    return {"launches": launches, "idle": 1 - busy_us / wall_us}


# ---------------------------------------------------------------------------
# phase 6: the fused stage, the path of the fused conv + statistics kernel
# ---------------------------------------------------------------------------


def phase_stage(dev) -> dict:
    """One fused stage forward and one conv + statistics forward + backward
    at the flagship site, batch 8, in bf16 and then in fp32, each counted,
    held against the same stage in library calls (cuDNN with TF32 off in
    fp32) and timed beside it (the yardstick, not a gate on speed). Returns
    the launches of both counted runs."""
    from sivae_torch.kernels import build

    total = {}
    for dtype in (torch.bfloat16, torch.float32):
        total = _add_counts(total, _stage(dev, dtype))
    build.reset_launches()
    return total


# the stage's gradients against the library stage's: in bf16 the Function
# receives gy already rounded to bf16 and then adds the sums' cotangents,
# where the library path adds all three in fp32 and rounds once, and the three
# nearly cancel (the loss normalizes y), so 5e-2 of the largest; in fp32 only
# the order of the sums differs (dw sums 4.9e6 products an element), so
# phase 4's fp32 weight-gradient tolerance
TOL_STAGE_GRAD = {torch.bfloat16: 5e-2, torch.float32: TOL_DW[torch.float32]}


def _stage(dev, dtype) -> dict:
    from sivae_torch.kernels import build
    from sivae_torch.kernels.conv3d_fused import (conv3d_fused_stats, conv3d_fused_stats_body,
                                                  conv3d_stats)

    c, sp = FLAGSHIP
    b, eps = 8, 1e-5
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
        raise SystemExit(f"chip_smoke: {dtype_name(dtype)} stage launches {counts}, "
                         f"expected {want}")

    y_l, mean_l, var_l = library_stage()
    dx_l, dw_l = library_grad()
    # the gradients are held to their plain versions in the gradient phase;
    # here they only have to be the library's (TOL_STAGE_GRAD says how far)
    g_tol = TOL_STAGE_GRAD[dtype]
    checks = {"y": _compare(y, y_l, TOL[dtype]), "mean": _compare(mean, mean_l, TOL_SUMS),
              "var": _compare(var, var_l, TOL_SUMS), "dx": _compare(dx, dx_l, g_tol),
              "dw": _compare(dw, dw_l, g_tol)}
    finite = all(torch.isfinite(t.float()).all().item() for t in (y, mean, var, dx, dw))
    tag = f"64->64@80x96x80 batch 8 {dtype_name(dtype)}"
    log(f"[stage] fused ({conv3d_fused_stats_body(x, w)}) vs library stage, {tag}: " + ", ".join(
        f"{k} max_rel {v[1]:.2e}" for k, v in checks.items()) + f"; launches {counts}")
    if not finite or not all(v[2] for v in checks.values()):
        raise SystemExit(f"chip_smoke: the {tag} fused stage disagrees with the library "
                         f"stage: {checks}")
    del y, dx, dw, y_l, dx_l, dw_l

    t = {"fused stage": time_ms(fused_stage, 5), "library stage": time_ms(library_stage, 5),
         "fused stage grad": time_ms(fused_grad, 3), "library stage grad": time_ms(library_grad, 3)}
    log(f"[stage] {tag}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    return counts


# ---------------------------------------------------------------------------
# phase 7: the two-phase train step
# ---------------------------------------------------------------------------


def _metrics_line(metrics) -> dict:
    return {k: (bool(v) if v.dtype == torch.bool else float(v)) for k, v in metrics.items()}


def phase_train(dev, real) -> dict:
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
    card_vs_cpu_step(dev, dataclasses.replace(tiny, act=tiny.act.with_no_dropout()), 6)
    build.reset_launches()
    return counts


class KinkReplay:
    """The branch every ReLU / LeakyReLU element takes (input > 0), recorded
    in the card's step and replayed in the CPU reference's. An input that is
    0 to within fp32 rounding falls on either side of the kink as the sums'
    order decides, and the two steps would then differentiate two different
    branches of a piecewise-linear function: one element of tiny_fc's
    decoder-tail ReLU (-1.8e-7 on the card, 3.4e-6 on the CPU, of a largest
    11) moved Adam's first moments by up to 6.5e-3 of a tensor's largest.
    Each element whose branch the CPU's own input would flip is counted and
    must be such a tie: the two inputs within 1e-4 of the tensor's largest
    (the forward tolerance). The BN + activation backward derives its own
    mask, which the replay does not reach."""

    def __init__(self):
        self.record, self.calls, self.at, self.flips, self.gap = True, [], 0, 0, 0.0

    def _act(self, x, slope, orig, *args, **kwargs):
        if self.record:
            self.calls.append(x.detach().float().cpu())
            return orig(x, *args, **kwargs)
        card = self.calls[self.at]
        self.at += 1
        mask = card > 0
        flip = mask != (x.detach() > 0)
        if flip.any():
            scale = max(card.abs().max().item(), x.detach().abs().max().item(), 1e-30)
            self.flips += int(flip.sum())
            self.gap = max(self.gap, (card - x.detach().float())[flip].abs().max().item() / scale)
        return torch.where(mask, x, x * slope)

    def __enter__(self):
        self._orig = F.relu, F.leaky_relu
        relu, leaky = self._orig
        F.relu = lambda x, inplace=False: self._act(x, 0.0, relu, inplace)
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: self._act(
            x, negative_slope, leaky, negative_slope, inplace)
        return self

    def __exit__(self, *exc):
        F.relu, F.leaky_relu = self._orig
        self.record = False


def card_vs_cpu_step(dev, cfg, max_floored: int) -> None:
    """One fp32 Soft-IntroVAE step of `cfg` (no dropout, zero_noise, a fixed
    numpy noise batch, batch 4, weights of seed 3) on the card through the
    kernels against the same step on the CPU through the plain versions, the
    card's ReLU / LeakyReLU branches replayed on the CPU (`KinkReplay`):
    lossE and lossD within 1e-4 relative, every first moment within 1e-3 *
    max|m| per tensor. A tensor whose gradient is zero or nearly so in exact
    arithmetic (a conv bias or a 1-channel conv weight in front of a BN,
    which cancels shift and scale; the zero-initialised logvar head under
    zero_noise) holds only cancellation noise, so the scale has a floor of
    1e-2 of the largest moment in the model, and at most `max_floored`
    tensors may sit under it."""
    import numpy as np

    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import make_model
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    rng = np.random.RandomState(11)
    real_t = torch.from_numpy(rng.rand(4, 1, *cfg.input_shape).astype(np.float32))
    fixed = rng.randn(4, cfg.latent_dim).astype(np.float32)
    done, kinks = {}, KinkReplay()
    for where in (dev, torch.device("cpu")):
        m_t = make_model(cfg, device=where, seed=3)
        s_t = create_train_state(m_t, seed=0)
        f_t = make_soft_intro_train_step(m_t, SoftIntroLossConfig(), OptimConfig(), 1,
                                         cfg.input_shape, zero_noise=True, fixed_noise=fixed)
        build.reset_launches()
        with kinks:  # records on the card, replays on the CPU
            _, met = f_t(s_t, real_t.to(where))
        names = {p: k for k, p in m_t.named_parameters()}
        moments = {names[p]: s["exp_avg"].detach().cpu()
                   for opt in (s_t.opt_e, s_t.opt_d) for p, s in opt.state.items()}
        done[where.type] = (_metrics_line(met), moments, dict(build.launches))
    (m_k, mom_k, n_k), (m_p, mom_p, n_p) = done["cuda"], done["cpu"]
    if n_k["conv3d_same"] == 0 or any(n_p.values()):
        raise SystemExit(f"chip_smoke: fp32 step launches card {n_k} CPU {n_p}")
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
    tag = f"fp32 {type(cfg).__name__} {grid_name(cfg.input_shape)} step"
    log(f"[train] {tag}, kernels (card) vs plain (CPU): lossE rel {rel_e:.2e}, "
        f"lossD rel {rel_d:.2e} (limit 1e-4); first moments of {len(mom_p)} tensors worst "
        f"{worst[0]:.2e} of max|m| at {worst[1]} (limit 1e-3); held to the floor {floor:.2e}: "
        f"{len(floored)} tensors (at most {max_floored}) {floored}; activation branches the "
        f"CPU took otherwise: {kinks.flips} of {len(kinks.calls)} calls' elements, card vs CPU "
        f"input gap {kinks.gap:.2e} of the largest (limit 1e-4); card launches {n_k}")
    if (rel_e > 1e-4 or rel_d > 1e-4 or bad or len(floored) > max_floored
            or kinks.at != len(kinks.calls) or kinks.gap > 1e-4):
        raise SystemExit(f"chip_smoke: the card's {tag} disagrees with the CPU's: {bad}")


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
    run_dir_tool(dev, run_dir, val_src, sweep, trainer.model_cfg)
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


def run_dir_tool(dev, run_dir: str, val_src, sweep: list, model_cfg) -> None:
    """The run-directory tool's function (`tools/torch_posthoc_health.py`)
    over the phase's own run directory and validation volumes, counted: the
    model rebuilt from args.json, its rows equal to the in-process sweep
    within 1e-6, its launches 2 checkpoints x one validation batch x the
    reconstruct counts derived from the model, sweep.json and health.json
    written; matplotlib does not import here, so it skips the panels and
    says so. Also: the CUDA generator state the orbax converter writes is a
    seeded CUDA generator's."""
    import os

    from sivae_torch.eval.run_dir import posthoc_health
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import make_model
    from sivae_torch.utils.checkpoint import seeded_generator_state

    for name in ("sweep.json", "health.json"):
        if os.path.exists(os.path.join(run_dir, name)):
            os.remove(os.path.join(run_dir, name))
    build.reset_launches()
    t0 = time.perf_counter()
    rows, health = posthoc_health(run_dir, val_src, dev, panels=True)
    torch.cuda.synchronize()
    tool_s = time.perf_counter() - t0
    counts = dict(build.launches)
    model = make_model(model_cfg, device=dev)
    e, d = conv_sites(model.encoder), conv_sites(model.decoder)
    n_batches = -(-len(val_src) // 8)
    want = {k: 2 * n_batches * (e[k] + d[k]) for k in e}
    err = max(abs(r[k] - w[k]) / max(1.0, abs(w[k]))
              for r, w in zip(rows, sweep) for k in w if k != "checkpoint")
    same_tags = [r["checkpoint"] for r in rows] == [w["checkpoint"] for w in sweep]
    files = all(os.path.exists(os.path.join(run_dir, n)) for n in ("sweep.json", "health.json"))
    log(f"[trainer] run-directory tool (posthoc_health) {tool_s:.2f} s: {len(rows)} rows vs the "
        f"in-process sweep max rel {err:.3e} (limit 1e-6), checkpoints {same_tags}; launches "
        f"{counts} (expected {want}); sweep.json + health.json {files}; healthy "
        f"{health['healthy']}")
    if not (err <= 1e-6 and same_tags and counts == want and files):
        raise SystemExit("chip_smoke: the run-directory tool disagrees with the in-process sweep")
    gen_same = all(torch.equal(seeded_generator_state("cuda", s).cpu(),
                               torch.Generator(device=dev).manual_seed(s).get_state().cpu())
                   for s in (0, 77, 2**40 + 3))
    log(f"[trainer] the converter's CUDA generator state equals a seeded CUDA generator's: "
        f"{gen_same}")
    if not gen_same:
        raise SystemExit("chip_smoke: seeded_generator_state('cuda') differs from the card's")
    build.reset_launches()


# ---------------------------------------------------------------------------
# phase 9: the other model families and trainers
# ---------------------------------------------------------------------------


def conv_sites(module) -> dict:
    """Launches of each kernel in one forward of `module`, read from its
    modules: every 3x3x3 `Conv3d` routes to one kernel (C->1 `conv3d_to1`,
    1->C `conv3d_from1`, else `conv3d_same`); the fused upsample + conv and
    the 1x1 convs are library calls."""
    from sivae_torch.models.blocks import Conv3d, UpsampleConv3d

    n = {"conv3d_same": 0, "conv3d_to1": 0, "conv3d_from1": 0, "conv3d_fused_stats": 0}
    for m in module.modules():
        if isinstance(m, Conv3d) and not isinstance(m, UpsampleConv3d) and m.kernel_size == 3:
            n["conv3d_to1" if m.out_ch == 1 else "conv3d_from1" if m.in_ch == 1
              else "conv3d_same"] += 1
    return n


def soft_intro_launches(model) -> dict:
    """One two-phase step: 5 encodes and 8 decodes forward; backward through
    all 5 encodes and the 7 decodes with a graph (phase E's decode of the
    noise has none). A conv's input gradient is one more launch: the same
    kernel for conv3d_same; conv3d_to1's is a conv3d_from1 launch (7 decoder
    tails) and conv3d_from1's a conv3d_to1 launch where the stem's input
    needs it (phase D's 2 encodes of decoded volumes)."""
    e, d = conv_sites(model.encoder), conv_sites(model.decoder)
    return {"conv3d_same": 10 * e["conv3d_same"] + 15 * d["conv3d_same"],
            "conv3d_to1": 8 * d["conv3d_to1"] + 2 * e["conv3d_from1"],
            "conv3d_from1": 5 * e["conv3d_from1"] + 7 * d["conv3d_to1"], "conv3d_fused_stats": 0}


def soft_intro_step_halos(cfg) -> int:
    """Halo exchanges one two-phase Soft-IntroVAE step makes on each rank
    under depth sharding, from the conv sites: one per 3x3x3 or upsample +
    conv site in each of the 5 encodes and 8 decodes, and one more in the
    backward wherever the site's input needs a gradient: in the 7 decodes
    with a graph (phase E's decode of the noise has none) at every site, in
    all 5 encodes past the stem, and at the stem in phase D's 2 encodes of
    decoded volumes. Remat adds none (its reruns exchange nothing). `cfg`
    is a spatial or an FC config (the FC decoder's first 3x3x3 conv takes
    the dfc's output, which needs a gradient in every decode with a graph,
    as the spatial decoder's first conv does)."""
    from sivae_torch.config import FCVAEConfig
    from sivae_torch.models.fc_vae import fc_conv_sites
    from sivae_torch.models.remat import STEP_DECODES, STEP_ENCODES
    from sivae_torch.models.resnet_vae import spatial_conv_sites

    enc, dec = (fc_conv_sites if isinstance(cfg, FCVAEConfig) else spatial_conv_sites)(cfg)
    e = sum(s.kind != "1x1" for s in enc)
    d = sum(s.kind != "1x1" for s in dec)
    forward = STEP_ENCODES * e + (STEP_DECODES + 1) * d
    backward = STEP_DECODES * d + STEP_ENCODES * (e - 1) + 2
    return forward + backward


def soft_intro_eval_launches(model) -> dict:
    """One validation step: 3 encodes, 6 decodes, no backward."""
    e, d = conv_sites(model.encoder), conv_sites(model.decoder)
    return {k: 3 * e[k] + 6 * d[k] for k in e}


def plain_launches(model, train_steps: int, eval_steps: int) -> dict:
    """VAE / CAE: a step is one encode + decode forward and backward (no
    input gradient at the stem: its input is the data; a tail's input
    gradient is a conv3d_from1 launch); a validation step is the forward
    alone."""
    f = conv_sites(model)
    return {"conv3d_same": (2 * train_steps + eval_steps) * f["conv3d_same"],
            "conv3d_to1": (train_steps + eval_steps) * f["conv3d_to1"],
            "conv3d_from1": (train_steps * (f["conv3d_from1"] + f["conv3d_to1"])
                             + eval_steps * f["conv3d_from1"]),
            "conv3d_fused_stats": 0}


def _add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def site_bodies(dev) -> dict:
    """The body each kernel's dispatch takes at each site launched since the
    counters were last set to 0, keyed "Ci->Co dtype" (conv3d_same), "to1
    C->1 dtype" and "from1 1->C dtype" (fresh operands, which are aligned, as
    the model's are)."""
    from sivae_torch.kernels import build
    from sivae_torch.kernels.conv3d import conv3d_same_body
    from sivae_torch.kernels.conv3d_small import conv3d_from1_body, conv3d_to1_body

    def parse(site):
        chans, rest = site.split("@")
        ci, co = (int(c) for c in chans.split("->"))
        return ci, co, getattr(torch, rest.split()[-1])

    bodies = {}
    for site in build.conv3d_same_sites:
        ci, co, dt = parse(site)
        ops = [torch.empty(s, dtype=dt, device=dev)
               for s in ((1, 1, 1, 1, ci), (3, 3, 3, ci, co), (1, 1, 1, 1, co))]
        bodies[f"{ci}->{co} {dtype_name(dt)}"] = conv3d_same_body(*ops)
    for site in build.conv3d_to1_sites:
        c, _, dt = parse(site)
        x = torch.empty((1, 1, 1, 1, c), dtype=dt, device=dev)
        bodies[f"to1 {c}->1 {dtype_name(dt)}"] = conv3d_to1_body(x)
    for site in build.conv3d_from1_sites:
        _, c, dt = parse(site)
        x = torch.empty((1, 1, 1, 1, 1), dtype=dt, device=dev)
        bodies[f"from1 1->{c} {dtype_name(dt)}"] = conv3d_from1_body(x, c)
    return bodies


def _require_tensor_core_bodies(what: str, bodies: dict) -> None:
    """Every site of a path whose channel counts are all multiples of 4 runs
    a tensor-core body, in bf16 and in fp32, forward and input gradient:
    conv3d_same ("wgmma", "narrow", "tf32x3", "narrow_tf32x3"), conv3d_to1
    and conv3d_from1 ("mma", "tf32x3"). "fma" there fails, and so does
    conv3d_same's superseded "mma" body at a bf16 site with Ci % 32 == 0 and
    Co % 64 == 0, which the wgmma body takes."""
    def chans(k):
        return [int(c) for c in k.split()[-2].split("->")]

    slow = {k: v for k, v in bodies.items() if v == "fma"
            and all(c % 4 == 0 for c in chans(k) if c != 1)}
    slow.update({k: v for k, v in bodies.items() if v == "mma" and len(k.split()) == 2
                 and k.endswith("bfloat16") and chans(k)[0] % 32 == 0 and chans(k)[1] % 64 == 0})
    if slow:
        raise SystemExit(f"chip_smoke: {what} ran the fma or a superseded body at {slow}")


# bf16 forward against fp32 forward of the same FC weights: bf16 keeps 8
# significant bits (a rounding is <= 2^-9 relative) and the forward rounds the
# activations after each of its ~20 layers (convs, BN, activations, pools,
# the Linears), so the errors add up; the same comparison of this
# architecture on the CPU (plain versions, 32^3 volumes) reads 0.8e-2 (mu)
# and 1.5e-2 (reconstruction) of the largest fp32 value. 5e-2 leaves 3x room;
# a wrong kernel body is off by O(1).
TOL_FC_FORWARD = 5e-2


def fc_forward_check(dev, real) -> None:
    """One whole fc_150 forward, eval mode, on the volumes `real`: encode, and
    decode of the fp32 forward's mu, in bf16 (its convs run the "narrow" and
    C->1 / 1->C tensor-core bodies) against the same weights in fp32 on the
    card (its convs on the fp32 bodies, "narrow_tf32x3" and "tf32x3": the two
    forwards share no kernel body)."""
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import get_model_config, make_model

    cfg32 = get_model_config("fc_150")
    model32 = make_model(cfg32, device=dev, seed=0)
    model16 = make_model(dataclasses.replace(cfg32, dtype=torch.bfloat16), device=dev, seed=0)
    with torch.no_grad():
        mu32, _ = model32.encode(real)
        rec32 = model32.decode(mu32)
        build.reset_launches()
        mu16, _ = model16.encode(real)
        rec16 = model16.decode(mu32)
        torch.cuda.synchronize()
    bodies = site_bodies(dev)
    e_mu, e_rec = _rel(mu16, mu32), _rel(rec16, rec32)
    ok = (e_mu <= TOL_FC_FORWARD and e_rec <= TOL_FC_FORWARD and mu16.shape == mu32.shape
          and rec16.shape == real.shape and bool(torch.isfinite(rec16).all()))
    log(f"[families] fc_150 forward, eval, {real.shape[0]} volumes: bf16 vs fp32 on the card, "
        f"mu rel {e_mu:.3e}, reconstruction rel {e_rec:.3e} (limit {TOL_FC_FORWARD}); bf16 "
        f"launches {dict(build.launches)}; bodies {json.dumps(bodies)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: fc_150 bf16 forward disagrees with its fp32 forward")
    _require_tensor_core_bodies("the fc_150 bf16 forward", bodies)
    build.reset_launches()


def phase_families(dev, real) -> dict:
    """z600 and z600-wide (fc_150, fc_600) train steps at full width, one
    fp32 tiny_fc step card vs CPU, one epoch of the vae, cae and vae2soft
    presets through the CLI's code, and the spatial_150 classifier."""
    import os
    import tempfile

    import numpy as np

    from sivae_torch.cli import train as cli_train
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
    from sivae_torch.eval.confusion import predict_all
    from sivae_torch.kernels import build
    from sivae_torch.models.blocks import Conv3d
    from sivae_torch.models.classifier import ResNetClassifier
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.train.state import create_train_state, param_count
    from sivae_torch.train.step import (make_classifier_eval_step, make_classifier_train_step,
                                        make_soft_intro_train_step)

    fc_forward_check(dev, real)
    total = {}
    batch = real.shape[0]
    for preset in ("z600", "z600-wide"):
        spec = cli_train.PRESETS[preset]
        cfg = dataclasses.replace(get_model_config(spec["model"]), dtype=torch.bfloat16)
        model = make_model(cfg, device=dev, seed=0)
        state = create_train_state(model, seed=0)
        loss_cfg = SoftIntroLossConfig(beta_rec=spec["beta_rec"], beta_neg=spec["beta_neg"],
                                       beta_kl=spec["beta_kl"])
        step = make_soft_intro_train_step(model, loss_cfg, OptimConfig(), 1, cfg.input_shape)
        want = soft_intro_launches(model)
        log(f"[families] {preset}: {spec['model']} {grid_name(cfg.input_shape)} batch {batch} "
            f"bf16, z {cfg.z_ch}, channels {cfg.first_ch}/{cfg.second_ch}/{cfg.third_ch}/"
            f"{cfg.forth_ch}, {param_count(state)} parameters; per forward encoder "
            f"{conv_sites(model.encoder)} decoder {conv_sites(model.decoder)}")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        step(state, real)  # warm-up
        torch.cuda.synchronize()
        log(f"[families] {preset} warm-up step {time.perf_counter() - t0:.2f} s")
        build.reset_launches()
        step(state, real)
        torch.cuda.synchronize()
        counts, bodies = dict(build.launches), site_bodies(dev)
        log(f"[families] {preset} launches in one step {counts} (expected {want}); conv3d_same "
            f"by site {json.dumps(build.conv3d_same_sites)}; bodies {json.dumps(bodies)}")
        if counts != want:
            raise SystemExit(f"chip_smoke: {preset} step launches {counts}, expected {want}")
        _require_tensor_core_bodies(f"the {preset} step", bodies)
        total = _add_counts(total, counts)
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
        m = _metrics_line(metrics)
        log(f"[families] {preset} {REPEATS} steps: median {median:.4f} s/step, min {times[0]:.4f}, "
            f"max {times[-1]:.4f}; {batch / median:.2f} vol/s; peak memory {peak_gib:.2f} GiB; "
            f"metrics {json.dumps(m)}")
        if m["nan"] or not all(math.isfinite(v) for k, v in m.items() if k != "nan"):
            raise SystemExit(f"chip_smoke: {preset} metrics not finite: {m}")
        # conv biases in front of a BN are left out: their gradient is
        # rounding noise, which may round to exactly 0
        biases = {f"{n}.bias" for n, c in model.named_modules()
                  if isinstance(c, Conv3d) and c.bias is not None}
        after = model.state_dict()
        same = [k for k, v in before.items() if k not in biases
                and not k.endswith("num_batches_tracked") and torch.equal(v, after[k])]
        log(f"[families] {preset}: unchanged tensors (conv biases in front of a BN aside) "
            f"{same} of {len(before)}")
        if same:
            raise SystemExit(f"chip_smoke: {preset} left tensors unchanged: {same}")
        if preset == "z600":
            profile_window(f"{preset} train step, batch {batch}", lambda: step(state, real),
                           top=15)
        del state, step, model, before
        torch.cuda.empty_cache()

    # one fp32 FC step through the kernels (card) against the plain versions
    # (CPU); every FC conv but the output one has a bias in front of a BN
    tiny = get_model_config("tiny_fc")
    n_bn_biases = sum(1 for m in make_model(tiny, device="cpu").modules()
                      if isinstance(m, Conv3d) and m.bias is not None) - 1
    card_vs_cpu_step(dev, tiny, n_bn_biases + 6)

    # vae, cae and vae2soft: one epoch of 2 steps each through the CLI's code
    # below its split, on phase 8's 24 volumes (16 train, 8 validation), with
    # no figures wherever it runs (as in phase 8)
    sys.modules["matplotlib"] = None
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_families_")
    common = ["--synthetic", "24", "--batch", "8", "--epochs", "1", "--device", str(dev)]
    shape = get_model_config("spatial_150").input_shape
    src = BrainDataSource(cli_train.load_records(cli_train.parse_args(common), shape))
    pids = sorted(set(src.pids))
    is_val = np.array([pids.index(p) % 3 == 2 for p in src.pids])
    train_src, val_src = src.subset(np.flatnonzero(~is_val)), src.subset(np.flatnonzero(is_val))
    for preset in ("vae", "cae", "vae2soft"):
        run_dir = os.path.join(tmp.name, preset)
        args = cli_train.parse_args(["--preset", preset, "--run-dir", run_dir] + common)
        probe = make_model(get_model_config(cli_train.PRESETS[preset]["model"]), device="cpu")
        want = plain_launches(probe, 2, 1)
        if preset == "vae2soft":
            soft = _add_counts({k: 2 * v for k, v in soft_intro_launches(probe).items()},
                               soft_intro_eval_launches(probe))
            want = _add_counts(want, soft)
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = cli_train.train_on_split(args, train_src, val_src)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts, bodies = dict(build.launches), site_bodies(dev)
        files = ["args.json", "train_result.csv", "metrics.jsonl", os.path.join("ckpt", "0.pth")]
        if preset == "vae2soft":
            files += [os.path.join("vae_stage", "train_losses.txt"),
                      os.path.join("vae_stage", "ckpt", "0.pth")]
        missing = [f for f in files if not os.path.exists(os.path.join(run_dir, f))]
        hist = trainer.logger.history
        finite = all(math.isfinite(v) for vals in hist.values() for v in vals)
        log(f"[families] {preset} epoch (2 steps, 1 validation step, checkpoint, the model's "
            f"build) {epoch_s:.2f} s; launches {counts} (expected {want}); bodies "
            f"{json.dumps(bodies)}; run files missing {missing}; last epoch "
            f"{json.dumps({k: v[-1] for k, v in hist.items()})}")
        if counts != want or missing or not finite or trainer.state.step != 2:
            raise SystemExit(f"chip_smoke: {preset} epoch: launches {counts} (expected {want}), "
                             f"missing {missing}, finite {finite}, step {trainer.state.step}")
        _require_tensor_core_bodies(f"the {preset} epoch", bodies)
        total = _add_counts(total, counts)
        del trainer
        torch.cuda.empty_cache()
    tmp.cleanup()

    # the classifier on spatial_150: 3 steps on the 24 volumes' labels, then
    # predict_all over them
    cfg = dataclasses.replace(get_model_config("spatial_150"), dtype=torch.bfloat16)
    model = ResNetClassifier(cfg, num_classes=2, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    state = create_train_state(model, seed=0, joint_optimizer=True)
    step = make_classifier_train_step(model, OptimConfig(), 3)
    pipe = DataPipeline(src, 8, device=dev, shuffle=False)
    f = conv_sites(model)
    want = {"conv3d_same": 3 * 2 * f["conv3d_same"] + 3 * f["conv3d_same"], "conv3d_to1": 0,
            "conv3d_from1": 3 * f["conv3d_from1"] + 3 * f["conv3d_from1"],
            "conv3d_fused_stats": 0}
    build.reset_launches()
    losses = [float(step(state, vox, lab)[1]["loss"]) for vox, lab in pipe.epoch(0)]
    preds, labels, acc = predict_all(make_classifier_eval_step(model), state, pipe)
    torch.cuda.synchronize()
    counts, bodies = dict(build.launches), site_bodies(dev)
    log(f"[families] classifier spatial_150 bf16 batch 8: losses {losses}, predict_all accuracy "
        f"{acc:.3f} over {len(preds)} volumes; launches {counts} (expected {want}); bodies "
        f"{json.dumps(bodies)}")
    _require_tensor_core_bodies("the classifier", bodies)
    if (counts != want or len(losses) != 3 or not all(math.isfinite(v) for v in losses)
            or preds.shape != (24,) or not np.array_equal(labels, src.labels)):
        raise SystemExit(f"chip_smoke: classifier: launches {counts} (expected {want}), "
                         f"losses {losses}, predictions {preds.shape}")
    total = _add_counts(total, counts)
    del state, step, model, pipe
    torch.cuda.empty_cache()
    build.reset_launches()
    return total


# ---------------------------------------------------------------------------
# phase 10: data parallelism, and the fullsize step
# ---------------------------------------------------------------------------

DDP_WORLD = 2
DDP_LIMIT_S = 600            # each rank process's time limit, build load included
LAUNCHER_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# a stand-in for scikit-learn's StratifiedGroupKFold, put on the train CLI's
# path only where scikit-learn does not import (the card's machine): folds by
# patient rank
SKLEARN_STUB = (
    "import numpy as np\n\n\n"
    "class StratifiedGroupKFold:\n"
    "    def __init__(self, n_splits=5, shuffle=False, random_state=None):\n"
    "        self.n_splits = n_splits\n\n"
    "    def split(self, X, y, groups):\n"
    "        groups = [str(g) for g in groups]\n"
    "        uniq = sorted(set(groups))\n"
    "        fold = np.array([uniq.index(g) % self.n_splits for g in groups])\n"
    "        for k in range(self.n_splits):\n"
    "            yield np.flatnonzero(fold != k), np.flatnonzero(fold == k)\n")


def split_by_patient(src):
    """Phase 8's split without scikit-learn: every third patient's volumes to
    validation."""
    import numpy as np

    pids = sorted(set(src.pids))
    is_val = np.array([pids.index(p) % 3 == 2 for p in src.pids])
    return src.subset(np.flatnonzero(~is_val)), src.subset(np.flatnonzero(is_val))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launcher_free_env() -> dict:
    import os

    return {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}


def ddp_equality_step(dev, reverse: bool = False) -> dict:
    """Part (a) on this process's rows (all of them in one process): one
    fp32 spatial_1200 step, TF32 off, no dropout, global batch 4 of phase
    5's volumes (seed 7), the fixed numpy noise batch of seed 11,
    `zero_noise` (every reparameterisation returns mu, as in phase 7's
    card-vs-CPU step) and a learning rate of 0. Adam's first update is
    lr * sign(g): a gradient that is rounding noise (a conv bias or a
    1-channel 1x1 conv weight in front of a BN, whose exact gradient is 0;
    any near-cancelling element) moves its parameter by +-lr, and phase D's
    forwards read the updated encoder, so at the default rate both runs
    differ by what fp32's sum order alone does, amplified (a batch in
    reverse order in one process differs from one process as much, on the
    card). At lr 0 phase D reads the same encoder; the first moments still
    hold the whole gradient of both phases and the running statistics all
    13 forwards. `reverse` takes the batch's rows (volumes and noise) in
    reverse order: the same step in exact arithmetic, its sums in another
    order. Metrics, first moments and BN running statistics on the CPU, the
    names of the tensors whose exact gradient is 0, and the state's
    digest."""
    import numpy as np

    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.parallel import local_batch_slice, replicate_state
    from sivae_torch.parallel.mesh import state_digest
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    cfg = get_model_config("spatial_1200")
    cfg = dataclasses.replace(cfg, act=cfg.act.with_no_dropout())
    real = synthetic_volumes(torch.device("cpu"), 4)[1][local_batch_slice(4)].to(dev)
    fixed = np.random.RandomState(11).randn(4, cfg.latent_dim).astype(np.float32)
    if reverse:
        real, fixed = real.flip(0), np.ascontiguousarray(fixed[::-1])
    model = make_model(cfg, device=dev, seed=0)
    state = replicate_state(create_train_state(model, seed=0))
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(lr=0.0), 1,
                                      cfg.input_shape, zero_noise=True, fixed_noise=fixed)
    _, metrics = step(state, real)
    torch.cuda.synchronize()
    names = {p: k for k, p in model.named_parameters()}
    out = {"metrics": _metrics_line(metrics),
           "moments": {names[p]: s["exp_avg"].detach().cpu()
                       for opt in (state.opt_e, state.opt_d) for p, s in opt.state.items()},
           "stats": {k: v.detach().cpu() for k, v in model.state_dict().items()
                     if "running" in k},
           "zero_grad": zero_gradient_tensors(model), "digest": state_digest(state).hex()}
    del state, step, model, real
    torch.cuda.empty_cache()
    return out


def zero_gradient_tensors(model) -> list:
    """The parameters whose gradient is 0 in exact arithmetic: the bias of a
    conv in front of a train-mode BN (the mean subtraction cancels it), and
    the weight of a 1x1 conv from one channel in front of one (it scales
    each channel, which the BN normalises away)."""
    from sivae_torch.models.blocks import BatchNorm, Conv3d

    out = []
    for name, mod in model.named_modules():
        kids = list(mod.named_children())
        for (cname, conv), (_, nxt) in zip(kids, kids[1:]):
            if isinstance(conv, Conv3d) and isinstance(nxt, BatchNorm):
                if conv.bias is not None:
                    out.append(f"{name}.{cname}.bias")
                if conv.in_ch == 1 and conv.kernel_size == 1:
                    out.append(f"{name}.{cname}.weight")
    return out


def ddp_flagship_rank(dev) -> dict:
    """Part (b), one rank: spatial_1200 bf16 with dropout, 4 of a global
    batch of 8 of phase 5's volumes; a warm-up step, one counted step
    (launches and all-reduces), 5 timed steps, one step under the profiler
    on rank 0, peak memory, the digest."""
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.parallel import local_batch_slice, rank, replicate_state
    from sivae_torch.parallel.mesh import collectives, reset_collectives, state_digest
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    cfg = dataclasses.replace(get_model_config("spatial_1200"), dtype=torch.bfloat16)
    real = synthetic_volumes(torch.device("cpu"), 8)[1][local_batch_slice(8)].to(dev)
    model = make_model(cfg, device=dev, seed=0)
    state = replicate_state(create_train_state(model, seed=0))
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape)
    torch.cuda.reset_peak_memory_stats(dev)
    step(state, real)   # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    reset_collectives()
    step(state, real)
    torch.cuda.synchronize()
    counts, coll = dict(build.launches), {k: list(v) for k, v in collectives.items()}
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, real)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # one more step on both ranks (their collectives pair up), rank 0's
    # under the profiler: its own kernels only, so its idle share holds the
    # other rank's turns on the card as well as the waits
    if rank() == 0:
        profile_window("data-parallel step, rank 0 of 2 sharing the card", lambda: step(state, real),
                       top=12)
    else:
        step(state, real)
    replicate_state(state)
    out = {"launches": counts, "collectives": coll, "times": times,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "metrics": _metrics_line(metrics), "digest": state_digest(state).hex(),
           "batch": real.shape[0]}
    del state, step, model, real
    torch.cuda.empty_cache()
    build.reset_launches()
    return out


def ddp_trainer_rank(dev, run_dir: str) -> dict:
    """Part (c), one rank: the z1200 preset through `train_on_split` for 2
    epochs over phase 8's 24 volumes, global batch 8 (4 a rank), counted;
    the run files as this rank sees them after the fit; then a new
    trainer's `try_resume` (which checks the ranks agree)."""
    import os

    from sivae_torch.cli import train as cli_train
    from sivae_torch.config import OptimConfig
    from sivae_torch.data.pipeline import BrainDataSource
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.parallel.mesh import collectives, reset_collectives, state_digest
    from sivae_torch.train.loop import SoftIntroTrainer

    sys.modules["matplotlib"] = None   # as phase 8: no figures on any machine
    args = cli_train.parse_args(["--preset", "z1200", "--epochs", "2", "--run-dir", run_dir,
                                 "--synthetic", "24", "--batch", "8", "--device", str(dev)])
    src = BrainDataSource(cli_train.load_records(
        args, get_model_config("spatial_1200").input_shape))
    train_src, val_src = split_by_patient(src)
    build.reset_launches()
    reset_collectives()
    t0 = time.perf_counter()
    trainer = cli_train.train_on_split(args, train_src, val_src)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, coll = dict(build.launches), {k: list(v) for k, v in collectives.items()}
    files = {}
    for name in ("train_result.csv", "metrics.jsonl"):
        with open(os.path.join(run_dir, name)) as f:
            files[name] = len(f.read().splitlines())
    files["ckpt"] = trainer.ckpt.all_steps()
    end = state_digest(trainer.state).hex()
    hist = {k: v for k, v in trainer.logger.history.items()}
    again = SoftIntroTrainer(make_model(trainer.model_cfg, device=dev), trainer.loss_cfg,
                             OptimConfig(), trainer.train_cfg, run_dir=run_dir,
                             steps_per_epoch=2)
    resumed = again.try_resume()
    out = {"launches": counts, "collectives": coll, "fit_s": fit_s, "files": files,
           "world_size": args.world_size, "history": hist, "digest_end": end,
           "resumed": resumed, "digest_resumed": state_digest(again.state).hex()}
    del trainer, again
    torch.cuda.empty_cache()
    build.reset_launches()
    return out


def ddp_rank(out_dir: str) -> int:
    """One of phase 10's ranks, started by `phase_ddp` with the launcher's
    environment (both on the one card: `LOCAL_RANK` 0, gloo)."""
    import os

    from sivae_torch.kernels import build
    from sivae_torch.parallel import init_distributed, rank, shutdown
    from sivae_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    dev = init_distributed(backend="gloo")
    resolve_device(dev)   # TF32 off
    build.library()       # the parent's build, from the cache
    t0 = time.perf_counter()
    res = {"a": ddp_equality_step(dev)}
    log(f"[ddp rank {rank()}] (a) {time.perf_counter() - t0:.1f} s")
    res["b"] = ddp_flagship_rank(dev)
    log(f"[ddp rank {rank()}] (b) {time.perf_counter() - t0:.1f} s")
    res["c"] = ddp_trainer_rank(dev, os.path.join(out_dir, "z1200"))
    log(f"[ddp rank {rank()}] (c) {time.perf_counter() - t0:.1f} s")
    torch.save(res, os.path.join(out_dir, f"rank{rank()}.pth"))
    shutdown()
    return 0


def run_ranks(tag: str, args: list, world: int, out_dir: str, limit_s: float,
              own_cards: bool = False) -> list:
    """Start `world` processes of this script with `args` as the ranks of
    one process group: all on the one card (`LOCAL_RANK` 0), or with
    `own_cards` each on its own (`LOCAL_RANK` = rank); print their output;
    return what each saved to `<out_dir>/rank<r>.pth`. A rank that fails,
    or the time limit `limit_s`, ends them all (a rank's peers would wait in
    a collective) and fails the run."""
    import os

    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        env = {**_launcher_free_env(), "RANK": str(r), "LOCAL_RANK": str(r if own_cards else 0),
               "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // world))}
        logs.append(open(os.path.join(out_dir, f"{tag}_rank{r}.log"), "w+"))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)] + args,
                                      env=env, stdout=logs[-1], stderr=subprocess.STDOUT,
                                      text=True))
    deadline = time.monotonic() + limit_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for r, f in enumerate(logs):
            f.seek(0)
            for line in f.read().splitlines():
                log(f"[{tag} rank {r} output] {line}")
            f.close()
    if any(p.returncode != 0 for p in procs):
        raise SystemExit(f"chip_smoke: a {tag} rank failed or ran out of time: "
                         f"{[p.returncode for p in procs]}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pth"), weights_only=False)
            for r in range(world)]


def _compare_equality(ref: dict, ctl: dict, ranks: list) -> list:
    """(a): the mean of the ranks' lossE / lossD within 1e-4 relative of one
    process's; each first moment within 1e-3 of max|m| of its tensor (one
    that is exactly 0 in one process exactly 0 in the ranks too), or within
    twice what one process's step on the reversed batch (`ctl`: the same
    step in exact arithmetic) differs by: a weight gradient of a conv in
    front of a BN at full width is a sum of ~1e8 products that nearly
    cancel, and fp32's sum order alone moves it by up to ~6e-3 of its
    largest element on the card; those whose exact gradient is 0
    (`zero_gradient_tensors`) hold rounding noise and must stay below 1e-2
    of the model's largest moment in both runs; each BN running statistic
    within 1e-5 of the largest running statistic; the ranks' digests
    equal."""
    two, zero = ranks[0], set(ref["zero_grad"])
    rel = {k: abs(sum(r["metrics"][k] for r in ranks) / len(ranks) - ref["metrics"][k])
           / abs(ref["metrics"][k]) for k in ("lossE", "lossD")}
    top_m = max(m.abs().max().item() for m in ref["moments"].values())

    def err(got, want):
        scale = want.abs().max().item()
        # an exactly-zero moment (the zero-initialised logvar head under
        # zero_noise) must be exactly zero in both runs
        return (got - want).abs().max().item() / scale if scale else float(bool(got.any()))

    worst, noise, bad, by_ctl, ctl_over = (0.0, "", 0.0), 0.0, [], 0, 0
    for k, want in ref["moments"].items():
        got = two["moments"][k]
        if k in zero:
            noise = max(noise, want.abs().max().item() / top_m, got.abs().max().item() / top_m)
            continue
        e, e_ctl = err(got, want), err(ctl["moments"][k], want)
        worst = max(worst, (e, k, e_ctl))
        ctl_over += e_ctl > 1e-3
        if e > 1e-3:
            by_ctl += e <= 2 * e_ctl
            if e > 2 * e_ctl:
                bad.append((k, e, e_ctl))
    top_s = max(v.abs().max().item() for v in ref["stats"].values())
    stat_worst = max(((two["stats"][k] - v).abs().max().item() / top_s, k)
                     for k, v in ref["stats"].items())
    same = len({r["digest"] for r in ranks}) == 1
    log(f"[ddp] (a) fp32 spatial_1200 80x96x80 step at lr 0, global batch 4: {len(ranks)} gloo "
        f"ranks x 2 on the card vs one process x 4 on the card: lossE rel {rel['lossE']:.2e}, "
        f"lossD rel {rel['lossD']:.2e} (limit 1e-4); first moments of "
        f"{len(ref['moments']) - len(zero)} tensors worst {worst[0]:.2e} of max|m| at {worst[1]} "
        f"(the reversed batch there {worst[2]:.2e}); over 1e-3: {by_ctl} tensors, each within "
        f"2x the reversed batch's difference (which is over 1e-3 at {ctl_over} tensors itself); "
        f"{len(zero)} with an exact gradient of 0 {sorted(zero)} at most {noise:.2e} of the "
        f"largest moment (limit 1e-2); BN running statistics worst {stat_worst[0]:.2e} of the "
        f"largest {top_s:.3f} at {stat_worst[1]} (limit 1e-5); ranks' digests equal {same}")
    if max(rel.values()) > 1e-4 or bad or noise > 1e-2 or stat_worst[0] > 1e-5 or not same:
        return [f"(a) 2 ranks disagree with one process: {rel} {bad} noise {noise:.2e} "
                f"{stat_worst} digests equal {same}"]
    return []


def _cli_world_of_one(tmp: str) -> None:
    """`python -m sivae_torch.cli.train` with `WORLD_SIZE=1`: the CLI joins an
    NCCL group of one on the card (its digest gather, its checkpoint
    broadcast and barrier run through NCCL), tiny_spatial, 1 epoch, batch 4,
    must exit 0 with its run files."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    run_dir = os.path.join(tmp, "cli")
    env = {**_launcher_free_env(), "RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    note = "scikit-learn's split"
    try:
        import sklearn  # noqa: F401
    except ImportError:
        stub = os.path.join(tmp, "stub", "sklearn")
        os.makedirs(stub)
        open(os.path.join(stub, "__init__.py"), "w").close()
        with open(os.path.join(stub, "model_selection.py"), "w") as f:
            f.write(SKLEARN_STUB)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(stub)] + [p for p in [env.get("PYTHONPATH")] if p])
        note = "no scikit-learn here: a patient-rank split stands in for its StratifiedGroupKFold"
    cmd = [sys.executable, "-m", "sivae_torch.cli.train", "--preset", "z1200", "--model",
           "tiny_spatial", "--synthetic", "24", "--epochs", "1", "--batch", "4", "--run-dir",
           run_dir]
    t0 = time.perf_counter()
    try:
        done = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=300)
    except subprocess.TimeoutExpired as e:
        raise SystemExit(f"chip_smoke: the train CLI with WORLD_SIZE=1 did not end: {e}")
    files = ["args.json", "train_result.csv", "metrics.jsonl", os.path.join("ckpt", "0.pth")]
    missing = [f for f in files if not os.path.exists(os.path.join(run_dir, f))]
    world = None
    if "args.json" not in missing:
        with open(os.path.join(run_dir, "args.json")) as f:
            world = json.load(f).get("world_size")
    log(f"[ddp] (c) python -m sivae_torch.cli.train under WORLD_SIZE=1 (NCCL), tiny_spatial, "
        f"1 epoch: exit {done.returncode} in {time.perf_counter() - t0:.1f} s, world_size "
        f"{world}, run files missing {missing} ({note})")
    if done.returncode != 0 or missing or world != 1:
        raise SystemExit(f"chip_smoke: the train CLI with WORLD_SIZE=1 failed:\n"
                         f"{done.stdout[-3000:]}\n{done.stderr[-3000:]}")


def ddp_fullsize(dev, card: str) -> tuple:
    """(d): spatial_1200_fullsize (160x192x160) bf16, batch 1, dropout on:
    a warm-up step, one counted step against the counts derived from the
    model, 3 timed steps, peak memory, finite metrics. Returns (the counted
    launches, the peak GiB)."""
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.data.synthetic import SyntheticBrainSource
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.train.state import create_train_state, param_count
    from sivae_torch.train.step import make_soft_intro_train_step

    cfg = dataclasses.replace(get_model_config("spatial_1200_fullsize"), dtype=torch.bfloat16)
    raw = SyntheticBrainSource(1, cfg.input_shape, seed=7).records[0]["voxel"]
    real = preprocess_batch(torch.from_numpy(raw[None]).to(dev))
    model = make_model(cfg, device=dev, seed=0)
    state = create_train_state(model, seed=0)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape)
    want = soft_intro_launches(model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step(state, real)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    build.reset_launches()
    step(state, real)
    torch.cuda.synchronize()
    counts = dict(build.launches)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, real)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    m = _metrics_line(metrics)
    log(f"[ddp] (d) spatial_1200_fullsize {grid_name(cfg.input_shape)} bf16 batch 1, dropout "
        f"on, {param_count(state)} parameters ({card}): warm-up {warm:.2f} s; 3 steps median "
        f"{times[1]:.4f} s/step, min {times[0]:.4f}, max {times[2]:.4f}; peak memory "
        f"{peak:.2f} GiB of {torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}; "
        f"launches {counts} (expected {want}); metrics {json.dumps(m)}")
    if counts != want:
        raise SystemExit(f"chip_smoke: fullsize step launches {counts}, expected {want}")
    if m["nan"] or not all(math.isfinite(v) for k, v in m.items() if k != "nan"):
        raise SystemExit(f"chip_smoke: fullsize metrics not finite: {m}")
    del state, step, model, real
    torch.cuda.empty_cache()
    build.reset_launches()
    return counts, peak


def phase_ddp(dev, card: str) -> tuple:
    """(a) one process's fp32 reference step here, then 2 gloo ranks on the
    card (`ddp_rank`: (a), (b), (c)), compared; the CLI under WORLD_SIZE=1;
    (d) the fullsize step. Returns (the ranks' counted launches summed, the
    fullsize step's launches, its peak GiB)."""
    import tempfile

    from sivae_torch.kernels import build

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_")
    t0 = time.perf_counter()
    ref = ddp_equality_step(dev)
    ctl = ddp_equality_step(dev, reverse=True)
    log(f"[ddp] (a) one-process reference step and its reversed batch "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks("ddp", ["--ddp-rank", tmp.name], DDP_WORLD, tmp.name, DDP_LIMIT_S)
    log(f"[ddp] {DDP_WORLD} gloo ranks on the one card (gloo all-reduces the CUDA tensors), "
        f"(a) + (b) + (c) in {time.perf_counter() - t0:.1f} s")

    failed = _compare_equality(ref, ctl, [r["a"] for r in ranks])

    b = [r["b"] for r in ranks]
    medians = [sorted(x["times"])[REPEATS // 2] for x in b]
    slow = max(range(DDP_WORLD), key=lambda r: medians[r])
    t = sorted(b[slow]["times"])
    glob = sum(x["batch"] for x in b)
    same = len({x["digest"] for x in b}) == 1
    finite = all(not x["metrics"]["nan"] and all(math.isfinite(v) for k, v in
                                                 x["metrics"].items() if k != "nan") for x in b)
    log(f"[ddp] (b) spatial_1200 bf16, dropout on, {DDP_WORLD} ranks x {b[0]['batch']} = global "
        f"{glob}, two ranks sharing one card ({card}; not a scaling figure): slower rank {slow} "
        f"median {t[REPEATS // 2]:.4f} s/step, min {t[0]:.4f}, max {t[-1]:.4f} (rank medians "
        f"{[round(x, 4) for x in medians]}); {glob / t[REPEATS // 2]:.2f} global vol/s; peak "
        f"memory per rank {[round(x['peak_gib'], 2) for x in b]} GiB; launches per rank "
        f"{[x['launches'] for x in b]} (expected {TRAIN_LAUNCHES}); all-reduces in one step "
        f"[calls, bytes] {json.dumps(b[0]['collectives'])}; digests equal {same}; metrics "
        f"{json.dumps(b[0]['metrics'])}")
    if any(x["launches"] != TRAIN_LAUNCHES for x in b) or not same or not finite:
        failed.append(f"(b) data-parallel flagship: launches {[x['launches'] for x in b]}, "
                      f"digests equal {same}, finite {finite}")

    c = [r["c"] for r in ranks]
    want = {k: 4 * TRAIN_LAUNCHES[k] + 2 * VAL_LAUNCHES[k] for k in TRAIN_LAUNCHES}
    ok = (all(x["launches"] == want and x["world_size"] == DDP_WORLD and x["resumed"] == 1
              and x["digest_resumed"] == x["digest_end"]
              and x["files"] == {"train_result.csv": 3, "metrics.jsonl": 2, "ckpt": [0, 1]}
              for x in c) and len({x["digest_end"] for x in c}) == 1)
    log(f"[ddp] (c) train_on_split, z1200, 2 epochs on {DDP_WORLD} ranks (global batch 8): fit "
        f"{[round(x['fit_s'], 2) for x in c]} s; run files as each rank reads them "
        f"{[x['files'] for x in c]} (one set: 2 CSV rows, 2 JSONL lines); launches per rank "
        f"{[x['launches'] for x in c]} (expected {want}); all-reduces per rank "
        f"{json.dumps(c[0]['collectives'])}; try_resume -> {[x['resumed'] for x in c]}, digests "
        f"end {[x['digest_end'][:12] for x in c]} resumed "
        f"{[x['digest_resumed'][:12] for x in c]}; epoch train_lossE {c[0]['history'].get('train_lossE')}")
    if not ok:
        failed.append("(c) the data-parallel trainer run is wrong")
    _cli_world_of_one(tmp.name)
    counted = {k: sum(x["launches"][k] + y["launches"][k] for x, y in zip(b, c))
               for k in TRAIN_LAUNCHES}
    full, full_peak = ddp_fullsize(dev, card)
    if failed:
        raise SystemExit("chip_smoke: phase 10: " + "; ".join(failed))
    tmp.cleanup()
    build.reset_launches()
    return counted, full, full_peak


# ---------------------------------------------------------------------------
# phase 11: rematerialisation
# ---------------------------------------------------------------------------

# (label, "block" (the config's remat) / "calls" (the step's remat_calls) /
# None (off), policy) of phase 11 (a)
REMAT_MODES = [("off", None, None)] + [
    (f"remat {p}", "block", p) for p in (None, "conv_outs", "conv_outs_lo",
                                         "conv_outs_no_dec_hi", "conv_outs_no_enc_hi")] + [
    ("remat_calls", "calls", None)]


def _first_moments(state) -> dict:
    names = {p: k for k, p in state.model.named_parameters()}
    return {names[p]: s["exp_avg"].detach().float().cpu()
            for opt in (state.opt_e, state.opt_d) for p, s in opt.state.items()}


def _moments_worst(got: dict, want: dict):
    """(worst |got - want| / max(max|want| of the tensor, 1e-2 * the largest
    moment), its tensor): phase 7's per-tensor rule with its floor."""
    floor = 1e-2 * max(m.abs().max().item() for m in want.values())
    return max(((got[k] - w).abs().max().item() / max(w.abs().max().item(), floor), k)
               for k, w in want.items())


def remat_launches(model, kind, policy) -> dict:
    """The launches of one step: the off counts derived from the model's
    modules, plus the convs each differentiated forward reruns, derived from
    its conv sites and the policy (`models/remat.py`)."""
    from sivae_torch.config import FCVAEConfig
    from sivae_torch.models.fc_vae import fc_conv_sites
    from sivae_torch.models.remat import soft_intro_step_recomputes
    from sivae_torch.models.resnet_vae import spatial_conv_sites

    want = soft_intro_launches(model)
    if kind is None:
        return want
    sites = fc_conv_sites if isinstance(model.cfg, FCVAEConfig) else spatial_conv_sites
    extra = soft_intro_step_recomputes(*sites(model.cfg), policy, whole_call=kind == "calls")
    return {k: want[k] + extra.get(k, 0) for k in want}


def _note_allocated(held: list, dev, zero_grad, *args, **kwargs):
    held.append(torch.cuda.memory_allocated(dev))
    return zero_grad(*args, **kwargs)


def remat_mode(dev, cfg, real, kind, policy, timed: int, profile: str = "") -> dict:
    """One mode of phase 11 from the seeded state: the warm-up step's
    metrics and first moments, a counted step, `timed` timed steps (the
    counted one among them where `timed` is below 3), the peak memory since
    the mode began; with `profile` (its label) one more step under the
    profiler."""
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import make_model
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    if kind == "block":
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = make_model(cfg, device=dev, seed=0)
    state = create_train_state(model, seed=0)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape, remat_calls=kind == "calls",
                                      remat_calls_policy=policy if kind == "calls" else None)
    want = remat_launches(model, kind, policy)
    t0 = time.perf_counter()
    _, m = step(state, real)
    torch.cuda.synchronize()
    out = {"warm_s": time.perf_counter() - t0, "metrics": _metrics_line(m),
           "moments": _first_moments(state), "want": want}
    # the bytes allocated when each phase's backward begins: its forwards'
    # saved tensors, the rest of the state and the metrics
    held = []
    for opt in (state.opt_e, state.opt_d):
        opt.zero_grad = functools.partial(_note_allocated, held, dev, opt.zero_grad)
    build.reset_launches()
    t0 = time.perf_counter()
    _, m = step(state, real)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    out["launches"] = dict(build.launches)
    for opt in (state.opt_e, state.opt_d):
        del opt.zero_grad
    out["held_gib"] = [h / 2**30 for h in held]
    times = [counted_s] if timed < 3 else []
    for _ in range(timed - len(times)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, real)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["times"] = sorted(times)
    out["last"] = _metrics_line(m)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if profile:
        profile_window(profile, lambda: step(state, real), top=15)
    del state, step, model
    torch.cuda.empty_cache()
    build.reset_launches()
    return out


def _remat_line(tag: str, label: str, r: dict, ref: Optional[dict]) -> list:
    """Print one mode's line; return what failed."""
    t = r["times"]
    failed = []
    spread = (f"{t[len(t) // 2]:.4f} s/step median, min {t[0]:.4f}, max {t[-1]:.4f} "
              f"({len(t)} steps)" if len(t) > 2 else f"s/step {[round(x, 4) for x in t]}")
    line = (f"[remat] {tag} {label}: {spread}; peak {r['peak_gib']:.2f} GiB, allocated as phase "
            f"E's and D's backward begin {[round(h, 2) for h in r['held_gib']]} GiB; launches "
            f"{r['launches']} (derived {r['want']})")
    if r["launches"] != r["want"]:
        failed.append(f"{tag} {label}: launches {r['launches']}, derived {r['want']}")
    m = r["last"]
    if m["nan"] or not all(math.isfinite(v) for k, v in m.items() if k != "nan"):
        failed.append(f"{tag} {label}: metrics not finite {m}")
    if ref is not None:
        rel = {k: abs(r["metrics"][k] - ref["metrics"][k]) / abs(ref["metrics"][k])
               for k in ("lossE", "lossD")}
        worst, where = _moments_worst(r["moments"], ref["moments"])
        line += (f"; warm-up step vs off: lossE rel {rel['lossE']:.2e}, lossD rel "
                 f"{rel['lossD']:.2e} (limit 1e-4), first moments worst {worst:.2e} of max|m| "
                 f"at {where} (limit 1e-3); peak {r['peak_gib'] / ref['peak_gib']:.3f} of off's")
        if max(rel.values()) > 1e-4 or worst > 1e-3:
            failed.append(f"{tag} {label}: step vs off {rel}, moments {worst:.2e} at {where}")
        if not r["peak_gib"] < ref["peak_gib"]:
            failed.append(f"{tag} {label}: peak {r['peak_gib']:.2f} GiB not below off's "
                          f"{ref['peak_gib']:.2f}")
    log(line)
    return failed


def phase_remat(dev, vox, fullsize_b1_gib: Optional[float]) -> dict:
    """Phase 11 (module docstring): (a) the flagship per mode, (b) the
    batches beyond one card without remat, (c) fc_150. `fullsize_b1_gib`
    is phase 10 (d)'s peak (None where it did not run), scaled for the
    no-remat peak printed beside (b)'s fullsize one."""
    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.data.synthetic import SyntheticBrainSource
    from sivae_torch.models.registry import get_model_config

    import numpy as np

    t_phase = time.perf_counter()
    failed = []
    bf16 = torch.bfloat16
    cfg = dataclasses.replace(get_model_config("spatial_1200"), dtype=bf16)
    real = vox[:8]
    results = {}
    for label, kind, policy in REMAT_MODES:
        # where the added time goes: the step without remat and with the
        # default policy, each under the profiler once
        prof = (f"(a) spatial_1200 bf16 batch 8 {label} step"
                if label in ("off", f"remat {cfg.remat_policy}") else "")
        results[label] = remat_mode(dev, cfg, real, kind, policy, REPEATS, prof)
        failed += _remat_line("(a) spatial_1200 bf16 batch 8", label, results[label],
                              None if label == "off" else results["off"])
    off_gib = results["off"]["peak_gib"]

    big = torch.cat([vox, vox[:16]])
    for label, kind in (("remat_calls", "calls"), ("remat None", "block")):
        r = remat_mode(dev, cfg, big, kind, None, 2)
        failed += _remat_line("(b) spatial_1200 bf16 batch 48", label, r, None)
        log(f"[remat] (b) spatial_1200 batch 48 {label}: peak {r['peak_gib']:.2f} GiB against "
            f"{6 * off_gib:.1f} GiB without remat (6 x (a)'s off peak), card "
            f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f} GiB; warm-up "
            f"{r['warm_s']:.2f} s")
    del big
    full = dataclasses.replace(get_model_config("spatial_1200_fullsize"), dtype=bf16)
    # 4 synthetic volumes, each 4 times: making 16 on the host takes longer
    raw = np.stack([r["voxel"] for r in SyntheticBrainSource(4, full.input_shape, seed=7)])
    real16 = preprocess_batch(torch.from_numpy(raw).to(dev)).repeat(4, 1, 1, 1, 1)
    r = remat_mode(dev, full, real16, "calls", None, 2)
    failed += _remat_line("(b) spatial_1200_fullsize bf16 batch 16", "remat_calls", r, None)
    scaled = ("phase 10 (d) did not run" if fullsize_b1_gib is None else
              f"against {16 * fullsize_b1_gib:.1f} GiB without remat (16 x phase 10 (d)'s "
              f"batch-1 peak)")
    log(f"[remat] (b) spatial_1200_fullsize batch 16 remat_calls: peak {r['peak_gib']:.2f} GiB "
        f"{scaled}; warm-up {r['warm_s']:.2f} s")
    del real16

    fc = dataclasses.replace(get_model_config("fc_150"), dtype=bf16)
    fc_off = remat_mode(dev, fc, real, None, None, 3)
    failed += _remat_line("(c) fc_150 bf16 batch 8", "off", fc_off, None)
    fc_on = remat_mode(dev, fc, real, "block", fc.remat_policy, 3)
    failed += _remat_line("(c) fc_150 bf16 batch 8", f"remat {fc.remat_policy}", fc_on, fc_off)
    log(f"[remat] phase 11 in {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise SystemExit("chip_smoke: phase 11: " + "; ".join(failed))
    return {k: v["launches"] for k, v in results.items()}


# ---------------------------------------------------------------------------
# phase 12: depth sharding
# ---------------------------------------------------------------------------

DEPTH_LIMIT_S = 600          # each rank process's time limit, build load included
DEPTH_A_WORLD, DEPTH_B_WORLD = 2, 4
TOL_DEPTH_ZERO_GRAD = 1e-4  # an exactly-zero gradient's moment, of the largest moment
TOL_DEPTH_ENCODE = 1e-3


def _fullsize_cfg(dtype, dropout: bool):
    from sivae_torch.models.registry import get_model_config

    cfg = dataclasses.replace(get_model_config("spatial_1200_fullsize"), dtype=dtype)
    return cfg if dropout else dataclasses.replace(cfg, act=cfg.act.with_no_dropout())


def _fc_cfg(dtype):
    """fc_600, the z600-wide preset's model, at its published widths (the FC
    family has no dropout)."""
    from sivae_torch.models.registry import get_model_config

    return dataclasses.replace(get_model_config("fc_600"), dtype=dtype)


def _step_inputs(inp: dict, family: str) -> tuple:
    """(the step's fp32 config, its 2 volumes, its fixed noise batch) of
    (a) ("fullsize") or (d) ("fc": phase 5's first 2 volumes)."""
    if family == "fc":
        return _fc_cfg(torch.float32), inp["vox"][:2], inp["fc_fixed"].numpy()
    return _fullsize_cfg(torch.float32, False), inp["full"], inp["fixed"].numpy()


def depth_inputs(path: str) -> dict:
    """The phase's inputs, made once and saved for its rank processes: 2
    fullsize synthetic volumes (seed 7, preprocessed), the fixed numpy noise
    batch of seed 11 (and one of fc_600's latent width, seed 13), and phase
    5's first 8 spatial_1200 volumes, on the host."""
    import numpy as np

    from sivae_torch.data.preprocess import preprocess_batch
    from sivae_torch.data.synthetic import SyntheticBrainSource

    cfg = _fullsize_cfg(torch.float32, False)
    raw = np.stack([r["voxel"] for r in SyntheticBrainSource(2, cfg.input_shape, seed=7)])
    fixed = np.random.RandomState(11).randn(2, cfg.latent_dim).astype(np.float32)
    fc_fixed = np.random.RandomState(13).randn(2, _fc_cfg(torch.float32).z_ch)
    inp = {"full": preprocess_batch(torch.from_numpy(raw)), "fixed": torch.from_numpy(fixed),
           "fc_fixed": torch.from_numpy(fc_fixed.astype(np.float32)),
           "vox": synthetic_volumes(torch.device("cpu"), 8)[1]}
    torch.save(inp, path)
    return inp


def _library_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 3x3x3 SAME conv of NDHWC `x` and DHWIO `w` by the library
    (cuDNN), in their dtype: the float64 yardstick's convs."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(), w.permute(4, 3, 0, 1, 2).contiguous(),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1)


def depth_step(dev, inp: dict, mesh=None, reverse: bool = False, exact: bool = False,
               family: str = "fullsize") -> dict:
    """(a) on this process's depth slab (the whole batch without `mesh`): one
    fp32 spatial_1200_fullsize step at its published widths, 160x192x160,
    TF32 off, no dropout, global batch 2, the fixed noise batch, zero_noise
    and a learning rate of 0 (`ddp_equality_step` says why; `reverse` as
    there), counted: metrics, first moments, running statistics, the
    tensors whose exact gradient is 0, the digest, launches against the
    derived counts, collectives, seconds and peak GiB. With `exact` the
    same step in float64, the same weights, every conv by cuDNN in float64
    (the kernels have no float64 form): the yardstick of the fp32 runs.
    `family` "fc": (d), the same for fc_600 at 80x96x80 (`_step_inputs`)."""
    import numpy as np

    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.kernels import build
    from sivae_torch.models import blocks
    from sivae_torch.models.registry import make_model
    from sivae_torch.models.resnet_vae import depth_levels
    from sivae_torch.parallel import replicate_state
    from sivae_torch.parallel.mesh import (collectives, reset_collectives, shard_batch,
                                           state_digest)
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    cfg, real, fixed = _step_inputs(inp, family)
    if reverse:
        real, fixed = real.flip(0), np.ascontiguousarray(fixed[::-1])
    if mesh is not None:
        real = shard_batch(real, mesh, spatial_axis="spatial", levels=depth_levels(cfg))
    model = make_model(cfg, device=dev, seed=0)
    kernels = dict(blocks._KERNELS)
    if exact:
        f64 = torch.float64
        wide = make_model(dataclasses.replace(cfg, dtype=f64, param_dtype=f64), device=dev)
        wide.load_state_dict(model.state_dict())
        model, real = wide, real.to(f64)
        blocks._KERNELS.update(dict.fromkeys(kernels, _library_conv))
    real = real.to(dev)
    state = replicate_state(create_train_state(model, seed=0))
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(lr=0.0), 1,
                                      cfg.input_shape, zero_noise=True, fixed_noise=fixed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    reset_collectives()
    t0 = time.perf_counter()
    try:
        _, metrics = step(state, real)
        torch.cuda.synchronize()
    finally:
        blocks._KERNELS.update(kernels)
    secs = time.perf_counter() - t0
    names = {p: k for k, p in model.named_parameters()}
    out = {"metrics": _metrics_line(metrics),
           "moments": {names[p]: s["exp_avg"].detach().double().cpu()
                       for opt in (state.opt_e, state.opt_d) for p, s in opt.state.items()},
           "stats": {k: v.detach().double().cpu() for k, v in model.state_dict().items()
                     if "running" in k},
           "zero_grad": zero_gradient_tensors(model), "digest": state_digest(state).hex(),
           "launches": dict(build.launches),
           "want": ({k: 0 for k in TRAIN_LAUNCHES} if exact else soft_intro_launches(model)),
           "collectives": {k: list(v) for k, v in collectives.items()}, "s": secs,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "slab": tuple(real.shape[2:])}
    del state, step, model, real
    torch.cuda.empty_cache()
    build.reset_launches()
    return out


def _depth_moment_check(grid: dict, ref: dict, ctl: dict, exact: dict) -> tuple:
    """Step 0's rule on first moments `grid` (name: tensor), the float64
    step (`exact`) the yardstick (`_compare_depth`): (the tensors over the
    limit, the largest ratio of the grid's distance from float64 to the
    farther of one process's two fp32 steps' with its tensor, the largest
    exactly-zero gradient over the largest moment)."""
    top = max(m.abs().max().item() for m in exact["moments"].values())
    bad, noise, worst = [], 0.0, (0.0, "")
    for k, want in exact["moments"].items():
        runs = {"grid": grid[k], "one": ref["moments"][k], "rev": ctl["moments"][k]}
        scale = want.abs().max().item()
        if k in exact["zero_grad"] and scale <= 1e-12 * top:
            noise = max([noise] + [v.abs().max().item() / top for v in runs.values()])
            continue
        dist = {n: (v - want).abs().max().item() for n, v in runs.items()}
        lim = 2 * max(dist["one"], dist["rev"]) + 1e-4 * scale + 1e-6 * top
        worst = max(worst, (dist["grid"] / max(dist["one"], dist["rev"], 1e-300), k))
        if dist["grid"] > lim:
            bad.append((k, dist["grid"] / scale, dist["one"] / scale, dist["rev"] / scale))
    if noise >= TOL_DEPTH_ZERO_GRAD:
        bad.append(("exactly-zero gradients", noise, 0.0, 0.0))
    return bad, worst, noise


def _compare_depth(ref: dict, ctl: dict, exact: dict, ranks: list, what: str,
                   part: str = "a") -> list:
    """(a) (and (d), `part`): the mean of the ranks' lossE / lossD within 1e-4 relative of one
    process's fp32 step; BN running statistics within 1e-5 of the largest;
    the ranks' digests equal. First moments by step 0's rule
    (tests/torch_port_common.py `assert_nearer_float64`), the float64 step
    (`exact`) the yardstick: each tensor of the grid's fp32 step at most
    twice as far from the float64 moment as the farther of one process's
    two fp32 steps (the batch as it is and reversed: the same step, its sums
    in other orders) plus 1e-4 of the tensor's largest float64 value and
    1e-6 of the model's largest moment (fp32 rounding at the scale of the
    largest gradient, tests/test_torch_ddp.py's noise; it decides only for
    a gradient near 0 in exact arithmetic, as the latent 1x1 conv's is when
    its BN's variance lies far above eps). A
    1e-3 bound against one process's fp32 moments is out of reach even for
    its own reversed batch: the decoder's head, a 1x1 conv from the one
    latent channel into a BN, projects the cotangent of mu onto the part
    that BN does not normalise away, a near-cancelling sum that every
    encoder gradient passes through (on the CPU at 32^3 the reversed
    batch's mu cotangent lies 2e-3 from the float64 one, the batch as it is
    8e-6). The tensors whose exact gradient is 0 (`zero_gradient_tensors`:
    the conv biases in front of a BN, and the latent 1x1 conv weight when
    its float64 moment is below 1e-12 of the largest) must stay below
    TOL_DEPTH_ZERO_GRAD of the largest moment in every run
    (`assert_moments_close`'s noise rule). The rule must also refuse two
    controls made from the grid's moments (Adam's first moment at step 1 is
    0.1 x the gradient): P times them, a grid whose `spatial_sum` backward
    all-reduces the cotangent, and their negation, a wrong sign."""
    two = ranks[0]
    rel = {k: abs(sum(r["metrics"][k] for r in ranks) / len(ranks) - ref["metrics"][k])
           / abs(ref["metrics"][k]) for k in ("lossE", "lossD")}
    bad, worst, noise = _depth_moment_check(two["moments"], ref, ctl, exact)
    p = len(ranks)
    controls = {f"{p} x the grid's": {k: p * v for k, v in two["moments"].items()},
                "the negated grid's": {k: -v for k, v in two["moments"].items()}}
    refused = {}
    for name, m in controls.items():
        c_bad, c_worst, _ = _depth_moment_check(m, ref, ctl, exact)
        refused[name] = (len(c_bad), c_worst[0])
    top_s = max(v.abs().max().item() for v in ref["stats"].values())
    stat_worst = max(((two["stats"][k] - v).abs().max().item() / top_s, k)
                     for k, v in ref["stats"].items())
    same = len({r["digest"] for r in ranks}) == 1
    over = sum((two["moments"][k] - v).abs().max().item() > 1e-3 * v.abs().max().item()
               for k, v in ref["moments"].items())
    log(f"{what}: lossE rel {rel['lossE']:.2e}, lossD rel {rel['lossD']:.2e} (limit 1e-4); first "
        f"moments against the float64 step: the grid's distance over the farther of one "
        f"process's two fp32 steps at most {worst[0]:.2f} ({worst[1]}; limit 2, plus 1e-4 of "
        f"the tensor's largest and 1e-6 of the largest moment); over 1e-3 of max|m| from one "
        f"process's fp32 moments: {over} tensors; exactly-zero gradients at most {noise:.2e} of "
        f"the largest moment (limit {TOL_DEPTH_ZERO_GRAD:.0e}); controls, [tensors refused, "
        f"largest ratio]: " + ", ".join(f"{n} moments {v[0]} / {v[1]:.3g}"
                                       for n, v in refused.items())
        + f"; BN running statistics worst {stat_worst[0]:.2e} of the largest {top_s:.3f} at "
        f"{stat_worst[1]} (limit 1e-5); ranks' digests equal {same}")
    for k, g, o, r in bad:
        log(f"[depth] ({part}) over the limit: {k}: grid {g:.2e}, one {o:.2e}, reversed {r:.2e} of "
            f"max|m| from the float64 moment")
    failed = []
    if max(rel.values()) > 1e-4 or bad or stat_worst[0] > 1e-5 or not same:
        failed.append(f"({part}) the grid disagrees with one process: {rel} {bad} noise "
                      f"{noise:.2e} {stat_worst} digests equal {same}")
    if not all(n for n, _ in refused.values()):
        failed.append(f"({part}) the moment rule passes a control: {refused}")
    return failed


def depth_flagship_rank(dev, inp: dict, mesh=None, family: str = "fullsize") -> dict:
    """(b), one rank: spatial_1200_fullsize bf16 with dropout on this rank's
    slab of the 2 volumes (both whole without `mesh`: one process's step,
    the yardstick); a warm-up step, one counted step (launches, collectives,
    the bodies its sites took), 5 timed steps, one more under the profiler
    on rank 0, peak GiB, the digest, the last metrics. `family` "fc": (e),
    the same for fc_600 in bf16 on phase 5's first 2 volumes."""
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import make_model
    from sivae_torch.models.resnet_vae import depth_levels
    from sivae_torch.parallel import rank, replicate_state
    from sivae_torch.parallel.mesh import (collectives, reset_collectives, shard_batch,
                                           state_digest)
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    if family == "fc":
        cfg, real, name = _fc_cfg(torch.bfloat16), inp["vox"][:2], "fc_600"
    else:
        cfg, real, name = _fullsize_cfg(torch.bfloat16, True), inp["full"], "fullsize"
    if mesh is not None:
        real = shard_batch(real, mesh, spatial_axis="spatial", levels=depth_levels(cfg))
    real = real.to(dev)
    model = make_model(cfg, device=dev, seed=0)
    state = replicate_state(create_train_state(model, seed=0))
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step(state, real)   # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    build.reset_launches()
    reset_collectives()
    step(state, real)
    torch.cuda.synchronize()
    counts, coll = dict(build.launches), {k: list(v) for k, v in collectives.items()}
    bodies = site_bodies(dev)
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, real)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # one more step on every rank (their exchanges pair up), rank 0's under
    # the profiler: its own kernels, so its idle share holds the other
    # ranks' turns on the card, the host copies of the halo planes and the
    # waits
    if rank() == 0:
        what = (f"{name} step, one process" if mesh is None else
                f"depth-sharded {name} step, rank 0 of {DEPTH_B_WORLD}")
        profile_window(what, lambda: step(state, real), top=12)
    else:
        step(state, real)
    replicate_state(state)
    out = {"launches": counts, "want": soft_intro_launches(model), "collectives": coll,
           "halos_want": soft_intro_step_halos(cfg), "bodies": bodies, "times": times,
           "warm_s": warm, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "metrics": _metrics_line(metrics), "digest": state_digest(state).hex(),
           "slab": tuple(real.shape[2:])}
    del state, step, model, real
    torch.cuda.empty_cache()
    build.reset_launches()
    return out


def depth_encode(dev, inp: dict) -> dict:
    """(c): `encode_dataset` of phase 5's first 8 volumes by spatial_1200
    fp32 (seed 0 weights) at batch 8, under this process's grid (the whole
    latents on every rank), counted and timed."""
    from sivae_torch.eval.latent_probe import encode_dataset
    from sivae_torch.kernels import build
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.parallel.mesh import collectives, reset_collectives

    model = make_model(get_model_config("spatial_1200"), device=dev, seed=0)
    build.reset_launches()
    reset_collectives()
    t0 = time.perf_counter()
    mu = encode_dataset(model, inp["vox"], batch_size=8)
    torch.cuda.synchronize()
    out = {"mu": mu, "s": time.perf_counter() - t0, "launches": dict(build.launches),
           "collectives": {k: list(v) for k, v in collectives.items()}}
    del model
    torch.cuda.empty_cache()
    build.reset_launches()
    return out


def depth_others(dev, inp: dict, mesh=None) -> dict:
    """(f), on this process's grid (one process without `mesh`): one fp32
    step (TF32 off, no dropout, weights of seed 0, lr 0) of the spatial_150
    classifier (labels 0 and 1), the VAE (vae_150, its eps drawn from the
    state's generator) and the CAE (cae_150) on this rank's slab of phase 5's
    first 2 volumes, and the lucky AE's train-mode forward on its slab of
    all 8 (its BatchNorm over the decoder Linear's features normalises each
    feature over the batch alone: over 2 samples a feature whose two values
    nearly agree turns rounding into O(1)); each counted: metrics, launches,
    the digest; the lucky AE's code and its output, gathered whole."""
    from sivae_torch.config import OptimConfig
    from sivae_torch.kernels import build
    from sivae_torch.models.classifier import ResNetClassifier
    from sivae_torch.models.lucky_ae import LuckyDecoder, LuckyEncoder
    from sivae_torch.models.registry import get_model_config, make_model
    from sivae_torch.models.resnet_vae import depth_levels
    from sivae_torch.parallel.mesh import gather_depth, shard_batch, state_digest
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import (make_cae_train_step, make_classifier_train_step,
                                        make_vae_train_step)

    whole = inp["vox"][:2]

    def part(levels, x=whole):
        if mesh is not None:
            x = shard_batch(x, mesh, spatial_axis="spatial", levels=levels)
        return x.to(dev)

    def cfg(name):
        c = get_model_config(name)
        return dataclasses.replace(c, act=c.act.with_no_dropout())

    opt = OptimConfig(lr=0.0)
    out = {}
    steps = {
        "classifier": lambda m: make_classifier_train_step(m, opt, 1),
        "vae": lambda m: make_vae_train_step(m, opt, 1),
        "cae": lambda m: make_cae_train_step(m, opt, 1)}
    for name, c in (("classifier", cfg("spatial_150")), ("vae", cfg("vae_150")),
                    ("cae", cfg("cae_150"))):
        gen = torch.Generator().manual_seed(0)
        model = (ResNetClassifier(c, num_classes=2, generator=gen) if name == "classifier"
                 else make_model(c, device="cpu", seed=0)).to(dev).eval()
        state = create_train_state(model, seed=0, joint_optimizer=True)
        extra = (torch.tensor([0, 1], device=dev),) if name == "classifier" else ()
        build.reset_launches()
        _, metrics = steps[name](model)(state, part(depth_levels(c)), *extra)
        torch.cuda.synchronize()
        out[name] = {"metrics": _metrics_line(metrics), "launches": dict(build.launches),
                     "digest": state_digest(state).hex()}
        del model, state
    gen = torch.Generator().manual_seed(0)
    enc = LuckyEncoder(whole.shape[2:], generator=gen).to(dev).train()
    dec = LuckyDecoder(tuple(d // 8 for d in whole.shape[2:]), generator=gen).to(dev).train()
    build.reset_launches()
    with torch.no_grad():
        z = enc(part(enc.depth_levels, inp["vox"]))
        y = gather_depth(dec(z), whole.shape[2])
    torch.cuda.synchronize()
    out["lucky"] = {"z": z.cpu(), "y": y.cpu(), "launches": dict(build.launches)}
    torch.cuda.empty_cache()
    build.reset_launches()
    return out


def depth_rank(out_dir: str, part: str, backend: str) -> int:
    """One of phase 12's ranks (`phase_depth`, the launcher's environment;
    `backend` "gloo": all on the one card, "nccl": one card each): part "a"
    runs (a), (c), (d) and (f) on a 1 x 2 grid, part "b" runs (b) and (e) on
    a 1 x 4 grid."""
    import os

    from sivae_torch.kernels import build
    from sivae_torch.parallel import init_distributed, make_mesh, rank, shutdown
    from sivae_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    dev = init_distributed(backend=backend)
    resolve_device(dev)   # TF32 off
    build.library()       # the parent's build, from the cache
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    t0 = time.perf_counter()
    if part == "a":
        mesh = make_mesh((1, DEPTH_A_WORLD), ("data", "spatial"))
        res = {"a": depth_step(dev, inp, mesh)}
        log(f"[depth rank {rank()}] (a) {time.perf_counter() - t0:.1f} s")
        res["c"] = depth_encode(dev, inp)
        log(f"[depth rank {rank()}] (c) {time.perf_counter() - t0:.1f} s")
        res["d"] = depth_step(dev, inp, mesh, family="fc")
        log(f"[depth rank {rank()}] (d) {time.perf_counter() - t0:.1f} s")
        res["f"] = depth_others(dev, inp, mesh)
        log(f"[depth rank {rank()}] (f) {time.perf_counter() - t0:.1f} s")
    else:
        mesh = make_mesh((1, DEPTH_B_WORLD), ("data", "spatial"))
        res = {"b": depth_flagship_rank(dev, inp, mesh)}
        log(f"[depth rank {rank()}] (b) {time.perf_counter() - t0:.1f} s")
        res["e"] = depth_flagship_rank(dev, inp, mesh, family="fc")
        log(f"[depth rank {rank()}] (e) {time.perf_counter() - t0:.1f} s")
    torch.save(res, os.path.join(out_dir, f"rank{rank()}.pth"))
    shutdown()
    return 0


def _mib(nbytes: int) -> str:
    return f"{nbytes / 2**20:.1f} MiB"


TOL_DEPTH_OTHERS = 1e-4      # (f): losses, relative to one process's
TOL_DEPTH_LUCKY = 1e-3       # (f): the lucky AE's code and output, of their largest


def _depth_timed(part: str, one: dict, ranks: list, what: str, where: str, card: str,
                 own_cards: bool) -> list:
    """(b) and (e): one process's step, then the 1 x 4 grid's (the slower
    rank's times, peak GiB a rank, halo exchanges and launches against the
    derived counts, equal digests, finite metrics, tensor-core bodies at
    every sharded site). Returns the failures."""
    failed = []
    t = sorted(one["times"])
    log(f"[depth] ({part}) one process on a card ({card}): {what}: median {t[REPEATS // 2]:.4f} "
        f"s/step, min {t[0]:.4f}, max {t[-1]:.4f}, peak {one['peak_gib']:.2f} GiB, launches "
        f"{one['launches']} (derived {one['want']})")
    if one["launches"] != one["want"]:
        failed.append(f"({part}) one process: launches {one['launches']}, derived {one['want']}")
    medians = [sorted(x["times"])[REPEATS // 2] for x in ranks]
    slow = max(range(len(ranks)), key=lambda r: medians[r])
    t = sorted(ranks[slow]["times"])
    same = len({x["digest"] for x in ranks}) == 1
    finite = all(not x["metrics"]["nan"] and all(math.isfinite(v) for k, v in
                                                 x["metrics"].items() if k != "nan")
                 for x in ranks)
    halos = [x["collectives"].get("halo", [0, 0]) for x in ranks]
    log(f"[depth] ({part}) {what} on a 1 x {len(ranks)} grid (slabs "
        f"{[x['slab'] for x in ranks]}), {len(ranks)} ranks ({where}; "
        f"{card}{'' if own_cards else '; not a scaling figure'}): slower rank {slow} median "
        f"{t[REPEATS // 2]:.4f} s/step, min {t[0]:.4f}, max {t[-1]:.4f} ({REPEATS} steps; rank "
        f"medians {[round(x, 4) for x in medians]}; warm-up "
        f"{[round(x['warm_s'], 2) for x in ranks]} s); peak GiB per rank "
        f"{[round(x['peak_gib'], 2) for x in ranks]}; halo exchanges a step per rank "
        f"{[h[0] for h in halos]} (derived {ranks[0]['halos_want']}), bytes sent "
        f"{[_mib(h[1]) for h in halos]}, through the host "
        f"{[_mib(x['collectives'].get('halo_host', [0, 0])[1]) for x in ranks]}; launches per "
        f"rank {[x['launches'] for x in ranks]} (derived {ranks[0]['want']}); digests equal "
        f"{same}; metrics {json.dumps(ranks[0]['metrics'])}")
    log(f"[depth] ({part}) all-reduces of rank 0 in one step [calls, bytes]: "
        f"{json.dumps({k: v for k, v in ranks[0]['collectives'].items() if k != 'halo'})}")
    log(f"[depth] ({part}) bodies at the sharded sites: {json.dumps(ranks[0]['bodies'])}")
    for x in ranks:
        _require_tensor_core_bodies(f"phase 12 ({part})", x["bodies"])
    if (any(x["launches"] != x["want"] for x in ranks) or not same or not finite
            or any(h[0] != ranks[0]["halos_want"] for h in halos)):
        failed.append(f"({part}) the depth-sharded step: launches "
                      f"{[x['launches'] for x in ranks]}, halos {halos}, digests equal {same}, "
                      f"finite {finite}")
    return failed


def _depth_others_check(one: dict, ranks: list, card: str) -> list:
    """(f): each model's losses on 1 x 2 within TOL_DEPTH_OTHERS of one
    process's, its launches on every rank one process's, the ranks' digests
    equal; the lucky AE's code and output within TOL_DEPTH_LUCKY."""
    failed = []
    for name in ("classifier", "vae", "cae"):
        mine = [r[name] for r in ranks]
        rel = {k: max(abs(x["metrics"][k] - v) / max(abs(v), 1e-30) for x in mine)
               for k, v in one[name]["metrics"].items() if k not in ("nan", "acc")}
        same = len({x["digest"] for x in mine}) == 1
        launches = [x["launches"] for x in mine]
        log(f"[depth] (f) {name} fp32 step on 1 x {len(ranks)} vs one process: losses rel "
            f"{json.dumps({k: f'{v:.2e}' for k, v in rel.items()})} (limit "
            f"{TOL_DEPTH_OTHERS}), metrics {json.dumps(mine[0]['metrics'])}; launches per rank "
            f"{launches} (one process {one[name]['launches']}); digests equal {same} ({card})")
        if (max(rel.values()) > TOL_DEPTH_OTHERS or not same or mine[0]["metrics"]["nan"]
                or any(x != one[name]["launches"] for x in launches)):
            failed.append(f"(f) {name}: rel {rel}, digests equal {same}, launches {launches}")
    errs = {k: max(_rel(r["lucky"][k], one["lucky"][k]) for r in ranks) for k in ("z", "y")}
    log(f"[depth] (f) lucky AE train-mode forward, 80x96x80 batch 8, on 1 x {len(ranks)} vs one "
        f"process: code rel {errs['z']:.2e}, output rel {errs['y']:.2e} (limit "
        f"{TOL_DEPTH_LUCKY}); launches per rank {[r['lucky']['launches'] for r in ranks]} (one "
        f"process {one['lucky']['launches']})")
    if max(errs.values()) > TOL_DEPTH_LUCKY or not all(
            bool(torch.isfinite(r["lucky"]["y"]).all()) for r in ranks):
        failed.append(f"(f) lucky AE: {errs}")
    return failed


def phase_depth(dev, card: str, own_cards: bool = False) -> dict:
    """Phase 12 (module docstring): (a) fp32 fullsize step, one process and
    a 1 x 2 grid; (c) the spatial_1200 encode, one process and 1 x 2; (d)
    the fp32 fc_600 step, one process and 1 x 2; (f) the classifier, VAE,
    CAE and lucky AE, one process and 1 x 2; (b) and (e) the bf16 fullsize
    and fc_600 steps on a 1 x 4 grid; gloo ranks sharing the one card, or
    with `own_cards` NCCL ranks on a card each (`--depth-cards`). Returns the
    ranks' counted launches, summed."""
    import os
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_depth_")
    t_phase = time.perf_counter()
    inp = depth_inputs(os.path.join(tmp.name, "inputs.pt"))
    refs = {fam: (depth_step(dev, inp, family=fam), depth_step(dev, inp, reverse=True, family=fam),
                  depth_step(dev, inp, exact=True, family=fam)) for fam in ("fullsize", "fc")}
    enc = depth_encode(dev, inp)
    others = depth_others(dev, inp)
    failed = []
    for part, fam, what in (("a", "fullsize", "fp32 spatial_1200_fullsize 160x192x160"),
                            ("d", "fc", "fp32 fc_600 80x96x80")):
        ref, ctl, exact = refs[fam]
        log(f"[depth] ({part}) one process: {what} batch 2 step {ref['s']:.2f} s (the reversed "
            f"batch {ctl['s']:.2f} s), peak {ref['peak_gib']:.2f} GiB; the float64 step "
            f"(cuDNN's convs) {exact['s']:.2f} s, peak {exact['peak_gib']:.2f} GiB ({card})")
        for tag, r in (("one process", ref), ("reversed batch", ctl), ("float64", exact)):
            if r["launches"] != r["want"]:
                failed.append(f"({part}) {tag}: launches {r['launches']}, derived {r['want']}")
    log(f"[depth] (c) one process's encode of 8 volumes {enc['s']:.3f} s ({card})")

    backend = "nccl" if own_cards else "gloo"
    where = "one card each, NCCL" if own_cards else "gloo, sharing the one card"
    t0 = time.perf_counter()
    ranks = run_ranks("depth", ["--depth-rank", tmp.name, "a", backend], DEPTH_A_WORLD,
                      tmp.name, DEPTH_LIMIT_S, own_cards)
    log(f"[depth] (a), (c), (d), (f): {DEPTH_A_WORLD} ranks ({where}) in "
        f"{time.perf_counter() - t0:.1f} s")
    grids = {}
    for part, fam, what in (("a", "fullsize", "spatial_1200_fullsize 160x192x160"),
                            ("d", "fc", "fc_600 80x96x80")):
        grid = grids[part] = [r[part] for r in ranks]
        failed += _compare_depth(
            *refs[fam], grid, f"[depth] ({part}) fp32 {what} step at lr 0, global batch 2: a 1 x "
            f"{DEPTH_A_WORLD} grid (slabs {[x['slab'] for x in grid]}; {where}) vs one process on "
            f"a card", part)
        for r, x in enumerate(grid):
            c = x["collectives"]
            log(f"[depth] ({part}) rank {r}: step {x['s']:.2f} s, peak {x['peak_gib']:.2f} GiB, "
                f"launches {x['launches']} (derived {x['want']}), halo exchanges {c.get('halo')} "
                f"[calls, bytes sent], through the host {c.get('halo_host')}, BN statistics "
                f"{c.get('bn')}, spatial sums {c.get('spatial')}, gradient buckets "
                f"{c.get('grad')} ({card})")
            if x["launches"] != x["want"]:
                failed.append(f"({part}) rank {r}: launches {x['launches']}, derived {x['want']}")
    halos = soft_intro_step_halos(_fc_cfg(torch.float32))
    if any(x["collectives"].get("halo", [0])[0] != halos for x in grids["d"]):
        failed.append(f"(d) halo exchanges {[x['collectives'].get('halo') for x in grids['d']]}, "
                      f"derived {halos}")
    rel = max(_rel(torch.from_numpy(r["c"]["mu"]), torch.from_numpy(enc["mu"])) for r in ranks)
    log(f"[depth] (c) spatial_1200 fp32 encode_dataset of 8 volumes on 1 x {DEPTH_A_WORLD} vs one "
        f"process: mu rel err {rel:.2e} (limit {TOL_DEPTH_ENCODE}); "
        f"{[round(r['c']['s'], 3) for r in ranks]} s, launches {ranks[0]['c']['launches']} (one "
        f"process {enc['launches']}), gathers {ranks[0]['c']['collectives'].get('gather')}")
    if not rel <= TOL_DEPTH_ENCODE or ranks[0]["c"]["launches"] != enc["launches"]:
        failed.append(f"(c) encode on the grid: rel {rel:.2e}, launches "
                      f"{ranks[0]['c']['launches']} vs {enc['launches']}")
    failed += _depth_others_check(others, [r["f"] for r in ranks], card)
    del refs, enc
    torch.cuda.empty_cache()

    ones = {fam: depth_flagship_rank(dev, inp, family=fam) for fam in ("fullsize", "fc")}
    t0 = time.perf_counter()
    ranks_b = run_ranks("depth", ["--depth-rank", tmp.name, "b", backend], DEPTH_B_WORLD,
                        tmp.name, DEPTH_LIMIT_S, own_cards)
    log(f"[depth] (b), (e): {DEPTH_B_WORLD} ranks ({where}) in {time.perf_counter() - t0:.1f} s")
    for part, fam, what in (("b", "fullsize", "spatial_1200_fullsize bf16 160x192x160, dropout "
                                              "on, global batch 2"),
                            ("e", "fc", "fc_600 bf16 80x96x80 (no dropout in the FC family), "
                                        "global batch 2")):
        grids[part] = [r[part] for r in ranks_b]
        failed += _depth_timed(part, ones[fam], grids[part], what, where, card, own_cards)
    log(f"[depth] phase 12 in {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise SystemExit("chip_smoke: phase 12: " + "; ".join(failed))
    tmp.cleanup()
    counted = [x["launches"] for g in grids.values() for x in g]
    counted += [r["f"][m]["launches"] for r in ranks for m in ("classifier", "vae", "cae", "lucky")]
    return {k: sum(c.get(k, 0) for c in counted) for k in TRAIN_LAUNCHES}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--ddp-rank", default=None, help=argparse.SUPPRESS)   # phase 10's ranks
    ap.add_argument("--depth-rank", nargs=3, default=None, help=argparse.SUPPRESS)   # phase 12's
    ap.add_argument("--depth-cards", action="store_true",
                    help=f"phase 12 alone, its ranks on a card each (NCCL; needs "
                         f"{DEPTH_B_WORLD} cards)")
    args = ap.parse_args(argv)
    if args.ddp_rank is not None:
        return ddp_rank(args.ddp_rank)
    if args.depth_rank is not None:
        return depth_rank(*args.depth_rank)
    only = [p for p in args.only.split(",") if p]
    if any(p not in PHASES for p in only):
        ap.error(f"--only takes {PHASES}")
    want = set(only or PHASES)
    if args.depth_cards:
        if torch.cuda.is_available() and torch.cuda.device_count() < DEPTH_B_WORLD:
            ap.error(f"--depth-cards needs {DEPTH_B_WORLD} cards")
        only, want = ["depth-cards"], set()

    name, card = phase_device()
    from sivae_torch.utils.device import resolve_device

    dev = resolve_device("cuda")  # also turns TF32 off for the fp32 checks
    phase_build()
    rows = phase_kernels(dev) if "kernels" in want else {}
    if "grad" in want:
        phase_gradients(dev)
    src, vox = (synthetic_volumes(dev) if want & {"path", "train", "families", "remat"}
                else (None, None))
    path_n, path32_n, fc32_n = phase_path(dev, src, vox) if "path" in want else ({}, {}, {})
    stage_n = phase_stage(dev) if "stage" in want else {}
    train_n = phase_train(dev, vox[:8]) if "train" in want else {}
    real = vox[:8].clone() if "families" in want else None
    remat_vox = vox.clone() if "remat" in want else None
    del src, vox
    trainer_n = phase_trainer(dev) if "trainer" in want else {}
    families_n = phase_families(dev, real) if "families" in want else {}
    ddp_n, fullsize_n, fullsize_gib = (phase_ddp(dev, card) if "ddp" in want
                                       else ({}, {}, None))
    if "remat" in want:
        phase_remat(dev, remat_vox, fullsize_gib)
    del remat_vox
    depth_n = phase_depth(dev, card) if "depth" in want else {}
    if args.depth_cards:
        phase_depth(dev, card, own_cards=True)
    log(card)
    if only:
        print(json.dumps({"ok": False, "partial": only}))
        return 0
    for kname in ("conv3d_same", "conv3d_to1", "conv3d_from1"):
        if families_n[kname] == 0:
            raise SystemExit(f"chip_smoke: the families phase launched no {kname}")

    flag = f"{FLAGSHIP[0]}->{{}}@{grid_name(FLAGSHIP[1])}"
    head = {"conv3d_same": flag.format(64), "conv3d_to1": flag.format(1),
            "conv3d_from1": f"1->64@{grid_name(FLAGSHIP[1])}",
            "conv3d_fused_stats": flag.format(64) + " prologue"}
    kernels = []
    for kname, site in head.items():
        r = rows[(kname, site, torch.bfloat16)]
        per_path = {"eval_path": path_n[kname], "eval_path_fp32": path32_n[kname],
                    "eval_path_fc150_fp32": fc32_n[kname],
                    "fused_stage": stage_n[kname],
                    "train_step": train_n[kname], "trainer": trainer_n[kname],
                    "families": families_n[kname], "ddp_ranks": ddp_n[kname],
                    "fullsize": fullsize_n[kname], "depth_ranks": depth_n[kname]}
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
                        "site": f"{site} batch 2 bf16",
                        "bodies": sorted({v["body"] for k, v in rows.items() if k[0] == kname}),
                        "rows": [dict(site=k[1], dtype=dtype_name(k[2]), **v)
                                 for k, v in rows.items() if k[0] == kname]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
