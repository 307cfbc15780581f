"""Time the wgmma body of `conv3d_same` (and of `conv3d_fused_stats`) in each
of its block shapes.

    python tools/torch_conv_blocks.py [--batches 2,8] [--reps 50] [--fused]

For every 3x3x3 site of spatial_1200 (bf16, the sites of `chip_smoke.py`),
and the two 32 -> 64 sites the body takes in 32-channel chunks (fc_600 at
20x24x20, spatial_1200_fullsize at 80x96x80), and each batch, prints the ms of the four block shapes (128x64, 256x64, 128x128,
256x128 outputs a block; "-" where Co has no 128-wide tile), of the shape the
dispatch picks (`wgmma_block_shape` in `sivae_torch/csrc/conv3d_wgmma.cuh`,
marked `*`), of the earlier mma.sync body and of the library call (cuDNN), so
that the cost model behind the pick can be held against the card. Needs a
CUDA card and `nvcc`; every shape is first held against the dispatch's output.

`--fused` times the fused conv + statistics kernel instead, at its site
(64->64@80x96x80) with and without the prologue: the same columns, the
library column being the unfused stage, and a last column with
`conv3d_same` on the same operands.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import SLOPE, time_ms, unfused_stage  # noqa: E402  (device time)
from sivae_torch.kernels.conv3d import (WGMMA_SHAPES, conv3d_same_earlier_body,  # noqa: E402
                                        conv3d_same_forward, conv3d_same_wgmma_blocks,
                                        conv3d_same_wgmma_shape)

SITES = [
    (64, 64, (80, 96, 80)), (64, 64, (40, 48, 40)), (64, 128, (40, 48, 40)),
    (128, 128, (20, 24, 20)), (128, 256, (20, 24, 20)), (256, 256, (10, 12, 10)),
    (128, 64, (40, 48, 40)), (256, 128, (20, 24, 20)),
    (32, 64, (20, 24, 20)), (32, 64, (80, 96, 80)),
]
NAMES = {11: "128x64", 21: "256x64", 12: "128x128", 22: "256x128"}
FUSED_SITES = [(64, 64, (80, 96, 80))]


def fused_rows(dev, gen, batches, reps: int) -> None:
    """The fused kernel's rows: each block shape with and without the
    prologue, beside the earlier body, the unfused library stage and
    conv3d_same."""
    from sivae_torch.kernels.conv3d_fused import (conv3d_fused_stats,
                                                  conv3d_fused_stats_earlier_body,
                                                  conv3d_fused_stats_wgmma_blocks,
                                                  conv3d_fused_stats_wgmma_shape)

    print("site | " + " | ".join(NAMES[s] for s in WGMMA_SHAPES)
          + " | mma.sync | library stage | conv3d_same (ms)")
    for batch in batches:
        for ci, co, sp in FUSED_SITES:
            x = torch.randn((batch,) + sp + (ci,), generator=gen, device=dev).bfloat16()
            w = (torch.randn((3, 3, 3, ci, co), generator=gen, device=dev)
                 * math.sqrt(2.0 / (27 * ci))).bfloat16()
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            in_a = 0.5 + torch.rand(ci, generator=gen, device=dev)
            in_b = 0.3 + 0.3 * torch.rand(ci, generator=gen, device=dev)
            picked = conv3d_fused_stats_wgmma_shape(x, co)
            same = time_ms(lambda: conv3d_same_forward(x, w), reps)
            for ab in ((), (in_a, in_b, SLOPE)):
                want = conv3d_fused_stats(x, w, *ab)[0]
                cells = []
                for shape in WGMMA_SHAPES:
                    if co % (64 * (shape % 10)):
                        cells.append("-")
                        continue
                    got = conv3d_fused_stats_wgmma_blocks(x, w, *ab, shape=shape)[0]
                    if not torch.equal(got, want):  # whole fp32 sums regrouped: same bits
                        raise SystemExit(f"fused block shape {shape} disagrees, batch {batch}")
                    ms = time_ms(lambda: conv3d_fused_stats_wgmma_blocks(x, w, *ab, shape=shape),
                                 reps)
                    cells.append(f"{ms:.4f}{'*' if shape == picked else ''}")
                old = time_ms(lambda: conv3d_fused_stats_earlier_body(x, w, *ab), reps)
                a_b = (ab[0], ab[1]) if ab else (None, None)
                lib = time_ms(lambda: unfused_stage(x, w_cl, *a_b, SLOPE), reps)
                site = f"{ci}->{co}@{'x'.join(map(str, sp))} b{batch}" + (" prologue" if ab else "")
                print(f"{site:38s} | " + " | ".join(cells) + f" | {old:.4f} | {lib:.4f} | "
                      f"{same:.4f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="2,8")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--fused", action="store_true", help="the fused kernel's rows instead")
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [int(b) for b in args.batches.split(",")]
    if args.fused:
        fused_rows(dev, gen, batches, args.reps)
        return
    print("site | " + " | ".join(NAMES[s] for s in WGMMA_SHAPES) + " | mma.sync | library (ms)")
    for batch in batches:
        for ci, co, sp in SITES:
            x = torch.randn((batch,) + sp + (ci,), generator=gen, device=dev).bfloat16()
            w = (torch.randn((3, 3, 3, ci, co), generator=gen, device=dev)
                 * math.sqrt(2.0 / (27 * ci))).bfloat16()
            x_cl = x.permute(0, 4, 1, 2, 3)
            w_cl = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            want = conv3d_same_forward(x, w)
            picked = conv3d_same_wgmma_shape(x, co)
            cells = []
            for shape in WGMMA_SHAPES:
                if co % (64 * (shape % 10)):
                    cells.append("-")
                    continue
                got = conv3d_same_wgmma_blocks(x, w, shape)
                # another block shape only regroups whole fp32 sums: same bits
                if not torch.equal(got, want):
                    raise SystemExit(f"block shape {shape} disagrees at {ci}->{co}@{sp} b{batch}")
                ms = time_ms(lambda: conv3d_same_wgmma_blocks(x, w, shape), args.reps)
                cells.append(f"{ms:.4f}{'*' if shape == picked else ''}")
            old = time_ms(lambda: conv3d_same_earlier_body(x, w), args.reps)
            lib = time_ms(lambda: F.conv3d(x_cl, w_cl, padding=1), args.reps)
            site = f"{ci}->{co}@{'x'.join(map(str, sp))} b{batch}"
            print(f"{site:28s} | " + " | ".join(cells) + f" | {old:.4f} | {lib:.4f}", flush=True)


if __name__ == "__main__":
    main()
