"""Print the SASS instruction mix of every kernel in the port's CUDA library.

    python tools/torch_sass_report.py [--out sass.txt]

Builds the kernels if needed (needs `nvcc`), disassembles the library with
`cuobjdump -sass` and prints, per kernel, the counts of the instructions
that say what the compiler made of it: tensor-core MMAs (`HGMMA` for wgmma,
`HMMA` for mma.sync), shared memory loads (`LDS`, and `LDSM` for ldmatrix),
generic loads (`LD`), async copies (`LDGSTS` for cp.async, `UTMALDG` for
TMA), mbarrier operations (`SYNCS`), wgmma fences and waits (`WARPGROUP`),
barriers (`BAR`), matrix moves (`MOVM`) and FMAs.
`--out` keeps the full disassembly.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sivae_torch.kernels import build  # noqa: E402

OPS = ("HGMMA", "HMMA", "LDSM", "LDS", "LD", "LDGSTS", "UTMALDG", "SYNCS", "WARPGROUP", "LDG",
       "STS", "STG", "BAR", "MOVM", "FFMA")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)")


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "cuobjdump"
    found = str(cand) if cand.exists() else shutil.which("cuobjdump")
    if found is None:
        raise SystemExit("cuobjdump not found (set CUDA_HOME)")
    return found


def instruction_mix(sass: str) -> dict:
    """{kernel symbol: Counter of instruction mnemonics (without suffixes)}."""
    out = {}
    for chunk in re.split(r"\n\s+Function : ", sass)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        out[name] = collections.Counter(m.group(1).split(".")[0] for m in _INSTR.finditer(chunk))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the full disassembly here")
    args = ap.parse_args()
    so, _ = build.build()
    sass = subprocess.run([_cuobjdump(), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    if args.out:
        Path(args.out).write_text(sass)
    for name, ops in instruction_mix(sass).items():
        counts = " ".join(f"{op} {ops.get(op, 0)}" for op in OPS)
        print(f"{name[:100]}\n    {counts} | total {sum(ops.values())}")


if __name__ == "__main__":
    main()
