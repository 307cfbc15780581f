"""The benchmark of sivae_torch (the PyTorch and CUDA port) on NVIDIA cards.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line (the last of standard
output); exits non-zero without printing one when the cell's cards are
missing. See port_bench/README.md.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from port_bench.harness import main

    sys.exit(main(sys.argv[1:], root=ROOT, t0=T0))
