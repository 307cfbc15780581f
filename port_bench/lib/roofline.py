"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W) and the least time of a conv launch of the port's kernels.

fp32 operands are multiplied at the TF32 tensor rate, the highest rate at
which the chip multiplies float32 inputs, whatever body a kernel uses.
"""

from __future__ import annotations

import re
from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}

# "Ci->Co@DxHxW bB dtype": the port's site keys (`kernels/build.py`)
SITE = re.compile(r"^(\d+)->(\d+)@(\d+)x(\d+)x(\d+) b(\d+) (\w+)$")


def site_least_s(key: str) -> float:
    """The least time of one 3x3x3 SAME conv launch at site `key`: the
    larger of its operations (2 Ci Co 27 per output voxel) over the dtype's
    peak and its bytes (input, weights and output, each once) over the
    memory's."""
    m = SITE.match(key)
    if m is None:
        raise ValueError(f"not a conv site: {key!r}")
    ci, co, d, h, w, b = (int(v) for v in m.groups()[:6])
    dt = m.group(7)
    vox = b * d * h * w
    ops = 2.0 * ci * co * 27 * vox
    nbytes = (vox * ci + 27 * ci * co + vox * co) * ELEM_BYTES[dt]
    return max(ops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES_S)


def sites_least_s(sites: Dict[str, int]) -> float:
    return sum(n * site_least_s(k) for k, n in sites.items())
