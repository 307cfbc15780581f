"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All of `sivae_torch/csrc/*.cu` go into one shared library with a plain C
interface. Each source compiles to an object in its own `nvcc` process (all
started together), and one more `nvcc` links them. The library lands in
`sivae_torch/_build/`, keyed by a hash of the sources and flags, so an
unchanged tree builds once. Nothing is built at import: `library()` builds on
the first CUDA launch.

PyTorch's own extension builder is not used: including its headers turns a
build of seconds into one of minutes, and the kernels need none of it.
Pointers and the stream cross as `c_void_p`; every C entry returns
`cudaGetLastError()` after its launch and `check()` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (all return int)
SIGNATURES = {
    "sivae_conv3d_same": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "sivae_conv3d_same_mma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sivae_conv3d_same_wgmma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sivae_conv3d_same_wgmma_shape": [_I, _I, _I, _I, _I],
    "sivae_conv3d_same_body": [_P, _P, _P, _I, _I, _I],
    "sivae_conv3d_same_scratch": [_I, _I, _I],
    "sivae_conv3d_to1_body": [_P, _I, _I],
    "sivae_conv3d_to1": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sivae_conv3d_to1_fma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sivae_conv3d_from1_body": [_P, _I, _I],
    "sivae_conv3d_from1": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sivae_conv3d_from1_fma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sivae_conv3d_fused_stats_body": [_P, _P, _I, _I, _I],
    "sivae_conv3d_fused_stats": [_P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sivae_conv3d_fused_stats_mma": [_P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                     _P],
    "sivae_conv3d_fused_stats_wgmma": [_P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _P],
    "sivae_conv3d_fused_stats_wgmma_shape": [_I, _I, _I, _I, _I],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launch counts per kernel wrapper: each wrapper adds one where it launches
# its kernel and nowhere else (a CPU tensor takes the plain version and
# counts nothing).
launches: Dict[str, int] = {"conv3d_same": 0, "conv3d_to1": 0, "conv3d_from1": 0,
                            "conv3d_fused_stats": 0}

# the launches of conv3d_same keyed by site, "Ci->Co@DxHxW b B dtype", of
# conv3d_to1, "C->1@...", and of conv3d_from1, "1->C@...": which shapes and
# types a path sends through each kernel, and how often
conv3d_same_sites: Dict[str, int] = {}
conv3d_to1_sites: Dict[str, int] = {}
conv3d_from1_sites: Dict[str, int] = {}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for sites in (conv3d_same_sites, conv3d_to1_sites, conv3d_from1_sites):
        sites.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in sorted(list(SRC_DIR.glob("*.cu")) + list(SRC_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return outs


def build() -> Tuple[Path, str]:
    """Compile csrc/*.cu into the hashed shared library. Returns its path
    and nvcc's output (with the -Xptxas -v register and spill report), which
    is empty when the library was already built."""
    so = BUILD_DIR / f"libsivae_kernels_{source_hash()}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        logs = _run_all([[nvcc, *COMPILE_FLAGS, "-I", str(SRC_DIR), "-c", str(src), "-o", str(o)]
                         for src, o in zip(_sources(), objs)])
        out = Path(tmp) / so.name
        logs += _run_all([[nvcc, *LINK_FLAGS, *map(str, objs), "-o", str(out)]])
        os.replace(out, so)  # atomic: a concurrent builder sees all or nothing
    return so, "".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sivae_error_string.argtypes = [ctypes.c_int]
            lib.sivae_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = library().sivae_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}") from None


def count_site(sites: Dict[str, int], x: torch.Tensor, ci: int, co: int) -> None:
    """One launch at the site "Ci->Co@DxHxW bB dtype" of the NDHWC input x."""
    b, d, h, w = x.shape[:4]
    key = f"{ci}->{co}@{d}x{h}x{w} b{b} {str(x.dtype).replace('torch.', '')}"
    sites[key] = sites.get(key, 0) + 1


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    with one dtype the kernels take."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"kernel needs CUDA tensors, got {t.device}")
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"kernel operands differ: {t.device}/{t.dtype} vs {dev}/{dt}")
        if not t.is_contiguous():
            raise ValueError("kernel needs contiguous operands")
    dtype_code(tensors[0])


def require_voxels(b: int, d: int, h: int, w: int) -> None:
    """The kernels index voxels with 32-bit integers."""
    if b * d * h * w >= 2**31:
        raise ValueError(f"kernel takes fewer than 2^31 voxels, got {b}x{d}x{h}x{w}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
