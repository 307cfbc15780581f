"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. When CUDA is
missing and the CPU was not asked for, they raise: nothing continues on the
CPU unasked.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` or "cuda" -> the current CUDA device (raises without CUDA);
    "cpu" -> the CPU. On CUDA, fp32 stays full fp32 (see `full_fp32`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' (or --device cpu) "
                               "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        full_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def full_fp32() -> None:
    """Turn TF32 off for fp32 convolutions and matrix products.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits). The port's fp32 path is held to fp32 tolerances against its
    plain version and the JAX reference, so both switches are set to full
    fp32. bf16 work is unaffected.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
