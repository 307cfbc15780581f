"""The accumulation type of the port's plain (CPU) paths."""

import torch


def wide_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for a float64 tensor: the plain paths sum in fp32 as
    the kernels do, and keep float64 whole, so that a float64 run of a
    model is float64 throughout."""
    return torch.promote_types(t.dtype, torch.float32)


def widen(t: torch.Tensor) -> torch.Tensor:
    """`t` in `wide_dtype(t)`."""
    return t.to(wide_dtype(t))
