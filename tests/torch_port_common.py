"""Shared set-up for the sivae_torch port tests: a tiny JAX spatial model with
non-trivial weights and BN statistics, and the same weights in the port.

The JAX side runs the 1-channel-sided convs through its Pallas stencils in
interpret mode (`use_pallas_small_ch=True`) and the other 3x3x3 convs
through XLA: `_PallasConvCore` calls its kernel without `interpret`, so it
cannot run on the CPU (that kernel's parity is held in
test_torch_kernels.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sivae_tpu.models.registry import get_model_config as jax_get_model_config
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.utils.jax_import import jax_to_state_dict


def perturb(variables, seed: int = 0):
    """Random BN scale/bias/mean/var and a non-zero logvar head, so the
    eval-mode BN and both heads are exercised (a fresh init has identity BN
    and a zero logvar head)."""
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(np.asarray, variables)

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            if k == "scale":
                node[k] = (1.0 + 0.2 * rng.randn(*v.shape)).astype(v.dtype)
            elif k in ("bias", "mean"):
                node[k] = (0.1 * rng.randn(*v.shape)).astype(v.dtype)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
            elif k == "kernel" and "logvar" in path:
                node[k] = (0.1 * rng.randn(*v.shape)).astype(v.dtype)

    walk(tree, ())
    return tree


def tiny_pair(seed: int = 0):
    """(jax_model, jax_variables, port_model) for `tiny_spatial`, same weights,
    both fp32, port on the CPU in eval mode."""
    cfg_j = dataclasses.replace(jax_get_model_config("tiny_spatial"), use_pallas_conv=False)
    x0 = jnp.zeros((1,) + cfg_j.input_shape + (1,), jnp.float32)
    # init through XLA's convs (the Pallas cores keep the same param tree),
    # apply through the interpret-mode stencils
    variables = perturb(jax.jit(jax_make_model(cfg_j).init)(jax.random.key(seed), x0), seed)
    model_j = jax_make_model(dataclasses.replace(cfg_j, use_pallas_small_ch=True))
    model_t = make_model(get_model_config("tiny_spatial"), device="cpu")
    model_t.load_state_dict(jax_to_state_dict(variables, model_t))
    return model_j, variables, model_t


def assert_close_scaled(got: np.ndarray, want: np.ndarray, rel: float) -> None:
    """max|got - want| <= rel * max(1, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    lim = rel * max(1.0, float(np.max(np.abs(want))))
    assert err <= lim, f"max |diff| {err:.3e} > {lim:.3e}"


def to_ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def to_ndhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 4, 1).numpy()
