"""Shared set-up for the sivae_torch port tests: a tiny JAX spatial model with
non-trivial weights and BN statistics, and the same weights in the port.

The JAX side runs the 1-channel-sided convs through its Pallas stencils in
interpret mode (`use_pallas_small_ch=True`) and the other 3x3x3 convs
through XLA: `_PallasConvCore` calls its kernel without `interpret`, so it
cannot run on the CPU (that kernel's parity is held in
test_torch_kernels.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import jax
import jax._src.random as jax_random_impl
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


@contextlib.contextmanager
def flat_random_draws():
    """While active, `jax.random.normal` and `jax.random.truncated_normal`
    draw a flat vector and reshape it to the asked shape. With the
    partitionable threefry (the default of the JAX installed here) a draw's
    bits depend on the flat index only, so the values are bit for bit those
    of the shaped draw; XLA on the CPU compiles a flat draw several times
    faster than a 5-D one (the conv kernels of a flax init), which is most
    of the time an init takes. Without the partitionable threefry it changes
    nothing."""
    normal, truncated = jax.random.normal, jax.random.truncated_normal

    def flat_normal(key, shape=(), dtype=None, **kw):
        shape = tuple(shape)
        return normal(key, (math.prod(shape),), dtype, **kw).reshape(shape)

    def flat_truncated(key, lower, upper, shape=None, dtype=None, **kw):
        if shape is None or np.ndim(lower) or np.ndim(upper):
            return truncated(key, lower, upper, shape, dtype, **kw)
        shape = tuple(shape)
        return truncated(key, lower, upper, (math.prod(shape),), dtype, **kw).reshape(shape)

    if not jax.config.jax_threefry_partitionable:
        yield
        return
    # jax.nn.initializers call the samplers through jax._src.random
    modules = (jax.random, jax_random_impl)
    for m in modules:
        m.normal, m.truncated_normal = flat_normal, flat_truncated
    try:
        yield
    finally:
        for m in modules:
            m.normal, m.truncated_normal = normal, truncated


@functools.lru_cache(maxsize=None)
def _tiny_init():
    """`tiny_spatial`'s config and its jitted init through XLA's convs (the
    Pallas cores keep the same param tree), compiled once per process."""
    cfg_j = dataclasses.replace(jax_get_model_config("tiny_spatial"), use_pallas_conv=False)
    return cfg_j, jax.jit(jax_make_model(cfg_j).init)


def tiny_pair(seed: int = 0):
    """(jax_model, jax_variables, port_model) for `tiny_spatial`, same weights,
    both fp32, port on the CPU in eval mode."""
    cfg_j, init = _tiny_init()
    x0 = jnp.zeros((1,) + cfg_j.input_shape + (1,), jnp.float32)
    # init through XLA's convs, apply through the interpret-mode stencils
    with flat_random_draws():  # the first call traces the init
        variables = perturb(init(jax.random.key(seed), x0), seed)
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


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_state_trees(st):
    """A JAX SIVAETrainState as the plain numpy trees that
    `load_jax_train_state` takes. A joint Adam (the VAE / CAE trainers) keeps
    its (encoder, decoder) pair of moment trees; an empty `opt_d` is left
    out, and so are a classifier's empty decoder trees."""
    def adam(o):
        return {"mu": np_tree(o[0].mu), "nu": np_tree(o[0].nu), "count": int(o[0].count)}

    out = {"enc_params": np_tree(st.enc_params), "dec_params": np_tree(st.dec_params),
           "enc_stats": np_tree(st.enc_stats), "dec_stats": np_tree(st.dec_stats),
           "opt_e": adam(st.opt_e), "step": int(st.step)}
    if st.opt_d != ():
        out["opt_d"] = adam(st.opt_d)
    return out


def flat_state(trees):
    """The trees of `jax_state_trees` flat, under `export_train_state`'s
    names ("opt_e/mu/0/..." for the encoder half of a joint Adam)."""
    def walk(node, prefix, out):
        items = (node.items() if isinstance(node, dict)
                 else ((str(i), v) for i, v in enumerate(node)))
        for k, v in items:
            if isinstance(v, (dict, tuple, list)):
                walk(v, prefix + (k,), out)
            else:
                out["/".join(prefix + (k,))] = np.asarray(v)
        return out

    out = {}
    for name in ("enc_params", "dec_params", "enc_stats", "dec_stats"):
        if trees[name]:
            walk(trees[name], (name,), out)
    for o in ("opt_e", "opt_d"):
        if o in trees:
            walk({"mu": trees[o]["mu"], "nu": trees[o]["nu"]}, (o,), out)
            out[f"{o}/count"] = np.asarray(trees[o]["count"])
    out["step"] = np.asarray(trees["step"])
    return out


def assert_moments_close(got, want, zero_grad=()):
    """Adam first moments after one step (0.1 x the gradient), per tensor:
    |got - want| <= 1e-3 * max|want| where |want| > 1e-3 * max|want|. The
    tensors in `zero_grad` (conv biases feeding a BN, whose exact gradient
    is 0: the mean subtraction cancels them) hold rounding noise in both
    stacks and must stay below 1e-4 of the largest first moment of all."""
    bad = []
    noise = 1e-4 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got[k]
        if k in zero_grad:
            if max(np.abs(g).max(), np.abs(w).max()) >= noise:
                bad.append((k, "noise", float(np.abs(g).max()), float(np.abs(w).max())))
            continue
        scale = np.abs(w).max()
        mask = np.abs(w) > 1e-3 * scale
        err = np.abs(g - w)[mask].max() if mask.any() else 0.0
        if err > 1e-3 * scale:
            bad.append((k, float(err), float(scale)))
    assert not bad, bad
