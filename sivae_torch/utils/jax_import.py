"""Carry weights and training state between the JAX package and the port:
from JAX variables or a reference .pth into the port, and a whole train
state (parameters, BN statistics, the Adams' moments, step) in and out.

`jax_to_state_dict` is the inverse of `sivae_tpu/utils/torch_import.py`: it
takes the JAX package's variables `{"enc"|"dec": {"params": ...,
"batch_stats": ...}}` (nested dicts of numpy arrays, with or without the
`Checkpoint` prefix that remat adds to module names) and returns the port
model's `state_dict`; `state_dict_to_jax` goes the other way. For the
spatial family:

  enc ConvBNAct_0/{Conv3d_0,BatchNorm_0}    -> encoder.blocks.0.{0,1}
  enc ConvBlock_{k-1}/{Conv3d_0,BatchNorm_0,Conv3d_1,BatchNorm_1,Conv3d_2}
                                            -> encoder.blocks.k.0.{block.0,block.1,
                                               block.4,block.5,shortcut}
  enc mu / logvar / head                    -> encoder.mu / encoder.var / encoder.conv.0
  dec ConvBNAct_0                           -> decoder.blocks.0.{0,1}
  dec UpBlock_{k-1}/...                     -> decoder.blocks.k.0.{...}
  dec Conv3d_0 (output conv)                -> decoder.blocks.{last}.0

For the FC family (`torch_import.py:172-231`), the JAX modules in call
order: enc ConvBNAct_{0..10} -> encoder.block{1,1,2,2,3,3,4short,5,6,6,7}
(`.0/.1`, `.3/.4`, or `.4/.5` for block6's second), enc Conv3d_0 /
BatchNorm_0 -> encoder.block7.{3,4}, enc mu and logvar -> rows 0:z and
z:2z of encoder.fc; dec Dense_0 -> decoder.dfc.0, dec ConvBNAct_{0..9} ->
decoder.block1.0, block2u.{0,4}, block3.0, block{4,5,6}u.{0,4} (each with
its BN), dec Conv3d_{0,1} / BatchNorm_{0,1} -> decoder.block{1,3}.{3,4},
dec Conv3d_2 -> decoder.last_block.0. The JAX package flattens the
bottleneck (D, H, W, C) and the port (C, D, H, W), so the fc input features
and the dfc output features are permuted. For `ResNetClassifier` the JAX
tree is the classifier's own (given as "enc"): the spatial encoder's names
under `blocks.`, and Dense_0 -> fc.

Conv kernels go DHWIO -> OIDHW and Dense kernels (in, out) -> (out, in);
BN scale/bias/mean/var go to weight/bias/running_mean/running_var. flax
keeps no BN step counter, so `num_batches_tracked` is set to 0. Any JAX leaf
without a port tensor, or port tensor without a JAX leaf, raises.

`load_jax_train_state` / `export_train_state` carry a `SIVAETrainState`
given as plain numpy trees:

    {"enc_params", "dec_params", "enc_stats", "dec_stats": JAX trees,
     "opt_e", "opt_d": {"mu": tree, "nu": tree, "count": int}, "step": int}

(`mu` / `nu` / `count` are optax's `ScaleByAdamState` fields; the trees have
the parameters' structure.) A state with one joint Adam over both halves
(the plain VAE and CAE trainers: the port's `opt_d` is None) has no
"opt_d", and its `mu` / `nu` are the pair (encoder tree, decoder tree). A
classifier's state has only the "enc" trees. The export walks the same
trees, so it writes under exactly the names it was given, joined with "/"
(a pair's halves as "0" and "1").
"""

from __future__ import annotations

import re
from typing import (Any, Callable, Dict, Iterator, List, Mapping, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np
import torch
import torch.nn as nn

from sivae_torch.config import FCVAEConfig

_BLOCK_SUB = {"Conv3d_0": "block.0", "BatchNorm_0": "block.1", "Conv3d_1": "block.4",
              "BatchNorm_1": "block.5", "Conv3d_2": "shortcut"}
_UNIT_SUB = {"Conv3d_0": "0", "BatchNorm_0": "1"}
_LEAF = {("params", "kernel"): "weight", ("params", "bias"): "bias",
         ("params", "scale"): "weight", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}
_SIDE = {"enc": "encoder", "dec": "decoder"}


class _Leaf(NamedTuple):
    """Where a JAX leaf lives in the port: `rows` of the tensor `key` (all
    of it when None), with its layout converted by `fwd` (JAX -> port) and
    `inv` (port -> JAX)."""
    key: str
    rows: Optional[slice]
    fwd: Callable[[np.ndarray], np.ndarray]
    inv: Callable[[np.ndarray], np.ndarray]


def _conv_fwd(a: np.ndarray) -> np.ndarray:
    return a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a  # DHWIO -> OIDHW


def _conv_inv(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 4, 1, 0) if a.ndim == 5 else a  # OIDHW -> DHWIO


def _dense(a: np.ndarray) -> np.ndarray:
    return a.T if a.ndim == 2 else a


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _module_key(side: str, path: Tuple[str, ...], n_dec_blocks: int) -> str:
    """Spatial family: port module prefix for the JAX module path (the inner
    module and the leaf removed)."""
    head, rest = path[0], path[1:]
    m = re.fullmatch(r"(ConvBNAct|ConvBlock|UpBlock)_(\d+)", head)
    if m and m.group(1) == "ConvBNAct" and m.group(2) == "0" and rest[0] in _UNIT_SUB:
        return f"{side}.blocks.0.{_UNIT_SUB[rest[0]]}"
    if m and m.group(1) in ("ConvBlock", "UpBlock") and rest[0] in _BLOCK_SUB:
        want = "ConvBlock" if side == "encoder" else "UpBlock"
        if m.group(1) == want:
            return f"{side}.blocks.{int(m.group(2)) + 1}.0.{_BLOCK_SUB[rest[0]]}"
    if side == "encoder" and not rest and head in ("mu", "logvar", "head"):
        return {"mu": "encoder.mu", "logvar": "encoder.var", "head": "encoder.conv.0"}[head]
    if side == "decoder" and head == "Conv3d_0" and not rest:
        return f"decoder.blocks.{n_dec_blocks + 1}.0"
    raise KeyError(f"JAX leaf {side}:{'/'.join(path)} has no port tensor")


_FC_ENC_UNITS = [("block1", 0, 1), ("block1", 3, 4), ("block2", 0, 1), ("block2", 3, 4),
                 ("block3", 0, 1), ("block3", 3, 4), ("block4short", 0, 1), ("block5", 0, 1),
                 ("block6", 0, 1), ("block6", 4, 5), ("block7", 0, 1)]
_FC_DEC_UNITS = [("block1", 0, 1), ("block2u", 0, 1), ("block2u", 4, 5), ("block3", 0, 1),
                 ("block4u", 0, 1), ("block4u", 4, 5), ("block5u", 0, 1), ("block5u", 4, 5),
                 ("block6u", 0, 1), ("block6u", 4, 5)]
_CONV, _BN = ("Conv3d_0", "Conv_0"), ("BatchNorm_0", "BatchNorm_0")


def _fc_modules(side: str) -> Dict[Tuple[str, ...], str]:
    """FC family: JAX module path -> port module prefix, convs and BNs."""
    out: Dict[Tuple[str, ...], str] = {}
    units = _FC_ENC_UNITS if side == "encoder" else _FC_DEC_UNITS
    for i, (block, ci, bi) in enumerate(units):
        out[(f"ConvBNAct_{i}",) + _CONV] = f"{side}.{block}.{ci}"
        out[(f"ConvBNAct_{i}",) + _BN] = f"{side}.{block}.{bi}"
    if side == "encoder":   # block7's second conv + BN are bare modules
        out[_CONV] = "encoder.block7.3"
        out[_BN] = "encoder.block7.4"
    else:
        out.update({_CONV: "decoder.block1.3", _BN: "decoder.block1.4",
                    ("Conv3d_1", "Conv_0"): "decoder.block3.3",
                    ("BatchNorm_1", "BatchNorm_0"): "decoder.block3.4",
                    ("Conv3d_2", "Conv_0"): "decoder.last_block.0"})
    return out


def _fc_perm(cfg: FCVAEConfig) -> np.ndarray:
    """perm[i] = the port's (C, D, H, W) flat index of the JAX package's
    (D, H, W, C) flat index i (`torch_import.py:146-150`)."""
    d, h, w = cfg.bottleneck_spatial_shape
    idx = np.arange(cfg.forth_ch * d * h * w).reshape(cfg.forth_ch, d, h, w)
    return idx.transpose(1, 2, 3, 0).reshape(-1)


def _fc_dense_leaf(cfg: FCVAEConfig, side: str, head: str, leaf: str) -> _Leaf:
    perm, z = _fc_perm(cfg), cfg.z_ch
    if side == "encoder":   # mu / logvar: rows of encoder.fc, input features permuted
        rows = slice(0, z) if head == "mu" else slice(z, 2 * z)

        def fwd(a):
            if a.ndim == 1:
                return a
            out = np.empty((a.shape[1], a.shape[0]), a.dtype)
            out[:, perm] = a.T
            return out

        return _Leaf(f"encoder.fc.{leaf}", rows, fwd,
                     lambda t: t if t.ndim == 1 else t[:, perm].T)

    def fwd(a):   # dfc: output features permuted
        out = np.empty(a.shape[::-1], a.dtype)
        out[perm] = a.T
        return out

    return _Leaf(f"decoder.dfc.0.{leaf}", None, fwd, lambda t: t[perm].T)


def _leaf_of(model: nn.Module, side: str, col: str, path: Tuple[str, ...]) -> _Leaf:
    """The port place of the JAX leaf `path` of tree `col` on `side`
    ("encoder" or "decoder"; the classifier's tree comes as "encoder")."""
    where = f"{side}/{col}/{'/'.join(path)}"
    leaf = _LEAF.get((col, path[-1]))
    if leaf is None:
        raise KeyError(f"JAX leaf {where} has no port tensor")
    head = path[0][len("Checkpoint"):] if path[0].startswith("Checkpoint") else path[0]
    mod = (head,) + path[1:-1]
    cfg = getattr(model, "cfg", None)
    if not hasattr(model, "encoder"):   # ResNetClassifier: blocks + fc
        if mod == ("Dense_0",):
            return _Leaf(f"fc.{leaf}", None, _dense, _dense)
        key = _module_key("encoder", mod[:-1], 0)[len("encoder."):]
    elif isinstance(cfg, FCVAEConfig):
        if mod in (("mu",), ("logvar",), ("Dense_0",)):
            return _fc_dense_leaf(cfg, side, head, leaf)
        key = _fc_modules(side).get(mod)
        if key is None:
            raise KeyError(f"JAX leaf {where} has no port tensor")
    else:
        key = _module_key(side, mod[:-1], sum(n for _, n, _ in cfg.block_setting))
    return _Leaf(f"{key}.{leaf}", None, _conv_fwd, _conv_inv)


def _port_leaves(side: str, col: str, tree: Mapping,
                 model: nn.Module) -> Iterator[Tuple[Tuple[str, ...], np.ndarray, _Leaf]]:
    """(JAX path, array, port place) of every leaf of one JAX tree."""
    target = model.state_dict()
    for path, arr in _flatten(tree).items():
        lf = _leaf_of(model, side, col, path)
        if lf.key not in target:
            raise KeyError(f"JAX leaf {side}/{col}/{'/'.join(path)} -> {lf.key}: "
                           f"no such port tensor")
        yield path, arr, lf


class _Assembly:
    """Port tensors put together from JAX leaves, row blocks included;
    `done()` raises where a tensor was not filled entirely."""

    def __init__(self):
        self.out: Dict[str, torch.Tensor] = {}
        self.rows: Dict[str, int] = {}

    def put(self, lf: _Leaf, arr: np.ndarray, like: torch.Tensor) -> None:
        part = torch.tensor(lf.fwd(np.asarray(arr)), dtype=like.dtype)
        want = like.shape if lf.rows is None else like[lf.rows].shape
        if part.shape != want:
            raise ValueError(f"shape mismatch at {lf.key}: {tuple(part.shape)} vs {tuple(want)}")
        if lf.rows is None:
            self.out[lf.key] = part
            self.rows[lf.key] = like.shape[0] if like.dim() else 1
            return
        t = self.out.setdefault(lf.key, torch.zeros_like(like, device="cpu"))
        t[lf.rows] = part
        self.rows[lf.key] = self.rows.get(lf.key, 0) + part.shape[0]

    def done(self, like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        short = [k for k in self.out if self.rows[k] != (like[k].shape[0] if like[k].dim() else 1)]
        if short:
            raise KeyError(f"port tensors only partly given by JAX leaves: {short}")
        return self.out


def _to_jax(t: torch.Tensor, lf: _Leaf) -> np.ndarray:
    a = t.detach().float().cpu()
    a = (a if lf.rows is None else a[lf.rows]).numpy()
    return np.array(lf.inv(a))  # a copy: a CPU tensor's array shares its memory


def jax_to_state_dict(variables: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX model variables -> the port model's full `state_dict`."""
    target = model.state_dict()
    acc = _Assembly()
    for jside, tree in variables.items():
        for col in ("params", "batch_stats"):
            for _, arr, lf in _port_leaves(_SIDE[jside], col, tree.get(col, {}), model):
                acc.put(lf, arr, target[lf.key])
    out = acc.done(target)
    for key, t in target.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(t)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port tensors without a JAX leaf: {missing}")
    return out


def state_dict_to_jax(model: nn.Module, like: Mapping[str, Any]) -> Dict[str, Any]:
    """The port model's weights and BN statistics as JAX variables, the
    inverse of `jax_to_state_dict`: nested dicts of numpy arrays with the
    structure of `like` (JAX variables, or their shapes), in the JAX
    layouts."""
    sd = model.state_dict()
    out: Dict[str, Any] = {}
    for jside, tree in like.items():
        for col in ("params", "batch_stats"):
            for path, _, lf in _port_leaves(_SIDE[jside], col, tree.get(col, {}), model):
                node = out.setdefault(jside, {}).setdefault(col, {})
                for name in path[:-1]:
                    node = node.setdefault(name, {})
                node[path[-1]] = _to_jax(sd[lf.key], lf)
    return out


def _is_orphan(key: str, model_keys) -> bool:
    """Reference weights the model never uses: torch's BuildingBlock builds a
    projection conv even when the residual path is unused (stride != 1,
    reference models.py:28-35), the reference's variational encoder also
    carries the CAE head `encoder.conv.0`, and the FC encoder declares a
    `block8` its forward never calls (mymodel.py)."""
    return key not in model_keys and (".shortcut." in key or key.startswith("encoder.conv.")
                                      or key.startswith("encoder.block8."))


def load_reference_pth(model: nn.Module,
                       source: Union[str, Mapping[str, torch.Tensor]]) -> nn.Module:
    """Load a reference `SoftIntroVAE` checkpoint of either family (a path or
    a state_dict) into the port model with `load_state_dict(strict=True)`,
    after dropping the orphan weights the model has no place for."""
    sd = source
    if isinstance(source, str):
        sd = torch.load(source, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
            sd = sd["model"]  # save_checkpoint format (my_trainer.py:135-143)
    keys = set(model.state_dict())
    sd = {k: torch.as_tensor(v) for k, v in sd.items() if not _is_orphan(k, keys)}
    model.load_state_dict(sd)
    return model


def _sides(jax_state: Mapping[str, Any]) -> List[str]:
    """The JAX halves a state holds: "enc" and "dec", or "enc" alone (a
    classifier's state has empty decoder trees)."""
    return [j for j in ("enc", "dec") if jax_state.get(f"{j}_params")]


def _adams(state, jax_state: Mapping[str, Any]):
    """[(name, port Adam, [(JAX side, tree index or None)])]: each Adam of
    the port state and the JAX halves its moments hold."""
    sides = _sides(jax_state)
    if state.opt_d is not None:
        return [("opt_e", state.opt_e, [("enc", None)]), ("opt_d", state.opt_d, [("dec", None)])]
    if len(sides) == 2:   # one joint Adam: optax's moments are the (enc, dec) pair
        return [("opt_e", state.opt_e, [("enc", 0), ("dec", 1)])]
    return [("opt_e", state.opt_e, [(sides[0], None)])]


def load_jax_train_state(state, jax_state: Mapping[str, Any]):
    """Load a JAX `SIVAETrainState`, given as numpy trees (see the module
    docstring), into the port's state: parameters, BN running statistics,
    the Adams' first and second moments and update counts, and the step."""
    model = state.model
    model.load_state_dict(jax_to_state_dict(
        {j: {"params": jax_state[f"{j}_params"], "batch_stats": jax_state[f"{j}_stats"]}
         for j in _sides(jax_state)}, model))
    params = dict(model.named_parameters())
    for opt_name, opt, parts in _adams(state, jax_state):
        adam = jax_state[opt_name]
        moments: Dict[str, Dict[str, torch.Tensor]] = {}
        for field, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            acc = _Assembly()
            for j, i in parts:
                tree = adam[field] if i is None else adam[field][i]
                for _, arr, lf in _port_leaves(_SIDE[j], "params", tree, model):
                    acc.put(lf, arr, params[lf.key].detach())
            for key, t in acc.done(params).items():
                moments.setdefault(key, {})[name] = t
        opt.state.clear()
        names = {p: k for k, p in params.items()}
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p] = {"step": torch.tensor(float(adam["count"])),
                                **{n: t.to(p.device) for n, t in moments[names[p]].items()}}
    state.step = int(jax_state["step"])
    return state


def export_train_state(state, like: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's state as flat numpy arrays under the JAX tree's names,
    "enc_params/.../kernel", "dec_stats/.../var", "opt_e/mu/.../kernel"
    (a joint Adam's "opt_e/mu/0/..." and "opt_e/mu/1/..."), "opt_e/count",
    "step", in the JAX layouts. `like` is a JAX state as
    `load_jax_train_state` takes it; only its tree structure is read."""
    model = state.model
    params = dict(model.named_parameters())
    out: Dict[str, np.ndarray] = {"step": np.asarray(state.step)}
    sides = _sides(like)
    variables = state_dict_to_jax(model, {j: {"params": like[f"{j}_params"],
                                              "batch_stats": like[f"{j}_stats"]} for j in sides})
    for j in sides:
        for col, name in (("params", f"{j}_params"), ("batch_stats", f"{j}_stats")):
            for path, arr in _flatten(variables[j].get(col, {})).items():
                out["/".join((name,) + path)] = arr
    for opt_name, opt, parts in _adams(state, like):
        counts = {int(s["step"]) for s in opt.state.values()}
        if len(counts) > 1:
            raise ValueError(f"{opt_name}: parameters disagree on the update count: {counts}")
        out[f"{opt_name}/count"] = np.asarray(counts.pop() if counts else 0)
        for field, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for j, i in parts:
                tree = like[opt_name][field] if i is None else like[opt_name][field][i]
                pre = (opt_name, field) if i is None else (opt_name, field, str(i))
                for path, arr, lf in _port_leaves(_SIDE[j], "params", tree, model):
                    st = opt.state.get(params[lf.key])
                    out["/".join(pre + path)] = (
                        np.zeros(arr.shape, arr.dtype) if st is None else _to_jax(st[name], lf))
    return out
