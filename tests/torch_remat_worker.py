"""Runs of the rematerialisation modes for tests/test_torch_remat.py, in a
process of its own so that the test's groups of runs go side by side (a
tiny step on the CPU is Python-bound: threads would not overlap them).

Each run takes `steps` Soft-IntroVAE steps of a tiny model from the seeded
state (weights of seed 0, the state's generator of seed 0, one fixed batch
of 4 volumes), in one remat mode or without remat, and records per step
the metrics, the model's `state_dict`, both Adams' first moments and the
dispatches of the three kernels (their plain versions, counted). It imports
torch and sivae_torch only.

Usage: python tests/torch_remat_worker.py <out.pth> '<json list of runs>'
with a run [name, share_phase_d_dropout_keys, mode, steps, hi_res_voxels]:
name "tiny_spatial", "tiny_fc" or "tiny_fc_unfused" (tiny_fc with the
upsample and its conv apart); mode "off", "remat-<policy>" or
"calls-<policy>" (the policy "None" or a `remat_policy` name);
hi_res_voxels the threshold the run uses, or null for the port's own.
"""

import collections
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BATCH = 4


def policy(mode):
    """("remat" | "calls", the policy name or None) of a mode."""
    kind, pol = mode.split("-", 1)
    return kind, None if pol == "None" else pol


def model_config(name):
    from sivae_torch.models.registry import get_model_config

    if name == "tiny_fc_unfused":
        return dataclasses.replace(get_model_config("tiny_fc"), fuse_upconv=False)
    return get_model_config(name)


def conv_sites(cfg):
    """(encoder, decoder) `ConvSite` lists of either family."""
    from sivae_torch.models.fc_vae import fc_conv_sites
    from sivae_torch.models.resnet_vae import spatial_conv_sites

    return (spatial_conv_sites if hasattr(cfg, "block_setting") else fc_conv_sites)(cfg)


class Dispatches:
    """Counts the kernels' dispatches: their plain versions, on the CPU."""

    def __init__(self):
        import sivae_torch.kernels.conv3d as kconv
        import sivae_torch.kernels.conv3d_small as ksmall

        self.n = collections.Counter()
        for mod, fn, key in ((kconv, "conv3d_same_plain", "conv3d_same"),
                             (ksmall, "conv3d_to1_plain", "conv3d_to1"),
                             (ksmall, "conv3d_from1_plain", "conv3d_from1")):
            setattr(mod, fn, self._counted(getattr(mod, fn), key))

    def _counted(self, f, key):
        def g(*a, **k):
            self.n[key] += 1
            return f(*a, **k)
        return g

    def take(self):
        from sivae_torch.models.remat import KERNELS

        out = {k: self.n[k] for k in KERNELS}
        self.n.clear()
        return out


def snapshot(state):
    model = state.model
    names = {p: k for k, p in model.named_parameters()}
    return {"sd": {k: v.clone() for k, v in model.state_dict().items()},
            "m": {names[p]: s["exp_avg"].clone() for opt in (state.opt_e, state.opt_d)
                  for p, s in opt.state.items()}}


def run(name, share, mode, steps, counter):
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.models.registry import make_model
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    cfg, calls, pol = model_config(name), False, None
    if mode != "off":
        kind, pol = policy(mode)
        calls = kind == "calls"
        if not calls:
            cfg = dataclasses.replace(cfg, remat=True, remat_policy=pol)
    model = make_model(cfg, device="cpu", seed=0)
    state = create_train_state(model, seed=0)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape, remat_calls=calls,
                                      remat_calls_policy=pol if calls else None,
                                      share_phase_d_dropout_keys=share)
    real = torch.from_numpy(np.random.RandomState(1).rand(BATCH, 1, *cfg.input_shape)
                            .astype(np.float32))
    out = []
    for _ in range(steps):
        counter.take()
        _, m = step(state, real)
        out.append({"metrics": {k: float(v) for k, v in m.items()}, "n": counter.take(),
                    **snapshot(state)})
    return out


def main(path, spec):
    from sivae_torch.models import remat

    torch.set_num_threads(1)
    counter, res = Dispatches(), {}
    own = remat.HI_RES_VOXELS
    for name, share, mode, steps, hi in json.loads(spec):
        remat.HI_RES_VOXELS = own if hi is None else hi
        res[(name, share, mode, hi)] = run(name, share, mode, steps, counter)
    torch.save(res, path)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
