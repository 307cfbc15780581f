"""One rank of the depth-sharding tests (tests/test_torch_depth.py), or the
one process they are held against.

With a launcher's environment it joins a gloo process group on the CPU
(`sivae_torch.parallel.init_distributed`) and runs the cases of its world:
4 ranks run a 2 x 2 `data x spatial` grid and then a 1 x 4 one, 2 ranks a
1 x 2 one. Without a launcher it runs every case in one process. Each case
writes what it got to `<out_dir>/rank<r>.pth`. It imports torch and
sivae_torch only; the test process prepares the inputs (`<in_dir>/inputs.npz`,
the initial state as a checkpoint payload) and compares.

Usage: python tests/torch_depth_worker.py <in_dir> <out_dir>
       python tests/torch_depth_worker.py --card <out_dir>

`--card` (tests/test_torch_cuda.py) runs `card_sites` as one of two gloo
ranks that share one CUDA card (`LOCAL_RANK` 0 for both).
"""

import dataclasses
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_ddp_worker import _cfg, _result, _state  # noqa: E402

torch.set_num_threads(1)

UNEQUAL = (24, 16, 16)     # tiny_spatial's latent depth 6 over 4 ranks: 8/8/4/4


def _collectives():
    from sivae_torch.parallel.mesh import collectives

    return {k: list(v) for k, v in collectives.items()}


def step_case(mesh, payload, inp, dtype, zero, fixed=None, loss_kw=None, remat=None,
              shape=None):
    """One Soft-IntroVAE step on this rank's rows and depth slab of the
    global batch (`mesh`; the whole batch without one): the state, metrics
    and collectives."""
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.models.registry import make_model
    from sivae_torch.models.resnet_vae import depth_levels
    from sivae_torch.parallel.mesh import replicate_state, reset_collectives, shard_batch
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    cfg = _cfg(dtype=dtype, remat=remat == "block")
    if shape is not None:
        cfg = dataclasses.replace(cfg, input_shape=shape)
        state = create_train_state(make_model(cfg, device="cpu", seed=0), seed=0)
    else:
        state = _state(cfg, payload)
    state = replicate_state(state)
    step = make_soft_intro_train_step(
        state.model, SoftIntroLossConfig(**(loss_kw or {})), OptimConfig(), 1, cfg.input_shape,
        remat_calls=remat == "calls", zero_noise=zero, fixed_noise=fixed)
    real = torch.from_numpy(inp["real" if shape is None else "real24"]).to(dtype)
    if mesh is not None:
        real = shard_batch(real, mesh, spatial_axis="spatial", levels=depth_levels(cfg))
    reset_collectives()
    _, metrics = step(state, real)
    return {**_result(state, metrics), "collectives": _collectives()}


def encode_case(payload, inp):
    """encode_dataset of 3 volumes at batch 2 (a padded tail), fp32, eval
    mode: whole latents on every rank."""
    from sivae_torch.eval.latent_probe import encode_dataset
    from sivae_torch.parallel.mesh import reset_collectives

    state = _state(_cfg(), payload)
    reset_collectives()
    mu = encode_dataset(state.model, inp["vox"], batch_size=2)
    zv = encode_dataset(state.model, inp["vox"], batch_size=2, representation="z_val")
    return {"mu": mu, "z_val": zv, "collectives": _collectives()}


class _Scatter(torch.autograd.Function):
    """A whole volume (the same on every rank) -> this rank's depth slab;
    backward: every rank's slab of the cotangent, joined (the whole
    volume's gradient, on every rank)."""

    @staticmethod
    def forward(ctx, x, depth):
        from sivae_torch.parallel.mesh import volume_slab

        ctx.depth = depth
        return x[:, volume_slab(depth)].contiguous()

    @staticmethod
    def backward(ctx, g):
        from sivae_torch.parallel.mesh import gather_depth

        with torch.no_grad():
            return gather_depth(g, ctx.depth, axis=1), None


def halo_gradcheck():
    """`torch.autograd.gradcheck`, float64, of a whole-volume function that
    runs through the halo exchange: scatter an NDHWC volume to the depth
    slabs, pad each with its neighbours' planes (`pad_depth`), take a 3-tap
    weighted sum along depth (every output plane reads both halos at the
    slab's edges) and gather the slabs back. Every rank checks the same
    function on the same input, so their collectives pair up."""
    from sivae_torch.parallel.halo import exchange_planes, pad_depth
    from sivae_torch.parallel.mesh import gather_depth

    depth = 6
    x = torch.from_numpy(np.random.RandomState(3).randn(1, depth, 2, 3, 2)).requires_grad_(True)

    def f(v):
        s = _Scatter.apply(v, depth)
        p = pad_depth(s, exchange_planes(s))
        y = 1.0 * p[:, :-2] + 2.0 * p[:, 1:-1] - 3.0 * p[:, 2:]
        return gather_depth(y, depth, axis=1)

    ok = torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-8, rtol=1e-6)
    # and the values: the same sum on the whole volume with zero padding
    with torch.no_grad():
        p = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
        want = 1.0 * p[:, :-2] + 2.0 * p[:, 1:-1] - 3.0 * p[:, 2:]
        err = (f(x) - want).abs().max().item()
    return {"gradcheck": bool(ok), "value_err": err}


def run_cases(in_dir, world):
    from sivae_torch.parallel.mesh import make_mesh

    inp = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    payload = os.path.join(in_dir, "soft.pth")   # the initial state, a checkpoint payload
    dp = dict(loss_multiplier=1.0, exp_elbo_weight=0.25, dp_semantics=True)
    f64 = torch.float64
    res = {}

    def grid(shape):
        return make_mesh(shape, ("data", "spatial")) if world > 1 else None

    if world in (1, 4):
        mesh = grid((2, 2))
        res["soft"] = step_case(mesh, payload, inp, torch.float32, True, inp["fixed"])
        res["port_soft"] = step_case(mesh, payload, inp, f64, False)
        res["port_dp"] = step_case(mesh, payload, inp, f64, False, loss_kw=dp)
        if world == 1:   # the yardstick of LATENT_CONV_KERNEL's moment (torch_port_common)
            res["soft64"] = step_case(mesh, payload, inp, f64, True, inp["fixed"])
        mesh = grid((1, 4))
        res["unequal"] = step_case(mesh, payload, inp, f64, False, shape=UNEQUAL)
    if world in (1, 2):
        mesh = grid((1, 2))
        res["encode"] = encode_case(payload, inp)
        if world == 2:
            res["port_soft"] = step_case(mesh, payload, inp, f64, False)
            res["halo"] = halo_gradcheck()
        res["remat"] = step_case(mesh, payload, inp, f64, False, remat="block")
    return res


def main(in_dir, out_dir):
    from sivae_torch.parallel import init_distributed, rank, world_size

    dev = init_distributed()
    assert dev in (None, torch.device("cpu")), dev
    res = run_cases(in_dir, world_size())
    torch.save(res, os.path.join(out_dir, f"rank{rank()}.pth"))


def card_sites(dev):
    """On a 1 x 2 grid sharing one card: the halo exchange, and one sharded
    conv site of each kernel kind (`conv3d_from1` 1 -> 8, `conv3d_same`
    8 -> 16, `conv3d_to1` 8 -> 1, and the upsample + conv 8 -> 4) in fp32,
    forward and backward, on this rank's slab of a seeded volume: the whole
    volume's output and input gradient gathered, this slab's part of the
    weight and bias gradients, the collectives and launches counted."""
    from sivae_torch.kernels import build
    from sivae_torch.models.blocks import Conv3d, UpsampleConv3d
    from sivae_torch.parallel.halo import exchange_planes
    from sivae_torch.parallel.mesh import (gather_depth, make_mesh, reset_collectives,
                                           volume_slab)

    make_mesh((1, 2), ("data", "spatial"))
    rng = np.random.RandomState(5)
    out = {}
    reset_collectives()
    build.reset_launches()
    for name, ci, co, cls, shape in (("from1", 1, 8, Conv3d, (12, 10, 8)),
                                     ("same", 8, 16, Conv3d, (12, 10, 8)),
                                     ("to1", 8, 1, Conv3d, (12, 10, 8)),
                                     ("upconv", 8, 4, UpsampleConv3d, (6, 5, 4))):
        torch.manual_seed(0)
        conv = cls(ci, co, use_bias=True, generator=torch.Generator().manual_seed(1)).to(dev)
        x = torch.from_numpy(rng.randn(2, ci, *shape).astype(np.float32))
        g = torch.from_numpy(rng.randn(2, co, *[s * (2 if cls is UpsampleConv3d else 1)
                                                for s in shape]).astype(np.float32))
        d, dg = shape[0], g.shape[2]
        xs = x[:, :, volume_slab(d)].to(dev).contiguous(memory_format=torch.channels_last_3d)
        xs.requires_grad_(True)
        y = conv(xs)
        (y.float() * g[:, :, volume_slab(dg)].to(dev)).sum().backward()
        with torch.no_grad():
            out[name] = {
                "y": gather_depth(y.detach().float(), dg).cpu(),
                "dx": gather_depth(xs.grad.float(), d).cpu(),
                "dw": conv.weight.grad.cpu(), "db": conv.bias.grad.cpu(),
                "x": x, "g": g, "w": conv.weight.detach().cpu(), "b": conv.bias.detach().cpu()}
    planes = torch.arange(2 * 4 * 3 * 2 * 5, dtype=torch.float32).reshape(2, 4, 3, 2, 5)
    mine = planes[:, volume_slab(4)].to(dev)
    below, above = exchange_planes(mine)
    out["planes"] = {"below": below.cpu(), "above": above.cpu(), "whole": planes}
    out["collectives"] = _collectives()
    out["launches"] = dict(build.launches)
    return out


def card_main(out_dir):
    from sivae_torch.parallel import init_distributed, rank

    from sivae_torch.utils.device import resolve_device

    dev = init_distributed(backend="gloo")
    assert dev.type == "cuda", dev
    resolve_device(dev)   # TF32 off, as in the test process
    torch.save(card_sites(dev), os.path.join(out_dir, f"rank{rank()}.pth"))


if __name__ == "__main__":
    try:
        if sys.argv[1] == "--card":
            card_main(sys.argv[2])
        else:
            main(sys.argv[1], sys.argv[2])
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)   # a peer may be blocked in a collective: do not wait for it
    from sivae_torch.parallel import shutdown

    shutdown()
