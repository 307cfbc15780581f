"""sivae_torch depth sharding on the CPU: gloo ranks on a `data x spatial`
grid against the JAX step on the same 2-D mesh (tests/test_spatial_sharding.py)
and against one process on the same global batch.

A module fixture launches `tests/torch_depth_worker.py` three times at once:
as 4 ranks of a gloo group (a 2 x 2 grid, then a 1 x 4 one), as 2 ranks (a
1 x 2 grid), and without a launcher's environment (one process, the
reference), within one 150 s limit, killed on expiry. While they run, this
process jits the JAX step on `make_mesh((2, 2), ("data", "spatial"))` and
JAX's encode on a 1 x 2 mesh (conftest gives 8 CPU devices). `tiny_spatial`
at 16^3 (latent 4^3), no dropout, global batch 4, weights carried from
flax's init with random BN statistics (as tests/test_torch_ddp.py).

The cases: the fp32 step with zero eps and a fixed noise batch on 2 x 2
against JAX (losses within 2e-4 relative, parameters within 5e-4: the
bounds of tests/test_spatial_sharding.py; Adam's first moments by
`assert_moments_close`, the decoder's latent 1x1 conv against one
process's float64 step of the same case); the float64 step with its eps and
noise drawn, plain and dp_semantics, on 2 x 2 and on 1 x 2, and at input
(24, 16, 16) on 1 x 4 (unequal slabs: 8/8/4/4), each against one process
(1e-6); the float64 step with every block rematerialised on 1 x 2 against
the same step without remat (the same halo exchanges and all-reduces: a
rerun issues no collective); the halo exchange's gradient by `gradcheck`
in float64; `encode_dataset` on 1 x 2 against JAX's encode on a 1 x 2 mesh
(1e-5) and one process; the halo exchanges a step against the count derived
from the model's conv sites.
"""

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import sivae_tpu.train.step as jax_step
from sivae_tpu.config import OptimConfig as JaxOptimConfig
from sivae_tpu.config import SoftIntroLossConfig as JaxLossConfig
from sivae_tpu.models.registry import get_model_config as jax_get_model_config
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_tpu.parallel import mesh as jax_mesh
from sivae_tpu.train.state import create_train_state as jax_create_train_state
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.models.resnet_vae import depth_levels
from sivae_torch.parallel import mesh as port_mesh
from sivae_torch.train.state import create_train_state
from sivae_torch.utils.checkpoint import load_payload, state_payload
from sivae_torch.utils.jax_import import export_train_state, load_jax_train_state
from chip_smoke import soft_intro_step_halos
from torch_port_common import (LATENT_CONV_KERNEL, assert_close_scaled, assert_moments_close,
                               flat_random_draws, flat_state, jax_state_trees, join_workers,
                               launch_workers, perturb, to_ncdhw)

torch.set_num_threads(2)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_depth_worker.py")
BATCH = 4
SHAPE = (16, 16, 16)
LIMIT_S = 150.0


def _jax_state():
    """flax's init of `tiny_spatial` without dropout, random BN statistics
    and a non-zero logvar head (`perturb`), one Adam a half; and the port's
    config of the same model."""
    cfg_t = get_model_config("tiny_spatial")
    act = cfg_t.act.with_no_dropout()
    cfg_j = dataclasses.replace(jax_get_model_config("tiny_spatial"), act=act, remat=False)
    model = jax_make_model(cfg_j)
    x0 = jnp.zeros((1,) + SHAPE + (1,), jnp.float32)
    with flat_random_draws():
        st = jax_create_train_state(model, jax.random.key(0), x0, JaxOptimConfig(), 1)
    v = perturb({"enc": {"params": st.enc_params, "batch_stats": st.enc_stats},
                 "dec": {"params": st.dec_params, "batch_stats": st.dec_stats}}, 0)
    st = st.replace(enc_params=v["enc"]["params"], enc_stats=v["enc"]["batch_stats"],
                    dec_params=v["dec"]["params"], dec_stats=v["dec"]["batch_stats"])
    return dataclasses.replace(cfg_t, act=act), model, st, v


@pytest.fixture(scope="module")
def depth(tmp_path_factory):
    t_end = time.monotonic() + LIMIT_S
    in_dir = tmp_path_factory.mktemp("depth_in")
    rng = np.random.RandomState(11)
    real = rng.rand(BATCH, *SHAPE, 1).astype(np.float32)
    cfg_t, model_j, st_j, variables = _jax_state()
    fixed = rng.randn(BATCH, cfg_t.latent_dim).astype(np.float32)
    real24 = rng.rand(BATCH, 1, 24, 16, 16).astype(np.float32)
    vox = rng.rand(3, *SHAPE, 1).astype(np.float32)
    trees = jax_state_trees(st_j)
    model = make_model(cfg_t, device="cpu")
    torch.save(state_payload(load_jax_train_state(create_train_state(model, seed=0), trees)),
               in_dir / "soft.pth")
    np.savez(in_dir / "inputs.npz", real=to_ncdhw(real).contiguous().numpy(), fixed=fixed,
             real24=real24, vox=to_ncdhw(vox).contiguous().numpy())
    procs = launch_workers(WORKER, in_dir, (4, 2, 0))
    try:
        out = {"trees": trees, "cfg_t": cfg_t}
        mesh = jax_mesh.make_mesh((2, 2), ("data", "spatial"))
        xb = jax_mesh.shard_batch(real, mesh, spatial_axis="spatial")
        assert xb.sharding.spec == ("data", "spatial")
        st = jax_mesh.replicate_state(st_j, mesh)
        step = jax.jit(jax_step.make_soft_intro_train_step(
            model_j, JaxLossConfig(), JaxOptimConfig(), 1, SHAPE, zero_noise=True,
            fixed_noise=fixed))

        @jax.jit
        def enc(v, x):
            (mu, _), _ = model_j.encode(v, x)
            return mu

        mesh12 = jax_mesh.make_mesh((1, 2), ("data", "spatial"))
        vs = jax.device_put(np.asarray(vox), jax_mesh.volume_sharding(mesh12))
        vrep = jax.device_put(variables["enc"], NamedSharding(mesh12, P()))
        with ThreadPoolExecutor(2) as ex:
            jobs = [ex.submit(lambda: step.lower(st, xb).compile()),
                    ex.submit(lambda: enc.lower(vrep, vs).compile())]
            step_c, enc_c = (j.result() for j in jobs)
        st1, m = step_c(st, xb)
        out["jax_state"] = flat_state(jax_state_trees(st1))
        out["jax_metrics"] = {k: float(np.asarray(v)) for k, v in m.items()}
        out["jax_mu"] = np.asarray(enc_c(vrep, vs))
    finally:
        join_workers(procs, t_end)
    for world, (d, ps) in procs.items():
        out[world] = [torch.load(d / f"rank{r}.pth", weights_only=False) for r in range(len(ps))]
    out["one"] = out.pop(0)[0]
    return out


def _mean_metrics(ranks, name):
    ms = [r[name]["metrics"] for r in ranks]
    return {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}


def _restored(cfg, payload):
    model = make_model(cfg, device="cpu")
    return load_payload(create_train_state(model, seed=0), payload)


# ---------------------------------------------------------------------------
# the slabs and the mesh, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth_,parts,levels,want", [
    (10, 4, 0, [(0, 3), (3, 6), (6, 8), (8, 10)]),
    (80, 4, 3, [(0, 24), (24, 48), (48, 64), (64, 80)]),
    (160, 4, 4, [(0, 48), (48, 96), (96, 128), (128, 160)]),
    (160, 2, 4, [(0, 80), (80, 160)]),
    (24, 4, 2, [(0, 8), (8, 16), (16, 20), (20, 24)]),
    (16, 1, 2, [(0, 16)])])
def test_slab_bounds(depth_, parts, levels, want):
    assert port_mesh.slab_bounds(depth_, parts, levels) == want


@pytest.mark.parametrize("depth_,parts,levels,msg", [
    (20, 2, 3, "does not divide"), (16, 8, 2, "cannot feed")])
def test_slab_bounds_refuse(depth_, parts, levels, msg):
    with pytest.raises(ValueError, match=msg):
        port_mesh.slab_bounds(depth_, parts, levels)


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "spatial")),
                                         ((1,), ("model",)), ((-1, -1), ("data", "spatial"))])
def test_make_mesh_refuses_what_the_world_cannot_hold(shape, names):
    with pytest.raises(ValueError):
        port_mesh.make_mesh(shape, names)


def test_one_process_mesh_is_the_identity():
    m = port_mesh.make_mesh((-1,), ("data",))
    try:
        assert (m.shape, m.grid.data, m.grid.spatial) == ((1,), 1, 1)
        x = torch.arange(2 * 16).reshape(2, 1, 16, 1, 1)
        assert torch.equal(port_mesh.shard_batch(x, m, spatial_axis="spatial", levels=2), x)
        assert port_mesh.volume_slab(10) == slice(0, 10)
    finally:
        from sivae_torch.parallel.distributed import shutdown

        shutdown()


@pytest.mark.parametrize("name,levels,halos", [("tiny_spatial", 2, 172),
                                               ("spatial_1200", 3, 222),
                                               ("spatial_1200_fullsize", 4, 272)])
def test_depth_levels_and_derived_halos(name, levels, halos):
    cfg = get_model_config(name)
    assert depth_levels(cfg) == levels
    assert soft_intro_step_halos(cfg) == halos


# ---------------------------------------------------------------------------
# the 2 x 2 grid against the JAX step on a 2 x 2 mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["lossE", "lossD", "loss_rec", "kl_real", "rec_kl", "fake_kl"])
def test_grid_step_metrics_match_jax_mesh(depth, key):
    got = _mean_metrics(depth[4], "soft")
    np.testing.assert_allclose(got[key], depth["jax_metrics"][key], rtol=2e-4, atol=1e-30)


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_grid_step_parameters_match_jax_mesh(depth, side):
    state = _restored(depth["cfg_t"], depth[4][0]["soft"]["payload"])
    got = export_train_state(state, depth["trees"])
    keys = [k for k in depth["jax_state"] if k.startswith(f"{side}_params/")]
    assert len(keys) >= 10
    for k in keys:
        np.testing.assert_allclose(got[k], depth["jax_state"][k], rtol=0, atol=5e-4, err_msg=k)


def test_grid_step_first_moments_match_jax_mesh(depth):
    """Both Adams' first moments (0.1 x the gradient) against the JAX mesh
    step's by `assert_moments_close`: the depth-sharded backward itself,
    which the parameters after one Adam step (each moved by at most lr)
    cannot show. The conv biases in front of a BN have an exact gradient of
    0; the decoder's latent 1x1 conv is held to one process's float64 step."""
    state = _restored(depth["cfg_t"], depth[4][0]["soft"]["payload"])
    got = export_train_state(state, depth["trees"])
    mu = {k: v for k, v in depth["jax_state"].items() if k.startswith(("opt_e/mu/", "opt_d/mu/"))}
    assert len(mu) >= 20
    cfg64 = dataclasses.replace(depth["cfg_t"], dtype=torch.float64, param_dtype=torch.float64)
    latent = f"opt_d/mu/{LATENT_CONV_KERNEL}"
    exact = export_train_state(_restored(cfg64, depth["one"]["soft64"]["payload"]),
                               depth["trees"])[latent]
    assert_moments_close({k: got[k] for k in mu}, mu,
                         zero_grad=[k for k in mu if k.endswith("ConvBNAct_0/Conv3d_0/Conv_0/bias")],
                         float64={latent: exact})


def test_grid_step_running_statistics_match_jax_mesh(depth):
    state = _restored(depth["cfg_t"], depth[4][0]["soft"]["payload"])
    got = export_train_state(state, depth["trees"])
    stats = [k for k in depth["jax_state"] if "_stats/" in k]
    assert len(stats) >= 8
    for k in stats:
        noisy = k == "enc_stats/ConvBNAct_0/BatchNorm_0/BatchNorm_0/mean"  # test_torch_ddp.py
        np.testing.assert_allclose(got[k], depth["jax_state"][k], rtol=0,
                                   atol=1e-4 if noisy else 1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# grids against one process
# ---------------------------------------------------------------------------

GRID_CASES = [(4, "port_soft"), (4, "port_dp"), (4, "unequal"), (2, "port_soft"), (2, "remat")]


@pytest.mark.parametrize("world,name", GRID_CASES)
def test_grid_step_matches_one_process(depth, world, name):
    """float64, eps and noise drawn (each rank keeps its rows and depth slab
    of one process's draw): metrics, BN running statistics and both Adams'
    first moments within 1e-6 of one process's (rounding noise where the
    exact gradient is 0: 1e-12 of the largest moment)."""
    one = depth["one"]["port_soft" if name == "remat" else name]
    ranks = depth[world]
    got = _mean_metrics(ranks, name)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-30, err_msg=k)
    two = ranks[0][name]["payload"]
    for k, x in one["payload"]["model"].items():
        if "running" in k:
            assert_close_scaled(two["model"][k].numpy(), x.numpy(), 1e-6)
    moments = [(s["exp_avg"], two[o]["state"][i]["exp_avg"])
               for o in ("opt_e", "opt_d") for i, s in one["payload"][o]["state"].items()]
    noise = 1e-12 * max(a.abs().max().item() for a, _ in moments)
    for a, b in moments:
        assert (a - b).abs().max().item() <= 1e-6 * a.abs().max().item() + noise


@pytest.mark.parametrize("world,name", [(4, "soft")] + GRID_CASES)
def test_grid_ranks_hold_identical_states(depth, world, name):
    digests = {r[name]["digest"] for r in depth[world]}
    assert len(digests) == 1


@pytest.mark.parametrize("world,name", [(4, "soft"), (4, "port_dp"), (4, "unequal"),
                                        (2, "port_soft")])
def test_grid_halo_exchanges_match_the_derived_count(depth, world, name):
    """Every rank makes the step's derived halo exchanges (forward and
    backward), reduces the per-sample sums over its spatial ranks and the BN
    statistics over the grid; the dp_semantics means over its data ranks."""
    want = soft_intro_step_halos(depth["cfg_t"])
    for r in depth[world]:
        c = r[name]["collectives"]
        assert c["halo"][0] == want, (name, c)
        assert c["spatial"][0] > 0 and c["bn"][0] > 0 and c["bn_grad"][0] > 0, (name, c)
        assert c.get("loss", [0])[0] == (2 if name == "port_dp" else 0), (name, c)
        assert "halo_host" not in c   # CPU tensors go over gloo as they are


def test_remat_reruns_issue_no_collective(depth):
    """Every block rematerialised (policy None) on 1 x 2: the same halo
    exchanges, all-reduces and bytes as the step without remat, and the
    same step to rounding."""
    for r in depth[2]:
        assert r["remat"]["collectives"] == r["port_soft"]["collectives"]
        for k, v in r["port_soft"]["metrics"].items():
            np.testing.assert_allclose(r["remat"]["metrics"][k], v, rtol=1e-12, atol=1e-30)


# ---------------------------------------------------------------------------
# the halo exchange and the eval encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 1])
def test_halo_gradcheck(depth, rank):
    h = depth[2][rank]["halo"]
    assert h["gradcheck"] and h["value_err"] < 1e-12, h


def test_encode_matches_jax_mesh(depth):
    want = depth["jax_mu"].reshape(3, -1)
    for r in depth[2]:
        np.testing.assert_allclose(r["encode"]["mu"], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rep", ["mu", "z_val"])
def test_encode_matches_one_process(depth, rep):
    want = depth["one"]["encode"][rep]
    assert want.shape == (3, depth["cfg_t"].latent_dim)
    for r in depth[2]:
        np.testing.assert_allclose(r["encode"][rep], want, rtol=0, atol=1e-6)
        # 2 batches: mu's latents (one gather each), then z_val's (mu and logvar)
        assert r["encode"]["collectives"]["gather"][0] == 2 + 2 * 2
