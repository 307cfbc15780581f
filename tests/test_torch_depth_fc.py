"""sivae_torch depth sharding of the FC family, the classifier, the lucky AE
and the plain steps on the CPU: gloo ranks on a `data x spatial` grid
against the JAX package on the same 2-D mesh and against one process on
the same global batch.

A module fixture launches `tests/torch_depth_fc_worker.py` three times at
once: as 4 ranks of a gloo group (a 2 x 2 grid), as 2 ranks (a 1 x 2 grid)
and without a launcher's environment (one process, the reference), within
one 150 s limit, killed on expiry. While they run this process compiles, in
threads, the JAX classifier step on `make_mesh((2, 2), ("data",
"spatial"))`, and the JAX Soft-IntroVAE step of `tiny_fc`, the JAX VAE
step, the FC encode and the lucky AE's train-mode forward on a 1 x 2 mesh
(conftest gives 8 CPU devices). Global batch 4.

Models: `tiny_fc` at input (32, 16, 16), a (2, 1, 1) bottleneck (its
16^3 default has a 1-plane bottleneck, which a grid refuses), and at (48,
16, 16) for unequal slabs (32/16 on 1 x 2); `tiny_spatial` without dropout
for the classifier, the VAE (ReLU body), the CAE and the spatial
validation step; the lucky AE at (16, 24, 16). Initial states: the port's
seeded init with random BN statistics (`perturb`), carried to JAX.

The cases: the fp32 FC step (zero eps, a fixed noise batch) on 2 x 2
against the JAX step on a 1 x 2 mesh (the JAX FC step on a 2 x 2 mesh
disagrees with JAX's own one-device step here: the comment above its
tests), and the classifier step on 2 x 2 against JAX's 2 x 2 mesh (losses
within 2e-4 relative, Adam's first moments by `assert_moments_close`, the
FC ones held to a float64 step: a gradient P times too large, P the spatial
ranks, fails there; BN running statistics); the float64 FC step
with its eps and noise drawn on 1 x 2 (unequal slabs), the VAE, CAE and
Soft-IntroVAE validation steps (spatial and FC) on 1 x 2 against one
process (1e-6); the VAE's fp32 metrics with a fixed eps batch against JAX's
1 x 2 mesh; `encode_dataset` of the FC model on 1 x 2 against JAX's encode
on a 1 x 2 mesh (1e-5) and one process; the lucky AE's train-mode forward
on 1 x 2 against one process and JAX and in float64 on 2 x 2 against one
process (its BatchNorm over the decoder Linear's features reduces over the
data ranks alone); one `remat_calls` FC step on 1 x 2 against the same step
without remat; the KL of a flat latent, not summed over the slabs; the
halo exchanges of an FC step against the count derived from its conv
sites; a grid that would leave a rank without bottleneck planes refused.
"""

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
from sivae_tpu.models.classifier import ResNetClassifier as JaxClassifier
from sivae_tpu.models.lucky_ae import LuckyDecoder as JaxLuckyDecoder
from sivae_tpu.models.lucky_ae import LuckyEncoder as JaxLuckyEncoder
from sivae_tpu.models.registry import get_model_config as jax_get_model_config
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_tpu.parallel import mesh as jax_mesh
from sivae_tpu.train.state import SIVAETrainState as JaxTrainState
from sivae_tpu.train.state import make_optimizer as jax_make_optimizer
from sivae_torch.models.lucky_ae import LuckyDecoder, LuckyEncoder
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.models.resnet_vae import depth_levels
from sivae_torch.train.state import create_train_state
from sivae_torch.utils.checkpoint import load_payload, state_payload
from sivae_torch.utils.jax_import import (export_train_state, load_jax_train_state,
                                          state_dict_to_jax)
from chip_smoke import soft_intro_step_halos
from torch_depth_fc_worker import (BATCH, CLASSES, FC_SHAPE, FC_UNEQUAL, LUCKY_SHAPE, classifier,
                                   fc_cfg)
from torch_ddp_worker import _cfg
from torch_port_common import (assert_close_scaled, assert_moments_close, flat_state,
                               jax_state_trees, join_workers, launch_workers, lucky_to_port,
                               perturb, to_ncdhw, to_ndhwc)

torch.set_num_threads(2)

WORKER = str(Path(__file__).resolve().parent / "torch_depth_fc_worker.py")
SHAPE = (16, 16, 16)
LIMIT_S = 150.0
LUCKY_BOTTLENECK = tuple(s // 8 for s in LUCKY_SHAPE)


def _jax_cfg(name, **kw):
    return dataclasses.replace(jax_get_model_config(name), remat=False, **kw)


def _adam_state(enc, dec, joint=False):
    """A JAX train state from flax variables: two Adams, or one over the
    (encoder, decoder) pair, or with `dec` None one over `enc` alone (a
    classifier)."""
    opt = jax_make_optimizer(JaxOptimConfig(), 1)
    if dec is None:
        opt_e, opt_d, dp, ds = opt.init(enc["params"]), (), {}, {}
    else:
        dp, ds = dec["params"], dec["batch_stats"]
        opt_e = opt.init((enc["params"], dp) if joint else enc["params"])
        opt_d = () if joint else opt.init(dp)
    return JaxTrainState(enc_params=enc["params"], dec_params=dp, enc_stats=enc["batch_stats"],
                         dec_stats=ds, opt_e=opt_e, opt_d=opt_d, rng=jax.random.key(1),
                         step=jnp.zeros((), jnp.int32))


def _carried(model_t, model_j, shape, joint=False, classifier_=False):
    """The port's seeded init with `perturb`'s BN statistics as JAX
    variables (through the tree `jax.eval_shape` gives for the JAX init),
    the JAX state over them, its trees, and the port's state payload."""
    x0 = jnp.zeros((1,) + tuple(shape) + (1,), jnp.float32)
    if classifier_:
        v = perturb(state_dict_to_jax(model_t, {"enc": jax.eval_shape(model_j.init,
                                                                       jax.random.key(0), x0)}))
        st = _adam_state(v["enc"], None)
    else:
        v = perturb(state_dict_to_jax(model_t, jax.eval_shape(model_j.init, jax.random.key(0),
                                                              x0)))
        st = _adam_state(v["enc"], v["dec"], joint)
    trees = jax_state_trees(st)
    state = load_jax_train_state(create_train_state(model_t, seed=0, joint_optimizer=joint
                                                    or classifier_), trees)
    return v, st, trees, state_payload(state)


def _lucky_variables():
    """JAX lucky AE variables (kernels of flax's lecun-normal scale, then
    `perturb`'s BN statistics), carried into the port's modules."""
    enc_j, dec_j = JaxLuckyEncoder(), JaxLuckyDecoder(bottleneck=LUCKY_BOTTLENECK)
    rng = np.random.RandomState(5)

    def draw(shapes, seed):
        def one(path, s):
            fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return perturb(jax.tree_util.tree_map_with_path(one, shapes), seed)

    x0 = jnp.zeros((1,) + LUCKY_SHAPE + (1,), jnp.float32)
    ev = draw(jax.eval_shape(enc_j.init, jax.random.key(0), x0), 1)
    dv = draw(jax.eval_shape(dec_j.init, jax.random.key(1), jnp.zeros((1, 512))), 2)
    enc, dec = LuckyEncoder(LUCKY_SHAPE), LuckyDecoder(LUCKY_BOTTLENECK)
    lucky_to_port(ev, dv, enc, dec, LUCKY_BOTTLENECK)
    return enc_j, dec_j, ev, dv, {"enc": enc.state_dict(), "dec": dec.state_dict()}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    t_end = time.monotonic() + LIMIT_S
    in_dir = tmp_path_factory.mktemp("depth_fc_in")
    rng = np.random.RandomState(21)
    fc_real = rng.rand(BATCH, *FC_SHAPE, 1).astype(np.float32)
    fc_fixed = rng.randn(BATCH, fc_cfg().z_ch).astype(np.float32)
    real = rng.rand(BATCH, *SHAPE, 1).astype(np.float32)
    labels = np.array([0, 2, 1, 2], np.int32)
    vae_eps = rng.randn(BATCH, 1, 4, 4, 4).astype(np.float32)
    fc_vox = rng.rand(3, *FC_SHAPE, 1).astype(np.float32)
    lucky_x = rng.rand(BATCH, *LUCKY_SHAPE, 1).astype(np.float32)

    cfg_fc = fc_cfg()
    fc_j = jax_make_model(_jax_cfg("tiny_fc", input_shape=FC_SHAPE))
    fc_v, fc_st, fc_trees, fc_pay = _carried(make_model(cfg_fc, device="cpu"), fc_j, FC_SHAPE)
    act = _cfg().act
    clf_j = JaxClassifier(_jax_cfg("tiny_spatial", act=act), num_classes=CLASSES)
    _, clf_st, clf_trees, clf_pay = _carried(classifier(_cfg()), clf_j, SHAPE, classifier_=True)
    vae_act = dataclasses.replace(act, body_act="relu")
    vae_j = jax_make_model(_jax_cfg("tiny_spatial", act=vae_act))
    _, vae_st, vae_trees, vae_pay = _carried(make_model(_cfg(body_act="relu"), device="cpu"),
                                             vae_j, SHAPE, joint=True)
    lenc_j, ldec_j, lev, ldv, lucky_pay = _lucky_variables()
    for name, pay in (("fc", fc_pay), ("clf", clf_pay), ("vae", vae_pay), ("lucky", lucky_pay)):
        torch.save(pay, in_dir / f"{name}.pth")
    np.savez(in_dir / "inputs.npz", fc_real=to_ncdhw(fc_real).contiguous().numpy(),
             fc_fixed=fc_fixed, real=to_ncdhw(real).contiguous().numpy(), labels=labels,
             vae_eps=vae_eps, fc_vox=to_ncdhw(fc_vox).contiguous().numpy(),
             lucky_x=to_ncdhw(lucky_x).contiguous().numpy(),
             fc_real48=rng.rand(BATCH, 1, *FC_UNEQUAL),
             kl_mu=rng.randn(BATCH, 7), kl_lv=0.3 * rng.randn(BATCH, 7))
    procs = launch_workers(WORKER, in_dir, (4, 2, 0))
    out = {"fc_trees": fc_trees, "clf_trees": clf_trees, "vae_trees": vae_trees,
           "labels": labels}
    eps_j = jnp.asarray(np.moveaxis(vae_eps, 1, -1))
    drawn = jax_step.reparameterize

    def fixed_reparam(rng_, mu, logvar, val_eps=None):
        if val_eps is not None or mu.shape != eps_j.shape:
            return drawn(rng_, mu, logvar, val_eps=val_eps)
        return mu.astype(jnp.float32) + eps_j * jnp.exp(0.5 * logvar.astype(jnp.float32))

    try:
        m22 = jax_mesh.make_mesh((2, 2), ("data", "spatial"))
        m12 = jax_mesh.make_mesh((1, 2), ("data", "spatial"))

        def put(x, mesh):
            return jax_mesh.shard_batch(x, mesh, spatial_axis="spatial")

        fc_step = jax.jit(jax_step.make_soft_intro_train_step(
            fc_j, JaxLossConfig(), JaxOptimConfig(), 1, FC_SHAPE, zero_noise=True,
            fixed_noise=fc_fixed))
        clf_step = jax.jit(jax_step.make_classifier_train_step(clf_j, JaxOptimConfig(), 1))
        vae_step = jax.jit(jax_step.make_vae_train_step(vae_j, JaxOptimConfig(), 1, mse_w=1.0,
                                                        kl_w=2.0))

        @jax.jit
        def fc_encode(v, x):
            (mu, _), _ = fc_j.encode(v, x)
            return mu

        @jax.jit
        def lucky(ev, dv, x):
            z, me = lenc_j.apply(ev, x, train=True, mutable=["batch_stats"])
            y, md = ldec_j.apply(dv, z, train=True, mutable=["batch_stats"])
            return z, y, me["batch_stats"], md["batch_stats"]

        def rep(tree, mesh):
            return jax.device_put(tree, NamedSharding(mesh, P()))

        args = {"fc": (jax_mesh.replicate_state(fc_st, m12), put(fc_real, m12)),
                "clf": (jax_mesh.replicate_state(clf_st, m22), put(real, m22),
                        jax_mesh.shard_batch(labels, m22)),
                "vae": (jax_mesh.replicate_state(vae_st, m12), put(real, m12)),
                "enc": (rep(fc_v["enc"], m12), put(fc_vox, m12)),
                "lucky": (rep(lev, m12), rep(ldv, m12), put(lucky_x, m12))}
        jax_step.reparameterize = fixed_reparam
        try:
            with ThreadPoolExecutor(5) as ex:
                jobs = {k: ex.submit(lambda f, a: f.lower(*a).compile(), f, args[k])
                        for k, f in (("fc", fc_step), ("clf", clf_step), ("vae", vae_step),
                                     ("enc", fc_encode), ("lucky", lucky))}
                compiled = {k: j.result() for k, j in jobs.items()}
        finally:
            jax_step.reparameterize = drawn
        for name in ("fc", "clf", "vae"):
            st1, m = compiled[name](*args[name])
            out[f"jax_{name}"] = flat_state(jax_state_trees(st1))
            out[f"jax_{name}_metrics"] = {k: float(np.asarray(v)) for k, v in m.items()}
        out["jax_mu"] = np.asarray(compiled["enc"](*args["enc"]))
        out["jax_lucky"] = jax.tree_util.tree_map(np.asarray, compiled["lucky"](*args["lucky"]))
    finally:
        join_workers(procs, t_end)
    for world, (d, ps) in procs.items():
        out[world] = [torch.load(d / f"rank{r}.pth", weights_only=False) for r in range(len(ps))]
    out["one"] = out.pop(0)[0]
    return out


def _mean_metrics(ranks, name):
    ms = [r[name]["metrics"] for r in ranks]
    return {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}


def _exported(model, payload, trees, joint=False):
    state = load_payload(create_train_state(model, seed=0, joint_optimizer=joint), payload)
    return export_train_state(state, trees)


# ---------------------------------------------------------------------------
# the levels and the derived halo exchanges, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,shape,levels,halos", [
    ("tiny_fc", FC_SHAPE, 4, 312), ("fc_150", None, 4, 312), ("fc_600", None, 4, 312),
    ("spatial_150", None, 4, 322)])
def test_depth_levels_and_derived_halos_of_the_fc_family(name, shape, levels, halos):
    cfg = get_model_config(name)
    if shape is not None:
        cfg = dataclasses.replace(cfg, input_shape=shape)
    assert depth_levels(cfg) == levels
    assert soft_intro_step_halos(cfg) == halos


def test_depth_levels_of_the_lucky_ae():
    assert depth_levels(LuckyEncoder(LUCKY_SHAPE)) == depth_levels(LuckyDecoder()) == 3


# ---------------------------------------------------------------------------
# 2 x 2 against the JAX package's 2 x 2 mesh
# ---------------------------------------------------------------------------


# The FC step is held to the JAX step on a 1 x 2 `data x spatial` mesh
# (depth-sharded by GSPMD), not on a 2 x 2 one: on this CPU the JAX FC step
# on a 2 x 2 mesh disagrees with the same JAX step on one device (its
# encoder's first moments by more than their own size), where its 2 x 1 and
# 1 x 2 meshes agree with it (`tools/jax_fc_mesh_check.py`). Every mesh
# computes the same global-batch step, so the 1 x 2 one is that step.


@pytest.mark.parametrize("key", ["lossE", "lossD", "loss_rec", "kl_real", "rec_kl", "fake_kl"])
def test_fc_grid_step_metrics_match_jax_mesh(grid, key):
    got = _mean_metrics(grid[4], "fc_soft")
    np.testing.assert_allclose(got[key], grid["jax_fc_metrics"][key], rtol=2e-4, atol=1e-30)


def test_fc_grid_step_first_moments_match_jax_mesh(grid):
    """Both Adams' first moments (0.1 x the gradient) against the JAX mesh
    step's by `assert_moments_close`; a Linear that took the whole gradient
    on every spatial rank would hold twice it here. The conv biases in
    front of a BN (all but the output conv's) have an exact gradient of 0.
    Every other moment of this tiny fp32 step is a near-cancelling sum
    (tests/test_torch_fc.py): the JAX step's lie up to 1.7e-3 of their
    largest from the float64 step's, so each is held to one process's
    float64 step of the same case (`assert_nearer_float64`): at most twice
    JAX's distance from it plus 1e-4 of its largest. Twice the gradient is
    its whole size away."""
    want = grid["jax_fc"]
    got = _exported(make_model(fc_cfg(), device="cpu"), grid[4][0]["fc_soft"]["payload"],
                    grid["fc_trees"])
    cfg64 = fc_cfg(torch.float64)
    exact = _exported(make_model(cfg64, device="cpu"), grid["one"]["fc_soft64"]["payload"],
                      grid["fc_trees"])
    mu = {k: v for k, v in want.items() if k.startswith(("opt_e/mu/", "opt_d/mu/"))}
    zero = {k for k in mu if k.endswith("/Conv_0/bias")
            and not k.endswith("Conv3d_2/Conv_0/bias")}
    assert len(zero) == 24 and len(mu) == 2 * (25 + 24 + 3)
    assert_moments_close({k: got[k] for k in mu}, mu, zero_grad=zero,
                         float64={k: exact[k] for k in mu if k not in zero})
    doubled = {k: 2 * got[k] for k in mu}
    with pytest.raises(AssertionError):   # the P-times gradient this guards against
        assert_moments_close(doubled, mu, zero_grad=zero,
                             float64={k: exact[k] for k in mu if k not in zero})
    for k in (k for k in want if k.startswith(("enc_stats/", "dec_stats/"))):
        # the encoder's means follow the zero-gradient biases Adam moved
        # by +-lr (tests/test_torch_fc.py)
        tol = 1e-4 if k.startswith("enc_stats/") and k.endswith("/mean") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_classifier_grid_step_matches_jax_mesh(grid):
    m = _mean_metrics(grid[4], "clf")
    want = grid["jax_clf_metrics"]
    np.testing.assert_allclose(m["loss"], want["loss"], rtol=2e-4)
    assert m["acc"] == want["acc"] and not m["nan"]
    got = _exported(classifier(_cfg()), grid[4][0]["clf"]["payload"], grid["clf_trees"],
                    joint=True)
    mu = {k: v for k, v in grid["jax_clf"].items() if k.startswith("opt_e/mu/")}
    assert len(mu) >= 20 and "opt_e/mu/Dense_0/kernel" in mu
    stem_bias = {k for k in mu if k.endswith("ConvBNAct_0/Conv3d_0/Conv_0/bias")}
    assert_moments_close({k: got[k] for k in mu}, mu, zero_grad=stem_bias)
    for k in (k for k in grid["jax_clf"] if "_stats/" in k):
        np.testing.assert_allclose(got[k], grid["jax_clf"][k], rtol=0, atol=1e-5, err_msg=k)


def test_classifier_grid_eval_step_matches_one_process(grid):
    """Each rank's loss is its rows' mean: the ranks' mean is one
    process's; its predictions are one process's for its rows."""
    one = grid["one"]["clf"]["eval"]
    got = np.mean([r["clf"]["eval"]["metrics"]["loss"] for r in grid[4]])
    np.testing.assert_allclose(got, one["metrics"]["loss"], rtol=1e-5)
    for i, r in enumerate(grid[4]):
        rows = slice(2 * (i // 2), 2 * (i // 2) + 2)   # rank = data index x 2 + spatial index
        assert torch.equal(r["clf"]["eval"]["pred"], one["pred"][rows])


@pytest.mark.parametrize("world,name", [(4, "fc_soft"), (4, "clf"), (2, "fc64"), (2, "fc_remat"),
                                        (2, "vae64"), (2, "vae"), (2, "cae64")])
def test_grid_ranks_hold_identical_states(grid, world, name):
    digests = {r[name]["digest"] for r in grid[world]}
    assert len(digests) == 1


# ---------------------------------------------------------------------------
# grids against one process
# ---------------------------------------------------------------------------

ONE_PROCESS = [("fc64", "fc64"), ("fc_remat", "fc64"), ("vae64", "vae64"), ("cae64", "cae64")]


@pytest.mark.parametrize("name,ref", ONE_PROCESS)
def test_grid_step_matches_one_process(grid, name, ref):
    """float64 on 1 x 2, eps and noise drawn: metrics, BN running
    statistics and the first moments within 1e-6 of one process's
    (rounding noise where the exact gradient is 0: 1e-12 of the largest)."""
    one, ranks = grid["one"][ref], grid[2]
    got = _mean_metrics(ranks, name)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-30, err_msg=k)
    two = ranks[0][name]["payload"]
    for k, x in one["payload"]["model"].items():
        if "running" in k:
            assert_close_scaled(two["model"][k].numpy(), x.numpy(), 1e-6)
    moments = [(s["exp_avg"], two[o]["state"][i]["exp_avg"])
               for o in ("opt_e", "opt_d") if one["payload"][o] is not None
               for i, s in one["payload"][o]["state"].items()]
    noise = 1e-12 * max(a.abs().max().item() for a, _ in moments)
    for a, b in moments:
        assert (a - b).abs().max().item() <= 1e-6 * a.abs().max().item() + noise


def test_fc_remat_calls_step_issues_the_same_collectives(grid):
    """remat_calls on the FC step (1 x 2, unequal slabs): the reruns issue no
    collective, and the step is the one without remat to rounding."""
    for r in grid[2]:
        assert r["fc_remat"]["collectives"] == r["fc64"]["collectives"]
        for k, v in r["fc64"]["metrics"].items():
            np.testing.assert_allclose(r["fc_remat"]["metrics"][k], v, rtol=1e-12, atol=1e-30)


@pytest.mark.parametrize("world,name", [(4, "fc_soft"), (2, "fc64")])
def test_fc_grid_halo_exchanges_match_the_derived_count(grid, world, name):
    cfg = fc_cfg(shape=FC_SHAPE if name == "fc_soft" else FC_UNEQUAL)
    want = soft_intro_step_halos(cfg)
    for r in grid[world]:
        c = r[name]["collectives"]
        assert c["halo"][0] == want, c
        assert c["spatial"][0] > 0 and c["bn"][0] > 0 and "gather" not in c, c


@pytest.mark.parametrize("name", ["eval64", "fc_eval64"])
def test_eval_step_matches_one_process(grid, name):
    want = grid["one"][name]["metrics"]
    for r in grid[2]:
        for k, v in want.items():
            np.testing.assert_allclose(r[name]["metrics"][k], v, rtol=1e-6, atol=1e-30,
                                       err_msg=k)


def test_vae_grid_metrics_match_jax_mesh(grid):
    """fp32, the same eps batch in both stacks, 1 x 2."""
    got = _mean_metrics(grid[2], "vae")
    for k in ("loss", "mse", "kl"):
        np.testing.assert_allclose(got[k], grid["jax_vae_metrics"][k], rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the FC encode, the lucky AE, the flat KL, the refusal
# ---------------------------------------------------------------------------


def test_fc_encode_matches_jax_mesh(grid):
    for r in grid[2]:
        np.testing.assert_allclose(r["encode"]["mu"], grid["jax_mu"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("rep", ["mu", "z_val"])
def test_fc_encode_matches_one_process(grid, rep):
    want = grid["one"]["encode"][rep]
    assert want.shape == (3, fc_cfg().z_ch)
    for r in grid[2]:
        np.testing.assert_allclose(r["encode"][rep], want, rtol=0, atol=1e-6)
        assert "gather" not in r["encode"]["collectives"]   # a flat latent is whole


@pytest.mark.parametrize("world,name", [(2, "lucky"), (4, "lucky22")])
def test_lucky_train_forward_matches_one_process(grid, world, name):
    """The code, the output and every running statistic (those of the
    decoder Linear's features included) on every rank; fp32 on 1 x 2,
    float64 on 2 x 2."""
    one = grid["one"][name]
    tol = 1e-4 if name == "lucky" else 1e-9   # fp32: a batch-4 BN amplifies the sums' order
    for i, r in enumerate(grid[world]):
        mine = r[name]
        rows = slice(0, BATCH) if world == 2 else slice(2 * (i // 2), 2 * (i // 2) + 2)
        assert_close_scaled(mine["z"].numpy(), one["z"][rows].numpy(), tol)
        assert_close_scaled(mine["y"].numpy(), one["y"][rows].numpy(), tol)
        for half in ("enc", "dec"):
            for k, v in one[half].items():
                if "running" in k:
                    assert_close_scaled(mine[half][k].numpy(), v.numpy(), tol)
        if world == 4:
            assert mine["collectives"]["gather"][0] == 1 + 1   # fc_bn's statistics, the output


def test_lucky_train_forward_matches_jax_mesh(grid):
    z_j, y_j, es_j, ds_j = grid["jax_lucky"]
    for r in grid[2]:
        got = r["lucky"]
        assert_close_scaled(got["z"].numpy(), z_j, 1e-4)
        assert_close_scaled(to_ndhwc(got["y"]), y_j, 1e-4)
        d, h, w = LUCKY_BOTTLENECK
        perm = np.arange(64 * d * h * w).reshape(64, d, h, w).transpose(1, 2, 3, 0).reshape(-1)
        fc_mean = got["dec"]["fc_bn.running_mean"].numpy()[perm]
        assert_close_scaled(fc_mean, ds_j["BatchNorm_0"]["mean"], 1e-5)
        assert_close_scaled(got["enc"]["bns.3.running_var"].numpy(),
                            es_j["BatchNorm_3"]["var"], 1e-5)


def test_flat_kl_is_not_summed_over_the_slabs(grid):
    """A flat latent is whole on every spatial rank: its KL on 1 x 2 is one
    process's; summed over the slabs as a spatial latent's, it is twice it."""
    one = grid["one"]["kl"]
    for r in grid[2]:
        for k in ("flat", "dp_flat", "vae_flat"):
            np.testing.assert_allclose(r["kl"][k], one[k], rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(r["kl"]["summed"], 2 * one["flat"], rtol=1e-12)
    assert one["flat"] == one["summed"]
    np.testing.assert_allclose([one["dp_flat"], one["vae_flat"]], [one["flat"], 10 * one["flat"]],
                               rtol=1e-6)   # the per-position KL takes fp32


def test_grid_refuses_a_bottleneck_without_a_plane_for_each_rank(grid):
    for r in grid[2]:
        assert "1 planes at the coarsest resolution cannot feed 2 spatial ranks" in r["refuse"]
