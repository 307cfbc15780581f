"""sivae_torch data parallelism on the CPU: 2 gloo ranks against one process
on the same global batch, and against the JAX step on a 2-device mesh.

A module fixture launches `tests/torch_ddp_worker.py` ONCE as ranks 0 and 1
of a gloo group (127.0.0.1, a free port) and once without a launcher's
environment (the one-process reference, the same code on the whole global
batch), all within one 180 s limit, killed on expiry, so a hung collective
fails this file and not the suite's clock. While they run, this process
jits the JAX steps on `make_mesh((2,), ("data",))` with `replicate_state` /
`shard_batch` (as tests/test_train_step.py does with 8 devices). Global
batch 4 (2 a rank), `tiny_spatial` at 16^3, no dropout.

The cases: train-mode BatchNorm over the global batch (fp32 and bf16, with
and without the activation); one Soft-IntroVAE step, plain and dp_semantics,
and one VAE step through `_plain_update`, in fp32 against the JAX mesh step
and against one process; the same steps in float64 with their eps drawn
against one process; the pipeline's rows, with and without augmentation;
a 2-epoch `SoftIntroTrainer.fit` with one set of run files and a resume;
`replicate_state` on a perturbed rank; the train CLI's arguments with
several cards.

Tolerances: against JAX those of tests/test_torch_train.py (metrics rtol
1e-4, BN running statistics atol 1e-5, first moments per
`assert_moments_close`, parameters atol 2e-5 where |g| > 1e-3 max|g|), the
metrics being the mean over the ranks of each rank's shard mean. Against
one port process: the float64 steps (eps drawn) and the float64 fit's epoch
means 1e-6, the fp32 steps 1e-5 (the order of their sums), first moments
of the largest value in their tensor plus rounding noise; the two ranks
bit for bit. BatchNorm fp32 1e-5 and bf16 1e-2 of max(1, max|ref|) (one
bf16 rounding of y and dx), its statistics 1e-6.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sivae_tpu.train.step as jax_step
from sivae_tpu.config import OptimConfig as JaxOptimConfig
from sivae_tpu.config import SoftIntroLossConfig as JaxLossConfig
from sivae_tpu.models.registry import get_model_config as jax_get_model_config
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_tpu.parallel.mesh import make_mesh, replicate_state, shard_batch
from sivae_tpu.train.state import SIVAETrainState as JaxTrainState
from sivae_tpu.train.state import create_train_state as jax_create_train_state
from sivae_tpu.train.state import make_optimizer as jax_make_optimizer
from sivae_torch.cli import train as cli_train
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.parallel.mesh import state_digest
from sivae_torch.train.state import create_train_state
from sivae_torch.utils.checkpoint import load_payload, state_payload
from sivae_torch.utils.jax_import import (export_train_state, load_jax_train_state,
                                          state_dict_to_jax)
from chip_smoke import zero_gradient_tensors
from torch_port_common import (LATENT_CONV_KERNEL, assert_close_scaled, assert_moments_close,
                               assert_nearer_float64, flat_random_draws, flat_state,
                               jax_state_trees, perturb, to_ncdhw)

torch.set_num_threads(2)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_worker.py")
BATCH, WORLD = 4, 2
SHAPE = (16, 16, 16)
DP_LOSS = dict(loss_multiplier=1.0, exp_elbo_weight=0.25, dp_semantics=True)
BN_CASES = [(dt, slope) for dt in ("torch.float32", "torch.bfloat16") for slope in (None, 0.2)]
# the conv bias in front of the stem's BN: its exact gradient is 0
ZERO_GRAD = "ConvBNAct_0/Conv3d_0/Conv_0/bias"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cfgs(body_act="leaky_relu"):
    """tiny_spatial without dropout, in both stacks."""
    cfg_t = get_model_config("tiny_spatial")
    act = dataclasses.replace(cfg_t.act.with_no_dropout(), body_act=body_act)
    cfg_j = dataclasses.replace(jax_get_model_config("tiny_spatial"), act=act, remat=False)
    return cfg_j, dataclasses.replace(cfg_t, act=act)


def _jax_soft_state():
    """tests/test_torch_train.py's state: flax's init of `tiny_spatial`
    without dropout, with random BN statistics and a non-zero logvar head
    (`perturb`), one Adam a half."""
    cfg_j, cfg_t = _cfgs()
    model = jax_make_model(cfg_j)
    x0 = jnp.zeros((1,) + SHAPE + (1,), jnp.float32)
    with flat_random_draws():
        st = jax_create_train_state(model, jax.random.key(0), x0, JaxOptimConfig(), 1)
    v = perturb({"enc": {"params": st.enc_params, "batch_stats": st.enc_stats},
                 "dec": {"params": st.dec_params, "batch_stats": st.dec_stats}}, 0)
    st = st.replace(enc_params=v["enc"]["params"], enc_stats=v["enc"]["batch_stats"],
                    dec_params=v["dec"]["params"], dec_stats=v["dec"]["batch_stats"])
    return cfg_t, model, st


def _jax_vae_state():
    """tests/test_torch_ae.py's VAE state (ReLU body): the port's seeded init
    with random BN statistics, carried to JAX, one joint Adam."""
    cfg_j, cfg_t = _cfgs(body_act="relu")
    model_j = jax_make_model(cfg_j)
    shapes = jax.eval_shape(model_j.init, jax.random.key(0),
                            jnp.zeros((1,) + SHAPE + (1,), jnp.float32))
    v = perturb(state_dict_to_jax(make_model(cfg_t, device="cpu", seed=0), shapes))
    params = (v["enc"]["params"], v["dec"]["params"])
    st = JaxTrainState(enc_params=params[0], dec_params=params[1],
                       enc_stats=v["enc"]["batch_stats"], dec_stats=v["dec"]["batch_stats"],
                       opt_e=jax_make_optimizer(JaxOptimConfig(), 1).init(params), opt_d=(),
                       rng=jax.random.key(1), step=jnp.zeros((), jnp.int32))
    return cfg_t, model_j, st


def _port_state(cfg_t, trees, joint=False):
    model = make_model(cfg_t, device="cpu")
    return load_jax_train_state(create_train_state(model, seed=0, joint_optimizer=joint), trees)


def _restored(cfg_t, payload, joint=False):
    model = make_model(cfg_t, device="cpu")
    return load_payload(create_train_state(model, seed=0, joint_optimizer=joint), payload)


def _np_metrics(m):
    return {k: float(np.asarray(v)) for k, v in m.items()}


def _launch(in_dir, out_dir, one_dir):
    """Ranks 0 and 1 of a gloo group into `out_dir`, and the worker without a
    launcher's environment (one process, the whole global batch) into
    `one_dir`."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    base["OMP_NUM_THREADS"] = "1"
    envs = [({**base, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(WORLD),
              "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}, out_dir)
            for r in range(WORLD)] + [(base, one_dir)]
    return [subprocess.Popen([sys.executable, WORKER, str(in_dir), str(d)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for env, d in envs]


def _join(procs, limit=180.0):
    outs = []
    t_end = time.monotonic() + limit
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, t_end - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} failed:\n{out[-6000:]}"


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    in_dir, out_dir = tmp_path_factory.mktemp("ddp_in"), tmp_path_factory.mktemp("ddp_out")
    one_dir = tmp_path_factory.mktemp("ddp_one")
    rng = np.random.RandomState(11)
    real = rng.rand(BATCH, *SHAPE, 1).astype(np.float32)
    cfg_t, model_j, st_j = _jax_soft_state()
    vcfg_t, vmodel_j, vst_j = _jax_vae_state()
    fixed = rng.randn(BATCH, cfg_t.latent_dim).astype(np.float32)
    trees, vtrees = jax_state_trees(st_j), jax_state_trees(vst_j)
    vae_eps = np.random.RandomState(7).randn(BATCH, 1, 4, 4, 4).astype(np.float32)
    soft0 = state_payload(_port_state(cfg_t, trees))
    torch.save(soft0, in_dir / "soft.pth")
    torch.save(state_payload(_port_state(vcfg_t, vtrees, joint=True)), in_dir / "vae.pth")
    bn_x = (2.0 * rng.randn(BATCH, 6, 5, 4, 3) + 0.5).astype(np.float32)
    bn_g = rng.randn(*bn_x.shape).astype(np.float32)
    np.savez(in_dir / "inputs.npz", real=to_ncdhw(real).contiguous().numpy(), fixed=fixed,
             vae_eps=vae_eps, bn_x=bn_x, bn_g=bn_g)
    procs = _launch(in_dir, out_dir, one_dir)
    try:
        out = {"trees": trees, "vtrees": vtrees, "cfg_t": cfg_t, "vcfg_t": vcfg_t,
               "soft0": soft0}
        # the JAX steps on a 2-device mesh: traced here (the VAE's with the
        # fixed eps batch in place of its key's draw), compiled in threads
        mesh = make_mesh((WORLD,), ("data",))
        xb = shard_batch(real, mesh)
        lowered = {}
        for name, loss in (("soft", JaxLossConfig()), ("dp", JaxLossConfig(**DP_LOSS))):
            st = replicate_state(st_j, mesh)
            lowered[name] = (st, jax.jit(jax_step.make_soft_intro_train_step(
                model_j, loss, JaxOptimConfig(), 1, SHAPE, zero_noise=True,
                fixed_noise=fixed)).lower(st, xb))
        eps_j = jnp.asarray(np.moveaxis(vae_eps, 1, -1))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_step, "reparameterize", lambda rng_, mu, logvar, val_eps=None:
                       mu.astype(jnp.float32) + eps_j * jnp.exp(0.5 * logvar.astype(jnp.float32)))
            st = replicate_state(vst_j, mesh)
            lowered["vae"] = (st, jax.jit(jax_step.make_vae_train_step(
                vmodel_j, JaxOptimConfig(), 1, mse_w=1.0, kl_w=2.0)).lower(st, xb))
        with ThreadPoolExecutor(len(lowered)) as ex:
            compiled = dict(zip(lowered, ex.map(lambda sl: sl[1].compile(), lowered.values())))
        for name, (st, _) in lowered.items():
            st1, m = compiled[name](st, xb)
            out[f"jax_{name}"] = (flat_state(jax_state_trees(st1)), _np_metrics(m))
    finally:
        _join(procs)
    out["ranks"] = [torch.load(out_dir / f"rank{r}.pth", weights_only=False)
                    for r in range(WORLD)]
    out["one"] = torch.load(one_dir / "rank0.pth", weights_only=False)
    return out


def _moment_key(param_key, joint):
    """The flat name of a parameter's first moment: one Adam a half, or one
    joint Adam over the (encoder, decoder) pair."""
    side, path = param_key.split("/", 1)
    enc = side == "enc_params"
    if joint:
        return f"opt_e/mu/{0 if enc else 1}/{path}"
    return f"{'opt_e' if enc else 'opt_d'}/mu/{path}"


def _mean_metrics(ddp, name):
    ms = [r[name]["metrics"] for r in ddp["ranks"]]
    return {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}


def _exported(ddp, name, rank=0, one=False):
    """A step's state flat under JAX's names: rank `rank`'s, or with `one`
    the one process's (where "soft64", the float64 step, runs)."""
    vae = name == "vae"
    res = ddp["one"] if one else ddp["ranks"][rank]
    cfg = ddp["vcfg_t" if vae else "cfg_t"]
    if name == "soft64":
        cfg = dataclasses.replace(cfg, dtype=torch.float64, param_dtype=torch.float64)
    state = _restored(cfg, res[name]["payload"], joint=vae)
    return export_train_state(state, ddp["vtrees" if vae else "trees"])


# ---------------------------------------------------------------------------
# 1. BatchNorm over the global batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt,slope", BN_CASES)
def test_batchnorm_two_ranks_match_one_process(ddp, dt, slope):
    want = ddp["one"]["bn"][(dt, slope)]
    got = [r["bn"][(dt, slope)] for r in ddp["ranks"]]
    tol = 1e-5 if dt == "torch.float32" else 1e-2
    for k in ("y", "dx"):
        assert_close_scaled(torch.cat([g[k] for g in got]).numpy(), want[k].numpy(), tol)
    for g in got:   # the statistics are the global batch's on every rank
        assert_close_scaled(g["mean"].numpy(), want["mean"].numpy(), 1e-6)
        assert_close_scaled(g["var"].numpy(), want["var"].numpy(), 1e-6)
    # each rank returns its own sums; they add up to one process's gradient
    for k in ("dw", "db"):
        assert_close_scaled(sum(g[k] for g in got).numpy(), want[k].numpy(), 1e-5)
    assert not torch.equal(got[0]["dw"], got[1]["dw"])


# ---------------------------------------------------------------------------
# 2-4. the steps against JAX on a 2-device mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["soft", "dp", "vae"])
def test_step_metrics_match_jax_mesh(ddp, name):
    want = ddp[f"jax_{name}"][1]
    got = _mean_metrics(ddp, name)
    assert set(got) == set(want)
    for k in want:
        if k == "nan":
            assert not got[k] and not want[k]
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-30, err_msg=k)


@pytest.mark.parametrize("name", ["soft", "dp", "vae"])
def test_step_state_matches_jax_mesh(ddp, name):
    """BN running statistics, Adam's first moments and (where the gradient
    is significant) the parameters after one step."""
    want, got = ddp[f"jax_{name}"][0], _exported(ddp, name)
    stats = [k for k in want if "_stats/" in k]
    assert len(stats) >= 8
    for k in stats:
        noisy = k == "enc_stats/ConvBNAct_0/BatchNorm_0/BatchNorm_0/mean" and name != "vae"
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 if noisy else 1e-5,
                                   err_msg=k)
    mu = {k: v for k, v in want.items() if "/mu/" in k}
    zero = {k for k in mu if k.endswith(ZERO_GRAD)}
    if name == "vae":   # tests/test_torch_ae.py's exactly-zero gradients
        zero |= {k for k in mu if k.endswith(("head/Conv_0/bias",
                                              "1/ConvBNAct_0/Conv3d_0/Conv_0/kernel"))}
    assert zero
    f64 = None
    if name == "soft":   # the decoder's latent 1x1 conv: against the float64 step
        latent = f"opt_d/mu/{LATENT_CONV_KERNEL}"
        f64 = {latent: _exported(ddp, "soft64", one=True)[latent]}
    assert_moments_close(got, mu, zero_grad=zero, float64=f64)
    shared = total = 0
    for k in want:
        if not k.startswith(("enc_params/", "dec_params/")):
            continue
        g = want[_moment_key(k, joint=name == "vae")]
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        if k.endswith(ZERO_GRAD):
            mask[...] = False
        shared, total = shared + mask.sum(), total + mask.size
        np.testing.assert_allclose(got[k][mask], want[k][mask], atol=2e-5, err_msg=k)
    assert shared > 0.9 * total, (shared, total)


def test_step_collectives(ddp):
    """What each step reduced: every train-mode BN call's statistics (and,
    where its input needs a gradient, their cotangents), at least one
    gradient bucket a backward, and the dp_semantics expELBO's two means."""
    for name in ("soft", "dp", "vae", "port_soft", "port_dp", "port_vae"):
        c = [r[name]["collectives"] for r in ddp["ranks"]]
        assert c[0] == c[1], name
        assert c[0]["bn"][0] > 0 and c[0]["bn_grad"][0] > 0, (name, c[0])
        assert c[0]["grad"][0] >= (1 if name.endswith("vae") else 2), (name, c[0])
        assert c[0].get("loss", [0])[0] == (2 if name.endswith("dp") else 0), (name, c[0])


# ---------------------------------------------------------------------------
# 5. two ranks against one process of the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,tol", [("soft", 1e-5), ("dp", 1e-5), ("vae", 1e-5),
                                      ("port_soft", 1e-6), ("port_dp", 1e-6),
                                      ("port_vae", 1e-6)])
def test_two_ranks_match_one_process_step(ddp, name, tol):
    """The step of 2 ranks is the step of one process on the global batch:
    metrics, BN running statistics, first moments. The "port_" steps run in
    float64 and draw their reparameterisation eps (for the global batch,
    each rank keeping its rows): 1e-6. The fp32 steps (zero eps, the VAE a
    fixed eps batch) differ by the order of their sums: 1e-5 (2e-6 seen)."""
    one, two = ddp["one"][name], ddp["ranks"][0][name]
    got = _mean_metrics(ddp, name)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=1e-30, err_msg=k)
    vae = name.endswith("vae")
    for k, x in one["payload"]["model"].items():
        if "running" in k:
            # the stem conv's bias has an exactly-zero gradient, whose sign is
            # rounding noise: Adam moves it by lr one way or the other, and
            # phase D's two encoder forwards carry that into the stem BN's
            # mean (tests/test_torch_train.py)
            noisy = k == "encoder.blocks.0.1.running_mean" and not vae
            assert_close_scaled(two["payload"]["model"][k].numpy(), x.numpy(),
                                1e-4 if noisy else tol)
    moments = [(s["exp_avg"], two["payload"][o]["state"][i]["exp_avg"], (o, i))
               for o in ("opt_e", "opt_d") if one["payload"][o] is not None
               for i, s in one["payload"][o]["state"].items()]
    top = max(a.abs().max().item() for a, _, _ in moments)
    # rounding noise where a gradient is zero in exact arithmetic (a conv bias
    # in front of a BN): 1e-6 of the largest moment in fp32, 1e-12 in float64
    noise = (1e-12 if name.startswith("port_") else 1e-6) * top
    # in the fp32 "soft" step the decoder's latent 1x1 conv is held to its
    # float64 step (one process) by `assert_nearer_float64`, and the conv
    # biases in front of a BN, whose exact gradient is 0, below 1e-5 of the
    # largest moment in both runs: their rank partials cancel only across
    # the ranks, in fp32 (the latent conv's bias read 1.45e-6 on 2 ranks,
    # 5e-8 in one process). The float64 step first shows them to be zeros.
    f64 = ddp["one"]["soft64"]["payload"] if name == "soft" else None
    latent = ("opt_d", _decoder_param_index(ddp["cfg_t"], "blocks.0.0.weight"))
    zero = _zero_gradient_biases(ddp["cfg_t"]) if f64 is not None else set()
    if zero:
        exact = {(o, i): s["exp_avg"] for o in ("opt_e", "opt_d")
                 for i, s in f64[o]["state"].items()}
        top64 = max(v.abs().max().item() for v in exact.values())
        for k in zero:
            assert exact[k].abs().max().item() <= 1e-12 * top64, k
    for a, b, (o, i) in moments:
        if f64 is not None and (o, i) == latent:
            exact = f64[o]["state"][i]["exp_avg"]
            assert_nearer_float64(b.numpy(), a.numpy(), exact.numpy(), "decoder.blocks.0.0")
            continue
        if (o, i) in zero:
            assert max(a.abs().max().item(), b.abs().max().item()) <= 1e-5 * top, (o, i)
            continue
        assert (a - b).abs().max().item() <= tol * a.abs().max().item() + noise, (o, i)


def _decoder_param_index(cfg_t, name):
    """The index of the decoder's parameter `name` in `opt_d`."""
    names = [n for n, _ in make_model(cfg_t, device="cpu").decoder.named_parameters()]
    return names.index(name)


def _zero_gradient_biases(cfg_t):
    """(optimizer, index) of each conv bias in front of a BN, whose exact
    gradient is 0, from the model (`chip_smoke.zero_gradient_tensors`)."""
    model = make_model(cfg_t, device="cpu")
    biases = [n for n in zero_gradient_tensors(model) if n.endswith(".bias")]
    out = set()
    for o, prefix, half in (("opt_e", "encoder.", model.encoder),
                            ("opt_d", "decoder.", model.decoder)):
        names = [prefix + n for n, _ in half.named_parameters()]
        out |= {(o, names.index(n)) for n in biases if n.startswith(prefix)}
    assert len(out) == len(biases) > 0
    return out


@pytest.mark.parametrize("name", ["soft", "dp", "vae", "port_soft", "port_dp", "port_vae"])
def test_ranks_hold_identical_states(ddp, name):
    a, b = (r[name] for r in ddp["ranks"])
    assert a["digest"] == b["digest"]
    for k, v in a["payload"]["model"].items():
        assert torch.equal(v, b["payload"]["model"][k]), k


# ---------------------------------------------------------------------------
# 5b. rematerialisation under data parallelism (models/remat.py)
# ---------------------------------------------------------------------------


def test_remat_two_ranks_match_one_process_without_remat(ddp):
    """2 ranks with every block rematerialised (policy None) take the step of
    one process without remat (float64, eps drawn, no dropout): metrics,
    running statistics and first moments within 1e-6."""
    one, two = ddp["one"]["port_soft"], ddp["ranks"][0]["port_remat"]
    got = _mean_metrics(ddp, "port_remat")
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-30, err_msg=k)
    for k, x in one["payload"]["model"].items():
        if "running" in k:
            noisy = k == "encoder.blocks.0.1.running_mean"   # as in the test above
            assert_close_scaled(two["payload"]["model"][k].numpy(), x.numpy(),
                                1e-4 if noisy else 1e-6)
    moments = [(s["exp_avg"], two["payload"][o]["state"][i]["exp_avg"])
               for o in ("opt_e", "opt_d") for i, s in one["payload"][o]["state"].items()]
    noise = 1e-12 * max(a.abs().max().item() for a, _ in moments)
    for a, b in moments:
        assert (a - b).abs().max().item() <= 1e-6 * a.abs().max().item() + noise


@pytest.mark.parametrize("who", ["rank0", "rank1", "one"])
def test_remat_with_dropout_is_the_step_without_remat(ddp, who):
    """With dropout on, the rematerialised step of each rank (and of one
    process) is bit for bit its step without remat: the reruns replay the
    masks of the rank generator and the global batch's statistics."""
    res = ddp["one"] if who == "one" else ddp["ranks"][int(who[-1])]
    a, b = res["port_remat_drop"], res["port_drop"]
    assert a["digest"] == b["digest"]
    assert a["metrics"] == b["metrics"]


@pytest.mark.parametrize("drop", ["", "_drop"])
def test_remat_reruns_issue_no_collective(ddp, drop):
    """The reruns reduce nothing: each rank's all-reduces with remat equal
    those without (a rerun's collective would also hang the group, which
    the worker's time limit turns into a failure)."""
    base = "port_soft" if drop == "" else "port_drop"
    for r in ddp["ranks"]:
        assert r[f"port_remat{drop}"]["collectives"] == r[base]["collectives"]
        assert r[f"port_remat{drop}"]["collectives"]["bn"][0] > 0


# ---------------------------------------------------------------------------
# 6. the pipeline's rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aug", ["plain", "aug"])
def test_pipeline_rows_match_one_process(ddp, aug):
    """Each rank yields its rows of the one-process batches, bit for bit,
    without augmentation and with a random affine (p = 1) and noise, whose
    draws are taken for the global batch."""
    want = ddp["one"]["pipe"][aug]
    got = [r["pipe"][aug] for r in ddp["ranks"]]
    for e in (0, 1):
        assert len(want[e]) == len(got[0][e]) == len(got[1][e]) == 2
        for i, (vox, lab) in enumerate(want[e]):
            rows = torch.cat([got[0][e][i][0], got[1][e][i][0]])
            assert np.array_equal(np.concatenate([got[0][e][i][1], got[1][e][i][1]]), lab)
            assert torch.equal(rows, vox)


# ---------------------------------------------------------------------------
# 7. the trainer
# ---------------------------------------------------------------------------


def test_fit_writes_one_set_of_run_files(ddp):
    for r in ddp["ranks"]:
        files = r["fit"]["files"]
        assert len(files["train_result.csv"].splitlines()) == 3   # a header and 2 epochs
        assert len(files["metrics.jsonl"].splitlines()) == 2
        assert files["ckpt"] == ["0.pth", "1.pth"]


def test_fit_epoch_means_match_one_process(ddp):
    want = ddp["one"]["fit"]["history"]
    for r in ddp["ranks"]:
        got = r["fit"]["history"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_fit_resumes_to_the_same_state_on_both_ranks(ddp):
    fits = [r["fit"] for r in ddp["ranks"]]
    assert all(f["resumed"] == 1 for f in fits)
    assert fits[0]["digest_end"] == fits[1]["digest_end"]
    assert all(f["digest_resumed"] == f["digest_end"] for f in fits)


# ---------------------------------------------------------------------------
# 8. replicate_state
# ---------------------------------------------------------------------------


def test_replicate_state_raises_on_a_perturbed_rank(ddp):
    for r in ddp["ranks"]:
        assert r["perturbed"] is not None and "differs across ranks" in r["perturbed"]
    assert ddp["one"]["perturbed"] is None   # one process: nothing to compare
    state = _restored(ddp["cfg_t"], ddp["soft0"])
    assert state_digest(state) == state_digest(_restored(ddp["cfg_t"], ddp["soft0"]))


# ---------------------------------------------------------------------------
# 9. the train CLI's arguments with several cards
# ---------------------------------------------------------------------------


@pytest.fixture()
def four_cards(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    return monkeypatch


@pytest.mark.parametrize("argv,world", [
    ([], 4), (["--batch", "12"], 4), (["--no-data-parallel", "--batch", "7"], 1),
    (["--device", "cuda:0", "--batch", "7"], 1), (["--device", "cpu", "--batch", "7"], 1)])
def test_train_cli_takes_every_card(four_cards, argv, world):
    assert cli_train.parse_args(["--preset", "z1200"] + argv).world_size == world


@pytest.mark.parametrize("argv,env,msg", [
    (["--batch", "6"], {}, "global batch"),
    (["--batch", "3"], {"WORLD_SIZE": "2", "RANK": "0"}, "global batch"),
    (["--no-data-parallel"], {"WORLD_SIZE": "2", "RANK": "0"}, "under a launcher")])
def test_train_cli_refuses_what_does_not_divide(four_cards, capsys, argv, env, msg):
    for k, v in env.items():
        four_cards.setenv(k, v)
    with pytest.raises(SystemExit) as ei:
        cli_train.parse_args(["--preset", "z1200"] + argv)
    assert ei.value.code == 2 and msg in capsys.readouterr().err


def test_train_cli_under_a_launcher_takes_its_world(four_cards):
    four_cards.setenv("WORLD_SIZE", "8")
    four_cards.setenv("RANK", "3")
    assert cli_train.parse_args(["--preset", "z1200", "--batch", "16"]).world_size == 8
