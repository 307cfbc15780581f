"""One rank of the 2-rank data-parallel tests (tests/test_torch_ddp.py), or
the one process they are held against.

With a launcher's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`) it joins a gloo process group on the CPU
through `sivae_torch.parallel.init_distributed` and runs every case on its
rows of the global batch; without one it runs the same cases on the whole
global batch. It writes what it got to `<out_dir>/rank<r>.pth`. It imports
torch and sivae_torch only, as tests/multihost_worker.py does JAX; the test
process prepares the inputs (`<in_dir>/inputs.npz`, the initial states as
checkpoint payloads) and compares.

Usage: python tests/torch_ddp_worker.py <in_dir> <out_dir>
       python tests/torch_ddp_worker.py --card <out_dir>

`--card` (tests/test_torch_cuda.py) runs `card_step` alone, as one of two
gloo ranks that share one CUDA card (`LOCAL_RANK` 0 for both: NCCL does
not take two ranks on one device).
"""

import dataclasses
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

BATCH = 4          # the global batch of every case
SHAPE = (16, 16, 16)


def _cfg(body_act="leaky_relu", dtype=torch.float32, dropout=False, remat=False):
    """tiny_spatial without dropout (unless asked); float64 computes and
    holds the parameters in float64 (the one-process comparisons, which then
    see no fp32 reduction-order noise); `remat` rematerialises every block,
    keeping its boundaries only (policy None)."""
    from sivae_torch.models.registry import get_model_config

    cfg = get_model_config("tiny_spatial")
    act = cfg.act if dropout else cfg.act.with_no_dropout()
    return dataclasses.replace(cfg, act=dataclasses.replace(act, body_act=body_act),
                               dtype=dtype, param_dtype=dtype, remat=remat, remat_policy=None)


def _state(cfg, payload_path, joint=False):
    from sivae_torch.models.registry import make_model
    from sivae_torch.train.state import create_train_state
    from sivae_torch.utils.checkpoint import load_payload

    model = make_model(cfg, device="cpu")
    state = create_train_state(model, seed=0, joint_optimizer=joint)
    return load_payload(state, torch.load(payload_path, weights_only=True))


def _result(state, metrics):
    from sivae_torch.parallel.mesh import state_digest
    from sivae_torch.utils.checkpoint import state_payload

    return {"metrics": {k: v.detach().float().item() for k, v in metrics.items()},
            "payload": state_payload(state), "digest": state_digest(state).hex()}


def bn_cases(inp, rows):
    """Train-mode BN (+ LeakyReLU or none) on this rank's rows, fp32 and bf16,
    and the gradient of sum(y * g) over the global batch."""
    from sivae_torch.models.blocks import _BatchNormTrain

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for slope in (None, 0.2):
            x = torch.from_numpy(inp["bn_x"][rows]).to(dt).requires_grad_(True)
            g = torch.from_numpy(inp["bn_g"][rows])
            c = x.shape[1]
            w = torch.linspace(0.5, 1.5, c).requires_grad_(True)
            b = torch.linspace(-0.2, 0.3, c).requires_grad_(True)
            y, mean, var = _BatchNormTrain.apply(x, w, b, 1e-5, slope, dt)
            (y.float() * g).sum().backward()
            out[(str(dt), slope)] = {"y": y.detach().float(), "mean": mean, "var": var,
                                     "dx": x.grad.float(), "dw": w.grad, "db": b.grad}
    return out


def main(in_dir, out_dir):
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.parallel import init_distributed, local_batch_slice, rank
    from sivae_torch.parallel.mesh import collectives, replicate_state, reset_collectives

    dev = init_distributed()
    assert dev in (None, torch.device("cpu")), dev
    rk = rank()
    rows = local_batch_slice(BATCH)
    inp = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    res = {"rows": (rows.start, rows.stop), "bn": bn_cases(inp, rows)}

    import sivae_torch.train.step as port_step

    real = torch.from_numpy(inp["real"][rows])
    dp = dict(loss_multiplier=1.0, exp_elbo_weight=0.25, dp_semantics=True)
    # fp32 with zero eps (held against JAX), then float64 with the eps drawn
    # (held against one process); in one process also "soft" in float64, the
    # yardstick of the moment both fp32 stacks miss (LATENT_CONV_KERNEL)
    cases = (("soft", {}, True, torch.float32), ("dp", dp, True, torch.float32),
             ("port_soft", {}, False, torch.float64), ("port_dp", dp, False, torch.float64))
    if dev is None:
        cases += (("soft64", {}, True, torch.float64),)
    for name, kw, zero, dt in cases:
        cfg = _cfg(dtype=dt)
        state = replicate_state(_state(cfg, os.path.join(in_dir, "soft.pth")))
        step = port_step.make_soft_intro_train_step(
            state.model, SoftIntroLossConfig(**kw), OptimConfig(), 1, cfg.input_shape,
            zero_noise=zero, fixed_noise=inp["fixed"])
        reset_collectives()
        _, metrics = step(state, real.to(dt))
        res[name] = {**_result(state, metrics), "collectives": dict(collectives)}

    # rematerialisation (policy None), float64 with the eps drawn: without
    # dropout (held against one process without remat), and with dropout,
    # with and without remat (held against each other on each rank: the
    # masks come from the rank generator)
    for name, drop, remat in (("port_remat", False, True), ("port_drop", True, False),
                              ("port_remat_drop", True, True)):
        cfg = _cfg(dtype=torch.float64, dropout=drop, remat=remat)
        state = replicate_state(_state(cfg, os.path.join(in_dir, "soft.pth")))
        step = port_step.make_soft_intro_train_step(
            state.model, SoftIntroLossConfig(), OptimConfig(), 1, cfg.input_shape,
            fixed_noise=inp["fixed"])
        reset_collectives()
        _, metrics = step(state, real.to(torch.float64))
        res[name] = {**_result(state, metrics), "collectives": dict(collectives)}

    # the VAE step: fp32 with the tests' fixed eps batch for the global batch
    # (held against JAX), then float64 with the eps drawn
    eps = torch.from_numpy(inp["vae_eps"])

    def fixed_reparam(mu, logvar, val_eps, gen, latent_shape):
        return mu.float() + eps[local_batch_slice(BATCH)] * torch.exp(0.5 * logvar.float())

    for name, dt in (("vae", torch.float32), ("port_vae", torch.float64)):
        vcfg = _cfg(body_act="relu", dtype=dt)
        state = replicate_state(_state(vcfg, os.path.join(in_dir, "vae.pth"), joint=True))
        step = port_step.make_vae_train_step(state.model, OptimConfig(), 1, mse_w=1.0, kl_w=2.0)
        reset_collectives()
        drawn = port_step._reparam
        if name == "vae":
            port_step._reparam = fixed_reparam
        try:
            _, metrics = step(state, real.to(dt))
        finally:
            port_step._reparam = drawn
        res[name] = {**_result(state, metrics), "collectives": dict(collectives)}

    res["pipe"] = pipeline_case()
    res["fit"] = fit_case(os.path.join(out_dir, "fit"))

    # a perturbed parameter on rank 1 fails the check on every rank
    state = _state(cfg, os.path.join(in_dir, "soft.pth"))
    if rk == 1:
        with torch.no_grad():
            next(state.model.parameters()).view(-1)[0] += 1e-3
    try:
        replicate_state(state)
        res["perturbed"] = None
    except ValueError as e:
        res["perturbed"] = str(e)
    torch.save(res, os.path.join(out_dir, f"rank{rk}.pth"))


def pipeline_case():
    """This rank's batches of two epochs, augmentation off and on (a random
    affine with p = 1 and additive noise)."""
    from sivae_torch.cli.train import make_augment_fn
    from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
    from sivae_torch.data.synthetic import SyntheticBrainSource

    src = BrainDataSource(SyntheticBrainSource(9, SHAPE, seed=21).records)
    affine, noise = make_augment_fn(("affine", 15.0, 1.0)), make_augment_fn(("noise", 0.03, 1.0))
    out = {}
    for name, aug in (("plain", None), ("aug", lambda g, v: noise(g, affine(g, v)))):
        pipe = DataPipeline(src, BATCH, device="cpu", seed=5, augment=aug)
        out[name] = [[(v, lab) for v, lab in pipe.epoch(e)] for e in (0, 1)]
    return out


def fit_case(run_dir):
    """Two epochs of SoftIntroTrainer.fit (2 steps each, one validation
    batch, float64) into one run directory shared by the ranks, then a new
    trainer that resumes from it."""
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig, TrainConfig
    from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
    from sivae_torch.data.synthetic import SyntheticBrainSource
    from sivae_torch.models.registry import make_model
    from sivae_torch.parallel.mesh import state_digest
    from sivae_torch.train.loop import SoftIntroTrainer

    sys.modules["matplotlib"] = None   # no figures: the run files are the logs
    src = BrainDataSource(SyntheticBrainSource(12, SHAPE, seed=31).records)
    train_src, val_src = src.subset(np.arange(8)), src.subset(np.arange(8, 12))
    # float64: in fp32 the gradient of a conv bias in front of a BN is
    # rounding noise of either sign, which Adam turns into steps of +-lr,
    # and eval-mode BN does not cancel them; in float64 that noise is far
    # below Adam's eps
    cfg = _cfg(dtype=torch.float64)
    tc = TrainConfig(epochs=2, batch_size=BATCH, seed=3)

    def trainer():
        return SoftIntroTrainer(make_model(cfg, device="cpu", seed=4), SoftIntroLossConfig(),
                                OptimConfig(), tc, run_dir=run_dir, steps_per_epoch=2)

    t = trainer()
    hist = t.fit(DataPipeline(train_src, BATCH, device="cpu", seed=5),
                 DataPipeline(val_src, BATCH, device="cpu", shuffle=False), verbose=False)
    # as every rank sees them once the fit returned (a new trainer writes a
    # new CSV header, as a resumed run does)
    files = {}
    for name in ("train_result.csv", "metrics.jsonl"):
        with open(os.path.join(run_dir, name)) as f:
            files[name] = f.read()
    files["ckpt"] = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
    again = trainer()
    resumed = again.try_resume()
    return {"history": hist, "files": files, "digest_end": state_digest(t.state).hex(),
            "digest_resumed": state_digest(again.state).hex(), "resumed": resumed}


def card_step(dev):
    """One fp32 tiny_spatial step (seeded weights, the fixed noise batch of
    seed 11, eps drawn) on this rank's rows of a global batch of 4, through
    the kernels on a card: (metrics, payload on the CPU, digest)."""
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.models.registry import make_model
    from sivae_torch.parallel import local_batch_slice
    from sivae_torch.train.state import create_train_state
    from sivae_torch.train.step import make_soft_intro_train_step

    cfg = _cfg()
    rng = np.random.RandomState(11)
    real = rng.rand(BATCH, 1, *SHAPE).astype(np.float32)
    fixed = rng.randn(BATCH, cfg.latent_dim).astype(np.float32)
    model = make_model(cfg, device=dev, seed=0)
    state = create_train_state(model, seed=0)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape, fixed_noise=fixed)
    _, metrics = step(state, torch.from_numpy(real[local_batch_slice(BATCH)]).to(dev))
    res = _result(state, metrics)
    res["payload"] = torch.utils._pytree.tree_map(
        lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, res["payload"])
    return res


def card_main(out_dir):
    from sivae_torch.parallel import init_distributed, rank

    dev = init_distributed(backend="gloo")
    assert dev.type == "cuda", dev
    torch.save(card_step(dev), os.path.join(out_dir, f"rank{rank()}.pth"))


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
