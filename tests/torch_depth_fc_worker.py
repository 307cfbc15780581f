"""One rank of the FC-family and plain-step depth-sharding tests
(tests/test_torch_depth_fc.py), or the one process they are held against.

With a launcher's environment it joins a gloo process group on the CPU and
runs the cases of its world: 4 ranks a 2 x 2 `data x spatial` grid, 2 ranks
a 1 x 2 one; without a launcher it runs every case in one process. Each
case writes what it got to `<out_dir>/rank<r>.pth`. It imports torch and
sivae_torch only; the test process prepares the inputs (`<in_dir>/inputs.npz`
and the initial states as checkpoint payloads) and compares.

Usage: python tests/torch_depth_fc_worker.py <in_dir> <out_dir>
"""

import dataclasses
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_ddp_worker import _cfg, _result  # noqa: E402

torch.set_num_threads(1)

BATCH = 4                  # the global batch of every case
FC_SHAPE = (32, 16, 16)    # tiny_fc with a (2, 1, 1) bottleneck: 16/16 on 1 x 2
FC_UNEQUAL = (48, 16, 16)  # a (3, 1, 1) bottleneck: slabs 32/16 on 1 x 2
LUCKY_SHAPE = (16, 24, 16)  # the lucky AE's bottleneck (2, 3, 2): 8/8 on 1 x 2
CLASSES = 3


def _collectives():
    from sivae_torch.parallel.mesh import collectives

    return {k: list(v) for k, v in collectives.items()}


def fc_cfg(dtype=torch.float32, shape=FC_SHAPE):
    from sivae_torch.models.registry import get_model_config

    return dataclasses.replace(get_model_config("tiny_fc"), input_shape=shape, dtype=dtype,
                               param_dtype=dtype)


def classifier(cfg):
    from sivae_torch.models.classifier import ResNetClassifier

    return ResNetClassifier(cfg, num_classes=CLASSES, generator=torch.Generator().manual_seed(0))


def _restore(model, payload_path, joint=False):
    from sivae_torch.parallel.mesh import replicate_state
    from sivae_torch.train.state import create_train_state
    from sivae_torch.utils.checkpoint import load_payload

    state = create_train_state(model.eval(), seed=0, joint_optimizer=joint)
    if payload_path is not None:
        load_payload(state, torch.load(payload_path, weights_only=True))
    return replicate_state(state)


def _model(cfg):
    from sivae_torch.models.registry import make_model

    return make_model(cfg, device="cpu", seed=0)


def _part(x, mesh, levels):
    from sivae_torch.parallel.mesh import shard_batch

    x = torch.as_tensor(x)
    return x if mesh is None else shard_batch(x, mesh, spatial_axis="spatial", levels=levels)


def _levels(cfg):
    from sivae_torch.models.resnet_vae import depth_levels

    return depth_levels(cfg)


def run_step(mesh, state, step, real, levels, *extra):
    """One train step on this rank's rows and slab: state, metrics and
    collectives."""
    from sivae_torch.parallel.mesh import reset_collectives

    reset_collectives()
    _, metrics = step(state, _part(real, mesh, levels), *extra)
    return {**_result(state, metrics), "collectives": _collectives()}


def soft_case(mesh, cfg, payload, real, zero=False, fixed=None, remat_calls=False):
    from sivae_torch.config import OptimConfig, SoftIntroLossConfig
    from sivae_torch.train.step import make_soft_intro_train_step

    state = _restore(_model(cfg), payload)
    step = make_soft_intro_train_step(state.model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape, remat_calls=remat_calls, zero_noise=zero,
                                      fixed_noise=fixed)
    return run_step(mesh, state, step, real.astype(_np(cfg.dtype)), _levels(cfg))


def _np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def eval_case(mesh, cfg, real):
    """The Soft-IntroVAE validation step from the seeded model, its random
    draws from a generator of seed 5 on every rank."""
    from sivae_torch.config import SoftIntroLossConfig
    from sivae_torch.parallel.mesh import reset_collectives
    from sivae_torch.train.step import make_soft_intro_eval_step

    state = _restore(_model(cfg), None)
    step = make_soft_intro_eval_step(state.model, SoftIntroLossConfig(), cfg.input_shape)
    reset_collectives()
    m = step(state, _part(real.astype(_np(cfg.dtype)), mesh, _levels(cfg)),
             torch.Generator().manual_seed(5))
    return {"metrics": {k: v.item() for k, v in m.items()}, "collectives": _collectives()}


def vae_case(mesh, cfg, payload, real, eps=None):
    """One VAE step (mse 1, kl 2), its eps drawn, or `eps` (the global
    batch's) with each rank keeping its rows and depth slab."""
    import sivae_torch.train.step as port_step
    from sivae_torch.config import OptimConfig
    from sivae_torch.parallel import local_batch_slice
    from sivae_torch.parallel.mesh import volume_slab

    state = _restore(_model(cfg), payload, joint=True)
    step = port_step.make_vae_train_step(state.model, OptimConfig(), 1, mse_w=1.0, kl_w=2.0)
    drawn = port_step._reparam
    if eps is not None:
        mine = torch.from_numpy(eps)[local_batch_slice(BATCH)]
        mine = mine[:, :, volume_slab(eps.shape[2])]

        def fixed(mu, logvar, val_eps, gen, latent_shape):
            return mu.float() + mine * torch.exp(0.5 * logvar.float())

        port_step._reparam = fixed
    try:
        return run_step(mesh, state, step, real.astype(_np(cfg.dtype)), _levels(cfg))
    finally:
        port_step._reparam = drawn


def cae_case(mesh, cfg, real):
    from sivae_torch.config import OptimConfig
    from sivae_torch.train.step import make_cae_train_step

    state = _restore(_model(cfg), None, joint=True)
    step = make_cae_train_step(state.model, OptimConfig(), 1)
    return run_step(mesh, state, step, real.astype(_np(cfg.dtype)), _levels(cfg))


def classifier_case(mesh, cfg, payload, x, labels):
    from sivae_torch.config import OptimConfig
    from sivae_torch.parallel import local_batch_slice
    from sivae_torch.train.step import make_classifier_eval_step, make_classifier_train_step

    state = _restore(classifier(cfg), payload, joint=True)
    x = _part(x.astype(_np(cfg.dtype)), mesh, _levels(cfg))
    lab = labels[local_batch_slice(BATCH)]
    m, pred = make_classifier_eval_step(state.model)(state, x, lab)
    out = run_step(None, state, make_classifier_train_step(state.model, OptimConfig(), 1), x,
                   0, lab)
    out["eval"] = {"metrics": {k: v.item() for k, v in m.items()}, "pred": pred}
    return out


def encode_case(cfg, payload, vox):
    """encode_dataset of 3 volumes at batch 2 (a padded tail), eval mode:
    whole latents on every rank."""
    from sivae_torch.eval.latent_probe import encode_dataset
    from sivae_torch.parallel.mesh import reset_collectives

    state = _restore(_model(cfg), payload)
    reset_collectives()
    mu = encode_dataset(state.model, vox, batch_size=2)
    zv = encode_dataset(state.model, vox, batch_size=2, representation="z_val")
    return {"mu": mu, "z_val": zv, "collectives": _collectives()}


def lucky_case(mesh, payload, x, dtype):
    """The lucky AE's train-mode forward on this rank's rows and slab: the
    code (whole), the output (gathered whole) and every running statistic."""
    from sivae_torch.models.lucky_ae import LuckyDecoder, LuckyEncoder
    from sivae_torch.parallel.mesh import gather_depth, reset_collectives

    enc = LuckyEncoder(LUCKY_SHAPE, dtype=dtype)
    dec = LuckyDecoder(tuple(s // 8 for s in LUCKY_SHAPE), dtype=dtype)
    sd = torch.load(payload, weights_only=True)
    enc.load_state_dict(sd["enc"])
    dec.load_state_dict(sd["dec"])
    enc.train()
    dec.train()
    reset_collectives()
    with torch.no_grad():
        z = enc(_part(x.astype(_np(dtype)), mesh, enc.depth_levels))
        y = gather_depth(dec(z), LUCKY_SHAPE[0])
    return {"z": z, "y": y, "enc": enc.state_dict(), "dec": dec.state_dict(),
            "collectives": _collectives()}


def kl_case(inp):
    """The KL of a flat latent (whole on every rank) told that it is flat,
    and the same latent summed over the slabs as a spatial one's is."""
    from sivae_torch.ops.losses import calc_kl, calc_kl_per_position, normal_loss

    mu, lv = torch.from_numpy(inp["kl_mu"]), torch.from_numpy(inp["kl_lv"])
    x = torch.zeros(BATCH, 1, 2, 2, 2, dtype=torch.float64)
    return {"flat": calc_kl(lv, mu, "mean", flat=True).item(),
            "dp_flat": calc_kl_per_position(lv, mu, "mean", flat=True).item(),
            "vae_flat": normal_loss(x, mu, lv, x, flat=True)[2].item(),
            "summed": calc_kl(lv, mu, "mean").item()}


def refuse_case(mesh):
    """tiny_fc at its 16^3: a 1-plane bottleneck cannot be cut for 2
    spatial ranks."""
    cfg = fc_cfg(shape=(16, 16, 16))
    try:
        _part(np.zeros((BATCH, 1, 16, 16, 16), np.float32), mesh, _levels(cfg))
    except ValueError as e:
        return str(e)
    return None


def run_cases(in_dir, world):
    from sivae_torch.parallel.mesh import make_mesh

    inp = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    pay = {k: os.path.join(in_dir, f"{k}.pth") for k in ("fc", "clf", "vae", "lucky")}
    f64 = torch.float64
    res = {}

    def grid(shape):
        return make_mesh(shape, ("data", "spatial")) if world > 1 else None

    if world in (1, 4):
        mesh = grid((2, 2))
        res["fc_soft"] = soft_case(mesh, fc_cfg(), pay["fc"], inp["fc_real"], zero=True,
                                   fixed=inp["fc_fixed"])
        res["clf"] = classifier_case(mesh, _cfg(), pay["clf"], inp["real"], inp["labels"])
        res["lucky22"] = lucky_case(mesh, pay["lucky"], inp["lucky_x"], f64)
        if world == 1:   # the yardstick of the fp32 FC moments (test_fc_grid_step_first_moments)
            res["fc_soft64"] = soft_case(None, fc_cfg(f64), pay["fc"], inp["fc_real"], zero=True,
                                         fixed=inp["fc_fixed"])
    if world in (1, 2):
        mesh = grid((1, 2))
        uneq = fc_cfg(f64, FC_UNEQUAL)
        res["fc64"] = soft_case(mesh, uneq, None, inp["fc_real48"])
        if world == 2:
            res["fc_remat"] = soft_case(mesh, uneq, None, inp["fc_real48"], remat_calls=True)
            res["refuse"] = refuse_case(mesh)
        res["vae64"] = vae_case(mesh, _cfg(body_act="relu", dtype=f64), pay["vae"], inp["real"])
        res["vae"] = vae_case(mesh, _cfg(body_act="relu"), pay["vae"], inp["real"],
                              eps=inp["vae_eps"])
        res["cae64"] = cae_case(mesh, dataclasses.replace(_cfg(dtype=f64), variational=False),
                                inp["real"])
        res["eval64"] = eval_case(mesh, _cfg(dtype=f64), inp["real"])
        res["fc_eval64"] = eval_case(mesh, uneq, inp["fc_real48"])
        res["encode"] = encode_case(fc_cfg(), pay["fc"], inp["fc_vox"])
        res["lucky"] = lucky_case(mesh, pay["lucky"], inp["lucky_x"], torch.float32)
        res["kl"] = kl_case(inp)
    return res


def main(in_dir, out_dir):
    from sivae_torch.parallel import init_distributed, rank, world_size

    dev = init_distributed()
    assert dev in (None, torch.device("cpu")), dev
    res = run_cases(in_dir, world_size())
    torch.save(res, os.path.join(out_dir, f"rank{rank()}.pth"))


if __name__ == "__main__":
    try:
        main(sys.argv[1], sys.argv[2])
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)   # a peer may be blocked in a collective: do not wait for it
    from sivae_torch.parallel import shutdown

    shutdown()
