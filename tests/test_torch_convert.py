"""tools/torch_from_orbax.py: the JAX package's orbax checkpoints into the
port's checkpoints, held against the JAX state they came from.

One `tiny_spatial` JAX train state built under `jax.jit` (the bits need not
match any other test's), its BN statistics and logvar head perturbed and its
Adam moments and counts filled with seeded random values, so that every
carried tensor is distinct; a second state with one joint Adam over both
halves (the VAE / vae2soft-stage kind). Each is saved once per module by the
JAX package's `CheckpointManager`. After the conversion the port state's
parameters, BN statistics, Adam moments and counts and step equal JAX's
exactly; the eval CLI's `--ckpt` on the converted directory encodes within
1e-5 of JAX's `encode_dataset` on the restored orbax state; the train CLI's
`--pretrained` takes the directory and refuses an orbax one, naming the
converter.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivae_tpu.config import OptimConfig as JaxOptimConfig
from sivae_tpu.eval.latent_probe import encode_dataset as jax_encode_dataset
from sivae_tpu.models.registry import get_model_config as jax_get_model_config
from sivae_tpu.models.registry import make_model as jax_make_model
from sivae_tpu.train.state import create_train_state as jax_create_train_state
from sivae_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from sivae_torch.cli import eval as cli_eval
from sivae_torch.cli import train as cli_train
from sivae_torch.eval import latent_probe
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.train.state import create_train_state
from sivae_torch.utils.checkpoint import CheckpointManager, seeded_generator_state
from sivae_torch.utils.jax_import import (export_train_state, jax_to_state_dict,
                                          load_reference_pth)
from torch_port_common import flat_random_draws, flat_state, jax_state_trees, load_tool, perturb

torch.set_num_threads(2)

STEP = {"two_adams": 7, "joint": 4}


def _fill_adam(adam_and_schedule, params, rng, count):
    """optax's adam state over `params` with random moments (nu >= 0) and
    `count` updates."""
    adam, schedule = adam_and_schedule
    draw = lambda scale: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(scale(rng.randn(*a.shape)), jnp.float32), params)
    return (adam._replace(count=jnp.int32(count), mu=draw(lambda a: 1e-2 * a),
                          nu=draw(lambda a: 1e-4 * np.abs(a))),
            schedule._replace(count=jnp.int32(count)))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{kind: (orbax directory, JAX state)} for both kinds of state."""
    cfg = jax_get_model_config("tiny_spatial")
    model = jax_make_model(cfg)
    x0 = jnp.zeros((1,) + cfg.input_shape + (1,), jnp.float32)
    with flat_random_draws():
        st = jax.jit(lambda k: jax_create_train_state(model, k, x0, JaxOptimConfig(), 1))(
            jax.random.key(0))
    var = perturb({"enc": {"params": st.enc_params, "batch_stats": st.enc_stats},
                   "dec": {"params": st.dec_params, "batch_stats": st.dec_stats}}, seed=11)
    var = jax.tree_util.tree_map(jnp.asarray, var)
    st = st.replace(enc_params=var["enc"]["params"], enc_stats=var["enc"]["batch_stats"],
                    dec_params=var["dec"]["params"], dec_stats=var["dec"]["batch_stats"])
    rng = np.random.RandomState(12)
    states = {
        "two_adams": st.replace(opt_e=_fill_adam(st.opt_e, st.enc_params, rng, 7),
                                opt_d=_fill_adam(st.opt_d, st.dec_params, rng, 7),
                                step=jnp.int32(7)),
        "joint": st.replace(opt_e=_fill_adam(st.opt_e, (st.enc_params, st.dec_params), rng, 4),
                            opt_d=(), step=jnp.int32(4)),
    }
    out = {}
    for kind, state in states.items():
        d = str(tmp_path_factory.mktemp(kind) / "ckpt")
        mgr = JaxCheckpointManager(d)
        mgr.save(STEP[kind], state, wait=True)
        mgr.close()
        out[kind] = (d, state)
    return out


@pytest.mark.parametrize("kind", ["two_adams", "joint"])
def test_converter_carries_the_state_exactly(saved, tmp_path, kind):
    ckpt_dir, st = saved[kind]
    out = str(tmp_path / "port")
    assert load_tool("torch_from_orbax").main(
        [ckpt_dir, out, "--model", "tiny_spatial", "--seed", "5", "--generator-device", "cpu"]
        + (["--step", str(STEP[kind])] if kind == "joint" else [])) == 0
    assert CheckpointManager(out).all_steps() == [STEP[kind]]
    trees = jax_state_trees(st)
    assert ("opt_d" in trees) == (kind == "two_adams")
    state = CheckpointManager(out).restore(create_train_state(
        make_model(get_model_config("tiny_spatial"), device="cpu"), seed=0,
        joint_optimizer=kind == "joint"))
    got, want = export_train_state(state, trees), flat_state(trees)
    assert set(got) == set(want) and len(want) > 40
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    assert state.step == STEP[kind]
    assert torch.equal(state.generator.get_state(), torch.Generator().manual_seed(5).get_state())


def test_eval_cli_reads_the_converted_checkpoint(saved, tmp_path, monkeypatch):
    """The eval CLI over the converter's output (default: a CUDA generator's
    state, which the CLI does not read) encodes as JAX's `encode_dataset`
    does on the state the JAX package's manager restores."""
    ckpt_dir, st = saved["two_adams"]
    out = str(tmp_path / "port")
    assert load_tool("torch_from_orbax").convert(ckpt_dir, out, "tiny_spatial") == [7]
    payload = torch.load(os.path.join(out, "7.pth"), weights_only=True)
    assert payload["generator_device"] == "cuda"
    assert torch.equal(payload["generator"], seeded_generator_state("cuda", 0))

    seen = []
    encode = latent_probe.encode_dataset

    def spy(model, voxels, **kw):
        seen.append((torch.as_tensor(voxels).numpy().copy(), encode(model, voxels, **kw)))
        return seen[-1][1]

    monkeypatch.setattr(latent_probe, "encode_dataset", spy)
    report = cli_eval.main(["--model", "tiny_spatial", "--ckpt", out, "--synthetic", "12",
                            "--device", "cpu"])
    assert np.isfinite(report["rmse"])
    (vox, z), = seen
    cfg = jax_get_model_config("tiny_spatial")
    restored = JaxCheckpointManager(ckpt_dir).restore(st)
    variables = {"enc": {"params": restored.enc_params, "batch_stats": restored.enc_stats},
                 "dec": {"params": restored.dec_params, "batch_stats": restored.dec_stats}}
    want = jax_encode_dataset(jax_make_model(cfg), variables, vox.transpose(0, 2, 3, 4, 1),
                              batch_size=16)
    assert z.shape == want.shape == (12, 64)
    np.testing.assert_allclose(z, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_train_cli_takes_the_converted_directory(saved, tmp_path, capsys):
    """`--pretrained` takes the converter's directory (its latest step) and
    loads JAX's weights and statistics; an orbax directory exits 2 naming
    the converter."""
    ckpt_dir, st = saved["two_adams"]
    out = str(tmp_path / "port")
    load_tool("torch_from_orbax").convert(ckpt_dir, out, "tiny_spatial")
    args = cli_train.parse_args(["--preset", "z1200", "--model", "tiny_spatial",
                                 "--pretrained", out, "--device", "cpu"])
    assert args.pretrained == os.path.join(out, "7.pth")
    model = load_reference_pth(make_model(get_model_config("tiny_spatial"), device="cpu", seed=3),
                               args.pretrained)
    want = jax_to_state_dict({"enc": {"params": st.enc_params, "batch_stats": st.enc_stats},
                              "dec": {"params": st.dec_params, "batch_stats": st.dec_stats}},
                             model)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    with pytest.raises(SystemExit) as ei:
        cli_train.parse_args(["--preset", "z1200", "--pretrained", ckpt_dir, "--device", "cpu"])
    assert ei.value.code == 2 and "tools/torch_from_orbax.py" in capsys.readouterr().err
