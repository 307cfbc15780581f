"""sivae_torch trainer, checkpoints, logs, health gate and train CLI, against
the JAX package where it has the same function: the logger's files byte
for byte, `run_health` / `select_best_checkpoint` as dicts, the presets as
a table, and the train + eval CLIs end to end over a fake pickle tree.
The trainer's own properties (bit-exact checkpoints, resume, the NaN
guard, skipped plots) are held in the port alone. Everything runs on the
CPU at `tiny_spatial` (16^3) in fp32 without dropout, except the CLI runs
(the z1200 preset's model with its dropout)."""

import dataclasses
import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from cli.train import PRESETS as JAX_PRESETS
from sivae_tpu.config import TrainConfig as JaxTrainConfig
from sivae_tpu.eval.sweep import run_health as jax_run_health
from sivae_tpu.eval.sweep import select_best_checkpoint as jax_select_best_checkpoint
from sivae_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from sivae_torch.cli import eval as cli_eval
from sivae_torch.cli import train as cli_train
from sivae_torch.config import OptimConfig, SoftIntroLossConfig, TrainConfig
from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
from sivae_torch.data.synthetic import SyntheticBrainSource
from sivae_torch.eval.sweep import run_health, select_best_checkpoint
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.train import loop
from sivae_torch.train.loop import SoftIntroTrainer
from sivae_torch.train.state import create_train_state
from sivae_torch.train.step import make_soft_intro_train_step
from sivae_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)


def _tiny_cfg():
    cfg = get_model_config("tiny_spatial")
    return dataclasses.replace(cfg, act=cfg.act.with_no_dropout())


def _pipelines(n_train, n_val=4, batch=4):
    """Train (not shuffled, so every epoch sees the same batches) and val
    pipelines over synthetic 16^3 volumes."""
    src = BrainDataSource(SyntheticBrainSource(n_train + n_val, (16, 16, 16), seed=4).records)
    idx = np.arange(n_train + n_val)
    train = DataPipeline(src.subset(idx[:n_train]), batch, device="cpu", shuffle=False)
    val = DataPipeline(src.subset(idx[n_train:]), batch, device="cpu", shuffle=False)
    return train, val


def _trainer(run_dir, steps_per_epoch, **train_kw):
    model = make_model(_tiny_cfg(), device="cpu", seed=1)
    return SoftIntroTrainer(model, train_cfg=TrainConfig(log_images_every_epochs=0, **train_kw),
                            run_dir=str(run_dir), steps_per_epoch=steps_per_epoch)


def _state_tensors(state):
    """Every tensor of a train state, by name, on the CPU."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for name in ("opt_e", "opt_d"):
        for i, st in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}/{i}/{k}": torch.as_tensor(v) for k, v in st.items()})
    out["generator"] = state.generator.get_state()
    out["step"] = torch.tensor(state.step)
    return {k: v.detach().cpu() for k, v in out.items()}


def _assert_states_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert set(ta) == set(tb) and len(ta) > 20
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


# ---------------------------------------------------------------------------
# config and logger against JAX
# ---------------------------------------------------------------------------


def test_train_config_defaults_match_jax():
    port = {f.name for f in dataclasses.fields(TrainConfig)}
    jax_fields = {f.name for f in dataclasses.fields(JaxTrainConfig)}
    assert jax_fields - port == {"mesh_shape", "mesh_axis_names"} and port <= jax_fields
    for name in port:
        assert getattr(TrainConfig(), name) == getattr(JaxTrainConfig(), name), name


def test_logger_files_match_jax_byte_for_byte(tmp_path):
    """The same history through both loggers: every file equal, the JSONL
    records equal apart from their wall-clock `time`, and the same epoch
    line."""
    rng = np.random.RandomState(0)
    dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    loggers = {"port": loop.MetricsLogger(str(dirs["port"])),
               "jax": JaxMetricsLogger(str(dirs["jax"]))}
    keys = ("train_lossE", "train_lossD", "val_lossE", "val_lossD", "kls_real", "kls_fake",
            "kls_rec", "rec_errs", "train_mse", "train_kl")
    for epoch in range(3):
        m = {k: float(rng.randn() * 10 ** rng.randint(-3, 4)) for k in keys}
        if epoch == 1:
            m["val_lossE"] = m["val_lossD"] = float("nan")
        row = {k: m[k] for k in keys[:6]}
        for lg in loggers.values():
            lg.append(**m)
            lg.write_epoch(epoch, row)
            lg.write_loss_txt()
            lg.write_kl_txt()
            lg.write_mse_kl_txt("train_losses.txt", "train_mse", "train_kl")
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"])) and len(names) == 5
    for name in names:
        got, want = (dirs[w].joinpath(name).read_bytes() for w in ("port", "jax"))
        if name == "metrics.jsonl":
            got, want = ([{k: v for k, v in json.loads(line).items() if k != "time"}
                          for line in text.splitlines()] for text in (got, want))
            assert len(got) == 3 and json.dumps(got) == json.dumps(want)
        else:
            assert got == want, name
    args = (2, 10, {"lossE": 1.5, "rmse": 0.1, "rec_kl": 3.0}, {"lossE": 2.0})
    assert loggers["port"].epoch_line(*args, 12.0) == loggers["jax"].epoch_line(*args, 12.0)


SWEEPS = {
    "healthy": [0.36, 0.2, 0.1, 0.12, 0.125],
    "collapse": [0.36, 0.1, 0.3],
    "no_convergence": [0.1, 0.2, 0.3],
    "single": [0.2],
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_health_and_best_checkpoint_match_jax(case):
    rows = [{"rmse": r, "psnr": 20.0 - r, "ssim3d": 0.15 + 0.1 * i, "ssim_center_slice": 0.3,
             "n": 4, "checkpoint": str(i)} for i, r in enumerate(SWEEPS[case])]
    assert run_health(rows) == jax_run_health(rows)
    assert run_health(rows, drift_frac=0.5, min_ssim3d=0.1) == \
        jax_run_health(rows, drift_frac=0.5, min_ssim3d=0.1)
    for metric, minimize in (("rmse", True), ("ssim3d", False)):
        assert select_best_checkpoint(rows, metric, minimize) == \
            jax_select_best_checkpoint(rows, metric, minimize)
    with pytest.raises(ValueError):
        select_best_checkpoint([])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    """Every tensor of the model, both Adams' moments and counts, the
    generator state and the step come back bit for bit into a state built
    from another seed; `max_to_keep` holds; a step not after the latest is
    skipped, as orbax's manager does."""
    cfg = _tiny_cfg()
    model = make_model(cfg, device="cpu", seed=1)
    state = create_train_state(model, seed=5)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 1,
                                      cfg.input_shape)
    real = torch.rand((2, 1) + cfg.input_shape, generator=torch.Generator().manual_seed(0))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    step(state, real)
    for epoch in range(3):
        assert mgr.save(epoch, state)
    assert mgr.all_steps() == [1, 2] and mgr.latest_step() == 2
    assert not mgr.save(2, state) and not mgr.save(0, state)
    assert not any(n.endswith(".tmp") for n in os.listdir(mgr.directory))

    other = create_train_state(make_model(cfg, device="cpu", seed=9), seed=6)
    CheckpointManager(mgr.directory).restore(other)
    _assert_states_equal(state, other)
    assert other.step == 1
    # the restored generator continues the saved one's stream
    assert torch.equal(torch.rand(4, generator=state.generator),
                       torch.rand(4, generator=other.generator))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(other)


def test_sweep_reads_port_checkpoints_and_reference_pth(tmp_path):
    """`sweep_checkpoints` walks a port checkpoint directory oldest first,
    then reference .pth files, each through `reconstruction_report`; a row
    equals the report of the model holding that checkpoint's weights."""
    from sivae_torch.eval.recon_quality import reconstruction_report
    from sivae_torch.eval.sweep import sweep_checkpoints

    cfg = _tiny_cfg()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for step, seed in ((0, 1), (1, 2)):
        mgr.save(step, create_train_state(make_model(cfg, device="cpu", seed=seed)))
    ref = make_model(cfg, device="cpu", seed=3)
    torch.save(ref.state_dict(), tmp_path / "epoch3.pth")
    vox = torch.rand((3, 1) + cfg.input_shape, generator=torch.Generator().manual_seed(0))
    rows = sweep_checkpoints(make_model(cfg, device="cpu"), vox, ckpt_dir=mgr.directory,
                             torch_paths=[str(tmp_path / "epoch3.pth")], batch_size=2)
    assert [r["checkpoint"] for r in rows] == ["0", "1", "epoch3.pth"]
    for row, seed in zip(rows, (1, 2, 3)):
        want = reconstruction_report(make_model(cfg, device="cpu", seed=seed), vox, batch_size=2)
        assert {k: row[k] for k in want} == want


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.fixture()
def no_figures(monkeypatch):
    """The trainer as where matplotlib does not import: no figures (they
    cost more than the tiny steps), one line saying so."""
    monkeypatch.setattr(loop, "matplotlib_missing", lambda: "No module named 'matplotlib'")


def test_resume_continues_bit_for_bit(tmp_path, no_figures):
    """fit for 2 epochs == fit for 1, then `try_resume` in a new trainer and
    fit for 1 more: the same final state bit for bit and the same train
    metrics. Epochs count from 0 again after a resume (the JAX package's
    behaviour), so the train pipeline is not shuffled here and the resumed
    run's checkpoint manager skips epoch 0, which the directory holds."""
    train, _ = _pipelines(n_train=2, batch=2)
    straight = _trainer(tmp_path / "a", steps_per_epoch=1)
    hist_a = straight.fit(train, epochs=2, verbose=False)
    assert CheckpointManager(str(tmp_path / "a" / "ckpt")).all_steps() == [0, 1]

    first = _trainer(tmp_path / "b", steps_per_epoch=1)
    first.fit(train, epochs=1, verbose=False)
    resumed = _trainer(tmp_path / "b", steps_per_epoch=1)
    assert resumed.try_resume() == 0 and resumed.state.step == 1
    hist_b = resumed.fit(train, epochs=1, verbose=False)
    _assert_states_equal(straight.state, resumed.state)
    for key in ("train_lossE", "train_lossD", "kls_real", "kls_fake", "kls_rec", "rec_errs",
                "train_rmse"):
        assert hist_b[key][0] == hist_a[key][1], key
    assert CheckpointManager(str(tmp_path / "b" / "ckpt")).all_steps() == [0]
    with open(tmp_path / "b" / "train_result.csv") as f:
        assert [line.split(",")[0] for line in f.read().splitlines()] == ["epoch", "0"]
    assert _trainer(tmp_path / "c", steps_per_epoch=1).try_resume() is None


def test_train_epoch_raises_on_nan_at_the_end_of_the_epoch(tmp_path):
    train, _ = _pipelines(n_train=8)
    calls = []

    def fake_step(state, vox):
        calls.append(vox.shape)
        value = torch.tensor(float("nan") if len(calls) == 1 else 1.0)
        return state, {"lossE": value, "lossD": value, "loss_rec": value,
                       "nan": torch.isnan(value)}

    trainer = types.SimpleNamespace(_step=fake_step, state=None, n_voxels=16 ** 3)
    with pytest.raises(FloatingPointError):
        SoftIntroTrainer.train_epoch(trainer, train, 0)
    assert len(calls) == train.steps_per_epoch == 2


def test_plots_skipped_with_one_line_without_matplotlib(tmp_path, no_figures, capsys):
    train, val = _pipelines(n_train=4)
    trainer = SoftIntroTrainer(make_model(_tiny_cfg(), device="cpu", seed=1),
                               run_dir=str(tmp_path), train_cfg=TrainConfig())
    trainer.fit(train, val, epochs=1, verbose=False)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and "matplotlib" in out[0] and "skipped" in out[0]
    assert not any(n.endswith((".png", ".jpg")) for n in os.listdir(tmp_path))
    assert not os.path.exists(tmp_path / "imgs")
    assert os.path.exists(tmp_path / "train_result.csv") and not trainer.model.training


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def test_presets_match_jax():
    assert cli_train.PRESETS == JAX_PRESETS


@pytest.mark.parametrize("argv,roadmap", [
    (["--preset", p, "--pretrained", f"runs/{p}/ckpt"], "A.6")
    for p in ("z600", "z600-wide", "vae", "cae", "vae2soft", "z1200")
])
def test_train_cli_refuses_what_the_port_cannot_run(argv, roadmap, capsys):
    with pytest.raises(SystemExit) as ei:
        cli_train.parse_args(argv + ["--device", "cpu"])
    assert ei.value.code == 2 and f"ROADMAP {roadmap}" in capsys.readouterr().err


def test_train_cli_refuses_data_parallel_over_several_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit) as ei:
        cli_train.parse_args(["--preset", "z1200"])
    assert ei.value.code == 2 and "ROADMAP A.9" in capsys.readouterr().err
    assert cli_train.parse_args(["--preset", "z1200", "--no-data-parallel"]).device == "cuda:0"


def test_both_clis_raise_without_cuda_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["--preset", "z1200", "--model", "tiny_spatial", "--synthetic", "40"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_eval.main(["--model", "tiny_spatial", "--synthetic", "4"])


@pytest.fixture()
def fake_adni_tree(tmp_path):
    """tests/test_cli_e2e.py's tree: 2 classes x 6 patients of 16^3
    volumes, the last AD uid (112) blacklisted."""
    root = tmp_path / "radiology_datas"
    base = root / "JHU-radiology" / "20170509"
    uid = 100
    rng = np.random.RandomState(0)
    for label in ("CN", "AD"):
        for p in range(6):
            uid += 1
            d = base / label / f"{label.lower()}{p:02d}"
            d.mkdir(parents=True, exist_ok=True)
            with open(d / f"scan_half_brain_S{uid}_1.pkl", "wb") as f:
                pickle.dump(rng.rand(16, 16, 16).astype(np.float32), f)
    bl = root / "util" / "lists" / "x"
    bl.mkdir(parents=True)
    (bl / "uids.txt").write_text(f"{uid}\n")
    return root


def test_train_then_resume_then_eval_over_fake_tree(fake_adni_tree, tmp_path, capsys):
    """catalog -> grouped split -> pipeline -> warm start from a reference
    .pth -> trainer -> checkpoints -> health gate, then `--resume`, then the
    eval CLI over the run's ckpt/ directory (tests/test_cli_e2e.py:49-80 for
    the JAX CLIs)."""
    run_dir = str(tmp_path / "run")
    pretrained = str(tmp_path / "epoch7.pth")
    torch.save(make_model(get_model_config("tiny_spatial"), device="cpu", seed=3).state_dict(),
               pretrained)
    argv = ["--preset", "z1200", "--model", "tiny_spatial", "--data-root", str(fake_adni_tree),
            "--batch", "2", "--no-bf16", "--run-dir", run_dir, "--device", "cpu"]
    code = 0
    try:
        cli_train.main(argv + ["--epochs", "2", "--health-gate", "--pretrained", pretrained])
    except SystemExit as e:  # the gate's verdict on a 2-epoch run
        code = e.code
    for name in ("args.json", "train_result.csv", "metrics.jsonl", "loss.txt", "kl_losses.txt",
                 "sweep.json", "health.json", "soft_intro_losses.png", "kl_stats.png",
                 os.path.join("imgs", "rec_epoch0.jpg"), os.path.join("imgs", "fake_epoch0.jpg"),
                 os.path.join("val_imgs", "val_rec_epoch0.jpg")):
        assert os.path.exists(os.path.join(run_dir, name)), name
    assert CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps() == [0, 1]
    with open(os.path.join(run_dir, "args.json")) as f:
        snap = json.load(f)
    assert snap["synthetic"] == 0 and snap["data_root"] == str(fake_adni_tree)
    assert snap["device"] == "cpu" and json.loads(snap["model_config"])["in_ch"] == 4
    with open(os.path.join(run_dir, "health.json")) as f:
        health = json.load(f)
    with open(os.path.join(run_dir, "sweep.json")) as f:
        assert [r["checkpoint"] for r in json.load(f)] == ["0", "1"]
    assert code == (0 if health["healthy"] else 1)
    assert health["criterion"] == {"drift_frac": 0.3, "min_ssim3d": 0.2}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 2

    two_epochs = torch.load(os.path.join(run_dir, "ckpt", "1.pth"), weights_only=True)["step"]
    trainer = cli_train.main(argv + ["--epochs", "1", "--resume"])
    out = capsys.readouterr().out
    assert f"warm-started from {pretrained}" in out and "resumed from epoch 1" in out
    assert two_epochs > 0 and trainer.state.step == two_epochs * 3 // 2

    out = str(tmp_path / "report.json")
    cli_eval.main(["--model", "tiny_spatial", "--ckpt", os.path.join(run_dir, "ckpt"),
                   "--data-root", str(fake_adni_tree), "--batch", "2", "--out", out,
                   "--device", "cpu"])
    with open(out) as f:
        report = json.load(f)
    assert "retrieval_p_at_k" in report and np.isfinite(report["rmse"])
    with pytest.raises(SystemExit, match="A.6"):
        cli_eval.main(["--model", "tiny_spatial", "--ckpt", str(tmp_path), "--synthetic", "4",
                       "--device", "cpu"])
