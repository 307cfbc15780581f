"""CPU tests of the benchmark's harness, reference and arithmetic.

    python -m pytest port_bench/tests -q

The cells run here at the test size (`tiny.py`) on the CPU, where the
port's kernels take their plain versions. The one test that needs the card
is marked `gpu` and skips without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench.harness import cell_metrics, find_cell, load_json, run_cell
from port_bench.lib import compare
from port_bench.lib.roofline import site_least_s
from port_bench.lib.trace import measure, minus, summarise, union
from port_bench.tests.tiny import REPO, context, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, **kw):
    rc, line = run_cell(context(root, cell, **kw))
    assert rc == 0
    return line


# -- the reference against the port's CPU path --------------------------------


@pytest.mark.parametrize("cell", ["t_train", "t_fc_train", "t_eval"])
def test_program_matches_the_reference(root, cell):
    line = _run(root, cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


def test_two_ranks_match_the_reference(root):
    line = _run(root, "t_dp2")
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 2


# -- faults planted under the timed path --------------------------------------


def _frozen_state_step(make):
    """A step that returns its state as it came in: the model, the Adams and
    the count untouched."""
    def wrapped(model, *a, **kw):
        step = make(model, *a, **kw)

        def train_step(state, real):
            saved = {k: v.clone() for k, v in model.state_dict().items()}
            _, metrics = step(state, real)
            model.load_state_dict(saved)
            for opt in (state.opt_e, state.opt_d):
                opt.state.clear()
            state.step -= 1
            return state, metrics
        return train_step
    return wrapped


def _half_batch_step(make):
    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def train_step(state, real):
            return step(state, real[: real.shape[0] // 2])
        return train_step
    return wrapped


def _reversed_update_step(make):
    """A step whose update goes the wrong way: each parameter moves by minus
    the program's change."""
    def wrapped(model, *a, **kw):
        step = make(model, *a, **kw)

        def train_step(state, real):
            before = {k: p.detach().clone() for k, p in model.named_parameters()}
            state, metrics = step(state, real)
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(2 * before[k] - p)
            return state, metrics
        return train_step
    return wrapped


def _altered_loss_step(make):
    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def train_step(state, real):
            state, metrics = step(state, real)
            return state, {**metrics, "lossE": metrics["lossE"] * 1.01}
        return train_step
    return wrapped


@pytest.mark.parametrize("fault", [_frozen_state_step, _half_batch_step, _reversed_update_step,
                                   _altered_loss_step])
def test_train_fault_is_not_correct(root, monkeypatch, fault):
    import sivae_torch.train.step as step_mod

    monkeypatch.setattr(step_mod, "make_soft_intro_train_step",
                        fault(step_mod.make_soft_intro_train_step))
    line = _run(root, "t_train")
    assert not line["correct"], line["checks"]


def _altered_latents(fn):
    def wrapped(*a, **kw):
        z = fn(*a, **kw)
        z = z.copy()
        z[:, 0] += 0.01 * np.abs(z).max()
        return z
    return wrapped


def _altered_report(fn):
    def wrapped(*a, **kw):
        rep = dict(fn(*a, **kw))
        rep["ssim3d"] *= 1.01
        return rep
    return wrapped


def _altered_later_recons(fn):
    """Every reconstruction after the report's first batch a little off."""
    calls = [0]

    def wrapped(*a, **kw):
        y = fn(*a, **kw)
        calls[0] += 1
        return y if calls[0] % 2 == 1 else y + 0.01 * y.abs().max()
    return wrapped


def _altered_neighbours(fn):
    """Each query's last neighbour swapped for its worst database entry."""
    def wrapped(q, d, k=10):
        scores, idx = fn(q, d, k)
        _, worst = fn(q, d, d.shape[0])
        idx = idx.clone()
        idx[:, -1] = worst[:, -1]
        return scores, idx
    return wrapped


@pytest.mark.parametrize("module,name,fault", [
    ("sivae_torch.eval.latent_probe", "encode_dataset", _altered_latents),
    ("sivae_torch.eval.recon_quality", "reconstruction_report", _altered_report),
    ("sivae_torch.eval.recon_quality", "reconstruct", _altered_later_recons),
    ("sivae_torch.eval.retrieval", "cosine_knn", _altered_neighbours)])
def test_eval_fault_is_not_correct(root, monkeypatch, module, name, fault):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    line = _run(root, "t_eval")
    assert not line["correct"], line["checks"]


def no_exchange_rank(ctx, rank, world, port, fn, args):
    """A spawned rank whose gradient all-reduce is left out."""
    import sivae_torch.parallel.mesh as mesh
    import sivae_torch.train.step as step_mod

    from port_bench.entries.train_step import rank_child

    step_mod.average_gradients = lambda params: None
    mesh.average_gradients = step_mod.average_gradients
    rank_child(ctx, rank, world, port, fn, args)


def jax_loading_rank(ctx, rank, world, port, fn, args):
    """A spawned rank that has loaded a module named `jax`."""
    import types

    from port_bench.entries.train_step import rank_child

    sys.modules["jax"] = types.ModuleType("jax")
    rank_child(ctx, rank, world, port, fn, args)


def test_exchange_left_out_is_not_correct(root, monkeypatch):
    import sivae_torch.train.step as step_mod

    monkeypatch.setattr(step_mod, "average_gradients", lambda params: None)
    rc, line = run_cell(context(root, "t_dp2", rank_target=no_exchange_rank))
    assert rc == 0
    assert not line["correct"], line["checks"]


def test_a_rank_that_loads_jax_fails_the_run(root):
    rc, line = run_cell(context(root, "t_dp2", rank_target=jax_loading_rank))
    assert rc != 0 and line is None


# -- the control: the reference one precision down ----------------------------


def test_control_fails_the_limits(root):
    from port_bench.entries.train_step import TrainCell
    from port_bench.reference.model import Precision

    ctx = context(root, "t_train")
    cell = TrainCell(ctx)
    cell.setup()
    cell.close_program()
    exact = cell.reference()
    for got in (cell.reference(Precision("fp8")), cell.reference(half_batch=True)):
        numbers = compare.train_numbers(*got, *exact, cell.state0)
        assert any(numbers[k] > ctx.limits[k] for k in ctx.limits), numbers


def test_eval_control_fails_the_limits(root):
    """At the test size on the CPU, where TF32 (the cell's control on the
    card) does not exist: float8 operands stand in."""
    from port_bench.entries.eval_pass import EvalCell, _stack
    from port_bench.reference.model import Precision

    ctx = context(root, "t_eval")
    cell = EvalCell(ctx)
    cell.setup()
    cell.close_program()
    z, recons = cell.reference()
    zc, recons_c = cell.reference(Precision("fp8"))
    idx = np.argsort(-compare.cosine(zc[cell.vid], zc[cell.tid]), axis=1)[:, :3]
    got = compare.eval_numbers(zc, z, _stack(recons_c), _stack(recons),
                               cell.report_of(recons, torch.bfloat16), cell.report_of(recons),
                               idx, compare.cosine(z[cell.vid], z[cell.tid]), 0.0, 0.0)
    assert got["latent_gap"] > ctx.limits["latent_gap"], got
    assert got["report_gap"] > ctx.limits["report_gap"], got


# -- arithmetic ---------------------------------------------------------------


def test_leaf_gaps_see_direction():
    ref = {"a": torch.tensor([3.0, -4.0]), "b": torch.tensor([0.0, 5.0])}
    flipped = {k: -v for k, v in ref.items()}
    assert [g for g, _ in compare.leaf_gaps(flipped, ref)] == [pytest.approx(2.0)] * 2
    assert max(g for g, _ in compare.leaf_gaps(flipped, ref, by_norms=True)) == 0.0
    unmoved = {k: torch.zeros_like(v) for k, v in ref.items()}
    assert max(g for g, _ in compare.leaf_gaps(unmoved, ref)) == pytest.approx(1.0)


def test_knn_shortfall():
    sim = np.array([[0.9, 0.8, 0.8, 0.1], [0.2, 0.3, 0.7, 0.6]])
    assert compare.knn_shortfall(np.array([[0, 1], [2, 3]]), sim) == 0.0
    assert compare.knn_shortfall(np.array([[0, 2], [3, 2]]), sim) == 0.0     # a tie, any order
    assert compare.knn_shortfall(np.array([[0, 3], [2, 3]]), sim) == pytest.approx(0.7)
    assert compare.knn_shortfall(np.array([[0, 0], [2, 3]]), sim) == 2.0     # a repeat
    assert compare.knn_shortfall(np.array([[0, 4], [2, 3]]), sim) == 2.0     # out of range


def test_union_idle_and_exposed_time():
    assert union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]
    assert measure([(0, 2), (1, 3), (5, 6)]) == 4
    assert minus([(0, 10)], [(2, 3), (2.5, 4), (8, 12)]) == 10 - 2 - 2
    device = [("sivae::conv3d_wgmma_kernel", 10, 40), ("void at::elementwise", 30, 50),
              ("ncclDevKernel_AllReduce", 45, 70), ("Memcpy HtoD", 80, 85)]
    host = [("aten::conv", 0, 60, 1), ("aten::add", 55, 90, 1), ("other", 50, 95, 2)]
    s = summarise(device, host, (0, 100), main_thread=1)
    assert s.busy_s == pytest.approx(65e-6)              # [10, 70] and [80, 85]
    assert s.idle_share == pytest.approx(1 - 65 / 100)
    assert s.kernels == 3
    assert s.port_s == pytest.approx(30e-6)
    assert s.library_s == pytest.approx(40e-6)             # [30, 70]
    assert s.nccl_exposed_s == pytest.approx(20e-6)        # [50, 70]
    gaps = dict(s.idle_gaps)
    assert gaps["aten::conv"] == pytest.approx(10e-6)      # [0, 10]
    assert gaps["aten::add"] == pytest.approx(10e-6 + 15e-6)   # [70, 80], [85, 100]
    assert s.device_ops[0] == ("sivae::conv3d_wgmma_kernel", pytest.approx(30e-6))


def test_site_roofline_by_hand():
    # 64 -> 64 at 80x96x80, batch 8, bf16: 2 * 64 * 64 * 27 * 4915200 operations
    ops = 2 * 64 * 64 * 27 * 8 * 80 * 96 * 80
    assert site_least_s("64->64@80x96x80 b8 bfloat16") == pytest.approx(ops / 989e12)
    # 64 -> 1 is bound by its bytes: input and output, fp32
    vox = 2 * 80 * 96 * 80
    nbytes = (vox * 64 + 27 * 64 + vox) * 4
    assert site_least_s("64->1@80x96x80 b2 float32") == pytest.approx(nbytes / 3.35e12)


def _conv_flops_by_hooks(model, x):
    """2 Ci Co k^3 per output voxel of every conv and 2 in out per Linear row."""
    from port_bench.reference.model import Conv, Lin, Precision, Run

    total = [0]

    def conv_hook(m, inp, out):
        k = m.weight.shape[2]
        total[0] += 2 * m.weight.shape[0] * m.weight.shape[1] * k ** 3 * out[0, 0].numel() \
            * out.shape[0]

    def lin_hook(m, inp, out):
        total[0] += 2 * m.weight.shape[0] * m.weight.shape[1] * out.shape[0]

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, Conv) else lin_hook)
             for m in model.modules() if isinstance(m, (Conv, Lin))]
    model.encode(x, Run(train=False, prec=Precision()))
    for h in hooks:
        h.remove()
    return total[0]


def test_flop_count_matches_hook_count():
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference.evaluate import encode_mu
    from port_bench.reference.model import Precision, make_reference

    for name in ("spatial_1200", "fc_150"):
        cfg = load_json(REPO / "port_bench" / "configs" / f"{name}.json")
        model = make_reference(cfg, "meta")
        x = torch.zeros((1, 1) + tuple(cfg["input_shape"]), device="meta")
        with FlopCounterMode(display=False) as counter:
            encode_mu(model, x, Precision())
        assert counter.get_total_flops() == _conv_flops_by_hooks(model, x)
    # spatial_1200's encoder: ~227 GF a volume
    cfg = load_json(REPO / "port_bench" / "configs" / "spatial_1200.json")
    model = make_reference(cfg, "meta")
    x = torch.zeros((1, 1, 80, 96, 80), device="meta")
    assert 220e9 < _conv_flops_by_hooks(model, x) < 235e9


def test_configs_are_the_registry_models():
    from sivae_torch.models.registry import get_model_config

    from port_bench.lib.program import model_config

    for name in ("spatial_1200", "fc_150"):
        cfg = load_json(REPO / "port_bench" / "configs" / f"{name}.json")
        got = model_config(cfg, "float32")
        want = get_model_config(name)
        for field in ("input_shape", "act", "logvar_head_zero_init", "logvar_clip"):
            assert getattr(got, field) == getattr(want, field), field
        if name == "spatial_1200":
            assert (got.in_ch, got.block_setting) == (want.in_ch, want.block_setting)
        else:
            assert (got.first_ch, got.second_ch, got.third_ch, got.forth_ch, got.z_ch) == \
                (want.first_ch, want.second_ch, want.third_ch, want.forth_ch, want.z_ch)
        from port_bench.reference.model import make_reference

        n = sum(p.numel() for p in make_reference(cfg, "meta").parameters())
        assert n == cfg["parameters"]


# -- discovery by name --------------------------------------------------------


def test_a_cell_and_a_metric_added_as_new_files_are_found(root, tmp_path):
    new_root = make_root(tmp_path)
    bench = load_json(new_root / "BENCHMARK.json")
    (new_root / "port_bench" / "metrics" / "steps_done.train.py").write_text(
        '"""Steps in the window."""\n\n\ndef read(obs):\n    return obs.units\n')
    bench["per_layer"].append({"name": "steps_done.train", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "loop and data",
                               "moves": "train_vol_s", "workloads": ["t_fc_train"]})
    (new_root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert find_cell(bench, "t_fc_train")["config"] == "tiny_fc"
    names = [m["name"] for m in cell_metrics(bench, "t_fc_train", trace=True)]
    assert "steps_done.train" in names
    line = _run(new_root, "t_fc_train", trace=1)
    assert line["metrics"]["steps_done.train"]["value"] >= 1
    assert "steps_done.train" not in _run(new_root, "t_train", trace=1)["metrics"]


def test_trace_line_carries_the_per_layer_metrics(root):
    line = _run(root, "t_train", trace=1)
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "breakdown" in line
    assert "mfu.train" in line["metrics"] and "train_vol_s" not in line["metrics"]


# -- refusals and imports -----------------------------------------------------


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(REPO / "port_bench" / "run.py"), "--workload",
                           "z1200_train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_fails_in_a_tree_without_the_program(tmp_path):
    import shutil

    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "z1200_eval",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


FORBIDDEN_CHECK = """
import sys, json
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(body: str):
    code = FORBIDDEN_CHECK.format(repo=str(REPO), body=body)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cell_loads_no_jax(root):
    from port_bench.harness import FORBIDDEN

    loaded = _loaded(f"""
from port_bench.tests.tiny import context
from port_bench.harness import run_cell
for cell in ("t_train", "t_eval", "t_dp2"):
    rc, line = run_cell(context({str(root)!r}, cell, trace=1))
    assert rc == 0 and line["correct"], line
""")
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
    assert "sivae_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("""
import port_bench.reference.model, port_bench.reference.step
import port_bench.reference.data, port_bench.reference.evaluate
import port_bench.lib.flops, port_bench.lib.compare
""")
    assert not loaded & {"sivae_torch", "sivae_tpu", "jax", "jaxlib", "flax"}


# -- on the card ----------------------------------------------------------------


@pytest.mark.gpu
def test_eval_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "z1200_eval",
                           "--seed", "7", "--seconds", "2", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
