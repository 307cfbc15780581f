"""CPU tests of the readers of the program's spans (`lib/spans.py`) on
hand-made span totals, and of their discovery from `BENCHMARK.json`.

    python -m pytest port_bench/tests/test_spans.py -q
"""

from __future__ import annotations

import sys

import pytest

from port_bench.harness import Observation, cell_metrics, load_json, read_metrics
from port_bench.lib import spans
from port_bench.tests.tiny import REPO, context, make_root

# seconds, as `sivae_torch.utils.trace.summary()` gives them
TOTALS = {
    "step": {"count": 4, "host_s": 2.0, "self_s": 0.1, "device_s": 3.0},
    "phase_e.forward": {"count": 4, "host_s": 0.5, "self_s": 0.5, "device_s": 1.0},
    "phase_d.forward": {"count": 4, "host_s": 0.4, "self_s": 0.4, "device_s": 0.6},
    "phase_e.backward": {"count": 4, "host_s": 0.3, "self_s": 0.3, "device_s": 0.8},
    "phase_d.backward": {"count": 4, "host_s": 0.3, "self_s": 0.3, "device_s": 0.4},
    "phase_e.update": {"count": 4, "host_s": 0.1, "self_s": 0.1, "device_s": 0.02},
    "phase_d.update": {"count": 4, "host_s": 0.1, "self_s": 0.1, "device_s": 0.02},
    "data.prepare": {"count": 6, "host_s": 0.3, "self_s": 0.3, "device_s": 0.012},
    "data.wait": {"count": 5, "host_s": 0.008, "self_s": 0.008, "device_s": 1e-4},
    "eval.encode": {"count": 1, "host_s": 1.0, "self_s": 1.0, "device_s": 1.5},
    "eval.reconstruct": {"count": 20, "host_s": 1.1, "self_s": 1.1, "device_s": 1.6},
    "eval.quality": {"count": 21, "host_s": 1.2, "self_s": 1.2, "device_s": 0.9},
}
# ms a unit over 4 traced steps (train) or 1 pass (eval)
EXPECTED = {
    "fwd_ms": 1e3 * 1.6 / 4, "bwd_ms": 1e3 * 1.2 / 4, "update_ms": 1e3 * 0.04 / 4,
    "step_host_ms": 1e3 * 2.0 / 4, "prepare_ms": 1e3 * 0.012 / 6,
    "pipeline_wait_ms": 1e3 * 0.008 / 4,
    "encode_ms": 1e3 * 1.5, "reconstruct_ms": 1e3 * 1.6, "quality_ms": 1e3 * 0.9,
}
TRAIN = ("fwd_ms", "bwd_ms", "update_ms", "step_host_ms", "prepare_ms", "pipeline_wait_ms")
EVAL = ("encode_ms", "reconstruct_ms", "quality_ms")
CELLS = {"train": "z1200_train", "fc": "z600_train", "eval": "z1200_eval"}


def _obs(units: int, traced: bool = True) -> Observation:
    obs = Observation(cell={}, chips=1)
    obs.trace = object() if traced else None
    obs.trace_units = units if traced else 0
    return obs


@pytest.fixture
def totals(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: TOTALS)
    return TOTALS


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_formula_by_hand(totals, name):
    units = 1 if name in EVAL else 4
    assert getattr(spans, name)(_obs(units)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_nothing_without_a_profiled_window(totals, name):
    assert getattr(spans, name)(_obs(4, traced=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_nothing_where_a_span_is_absent(monkeypatch, name):
    monkeypatch.setattr(spans, "program_spans", lambda: {"other": TOTALS["step"]})
    assert getattr(spans, name)(_obs(4)) is None


def test_nothing_without_device_times(monkeypatch):
    cpu = {k: dict(v, device_s=None) for k, v in TOTALS.items()}
    monkeypatch.setattr(spans, "program_spans", lambda: cpu)
    obs = _obs(4)
    assert spans.fwd_ms(obs) is None and spans.prepare_ms(obs) is None
    assert spans.step_host_ms(obs) == pytest.approx(EXPECTED["step_host_ms"])


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "sivae_torch.utils.trace", None)   # import fails
    assert spans.program_spans() is None
    assert spans.fwd_ms(_obs(4)) is None and spans.encode_ms(_obs(1)) is None


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_readers_are_found_from_their_entries(totals, kind):
    bench = load_json(REPO / "BENCHMARK.json")
    names = TRAIN if kind != "eval" else EVAL
    wanted = {f"{n}.{kind}" for n in names}
    metrics = [m for m in cell_metrics(bench, CELLS[kind], trace=True) if m["name"] in wanted]
    assert {m["name"] for m in metrics} == wanted
    assert all(m["source"] == "program_counter" for m in metrics)
    got = read_metrics(REPO, metrics, _obs(1 if kind == "eval" else 4))
    assert {k: v["value"] for k, v in got.items()} == pytest.approx(
        {f"{n}.{kind}": EXPECTED[n] for n in names})


def test_a_traced_cpu_run_reports_the_host_spans(tmp_path):
    """The tiny train cell on the CPU: the host times are read, the device
    times (no CUDA) are left out of the line."""
    from port_bench.harness import run_cell
    from sivae_torch.utils import trace

    root = make_root(tmp_path)
    trace.reset()
    rc, line = run_cell(context(root, "t_train", trace=1))
    assert rc == 0 and line["correct"], line["checks"]
    reported = set(line["metrics"])
    assert {"step_host_ms.train", "pipeline_wait_ms.train"} <= reported
    assert not {"fwd_ms.train", "bwd_ms.train", "update_ms.train", "prepare_ms.train"} & reported
    assert line["metrics"]["step_host_ms.train"]["value"] > 0
