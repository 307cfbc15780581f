"""The span recorder of sivae_torch (`sivae_torch/utils/trace.py`) and the
spans of the train step, the data pipeline and the eval functions, on the
CPU at the tiny sizes.

With no profiler recording a span is a shared no-op: a step makes no
`record_function`, no CUDA event and no entry in the store. Under
`torch.profiler.profile` each span is a `sivae.<name>` range on the
profiler's timeline of the thread that ran it, and the store keeps its
count, host time and self time (the device time needs CUDA: None here).
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import sivae_torch.eval.recon_quality as recon_quality
from sivae_torch.config import OptimConfig, SoftIntroLossConfig
from sivae_torch.data.pipeline import BrainDataSource, DataPipeline
from sivae_torch.data.synthetic import SyntheticBrainSource
from sivae_torch.eval.latent_probe import encode_dataset
from sivae_torch.models.registry import get_model_config, make_model
from sivae_torch.train.state import create_train_state
from sivae_torch.train.step import make_soft_intro_train_step
from sivae_torch.utils import trace

torch.set_num_threads(2)

STEP_SPANS = {"step", "phase_e.forward", "phase_e.backward", "phase_e.update",
              "phase_d.forward", "phase_d.backward", "phase_d.update"}
MODELS = {"spatial": "tiny_spatial", "fc": "tiny_fc"}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _no_device_times() -> bool:
    return not torch.cuda.is_initialized()


def _train(family: str, seed: int = 0):
    """A tiny model's state, its two-phase step and a batch of 2."""
    cfg = get_model_config(MODELS[family])
    model = make_model(cfg, device="cpu", seed=seed)
    state = create_train_state(model, seed=seed)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 2,
                                      cfg.input_shape)
    real = torch.rand((2, 1) + tuple(cfg.input_shape), generator=torch.Generator().manual_seed(1))
    return state, step, real


@pytest.fixture(autouse=True)
def empty_store():
    trace.reset()
    yield
    trace.reset()


def _refuse(*args, **kwargs):
    raise AssertionError("made while no profiler records")


@pytest.mark.parametrize("family", sorted(MODELS))
def test_without_a_profiler_a_step_records_nothing(monkeypatch, family):
    state, step, real = _train(family)
    plain = torch.autograd.profiler.record_function

    def ranges(name, *args, **kwargs):
        # torch's own ranges (Adam's) are made whether or not a profiler records
        if name.startswith(trace.PREFIX):
            _refuse()
        return plain(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", ranges)
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    for _ in range(2):
        state, metrics = step(state, real)
    assert trace.summary() == {}
    assert trace.span("step") is trace.span("data.wait")   # the one shared no-op
    assert np.isfinite(metrics["lossE"].item())


@pytest.mark.parametrize("family", sorted(MODELS))
def test_a_profiled_step_records_each_span_once(family):
    state, step, real = _train(family)
    with _cpu_profile():
        step(state, real)
    got = trace.summary()
    assert set(got) == STEP_SPANS
    for name, t in got.items():
        assert t["count"] == 1, name
        assert 0.0 <= t["self_s"] <= t["host_s"], name
        if _no_device_times():
            assert t["device_s"] is None, name
    children = sum(t["host_s"] for name, t in got.items() if name != "step")
    assert children <= got["step"]["host_s"]
    assert got["step"]["self_s"] == pytest.approx(got["step"]["host_s"] - children)


def test_span_names_sit_on_the_thread_that_ran_the_step():
    state, step, real = _train("spatial")
    with _cpu_profile() as prof:
        with record_function("test.around_the_step"):
            step(state, real)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    (outer,) = events["test.around_the_step"]
    for name in STEP_SPANS:
        (e,) = events[trace.PREFIX + name]
        assert e.start_thread_id() == outer.start_thread_id(), name
        assert outer.start_ns() <= e.start_ns(), name
        assert e.start_ns() + e.duration_ns() <= outer.start_ns() + outer.duration_ns(), name


@pytest.mark.parametrize("family", sorted(MODELS))
def test_a_profiled_step_is_bit_identical_to_an_unprofiled_one(family):
    outs = []
    for profiled in (False, True):
        state, step, real = _train(family)
        if profiled:
            with _cpu_profile():
                state, metrics = step(state, real)
        else:
            state, metrics = step(state, real)
        adam = [st["exp_avg_sq"].clone() for opt in (state.opt_e, state.opt_d)
                for st in opt.state.values()]
        outs.append((metrics, state.model.state_dict(), adam, state.step))
    (m0, sd0, adam0, n0), (m1, sd1, adam1, n1) = outs
    assert n0 == n1 == 1
    assert set(trace.summary()) == STEP_SPANS
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    assert len(adam0) == len(adam1) and all(torch.equal(a, b) for a, b in zip(adam0, adam1))


def test_the_pipeline_records_prepare_on_its_producer_and_wait_on_its_consumer(monkeypatch):
    src = BrainDataSource(SyntheticBrainSource(6, (16, 16, 16), seed=3).records)
    pipe = DataPipeline(src, 2, device="cpu", seed=5)
    threads = {}
    add = trace.STORE.add

    def add_by_thread(name, *args, **kwargs):
        threads.setdefault(name, set()).add(threading.get_ident())
        add(name, *args, **kwargs)

    monkeypatch.setattr(trace.STORE, "add", add_by_thread)
    with _cpu_profile():
        batches = [vox for vox, _ in pipe.epoch(0)]
    got = trace.summary()
    assert len(batches) == pipe.steps_per_epoch == 3
    assert got["data.prepare"]["count"] == 3
    assert got["data.wait"]["count"] == 4   # each batch, and the epoch's end
    assert threads["data.wait"] == {threading.get_ident()}
    assert len(threads["data.prepare"]) == 1
    assert threads["data.prepare"] != threads["data.wait"]


def test_the_eval_functions_record_encode_reconstruct_and_quality(monkeypatch):
    model = make_model(get_model_config("tiny_spatial"), device="cpu", seed=0)
    vox = torch.rand((5, 1, 16, 16, 16), generator=torch.Generator().manual_seed(2))
    with _cpu_profile():
        z = encode_dataset(model, vox, batch_size=2)
        recon_quality.reconstruction_report(model, vox, batch_size=2)
    got = trace.summary()
    assert z.shape[0] == 5
    assert set(got) == {"eval.encode", "eval.reconstruct", "eval.quality"}
    assert got["eval.encode"]["count"] == 1
    assert got["eval.reconstruct"]["count"] == 3
    assert got["eval.quality"]["count"] == 4   # each batch's metrics, and the means

    # a caller's wrapper around `reconstruct` calls through it: still recorded
    trace.reset()
    kept = []
    original = recon_quality.reconstruct

    def keep(*args, **kwargs):
        y = original(*args, **kwargs)
        kept.append(y)
        return y

    monkeypatch.setattr(recon_quality, "reconstruct", keep)
    with _cpu_profile():
        recon_quality.reconstruction_report(model, vox, batch_size=2)
    assert len(kept) == 3
    assert trace.summary()["eval.reconstruct"]["count"] == 3


def test_self_time_leaves_out_the_children():
    with _cpu_profile():
        with trace.span("outer"):
            for _ in range(2):
                with trace.span("inner"):
                    sum(range(1000))
    got = trace.summary()
    assert got["inner"]["count"] == 2
    assert got["outer"]["self_s"] == pytest.approx(got["outer"]["host_s"] -
                                                   got["inner"]["host_s"])
    assert got["inner"]["self_s"] == got["inner"]["host_s"]


def test_spans_of_many_threads_lose_no_update():
    threads, per = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            def work():
                for _ in range(per):
                    with trace.span("outer"):
                        with trace.span("inner"):
                            pass
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    got = trace.summary()
    assert got["outer"]["count"] == got["inner"]["count"] == threads * per
    assert got["outer"]["host_s"] >= got["inner"]["host_s"]


def test_reset_empties_the_store():
    with _cpu_profile():
        with trace.span("outer"):
            pass
    assert set(trace.summary()) == {"outer"}
    trace.reset()
    assert trace.summary() == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); run chip_smoke.py there")
    from sivae_torch.utils.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
def test_on_the_card_each_span_has_a_device_time(cuda_device):
    """An epoch of the pipeline into the step on the card: every span has
    a device time, and on the compute stream the phases' add up to at most
    the step's."""
    cfg = get_model_config("tiny_spatial")
    model = make_model(cfg, device=cuda_device, seed=0)
    state = create_train_state(model, seed=0)
    step = make_soft_intro_train_step(model, SoftIntroLossConfig(), OptimConfig(), 3,
                                      cfg.input_shape)
    src = BrainDataSource(SyntheticBrainSource(6, cfg.input_shape, seed=3).records)
    pipe = DataPipeline(src, 2, device=cuda_device, seed=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for vox, _ in pipe.epoch(0):
            state, metrics = step(state, vox)
        torch.cuda.synchronize()
    got = trace.summary()
    assert set(got) == STEP_SPANS | {"data.prepare", "data.wait"}
    assert got["step"]["count"] == 3 and got["data.prepare"]["count"] == 3
    for name, t in got.items():
        assert t["device_s"] is not None and t["device_s"] >= 0.0, name
    assert got["phase_e.forward"]["device_s"] > 0.0 and got["data.prepare"]["device_s"] > 0.0
    phases = sum(t["device_s"] for name, t in got.items() if name.startswith("phase_"))
    assert phases <= got["step"]["device_s"] + 1e-5   # event timer resolution, 14 events
