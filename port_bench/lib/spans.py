"""The formulas of the metric readers that read the program's own spans
(`sivae_torch.utils.trace`): the split of a train step, of the pipeline's
work and of an eval pass.

The program records its spans only while a torch profiler records, so in
the printing process (rank 0) its store holds exactly the profiled window
of a `--trace 1` run. Each formula returns None without a profiled window,
where the program records no spans (a tree without the recorder), or where
a span it needs is absent or has no device time (no CUDA).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

FORWARD = ("phase_e.forward", "phase_d.forward")
BACKWARD = ("phase_e.backward", "phase_d.backward")
UPDATE = ("phase_e.update", "phase_d.update")


def program_spans() -> Optional[Dict[str, dict]]:
    """{name: {"count", "host_s", "self_s", "device_s"}} of the program's
    spans in this process, or None where the program has no recorder."""
    try:
        from sivae_torch.utils.trace import summary
    except ImportError:
        return None
    return summary()


def total_s(spans: Optional[Dict[str, dict]], names: Sequence[str], key: str
            ) -> Optional[float]:
    """The `key` seconds of the named spans added, or None where one is
    absent or has no such time."""
    if spans is None or any(n not in spans or spans[n][key] is None for n in names):
        return None
    return sum(spans[n][key] for n in names)


def ms_per_unit(obs, names: Sequence[str], key: str) -> Optional[float]:
    """Milliseconds a unit (a step or a pass) of the profiled window."""
    if obs.trace is None or not obs.trace_units:
        return None
    s = total_s(program_spans(), names, key)
    return None if s is None else 1e3 * s / obs.trace_units


def ms_per_call(obs, name: str, key: str) -> Optional[float]:
    """Milliseconds a call of the span `name`, by its own count."""
    if obs.trace is None:
        return None
    spans = program_spans()
    s = total_s(spans, (name,), key)
    return None if s is None else 1e3 * s / spans[name]["count"]


def fwd_ms(obs):
    """Device ms a step of the two phases' forwards and losses."""
    return ms_per_unit(obs, FORWARD, "device_s")


def bwd_ms(obs):
    """Device ms a step of the two phases' backwards."""
    return ms_per_unit(obs, BACKWARD, "device_s")


def update_ms(obs):
    """Device ms a step of the two phases' gradient averages and Adam steps."""
    return ms_per_unit(obs, UPDATE, "device_s")


def step_host_ms(obs):
    """Host ms a step spent issuing the two-phase step (above the step's
    device time, the host paces the cell)."""
    return ms_per_unit(obs, ("step",), "host_s")


def prepare_ms(obs):
    """Device ms a batch of the pipeline's copy, augmentation and
    preprocessing on its side stream (the producer runs ahead, so by its
    own count)."""
    return ms_per_call(obs, "data.prepare", "device_s")


def pipeline_wait_ms(obs):
    """Host ms a step the consumer waited for the pipeline's next batch."""
    return ms_per_unit(obs, ("data.wait",), "host_s")


def encode_ms(obs):
    """Device ms a pass of `encode_dataset`."""
    return ms_per_unit(obs, ("eval.encode",), "device_s")


def reconstruct_ms(obs):
    """Device ms a pass of the report's reconstructions."""
    return ms_per_unit(obs, ("eval.reconstruct",), "device_s")


def quality_ms(obs):
    """Device ms a pass of the report's quality metrics and their means."""
    return ms_per_unit(obs, ("eval.quality",), "device_s")
