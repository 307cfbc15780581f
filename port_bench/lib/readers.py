"""The formulas of the metric readers that several metrics share; each
`metrics/<name>.py` names its formula here. Each takes the run's
`harness.Observation` and returns a number, or None where the run has
nothing to read for it."""

from __future__ import annotations


def volumes_per_s(obs):
    """Volumes whose work completed in the timed window, over its seconds
    (host clock, from the first dispatch to the synchronise after the
    last)."""
    return obs.volumes / obs.window_s if obs.units else None


def data_wait_ms(obs):
    """Milliseconds a step waited for its batch from the pipeline, in the
    timed window (the benchmark's host-clock span around taking it)."""
    return 1e3 * obs.spans["data_wait"] / obs.units if "data_wait" in obs.spans else None


def launches(obs):
    """Kernel launches a unit (copies and fills left out), profiled window."""
    return obs.trace.kernels / obs.trace_units if obs.trace is not None else None


def mfu(obs):
    """Percent of the chips' peak: the algorithm's multiplications (counted
    from the plain reference) times the units of the timed window, over its
    seconds times the peak of the compute type times the chips."""
    if obs.flops_per_unit is None or not obs.units:
        return None
    return 100.0 * obs.flops_per_unit * obs.units / (obs.window_s * obs.peak_flops * obs.chips)


def library_ms(obs):
    """Milliseconds a unit in which some kernel outside the port's `sivae::`
    namespace ran (a union of intervals), profiled window."""
    return 1e3 * obs.trace.library_s / obs.trace_units if obs.trace is not None else None


def library_ms_per_volume(obs):
    """As `library_ms`, a volume."""
    if obs.trace is None or not obs.units:
        return None
    return 1e3 * obs.trace.library_s / (obs.trace_units * obs.volumes / obs.units)


def conv_roofline(obs):
    """Percent: the least time of every conv launch of the port's kernels in
    the profiled window (by its site, `lib/roofline.py`), over the device
    time of the port's kernels in the same window."""
    from port_bench.lib.roofline import sites_least_s

    if obs.trace is None or obs.trace.port_s <= 0 or not obs.sites:
        return None
    return 100.0 * sites_least_s(obs.sites) / obs.trace.port_s


def idle_share(obs):
    """Percent of the profiled window in which no kernel, copy or fill ran
    on the card (rank 0's)."""
    return 100.0 * obs.trace.idle_share if obs.trace is not None else None


def peak_gib(obs):
    """GiB: the largest allocation on rank 0's card in the timed window."""
    return obs.peak_window_bytes / 2 ** 30 if obs.peak_window_bytes else None
