"""Percent of a pass spent in `reconstruction_report` (the benchmark's
host-clock spans around the pass's calls)."""


def read(obs):
    return 100.0 * obs.spans["report"] / obs.spans["pass"] if "report" in obs.spans else None
