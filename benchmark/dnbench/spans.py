"""The port's own span records of a run's untraced window, for the readers
of metrics/ that read what the program records
(`diffusionnet_tpu_torch.training.profiling`).

A loop runs its set-up, then the untraced window of W units (steps or
requests: record["window"]), then two traced stretches of n units each
(record["trace_counts"]), and the readers run after all of it. So the
window's records of one top-level span name are the W records of that
name before the last 2n. A port without the registry, a run without a
trace, or fewer than W + 2n records give None. A benchmark change that
resets the registry at the window's start should replace this arithmetic.
"""

from __future__ import annotations


def window_records(record: dict, name: str):
    """The window's records named `name` (see the module), or None."""
    try:
        from diffusionnet_tpu_torch.training import profiling
        snapshot = profiling.snapshot
    except (ImportError, AttributeError):
        return None
    unit = "steps" if "steps" in record["window"] else "requests"
    W = record["window"].get(unit)
    n = (record.get("trace_counts") or {}).get(unit)
    if not W or not n:
        return None
    recs = [r for r in snapshot() if r.name == name]
    if len(recs) < W + 2 * n:
        return None
    return recs[len(recs) - W - 2 * n:len(recs) - 2 * n]


def mean(values: list):
    return sum(values) / len(values) if values else None


def launch_host_us(recs) -> float | None:
    """Host microseconds a launch of the port's kernels (`launch.*`
    counters) over `recs`; None without records or launches."""
    if recs is None:
        return None
    n = s = 0
    for r in recs:
        for k, (c, sec) in r.counters.items():
            if k.startswith("launch."):
                n += c
                s += sec
    return 1e6 * s / n if n else None
