"""Device time by the port's own spans: `trace.traced`'s two stretches,
and the card's time of each kernel, copy and set of the second stretch
(the one that records the host's ops) charged to the innermost `dnt.*`
annotation open on the host thread that launched it. A launch (a CUDA
runtime or driver call) and its device activity share a correlation id;
the launch's start and thread find the annotation. Device activity whose
launch sits in no `dnt.*` annotation is charged to "outside".
"""

from __future__ import annotations

import bisect
import itertools
import sys

from dnbench import trace as tr

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def device_by_span(events: list, prefix: str = "dnt.") -> dict:
    """{span name: device seconds} over chrome-trace `events` (see the
    module)."""
    spans: dict = {}
    for e in events:
        if (e.get("cat") == "user_annotation" and "dur" in e
                and str(e.get("name", "")).startswith(prefix)):
            spans.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    index = {}
    for tid, s in spans.items():
        s.sort()
        reach = list(itertools.accumulate((b for _, b, _ in s), max))
        index[tid] = ([a for a, _, _ in s], reach, s)

    def innermost(tid, t):
        if tid not in index:
            return "outside"
        starts, reach, s = index[tid]
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and reach[i] >= t:
            if s[i][1] >= t:
                return s[i][2]
            i -= 1
        return "outside"

    owner = {e["args"]["correlation"]: innermost(e.get("tid"), e["ts"])
             for e in events if e.get("cat") in LAUNCH_CATS
             and _correlation(e) is not None}
    out: dict = {}
    for e in events:
        if e.get("cat") not in tr.DEVICE_CATS or "dur" not in e:
            continue
        name = owner.get(_correlation(e), "outside")
        out[name] = out.get(name, 0.0) + e["dur"] * 1e-6
    return out


def traced(work) -> tuple:
    """(trace.Trace, {span name: device seconds}): work(spans) twice, as
    `trace.traced` runs it; the device time by span comes from the second
    stretch."""
    measured = tr.reduce_device(*tr._profiled(lambda: work(False), False))
    events, _ = tr._profiled(lambda: work(True), True)
    named = tr.reduce(events)
    measured.idle_by_host = named.idle_by_host
    by_span = device_by_span(events)
    print(f"trace: busy {measured.busy_s:.4f} s of {measured.window_s:.4f} "
          f"s measured; {named.busy_s:.4f} s of {named.window_s:.4f} s with "
          "the host's ops recorded; device s by span "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(by_span.items())),
          file=sys.stderr)
    return measured, by_span
