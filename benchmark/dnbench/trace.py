"""Two bounded stretches of work under torch.profiler, reduced to what the
per-layer readers and the result's `breakdown` need.

The first stretch records the card's activity alone, so the host runs as
fast as it does untraced: its wall time on the host's clock (the card
synchronised before and after) is the traced window, and device activity
is every kernel, copy and set on the card's timeline; busy time is the
union of their intervals (kernels that overlap count once). The second
stretch, inside a `bench.stretch` annotation, also records the host's
PyTorch ops, only to name the idle gaps: a gap is named by what the host
was doing when it began, the benchmark's own innermost span (`bench.*`)
and the innermost PyTorch op then running. Recording the ops slows the
host, so that stretch's gaps are longer than the first's.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: dict = field(default_factory=dict)  # short name -> seconds
    kernels: dict = field(default_factory=dict)     # full name -> seconds
    idle_by_host: dict = field(default_factory=dict)  # label -> seconds

    def top(self, d: dict, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top(self.device_ops),
                "idle_gaps": self.top(self.idle_by_host)}

    def kernel_seconds(self, *fragments: str) -> float:
        """Device seconds of kernels whose name holds one of `fragments`."""
        return sum(s for k, s in self.kernels.items()
                   if any(f in k for f in fragments))


def short_name(name: str) -> str:
    """A kernel's name without its argument list (and `void `), at most
    96 characters."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:96]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(events, starts, t, look_back: int = 256):
    """The name of the latest-starting event of `events` (sorted by start;
    `starts` their starts) that contains time t, looking back over at most
    `look_back` events; None if none does."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(events[max(0, i - look_back):i]):
        if b >= t:
            return name
    return None


def _device(events: list, w0: float, w1: float) -> tuple:
    """The device intervals of `events` clipped to [w0, w1] (microseconds),
    and their seconds by short and by full kernel name."""
    dev, ops, kernels = [], {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        dev.append((a, b))
        s = (b - a) * 1e-6
        short = short_name(e["name"])
        ops[short] = ops.get(short, 0.0) + s
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + s
    return dev, ops, kernels


def reduce_device(events: list, window_s: float) -> Trace:
    """A Trace of a stretch that recorded device activity alone, every
    event of it inside the stretch, whose wall time was `window_s`."""
    dev, ops, kernels = _device(events, -math.inf, math.inf)
    if not dev:
        raise RuntimeError("the trace holds no device activity")
    return Trace(window_s=window_s,
                 busy_s=sum(b - a for a, b in _union(dev)) * 1e-6,
                 device_ops=ops, kernels=kernels)


def reduce(events: list) -> Trace:
    """A Trace from chrome-trace events (dicts with cat, name, ts, dur in
    microseconds) of a stretch inside a `bench.stretch` annotation that
    recorded the host's ops as well."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == "bench.stretch"]
    if not win:
        raise RuntimeError("the trace holds no bench.stretch annotation")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev, ops, kernels = _device(events, w0, w1)
    busy = _union(dev)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("bench.")
                   and e.get("name") != "bench.stretch")
    cpu_ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "cpu_op")
    span_starts = [s[0] for s in spans]
    op_starts = [s[0] for s in cpu_ops]
    idle, t = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            span = _innermost(spans, span_starts, t, len(spans))
            op = _innermost(cpu_ops, op_starts, t)
            label = f"{span or 'bench.stretch'}/{op or 'python'}"
            idle[label] = idle.get(label, 0.0) + (a - t) * 1e-6
        t = max(t, b)
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 device_ops=ops, kernels=kernels, idle_by_host=idle)


def _profiled(work, host_ops: bool) -> tuple:
    """work() under the profiler, the card synchronised before and after:
    (chrome-trace events, wall seconds of work and the last sync)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function("bench.stretch"):
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return (data["traceEvents"] if isinstance(data, dict) else data), wall


def traced(work) -> Trace:
    """work(spans) twice: first with spans False under a device-only
    profile (busy time, window, device ops, kernels), then with spans True
    under a profile of the host's ops too (the idle gaps' names)."""
    measured = reduce_device(*_profiled(lambda: work(False), False))
    named = reduce(_profiled(lambda: work(True), True)[0])
    measured.idle_by_host = named.idle_by_host
    print(f"trace: busy {measured.busy_s:.4f} s of {measured.window_s:.4f} "
          f"s measured; {named.busy_s:.4f} s of {named.window_s:.4f} s with "
          "the host's ops recorded", file=sys.stderr)
    return measured
