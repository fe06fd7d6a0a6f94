"""Spans and counters of the port's own work, and traces of the card: the
counterpart of diffusionnet_tpu/training/profiling.py.

`span(name)` times a stretch of host work on `time.perf_counter_ns()`. The
outermost open span of a thread is a top-level span: it closes into one
`Record` (its name, id, start and duration, the nanoseconds of each span
name opened inside it, and its counters), which goes into a ring of the
last `RING` records beside running totals of every record
(`snapshot()`, `totals()`, `reset()`). A span opened in a thread with no
span of its own joins the top-level record open in another thread, if
there is one, as a span inside it; dnt.batch, dnt.step and dnt.serve
always open records of their own. (The autograd engine runs the backward
of a card's work on a thread of its own while the step's thread waits.)
`count(name, n, seconds)` adds work done, with host seconds where they are
known, to the open record, or to the totals when none is open. While a
torch.profiler session
records, each span is also a `record_function` annotation, so it sits on
the trace's timeline beside the kernels and copies it issued; with no
session a span costs a flag test, two clock reads and a few adds.

The names the port records:

    dnt.batch              the making of one batch (top level)
    dnt.step               one train step (top level), and inside it
    dnt.step.forward       the loss function
    dnt.step.backward      the backward
    dnt.step.optimizer     Adam and the learning-rate schedule
    dnt.serve              one PreparedMesh request (top level), and inside
    dnt.serve.upload       the signal's copy to the card
    dnt.serve.pad          its padding to the bucket's rows
    dnt.serve.program      the host's launch of the exported program
    dnt.serve.finish       the output's slice back to the mesh
    dnt.wait.<why>         the host blocked on the card; counts `syncs`
    dnt.ell                one `ell_matvec`, forward or backward
    dnt.fmap               the functional-map head's forward (projections,
                           systems, solve)
    launch.<kernel>        counter: launches of the port's CUDA kernels,
                           with the host seconds of each wrapper call
    upload_bytes           counter: bytes of a request's signal uploaded
    block.b4, block.dense, block.ell
                           counter: a DiffusionNet block's route
    fmap.pairs             counter: functional maps solved

`device_trace(dir)` records a torch.profiler trace of a block of work (the
host's ops and, where there is a card, its kernels and copies) into
<dir>/trace.json, for Perfetto or chrome://tracing, and beside it
<dir>/idle_by_span.json: the card's idle seconds by the innermost `dnt.*`
span open on the host when each gap began (`idle_by_span`).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 65536  # records kept in order; totals keep every record
WAIT = "dnt.wait."
TOP = ("dnt.batch", "dnt.step", "dnt.serve")  # always records of their own
SYNCS = "syncs"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")

_clock = time.perf_counter_ns
_ids = itertools.count(1)


class Record:
    """One closed top-level span: `name`, `id`, `start_ns` and `dur_ns` on
    `time.perf_counter_ns()`, `children` (span name -> nanoseconds of the
    spans of that name inside it) and `counters` (name -> [count, host
    seconds])."""

    __slots__ = ("name", "id", "start_ns", "dur_ns", "children", "counters")

    def __init__(self, name: str, id_: int, start_ns: int):
        self.name, self.id, self.start_ns = name, id_, start_ns
        self.dur_ns = 0
        self.children: dict = {}
        self.counters: dict = {}

    @property
    def seconds(self) -> float:
        return self.dur_ns * 1e-9

    def child_s(self, name: str) -> float:
        return self.children.get(name, 0) * 1e-9

    def wait_s(self) -> float:
        """Seconds the host waited on the card: the `dnt.wait.*` spans
        inside the record, or all of it when it is such a span itself."""
        if self.name.startswith(WAIT):
            return self.seconds
        return sum(ns for k, ns in self.children.items()
                   if k.startswith(WAIT)) * 1e-9

    def counter(self, name: str) -> tuple:
        """(count, host seconds) of a counter; (0, 0.0) when not counted."""
        n, s = self.counters.get(name, (0, 0.0))
        return n, s


class Registry:
    """The last `size` records in order, and totals of every record and of
    the counts made outside any record."""

    def __init__(self, size: int = RING):
        self.ring: collections.deque = collections.deque(maxlen=size)
        self.lock = threading.Lock()
        self.by_name: dict = {}
        self.loose: dict = {}

    def close(self, rec: Record) -> None:
        self.ring.append(rec)
        with self.lock:
            t = self.by_name.get(rec.name)
            if t is None:
                t = self.by_name[rec.name] = [0, 0, {}, {}]
            t[0] += 1
            t[1] += rec.dur_ns
            for k, ns in rec.children.items():
                t[2][k] = t[2].get(k, 0) + ns
            for k, (n, s) in rec.counters.items():
                _add(t[3], k, n, s)

    def add_loose(self, name: str, n: int, seconds: float) -> None:
        with self.lock:
            _add(self.loose, name, n, seconds)

    def totals(self) -> dict:
        with self.lock:
            return {
                "records": {name: {"records": n, "seconds": ns * 1e-9,
                                   "children": {k: v * 1e-9
                                                for k, v in ch.items()},
                                   "counters": {k: list(c)
                                                for k, c in co.items()}}
                            for name, (n, ns, ch, co) in self.by_name.items()},
                "counters": {k: list(c) for k, c in self.loose.items()}}


def _add(counters: dict, name: str, n: int, seconds: float) -> None:
    c = counters.get(name)
    if c is None:
        counters[name] = [n, seconds]
    else:
        c[0] += n
        c[1] += seconds


_REG = Registry()


class _Open(threading.local):
    """A thread's open spans, innermost last, and the record they time
    (`joined`: another thread's)."""

    def __init__(self):
        self.starts: list = []
        self.annotations: list = []
        self.record = None
        self.joined = False


_open = _Open()
# the latest top-level record still open, in any thread: a thread with no
# span of its own joins it (the autograd engine runs a card's backward on
# a thread of its own, while the step's thread waits for it)
_active: list = [None]


class _Span:
    """The context manager of one span name (one object a name, reused)."""

    __slots__ = ("name", "wait", "top")

    def __init__(self, name: str):
        self.name = name
        self.wait = name.startswith(WAIT)
        self.top = name in TOP

    def __enter__(self):
        t = _clock()
        o = _open
        if not o.starts:
            rec = _active[0]
            o.joined = rec is not None and not self.top
            if not o.joined:
                rec = _active[0] = Record(self.name, next(_ids), t)
            o.record = rec
        o.starts.append(t)
        if _autograd_profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        else:
            rf = None
        o.annotations.append(rf)
        return self

    def __exit__(self, *exc):
        o = _open
        rf = o.annotations.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        dt = _clock() - o.starts.pop()
        rec = o.record
        if self.wait:
            _add(rec.counters, SYNCS, 1, 0.0)
        if o.starts or o.joined:
            ch = rec.children
            ch[self.name] = ch.get(self.name, 0) + dt
        else:
            rec.dur_ns = dt
            if _active[0] is rec:
                _active[0] = None
            _REG.close(rec)
        if not o.starts:
            o.record = None
        return False


_SPANS: dict = {}


def span(name: str) -> _Span:
    """The context manager that times `name` (see the module's list)."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS.setdefault(name, _Span(name))
    return s


_NO_SPAN = contextlib.nullcontext()


def wait(name: str, device: torch.device):
    """span(name), a `dnt.wait.*` name, where `device` is a card, whose
    work the host then blocks on; no span on other devices."""
    return span(name) if device.type == "cuda" else _NO_SPAN


def count(name: str, n: int = 1, seconds: float = 0.0) -> None:
    """Add n to counter `name`, and `seconds` of host time to its seconds,
    in the open record (this thread's, else the one a span would join), or
    in the totals when none is open."""
    rec = _open.record or _active[0]
    if rec is None:
        _REG.add_loose(name, n, seconds)
    else:
        _add(rec.counters, name, n, seconds)


def since(t0_ns: int) -> float:
    """Seconds from `t0_ns`, a reading of the spans' clock, to now."""
    return (_clock() - t0_ns) * 1e-9


def snapshot() -> list:
    """The ring's records, oldest first."""
    return list(_REG.ring)


def totals() -> dict:
    """{"records": {name: {records, seconds, children: {name: seconds},
    counters: {name: [count, seconds]}}}, "counters": {the counts made
    outside any record}}, over every record since the last reset."""
    return _REG.totals()


def reset() -> None:
    """Empty the ring and the totals (open spans close into the new
    registry)."""
    global _REG
    _REG = Registry(_REG.ring.maxlen)


def _union(intervals) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_by_span(events: list, window: tuple | None = None) -> dict:
    """The card's idle seconds, keyed by the innermost `dnt.*` span open on
    the host when each gap began ("outside" when none was open).

    events: chrome-trace events (dicts with cat, name, ts and dur in
    microseconds), as torch.profiler exports them. The card is busy where
    any kernel, copy or set runs (overlaps count once); a gap is any other
    time in `window` ((start, end) in the events' microseconds; default:
    from the first to the last event of the host or the card)."""
    dev, host_spans, extent = [], [], []
    for e in events:
        cat = e.get("cat")
        if "ts" not in e or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((a, b))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and str(e.get("name", "")).startswith(
                    "dnt."):
                host_spans.append((a, b, e["name"]))
        else:
            continue
        extent.append((a, b))
    if window is None:
        if not extent:
            return {}
        window = (min(a for a, _ in extent), max(b for _, b in extent))
    w0, w1 = window
    host_spans.sort()
    starts = [s[0] for s in host_spans]
    reach = list(itertools.accumulate((s[1] for s in host_spans), max))

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and reach[i] >= t:
            if host_spans[i][1] >= t:
                return host_spans[i][2]
            i -= 1
        return "outside"

    busy = _union((max(a, w0), min(b, w1)) for a, b in dev
                  if min(b, w1) > max(a, w0))
    idle: dict = {}
    t = w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            label = innermost(t)
            idle[label] = idle.get(label, 0.0) + (a - t) * 1e-6
        t = max(t, b)
    return idle


def _sync() -> None:
    """Wait for the card's queued work, where this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace of the block (the host's ops, and the
    card's kernels and copies where there is one) into <log_dir>/trace.json
    and the card's idle seconds by `dnt.*` span into
    <log_dir>/idle_by_span.json (largest first)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    idle = idle_by_span(data["traceEvents"] if isinstance(data, dict)
                        else data)
    with open(os.path.join(log_dir, "idle_by_span.json"), "w") as f:
        json.dump(dict(sorted(idle.items(), key=lambda kv: -kv[1])), f,
                  indent=1)
