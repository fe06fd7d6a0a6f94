"""Timing and tracing: the counterpart of
diffusionnet_tpu/training/profiling.py.

StageTimer accumulates host seconds per named stage; slope_throughput
measures a chained step's rate by the slope of two run lengths, with the
card synchronised before each clock read; device_trace records a
torch.profiler trace. No measurement here depends on the profiler's device
events: on one H100 run they came back empty.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulating named stage timer for host pipelines.

    with timer.stage("eigendecomposition"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<32} {total:8.3f}s  x{self.counts[name]}")
        return "\n".join(lines)


def _sync() -> None:
    """Wait for the card's queued work, where this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace of the block (the CPU, and the card
    where there is one) and write it to <log_dir>/trace.json (Perfetto,
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def slope_throughput(step_fn, state, n1: int = 4, n2: int = 12):
    """Steps per second of a chained step_fn(state) -> (state, scalar) by
    the slope method: wall clock of n2 against n1 chained steps, the card
    synchronised and the last scalar read before each clock read. The slope
    cancels the fixed costs of starting and ending a run. Returns (rate,
    state)."""
    state, out = step_fn(state)
    float(out)

    def run(n, state):
        _sync()
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            state, out = step_fn(state)
        float(out)
        _sync()
        return time.perf_counter() - t0, state

    t1, state = run(n1, state)
    t2, state = run(n2, state)
    per_step = max((t2 - t1) / (n2 - n1), 1e-12)
    return 1.0 / per_step, state
