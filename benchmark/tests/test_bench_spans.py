"""The readers of the port's own spans and counters (metrics/ that read
`diffusionnet_tpu_torch.training.profiling` through dnbench/spans.py), on
a synthetic record and registry: each takes exactly the W records of its
span name before the last 2n, and gives None with fewer, without a
traced stretch, or without the port's registry."""

import pytest

from dnbench import spec
from diffusionnet_tpu_torch.training import profiling

W, N = 3, 2
TRAIN = ["data_ms_per_step", "step_issue_ms", "step_wait_ms",
         "syncs_per_step", "launch_host_us.train"]
SERVE = ["launch_host_us.serve", "upload_ms_per_request",
         "program_ms_per_request"]


def _rec(name, ms, children=(), counters=()):
    r = profiling.Record(name, 0, 0)
    r.dur_ns = int(ms * 1e6)
    r.children = {k: int(v * 1e6) for k, v in children}
    r.counters = {k: list(v) for k, v in counters}
    return r


def _fill(reg, n_before, make):
    """n_before set-up records, then W window records, then 2N traced,
    each unit's `make(i, in_window)` records in order."""
    total = n_before + W + 2 * N
    for i in range(total):
        for r in make(i, n_before <= i < n_before + W):
            reg.close(r)


def _train(i, win):
    """Window steps: 10 ms with 4 ms of waits in 2 syncs, 3 launches of
    30 us; batches 0.5 ms. Other steps: 99 ms, one wait of 50 ms, one
    launch of 1 ms; batches 9 ms."""
    if win:
        return [_rec("dnt.batch", 0.5),
                _rec("dnt.step", 10.0,
                     [("dnt.step.forward", 6.0), ("dnt.wait.a", 1.0),
                      ("dnt.wait.b", 3.0)],
                     [("syncs", (2, 0.0)), ("launch.k1", (2, 60e-6)),
                      ("launch.k2", (1, 30e-6))]),
                _rec("dnt.wait.step_reads", 1.0, [], [("syncs", (1, 0.0))])]
    return [_rec("dnt.batch", 9.0),
            _rec("dnt.step", 99.0, [("dnt.wait.a", 50.0)],
                 [("syncs", (1, 0.0)), ("launch.k1", (1, 1e-3))])]


def _serve(i, win):
    if win:
        return [_rec("dnt.serve", 8.0,
                     [("dnt.serve.upload", 1.5), ("dnt.wait.upload", 1.4),
                      ("dnt.serve.pad", 0.2), ("dnt.serve.program", 5.0),
                      ("dnt.serve.finish", 0.1)],
                     [("upload_bytes", (1000, 0.0)),
                      ("launch.spectral_apply", (4, 80e-6)),
                      ("syncs", (1, 0.0))])]
    return [_rec("dnt.serve", 80.0, [("dnt.serve.upload", 30.0),
                                     ("dnt.serve.program", 40.0)],
                 [("launch.spectral_apply", (4, 4e-3))])]


def _read(names, record):
    units = {n: "x" for n in names}
    got = spec.read_metrics(names, record, units)
    return {k: v["value"] for k, v in got.items()}


@pytest.fixture
def reg(monkeypatch):
    r = profiling.Registry()
    monkeypatch.setattr(profiling, "_REG", r)
    return r


TRAIN_RECORD = {"window": {"steps": W}, "trace_counts": {"steps": N}}
SERVE_RECORD = {"window": {"requests": W}, "trace_counts": {"requests": N}}


def test_train_readers_take_the_window_steps(reg):
    _fill(reg, 5, _train)
    got = _read(TRAIN, TRAIN_RECORD)
    assert got.keys() == set(TRAIN)
    assert got["data_ms_per_step"] == pytest.approx(0.5)
    assert got["step_issue_ms"] == pytest.approx(6.0)
    assert got["step_wait_ms"] == pytest.approx(4.0)
    assert got["syncs_per_step"] == pytest.approx(2.0)
    assert got["launch_host_us.train"] == pytest.approx(30.0)


def test_serve_readers_take_the_window_requests(reg):
    _fill(reg, 16, _serve)
    got = _read(SERVE, SERVE_RECORD)
    assert got == pytest.approx({"launch_host_us.serve": 20.0,
                                 "upload_ms_per_request": 1.5,
                                 "program_ms_per_request": 5.0})


@pytest.mark.parametrize("names, record, make", [
    (TRAIN, TRAIN_RECORD, _train), (SERVE, SERVE_RECORD, _serve)])
def test_readers_give_nothing_with_too_few_records(reg, names, record,
                                                   make):
    """W + 2N - 1 records: the window is not all there."""
    for i in range(W + 2 * N - 1):
        for r in make(i, True):
            reg.close(r)
    assert _read(names, record) == {}


@pytest.mark.parametrize("names, record", [
    (TRAIN, {"window": {"steps": W}, "trace_counts": {}}),
    (SERVE, {"window": {"requests": W}, "trace_counts": {}})])
def test_readers_give_nothing_without_a_trace(reg, names, record):
    _fill(reg, 5, _train)
    _fill(reg, 5, _serve)
    assert _read(names, record) == {}


def test_readers_give_nothing_without_the_ports_registry(reg, monkeypatch):
    """A port that keeps no records (no `snapshot`), as before it had any."""
    _fill(reg, 5, _train)
    monkeypatch.delattr(profiling, "snapshot")
    assert _read(TRAIN + SERVE, TRAIN_RECORD) == {}


def test_launch_reader_gives_nothing_without_launches(reg):
    _fill(reg, 0, lambda i, win: [_rec("dnt.step", 5.0)])
    got = _read(TRAIN, TRAIN_RECORD)
    assert "launch_host_us.train" not in got
    assert got["syncs_per_step"] == 0 and got["step_wait_ms"] == 0
