"""The trace's reduction: busy time is the union of device intervals inside
the stretch (overlaps count once), idle gaps are named by the benchmark's
span and the PyTorch op running when they begin, and the readers of the
device-trace metrics take their shares from it."""

import pytest

from dnbench import trace


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


EVENTS = [
    ev("user_annotation", "bench.stretch", 1000.0, 1000.0),
    ev("user_annotation", "bench.step", 1000.0, 600.0),
    ev("user_annotation", "bench.read", 1600.0, 400.0),
    ev("cpu_op", "aten::mm", 1010.0, 50.0),
    ev("cpu_op", "aten::item", 1600.0, 390.0),
    # two overlapping kernels, one copy, one kernel partly outside
    ev("kernel", "void (anonymous namespace)::megablock_fwd_rows_kernel"
       "(FwdArgs)", 1100.0, 200.0),
    ev("kernel", "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128>"
       "(Params)", 1200.0, 200.0),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1700.0, 100.0),
    ev("kernel", "late_kernel", 1950.0, 100.0),
    ev("kernel", "outside", 3000.0, 10.0),
]


def test_busy_is_the_union_inside_the_window():
    t = trace.reduce(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # [1100, 1400] + [1700, 1800] + [1950, 2000]
    assert t.busy_s == pytest.approx(450e-6)
    assert t.kernel_seconds("megablock_fwd_rows_kernel") == pytest.approx(
        200e-6)
    assert "outside" not in t.kernels


def test_idle_gaps_are_named_by_span_and_op():
    t = trace.reduce(EVENTS)
    gaps = dict(t.breakdown()["idle_gaps"])
    # 1000-1100 in bench.step (no op at 1000), 1400-1700 begun in
    # bench.step (aten::mm ended), 1800-1950 in bench.read/aten::item
    assert gaps["bench.step/python"] == pytest.approx(400e-6)
    assert gaps["bench.read/aten::item"] == pytest.approx(150e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_short_names_drop_arguments_and_namespaces():
    ops = dict(trace.reduce(EVENTS).breakdown()["device_ops"])
    assert "megablock_fwd_rows_kernel" in ops
    assert "cutlass::Kernel2<cutlass_80_simt_sgemm_256x128>" in ops
    assert trace.short_name("void at::native::(anonymous namespace)::"
                            "f<int>(int)") == "at::native::f<int>"


def test_device_trace_readers():
    from dnbench import spec
    t = trace.reduce(EVENTS)
    record = {"trace": t, "trace_counts": {"steps": 2, "megablock_bound_s":
                                           50e-6}}
    units = {"megablock_roofline": "%", "gemm_ms_per_step": "ms",
             "idle_share.train": "%"}
    got = spec.read_metrics(list(units), record, units)
    assert got["megablock_roofline"]["value"] == pytest.approx(25.0)
    assert got["gemm_ms_per_step"]["value"] == pytest.approx(0.1)
    assert got["idle_share.train"]["value"] == pytest.approx(55.0)
    # without a trace there is nothing to read
    assert spec.read_metrics(list(units), {"trace": None, "trace_counts": {}},
                             units) == {}


def test_window_with_no_stretch_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce(EVENTS[1:])


DEVICE_ONLY = [
    ev("kernel", "megablock_bwd_rows_kernel", 5000.0, 300.0),
    ev("kernel", "ampere_sgemm_128x64_nn", 5200.0, 200.0),
    ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 6000.0, 100.0),
    ev("cuda_runtime", "cudaLaunchKernel", 4990.0, 5.0),
]


def test_device_only_stretch_takes_its_window_from_the_host_clock():
    t = trace.reduce_device(DEVICE_ONLY, 2e-3)
    assert t.window_s == 2e-3
    # [5000, 5400] + [6000, 6100]; runtime calls are not device activity
    assert t.busy_s == pytest.approx(500e-6)
    assert t.kernel_seconds("megablock_bwd_rows_kernel") == pytest.approx(
        300e-6)
    with pytest.raises(RuntimeError):
        trace.reduce_device(DEVICE_ONLY[-1:], 2e-3)


def test_traced_measures_the_device_only_stretch(monkeypatch):
    calls = []

    def profiled(work, host_ops):
        work()
        return (EVENTS, 1e-3) if host_ops else (DEVICE_ONLY, 2e-3)
    monkeypatch.setattr(trace, "_profiled", profiled)
    t = trace.traced(calls.append)
    # the measured stretch first, without spans; then the named one
    assert calls == [False, True]
    assert (t.window_s, t.busy_s) == (2e-3, pytest.approx(500e-6))
    assert "late_kernel" not in t.kernels
    assert dict(t.breakdown()["idle_gaps"])["bench.read/aten::item"] == \
        pytest.approx(150e-6)
