"""The port's spans and counters (diffusionnet_tpu_torch.training.profiling)
on the CPU: records, the ring and its totals, counters, waits, threads,
the profiler's annotations and their clock, the card's idle time by span,
and what the train step, the batches, fit's log and a serving call
record."""

import json
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.data import DeviceDataset, SurfaceDataset
from diffusionnet_tpu_torch.experiments import exp_common as tex
from diffusionnet_tpu_torch.models import DiffusionNet
from diffusionnet_tpu_torch.serving import export_forward, load_serving_model
from diffusionnet_tpu_torch.training import (adam_with_step_decay,
                                             apply_model, loss_and_counts,
                                             make_train_step, profiling)
from tests.meshgen import icosphere, torus
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def registry(monkeypatch):
    """A registry of its own for each test."""
    monkeypatch.setattr(profiling, "_REG", profiling.Registry())
    return profiling


def _names(recs):
    return [r.name for r in recs]


def test_nested_spans_share_their_top_level_id_and_roll_up():
    span = profiling.span
    with span("dnt.a") as outer:
        with span("dnt.a.b"):
            with span("dnt.a.b.c"):
                time.sleep(0.002)
        with span("dnt.a.b"):
            time.sleep(0.001)
    with span("dnt.z"):
        pass
    assert outer is span("dnt.a")  # one object a name
    a, z = profiling.snapshot()
    assert (a.name, z.name) == ("dnt.a", "dnt.z") and z.id > a.id
    assert set(a.children) == {"dnt.a.b", "dnt.a.b.c"}
    assert a.child_s("dnt.a.b.c") >= 0.002
    assert a.child_s("dnt.a.b") >= a.child_s("dnt.a.b.c") + 0.001
    assert a.seconds >= a.child_s("dnt.a.b")
    assert z.children == {} and a.child_s("dnt.none") == 0.0


def test_ring_keeps_the_last_records_and_totals_keep_all(monkeypatch):
    monkeypatch.setattr(profiling, "_REG", profiling.Registry(4))
    for i in range(10):
        with profiling.span("dnt.step"):
            with profiling.span("dnt.step.forward"):
                profiling.count("launch.k", 2, 0.5)
    recs = profiling.snapshot()
    assert len(recs) == 4
    assert [r.id for r in recs] == sorted(r.id for r in recs)
    t = profiling.totals()["records"]["dnt.step"]
    assert t["records"] == 10
    assert t["counters"] == {"launch.k": [20, 5.0]}
    assert t["seconds"] >= t["children"]["dnt.step.forward"] > 0
    profiling.reset()
    assert profiling.snapshot() == [] and profiling.totals()["records"] == {}


def test_counts_go_to_the_open_record_or_the_totals():
    profiling.count("launch.k", seconds=1e-6)
    with profiling.span("dnt.serve"):
        profiling.count("upload_bytes", 64)
        with profiling.span("dnt.serve.program"):
            profiling.count("launch.k", seconds=2e-6)
            profiling.count("launch.k", seconds=3e-6)
    (rec,) = profiling.snapshot()
    assert rec.counter("upload_bytes") == (64, 0.0)
    n, s = rec.counter("launch.k")
    assert n == 2 and s == pytest.approx(5e-6)
    assert rec.counter("absent") == (0, 0.0)
    assert profiling.totals()["counters"] == {"launch.k": [1, 1e-6]}


def test_wait_spans_count_syncs_and_their_seconds():
    with profiling.span("dnt.step"):
        for _ in range(2):
            with profiling.span("dnt.wait.x"):
                time.sleep(0.001)
    with profiling.span("dnt.wait.y"):
        pass
    step, y = profiling.snapshot()
    assert step.counter(profiling.SYNCS)[0] == 2
    assert step.wait_s() == pytest.approx(step.child_s("dnt.wait.x"))
    assert step.wait_s() >= 0.002
    assert y.counter(profiling.SYNCS)[0] == 1 and y.wait_s() == y.seconds
    # a wait on a device that is not a card is no span
    with profiling.wait("dnt.wait.z", torch.device("cpu")):
        pass
    assert len(profiling.snapshot()) == 2


def test_spans_of_another_thread_make_their_own_records():
    inside = threading.Event()
    go = threading.Event()

    def other():
        with profiling.span("dnt.batch"):
            profiling.count("n")
            inside.set()
            go.wait(10)

    t = threading.Thread(target=other)
    with profiling.span("dnt.step"):
        t.start()
        assert inside.wait(10)
        profiling.count("m")
        with profiling.span("dnt.step.forward"):
            pass
    go.set()
    t.join(10)
    assert not t.is_alive()
    recs = {r.name: r for r in profiling.snapshot()}
    assert set(recs) == {"dnt.step", "dnt.batch"}
    assert recs["dnt.step"].counters == {"m": [1, 0.0]}
    assert recs["dnt.batch"].counters == {"n": [1, 0.0]}
    assert recs["dnt.batch"].children == {}


def test_a_thread_with_no_span_joins_the_open_record():
    """As the autograd engine's thread does in a step's backward: its waits
    and counts go into the step's record, and once no record is open its
    spans and counts are its own again."""
    def backward():
        with profiling.span("dnt.wait.mean_degree"):
            profiling.count("launch.k", seconds=1e-6)

    with profiling.span("dnt.step"):
        with profiling.span("dnt.step.backward"):
            t = threading.Thread(target=backward)
            t.start()
            t.join(10)
    assert not t.is_alive()
    t = threading.Thread(target=backward)
    t.start()
    t.join(10)
    step, alone = profiling.snapshot()
    assert step.name == "dnt.step"
    assert set(step.children) == {"dnt.step.backward",
                                  "dnt.wait.mean_degree"}
    assert step.counter(profiling.SYNCS)[0] == 1
    assert step.counter("launch.k") == (1, 1e-6)
    assert alone.name == "dnt.wait.mean_degree"
    assert alone.counter("launch.k") == (1, 1e-6)


def test_the_face_means_degree_read_is_a_wait():
    """On a card MeanPlan's degree read waits for an event: a dnt.wait
    span and one sync of the step."""
    from diffusionnet_tpu_torch.models.diffusion_net import MeanPlan
    plan = MeanPlan(torch.tensor([[[0, 1, 2], [1, 2, 3]]]), 4)
    plan._event = mock.Mock()
    with profiling.span("dnt.step"):
        assert plan.max_degree == 2
    plan._event.synchronize.assert_called_once_with()
    (rec,) = profiling.snapshot()
    assert set(rec.children) == {"dnt.wait.mean_degree"}
    assert rec.counter(profiling.SYNCS) == (1, 0.0)


@pytest.mark.parametrize("session", [False, True])
def test_record_function_only_inside_a_profiler_session(session):
    """With no session a span never enters record_function; inside one it
    enters it once per span."""
    from torch.profiler import ProfilerActivity, profile
    with mock.patch.object(torch.profiler, "record_function") as rf:
        if session:
            with profile(activities=[ProfilerActivity.CPU]):
                with profiling.span("dnt.step"):
                    with profiling.span("dnt.step.forward"):
                        pass
        else:
            with profiling.span("dnt.step"):
                with profiling.span("dnt.step.forward"):
                    pass
    assert [c.args for c in rf.call_args_list] == (
        [("dnt.step",), ("dnt.step.forward",)] if session else [])
    assert _names(profiling.snapshot()) == ["dnt.step"]


def test_spans_sit_on_the_profiler_timeline(tmp_path):
    """Each span is a user_annotation of the trace, and starts where the
    registry says (within 1 ms) once both clocks are read from one anchor:
    an annotation entered just after a reading of the registry's clock
    (the trace's `ts` runs on the profiler's own clock, in microseconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        anchor_ns = time.perf_counter_ns()
        with record_function("anchor"):
            pass
        for _ in range(3):
            with profiling.span("dnt.step"):
                with profiling.span("dnt.step.forward"):
                    torch.ones(64).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    (anchor,) = [e["ts"] for e in ann if e["name"] == "anchor"]
    steps = sorted(e["ts"] for e in ann if e["name"] == "dnt.step")
    assert len(steps) == 3
    assert sum(e["name"] == "dnt.step.forward" for e in ann) == 3
    for ts, rec in zip(steps, profiling.snapshot()):
        got = (ts - anchor) * 1e3
        assert abs(got - (rec.start_ns - anchor_ns)) < 1e6


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.mark.parametrize("window", [None, (0.0, 150.0)])
def test_idle_by_span_names_each_gap(window):
    """Host: a cpu_op [0, 5], dnt.step [10, 60] with dnt.wait.x [40, 55]
    inside it, an annotation of another name [55, 85], dnt.batch [70, 80].
    Card: kernels [5, 20], [30, 45] and a copy [35, 50] over it, kernels
    [57, 66], [68, 72] and [85, 100]. A gap goes whole to the innermost
    dnt span open where it begins."""
    events = [
        _ev("cpu_op", "aten::mm", 0, 5),
        _ev("user_annotation", "dnt.step", 10, 50),
        _ev("user_annotation", "dnt.wait.x", 40, 15),
        _ev("user_annotation", "other", 55, 30),
        _ev("user_annotation", "dnt.batch", 70, 10),
        _ev("kernel", "k1", 5, 15),
        _ev("kernel", "k2", 30, 15),
        _ev("gpu_memcpy", "Memcpy HtoD", 35, 15),
        _ev("kernel", "k3", 57, 9),
        _ev("kernel", "k4", 68, 4),
        _ev("kernel", "k5", 85, 15),
        _ev("gpu_user_annotation", "dnt.step", 5, 95),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 60},
    ]
    idle = profiling.idle_by_span(events, window)
    want = {"outside": 5e-6 + 2e-6,  # (0, 5) and (66, 68)
            "dnt.step": 10e-6,       # (20, 30)
            "dnt.wait.x": 7e-6,      # (50, 57): the copy ran to 50
            "dnt.batch": 13e-6}      # (72, 85)
    if window is not None:
        want["outside"] += 50e-6     # (100, 150)
    assert idle.keys() == want.keys()
    for k, v in want.items():
        assert idle[k] == pytest.approx(v), k
    assert profiling.idle_by_span([]) == {}


def test_device_trace_writes_the_idle_seconds_by_span(tmp_path):
    with profiling.device_trace(str(tmp_path / "tr")):
        with profiling.span("dnt.step"):
            torch.ones(8).sum()
    with open(tmp_path / "tr" / "idle_by_span.json") as f:
        idle = json.load(f)
    # on the CPU there is no card: all of the trace is idle
    assert idle and all(v >= 0 for v in idle.values())
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


@pytest.fixture(scope="module")
def small_ds():
    ds = SurfaceDataset(labels_kind="global")
    for i in range(5):
        v, f = icosphere(1) if i % 2 == 0 else torus(8, 6)
        ds.add(v, f, i % 2)
    ds.precompute(k_eig=8, verbose=False, eigensolver="host", device="cpu")
    return ds


def _model():
    return tex.build_model(n_class=2, c_width=8, outputs_at="global_mean",
                           dropout=False, input_features="xyz", n_block=2)


def test_train_step_and_batches_record_their_spans(small_ds):
    cfg = tex.FitConfig(n_epoch=1, batch_size=2, input_features="xyz",
                        labels_kind="global")
    tcfg = tex.task_config(cfg)
    model = _model()
    from diffusionnet_tpu_torch.models import flat_params
    params = flat_params(model, "cpu", requires_grad=True)
    opt = adam_with_step_decay(1e-3)
    state = opt.init(params)

    def loss_fn(p, batch, generator):
        preds = apply_model(model, p, batch, generator, tcfg,
                            deterministic=False)
        return loss_and_counts(preds, batch, tcfg)

    step = make_train_step(loss_fn, opt)
    batches = DeviceDataset(small_ds, device="cpu").batches(2, shuffle=True)
    batch = next(batches)
    step(params, state, batch, torch.Generator().manual_seed(0))
    batch_rec, step_rec = profiling.snapshot()
    assert batch_rec.name == "dnt.batch" and batch_rec.seconds > 0
    assert step_rec.name == "dnt.step" and step_rec.id > batch_rec.id
    assert set(step_rec.children) == {"dnt.step.forward",
                                      "dnt.step.backward",
                                      "dnt.step.optimizer"}
    assert all(v > 0 for v in step_rec.children.values())
    assert step_rec.seconds >= sum(step_rec.children.values()) * 1e-9
    assert len(list(batches)) == 2  # 5 surfaces: 3 batches, one a span
    assert _names(profiling.snapshot()) == ["dnt.batch", "dnt.step",
                                            "dnt.batch", "dnt.batch"]


def test_fit_logs_each_epochs_split(small_ds, tmp_path):
    log = tmp_path / "log.jsonl"
    tex.fit(_model(), small_ds, small_ds,
            tex.FitConfig(n_epoch=2, batch_size=2, input_features="xyz",
                          labels_kind="global", device_data=True),
            verbose=False, log_path=str(log), device="cpu")
    lines = [json.loads(s) for s in log.read_text().splitlines()]
    assert len(lines) == 2
    for line in lines:
        # on the CPU the host never waits on a card
        assert line["issue_ms_per_step"] > 0
        assert line["wait_ms_per_step"] == 0 and line["syncs_per_step"] == 0
    steps = [r for r in profiling.snapshot() if r.name == "dnt.step"]
    assert len(steps) == 6  # 3 a epoch
    assert tex.step_split([]) == dict(issue_ms_per_step=None,
                                      wait_ms_per_step=None,
                                      syncs_per_step=None)


def test_step_split_counts_the_reads_after_the_step():
    rec = profiling.Record("dnt.step", 1, 0)
    rec.dur_ns, rec.children = 10_000_000, {"dnt.wait.a": 4_000_000,
                                            "dnt.step.forward": 6_000_000}
    rec.counters = {profiling.SYNCS: [1, 0.0]}
    read = profiling.Record("dnt.wait.step_reads", 2, 0)
    read.dur_ns, read.counters = 2_000_000, {profiling.SYNCS: [1, 0.0]}
    other = profiling.Record("dnt.batch", 3, 0)
    other.dur_ns = 5_000_000
    got = tex.step_split([rec, read, other])
    assert got["issue_ms_per_step"] == pytest.approx(6.0)
    assert got["wait_ms_per_step"] == pytest.approx(6.0)
    assert got["syncs_per_step"] == 2


def test_prepared_mesh_call_records_serve(tmp_path):
    K, V, bucket = 8, 100, 128
    model = DiffusionNet(c_in=3, c_out=4, c_width=8, n_block=1,
                         dropout=False, outputs_at="vertices")
    export_forward(model, v_buckets=(bucket,), out_dir=str(tmp_path),
                   k_eig=K)
    sm = load_serving_model(str(tmp_path), device="cpu")
    rs = np.random.RandomState(0)
    handle = sm.prepare(rs.rand(V).astype(np.float32),
                        np.sort(rs.rand(K)).astype(np.float32),
                        *(rs.randn(V, K).astype(np.float32)
                          for _ in range(3)))
    profiling.reset()
    x = rs.randn(V, 3).astype(np.float32)
    out = handle(x)
    assert out.shape == (V, 4)
    handle(torch.from_numpy(x))  # already on the device: nothing uploaded
    first, second = profiling.snapshot()
    assert first.name == second.name == "dnt.serve"
    parts = {"dnt.serve.upload", "dnt.serve.pad", "dnt.serve.program",
             "dnt.serve.finish"}
    assert set(first.children) == parts == set(second.children)
    assert first.counter("upload_bytes") == (V * 3 * 4, 0.0)
    assert second.counter("upload_bytes") == (0, 0.0)
    assert first.counter(profiling.SYNCS) == (0, 0.0)  # no card
    assert first.seconds >= sum(first.children.values()) * 1e-9
