"""The cell added with the correspondence configuration, tiny on the CPU:
fmap_train through the driver's pair step agrees with the plain reference,
planted faults are not correct, a port without pair batches fails at once;
the device time by span charges kernels to the launching thread's
innermost dnt.* span, and the new readers give None where they find
nothing."""

import copy
import time

import pytest
import torch

from conftest import ROOT

CPU = torch.device("cpu")
SEED = 2 ** 31 + 203


def tiny_pairs(tmp_path):
    from dnbench import spec
    cell = copy.deepcopy(spec.load_cell(ROOT, "fmap_train"))
    cell.config["model"].update(c_width=16, c_out=16, mlp_hidden_dims=[16, 16],
                                k_eig=24, n_fmap=8, n_block=2)
    cell.config["dataset"].update(n_train=3, v_min=300, v_max=400,
                                  distinct_surfaces=2, n_vts=200)
    cell.config["fit"]["batch_pairs"] = 2
    loop = spec.loop_module(cell)
    loop.CACHE = tmp_path
    return cell, loop


def run_with(cell, loop, seconds=0.3):
    from dnbench import compare
    rec = loop.run(cell, SEED, seconds, False, CPU, time.perf_counter())
    return rec, compare.judge(rec["readings"], cell.limits)


def test_fmap_train_agrees_with_the_reference(tmp_path):
    cell, loop = tiny_pairs(tmp_path)
    rec, (_, checks) = run_with(cell, loop)
    # the CPU runs the port's plain versions: the same products in other
    # orders of summation, then f32 solves of systems whose condition
    # number is 1e3-6e3 at these sizes, which lifts the rounding to about
    # 1e-5 in the loss
    assert checks["loss_rel"]["value"] < 1e-4, checks
    # the worst leaf is read, not judged, on the card
    # (limits/fmap_train.json): at these sizes it is well within f32
    # rounding of the reference's
    assert rec["readings"]["grad_norm_gap"] < 1e-3, rec["readings"]
    assert checks["grad_norm_gap_last_mlp"]["value"] < 1e-5, checks
    assert checks["grad_norm_gap_last_spatial"]["value"] < 1e-5, checks
    w = rec["window"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert w["meshes"] == 2 * 2 * w["steps"]  # 2 pairs, 2 meshes a pair
    assert w["model_flops"] > 0


def test_a_dropped_pair_is_not_correct(tmp_path, monkeypatch):
    """The loss over the first pair of each batch only."""
    from diffusionnet_tpu_torch.experiments.functional_correspondence import \
        functional_correspondence as fc
    cell, loop = tiny_pairs(tmp_path)
    loss = fc.pair_loss
    monkeypatch.setattr(fc, "pair_loss", lambda C, gt: loss(C[:1], gt[:1]))
    _, (correct, checks) = run_with(cell, loop)
    # a sound run reads about 1e-5 here (test above)
    assert not correct and checks["loss_rel"]["value"] > 1e-2, checks


@pytest.mark.parametrize("fault,reading", [
    ("ell_transpose", "grad_norm_gap_last_spatial"),
    ("solve_rhs_only", "grad_norm_gap_last_mlp")])
def test_a_backward_fault_is_not_correct(tmp_path, monkeypatch, fault,
                                         reading):
    """A wrong backward under the right forward: the ELL product's dx by
    the operator instead of its transpose (every leaf before the last
    block's MLP moves), or the map's gradient through the right-hand side
    only, the systems detached (every leaf moves, the last MLP's and
    last_lin's too). The loss is the program's; the gradient reading is
    not (a sound run reads under 1e-5 in both)."""
    from diffusionnet_tpu_torch.models import fmaps
    from diffusionnet_tpu_torch.ops import sparse
    cell, loop = tiny_pairs(tmp_path)
    if fault == "ell_transpose":
        def backward(ctx, dy):
            idx, val, x = ctx.saved_tensors
            return None, None, sparse._ell_forward(idx, val, dy.to(x.dtype))
        monkeypatch.setattr(sparse._EllMatvec, "_backward",
                            staticmethod(backward))
    else:
        cholesky_ex = torch.linalg.cholesky_ex

        def detached(A, **kw):
            return cholesky_ex(A.detach(), **kw)
        monkeypatch.setattr(fmaps.torch.linalg, "cholesky_ex", detached)
    rec, (correct, checks) = run_with(cell, loop)
    assert checks["loss_rel"]["value"] < 1e-4, checks
    assert not correct
    assert checks[reading]["value"] > cell.limits[reading], checks


def test_a_port_without_pair_batches_fails_at_once(tmp_path, monkeypatch):
    from diffusionnet_tpu_torch.experiments.functional_correspondence import \
        functional_correspondence as fc
    cell, loop = tiny_pairs(tmp_path)
    monkeypatch.delattr(fc, "PairFeed")
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="PairFeed"):
        loop.run(cell, SEED, 0.3, False, CPU, t)
    assert time.perf_counter() - t < 5.0


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_device_time_goes_to_the_launching_threads_innermost_span():
    from dnbench import by_span
    events = [
        _event("user_annotation", "dnt.step", 0, 100),
        _event("user_annotation", "dnt.step.forward", 1, 40),
        _event("user_annotation", "dnt.ell", 5, 10),
        _event("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
        _event("cuda_runtime", "cudaLaunchKernel", 120, 1, corr=3),
        # the autograd engine's thread: its own dnt.ell span
        _event("user_annotation", "dnt.ell", 50, 10, tid=2),
        _event("cuda_runtime", "cudaLaunchKernel", 55, 1, tid=2, corr=4),
        _event("cuda_runtime", "cudaLaunchKernel", 65, 1, tid=2, corr=5),
        _event("kernel", "a", 10, 3, tid=7, corr=1),
        _event("kernel", "b", 30, 5, tid=7, corr=2),
        _event("kernel", "c", 130, 7, tid=7, corr=3),
        _event("kernel", "d", 60, 11, tid=7, corr=4),
        _event("gpu_memset", "e", 70, 13, tid=7, corr=5),
    ]
    got = by_span.device_by_span(events)
    assert got == pytest.approx({"dnt.ell": 14e-6,
                                 "dnt.step.forward": 5e-6,
                                 "outside": 20e-6})


def test_the_new_readers_find_nothing_without_the_spans():
    from diffusionnet_tpu_torch.training import profiling
    from dnbench import spec
    profiling.reset()  # the span records of runs earlier in this process
    names = ["ell_ms_per_step", "ell_roofline", "fmap_issue_ms"]
    units = {n: "x" for n in names}
    record = {"trace_counts": {"steps": 30, "span_device_s": {
        "dnt.step.forward": 0.1}, "ell_bound_s": 0.01},
        "window": {"steps": 3}}
    assert spec.read_metrics(names, record, units) == {}
    record["trace_counts"]["span_device_s"]["dnt.ell"] = 0.05
    got = spec.read_metrics(names[:2], record, units)
    assert got["ell_ms_per_step"]["value"] == pytest.approx(50 / 30)
    assert got["ell_roofline"]["value"] == pytest.approx(20.0)
