"""The port's `fit` over several ranks on the CPU: 4 spawned processes over
gloo (`parallel.launch`; the ranks are tests/torch_parallel_workers.py's
`fit_rank`), run once for the module, against the JAX package's fit tests
(tests/test_parallel.py) and against one process's `fit` here.

Checked: data parallelism (with and without device_data) and the
(data 2, vert 2) route learn as the JAX package's tests require, and with
dropout off their histories and weights follow one process's run; a
(4, 1) mesh_shape is data parallelism; a run stopped after epoch 0 and
resumed ends bit-identical to the uninterrupted run on every rank (dropout
and rotations on); rank 0 alone writes the log and the checkpoints; a
SIGTERM that reaches one rank stops every rank at the same epoch. Also the
routing errors, raised before any rank is needed."""

import json
import os

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.experiments.exp_common import fit
from diffusionnet_tpu_torch.parallel import launch
from tests import torch_parallel_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The datasets' operators cached here first (the ranks load them),
    then the 4-rank world."""
    cache = str(tmp_path_factory.mktemp("op_cache"))
    W.global_dataset(cache)
    W.vertex_dataset(cache)
    workdir = str(tmp_path_factory.mktemp("fits"))
    ranks = launch(W.fit_rank, 4, (cache, workdir), timeout_s=600,
                   workdir=str(tmp_path_factory.mktemp("ranks")))
    return cache, workdir, ranks


def _single(tmp, model, ds, cfg):
    """One process's fit: its weights, history and logged train losses."""
    log = os.path.join(tmp, "single.jsonl")
    params, hist, _ = fit(model, ds, ds, cfg, verbose=False, device="cpu",
                          log_path=log)
    return ({k: v.detach().numpy() for k, v in params.items()}, hist,
            _losses(log))


def _losses(log):
    with open(log) as f:
        return np.asarray([json.loads(x)["train_loss"] for x in f])


def _follows(ranks, name, workdir, want, whist, wloss, acc_atol):
    """The ranks' run against one process's: the accuracies each epoch
    within acc_atol, the train loss logged each epoch within rtol 1e-3,
    the weights within 1e-3 of their norm as one vector and each tensor
    within 1e-2 of its own. Adam's first steps divide each gradient entry
    by its own magnitude, so an entry whose gradient nearly cancels over
    the batch (A_im's) moves by up to lr on rounding alone; the two sum
    the same terms in other orders."""
    hist = ranks[0][name + "/history"]
    np.testing.assert_allclose(hist[:, 1:], np.asarray(
        [(a, t) for _, a, t in whist]), atol=acc_atol)
    np.testing.assert_allclose(_losses(os.path.join(workdir,
                                                    name + ".jsonl")),
                               wloss, rtol=1e-3)
    got = _params(ranks[0], name)
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= 1e-3
    for k in want:
        assert (np.linalg.norm(got[k] - want[k])
                <= 1e-2 * np.linalg.norm(want[k]) + 1e-6), k


def _params(rank, name):
    p = name + "/param/"
    return {k[len(p):]: v for k, v in rank.items() if k.startswith(p)}


@pytest.mark.parametrize("name", ["dp", "dp_device"])
def test_fit_data_parallel_learns_and_follows_one_process(fits, name,
                                                          tmp_path):
    """data_parallel over 4 ranks (batch 8, 2 a rank), the JAX test's
    configuration: train accuracy >= 0.9 after 8 epochs; every rank the
    same weights; against one process's fit (`_follows`), the accuracies
    each epoch within one of the 16 samples (one label a sample, so each
    rank's mean loss weighs its samples as the whole batch's does)."""
    cache, workdir, ranks = fits
    hist = ranks[0][name + "/history"]
    assert hist[-1][1] >= 0.9, hist
    for r in ranks:
        assert str(r[name + "/hash"]) == str(ranks[0][name + "/hash"])
    _follows(ranks, name, workdir, *_single(
        tmp_path, W.global_model(), W.global_dataset(cache),
        W.dp_config(data_parallel=False, device_data=name == "dp_device")),
        acc_atol=1.5 / 16)


def test_fit_mesh_shape_data_only_routes_to_dp(fits):
    """mesh_shape (4, 1) is data parallelism over the 4 ranks: batch 6
    fails its divisibility check (as in the JAX package's test)."""
    for r in fits[2]:
        assert "not divisible" in str(r["dp_mesh/error"])


def test_fit_two_axis_learns_and_follows_one_process(fits, tmp_path):
    """mesh_shape (2, 2) on the JAX test's vertex dataset (162 vertices a
    surface; buckets (200,) rounded to (256,), so both shards of a surface
    hold real vertices): train accuracy >= 0.85 after 6 epochs, evaluate
    over the ranks equal to the last test accuracy; the same weights on
    every rank; against one process's fit on the (256,) bucket
    (`_follows`; the objective is the same masked mean), the accuracies
    each epoch within one vertex of 648."""
    cache, workdir, ranks = fits
    hist = ranks[0]["ta/history"]
    assert hist[-1][1] >= 0.85, hist
    assert float(ranks[0]["ta/evaluate"]) == hist[-1][2]
    for r in ranks:
        assert str(r["ta/hash"]) == str(ranks[0]["ta/hash"])
    _follows(ranks, "ta", workdir, *_single(
        tmp_path, W.vertex_model(), W.vertex_dataset(cache),
        W.two_axis_config(mesh_shape=None, buckets=(256,))),
        acc_atol=1.5 / 648)


@pytest.mark.parametrize("name", ["ta_drop", "dp_drop"])
def test_fit_sharded_resume_is_bit_identical(fits, name):
    """Dropout and rotations on: 1 epoch, then resume_from its checkpoint
    to epoch 2, equals the uninterrupted 2 epochs bit for bit on every
    rank; the log has one line an epoch (rank 0's alone)."""
    _, workdir, ranks = fits
    for r in ranks:
        assert str(r[name + "_resumed/hash"]) == str(r[name + "_whole/hash"])
        assert str(r[name + "_whole/hash"]) == str(ranks[0][name +
                                                            "_whole/hash"])
    for run, epochs in (("_whole", [0, 1]), ("_first", [0]),
                        ("_resumed", [1])):
        with open(os.path.join(workdir, name + run + ".jsonl")) as f:
            assert [json.loads(x)["epoch"] for x in f] == epochs
    assert sorted(os.listdir(os.path.join(workdir, name + "_first_ckpt"))) \
        == ["step_0.npz"]


def test_fit_sigterm_on_one_rank_stops_every_rank(fits):
    """graceful_sigterm, n_epoch 3: SIGTERM reaches rank 1 alone during
    epoch 0; every rank leaves after epoch 0 (none hangs in a collective)
    and the preemption checkpoint of epoch 0 is written once."""
    _, workdir, ranks = fits
    for r in ranks:
        assert [int(e) for e in r["stop/history"][:, 0]] == [0]
        assert str(r["stop/hash"]) == str(ranks[0]["stop/hash"])
    assert os.listdir(os.path.join(workdir, "stop_ckpt")) == ["step_0.npz"]


def test_fit_routing_errors_before_any_rank():
    """The JAX fit's envelope checks, which need no process group: a
    (data, vert) mesh without the megakernel, and malformed axes."""
    cfg = W.two_axis_config(use_megakernel=False)
    with pytest.raises(ValueError, match="use_megakernel"):
        fit(W.vertex_model(), None, None, cfg, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="mesh_shape"):
        fit(W.vertex_model(), None, None, W.two_axis_config(mesh_shape=(0, 2)),
            verbose=False, device="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        fit(W.global_model(), None, None, W.dp_config(), verbose=False,
            device="cpu")
