"""The port's functional_correspondence driver and dataset against the JAX
package's on the CPU (the split of tests/test_torch_experiments.py; its
helpers are tests/torch_experiments_common.py): the dataset and C_gt, the
--evaluate test loss on the reference's faust_hks.npz, one epoch and a
resume, and a SIGTERM at a pair boundary resumed bit-equal."""

import json
import os
import re
import shutil
import signal

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.experiments import layouts
from diffusionnet_tpu_torch.experiments.functional_correspondence import (
    faust_scape_dataset as t_fmaps_ds, functional_correspondence as t_fmaps)
from tests.torch_experiments_common import (FAUST_HKS, jax_module, mesh,
                                            run_jax, train_and_resume)
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def fmaps(tmp_path_factory):
    """Five 642-vertex shapes (3 train, 2 test) with 40-sample .vts files;
    the JAX --evaluate on the reference's faust_hks.npz at k 128, then the
    JAX train and test datasets."""
    root = layouts.fmaps(str(tmp_path_factory.mktemp("fmaps") / "data"),
                         [mesh(60 + i, subdivisions=3) for i in range(5)],
                         n_vts=40, seed=300)
    out = run_jax(jax_module("functional_correspondence",
                             "functional_correspondence"),
                  ["--evaluate", "--load_model", FAUST_HKS, "--k_eig", "128",
                   "--n_fmap", "30", "--n_feat", "128", "--n_train", "3",
                   "--n_test", "2", "--data_dir", root])
    j_ds = jax_module("functional_correspondence", "faust_scape_dataset")
    sets = {t: j_ds.FaustScapeDataset(root, train=t, k_eig=128, n_fmap=30,
                                      op_cache_dir=os.path.join(root,
                                                                "op_cache"),
                                      n_train=3, n_test=2)
            for t in (True, False)}
    return root, out, sets


@pytest.mark.parametrize("train", [True, False])
def test_fmaps_dataset_matches_jax(fmaps, train):
    root, _, j = fmaps
    stages = {}
    ds = t_fmaps_ds.FaustScapeDataset(
        root, train=train, k_eig=128, n_fmap=30,
        op_cache_dir=os.path.join(root, "op_cache"), n_train=3, n_test=2,
        device="cpu", timings=stages)
    assert stages == {}
    jd = j[train]
    assert ds.combinations == jd.combinations
    assert ds.combinations == ([(0, 1), (0, 2), (1, 0), (1, 2), (2, 0),
                                (2, 1)] if train else [(3, 4)])
    assert ds.names_list == jd.names_list
    for name in ("verts_list", "faces_list", "vts_list"):
        for a, b in zip(getattr(ds, name), getattr(jd, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for idx in range(len(ds)):
        i1, i2, C = ds[idx]
        assert (i1, i2) == jd[idx][:2]
        np.testing.assert_allclose(C, jd[idx][2], rtol=0, atol=1e-5)


def test_fmaps_evaluate_pretrained_matches_jax(fmaps):
    """The reference's faust_hks.npz (n_feat 128, k 128, n_fmap 30), picked
    up by --evaluate as the JAX driver picks it: the same test loss (rtol
    1e-4) and geodesic error."""
    root, out, _ = fmaps
    res = t_fmaps.main(["--evaluate", "--k_eig", "128", "--n_fmap", "30",
                        "--n_feat", "128", "--n_train", "3", "--n_test", "2",
                        "--data_dir", root, "--device", "cpu"])
    (loss, geo), = re.findall(
        r"Overall test loss: (\S+)  geodesic error: (\S+)", out)
    assert abs(res["test_loss"] - float(loss)) <= 1e-4 * float(loss)
    assert abs(res["geodesic_error"] - float(geo)) <= 1e-4 * float(geo)
    assert res["precompute_stages"] == {}


FMAPS_TRAIN = ["--k_eig", "16", "--n_fmap", "8", "--n_feat", "16",
               "--n_train", "3", "--n_test", "2", "--device", "cpu",
               "--geodesic_method", "graph"]


@pytest.mark.parametrize("device_data", [False, True])
def test_fmaps_trains_and_resumes(fmaps, device_data):
    root = fmaps[0]
    res = train_and_resume(
        t_fmaps.main, FMAPS_TRAIN + ["--data_dir", root]
        + (["--device_data"] if device_data else []),
        os.path.join(root, "saved_models", "faust_hks"))
    (line,) = res["log"]
    assert line["epoch"] == 0 and np.isfinite(line["train_loss"])


@pytest.mark.parametrize("stop_after,stopped_at", [(10, (1, 4)),
                                                   (6, (0, 6))])
def test_fmaps_sigterm_at_a_pair_and_resume_is_exact(fmaps, tmp_path,
                                                     monkeypatch, stop_after,
                                                     stopped_at):
    """xyz features with rotations and dropout: a run stopped by SIGTERM
    after training pair `stop_after` (epoch 1's pair 4, or epoch 0's last
    pair) and resumed from its checkpoint ends with the uninterrupted run's
    weights bit for bit. A resume that lands on the end of an epoch replays
    it with no pairs and logs its train_loss as null."""
    runs = {}
    for name in ("whole", "stopped"):
        runs[name] = str(tmp_path / name)
        shutil.copytree(fmaps[0], runs[name],
                        ignore=shutil.ignore_patterns("saved_models"))
    argv = FMAPS_TRAIN + ["--input_features", "xyz", "--n_epoch", "2"]
    whole = t_fmaps.main(argv + ["--data_dir", runs["whole"]])

    calls = []
    make = t_fmaps.make_train_step

    def signalling(loss_fn, optimizer):
        step = make(loss_fn, optimizer)

        def wrapped(*a):
            out = step(*a)
            calls.append(1)
            if len(calls) == stop_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped
    with monkeypatch.context() as m:
        m.setattr(t_fmaps, "make_train_step", signalling)
        stopped = t_fmaps.main(argv + ["--data_dir", runs["stopped"]])
    assert stopped["stopped"] == stopped_at
    ckpt = os.path.join(runs["stopped"], "saved_models", "faust_xyz_ckpt")
    resumed = t_fmaps.main(argv + ["--data_dir", runs["stopped"],
                                   "--resume_from", ckpt])
    assert sorted(resumed["params"]) == sorted(whole["params"])
    for k, v in whole["params"].items():
        assert torch.equal(resumed["params"][k], v), k
    log = [json.loads(x) for x in open(os.path.join(
        runs["stopped"], "saved_models", "faust_xyz_log.jsonl"))]
    assert [x["epoch"] for x in log] == [0, 1]
    for key in ("test_loss", "test_geodesic_error"):
        assert log[1][key] == whole["log"][1][key]
    assert (log[0]["train_loss"] is None) == (stopped_at == (0, 6))


def test_fmaps_pair_batches_stop_and_resume_exactly(fmaps, tmp_path,
                                                    monkeypatch):
    """--batch_pairs 4 on the 6 training pairs (a step of 4, then one of
    2), xyz features with rotations and dropout: a run stopped by SIGTERM
    after its first step resumes at pair 4 and ends with the uninterrupted
    run's weights bit for bit; every logged train loss is finite."""
    runs = {}
    for name in ("whole", "stopped"):
        runs[name] = str(tmp_path / name)
        shutil.copytree(fmaps[0], runs[name],
                        ignore=shutil.ignore_patterns("saved_models"))
    argv = FMAPS_TRAIN + ["--input_features", "xyz", "--n_epoch", "2",
                          "--batch_pairs", "4"]
    whole = t_fmaps.main(argv + ["--data_dir", runs["whole"]])
    assert all(np.isfinite(x["train_loss"]) for x in whole["log"])
    make = t_fmaps.make_train_step

    def signalling(loss_fn, optimizer):
        step = make(loss_fn, optimizer)

        def wrapped(*a):
            out = step(*a)
            os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped
    with monkeypatch.context() as m:
        m.setattr(t_fmaps, "make_train_step", signalling)
        stopped = t_fmaps.main(argv + ["--data_dir", runs["stopped"]])
    assert stopped["stopped"] == (0, 4)
    ckpt = os.path.join(runs["stopped"], "saved_models", "faust_xyz_ckpt")
    resumed = t_fmaps.main(argv + ["--data_dir", runs["stopped"],
                                   "--resume_from", ckpt])
    for k, v in whole["params"].items():
        assert torch.equal(resumed["params"][k], v), k
