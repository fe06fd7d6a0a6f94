"""The port's classification_shrec11 driver and datasets against the JAX
package's on the CPU (the split of tests/test_torch_experiments.py; its
helpers are tests/torch_experiments_common.py): the split under one
np.random.seed and the datasets bit-equal, one epoch and a resume."""

import os

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.experiments import layouts
from diffusionnet_tpu_torch.experiments.classification_shrec11 import (
    classification_shrec11 as t_shrec, shrec11_dataset as t_shrec_ds)
from tests.torch_experiments_common import (assert_same_surfaces, jax_module,
                                            mesh, train_and_resume)
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def shrec(tmp_path_factory):
    base = tmp_path_factory.mktemp("shrec")
    simplified = layouts.shrec11_simplified(
        str(base / "simplified"),
        lambda c, t, i: mesh(100 + 4 * c + 2 * i + (t == "test")),
        n_train=2, n_test=2)
    original = layouts.shrec11_original(str(base / "original"),
                                        lambda k: mesh(300 + k % 7))
    return simplified, original


@pytest.mark.parametrize("variant", ["Simplified", "Original"])
def test_shrec11_split_and_dataset_match_jax(shrec, variant):
    """One np.random.seed gives both packages the same train split and the
    disjoint test set."""
    root = shrec[variant == "Original"]
    cache = os.path.join(root, "op_cache")
    j_cls = getattr(jax_module("classification_shrec11", "shrec11_dataset"),
                    f"Shrec11MeshDataset_{variant}")
    t_cls = getattr(t_shrec_ds, f"Shrec11MeshDataset_{variant}")
    sets = {}
    for name, cls, kw in (("jax", j_cls, {}),
                          ("port", t_cls, {"device": "cpu"})):
        np.random.seed(7)
        stages = {}
        if name == "port":
            kw = dict(kw, timings=stages)
        tr = cls(root, split_size=2, k_eig=8, op_cache_dir=cache, **kw)
        te = cls(root, split_size=None, k_eig=8, op_cache_dir=cache,
                 exclude_dict=tr.entries, **kw)
        sets[name] = (tr, te)
        assert stages == {}
    for t_ds, j_ds in zip(sets["port"], sets["jax"]):
        assert t_ds.entries == j_ds.entries
        assert_same_surfaces(t_ds, j_ds)
    tr, te = sets["port"]
    assert len(tr) == 60
    for cname, chosen in tr.entries.items():
        assert not chosen & te.entries[cname]


def test_shrec11_trains_and_resumes(shrec):
    root = shrec[0]
    train_and_resume(
        t_shrec.main, ["--dataset_type", "simplified", "--split_size", "2",
                       "--k_eig", "8", "--data_dir", root, "--device", "cpu",
                       "--input_features", "xyz"],
        os.path.join(root, "saved_models", "shrec11_simplified_xyz"))
