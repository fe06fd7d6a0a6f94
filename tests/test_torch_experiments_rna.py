"""The port's rna_mesh_segmentation driver and dataset against the JAX
package's on the CPU (the split of tests/test_torch_experiments.py; its
helpers are tests/torch_experiments_common.py): the dataset bit-equal, one
epoch and a resume, and --mesh over two gloo ranks."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.experiments import layouts
from diffusionnet_tpu_torch.experiments.rna_mesh_segmentation import (
    rna_mesh_dataset as t_rna_ds, rna_mesh_segmentation as t_rna)
from diffusionnet_tpu_torch.parallel import launch
from tests import torch_parallel_workers
from tests.torch_experiments_common import (assert_same_surfaces, jax_module,
                                            mesh, train_and_resume)
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def rna(tmp_path_factory):
    root = layouts.rna(str(tmp_path_factory.mktemp("rna") / "rna"),
                       [mesh(20 + i) for i in range(3)], n_train=2)
    j_ds = jax_module("rna_mesh_segmentation", "rna_mesh_dataset")
    cache = os.path.join(root, "op_cache")
    return root, {t: j_ds.RNAMeshDataset(root, train=t, k_eig=8,
                                         op_cache_dir=cache)
                  for t in (True, False)}


@pytest.mark.parametrize("train", [True, False])
def test_rna_dataset_matches_jax(rna, train):
    root, j = rna
    stages = {}
    ds = t_rna_ds.RNAMeshDataset(root, train=train, k_eig=8,
                                 op_cache_dir=os.path.join(root, "op_cache"),
                                 device="cpu", timings=stages)
    assert stages == {} and ds.n_class == 260
    assert_same_surfaces(ds, j[train])
    assert min(int(l.min()) for l in ds.labels_list) >= 0  # -1 shifted to 0


def test_rna_trains_and_resumes(rna):
    root = rna[0]
    train_and_resume(t_rna.main, ["--k_eig", "8", "--data_dir", root,
                                  "--buckets", "64,128", "--device", "cpu"],
                     os.path.join(root, "saved_models", "rna_seg_xyz_4x128"))


def test_rna_mesh_trains_over_two_gloo_ranks(rna, tmp_path):
    """--mesh 1,2 --megakernel: the driver in two ranks over gloo
    (parallel.launch makes the world; main()'s initialize() keeps it) on a
    copy of the synthetic layout trains one epoch through the (data 1,
    vert 2) route, bucket 256 a shard of 128 rows; both ranks report the
    same history and test accuracy, and rank 0 alone wrote the log's one
    line. (Replaces the refusal of --mesh.)"""
    root = str(tmp_path / "rna")
    shutil.copytree(rna[0], root,
                    ignore=shutil.ignore_patterns("saved_models"))
    argv = ["--n_epoch", "1", "--k_eig", "8", "--data_dir", root,
            "--device", "cpu", "--megakernel", "--mesh", "1,2",
            "--buckets", "256"]
    ranks = launch(torch_parallel_workers.rna_rank, 2, (argv,),
                   workdir=str(tmp_path / "ranks"), timeout_s=300)
    for r in ranks:
        np.testing.assert_array_equal(r["history"], ranks[0]["history"])
        assert float(r["test_acc"]) == float(ranks[0]["test_acc"])
    assert [int(e) for e in ranks[0]["history"][:, 0]] == [0]
    log = os.path.join(root, "saved_models", "rna_seg_xyz_4x128_log.jsonl")
    with open(log) as f:
        assert [json.loads(x)["epoch"] for x in f] == [0]
