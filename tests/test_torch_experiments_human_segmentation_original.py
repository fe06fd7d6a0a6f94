"""The port's human_segmentation_original driver and dataset against the JAX
package's on the CPU (the split of tests/test_torch_experiments.py; its
helpers are tests/torch_experiments_common.py): the dataset bit-equal, the
--evaluate accuracy on the reference's weights, one epoch and a resume,
and --evaluate on the run's own checkpoints."""

import os

import pytest
import torch

from diffusionnet_tpu_torch.experiments import layouts
from diffusionnet_tpu_torch.experiments.human_segmentation_original import (
    human_segmentation_original as t_hseg,
    human_segmentation_original_dataset as t_hseg_ds)
from tests.torch_experiments_common import (HSEG_HKS, assert_same_surfaces,
                                            jax_module, mesh, printed, run_jax,
                                            train_and_resume)
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def hseg(tmp_path_factory):
    """The layout (4 train, 2 test geometries on the 18 shrec names); the
    JAX train dataset and the JAX --evaluate on the reference's
    human_seg_hks_4x128.npz, which write the operator cache."""
    root = layouts.human_segmentation(
        str(tmp_path_factory.mktemp("hseg") / "sig17"),
        [mesh(i) for i in range(4)], [mesh(10), mesh(11)])
    cache = os.path.join(root, "op_cache")
    j_ds = jax_module("human_segmentation_original",
                      "human_segmentation_original_dataset")
    train = j_ds.HumanSegOrigDataset(root, train=True, k_eig=8,
                                     op_cache_dir=cache)
    out = run_jax(jax_module("human_segmentation_original",
                             "human_segmentation_original"),
                  ["--evaluate", "--load_model", HSEG_HKS, "--k_eig", "8",
                   "--data_dir", root])
    test = j_ds.HumanSegOrigDataset(root, train=False, k_eig=8,
                                    op_cache_dir=cache)
    return root, train, test, out


@pytest.mark.parametrize("train", [True, False])
def test_human_segmentation_dataset_matches_jax(hseg, train):
    root, j_train, j_test, _ = hseg
    stages = {}
    ds = t_hseg_ds.HumanSegOrigDataset(
        root, train=train, k_eig=8, op_cache_dir=os.path.join(root, "op_cache"),
        device="cpu", timings=stages)
    assert stages == {}  # every mesh from the JAX package's cache
    assert len(ds) == (4 if train else 18)
    assert_same_surfaces(ds, j_train if train else j_test)


def test_human_segmentation_evaluate_matches_jax(hseg):
    root, _, _, out = hseg
    res = t_hseg.main(["--evaluate", "--load_model", HSEG_HKS, "--k_eig",
                       "8", "--data_dir", root, "--device", "cpu"])
    (want,) = printed(r"Overall test accuracy: ([\d.]+)%", out)
    assert f"{100 * res['test_acc']:06.3f}" == f"{want:06.3f}"
    assert res["precompute_stages"] == {}


def test_human_segmentation_trains_resumes_and_evaluates(hseg):
    """(c), and --evaluate on the run's own checkpoints repeats the test
    accuracy that fit logged for each one's epoch."""
    root = hseg[0]
    save = os.path.join(root, "saved_models", "human_seg_hks_4x128")
    first = train_and_resume(t_hseg.main, ["--k_eig", "8", "--data_dir", root,
                                           "--device", "cpu"], save)
    (epoch, _, test_acc), = first["history"]
    res = t_hseg.main(["--evaluate", "--load_model",
                       os.path.join(save + "_ckpt", f"step_{epoch}.npz"),
                       "--k_eig", "8", "--data_dir", root, "--device", "cpu"])
    assert res["test_acc"] == test_acc
