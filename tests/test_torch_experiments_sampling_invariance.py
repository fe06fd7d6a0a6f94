"""The port's sampling_invariance driver and dataset against the JAX
package's on the CPU (the split of tests/test_torch_experiments.py; its
helpers are tests/torch_experiments_common.py): the dataset bit-equal,
--evaluate's per-mutation geodesic means on one weights .npz, one epoch
and a resume."""

import os

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.experiments import layouts
from diffusionnet_tpu_torch.experiments.sampling_invariance import (
    faust_with_robust_test_dataset as t_si_ds, sampling_invariance as t_si)
from tests.torch_experiments_common import (assert_same_surfaces, jax_module,
                                            mesh, printed, run_jax,
                                            train_and_resume)
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


def _si_layout(root):
    """2 training registrations and 1 held-out shape in the five other
    mutations: a jittered copy, the sub-2 sphere, and the cloud with the
    held-out shape's normals."""
    regs = [mesh(40 + i) for i in range(3)]
    v, f = regs[2]
    v2, f2 = mesh(50, subdivisions=2)
    nrm = v / np.linalg.norm(v, axis=1, keepdims=True)
    lbl = np.arange(len(v))
    lbl2 = np.argmax((v2 / np.linalg.norm(v2, axis=1, keepdims=True))
                     @ nrm.T, axis=1)
    muts = {"iso": [(mesh(51)[0], f, lbl)], "qes": [(v, f, lbl)],
            "mc": [(mesh(52)[0], f, lbl)], "dense": [(v2, f2, lbl2)],
            "cloud": [(v, nrm, lbl)]}
    return layouts.sampling_invariance(root, regs, muts)


def _si_weights(path):
    """Seeded weights of the driver's model (C 256, 42 classes, xyz) as a
    converter .npz (keys without 'params/')."""
    from diffusionnet_tpu_torch.experiments.exp_common import build_model
    from diffusionnet_tpu_torch.models import to_flat_jax_params
    model = build_model(n_class=42, c_width=256, outputs_at="vertices",
                        dropout=True, input_features="xyz")
    model.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():  # nonzero diffusion times
        for b in model.blocks:
            b.diffusion.diffusion_time.uniform_(0.0, 0.1)
    flat = to_flat_jax_params(model)
    np.savez(path, **{k[len("params/"):]: v for k, v in flat.items()})
    return path


@pytest.fixture(scope="module")
def si(tmp_path_factory):
    """The layout, and the JAX --evaluate (exact geodesics) on one weights
    .npz, with its per-mutation errors recorded."""
    base = tmp_path_factory.mktemp("si")
    root = _si_layout(str(base / "faust"))
    npz = _si_weights(str(base / "si_weights.npz"))
    mod = jax_module("sampling_invariance", "sampling_invariance")
    seen = {}
    inner = mod.per_mutation_geodesic_errors

    def record(*a, **kw):
        seen["errors"] = inner(*a, **kw)
        return seen["errors"]
    mod.per_mutation_geodesic_errors = record
    out = run_jax(mod, ["--evaluate", "--load_model", npz, "--k_eig", "8",
                        "--n_train", "2", "--n_test", "1",
                        "--geodesic_method", "exact", "--data_dir", root])
    j_ds = jax_module("sampling_invariance", "faust_with_robust_test_dataset")
    cache = os.path.join(root, "op_cache")
    sets = {t: j_ds.FaustWithRobustTestDataset(
        root, train=t, k_eig=8, op_cache_dir=cache, n_train=2, n_test=1)
        for t in (True, False)}
    return root, npz, out, seen["errors"], sets


@pytest.mark.parametrize("train", [True, False])
def test_sampling_invariance_dataset_matches_jax(si, train):
    root, _, _, _, j = si
    stages = {}
    ds = t_si_ds.FaustWithRobustTestDataset(
        root, train=train, k_eig=8, op_cache_dir=os.path.join(root, "op_cache"),
        n_train=2, n_test=1, device="cpu", timings=stages)
    assert stages == {}
    assert ds.mut_list == j[train].mut_list
    assert ds.mut_list == ([None, None] if train else
                           ["orig", "iso", "qes", "mc", "dense", "cloud"])
    assert_same_surfaces(ds, j[train])


def test_sampling_invariance_evaluate_matches_jax(si):
    root, npz, out, j_errors, _ = si
    res = t_si.main(["--evaluate", "--load_model", npz, "--k_eig", "8",
                     "--n_train", "2", "--n_test", "1",
                     "--geodesic_method", "exact", "--data_dir", root,
                     "--device", "cpu"])
    (want,) = printed(r"Overall test accuracy: ([\d.]+)%", out)
    assert f"{100 * res['test_acc']:06.3f}" == f"{want:06.3f}"
    assert list(res["geodesic_means"]) == list(j_errors)
    for mut, errs in j_errors.items():
        assert abs(res["geodesic_means"][mut] - np.mean(errs)) <= 1e-6, mut


def test_sampling_invariance_trains_and_resumes(si):
    root = si[0]
    train_and_resume(
        t_si.main, ["--k_eig", "8", "--n_train", "2", "--n_test", "1",
                    "--geodesic_method", "graph", "--data_dir", root,
                    "--device", "cpu"],
        os.path.join(root, "saved_models",
                     "categorical_correspondence_xyz_4x256"))
