"""The port's five experiment drivers and their datasets against the JAX
package's drivers on the CPU, on each suite's on-disk layout written with
small synthetic meshes (`diffusionnet_tpu_torch.experiments.layouts`).

Per suite the JAX driver or dataset runs first and writes the operator
cache; the port then reads that cache (its precompute records no stage) and
must give (a) the same dataset (verts, faces and labels bit-equal; the
SHREC11 split under one np.random.seed; mut_list; the fmaps pairs and C_gt
to 1e-5), (b) the same --evaluate numbers from one weights .npz (human
segmentation accuracy; sampling_invariance's per-mutation geodesic means to
1e-6; the fmaps test loss to rtol 1e-4 with the reference's faust_hks.npz),
(c) one epoch of each port driver with its log lines and checkpoint, and a
--resume_from that goes on, (d) the fmaps driver stopped by SIGTERM at a
pair boundary and resumed bit-equal to the uninterrupted run, and (e) the
refusals: --mesh (ROADMAP A.6) and --device cuda without a card.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import re
import shutil
import signal
import sys

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.experiments import layouts
from diffusionnet_tpu_torch.experiments.classification_shrec11 import (
    classification_shrec11 as t_shrec, shrec11_dataset as t_shrec_ds)
from diffusionnet_tpu_torch.experiments.functional_correspondence import (
    faust_scape_dataset as t_fmaps_ds, functional_correspondence as t_fmaps)
from diffusionnet_tpu_torch.experiments.human_segmentation_original import (
    human_segmentation_original as t_hseg,
    human_segmentation_original_dataset as t_hseg_ds)
from diffusionnet_tpu_torch.experiments.rna_mesh_segmentation import (
    rna_mesh_dataset as t_rna_ds, rna_mesh_segmentation as t_rna)
from diffusionnet_tpu_torch.experiments.sampling_invariance import (
    faust_with_robust_test_dataset as t_si_ds, sampling_invariance as t_si)
from tests.meshgen import icosphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
FAUST_HKS = os.path.join(EXP, "functional_correspondence", "pretrained_models",
                         "faust_hks.npz")
HSEG_HKS = os.path.join(EXP, "human_segmentation_original",
                        "pretrained_models", "human_seg_hks_4x128.npz")

torch.set_float32_matmul_precision("highest")


def mesh(seed, subdivisions=1):
    """A jittered icosphere (42 vertices at subdivision 1)."""
    v, f = icosphere(subdivisions=subdivisions)
    return v + 0.01 * np.random.RandomState(seed).randn(*v.shape), f


def jax_module(suite, name):
    """experiments/<suite>/<name>.py of the JAX package, on its own
    sys.path bootstrap."""
    for p in (os.path.join(EXP, suite), EXP):
        if p not in sys.path:
            sys.path.insert(0, p)
    spec = importlib.util.spec_from_file_location(
        f"jax_{suite}_{name}", os.path.join(EXP, suite, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(mod, argv) -> str:
    """A JAX driver's main() on argv; returns what it printed."""
    old, sys.argv = sys.argv, ["driver"] + argv
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = old
    return buf.getvalue()


def printed(pattern, text):
    return [float(x) for x in re.findall(pattern, text)]


def assert_same_surfaces(t_ds, j_ds):
    assert len(t_ds) == len(j_ds)
    for name in ("verts_list", "faces_list", "labels_list"):
        for a, b in zip(getattr(t_ds, name), getattr(j_ds, name)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    for a, b in zip(t_ds.ops_list, j_ds.ops_list):
        for f in ("mass", "evals", "evecs"):
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f))[
                                              ..., :getattr(a, f).shape[-1]],
                                          err_msg=f)


def train_and_resume(main, argv, save_path):
    """(c): one epoch, its log line and checkpoint, then --resume_from
    <path>_ckpt with --n_epoch 2 goes on at epoch 1."""
    log = save_path + "_log.jsonl"
    if os.path.exists(log):
        os.remove(log)
    shutil.rmtree(save_path + "_ckpt", ignore_errors=True)
    first = main(argv + ["--n_epoch", "1"])
    assert first["model_save_path"] == save_path
    assert "eigensolve" not in first["precompute_stages"]
    assert os.listdir(save_path + "_ckpt")
    assert [json.loads(x)["epoch"]
            for x in open(log).read().splitlines()] == [0]
    main(argv + ["--n_epoch", "2", "--resume_from", save_path + "_ckpt"])
    assert [json.loads(x)["epoch"]
            for x in open(log).read().splitlines()] == [0, 1]
    return first


# ---------------------------------------------------------------------------
# human_segmentation_original
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# rna_mesh_segmentation
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# classification_shrec11
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# sampling_invariance
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# functional_correspondence
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_rna_mesh_flag_raises_naming_a6(rna):
    with pytest.raises(NotImplementedError, match="A.6"):
        t_rna.main(["--n_epoch", "1", "--k_eig", "8", "--data_dir", rna[0],
                    "--device", "cpu", "--mesh", "2,2"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("main", [t_hseg.main, t_rna.main, t_shrec.main,
                                  t_si.main, t_fmaps.main])
def test_device_cuda_without_a_card_raises(main, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--data_dir", str(tmp_path)])


def test_default_paths_are_the_jax_drivers(monkeypatch):
    """Run from the repo, a driver's default data and pretrained_models
    directories are the JAX driver's own."""
    from diffusionnet_tpu_torch.experiments import exp_common
    assert exp_common.suite_dir("sampling_invariance") == os.path.join(
        EXP, "sampling_invariance")
    seen = {}

    def stop(root, **kw):
        seen["root"] = root
        raise SystemExit
    monkeypatch.setattr(t_rna, "RNAMeshDataset", stop)
    with pytest.raises(SystemExit):
        t_rna.main(["--device", "cpu"])
    assert seen["root"] == os.path.join(EXP, "rna_mesh_segmentation", "data")
