"""What the port's experiment-driver tests share: small synthetic meshes,
the JAX drivers loaded from experiments/ on their own sys.path bootstrap,
and the train-then-resume check of a driver. The tests are split by suite,
tests/test_torch_experiments_<suite>.py, so that pytest-xdist's loadfile
spreads the suites over its workers."""

import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import sys

import numpy as np

from tests.meshgen import icosphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
FAUST_HKS = os.path.join(EXP, "functional_correspondence", "pretrained_models",
                         "faust_hks.npz")
HSEG_HKS = os.path.join(EXP, "human_segmentation_original",
                        "pretrained_models", "human_seg_hks_4x128.npz")


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
