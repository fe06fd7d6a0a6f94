"""The port's two point-cloud examples against the JAX package's on the CPU:
fmaps_synthetic (its shapes, one train step from the same weights, the
held-out vertex map for a given functional map) and
sampling_invariance_synthetic (its six mutation datasets, the cloud among
them, against the JAX package's operators), and each example's entry point
at one epoch."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusionnet_tpu.geometry as jgeo
from diffusionnet_tpu.serving.export import _flatten_params
from diffusionnet_tpu_torch.examples import fmaps_synthetic as tfm
from diffusionnet_tpu_torch.examples import sampling_invariance_synthetic as tsi
from diffusionnet_tpu_torch.models import (FunctionalMapCorrespondence,
                                           from_flat_jax_params,
                                           to_flat_jax_params)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples import fmaps_synthetic as jfm  # noqa: E402
from examples import sampling_invariance_synthetic as jsi  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

torch.set_float32_matmul_precision("highest")


def _host(fn):
    def call(*a, **kw):
        return fn(*a, **{**kw, "eigensolver": "host"})
    return call


@pytest.fixture(scope="module")
def fmap_shapes():
    """Three shapes of each package's build_shapes (same seed), both on
    host ARPACK."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tfm, "compute_operators", _host(tfm.compute_operators))
    mp.setattr(jfm, "compute_operators", _host(jgeo.compute_operators))
    try:
        return (tfm.build_shapes(n=3, k_eig=32, device="cpu"),
                jfm.build_shapes(n=3, k_eig=32))
    finally:
        mp.undo()


def test_fmaps_shapes_match_jax(fmap_shapes):
    t, j = fmap_shapes
    for (vt, ft, ot), (vj, fj, oj) in zip(t, j):
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
        for f in ("mass", "evals", "evecs", "gradX_spec", "gradY_spec"):
            np.testing.assert_allclose(getattr(ot, f), getattr(oj, f),
                                       rtol=0, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(tfm.gt_fmap(t[0][2], ot, 12),
                                   jfm.gt_fmap(j[0][2], oj, 12), rtol=0,
                                   atol=1e-5)


def test_fmaps_train_step_matches_jax(fmap_shapes, one_torch_thread):
    """One Adam step (dropout off on both sides) from the same weights on
    the same inputs (the port's shape dicts, also given to JAX): the loss
    to 1e-5 relative; each gradient tensor within 1e-4 of its own norm
    plus 1e-5 of the whole gradient's (A_im's gradient nearly cancels over
    the vertices, so its own norm is small beside the sums' rounding).
    Each package's own shape dict holds the same features to 1e-5."""
    t, j = fmap_shapes
    n_fmap, k_eig, n_feat, v_pad = 12, 32, 32, 256
    td = [tfm.shape_dict(v, ops, v_pad, k_eig, "cpu") for v, _, ops in t[:2]]
    own = jfm.shape_dict(*j[0][::2], v_pad, k_eig)
    for key in ("features", "mass", "evals", "evecs", "gradX", "gradY"):
        np.testing.assert_allclose(td[0][key].numpy(), np.asarray(own[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    jd = [{k: None if k == "L" else jnp.asarray(a.numpy())
           for k, a in d.items()} for d in td]
    jmodel = jfm.FunctionalMapCorrespondence(c_in=16, c_out=n_feat,
                                             c_width=n_feat, n_block=2,
                                             n_fmap=n_fmap)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jd[0], jd[1])
    C_gt = tfm.gt_fmap(t[0][2], t[1][2], n_fmap)

    def loss_fn(p):
        C_pred, _, _ = jmodel.apply(p, jd[0], jd[1], deterministic=True)
        return jnp.mean((C_pred - jnp.asarray(C_gt)) ** 2)
    j_loss, j_grads = jax.value_and_grad(loss_fn)(params)
    j_grads = _flatten_params(jax.tree.map(np.asarray, j_grads))

    model = FunctionalMapCorrespondence(c_in=16, c_out=n_feat,
                                        c_width=n_feat, n_block=2,
                                        n_fmap=n_fmap)
    model.load_state_dict(from_flat_jax_params(
        _flatten_params(jax.tree.map(np.asarray, params))))
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    loss = tfm.train_step(model, opt, td[0], td[1], torch.from_numpy(C_gt),
                          None, deterministic=True)
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    grads = to_flat_jax_params({n: p.grad for n, p in
                                model.named_parameters()})
    assert sorted(grads) == sorted(j_grads)
    whole = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for g in j_grads.values()))
    for key, g in j_grads.items():
        err = np.linalg.norm(grads[key] - g)
        assert err <= 1e-4 * np.linalg.norm(g) + 1e-5 * whole, key


def test_fmaps_held_out_vertex_map_matches_jax(fmap_shapes):
    """Given the same C_pred, the induced map equals the JAX example's."""
    t, _ = fmap_shapes
    e1, e2 = t[0][2].evecs[:, :12], t[1][2].evecs[:, :12]
    C = np.eye(12, dtype=np.float32) + 0.05 * np.random.RandomState(
        0).randn(12, 12).astype(np.float32)
    got = tfm.vertex_map(e1, e2, C)
    _, want = jgeo.find_knn_host(e2, e1 @ C.T, k=1)
    np.testing.assert_array_equal(got, want[:, 0])


def test_sampling_invariance_mutations_match_jax(monkeypatch):
    """The six mutation datasets: the same vertices, faces, labels and (for
    the cloud) normals as the JAX example's, and each one's operators
    (host ARPACK) equal to the JAX package's to 1e-6."""
    seen = {}

    def record(self, k_eig, op_cache_dir=None, normals_list=None, **kw):
        seen.setdefault("sets", []).append((self, normals_list))

    monkeypatch.setattr(jsi.SurfaceDataset, "precompute", record)
    _, _, jtests = jsi.build_sets(seed=0)
    monkeypatch.setattr(tsi.SurfaceDataset, "precompute",
                        functools.partialmethod(tsi.SurfaceDataset.precompute,
                                                eigensolver="host"))
    template, train, tests = tsi.build_sets(seed=0, device="cpu")
    assert list(tests) == ["orig", "iso", "qes", "mc", "dense", "cloud"]
    assert list(jtests) == list(tests)
    jnormals = {id(ds): nl for ds, nl in seen["sets"]}
    for name, ds in tests.items():
        jds = jtests[name]
        v = ds.verts_list[0]
        np.testing.assert_array_equal(v, jds.verts_list[0])
        np.testing.assert_array_equal(ds.faces_list[0], jds.faces_list[0])
        np.testing.assert_array_equal(ds.labels_list[0], jds.labels_list[0])
        nl = jnormals[id(jds)]
        jo = jgeo.compute_operators(v, jds.faces_list[0], k_eig=32,
                                    normals=None if nl is None else nl[0],
                                    eigensolver="host")
        o = ds.ops_list[0]
        if name == "cloud":
            assert ds.faces_list[0].size == 0
            np.testing.assert_allclose(o.frames[:, 2], nl[0], atol=1e-6)
        for f in ("frames", "mass", "evals", "evecs", "gradX_spec",
                  "gradY_spec"):
            np.testing.assert_allclose(getattr(o, f), getattr(jo, f),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{name} {f}")


def test_fmaps_entry_point_one_epoch(capsys):
    res = tfm.main(["--n_epoch", "1", "--device", "cpu"])
    assert set(res) == {"test_fmap_l2", "mean_angular_err_deg",
                        "exact_match"}
    assert np.isfinite(res["test_fmap_l2"])
    assert "held-out pair" in capsys.readouterr().out


def test_sampling_invariance_entry_point_one_epoch(tmp_path):
    out = tmp_path / "table.jsonl"
    rec = tsi.main(["--n_epoch", "1", "--device", "cpu", "--out", str(out)])
    assert set(rec["per_mutation"]) == {"orig", "iso", "qes", "mc", "dense",
                                        "cloud"}
    assert rec["gate"]["rule"] == "err <= max(2*orig, half template edge)"
    assert json.loads(out.read_text())["n_epoch"] == 1
