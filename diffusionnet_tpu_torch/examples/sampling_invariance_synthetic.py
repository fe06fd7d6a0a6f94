"""Synthetic sampling-invariance check (the DiffusionNet headline property,
reference experiments/sampling_invariance): train template-vertex
correspondence on ONE discretization of a shape family, evaluate on DIFFERENT
discretizations — a finer remeshing and a raw point cloud — without
retraining. The counterpart of examples/sampling_invariance_synthetic.py:
the same shapes, seeds, configuration and gate.

Template: a fixed asymmetric "bumpy sphere" (icosphere sub-2, 162 vertices;
labels = vertex ids). Features are xyz, the reference E5 default
(sampling_invariance.py:21). Train split: jittered bumpy sub-2 spheres.
Test mutations mirror the reference's six-method protocol
(faust_with_robust_test_dataset.py:85 `['orig','iso','qes','mc','dense',
'cloud']`), realized on the sphere family:
  orig  — the training tessellation (icosphere sub-2, 162 v)
  iso   — isotropic remesh: Fibonacci-sphere points, hull triangulation
  qes   — decimation: FPS-subsampled sub-3 directions (100 v), hull
  mc    — irregular remesh: random directions, hull
  dense — finer remesh (icosphere sub-3, 642 v)
  cloud — sub-3 vertices as a raw point cloud (no faces), with normals
          from the source mesh, as the reference's cloud split stores them
Metric: mean angular (great-circle) error between the predicted template
vertex and the true nearest template vertex (the analogue of the
reference's per-mutation geodesic error table, sampling_invariance.py:
212-225).

The per-mutation table is appended to --out (empty: not written), and
with --gate each mutation's mean angular error must be <= max(2x orig's,
half a template edge length, 8.6 deg): the example's own rule, as a
failing check.

    python -m diffusionnet_tpu_torch.examples.sampling_invariance_synthetic
        [--n_epoch 30] [--gate] [--out PATH] [--device cuda]

The mesh generator is the repository's tests/meshgen.py, loaded by its
path when the example runs.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data import SurfaceDataset, make_padded_batches
from ..experiments.exp_common import FitConfig, build_model, fit
from ..geometry.host_frames import mesh_vertex_normals_np
from ..training.task import TaskConfig, apply_model
from .synthetic_shrec import _meshgen

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def bumpy(v):
    """Fixed asymmetric radial deformation (same for every sample)."""
    u = unit(v)
    r = (1.0 + 0.25 * np.sin(3 * u[:, 0] + 1.0) * np.cos(2 * u[:, 1])
         + 0.15 * u[:, 2] ** 3)
    return u * r[:, None]


def nearest_template_labels(verts, template):
    """True labels for any discretization: nearest template vertex (by the
    underlying sphere parametrization)."""
    cos = unit(verts) @ unit(template).T
    return np.argmax(cos, axis=1).astype(np.int32)


def sphere_hull_mesh(dirs):
    """Triangulate unit directions via their convex hull (valid for the
    star-convex bumpy-sphere family), faces oriented outward."""
    from scipy.spatial import ConvexHull
    dirs = unit(np.asarray(dirs, np.float64))
    hull = ConvexHull(dirs)
    faces = hull.simplices.copy()
    # orient each face outward: normal . centroid-direction > 0
    a, b, c = dirs[faces[:, 0]], dirs[faces[:, 1]], dirs[faces[:, 2]]
    n = np.cross(b - a, c - a)
    flip = np.sum(n * (a + b + c), axis=1) < 0
    faces[flip] = faces[flip][:, ::-1]
    return dirs, faces.astype(np.int64)


def fibonacci_sphere(n):
    """Near-isotropic point distribution on the sphere (golden-angle spiral)."""
    i = np.arange(n, dtype=np.float64)
    z = 1.0 - (2.0 * i + 1.0) / n
    phi = i * np.pi * (3.0 - np.sqrt(5.0))
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def fps_directions(dirs, n, seed=0):
    """Farthest-point subsample of unit directions (geodesic ~ chordal here)."""
    dirs = unit(np.asarray(dirs, np.float64))
    rs = np.random.RandomState(seed)
    chosen = [int(rs.randint(dirs.shape[0]))]
    d = np.linalg.norm(dirs - dirs[chosen[0]], axis=1)
    for _ in range(n - 1):
        nxt = int(np.argmax(d))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(dirs - dirs[nxt], axis=1))
    return dirs[np.asarray(chosen)]


def build_mutations(rs, icosphere):
    """The six reference mutation methods realized on the sphere family
    (faust_with_robust_test_dataset.py:85). Each value is (verts, faces|None)
    BEFORE the bumpy deformation; jitter is applied to the deformed verts."""
    muts = {}
    v, f = icosphere(subdivisions=2)
    muts["orig"] = (v, f)
    muts["iso"] = sphere_hull_mesh(fibonacci_sphere(162))
    v3, _ = icosphere(subdivisions=3)
    muts["qes"] = sphere_hull_mesh(fps_directions(v3, 100, seed=3))
    muts["mc"] = sphere_hull_mesh(unit(rs.randn(300, 3)))
    v, f = icosphere(subdivisions=3)             # finer remeshing, 642 verts
    muts["dense"] = (v, f)
    v, _ = icosphere(subdivisions=3)
    muts["cloud"] = (v, None)
    return muts


def build_sets(n_train=12, seed=0, device="cuda"):
    """(template, train set, {mutation: test set})."""
    icosphere = _meshgen().icosphere
    rs = np.random.RandomState(seed)
    template, _ = icosphere(subdivisions=2)

    train = SurfaceDataset(labels_kind="vertex")
    for _ in range(n_train):
        v, f = icosphere(subdivisions=2)
        v = bumpy(v) * (1.0 + 0.02 * rs.randn(*v.shape))
        train.add(v, f, np.arange(v.shape[0], dtype=np.int32))
    train.precompute(k_eig=32, verbose=False, device=device)

    tests = {}
    for name, (v, f) in build_mutations(rs, icosphere).items():
        v = bumpy(v) * (1.0 + 0.02 * rs.randn(*v.shape))
        ds = SurfaceDataset(labels_kind="vertex")
        ds.add(v, f, nearest_template_labels(v, template))
        normals_list = None
        if f is None:
            # the reference's cloud split ships normals computed from the
            # source mesh and stored in the ply
            # (faust_with_robust_test_dataset.py:107-115); plane-fit normals
            # have an arbitrary per-point sign, which flips the tangent
            # frame's handedness and conjugates the gradient features. So
            # the normals come from the source mesh, then the faces go.
            _, f_src = icosphere(subdivisions=3)
            normals_list = [mesh_vertex_normals_np(v, f_src)]
        ds.precompute(k_eig=32, verbose=False, normals_list=normals_list,
                      device=device)
        tests[name] = ds
    return template, train, tests


def mutation_results(model, params, template, tests, device) -> dict:
    """Exact-label accuracy and mean angular error of each test set (batch
    1, the eager model)."""
    tcfg = TaskConfig(input_features="xyz", labels_kind="vertex",
                      use_megakernel=False)
    t_unit = unit(template)
    results = {}
    for name, ds in tests.items():
        batch = next(iter(make_padded_batches(ds, 1, shuffle=False)))
        with torch.no_grad():
            preds = apply_model(model, params, batch.to(device), None, tcfg,
                                deterministic=True)
        pred_labels = preds.argmax(-1)[0].cpu().numpy()
        labels = np.asarray(batch.labels)[0]
        valid = labels >= 0
        acc = float((pred_labels[valid] == labels[valid]).mean())
        ang = np.degrees(np.arccos(np.clip(
            np.sum(t_unit[pred_labels[valid]] * t_unit[labels[valid]], -1),
            -1, 1)))
        results[name] = {"exact_label_acc_pct": round(100 * acc, 2),
                         "mean_angular_err_deg": round(float(np.mean(ang)), 3),
                         "n_verts": int(valid.sum()),
                         "is_cloud": name == "cloud"}
        print(f"  {name:>6}: exact-label acc {100 * acc:6.2f}%   "
              f"mean angular err {np.mean(ang):6.2f} deg")
    return results


def gate(results: dict) -> dict:
    """The discretization-invariance gate: each mutation's mean angular
    error <= max(2x the training tessellation's error, half a template edge
    length). The 2x-orig term is the reference table's shape; the edge term
    is the label quantization scale (orig is the training tessellation
    itself, so its error is near 0 and a bare 2x-orig gate would be
    vacuous). A collapsed model reads ~90 deg."""
    icosphere = _meshgen().icosphere
    v_t, f_t = icosphere(subdivisions=2)
    e = np.concatenate([f_t[:, [0, 1]], f_t[:, [1, 2]], f_t[:, [2, 0]]])
    tu = unit(v_t)
    edge_deg = float(np.degrees(np.mean(np.arccos(np.clip(
        np.sum(tu[e[:, 0]] * tu[e[:, 1]], -1), -1, 1)))))
    orig = results["orig"]["mean_angular_err_deg"]
    limit = max(2.0 * orig, 0.5 * edge_deg)
    ok = all(r["mean_angular_err_deg"] <= limit for r in results.values())
    return {"rule": "err <= max(2*orig, half template edge)",
            "template_edge_deg": round(edge_deg, 2),
            "limit_deg": round(limit, 3), "ok": ok}


def run(n_epoch=30, out_path=None, gate_on=False, seed=0, device="cuda"):
    template, train_ds, tests = build_sets(seed=seed, device=device)
    n_class = template.shape[0]

    cfg = FitConfig(n_epoch=n_epoch, lr=2e-3, decay_every=50,
                    batch_size=6, input_features="xyz", labels_kind="vertex")
    model = build_model(n_class=n_class, c_width=32, outputs_at="vertices",
                        dropout=False, input_features="xyz", n_block=2)
    params, history, evaluate = fit(model, train_ds, tests["orig"], cfg,
                                    verbose=False, device=device)

    print("\n== per-mutation results (angular error on the template sphere) ==")
    results = mutation_results(model, params, template, tests, device)
    verdict = gate(results)
    record = {"suite": "sampling_invariance_synthetic", "n_epoch": n_epoch,
              "per_mutation": results, "gate": verdict}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        print(f"appended table to {out_path}")
    if gate_on and not verdict["ok"]:
        raise SystemExit(
            f"GATE FAILED: some mutation error exceeds "
            f"{verdict['limit_deg']:.2f} deg: "
            f"{ {k: v['mean_angular_err_deg'] for k, v in results.items()} }")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_epoch", type=int, default=30)
    ap.add_argument("--out", default=os.path.join(
        _REPO, "docs", "results", "sampling_invariance_torch.jsonl"),
        help="the JSON lines file the table is appended to ('' for none)")
    ap.add_argument("--gate", action="store_true",
                    help="exit nonzero if any mutation's error exceeds "
                         "max(2x orig, half a template edge length)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    return run(n_epoch=args.n_epoch, out_path=args.out, gate_on=args.gate,
               device=args.device)


if __name__ == "__main__":
    main()
