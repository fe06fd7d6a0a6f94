"""Synthetic functional correspondence (the E4 pipeline without dataset
downloads): train the FunctionalMapCorrespondence model (shared-weights
DiffusionNet features + regularized fmap solver) on pairs of jittered
ASYMMETRIC bumpy spheres (a perfect sphere has degenerate eigenspaces, which
makes the ground-truth functional map gauge-ambiguous and the task ill-posed)
with identity ground-truth correspondence, then evaluate the induced
vertex-to-vertex map as the reference does (kNN in the spectrally aligned
embedding, reference functional_correspondence.py:181-204). The counterpart
of examples/fmaps_synthetic.py: the same shapes, seeds and configuration.

    python -m diffusionnet_tpu_torch.examples.fmaps_synthetic [--n_epoch 4]
        [--device cuda]

The mesh generator is the repository's tests/meshgen.py, loaded by its
path when the example runs.
"""

from __future__ import annotations

import argparse
from itertools import permutations

import numpy as np
import torch

from ..data.features import get_features
from ..geometry import (compute_operators, find_knn_host, grad_operators,
                        pad_operators)
from ..models.fmaps import FunctionalMapCorrespondence
from ..utils import normalize_positions_np, pad_to
from .synthetic_shrec import _meshgen


def bumpy(v):
    """Fixed asymmetric radial deformation: breaks the sphere's eigenspace
    degeneracies so the ground-truth functional map is well defined."""
    u = v / np.linalg.norm(v, axis=-1, keepdims=True)
    r = (1.0 + 0.25 * np.sin(3 * u[:, 0] + 1.0) * np.cos(2 * u[:, 1])
         + 0.15 * u[:, 2] ** 3)
    return u * r[:, None]


def build_shapes(n=8, seed=0, k_eig=32, device="cuda"):
    """n jittered bumpy icospheres (subdivision 2): (verts f32, faces,
    Operators) each."""
    icosphere = _meshgen().icosphere
    rs = np.random.RandomState(seed)
    shapes = []
    for _ in range(n):
        v, f = icosphere(subdivisions=2)
        v = bumpy(v) * (1.0 + 0.02 * rs.randn(*v.shape))
        v = normalize_positions_np(v, faces=f, scale_method="area")
        ops = compute_operators(v, f, k_eig=k_eig, device=device)
        shapes.append((v.astype(np.float32), f, ops))
    return shapes


def shape_dict(v, ops, v_pad, k_eig, device, input_features="hks"):
    """The model's input dict of one shape, padded to v_pad, on device."""
    ops = pad_operators(ops, v_pad, k_eig)
    gX, gY = grad_operators(ops)
    dev = ops._replace(gradX_spec=gX, gradY_spec=gY).to(device)
    x = torch.from_numpy(pad_to(v, v_pad)).to(device)
    feats = get_features(input_features, x, dev.evals, dev.evecs)
    return dict(features=feats, mass=dev.mass, L=dev.L, evals=dev.evals,
                evecs=dev.evecs, gradX=dev.gradX_spec, gradY=dev.gradY_spec)


def gt_fmap(ops1, ops2, n_fmap):
    """Identity correspondence: lstsq alignment of the full eigenbases."""
    e1 = ops1.evecs[:, :n_fmap].astype(np.float64)
    e2 = ops2.evecs[:, :n_fmap].astype(np.float64)
    sol, *_ = np.linalg.lstsq(e1, e2, rcond=None)
    return sol.T.astype(np.float32)


def train_step(model, optimizer, s1, s2, C_gt, generator,
               deterministic=False) -> float:
    """One Adam step on the mean squared fmap error; returns the loss."""
    model.train(not deterministic)
    optimizer.zero_grad(set_to_none=True)
    C_pred, _, _ = model(s1, s2, deterministic=deterministic,
                         generator=generator)
    loss = torch.mean((C_pred - C_gt) ** 2)
    loss.backward()
    optimizer.step()
    return float(loss.detach())


def vertex_map(evecs1, evecs2, C_pred):
    """The induced map from shape 2 to shape 1: each vertex of 2 to its
    nearest neighbour in the spectrally aligned embedding of 1."""
    evec1_on_2 = evecs1 @ np.asarray(C_pred).T
    _, pred_2to1 = find_knn_host(evecs2, evec1_on_2, k=1)
    return pred_2to1[:, 0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_epoch", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    n_fmap, k_eig, n_feat = 12, 32, 32
    shapes = build_shapes(n=6, k_eig=k_eig, device=device)
    v_pad = 256

    model = FunctionalMapCorrespondence(
        c_in=16, c_out=n_feat, c_width=n_feat, n_block=2, n_fmap=n_fmap,
        generator=torch.Generator().manual_seed(0)).to(device)
    dicts = [shape_dict(v, ops, v_pad, k_eig, device) for v, f, ops in shapes]
    optimizer = torch.optim.Adam(model.parameters(), lr=5e-4)
    generator = torch.Generator(device=device).manual_seed(0)

    pairs = list(permutations(range(4), 2))  # train on shapes 0-3
    print(f"training on {len(pairs)} pairs x {args.n_epoch} epochs")
    for epoch in range(args.n_epoch):
        losses = []
        for i, j in pairs:
            C_gt = torch.from_numpy(
                gt_fmap(shapes[i][2], shapes[j][2], n_fmap)).to(device)
            losses.append(train_step(model, optimizer, dicts[i], dicts[j],
                                     C_gt, generator))
        print(f"epoch {epoch}: train fmap L2 {np.mean(losses):.4e}")

    # held-out pair (4, 5): the induced vertex map's accuracy
    i, j = 4, 5
    C_gt = gt_fmap(shapes[i][2], shapes[j][2], n_fmap)
    model.eval()
    with torch.no_grad():
        C_pred = model(dicts[i], dicts[j])[0].cpu().numpy()
    test_loss = float(np.mean((C_pred - C_gt) ** 2))
    pred_2to1 = vertex_map(shapes[i][2].evecs[:, :n_fmap],
                           shapes[j][2].evecs[:, :n_fmap], C_pred)
    # identity correspondence: compare directions on the underlying sphere
    u1 = shapes[i][0] / np.linalg.norm(shapes[i][0], axis=1, keepdims=True)
    u2 = shapes[j][0] / np.linalg.norm(shapes[j][0], axis=1, keepdims=True)
    ang = np.degrees(np.arccos(np.clip(
        np.sum(u1 * u2[pred_2to1], axis=-1), -1, 1)))
    exact = float((pred_2to1 == np.arange(len(u2))).mean())
    print(f"held-out pair: fmap L2 {test_loss:.4e}, "
          f"vertex-map mean angular err {ang.mean():.2f} deg "
          f"(exact matches {100 * exact:.1f}%)")
    return {"test_fmap_l2": test_loss, "mean_angular_err_deg":
            float(ang.mean()), "exact_match": exact}


if __name__ == "__main__":
    main()
