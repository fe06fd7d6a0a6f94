"""Geodesic distances and the geodesic-error evaluation metric: the
counterpart of diffusionnet_tpu/geometry/geodesics.py.

The reference computes exact all-pairs geodesics with libigl's MMP fanned over
a Python multiprocessing Pool (geometry.py:784-896). The equivalent here — and
the EVAL DEFAULT, so reported geodesic errors are comparable to reference
numbers — is an in-repo native C++ ICH (improved Chen-Han) continuous-Dijkstra
solver (ich_geodesics.cpp), threaded across sources instead of fanned over a
process pool.

A fast approximate alternative is also provided: the *heat method* (Crane,
Weischedel & Wardetzky, "Geodesics in Heat", TOG 2013) — two sparse linear
solves against prefactorized operators, batched over ALL sources at once as
dense multi-RHS solves (BLAS-3-shaped instead of V branchy graph runs).

The disk-cache scheme (SHA1 bucket files with linear probing) matches the
reference's geodesic cache (geometry.py:818-894).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse
import scipy.sparse.linalg as sla

from .. import utils
from ..native import (dijkstra_geodesics_native, exact_geodesics_native,
                      steiner_geodesics_native)
from .laplacian import (cotan_laplacian, vertex_areas, face_areas_np,
                        heat_face_geometry)


class HeatMethodSolver:
    """Prefactorized heat-method geodesic solver for one mesh.

    Usage: solver = HeatMethodSolver(verts, faces); d = solver.distance(sources).
    """

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 t_coef: float = 1.0):
        verts = np.asarray(verts, dtype=np.float64)
        faces = np.asarray(faces, dtype=np.int64)
        self.verts, self.faces = verts, faces
        V = verts.shape[0]

        L = cotan_laplacian(verts, faces)
        mass = vertex_areas(verts, faces)

        # per-face geometry for gradient/divergence (shared with the device
        # solver): grad u = sum_c u_c * rot_edges[c] (Crane et al.)
        (self._rot_edges, self._cot, self._edge_vecs,
         h) = heat_face_geometry(verts, faces)
        t = t_coef * h * h  # time step: t = t_coef * (mean edge length)^2

        M = scipy.sparse.diags(mass)
        self._heat_factor = sla.splu((M + t * L).tocsc())
        self._poisson_factor = sla.splu(
            (L + scipy.sparse.identity(V) * 1e-8 * L.diagonal().mean()).tocsc())

    def distance(self, sources: np.ndarray, block: int = 256) -> np.ndarray:
        """Geodesic distance from each source vertex: returns (S, V)."""
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
        V = self.verts.shape[0]
        out = np.zeros((sources.shape[0], V), dtype=np.float32)

        for s0 in range(0, sources.shape[0], block):
            srcs = sources[s0:s0 + block]
            S = srcs.shape[0]
            rhs = np.zeros((V, S))
            rhs[srcs, np.arange(S)] = 1.0

            u = self._heat_factor.solve(rhs)                      # (V,S)
            X = self._grad_faces(u)                                # (F,3,S)
            # max-scaled normalization: far-field |X| can sit below
            # sqrt(f64_min) where |X|^2 underflows in the norm while
            # X / 1e-300 amplifies the underflow noise (same failure mode as
            # the f32 device path, just at ~1e-150 instead of ~1e-19);
            # dividing by the per-(face,source) max first keeps every square
            # in range, so directions stay valid to the f64 underflow line
            m = np.max(np.abs(X), axis=1, keepdims=True)
            m_safe = m + 1e-12 * np.max(m, axis=0, keepdims=True) + 1e-300
            Z = X / m_safe
            Xn = -Z / (np.linalg.norm(Z, axis=1, keepdims=True) + 1e-30)
            div = self._divergence(Xn)                             # (V,S)
            phi = self._poisson_factor.solve(div)                  # (V,S)
            phi = phi - phi[srcs, np.arange(S)][None, :]
            # heat-method sign convention can flip on tiny meshes; distances >= 0
            phi = np.abs(phi)
            out[s0:s0 + block] = phi.T.astype(np.float32)
        return out

    def _grad_faces(self, u: np.ndarray) -> np.ndarray:
        # grad u = sum_c u_c * rot_edges[c]; the 1/(2A) scale and the unit
        # normal are pre-baked into self._rot_edges
        uf = u[self.faces]  # (F,3,S)
        return np.einsum("fcd,fcs->fds", self._rot_edges, uf)

    def _divergence(self, X: np.ndarray) -> np.ndarray:
        """X: (F,3,S) unit face vectors -> (V,S) integrated divergence."""
        V = self.verts.shape[0]
        S = X.shape[-1]
        div = np.zeros((V, S))
        f = self.faces
        e = self._edge_vecs   # e[:,c] is edge opposite corner c
        c = self._cot
        # At corner i of each face, the two adjacent edges are the ones NOT
        # opposite corner i. div_i += 0.5 * (cot_a (e1.X) + cot_b (e2.X))
        for corner in range(3):
            j = (corner + 1) % 3
            k = (corner + 2) % 3
            # edge corner->j is the edge opposite corner k (p_j - p_i = e_k);
            # edge corner->k is minus the edge opposite corner j.
            e_ij = e[:, k]
            e_ik = -e[:, j]
            # the angle opposite edge (i->j) within the face is at corner k
            dot_ij = np.einsum("fd,fds->fs", e_ij, X)
            dot_ik = np.einsum("fd,fds->fs", e_ik, X)
            contrib = 0.5 * (c[:, k][:, None] * dot_ij + c[:, j][:, None] * dot_ik)
            np.add.at(div, f[:, corner], contrib)
        return div


METHODS = ("exact", "ich", "steiner", "graph", "heat", "heat_device")


def _compute_all_pairs(verts_np, faces_np, method, device, info):
    """The (V, V) table of one method; info["ran"] names what computed it."""
    verts = verts_np.astype(np.float64)
    faces = faces_np.astype(np.int64)
    everyone = np.arange(verts.shape[0])
    info["ran"] = method
    if method == "graph":
        return dijkstra_geodesics_native(verts, faces, everyone)
    if method == "steiner":
        return steiner_geodesics_native(verts, faces, everyone)
    if method == "exact":
        # the documented patches of the exact method (JAX package and
        # reference numerics): a source over its window budget is
        # recomputed on the Steiner graph (k 8), and a mesh the ICH solver
        # refuses (non-manifold, non-oriented) takes the Steiner graph (k 4)
        # whole; info records which ran
        try:
            d = exact_geodesics_native(verts, faces, everyone,
                                       patch_failures=True, info=info)
        except RuntimeError as e:
            print(f"exact geodesics unavailable ({e}); falling back to "
                  "steiner")
            info["ran"] = "steiner"
            info["exact_error"] = str(e)
            return steiner_geodesics_native(verts, faces, everyone)
        if len(info["patched_sources"]):
            info["ran"] = "exact+steiner_patch"
        return d
    if method == "heat_device":
        from .heat_device import all_pairs_heat_device
        return all_pairs_heat_device(verts_np, faces_np, device=device)
    return HeatMethodSolver(verts_np, faces_np).distance(everyone)


def get_all_pairs_geodesic_distance(verts_np: np.ndarray, faces_np: np.ndarray,
                                    geodesic_cache_dir: str | None = None,
                                    method: str = "exact", device="cuda",
                                    info: dict | None = None) -> np.ndarray:
    """Dense (V,V) geodesic distance matrix, cached on disk like the reference
    (geometry.py:804-896); symmetrized with fmin of the transpose and NaN/inf
    repaired to the max finite value.

    method='exact' (default, matching the reference's libigl MMP oracle,
    geometry.py:785,792): ICH continuous-Dijkstra window propagation (native
    C++, threaded) — exact polyhedral geodesics; per-source Steiner patching
    on window-budget overflow, whole-mesh Steiner on non-manifold input.
    method='heat': heat-method multi-RHS solves on the host (smooth, fast,
    approximate — NOT comparable to reference eval numbers).
    method='heat_device': the same heat method on `device` (dense Cholesky,
    explicit inverses, heat_device.py). method='steiner': native Dijkstra
    over a Steiner-refined graph (upper bound, error ~ O(1/k); ~0.3% at
    k=4). method='graph': plain edge-graph Dijkstra (~5-8% stretch). 'ich'
    is an alias of 'exact'.

    info: optional dict; receives "ran" (the method that computed the
    table: 'exact+steiner_patch' when some sources were patched, 'steiner'
    when the mesh was refused by the exact solver; from a cache entry the
    one it recorded, or None for an entry that predates the record),
    "patched_sources" for the exact method, and "cached"."""
    verts_np = np.asarray(verts_np)
    faces_np = np.asarray(faces_np)
    if method == "ich":
        method = "exact"
    if method not in METHODS:
        raise ValueError(f"unknown geodesic method {method!r}")
    info = {} if info is None else info
    info["cached"] = False

    search_path = None
    if geodesic_cache_dir is not None:
        utils.ensure_dir_exists(geodesic_cache_dir)
        hash_key_str = str(utils.hash_arrays((verts_np, faces_np)))
        i_cache_search = 0
        while True:
            search_path = os.path.join(
                geodesic_cache_dir, f"{hash_key_str}_{i_cache_search}.npz")
            try:
                npzfile = np.load(search_path, allow_pickle=True)
                # entries without a method field predate the field or were
                # written by the reference (always exact MMP)
                cached_method = (str(npzfile["method"])
                                 if "method" in npzfile.files else "exact")
                if (cached_method != method
                        or not np.array_equal(verts_np, npzfile["verts"])
                        or not np.array_equal(faces_np, npzfile["faces"])):
                    i_cache_search += 1
                    continue
                info["cached"] = True
                info["ran"] = (str(npzfile["ran"]) if "ran" in npzfile.files
                               else None)
                return npzfile["dist"]
            except FileNotFoundError:
                break
            except Exception as E:
                # a corrupted or partly written entry: recompute and
                # overwrite it, as the operator cache does
                print(f"unexpected error loading geodesic cache: {E}"
                      " -- recomputing")
                break

    print(f"Computing all-pairs geodesic distance ({method} method)")
    result_dists = _compute_all_pairs(verts_np, faces_np, method, device,
                                      info)
    result_dists = np.nan_to_num(result_dists, nan=np.nan, posinf=np.nan,
                                 neginf=np.nan)
    result_dists = np.fmin(result_dists, result_dists.T)
    max_dist = np.nanmax(result_dists)
    result_dists = np.nan_to_num(result_dists, nan=max_dist, posinf=max_dist,
                                 neginf=max_dist)

    if search_path is not None:
        # the JAX package's fields, plus "ran", which its reader ignores
        np.savez(search_path, verts=verts_np, faces=faces_np,
                 dist=result_dists, method=method, ran=info["ran"])
    return result_dists


def geodesic_label_errors(target_verts, target_faces, pred_labels, gt_labels,
                          normalization: str = "diameter",
                          geodesic_cache_dir: str | None = None,
                          method: str = "exact", device="cuda",
                          info: dict | None = None):
    """Distances between predicted and ground-truth label vertices, normalized by
    geodesic diameter or sqrt(total area) (reference geometry.py:754-781).
    Defaults to exact polyhedral geodesics, the same oracle family the
    reference uses (libigl MMP, geometry.py:785,792), so reported errors are
    comparable to reference numbers. device, info: as
    get_all_pairs_geodesic_distance."""
    target_verts = np.asarray(utils.to_np(target_verts))
    target_faces = np.asarray(utils.to_np(target_faces))
    pred_labels = np.asarray(utils.to_np(pred_labels))
    gt_labels = np.asarray(utils.to_np(gt_labels))

    dists = get_all_pairs_geodesic_distance(target_verts, target_faces,
                                            geodesic_cache_dir, method=method,
                                            device=device, info=info)
    result_dists = dists[pred_labels, gt_labels]

    if normalization == "diameter":
        return result_dists / np.max(dists)
    elif normalization == "area":
        total_area = face_areas_np(target_verts.astype(np.float64),
                                   target_faces).sum()
        return result_dists / np.sqrt(total_area)
    else:
        raise ValueError("unrecognized normalization")
