"""Operator precompute, the typed Operators bundle, disk caching, and padding.

The counterpart of diffusionnet_tpu/geometry/operators.py. The host work is
numpy/scipy (float64, stored float32) and the eigensolve runs on the device
(geometry/eigen.py) unless the caller asks for host ARPACK; the bundle is
numpy, and `Operators.to(device)` is the one boundary where it becomes
torch tensors. The npz disk cache is the
JAX package's format byte for byte (same SHA1 key, same probing, same
fields), so a cache written by either package is read by the other.

Attribution: the get_operators cache protocol (bucket probing, messages, npz
field layout) transcribes nmwsharp/diffusion-net geometry.py:426-570 for
on-disk byte compatibility — MIT License (c) 2020-2021 Nicholas Sharp and
coauthors; see the repository LICENSE file.
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import scipy.sparse
import torch

from .. import utils
from ..ops.sparse import Ell, ell_from_coo, ell_pad
from .eigen import EigenSolveNotConverged, eigensolve_device, eigensolve_host
from .gradients import build_grad, build_grad_point_cloud
from .host_frames import build_tangent_frames_np, edge_tangent_vectors_np
from .laplacian import cotan_laplacian, vertex_areas
from .point_cloud import _soup_laplacian, cloud_soup


class Operators(NamedTuple):
    """The operator bundle (reference geometry.py:392's 7-tuple). Padded
    vertices carry mass == 0.

    gradX_spec/gradY_spec are the spectral gradient operators
    GX = gradX @ evecs, GY = gradY @ evecs, each (V, K): the gradient of the
    spectrally diffused signal is then GX @ (e^{-lambda t} (.) x_hat), a dense
    (V,K)x(K,C) product."""
    frames: np.ndarray   # (V, 3, 3)
    mass: np.ndarray     # (V,)
    L: Ell               # (V, V) weak Laplacian
    evals: np.ndarray    # (K,)
    evecs: np.ndarray    # (V, K)
    gradX: Ell           # (V, V) tangent-gradient real part
    gradY: Ell           # (V, V) tangent-gradient imaginary part
    gradX_spec: np.ndarray | None = None  # (V, K) gradX @ evecs
    gradY_spec: np.ndarray | None = None  # (V, K) gradY @ evecs

    def to(self, device) -> "Operators":
        """The same bundle with every array a torch tensor on `device`."""
        return map_operators(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device),
            self)


def map_operators(fn: Callable, *bundles: Operators) -> Operators:
    """fn applied field by field across bundles (to the idx and val of each
    Ell; None stays None): the JAX package's jax.tree.map over Operators."""
    def one(*xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], Ell):
            return Ell(fn(*(x.idx for x in xs)), fn(*(x.val for x in xs)))
        return fn(*xs)
    return Operators(*(one(*xs) for xs in zip(*bundles)))


def spectral_gradients(gradX, gradY, evecs: np.ndarray):
    """Host computation of GX = gradX @ evecs, GY = gradY @ evecs for scipy
    sparse gradX/gradY."""
    evecs = np.asarray(evecs)
    return (np.asarray(gradX @ evecs).astype(evecs.dtype),
            np.asarray(gradY @ evecs).astype(evecs.dtype))


def grad_operators(ops: Operators, prefer_spectral: bool = True):
    """(gradX, gradY) to feed the model: the dense spectral operators when
    available, else the ELL operators."""
    if prefer_spectral and ops.gradX_spec is not None:
        return ops.gradX_spec, ops.gradY_spec
    return ops.gradX, ops.gradY


def _csc_to_ell(mat: scipy.sparse.spmatrix, dtype=np.float32) -> Ell:
    coo = mat.tocoo()
    return ell_from_coo(coo.row, coo.col, coo.data, mat.shape[0], dtype=dtype)


# The device eigensolver (Chebyshev-filtered subspace iteration on kernel
# B5) is the default, as in the JAX package; 'host' (ARPACK) stays as the
# reference-parity path and the fallback when the device solve does not
# converge.
DEFAULT_EIGENSOLVER = "device"

# device solves that did not converge and fell back to host ARPACK in this
# process (a run reads it to show that its operators came from the device)
EIGEN_FALLBACKS = 0


def compute_operators(verts, faces, k_eig: int, normals=None,
                      dtype=np.float32,
                      eigensolver: str = DEFAULT_EIGENSOLVER,
                      device="cuda",
                      _return_sparse: bool = False,
                      timings: dict | None = None):
    """Build spectral operators for a mesh or a point cloud (numpy in /
    Operators out).

    verts: (V,3); faces: (F,3) int, or None / empty for a point cloud;
    k_eig: number of eigenpairs. Same pipeline as reference
    geometry.py:276-392: tangent frames, Laplacian and lumped mass (cotan
    for a mesh; for a cloud the robust Laplacian of point_cloud.py on the
    native triangle soup of each point's 30 neighbours), eigendecomposition,
    least-squares tangent gradients over the Laplacian's edge set (a mesh)
    or the 30-NN graph (a cloud).

    eigensolver: 'device' (default): the device solver on `device`, with
    the float64 host polish; if it does not converge
    (EigenSolveNotConverged) a warning is issued, EIGEN_FALLBACKS rises and
    the host ARPACK ladder runs instead. Any other error propagates.
    'host': seeded ARPACK, deterministic, equal to the JAX package's 'host'
    result.
    timings: optional dict of wall seconds per stage (frames, for a cloud
    triangulation, laplacian, eigensolve and the solver's own stages,
    build_grad, ell_convert, spectral_grad)."""
    global EIGEN_FALLBACKS
    if eigensolver not in ("host", "device"):
        raise ValueError("eigensolver must be 'host' or 'device'")
    t_last = [time.perf_counter()]

    def _mark(stage):
        now = time.perf_counter()
        if timings is not None:
            timings[stage] = timings.get(stage, 0.0) + now - t_last[0]
        t_last[0] = now

    verts_np = np.asarray(verts, dtype=np.float64)
    faces_np = (np.asarray(faces, dtype=np.int64)
                if faces is not None and np.asarray(faces).size else
                np.zeros((0, 3), dtype=np.int64))
    is_cloud = faces_np.size == 0
    eps = 1e-8

    if normals is not None:
        normals = np.asarray(normals, dtype=np.float64)
    frames = build_tangent_frames_np(verts_np, faces_np, normals=normals)
    _mark("frames")

    if is_cloud:
        # point_cloud_laplacian(verts_np) at its defaults, in two stages
        soup = cloud_soup(verts_np)
        _mark("triangulation")
        L, massvec_np = _soup_laplacian(verts_np, soup, 1e-6)
    else:
        L = cotan_laplacian(verts_np, faces_np, denom_eps=1e-10)
        massvec_np = vertex_areas(verts_np, faces_np)
        massvec_np = massvec_np + eps * np.mean(massvec_np)
    if np.isnan(L.data).any():
        raise RuntimeError("NaN Laplace matrix")
    if np.isnan(massvec_np).any():
        raise RuntimeError("NaN mass matrix")
    _mark("laplacian")

    if k_eig == 0:
        evals_np = np.zeros((0,))
        evecs_np = np.zeros((verts_np.shape[0], 0))
    elif eigensolver == "host":
        evals_np, evecs_np = eigensolve_host(L, massvec_np, k_eig, eps=eps)
    else:
        try:
            # polish: one float64 Rayleigh-Ritz on the host within the
            # device-converged basis (the f64 operator is at hand)
            evals_np, evecs_np = eigensolve_device(
                _csc_to_ell(L, dtype=np.float32),
                massvec_np.astype(np.float32), k_eig, eps=eps,
                polish=(L, massvec_np), timings=timings, device=device)
        except EigenSolveNotConverged as e:
            import warnings
            warnings.warn(f"device eigensolver did not converge ({e}); "
                          "falling back to the host ARPACK ladder",
                          stacklevel=2)
            EIGEN_FALLBACKS += 1
            evals_np, evecs_np = eigensolve_host(L, massvec_np, k_eig,
                                                 eps=eps)
    _mark("eigensolve")

    # gradient operator over the Laplacian's sparsity (reference
    # geometry.py:331-334,375); a cloud's over its 30-NN graph
    if is_cloud:
        grad_mat = build_grad_point_cloud(verts_np, frames)
    else:
        L_coo = L.tocoo()
        edges = np.stack((L_coo.row, L_coo.col), axis=0)
        edge_vecs = edge_tangent_vectors_np(verts_np, frames, edges)
        grad_mat = build_grad(verts_np.shape[0], edges, edge_vecs)
    _mark("build_grad")

    # split the complex gradient into two real sparse matrices
    gradX_sp = grad_mat.copy()
    gradX_sp.data = np.real(grad_mat.data)
    gradY_sp = grad_mat.copy()
    gradY_sp.data = np.imag(grad_mat.data)

    gradX_ell = _csc_to_ell(gradX_sp, dtype=dtype)
    gradY_ell = _csc_to_ell(gradY_sp, dtype=dtype)
    L_ell = _csc_to_ell(L, dtype=dtype)
    _mark("ell_convert")
    gX_spec, gY_spec = spectral_gradients(gradX_sp, gradY_sp,
                                          evecs_np.astype(dtype))
    _mark("spectral_grad")
    ops = Operators(
        frames=frames.astype(dtype),
        mass=massvec_np.astype(dtype),
        L=L_ell,
        evals=evals_np.astype(dtype),
        evecs=evecs_np.astype(dtype),
        gradX=gradX_ell,
        gradY=gradY_ell,
        gradX_spec=gX_spec,
        gradY_spec=gY_spec,
    )
    if _return_sparse:
        return ops, (L, gradX_sp, gradY_sp)
    return ops


def _write_cache(search_path, verts_np, faces_np, k_eig, ops, sparse_mats):
    L, gradX_sp, gradY_sp = sparse_mats
    f32 = np.float32
    L_csc = L.tocsc().astype(f32)
    gX = gradX_sp.tocsc().astype(f32)
    gY = gradY_sp.tocsc().astype(f32)
    np.savez(
        search_path,
        verts=verts_np.astype(f32),
        frames=ops.frames.astype(f32),
        faces=faces_np,
        k_eig=k_eig,
        mass=ops.mass.astype(f32),
        L_data=L_csc.data.astype(f32), L_indices=L_csc.indices,
        L_indptr=L_csc.indptr, L_shape=L_csc.shape,
        evals=ops.evals.astype(f32),
        evecs=ops.evecs.astype(f32),
        gradX_data=gX.data.astype(f32), gradX_indices=gX.indices,
        gradX_indptr=gX.indptr, gradX_shape=gX.shape,
        gradY_data=gY.data.astype(f32), gradY_indices=gY.indices,
        gradY_indptr=gY.indptr, gradY_shape=gY.shape,
        # beyond the reference's set, as the JAX package writes them: the
        # dense spectral gradient operators
        gradX_spec=(np.zeros((0, 0), f32) if ops.gradX_spec is None
                    else ops.gradX_spec.astype(f32)),
        gradY_spec=(np.zeros((0, 0), f32) if ops.gradY_spec is None
                    else ops.gradY_spec.astype(f32)),
    )


def _read_sp_mat(npzfile, prefix) -> scipy.sparse.csc_matrix:
    return scipy.sparse.csc_matrix(
        (npzfile[prefix + "_data"], npzfile[prefix + "_indices"],
         npzfile[prefix + "_indptr"]), shape=npzfile[prefix + "_shape"])


def get_operators(verts, faces, k_eig: int = 128, op_cache_dir: str | None = None,
                  normals=None, overwrite_cache: bool = False,
                  dtype=np.float32, eigensolver: str = DEFAULT_EIGENSOLVER,
                  device="cuda", timings: dict | None = None) -> Operators:
    """compute_operators with reference-compatible disk caching
    (geometry.py:426-570): SHA1-of-bytes key, linear probing on collision,
    exact array-equality verification, k_eig truncation on load.

    eigensolver, device, timings: as compute_operators (the device solve
    runs on `device`). The cache is keyed on geometry only, so an entry
    written by either eigensolver, or by the JAX package, satisfies a
    request here."""
    verts_np = np.asarray(verts)
    faces_np = (np.asarray(faces) if faces is not None and np.asarray(faces).size
                else np.zeros((0, 3), dtype=np.int64))
    if np.isnan(verts_np).any():
        raise RuntimeError("tried to construct operators from NaN verts")

    search_path = None
    if op_cache_dir is not None:
        utils.ensure_dir_exists(op_cache_dir)
        # canonical key dtypes (f32 verts / int64 faces), as the JAX package
        hash_key_str = str(utils.hash_arrays(
            (verts_np.astype(np.float32), faces_np.astype(np.int64))))
        i_cache_search = 0
        while True:
            search_path = os.path.join(
                op_cache_dir, f"{hash_key_str}_{i_cache_search}.npz")
            try:
                npzfile = np.load(search_path, allow_pickle=True)
                cache_verts = npzfile["verts"]
                cache_faces = npzfile["faces"]
                cache_k_eig = npzfile["k_eig"].item()
                if (not np.array_equal(verts_np.astype(np.float32), cache_verts)
                        or not np.array_equal(faces_np, cache_faces)):
                    i_cache_search += 1
                    print("hash collision! searching next.")
                    continue
                if overwrite_cache:
                    os.remove(search_path)
                    break
                if cache_k_eig < k_eig:
                    print("  overwriting cache --- not enough eigenvalues")
                    os.remove(search_path)
                    break
                if "L_data" not in npzfile:
                    print("  overwriting cache --- entries are absent")
                    os.remove(search_path)
                    break

                gradX_sp = _read_sp_mat(npzfile, "gradX")
                gradY_sp = _read_sp_mat(npzfile, "gradY")
                evecs = npzfile["evecs"][:, :k_eig].astype(dtype)
                if ("gradX_spec" in npzfile.files
                        and npzfile["gradX_spec"].size):
                    gX_spec = npzfile["gradX_spec"][:, :k_eig].astype(dtype)
                    gY_spec = npzfile["gradY_spec"][:, :k_eig].astype(dtype)
                else:  # entry written by the reference
                    gX_spec, gY_spec = spectral_gradients(gradX_sp, gradY_sp,
                                                          evecs)
                return Operators(
                    frames=npzfile["frames"].astype(dtype),
                    mass=npzfile["mass"].astype(dtype),
                    L=_csc_to_ell(_read_sp_mat(npzfile, "L"), dtype=dtype),
                    evals=npzfile["evals"][:k_eig].astype(dtype),
                    evecs=evecs,
                    gradX=_csc_to_ell(gradX_sp, dtype=dtype),
                    gradY=_csc_to_ell(gradY_sp, dtype=dtype),
                    gradX_spec=gX_spec,
                    gradY_spec=gY_spec,
                )
            except FileNotFoundError:
                break
            except Exception as E:
                print("unexpected error loading file: " + str(E))
                print("-- constructing operators")
                break

    ops, sparse_mats = compute_operators(verts_np, faces_np, k_eig,
                                         normals=normals, dtype=dtype,
                                         eigensolver=eigensolver,
                                         device=device,
                                         _return_sparse=True,
                                         timings=timings)
    if search_path is not None:
        _write_cache(search_path, np.asarray(verts_np, dtype=np.float64),
                     faces_np, k_eig, ops, sparse_mats)
    return ops


def get_all_operators(verts_list, faces_list, k_eig: int,
                      op_cache_dir: str | None = None,
                      normals=None,
                      eigensolver: str = DEFAULT_EIGENSOLVER,
                      n_workers: int | None = None,
                      verbose: bool = True,
                      device="cuda",
                      timings: dict | None = None) -> list[Operators]:
    """get_operators over a list of shapes, in order (reference
    geometry.py:395-424). normals: None, or one (V, 3) array (or None) per
    shape.

    n_workers: threads. With the device eigensolver a mesh's work alternates
    between the card (the sweeps) and the host (assembly, the f64 polish),
    so two threads overlap one mesh's host work with the next one's sweeps
    (both release the GIL). Default, as the JAX package: 2 for 'device' on
    a host with at least 4 cores, else 1; 1 for 'host' (ARPACK is
    host-bound). The results equal the sequential loop's: every solve is
    seeded, and the disk cache tolerates concurrent writers.

    timings: optional dict of wall seconds per stage summed over the shapes
    computed (as get_operators'; a shape read from the cache adds none)."""
    N = len(verts_list)
    if n_workers is None:
        n_workers = 2 if (eigensolver == "device"
                          and (os.cpu_count() or 1) >= 4) else 1

    def one(i):
        if verbose:
            print(f"get_all_operators() processing {i} / {N} "
                  f"{i / N * 100:.3f}%")
        ni = None if normals is None else normals[i]
        return get_operators(verts_list[i], faces_list[i], k_eig,
                             op_cache_dir, normals=ni,
                             eigensolver=eigensolver, device=device,
                             timings=stage_seconds[i])

    stage_seconds = [{} for _ in range(N)]  # one dict a shape: no races
    if n_workers <= 1 or N <= 1:
        ops = [one(i) for i in range(N)]
    else:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            ops = list(ex.map(one, range(N)))
    if timings is not None:
        for st in stage_seconds:
            for stage, sec in st.items():
                timings[stage] = timings.get(stage, 0.0) + sec
    return ops


def pad_operators(ops: Operators, v_pad: int, k_eig: int | None = None,
                  d_max_l: int | None = None, d_max_grad: int | None = None
                  ) -> Operators:
    """Pad a (numpy) Operators bundle to static shapes.

    Padded vertices have mass == 0, zero rows in evecs/frames/gradX_spec/
    gradY_spec, and all-zero ELL rows."""
    V = ops.mass.shape[0]
    if v_pad < V:
        raise ValueError(f"v_pad={v_pad} < V={V}")
    K = ops.evals.shape[0]
    k_eig = k_eig if k_eig is not None else K

    def pad_vk(g):
        if g is None:
            return None
        return utils.pad_to(utils.pad_to(g, v_pad, axis=0), k_eig, axis=1)

    return Operators(frames=utils.pad_to(ops.frames, v_pad, axis=0),
                     mass=utils.pad_to(ops.mass, v_pad, axis=0),
                     L=ell_pad(ops.L, v_pad, d_max_l),
                     evals=utils.pad_to(ops.evals, k_eig, axis=0),
                     evecs=pad_vk(ops.evecs),
                     gradX=ell_pad(ops.gradX, v_pad, d_max_grad),
                     gradY=ell_pad(ops.gradY, v_pad, d_max_grad),
                     gradX_spec=pad_vk(ops.gradX_spec),
                     gradY_spec=pad_vk(ops.gradY_spec))


def stack_operators(ops_list: Sequence[Operators],
                    v_pad: int | None = None,
                    k_eig: int | None = None) -> Operators:
    """Stack a list of Operators into one batched bundle with common padding:
    V padded to the largest (or v_pad), k truncated to the smallest (or
    k_eig), ELL degrees padded to the largest."""
    v_pad = v_pad if v_pad is not None else max(o.mass.shape[0] for o in ops_list)
    k_eig = k_eig if k_eig is not None else min(o.evals.shape[0] for o in ops_list)
    d_l = max(o.L.max_degree for o in ops_list)
    d_g = max(max(o.gradX.max_degree, o.gradY.max_degree) for o in ops_list)
    padded = [pad_operators(truncate_k(o, k_eig), v_pad, k_eig, d_l, d_g)
              for o in ops_list]
    return map_operators(lambda *xs: np.stack(xs, axis=0), *padded)


def truncate_k(o: Operators, k_eig: int) -> Operators:
    """The first k_eig eigenpairs (and spectral gradient columns)."""
    return o._replace(
        evals=o.evals[:k_eig], evecs=o.evecs[:, :k_eig],
        gradX_spec=None if o.gradX_spec is None else o.gradX_spec[:, :k_eig],
        gradY_spec=None if o.gradY_spec is None else o.gradY_spec[:, :k_eig])
