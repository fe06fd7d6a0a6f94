"""The ranks of the port's vertex-sharded eigensolver and serving tests
(tests/test_torch_eigen_sharded.py, tests/test_torch_serving_sharded.py):
module-level functions that `diffusionnet_tpu_torch.parallel.launch` runs
in spawned CPU processes over gloo. This module imports torch, numpy and
the port only (jax stays in the pytest process). Each rank reads its
inputs from an npz that the test wrote and returns its results as
arrays."""

from __future__ import annotations

import numpy as np
import torch

from diffusionnet_tpu_torch.geometry import eigen as teig
from diffusionnet_tpu_torch.geometry import Operators
from diffusionnet_tpu_torch.ops.collectives import ordered_sum
from diffusionnet_tpu_torch.ops.sparse import Ell
from diffusionnet_tpu_torch.parallel import VertexGroup, make_mesh
from diffusionnet_tpu_torch.serving import load_sharded_serving_model


def _error(fn) -> str:
    """The message of the ValueError that fn() raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# tests/test_torch_eigen_sharded.py
# ---------------------------------------------------------------------------

def eigen_rank(rank: int, world: int, inputs: str) -> dict:
    """On mesh (1, world): one sweep of the sharded stages from the npz's
    start block, the whole solve (f32, and polished), k_eig 0, and the
    refusal of a V that does not split."""
    torch.set_float32_matmul_precision("highest")
    z = dict(np.load(inputs))
    mesh = make_mesh(vert=world)
    group = mesh.get_group("vert")
    ell = Ell(z["idx"], z["val"])
    mass = z["mass"]
    k = int(z["k"])
    out: dict = {}

    # one sweep: the solver's own stages on this rank's rows
    mask, ism, bound, n_cols, _, lam = teig._device_solver_setup(
        ell, mass, k, None, 1e-8, None, None)
    step = ell.idx.shape[0] // world
    rows = slice(rank * step, (rank + 1) * step)

    def loc(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows]))
    mv = teig._mv_ell(loc(ell.idx), loc(ell.val), loc(ism), loc(mask),
                      bound, 1e-8, gather=VertexGroup(mesh).gather)
    with teig._full_f32_matmul():
        U, w, res = teig._sweep_fn(
            mv, loc(mask), bound, int(z["degree"]),
            lambda t: ordered_sum(t, group))(loc(z["X0"]), np.float32(lam))
    out["sweep/U"], out["sweep/w"], out["sweep/res"] = U.numpy(), w, res

    ev, evecs = teig.eigensolve_device_sharded(ell, mass, k, mesh,
                                               device="cpu")
    out["evals"], out["evecs"] = ev.numpy(), evecs.numpy()
    out["converge"] = np.asarray(teig.LAST_CONVERGE_INFO["sweeps"])
    pe, pv = teig.eigensolve_device_sharded(
        ell, mass, k, mesh, device="cpu",
        polish=(_csr(z), z["mass64"]))
    out["polish/evals"], out["polish/evecs"] = pe, pv
    e0, v0 = teig.eigensolve_device_sharded(ell, mass, 0, mesh, device="cpu")
    out["k0/shapes"] = np.asarray([*e0.shape, *v0.shape])
    out["refuse/divisible"] = _error(lambda: teig.eigensolve_device_sharded(
        Ell(ell.idx[:-2], ell.val[:-2]), mass[:-2], 4, mesh, device="cpu"))
    return out


def _csr(z):
    import scipy.sparse
    return scipy.sparse.csr_matrix(
        (z["csr/data"], z["csr/indices"], z["csr/indptr"]),
        shape=(int(z["csr/n"]),) * 2)


# ---------------------------------------------------------------------------
# tests/test_torch_serving_sharded.py
# ---------------------------------------------------------------------------

def _ops(z, prefix):
    return Operators(frames=None, mass=z[prefix + "mass"], L=None,
                     evals=z[prefix + "evals"], evecs=z[prefix + "evecs"],
                     gradX=None, gradY=None,
                     gradX_spec=z[prefix + "gradX_spec"],
                     gradY_spec=z[prefix + "gradY_spec"])


def serving_rank(rank: int, world: int, inputs: str, dirs: list) -> dict:
    """Each artifact of `dirs` (name=path) loaded on mesh (1, world) and
    served the npz's surface: __call__, call_operators, K truncation,
    PreparedSurface; the guards; and the device-count refusal on a vert
    group of 2."""
    torch.set_float32_matmul_precision("highest")
    z = dict(np.load(inputs))
    out: dict = {}
    mesh = make_mesh(vert=world)
    ops = _ops(z, "ops/")
    x = z["x"]
    pad_k = lambda a: np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, 4)])  # noqa
    for item in dirs:
        name, d = item.split("=", 1)
        sm = load_sharded_serving_model(d, mesh=mesh, device="cpu")
        out[name + "/call"] = sm.call_operators(x, ops).numpy()
        out[name + "/wide_k"] = sm(x, ops.mass, pad_k(ops.evals),
                                   pad_k(ops.evecs), pad_k(ops.gradX_spec),
                                   pad_k(ops.gradY_spec)).numpy()
        handle = sm.prepare_operators(ops)
        out[name + "/prepared"] = handle(x).numpy()
        out[name + "/prepared_tensor"] = handle(torch.from_numpy(x)).numpy()
    v = x.shape[0]
    big = 2 * int(z["bucket"])
    k = ops.evals.shape[0]
    out["refuse/one_surface"] = _error(lambda: sm(
        x[None], ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
        ops.gradY_spec))
    out["refuse/c_in"] = _error(lambda: sm(
        np.zeros((v, 5), np.float32), ops.mass, ops.evals, ops.evecs,
        ops.gradX_spec, ops.gradY_spec))
    out["refuse/bucket"] = _error(lambda: sm(
        np.zeros((big, 3), np.float32), np.ones(big, np.float32), ops.evals,
        *(np.zeros((big, k), np.float32),) * 3))
    out["refuse/narrow_k"] = _error(lambda: sm(
        x, ops.mass, ops.evals[:4], ops.evecs[:, :4], ops.gradX_spec[:, :4],
        ops.gradY_spec[:, :4]))
    out["refuse/prepared"] = _error(lambda: handle(x[:-1]))
    out["refuse/kind"] = _error(lambda: load_sharded_serving_model(
        z["single_dir"].item(), mesh=mesh, device="cpu"))
    two = make_mesh(data=world // 2, vert=2)
    out["refuse/devices"] = _error(lambda: load_sharded_serving_model(
        dirs[0].split("=", 1)[1], mesh=two, device="cpu"))
    return out
