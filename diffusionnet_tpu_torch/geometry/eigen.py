"""Generalized eigensolver for L phi = lambda M phi (M diagonal lumped mass).

Only the host path of diffusionnet_tpu/geometry/eigen.py: scipy ARPACK
shift-invert with the reference's ladder (geometry.py:336-361), seeded per
attempt so a run is deterministic. The device eigensolver (Chebyshev-filtered
subspace iteration on the blocked-ELL SpMM, kernel B5) comes with ROADMAP
item A.8.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.linalg as sla


def eigensolve_host(L: scipy.sparse.spmatrix, massvec: np.ndarray, k_eig: int,
                    eps: float = 1e-8):
    """Reference-parity host path (ARPACK shift-invert with the retry ladder)."""
    if k_eig == 0:
        return np.zeros((0,)), np.zeros((L.shape[0], 0))

    L_eigsh = (L + scipy.sparse.identity(L.shape[0]) * eps).tocsc()
    Mmat = scipy.sparse.diags(np.asarray(massvec, dtype=np.float64))
    failcount = 0
    while True:
        try:
            # deterministic ARPACK start, seeded per ATTEMPT: a retry still
            # escapes a start-vector-driven convergence failure while the
            # run stays reproducible (and equal to the JAX package's)
            v0 = np.random.RandomState(777 + failcount).randn(L.shape[0])
            evals, evecs = sla.eigsh(L_eigsh, k=k_eig, M=Mmat, sigma=eps,
                                     v0=v0)
            evals = np.clip(evals, a_min=0.0, a_max=float("inf"))
            return evals, evecs
        except Exception as e:  # same ladder as reference geometry.py:345-361
            print(e)
            if failcount > 3:
                raise ValueError("failed to compute eigendecomp")
            failcount += 1
            print(f"--- decomp failed; adding eps ===> count: {failcount}")
            L_eigsh = L_eigsh + scipy.sparse.identity(L.shape[0]) * (eps * 10 ** failcount)
