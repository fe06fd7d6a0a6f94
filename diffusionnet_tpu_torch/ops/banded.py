"""Bandwidth-reducing ordering for the device eigensolver's operator formats.

The counterpart of diffusionnet_tpu/ops/banded.py, so far only its
`rcm_permutation` (host scipy): the blocked-ELL planner (ops/blocked_ell.py)
orders rows with it. The dense RCM band and the DIA format of that module
are queued in ROADMAP item A.8.
"""

from __future__ import annotations

import numpy as np


def rcm_permutation(mat) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (symmetric): new -> old indices."""
    import scipy.sparse
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(
        scipy.sparse.csr_matrix(mat), symmetric_mode=True), dtype=np.int64)
