"""Tensor ops: spectral transforms and HKS, the host ELL layout, and the
block kernel's wrapper (megablock)."""

from .spectral import to_basis, from_basis, compute_hks, compute_hks_autoscale
from .sparse import Ell, ell_from_coo, ell_pad
from .megablock import (megablock_chained, megablock_chained_reference,
                        xhat_reduce, xhat_reduce_reference, LAUNCHES,
                        reset_launches)
