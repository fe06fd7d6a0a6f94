"""Tensor ops: spectral transforms and HKS, the ELL layout and its gather
product, the block kernels' wrappers (megablock), the fused spectral block
(kernel B4's wrappers, fused), and the blocked-ELL SpMM of the device
eigensolver (kernel B5's wrapper)."""

from .spectral import to_basis, from_basis, compute_hks, compute_hks_autoscale
from .sparse import Ell, ell_from_coo, ell_matvec, ell_pad, ell_to_dense
from .blocked_ell import (BlockedEll, blocked_ell_from_sparse,
                          blocked_ell_matvec, blocked_ell_matvec_reference)
# the B3 op is ops.megablock.megablock: a name here would shadow the module
from .megablock import (megablock_chained, megablock_chained_reference,
                        xhat_reduce, xhat_reduce_reference, LAUNCHES,
                        reset_launches)
from .fused import (fused_spectral_block, fused_spectral_block_batched,
                    fused_spectral_block_reference)
