"""Tensor ops: vector and face math, tangent frames, position
normalization, kNN and farthest-point sampling, spectral transforms and
HKS, the ELL layout and its gather product, the block kernels' wrappers (megablock), the fused spectral block
(kernel B4's wrappers, fused), and the sliced-ELL SpMM of the device
eigensolver (kernel B5's wrapper, blocked_ell)."""

from .vector import (norm, norm2, normalize, dot, cross, face_coords,
                     face_area, face_normals, project_to_tangent)
from .frames import (mesh_vertex_normals, vertex_normals,
                     build_tangent_frames, edge_tangent_vectors)
from .transforms import normalize_positions
from .knn import find_knn, farthest_point_sampling
from .spectral import to_basis, from_basis, compute_hks, compute_hks_autoscale
from .sparse import Ell, ell_from_coo, ell_matvec, ell_pad, ell_to_dense
from .blocked_ell import (SlicedEll, blocked_ell_from_sparse,
                          blocked_ell_matvec, blocked_ell_matvec_reference)
# the B3 op is ops.megablock.megablock: a name here would shadow the module
from .megablock import (megablock_chained, megablock_chained_reference,
                        xhat_reduce, xhat_reduce_reference, LAUNCHES,
                        reset_launches)
from .fused import (fused_spectral_block, fused_spectral_block_batched,
                    fused_spectral_block_reference)
