"""diffusionnet_tpu_torch — the PyTorch/CUDA port of diffusionnet_tpu.

The JAX package `diffusionnet_tpu` is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find. It imports
torch, numpy and scipy, never jax. Ported so far: the inference path
(host operator precompute with the shared disk cache, HKS features, the eager
DiffusionNet, and the megakernel fast path on the hand-written CUDA block
kernel, csrc/megablock_fwd.cu), the training step (padded batching, the
block's backward kernel csrc/megablock_bwd.cu, dropout, Adam with step
decay), the device eigensolver of the operator precompute (on the
sliced-ELL SpMM kernel csrc/blocked_ell.cu) and the rest of the model
surface (implicit_dense diffusion, ELL gradients, compute_dtype, remat, the
fused spectral block on csrc/spectral_fused.cu, the one-block op
`megablock`, the functional-maps head), and the training harness
(`experiments.exp_common.fit`: the epoch loop, rotation augmentation, the
two input pipelines, full-state checkpoints with an exact resume) with the
device ops of kNN, frames and position normalization. ROADMAP.md lists
what is still to come.
"""

from . import utils
from .utils import hash_arrays, ensure_dir_exists

from . import ops
from .ops import (to_basis, from_basis, compute_hks, compute_hks_autoscale,
                  norm, norm2, normalize, dot, cross, face_coords, face_area,
                  face_normals, project_to_tangent, mesh_vertex_normals,
                  vertex_normals, build_tangent_frames, edge_tangent_vectors,
                  normalize_positions, find_knn, farthest_point_sampling)

from . import geometry
from .geometry import (compute_operators, get_operators, Operators,
                       pad_operators, stack_operators)

from . import models
from .models import (DiffusionNet, DiffusionNetBlock, LearnedTimeDiffusion,
                     SpatialGradientFeatures, MiniMLP,
                     FunctionalMapCorrespondence)

from . import data
from .data import (DeviceDataset, PaddedBatch, SurfaceDataset,
                   make_padded_batches, prefetch_to_device)
from . import training
from .training import (InferenceSession, adam_with_step_decay,
                       make_train_step, save_checkpoint, restore_checkpoint,
                       latest_checkpoint)

__version__ = "0.1.0"
