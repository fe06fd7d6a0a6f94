"""torch modules: the eager DiffusionNet, the functional-maps head, the
weight bridge to the JAX package's parameters, and the megakernel fast
path."""

from .diffusion_net import (DiffusionNet, DiffusionNetBlock,
                            LearnedTimeDiffusion, SpatialGradientFeatures,
                            MiniMLP)
from .fmaps import FunctionalMapCorrespondence, compute_fmap
from .params import from_flat_jax_params, module_state, to_flat_jax_params
from .fast_path import megablock_apply, flat_params
