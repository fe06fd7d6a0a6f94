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
device ops of kNN, frames and position normalization, and serving
(`serving`: per-bucket torch.export artifacts that carry kernel B4 as
registered ops, their loader and device-resident mesh handles), and
point clouds, geodesics and mesh IO (the robust, tufted and point-cloud
Laplacians on the native host library native/, exact, Steiner, graph and
heat-method geodesics, the heat method on the card, OFF/OBJ/PLY IO), and
the five experiment drivers with their dataset loaders and the
reference-checkpoint converter (`experiments.<suite>.<driver>`), and
training over several cards (`parallel`: data parallelism and the
(data, vert) vertex-sharded step, one process a card over
torch.distributed) with the host-parallel precompute.
ROADMAP.md lists what is still to come.
"""

import importlib

# Subpackages and names load when first used (PEP 562), so that a module
# that needs little loads little: `import diffusionnet_tpu_torch.serving`
# loads the serving module and the kernel ops, and none of geometry,
# models, training, data or experiments.
_SUBMODULES = ("utils", "ops", "geometry", "models", "data", "training",
               "serving", "experiments", "examples", "native", "parallel")
_NAMES = {
    "utils": ("hash_arrays", "ensure_dir_exists"),
    "ops": ("to_basis", "from_basis", "compute_hks", "compute_hks_autoscale",
            "norm", "norm2", "normalize", "dot", "cross", "face_coords",
            "face_area", "face_normals", "project_to_tangent",
            "mesh_vertex_normals", "vertex_normals", "build_tangent_frames",
            "edge_tangent_vectors", "normalize_positions", "find_knn",
            "farthest_point_sampling"),
    "geometry": ("compute_operators", "get_operators", "get_all_operators",
                 "Operators", "pad_operators", "stack_operators",
                 "geodesic_label_errors", "get_all_pairs_geodesic_distance"),
    "models": ("DiffusionNet", "DiffusionNetBlock", "LearnedTimeDiffusion",
               "SpatialGradientFeatures", "MiniMLP",
               "FunctionalMapCorrespondence"),
    "data": ("DeviceDataset", "PaddedBatch", "SurfaceDataset",
             "make_padded_batches", "prefetch_to_device"),
    "training": ("InferenceSession", "adam_with_step_decay",
                 "make_train_step", "save_checkpoint", "restore_checkpoint",
                 "latest_checkpoint"),
    "serving": ("export_forward", "load_serving_model", "ServingModel",
                "PreparedMesh"),
}
_HOME = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = [*_SUBMODULES, *_HOME]
__version__ = "0.1.0"


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _HOME:
        return getattr(importlib.import_module(f".{_HOME[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
