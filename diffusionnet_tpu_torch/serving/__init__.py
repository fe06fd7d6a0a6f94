"""Serving: export the forward pass as torch.export artifacts and load +
serve them without the model definition: per-bucket programs on one card
(export_forward, load_serving_model, PreparedMesh), and one large surface
vertex-sharded over several ranks (export_sharded_forward,
load_sharded_serving_model, PreparedSurface). See serving.export's module
docstring."""

from .export import (
    PreparedMesh,
    PreparedSurface,
    ServingModel,
    ShardedServingModel,
    export_forward,
    export_sharded_forward,
    load_serving_model,
    load_sharded_serving_model,
)

__all__ = [
    "PreparedMesh",
    "PreparedSurface",
    "ServingModel",
    "ShardedServingModel",
    "export_forward",
    "export_sharded_forward",
    "load_serving_model",
    "load_sharded_serving_model",
]
