"""Serving: export the forward pass as torch.export artifacts (static vertex
buckets, symbolic batch) and load + serve them without the model
definition. See serving.export's module docstring. The vertex-sharded
artifact comes with ROADMAP item A.6: its entry points here
(export_sharded_forward, load_sharded_serving_model, ShardedServingModel,
PreparedSurface) raise NotImplementedError."""

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
