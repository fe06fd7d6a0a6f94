"""Input features, padded batching and the two input pipelines."""

from .features import get_features, FEATURE_DIMS
from .dataset import (DeviceDataset, PaddedBatch, SurfaceDataset,
                      make_padded_batches, prefetch_to_device)
