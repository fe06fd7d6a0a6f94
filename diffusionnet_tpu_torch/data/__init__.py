"""Input features and padded batching."""

from .features import get_features, FEATURE_DIMS
from .dataset import PaddedBatch, SurfaceDataset, make_padded_batches
