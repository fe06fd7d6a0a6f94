"""Input features."""

from .features import get_features, FEATURE_DIMS
