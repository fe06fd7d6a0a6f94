"""Input feature construction: 'xyz' raw positions or 'hks' heat kernel
signatures (the 16-scale autoscale variant, reference geometry.py:630-633).
The counterpart of diffusionnet_tpu/data/features.py."""

from __future__ import annotations

import torch

from ..ops.spectral import compute_hks_autoscale

# channel count per feature type: the DiffusionNet c_in of every experiment
FEATURE_DIMS = {"xyz": 3, "hks": 16}


def get_features(kind: str, verts, evals, evecs):
    """Build network input features (torch tensors in, torch tensor out).

    kind: 'xyz' | 'hks'; verts: (..., V, 3); evals: (..., K); evecs: (..., V, K).
    Returns (..., V, FEATURE_DIMS[kind]). Padding rows of evecs are zero, so
    padded HKS rows are exactly zero."""
    if kind == "xyz":
        return torch.as_tensor(verts)
    if kind == "hks":
        return compute_hks_autoscale(evals, evecs, count=FEATURE_DIMS["hks"])
    raise ValueError(f"unrecognized input feature type '{kind}' "
                     "(expected 'xyz' or 'hks')")
