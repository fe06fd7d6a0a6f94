"""Spectral transforms and heat kernel signatures on torch tensors.

The counterpart of diffusionnet_tpu/ops/spectral.py (reference
geometry.py:572-633). All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch


def to_basis(values, basis, massvec):
    """Project into the mass-orthonormal basis: phi^T (M (.) x).

    values: (..., V, D); basis: (..., V, K); massvec: (..., V) -> (..., K, D).
    Padded vertices carry mass 0 and contribute nothing."""
    return basis.transpose(-1, -2) @ (values * massvec[..., None])


def from_basis(values, basis):
    """Back-project out of the basis: phi x_hat.

    values: (..., K, D); basis: (..., V, K) -> (..., V, D)."""
    return basis @ values


def compute_hks(evals, evecs, scales):
    """Heat kernel signature at S time scales, as one (V,K)x(K,S) product.

    evals: (..., K); evecs: (..., V, K); scales: (..., S) -> (..., V, S)."""
    # coefs[s,k] = exp(-eval_k * scale_s)
    power_coefs = torch.exp(-evals[..., None, :] * scales[..., :, None])
    return (evecs * evecs) @ power_coefs.transpose(-1, -2)


def compute_hks_autoscale(evals, evecs, count: int = 16):
    """HKS at `count` log-spaced times in [1e-2, 1] (reference
    geometry.py:630-633)."""
    scales = torch.logspace(-2.0, 0.0, steps=count, dtype=evals.dtype,
                            device=evals.device)
    if evals.ndim > 1:  # broadcast scales over batch dims
        scales = scales.expand(evals.shape[:-1] + (count,))
    return compute_hks(evals, evecs, scales)
