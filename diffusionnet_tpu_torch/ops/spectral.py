"""Spectral transforms and heat kernel signatures on torch tensors.

The counterpart of diffusionnet_tpu/ops/spectral.py (reference
geometry.py:572-633). All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch


def lowp_matmul(a, b, compute_dtype=None, out_dtype=None):
    """a @ b. With compute_dtype (e.g. torch.bfloat16) both operands are
    rounded to it and the product is accumulated in f32 (the JAX package's
    einsum with preferred_element_type=f32). The result is stored in
    out_dtype, by default compute_dtype (then astype)."""
    if compute_dtype is not None:
        a = a.to(compute_dtype).float()
        b = b.to(compute_dtype).float()
    out = a @ b
    dtype = out_dtype or compute_dtype
    return out if dtype is None else out.to(dtype)


def to_basis(values, basis, massvec, compute_dtype=None):
    """Project into the mass-orthonormal basis: phi^T (M (.) x).

    values: (..., V, D); basis: (..., V, K); massvec: (..., V) -> (..., K, D).
    Padded vertices carry mass 0 and contribute nothing. compute_dtype
    (e.g. torch.bfloat16): operands cast to it, f32 accumulation, result
    stored in it."""
    return lowp_matmul(basis.transpose(-1, -2), values * massvec[..., None],
                       compute_dtype)


def from_basis(values, basis, compute_dtype=None):
    """Back-project out of the basis: phi x_hat.

    values: (..., K, D); basis: (..., V, K) -> (..., V, D). compute_dtype as
    in to_basis."""
    return lowp_matmul(basis, values, compute_dtype)


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
