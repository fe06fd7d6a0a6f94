"""Functional-maps correspondence head: the counterpart of
diffusionnet_tpu/models/fmaps.py (reference
experiments/functional_correspondence/fmaps_model.py). All regularised rows
of the functional map are one batched linear solve."""

from __future__ import annotations

import torch
from torch import nn

from .diffusion_net import DiffusionNet


def compute_fmap(feat_x, feat_y, evals_x, evals_y, evecs_trans_x,
                 evecs_trans_y, lambda_param: float = 1e-3):
    """Least-squares functional map with Laplacian-commutativity
    regularisation.

    feat_x: (..., Vx, C); evecs_trans_x: (..., Kx, Vx) mass-weighted
    transposed eigenvectors; evals_*: (..., K). Returns C_xy (..., Ky, Kx)
    mapping spectral coefficients on X to Y."""
    A = evecs_trans_x @ feat_x                       # (..., Kx, C)
    B = evecs_trans_y @ feat_y                       # (..., Ky, C)
    D = (evals_y[..., :, None] - evals_x[..., None, :]) ** 2  # (..., Ky, Kx)
    A_t = A.transpose(-1, -2)
    A_A_t = A @ A_t                                  # (..., Kx, Kx)
    B_A_t = B @ A_t                                  # (..., Ky, Kx)
    # row i of C solves (A A^T + lambda diag(D_i)) C_i^T = (B A^T)_i^T: all
    # Ky systems in one batched solve
    eye = torch.eye(D.shape[-1], dtype=A.dtype, device=A.device)
    systems = A_A_t[..., None, :, :] + lambda_param * (D[..., :, None] * eye)
    rhs = B_A_t[..., :, :, None]                     # (..., Ky, Kx, 1)
    return torch.linalg.solve(systems, rhs)[..., 0]  # (..., Ky, Kx)


class FunctionalMapCorrespondence(nn.Module):
    """Shared-weights DiffusionNet feature extractor + parameter-free fmap
    solver (reference fmaps_model.py:43-89). Its weights map to the JAX
    tree's `params/feature_extractor/...` through models.params.

    generator: the torch.Generator the weights are drawn from (CPU)."""

    def __init__(self, c_in: int, c_out: int = 128, c_width: int = 128,
                 n_block: int = 4, n_fmap: int = 30,
                 lambda_param: float = 1e-3, input_features: str = "xyz",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_fmap = n_fmap
        self.lambda_param = lambda_param
        self.input_features = input_features  # documentation only
        self.feature_extractor = DiffusionNet(
            c_in=c_in, c_out=c_out, c_width=c_width, n_block=n_block,
            dropout=True, outputs_at="vertices", generator=generator)

    def forward(self, shape_x: dict, shape_y: dict,
                deterministic: bool = True,
                generator: torch.Generator | None = None):
        """Each shape dict: {features, mass, L, evals, evecs, gradX, gradY}.
        generator: the dropout masks' source in training mode. Returns
        (C_xy (n_fmap, n_fmap), feat_x, feat_y)."""
        def extract(s):
            return self.feature_extractor(
                s["features"], s["mass"], evals=s["evals"], evecs=s["evecs"],
                gradX=s["gradX"], gradY=s["gradY"],
                deterministic=deterministic, generator=generator, L=s["L"])

        feat_x = extract(shape_x)
        feat_y = extract(shape_y)
        k = self.n_fmap
        for name, s in (("shape_x", shape_x), ("shape_y", shape_y)):
            if s["evals"].shape[-1] < k:
                raise ValueError(
                    f"{name} carries only {s['evals'].shape[-1]} eigenpairs "
                    f"but n_fmap={k}; precompute with k_eig >= n_fmap")

        def trans(s):
            # (K, V) mass-weighted transposed eigenvectors
            return (s["evecs"][..., :, :k].transpose(-1, -2)
                    * s["mass"][..., None, :])

        C = compute_fmap(feat_x, feat_y, shape_x["evals"][..., :k],
                         shape_y["evals"][..., :k], trans(shape_x),
                         trans(shape_y), lambda_param=self.lambda_param)
        return C, feat_x, feat_y
