"""Functional-maps correspondence head: the counterpart of
diffusionnet_tpu/models/fmaps.py (reference
experiments/functional_correspondence/fmaps_model.py). All regularised rows
of the functional map are one batched Cholesky solve, which does not make
the host wait for the card: a singular system is reported in the
factorisation's `info`, on the device, instead of raising.

Also the helpers that the fmaps example and the functional_correspondence
driver share: a shape's input dict, the ground-truth map, one Adam step and
the induced vertex map."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..training.profiling import count, span
from .diffusion_net import DiffusionNet


def compute_fmap(feat_x, feat_y, evals_x, evals_y, evecs_trans_x,
                 evecs_trans_y, lambda_param: float = 1e-3):
    """Least-squares functional map with Laplacian-commutativity
    regularisation.

    feat_x: (..., Vx, C); evecs_trans_x: (..., Kx, Vx) mass-weighted
    transposed eigenvectors; evals_*: (..., K). Returns (C_xy, info): C_xy
    (..., Ky, Kx) maps spectral coefficients on X to Y; info (..., Ky)
    int32, on the device, is 0 where row i's system was solved and else
    the order of the leading minor that is not positive definite (that
    row's values are then meaningless). Nothing here waits for the card."""
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
    # the systems are symmetric positive definite: a batched Cholesky
    # factorisation and two batched triangular solves, none of which waits
    # for the card (torch.linalg.solve raises on a singular system, so it
    # waits to find out, and solve_ex's batched LU waits as well)
    L, info = torch.linalg.cholesky_ex(systems)
    C = torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, rhs, upper=False), upper=True)
    return C[..., 0], info


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

    def forward(self, shape_x: dict, shape_y: dict | None = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None,
                return_info: bool = False):
        """Each shape dict: {features, mass, L, evals, evecs, gradX, gradY}.
        shape_y None: shape_x holds both shapes of P pairs, batched (2P,
        ...), the P first shapes first, and the extractor runs once over
        all 2P (else once a dict). generator: the dropout masks' source in
        training mode. Returns (C_xy (..., n_fmap, n_fmap), feat_x, feat_y),
        and the solve's info (..., n_fmap) with return_info
        (`compute_fmap`)."""
        def extract(s):
            return self.feature_extractor(
                s["features"], s["mass"], evals=s["evals"], evecs=s["evecs"],
                gradX=s["gradX"], gradY=s["gradY"],
                deterministic=deterministic, generator=generator, L=s["L"])

        k = self.n_fmap
        for s in (shape_x, shape_y):
            if s is not None and s["evals"].shape[-1] < k:
                raise ValueError(
                    f"a shape carries only {s['evals'].shape[-1]} eigenpairs "
                    f"but n_fmap={k}; precompute with k_eig >= n_fmap")
        if shape_y is None:
            P = shape_x["features"].shape[0] // 2
            feats = extract(shape_x)
            feat_x, feat_y = feats[:P], feats[P:]
            evals, evecs = shape_x["evals"][..., :k], shape_x["evecs"]
            mass = shape_x["mass"]
            sides = [(evals[:P], evecs[:P], mass[:P]),
                     (evals[P:], evecs[P:], mass[P:])]
        else:
            feat_x = extract(shape_x)
            feat_y = extract(shape_y)
            sides = [(s["evals"][..., :k], s["evecs"], s["mass"])
                     for s in (shape_x, shape_y)]
        with span("dnt.fmap"):
            count("fmap.pairs", feat_x.numel() // feat_x.shape[-2:].numel())
            # (K, V) mass-weighted transposed eigenvectors
            (ev_x, vec_x, m_x), (ev_y, vec_y, m_y) = sides
            C, info = compute_fmap(
                feat_x, feat_y, ev_x, ev_y,
                vec_x[..., :, :k].transpose(-1, -2) * m_x[..., None, :],
                vec_y[..., :, :k].transpose(-1, -2) * m_y[..., None, :],
                lambda_param=self.lambda_param)
        if return_info:
            return C, feat_x, feat_y, info
        return C, feat_x, feat_y


def shape_dict(v, ops, v_pad, k_eig, device, input_features="hks",
               d_l=None, d_g=None, spectral_grads=True):
    """The model's input dict of one shape (numpy verts and Operators),
    padded to v_pad (and ELL degrees d_l, d_g), on device. spectral_grads:
    the dense spectral gradient operators (the example's); False gives the
    ELL ones, as the functional_correspondence driver feeds them."""
    from ..data.features import get_features
    from ..geometry import grad_operators, pad_operators
    from ..utils import pad_to
    dev = pad_operators(ops, v_pad, k_eig, d_l, d_g).to(device)
    gX, gY = grad_operators(dev, prefer_spectral=spectral_grads)
    x = torch.from_numpy(pad_to(np.asarray(v, np.float32), v_pad)).to(device)
    feats = get_features(input_features, x, dev.evals, dev.evecs)
    return dict(features=feats, mass=dev.mass, L=dev.L, evals=dev.evals,
                evecs=dev.evecs, gradX=gX, gradY=gY)


def gt_fmap(ops1, ops2, n_fmap, vts1=None, vts2=None):
    """C_gt (n_fmap, n_fmap): the least-squares map aligning the first
    n_fmap eigenvectors at corresponding samples, float64 lstsq. vts1,
    vts2: the samples' vertex indices (reference
    faust_scape_dataset.py:186-191); None is the identity correspondence."""
    e1 = ops1.evecs[:, :n_fmap]
    e2 = ops2.evecs[:, :n_fmap]
    if vts1 is not None:
        e1, e2 = e1[vts1], e2[vts2]
    sol, *_ = np.linalg.lstsq(e1.astype(np.float64), e2.astype(np.float64),
                              rcond=None)
    return sol.T.astype(np.float32)


def train_step(model, optimizer, s1, s2, C_gt, generator,
               deterministic=False) -> float:
    """One Adam step on the mean squared fmap error; returns the loss."""
    model.train(not deterministic)
    optimizer.zero_grad(set_to_none=True)
    C_pred, _, _ = model(s1, s2, deterministic=deterministic,
                         generator=generator)
    loss = torch.mean((C_pred - C_gt) ** 2)
    loss.backward()
    optimizer.step()
    return float(loss.detach())


def vertex_map(evecs1, evecs2, C_pred):
    """The induced map from shape 2 to shape 1: each vertex of 2 to its
    nearest neighbour in the spectrally aligned embedding of 1."""
    from ..geometry import find_knn_host
    evec1_on_2 = evecs1 @ np.asarray(C_pred).T
    _, pred_2to1 = find_knn_host(evecs2, evec1_on_2, k=1)
    return pred_2to1[:, 0]
