"""The functional-map correspondence model in plain PyTorch: the yardstick
the benchmark holds the port's correspondence driver to.

Written from the published model (Sharp et al., "DiffusionNet", ACM TOG
2022, section 5.4, and its reference implementation's
experiments/functional_correspondence: fmaps_model.py and
functional_correspondence.py), one shape at a time, on its real vertices
only (no padding, no batching, no kernels):

    feat   = DiffusionNet(xyz @ R), vertex outputs of width C_out; each
             block's tangent gradients are the sparse gradient operators
             (gradX, gradY) applied to the diffused signal:
             gx = G_X (Phi s), gy = G_Y (Phi s), as plain sparse products
    A      = (Phi_x[:, :k] * m_x)^T feat_x;  B likewise on y  (k, C_out)
    D_ij   = (lambda_y,i - lambda_x,j)^2
    row i of C: (A A^T + lam diag(D_i)) C_i^T = (B A^T)_i^T, one solve a
             row, as fmaps_model.py solves them
    loss   = mean over the pairs of each pair's mean (C - C_gt)^2
    C_gt   = the least-squares map that aligns the first k eigenvectors
             of the two shapes at their template samples, float64
             (faust_scape_dataset.py)

The block otherwise is `diffusionnet.forward`'s (its dense helpers and its
straight-through clamp of the diffusion time). Departures from the
published model, each shared with the port's driver:
- the rotation's uniforms and the dropout's are drawn on the card from one
  generator a training step, seeded from the step's seed: first the (2P, 3)
  rotation uniforms of the step's 2P shapes (the P first shapes of its
  pairs, then the P second ones), then each block's keep masks over the
  padded batch (`draws`); the published driver draws them from torch's
  global generators;
- the Householder rotation is written out in the port's order of
  operations (`rotation`), the published utils.py's construction.

Runs inside `diffusionnet.matmul_precision(prec)` ("f32": TF32 off; "tf32"
the control; "f64" the witness). Imports torch and the plain model beside
it only: nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import math

import torch

from . import diffusionnet as ref


def rotation(u: torch.Tensor) -> torch.Tensor:
    """(..., 3) uniforms in [0, 1) -> (..., 3, 3) rotations uniform on
    SO(3), applied to row vectors (points @ R)."""
    theta = u[..., 0] * 2.0 * math.pi
    phi = u[..., 1] * 2.0 * math.pi
    z = u[..., 2] * 2.0
    r = torch.sqrt(z)
    v = torch.stack([torch.sin(phi) * r, torch.cos(phi) * r,
                     torch.sqrt(2.0 - z)], dim=-1)
    st, ct = torch.sin(theta), torch.cos(theta)
    zero, one = torch.zeros_like(st), torch.ones_like(st)
    R = torch.stack([torch.stack([ct, st, zero], -1),
                     torch.stack([-st, ct, zero], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    return (v[..., :, None] * v[..., None, :] - eye) @ R


def draws(step_seed: int, n_shapes: int, v_pad: int, n_block: int,
          widths: list, rotate: bool, device) -> tuple:
    """A training step's (rotation uniforms (n_shapes, 3), or None without
    `rotate`; keep masks {(block, layer): (n_shapes, v_pad, width) bool}):
    one generator on `device` seeded with the step's seed; widths: the
    input widths of the MLP's dense layers (dropout before every layer but
    the first)."""
    g = torch.Generator(device=device).manual_seed(step_seed)
    u = (torch.rand((n_shapes, 3), generator=g, device=device) if rotate
         else None)
    keep = {}
    for b in range(n_block):
        for l, w in enumerate(widths[1:], start=1):
            keep[b, l] = torch.rand((n_shapes, v_pad, w), generator=g,
                                    device=device) >= 0.5
    return u, keep


def sparse(idx: torch.Tensor, val: torch.Tensor, V: int) -> torch.Tensor:
    """The (V, V) sparse matrix of ELL rows idx, val (V, D); entries that
    share a place add."""
    rows = torch.arange(V, device=idx.device)[:, None].expand_as(idx)
    return torch.sparse_coo_tensor(
        torch.stack([rows.reshape(-1), idx.reshape(-1).long()]),
        val.reshape(-1), (V, V), check_invariants=False).coalesce()


def features(p: dict, xyz, mass, evals, evecs, GX, GY, n_block: int,
             masks=None) -> torch.Tensor:
    """The shared extractor's (V, C_out) features of one shape. p: flat
    parameters under params/feature_extractor/...; GX, GY: sparse (V, V);
    masks: None, or masks(block, layer, rows, width) -> the keep mask."""
    q = {k.replace("params/feature_extractor/", "params/", 1): v
         for k, v in p.items()}
    x = ref._dense(q, "params/first_lin", xyz)
    for b in range(n_block):
        pre = f"params/block_{b}/"
        t = ref._clamped_time(q[pre + "diffusion/diffusion_time"])
        coefs = torch.exp(-evals[:, None] * t)
        s = coefs * (evecs.T @ (x * mass[:, None]))
        xd = evecs @ s
        gx, gy = GX @ xd, GY @ xd
        A_re = q[pre + "gradient_features/A_re/kernel"]
        A_im = q[pre + "gradient_features/A_im/kernel"]
        vb_re = gx @ A_re - gy @ A_im
        vb_im = gy @ A_re + gx @ A_im
        h = torch.cat([x, xd, torch.tanh(gx * vb_re + gy * vb_im)], -1)
        n_dense = sum(1 for k in q if k.startswith(pre + "mlp/")
                      and k.endswith("/kernel"))
        for l in range(n_dense):
            if l > 0 and masks is not None:
                keep = masks(b, l, h.shape[0], h.shape[1])
                h = torch.where(keep, h / ref.DROPOUT_KEEP,
                                torch.zeros_like(h))
            h = ref._dense(q, f"{pre}mlp/dense_{l:03d}", h)
            if l < n_dense - 1:
                h = torch.relu(h)
        x = h + x
    return ref._dense(q, "params/last_lin", x)


def fmap(feat_x, feat_y, evals_x, evals_y, evecs_x, evecs_y, mass_x, mass_y,
         k: int, lam: float) -> torch.Tensor:
    """C (k, k), the map of X's spectral coefficients to Y's, one row
    at a time."""
    A = (evecs_x[:, :k] * mass_x[:, None]).T @ feat_x
    B = (evecs_y[:, :k] * mass_y[:, None]).T @ feat_y
    D = (evals_y[:k, None] - evals_x[None, :k]) ** 2
    AAt, BAt = A @ A.T, B @ A.T
    rows = [torch.linalg.solve(AAt + lam * torch.diag(D[i]), BAt[i])
            for i in range(k)]
    return torch.stack(rows)


def gt_map(evecs1, evecs2, vts1, vts2, k: int) -> torch.Tensor:
    """C_gt (k, k), float64 least squares: C_gt^T = argmin |E1 X - E2| over
    the shapes' eigenvectors at their template samples."""
    e1 = evecs1[vts1, :k].double()
    e2 = evecs2[vts2, :k].double()
    return torch.linalg.lstsq(e1, e2).solution.T
