"""DiffusionNet in plain PyTorch: the yardstick the benchmark holds the port to.

Written from the published model (Sharp et al., "DiffusionNet:
Discretization Agnostic Learning on Surfaces", ACM TOG 2022, and its
reference implementation's layers.py), for one surface at a time, on its
real vertices and faces only (no padding, no batching, no kernels):

    x      = first_lin(features)
    block: x_hat = Phi^T (m * x);  s = exp(-lambda t) * x_hat
           xd = Phi s;  gx = GX s;  gy = GY s          (spectral gradients)
           feat = tanh(gx * (gx A_re - gy A_im) + gy * (gy A_re + gx A_im))
           x = MLP([x, xd, feat]) + x                  (Dropout before every
                                                        layer but the first)
    out    = log_softmax(last_lin(x)), averaged over each face's 3 vertices
             first where the outputs sit at faces

The diffusion time's clamp at 1e-8 is straight-through (value clamped,
gradient passed), as the reference clamps `.data`. Parameters are a dict
of flat tensors under the JAX-layout keys (`params/block_0/mlp/dense_000/
kernel`, kernels (in, out)), which is how the benchmark makes weights.

The caller runs it inside `matmul_precision(prec)`: "f32" (true float32:
TF32 off), "tf32" (on the card, the lower precision a later change could
slip in: the control) or "f64" (a witness above both, on float64 inputs).

This module imports torch only: nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import contextlib
import math

import torch

DROPOUT_KEEP = 0.5


@contextlib.contextmanager
def matmul_precision(prec: str):
    """TF32 on the card on for "tf32", off for "f32" and "f64"; restored
    after."""
    if prec not in ("f32", "tf32", "f64"):
        raise ValueError(f"precision must be 'f32', 'tf32' or 'f64', got "
                         f"{prec!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = prec == "tf32"
    torch.backends.cudnn.allow_tf32 = prec == "tf32"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def hks(evals: torch.Tensor, evecs: torch.Tensor,
        count: int = 16) -> torch.Tensor:
    """Heat kernel signature at `count` times log-spaced in [1e-2, 1]:
    sum_k exp(-lambda_k t) phi_k(v)^2, (V, count)."""
    t = torch.logspace(-2.0, 0.0, steps=count, dtype=evals.dtype,
                       device=evals.device)
    return (evecs * evecs) @ torch.exp(-evals[None, :] * t[:, None]).T


def rotation_y(u: torch.Tensor) -> torch.Tensor:
    """(B,) uniforms -> (B, 3, 3) rotations about Y by the angle 2 pi u,
    applied to row vectors (points @ R)."""
    a = u * (2.0 * math.pi)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def _clamped_time(t: torch.Tensor) -> torch.Tensor:
    return t + (torch.clamp(t, min=1e-8) - t).detach()


def _dense(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[name + "/kernel"] + p[name + "/bias"]


def forward(p: dict, feats, mass, evals, evecs, gX, gY, n_block: int,
            faces=None, masks=None) -> torch.Tensor:
    """Log-probabilities of one surface: (V, n_class), or (F, n_class)
    with `faces` (F, 3).

    masks: None (no dropout), or masks(block, layer, rows, width) -> the
    (rows, width) boolean keep mask of the MLP input of `layer` (>= 1) in
    `block`."""
    x = _dense(p, "params/first_lin", feats)
    for b in range(n_block):
        pre = f"params/block_{b}/"
        coefs = torch.exp(-evals[:, None]
                          * _clamped_time(p[pre + "diffusion/diffusion_time"]))
        s = coefs * (evecs.T @ (x * mass[:, None]))
        xd, gx, gy = evecs @ s, gX @ s, gY @ s
        A_re = p[pre + "gradient_features/A_re/kernel"]
        A_im = p[pre + "gradient_features/A_im/kernel"]
        vb_re = gx @ A_re - gy @ A_im
        vb_im = gy @ A_re + gx @ A_im
        h = torch.cat([x, xd, torch.tanh(gx * vb_re + gy * vb_im)], -1)
        n_dense = sum(1 for k in p if k.startswith(pre + "mlp/")
                      and k.endswith("/kernel"))
        for l in range(n_dense):
            if l > 0 and masks is not None:
                keep = masks(b, l, h.shape[0], h.shape[1])
                h = torch.where(keep, h / DROPOUT_KEEP, torch.zeros_like(h))
            h = _dense(p, f"{pre}mlp/dense_{l:03d}", h)
            if l < n_dense - 1:
                h = torch.relu(h)
        x = h + x
    x = _dense(p, "params/last_lin", x)
    if faces is not None:
        x = (x[faces[:, 0]] + x[faces[:, 1]] + x[faces[:, 2]]) / 3.0
    return torch.log_softmax(x, dim=-1)
