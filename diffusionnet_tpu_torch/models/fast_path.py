"""Megakernel fast path: a DiffusionNet forward with each block as one
`megablock_chained` call (kernel B1). The counterpart of
diffusionnet_tpu/models/fast_path.py, forward only.

Supported configuration: spectral diffusion with dense spectral gradient
operators and gradient features, with or without gradient rotations, any
MLP hidden widths, dropout off. The block-0 projection x_hat = Phi^T (m x),
first_lin, last_lin and coefs = exp(-evals t) are plain torch, as the JAX
package computes them outside Pallas. One kernel launch per block covers the
whole batch, plus one x_hat partial-sum launch per block that feeds a next
block.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.megablock import megablock_chained
from .params import to_flat_jax_params


def flat_params(model: nn.Module, device=None) -> dict[str, torch.Tensor]:
    """The model's weights as JAX-layout flat tensors (kernels (in, out),
    contiguous), the form `megablock_apply` reads."""
    device = device if device is not None else next(model.parameters()).device
    return {k: torch.from_numpy(v).to(device)
            for k, v in to_flat_jax_params(model).items()}


def _block_params(params: dict, b: int):
    p = f"params/block_{b}/"
    t = params[p + "diffusion/diffusion_time"]
    n_dense = sum(1 for k in params
                  if k.startswith(p + "mlp/") and k.endswith("/kernel"))
    Ws = tuple(params[f"{p}mlp/dense_{l:03d}/kernel"] for l in range(n_dense))
    bs = tuple(params[f"{p}mlp/dense_{l:03d}/bias"] for l in range(n_dense))
    if p + "gradient_features/A/kernel" in params:
        # with_gradient_rotations=False: vb_re = gx A, vb_im = gy A
        A = params[p + "gradient_features/A/kernel"]
        return t, A, torch.zeros_like(A), Ws, bs
    return (t, params[p + "gradient_features/A_re/kernel"],
            params[p + "gradient_features/A_im/kernel"], Ws, bs)


def megablock_apply(params, x_in, mass, evals, evecs, gX_spec, gY_spec,
                    n_block: int, last_activation=None, dropout_rng=None,
                    xhat_reduce=None):
    """Forward pass equal to DiffusionNet for the supported configuration,
    with each block as ONE batched kernel launch.

    params: the model's flat JAX-layout tensors (`flat_params`). x_in
    (B, V, C_in); evecs/gX_spec/gY_spec (B, V, K); mass
    (B, V); evals (B, K). The operand precision follows evecs: bf16 evecs run
    every product on bf16 operands (f32 accumulation).

    xhat_reduce: optional callable applied to each block's x_hat = Phi^T(m x)
    (vertex sharding sums the per-shard partials through it)."""
    if dropout_rng is not None:
        raise NotImplementedError(
            "dropout in the block kernel comes with the training slice "
            "(ROADMAP item A.3)")
    lowp = evecs.dtype == torch.bfloat16

    x = (x_in.float() @ params["params/first_lin/kernel"]
         + params["params/first_lin/bias"])
    # inter-block activations inherit the input precision
    x = x.to(x_in.dtype)

    # block 0's projection is plain torch; every later block receives its
    # x_hat from the previous block's kernel
    x_hat = evecs.float().transpose(-1, -2) @ (x.float() * mass[..., None])
    if xhat_reduce is not None:
        x_hat = xhat_reduce(x_hat)
    for b in range(n_block):
        t, A_re, A_im, Ws, bs = _block_params(params, b)
        t = torch.clamp(t, min=1e-8)
        coefs = torch.exp(-evals[..., None] * t).contiguous()  # (B, K, C)
        x, x_hat = megablock_chained(
            x, evecs, gX_spec, gY_spec, mass, coefs, A_re, A_im, Ws, bs,
            x_hat, emit_next=b < n_block - 1, lowp=lowp)
        if x_hat is not None and xhat_reduce is not None:
            x_hat = xhat_reduce(x_hat)

    x = (x.float() @ params["params/last_lin/kernel"]
         + params["params/last_lin/bias"])
    if last_activation is not None:
        x = last_activation(x)
    return x
