"""Megakernel fast path: a DiffusionNet forward with each block as one
`megablock_chained` call (kernel B1 forward, kernel B2 backward). The
counterpart of diffusionnet_tpu/models/fast_path.py.

Supported configuration: spectral diffusion with dense spectral gradient
operators and gradient features, with or without gradient rotations, any
MLP hidden widths, dropout on (rate 0.5) or off. The block-0 projection
x_hat = Phi^T (m x), first_lin, last_lin and coefs = exp(-evals t) are plain
torch, as the JAX package computes them outside Pallas. One kernel launch
per block covers the whole batch, plus one x_hat partial-sum launch per
block that feeds a next block; the backward is one B2 launch and two
partial-sum launches per block.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.megablock import DEFAULT_TILE_V, megablock_chained
from ..utils import fold_seed
from .params import to_flat_jax_params


def flat_params(model: nn.Module, device=None, requires_grad: bool = False
                ) -> dict[str, torch.Tensor]:
    """The model's weights as JAX-layout flat tensors (kernels (in, out),
    contiguous), the form `megablock_apply` reads. With requires_grad they
    are new leaf tensors: the train state of `training.fit`, which
    `from_flat_jax_params` takes back into a module."""
    device = device if device is not None else next(model.parameters()).device
    # torch.tensor copies: a CPU state must not share storage with the
    # module's parameters (to_flat_jax_params' arrays view the 1-D ones)
    return {k: torch.tensor(v, device=device).requires_grad_(requires_grad)
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
                    n_block: int, tile_v: int = DEFAULT_TILE_V,
                    last_activation=None, dropout_rng=None,
                    xhat_reduce=None, seed_fold: int = 0):
    """Forward pass equal to DiffusionNet for the supported configuration,
    with each block as ONE batched kernel launch; differentiable in params.

    params: the model's flat JAX-layout tensors (`flat_params`). x_in
    (B, V, C_in); evecs/gX_spec/gY_spec (B, V, K); mass (B, V); evals
    (B, K). The operand precision follows evecs: bf16 evecs run every
    product on bf16 operands (f32 accumulation).

    dropout_rng: None, or a torch.Generator (on the CPU) that turns MiniMLP
    dropout (rate 0.5) on; it draws one seed per block in [0, 2^31 - 1), as
    the JAX package's randint(fold_in(rng, b)) does (the bits differ). The
    masks are tiled in tile_v rows, so V must then be a multiple of tile_v.

    xhat_reduce: optional callable applied to each block's x_hat = Phi^T(m x)
    (vertex sharding sums the per-shard partials through it).
    seed_fold: folded into each block's dropout seed (`utils.fold_seed`;
    0 keeps it). Vertex sharding passes the shard's index: the kernels hash
    the local tile index, so shards given one seed would draw the same
    masks."""
    lowp = evecs.dtype == torch.bfloat16
    if dropout_rng is not None:
        # the kernels fold (batch, tile, layer) into ONE int32 key
        # ((b * 65536 + i) * 16 + layer); the packing is exact only inside
        # these bounds -- outside them keys collide and masks correlate
        # across batch elements, so refuse
        B, V = x_in.shape[0], x_in.shape[-2]
        n_tiles = -(-V // tile_v)
        n_mlp = len(_block_params(params, 0)[3])
        problems = []
        if B > 2048:
            problems.append(f"batch {B} > 2048")
        if n_tiles > 65536:
            problems.append(f"V/tile_v = {n_tiles} tiles > 65536")
        if n_mlp - 1 > 16:
            problems.append(f"{n_mlp - 1} dropout layers > 16")
        if problems:
            raise ValueError(
                "megakernel dropout key packing out of range ("
                + "; ".join(problems) + "); use the eager model for this "
                "config")

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
        # straight-through clamp: the value is >= 1e-8, the gradient passes
        # (diffusion times start at 0)
        t = t + (torch.clamp(t, min=1e-8) - t).detach()
        coefs = torch.exp(-evals[..., None] * t).contiguous()  # (B, K, C)
        seed = None
        if dropout_rng is not None:
            seed = fold_seed(int(torch.randint(0, 2 ** 31 - 1, (),
                                               generator=dropout_rng)),
                             seed_fold, 2 ** 31 - 1)
        x, x_hat = megablock_chained(
            x, evecs, gX_spec, gY_spec, mass, coefs, A_re, A_im, Ws, bs,
            x_hat, emit_next=b < n_block - 1, lowp=lowp, seed=seed,
            tile_v=tile_v)
        if x_hat is not None and xhat_reduce is not None:
            x_hat = xhat_reduce(x_hat)

    x = (x.float() @ params["params/last_lin/kernel"]
         + params["params/last_lin/bias"])
    if last_activation is not None:
        x = last_activation(x)
    return x
