"""DiffusionNet as torch nn.Modules — the eager model.

The counterpart of diffusionnet_tpu/models/diffusion_net.py, on the dense
spectral-gradient path: gradX/gradY are the (V, K) spectral gradient
operators (Operators.gradX_spec), so every product in a block is dense. This
eager model is the plain reference for the whole model; the CUDA main path
(models/fast_path.py) does not call it.

Initialisation follows flax's `Dense` defaults in distribution: a
lecun-normal kernel (truncated normal, fan-in scaled), zero bias, and zero
diffusion times. It draws from an explicit torch.Generator on the CPU, so one
seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.spectral import from_basis, to_basis

# flax's truncated-normal variance scaling divides the stddev by the std of a
# unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """In place: flax's lecun_normal for an nn.Linear weight (out, in)."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        w = torch.empty(weight.shape, dtype=torch.float32)
        nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)
        weight.copy_(w)


def _dense(c_in: int, c_out: int, bias: bool = True) -> nn.Linear:
    return nn.Linear(c_in, c_out, bias=bias, device="meta")


class LearnedTimeDiffusion(nn.Module):
    """Per-channel learned diffusion time, spectral method (reference
    layers.py:17-90). The clamp is a straight-through projection: the value
    is clamped to >= 1e-8, the gradient is the identity."""

    def __init__(self, c_inout: int, method: str = "spectral"):
        super().__init__()
        if method == "implicit_dense":
            raise NotImplementedError(
                "implicit_dense diffusion comes with ROADMAP item A.5")
        if method != "spectral":
            raise ValueError("unrecognized method")
        self.c_inout = c_inout
        self.diffusion_time = nn.Parameter(torch.zeros(c_inout))

    def time(self) -> torch.Tensor:
        t = self.diffusion_time
        return t + (torch.clamp(t, min=1e-8) - t).detach()

    def coefs(self, evals) -> torch.Tensor:
        """Per-channel diffusion coefficients exp(-evals t): (..., K, C)."""
        return torch.exp(-evals[..., :, None] * self.time())

    def forward(self, x, mass, evals, evecs):
        """Returns (x_diffuse, x_diffuse_spec)."""
        if x.shape[-1] != self.c_inout:
            raise ValueError(
                f"Tensor has wrong shape = {tuple(x.shape)}. Last dim shape "
                f"should have number of channels = {self.c_inout}")
        x_diffuse_spec = self.coefs(evals) * to_basis(x, evecs, mass)
        return from_basis(x_diffuse_spec, evecs), x_diffuse_spec


class SpatialGradientFeatures(nn.Module):
    """Inner products between tangent gradients through a learned
    complex-linear map (reference layers.py:93-130).
    forward(vX, vY): two (..., V, C) -> (..., V, C)."""

    def __init__(self, c_inout: int, with_gradient_rotations: bool = True):
        super().__init__()
        self.with_gradient_rotations = with_gradient_rotations
        if with_gradient_rotations:
            self.A_re = _dense(c_inout, c_inout, bias=False)
            self.A_im = _dense(c_inout, c_inout, bias=False)
        else:
            self.A = _dense(c_inout, c_inout, bias=False)

    def forward(self, vX, vY):
        if self.with_gradient_rotations:
            vb_re = self.A_re(vX) - self.A_im(vY)
            vb_im = self.A_re(vY) + self.A_im(vX)
        else:
            vb_re = self.A(vX)
            vb_im = self.A(vY)
        return torch.tanh(vX * vb_re + vY * vb_im)


class MiniMLP(nn.Module):
    """Linear+ReLU stack, no activation after the last layer (reference
    layers.py:133-164). With `dropout`, Dropout(0.5) before every layer
    except the first, active when deterministic is False: its masks come
    from `generator` (a torch.Generator on the tensors' device, or None for
    torch's default one), so they differ from flax's bits but not in law."""

    def __init__(self, layer_sizes: Sequence[int], dropout: bool = False):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList(
            _dense(layer_sizes[i], layer_sizes[i + 1])
            for i in range(len(layer_sizes) - 1))

    def forward(self, x, deterministic: bool = True,
                generator: torch.Generator | None = None):
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            if self.dropout and not deterministic and i > 0:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) >= 0.5
                x = torch.where(keep, x * 2.0, torch.zeros_like(x))
            x = lin(x)
            if i < n - 1:
                x = torch.relu(x)
        return x


class DiffusionNetBlock(nn.Module):
    """diffusion -> tangent gradients -> gradient features -> MLP -> residual
    (reference layers.py:167-241), on dense spectral gradient operators:
    the gradients of the diffused signal are GX @ (e^{-lambda t} (.) x_hat)."""

    def __init__(self, c_width: int, mlp_hidden_dims: Sequence[int],
                 dropout: bool = True, with_gradient_features: bool = True,
                 with_gradient_rotations: bool = True):
        super().__init__()
        self.c_width = c_width
        self.with_gradient_features = with_gradient_features
        self.diffusion = LearnedTimeDiffusion(c_width)
        if with_gradient_features:
            self.gradient_features = SpatialGradientFeatures(
                c_width, with_gradient_rotations=with_gradient_rotations)
        mlp_c = (3 if with_gradient_features else 2) * c_width
        self.mlp = MiniMLP((mlp_c, *mlp_hidden_dims, c_width), dropout=dropout)

    def forward(self, x_in, mass, evals, evecs, gradX, gradY,
                deterministic: bool = True,
                generator: torch.Generator | None = None):
        if x_in.shape[-1] != self.c_width:
            raise ValueError(
                f"Tensor has wrong shape = {tuple(x_in.shape)}. Last dim "
                f"shape should have number of channels = {self.c_width}")
        x_diffuse, x_diffuse_spec = self.diffusion(x_in, mass, evals, evecs)
        if self.with_gradient_features:
            if gradX is None or gradX.shape[-1] != evecs.shape[-1]:
                raise NotImplementedError(
                    "gradient features on ELL gradient operators come with "
                    "ROADMAP item A.5; pass the (V, K) spectral operators")
            feats = self.gradient_features(gradX @ x_diffuse_spec,
                                           gradY @ x_diffuse_spec)
            combined = torch.cat((x_in, x_diffuse, feats), dim=-1)
        else:
            combined = torch.cat((x_in, x_diffuse), dim=-1)
        return self.mlp(combined, deterministic, generator) + x_in


def _gather_mean(x, inds):
    """x: (B, V, C); inds: (B, E, m) -> mean over the m gathered vertices
    (the edges/faces output remap, reference layers.py:379-391)."""
    m = inds.shape[-1]
    C = x.shape[-1]
    parts = [torch.gather(x, -2, inds[..., i, None].expand(
        inds.shape[:-1] + (C,))) for i in range(m)]
    return sum(parts) / m


class DiffusionNet(nn.Module):
    """Top-level model (reference layers.py:244-407), the constructor surface
    of the JAX package's DiffusionNet.

    forward(x_in, mass, evals, evecs, gradX, gradY, edges=None, faces=None,
            deterministic=True, generator=None)
    x_in: (V, C_in) or (B, V, C_in); operators batched to match; gradX/gradY
    are the dense (.., V, K) spectral gradient operators.

    generator: the torch.Generator the weights are drawn from (on the CPU);
    None means a generator seeded with 0. forward's `generator` is another
    one: the source of the dropout masks in training mode."""

    def __init__(self, c_in: int, c_out: int, c_width: int = 128,
                 n_block: int = 4,
                 last_activation: Optional[Callable] = None,
                 outputs_at: str = "vertices",
                 mlp_hidden_dims: Optional[Sequence[int]] = None,
                 dropout: bool = True,
                 with_gradient_features: bool = True,
                 with_gradient_rotations: bool = True,
                 diffusion_method: str = "spectral",
                 generator: torch.Generator | None = None):
        super().__init__()
        if outputs_at not in ("vertices", "edges", "faces", "global_mean"):
            raise ValueError("invalid setting for outputs_at")
        if diffusion_method == "implicit_dense":
            raise NotImplementedError(
                "implicit_dense diffusion comes with ROADMAP item A.5")
        if diffusion_method != "spectral":
            raise ValueError("invalid setting for diffusion_method")
        self.c_in, self.c_out, self.c_width = c_in, c_out, c_width
        self.n_block = n_block
        self.dropout = dropout
        self.last_activation = last_activation
        self.outputs_at = outputs_at
        self.diffusion_method = diffusion_method
        self.with_gradient_features = with_gradient_features
        self.with_gradient_rotations = with_gradient_rotations
        hidden = (list(mlp_hidden_dims) if mlp_hidden_dims is not None
                  else [c_width, c_width])
        self.mlp_hidden_dims = hidden
        self.first_lin = _dense(c_in, c_width)
        self.blocks = nn.ModuleList(
            DiffusionNetBlock(c_width, hidden, dropout=dropout,
                              with_gradient_features=with_gradient_features,
                              with_gradient_rotations=with_gradient_rotations)
            for _ in range(n_block))
        self.last_lin = _dense(c_width, c_out)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax Dense defaults: lecun-normal kernels, zero biases, zero
        diffusion times; drawn on the CPU in module order."""
        self.to_empty(device="cpu")
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    _lecun_normal_(mod.weight, generator)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, LearnedTimeDiffusion):
                    mod.diffusion_time.zero_()

    def forward(self, x_in, mass, evals=None, evecs=None, gradX=None,
                gradY=None, edges=None, faces=None,
                deterministic: bool = True,
                generator: torch.Generator | None = None):
        if x_in.shape[-1] != self.c_in:
            raise ValueError(
                f"DiffusionNet was constructed with C_in={self.c_in}, but "
                f"x_in has last dim={x_in.shape[-1]}")
        appended_batch_dim = x_in.ndim == 2
        if appended_batch_dim:
            def expand(a):
                return None if a is None else a[None]
            x_in, mass, evals, evecs = (expand(a) for a in
                                        (x_in, mass, evals, evecs))
            gradX, gradY, edges, faces = (expand(a) for a in
                                          (gradX, gradY, edges, faces))
        elif x_in.ndim != 3:
            raise ValueError("x_in should be tensor with shape [N,C] or [B,N,C]")

        x = self.first_lin(x_in)
        for block in self.blocks:
            x = block(x, mass, evals, evecs, gradX, gradY, deterministic,
                      generator)
        x = self.last_lin(x)

        if self.outputs_at == "vertices":
            x_out = x
        elif self.outputs_at == "edges":
            x_out = _gather_mean(x, edges.long())
        elif self.outputs_at == "faces":
            x_out = _gather_mean(x, faces.long())
        else:  # global_mean — mass-weighted, padding-invariant
            x_out = ((x * mass[..., None]).sum(-2)
                     / mass.sum(-1, keepdim=True))

        if self.last_activation is not None:
            x_out = self.last_activation(x_out)
        if appended_batch_dim:
            x_out = x_out[0]
        return x_out
