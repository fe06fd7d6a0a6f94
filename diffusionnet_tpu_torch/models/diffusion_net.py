"""DiffusionNet as torch nn.Modules — the eager model.

The counterpart of diffusionnet_tpu/models/diffusion_net.py, with its whole
constructor surface. A block takes one of three routes, chosen as the JAX
block chooses them:

  * dense spectral gradient operators (gradX/gradY the (V, K)
    Operators.gradX_spec): the gradients of the diffused signal are
    GX @ (e^{-lambda t} (.) x_hat), dense products;
  * the same, fused into kernel B4 (ops/fused.py) when use_pallas_fused and
    V % pallas_tile_v == 0 (else the dense route: JAX semantics); on a
    vertex-sharded surface B4 runs on each shard's rows, forward and
    backward, with the projection summed over the shards between its two
    kernels (and its cotangent in the backward). On a CUDA device the
    dense-spectral block takes this route whatever use_pallas_fused says:
    the two compute the same products, and B4's kernels are the card's
    implementation of them (cuBLAS runs the long-V transposed products on
    small tiles), unless an operator requires grad: B4 gives the operators
    no gradient, the dense route does (`takes_b4`). On the CPU
    use_pallas_fused picks between the two formulations, as in the JAX
    package;
  * ELL gradient operators (gradX/gradY an `Ell`): `ell_matvec` of the
    diffused signal. Required by diffusion_method="implicit_dense".

compute_dtype (e.g. torch.bfloat16) casts what the JAX model casts: each
Dense layer computes and returns compute_dtype (flax `Dense(dtype=...)`),
the basis transforms and gradient products take compute_dtype operands with
f32 accumulation. Parameters stay f32.

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
from torch.utils.checkpoint import checkpoint

from ..ops.fused import (fused_spectral_block, fused_spectral_block_batched,
                         fused_spectral_block_sharded)
from ..ops.sparse import Ell, ell_matvec, ell_to_dense
from ..ops.spectral import from_basis, lowp_matmul, to_basis
from ..training.profiling import count, span

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
    """Per-channel learned diffusion time (reference layers.py:17-90). The
    clamp is a straight-through projection: the value is clamped to >= 1e-8,
    the gradient is the identity.

    method='spectral': diffuse in the truncated eigenbasis.
    method='implicit_dense': one backward-Euler step through a dense
    Cholesky of t_c L + diag(mass) per channel (usable with k_eig=0; O(V^3),
    for small padded buckets)."""

    def __init__(self, c_inout: int, method: str = "spectral",
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if method not in ("spectral", "implicit_dense"):
            raise ValueError("unrecognized method")
        self.c_inout = c_inout
        self.method = method
        self.compute_dtype = compute_dtype
        self.diffusion_time = nn.Parameter(torch.zeros(c_inout))

    def time(self) -> torch.Tensor:
        t = self.diffusion_time
        return t + (torch.clamp(t, min=1e-8) - t).detach()

    def coefs(self, evals) -> torch.Tensor:
        """Per-channel diffusion coefficients exp(-evals t): (..., K, C)."""
        return torch.exp(-evals[..., :, None] * self.time())

    def forward(self, x, mass, evals, evecs, L=None, vert=None):
        """Returns (x_diffuse, x_diffuse_spec); the second is None for
        implicit_dense. vert: None, or the `parallel.VertexGroup` of a
        V-sharded surface (x, mass, evecs and L's rows are this shard's):
        the projection's partials are summed over the shards; implicit_dense
        gathers the whole surface and solves it on every shard."""
        if x.shape[-1] != self.c_inout:
            raise ValueError(
                f"Tensor has wrong shape = {tuple(x.shape)}. Last dim shape "
                f"should have number of channels = {self.c_inout}")
        if self.method == "spectral":
            cd = self.compute_dtype
            x_hat = to_basis(x, evecs, mass, cd)
            if vert is not None:
                x_hat = vert.sum(x_hat)
            x_diffuse_spec = self.coefs(evals) * x_hat
            return from_basis(x_diffuse_spec, evecs, cd), x_diffuse_spec
        if vert is not None:
            if isinstance(L, Ell):
                L = Ell(vert.gather(L.idx), vert.gather(L.val))
            else:
                L = vert.gather(L)
            full = self(vert.gather(x), vert.gather(mass[..., None])[..., 0],
                        evals, evecs, L)[0]
            return vert.local(full), None
        V = x.shape[-2]
        L_dense = ell_to_dense(L) if isinstance(L, Ell) else L
        # padded rows (mass == 0) get identity rows so the system stays SPD
        mass_eff = torch.where(mass > 0, mass, torch.ones_like(mass))
        eye = torch.eye(V, dtype=x.dtype, device=x.device)
        # (..., C, V, V) = t_c L + diag(mass)
        mat = (self.time()[:, None, None] * L_dense[..., None, :, :]
               + eye * mass_eff[..., None, :, None])
        chol = torch.linalg.cholesky(mat)
        rhs = (x * mass[..., None]).transpose(-1, -2)[..., None]  # (..,C,V,1)
        sols = torch.cholesky_solve(rhs.to(chol.dtype), chol)
        return sols[..., 0].transpose(-1, -2), None


def _linear(lin: nn.Linear, x, dtype):
    """lin(x), or as flax's Dense(dtype=dtype) computes it: input, kernel
    and bias cast to dtype, the result in dtype."""
    if dtype is None:
        return lin(x)
    y = x.to(dtype) @ lin.weight.to(dtype).transpose(0, 1)
    return y if lin.bias is None else y + lin.bias.to(dtype)


class SpatialGradientFeatures(nn.Module):
    """Inner products between tangent gradients through a learned
    complex-linear map (reference layers.py:93-130).
    forward(vX, vY): two (..., V, C) -> (..., V, C)."""

    def __init__(self, c_inout: int, with_gradient_rotations: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.with_gradient_rotations = with_gradient_rotations
        self.dtype = dtype
        if with_gradient_rotations:
            self.A_re = _dense(c_inout, c_inout, bias=False)
            self.A_im = _dense(c_inout, c_inout, bias=False)
        else:
            self.A = _dense(c_inout, c_inout, bias=False)

    def forward(self, vX, vY):
        dt = self.dtype
        if self.with_gradient_rotations:
            vb_re = _linear(self.A_re, vX, dt) - _linear(self.A_im, vY, dt)
            vb_im = _linear(self.A_re, vY, dt) + _linear(self.A_im, vX, dt)
        else:
            vb_re = _linear(self.A, vX, dt)
            vb_im = _linear(self.A, vY, dt)
        return torch.tanh(vX * vb_re + vY * vb_im)


class MiniMLP(nn.Module):
    """Linear+ReLU stack, no activation after the last layer (reference
    layers.py:133-164). With `dropout`, Dropout(0.5) before every layer
    except the first, active when deterministic is False: its masks come
    from `generator` (a torch.Generator on the tensors' device, or None for
    torch's default one), so they differ from flax's bits but not in law.
    dtype: the layers' compute dtype (flax `Dense(dtype=...)`)."""

    def __init__(self, layer_sizes: Sequence[int], dropout: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
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
            x = _linear(lin, x, self.dtype)
            if i < n - 1:
                x = torch.relu(x)
        return x


def takes_b4(x_in, operators, use_pallas_fused: bool, tile_v: int) -> bool:
    """Whether a block with dense spectral gradients runs on B4 (module
    docstring): only where V (a shard's rows) is a multiple of tile_v; then
    where use_pallas_fused asks for it, or on a CUDA tensor unless an
    operator (mass, evecs, gradX, gradY) requires grad, since B4 gives the
    operators no gradient and the dense route does."""
    if x_in.shape[-2] % tile_v:
        return False
    return use_pallas_fused or (x_in.is_cuda and not any(
        t.requires_grad for t in operators))


class DiffusionNetBlock(nn.Module):
    """diffusion -> tangent gradients -> gradient features -> MLP -> residual
    (reference layers.py:167-241), on one of the three routes of the module
    docstring. A call counts the route it took, `block.b4` or
    `block.dense` with dense spectral gradients, `block.ell` with ELL ones
    (training.profiling.count)."""

    def __init__(self, c_width: int, mlp_hidden_dims: Sequence[int],
                 dropout: bool = True, with_gradient_features: bool = True,
                 with_gradient_rotations: bool = True,
                 diffusion_method: str = "spectral",
                 compute_dtype: torch.dtype | None = None,
                 use_pallas_fused: bool = False, pallas_tile_v: int = 1024):
        super().__init__()
        self.c_width = c_width
        self.with_gradient_features = with_gradient_features
        self.diffusion_method = diffusion_method
        self.compute_dtype = compute_dtype
        self.use_pallas_fused = use_pallas_fused
        self.pallas_tile_v = pallas_tile_v
        self.diffusion = LearnedTimeDiffusion(c_width, diffusion_method,
                                              compute_dtype)
        if with_gradient_features:
            self.gradient_features = SpatialGradientFeatures(
                c_width, with_gradient_rotations=with_gradient_rotations,
                dtype=compute_dtype)
        mlp_c = (3 if with_gradient_features else 2) * c_width
        self.mlp = MiniMLP((mlp_c, *mlp_hidden_dims, c_width), dropout=dropout,
                           dtype=compute_dtype)

    def forward(self, x_in, mass, evals, evecs, gradX, gradY,
                deterministic: bool = True,
                generator: torch.Generator | None = None, L=None,
                vert=None):
        """vert: None, or the `parallel.VertexGroup` of a V-sharded surface:
        the V-sized inputs hold this shard's rows (an ELL gradient's with
        global column indices); the output is this shard's rows."""
        if x_in.shape[-1] != self.c_width:
            raise ValueError(
                f"Tensor has wrong shape = {tuple(x_in.shape)}. Last dim "
                f"shape should have number of channels = {self.c_width}")
        spectral_grads = (self.with_gradient_features and gradX is not None
                          and not isinstance(gradX, Ell))
        if spectral_grads and self.diffusion_method != "spectral":
            raise ValueError(
                "dense spectral gradient operators require "
                "diffusion_method='spectral'; pass Ell gradX/gradY instead")
        fused = spectral_grads and takes_b4(
            x_in, (mass, evecs, gradX, gradY), self.use_pallas_fused,
            self.pallas_tile_v)
        if spectral_grads:
            count("block.b4" if fused else "block.dense")
        elif self.with_gradient_features and isinstance(gradX, Ell):
            count("block.ell")
        if fused and vert is not None:
            # B4 on the shard's rows, its (K, C) projection summed over the
            # shards between the two kernels; differentiable, the backward
            # summing x_hat's cotangent over the shards
            x_diffuse, x_gradX, x_gradY = fused_spectral_block_sharded(
                x_in, evecs, gradX, gradY, mass,
                self.diffusion.coefs(evals), vert.sum, self.pallas_tile_v)
        elif fused:
            block = (fused_spectral_block_batched if x_in.ndim == 3
                     else fused_spectral_block)
            x_diffuse, x_gradX, x_gradY = block(
                x_in, evecs, gradX, gradY, mass,
                self.diffusion.coefs(evals), self.pallas_tile_v)
        else:
            x_diffuse, x_diffuse_spec = self.diffusion(x_in, mass, evals,
                                                       evecs, L, vert)
        if self.with_gradient_features:
            if fused:
                pass  # the fused kernel computed x_gradX / x_gradY
            elif spectral_grads:
                x_gradX, x_gradY = (
                    lowp_matmul(g, x_diffuse_spec, self.compute_dtype,
                                x_in.dtype) for g in (gradX, gradY))
            else:
                # an ELL row reads any vertex: the whole surface's x
                x_all = x_diffuse if vert is None else vert.gather(x_diffuse)
                x_gradX = ell_matvec(gradX, x_all)
                x_gradY = ell_matvec(gradY, x_all)
            feats = self.gradient_features(x_gradX, x_gradY)
            combined = torch.cat((x_in, x_diffuse, feats), dim=-1)
        else:
            combined = torch.cat((x_in, x_diffuse), dim=-1)
        out = self.mlp(combined, deterministic, generator) + x_in
        return out.to(x_in.dtype)


class MeanPlan:
    """What gather_mean's backward needs of its indices alone: each entry's
    row of the batch's B*V rows (out-of-range entries to a sentinel row
    B*V), its rank among its row's entries by a stable sort (so in entry
    order), and the largest degree D, copied to the host without waiting.
    Made before a model's blocks are issued, D is on the host by the time
    the backward reads it: the read does not wait for the card to drain
    the forward and then leave it idle while the host issues the rest."""

    def __init__(self, inds: torch.Tensor, V: int):
        B = inds.shape[0]
        n_rows, n = B * V, inds.numel()
        dev = inds.device
        self.low, self.high = inds < 0, inds >= V
        outside = (self.low | self.high).reshape(-1)
        self.keys = (inds.clamp(0, V - 1) + V * torch.arange(
            B, device=dev).view(B, 1, 1)).reshape(-1)
        self.keys_in = torch.where(outside, n_rows, self.keys)
        # int32 keys halve the radix sort's passes
        key_t = torch.int32 if n_rows < 2 ** 31 - 1 else torch.int64
        sk, order = torch.sort(self.keys_in.to(key_t), stable=True)
        self.rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(n, device=dev)
            - torch.searchsorted(sk, sk)).masked_fill(outside, 0)
        d = (self.rank.max() if n else self.rank.new_zeros(())) + 1
        self._event = None
        if d.is_cuda:
            self._d = torch.empty((), dtype=d.dtype, pin_memory=True)
            self._d.copy_(d, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._d = d

    @property
    def max_degree(self) -> int:
        if self._event is not None:
            with span("dnt.wait.mean_degree"):
                self._event.synchronize()
        return int(self._d)


class _GatherMean(torch.autograd.Function):
    """The mean of gathered rows, with a backward that sums each vertex's
    entries in a fixed order. gather's backward adds them atomically on a
    card, so a step's bits would vary from run to run and a resumed run
    would not repeat the uninterrupted one.

    The backward scatters each entry to its own slot (row, rank) of a
    zeroed (B*V, D, C) buffer (MeanPlan) and sums over D. Out-of-range
    entries are summed per element apart, so a batch's padding faces, all
    on one vertex, do not set D. Where a vertex has more than MAX_DEGREE
    entries, the backward is the embedding lookup's (sort-based, also in a
    fixed order, slower on a card)."""

    MAX_DEGREE = 32

    @staticmethod
    def forward(ctx, x, inds, plan):
        B, V, C = x.shape
        E, m = inds.shape[1:]
        ctx.save_for_backward(inds)
        ctx.shape, ctx.plan = (B, V, C), plan
        safe = inds.clamp(0, V - 1)
        return sum(torch.gather(x, 1, safe[..., i, None].expand(B, E, C))
                   for i in range(m)) / m

    @staticmethod
    def backward(ctx, g):
        (inds,) = ctx.saved_tensors
        B, V, C = ctx.shape
        E, m = inds.shape[1:]
        plan = ctx.plan if ctx.plan is not None else MeanPlan(inds, V)
        n_rows = B * V
        g = g / m
        g_rows = g.reshape(B * E, C)
        D = plan.max_degree
        if D > _GatherMean.MAX_DEGREE:
            return torch.ops.aten.embedding_dense_backward(
                g_rows.repeat_interleave(m, 0), plan.keys, n_rows, -1,
                False).view(B, V, C), None, None
        # m scatters straight from g (row gathers of a few channels are
        # several times slower on a card)
        slots = (plan.keys_in * D + plan.rank).view(B * E, m)
        dense = g.new_zeros(((n_rows + 1) * D, C))
        for i in range(m):
            dense.scatter_(0, slots[:, i, None].expand(B * E, C), g_rows)
        grad = dense[:n_rows * D].view(n_rows, D, C).sum(1).view(B, V, C)
        for mask, row in ((plan.low, 0), (plan.high, V - 1)):
            k = mask.sum(-1, keepdim=True)
            grad[:, row] += torch.where(k > 0, g * k, 0).sum(1)
        return grad, None, None


def gather_mean(x, inds, plan: MeanPlan | None = None):
    """x: (B, V, C); inds: (B, E, m) -> mean over the m gathered vertices
    (the edges/faces output remap, reference layers.py:379-391). An index
    below 0 (padding faces are -1) reads row 0 of its element, one above
    V - 1 row V - 1, as the JAX harness clamps padding faces (the JAX
    model's own gather wraps -1 to V - 1; the loss masks padding faces
    either way). The backward repeats its bits (_GatherMean). plan:
    MeanPlan(inds, V), made early where a backward will follow (else the
    backward makes it)."""
    return _GatherMean.apply(x, inds, plan)


def _expand(a):
    """a with a leading batch dim of 1 (an Ell: both arrays)."""
    if a is None:
        return None
    if isinstance(a, Ell):
        return Ell(a.idx[None], a.val[None])
    return a[None]


class DiffusionNet(nn.Module):
    """Top-level model (reference layers.py:244-407), the constructor surface
    of the JAX package's DiffusionNet.

    forward(x_in, mass, evals, evecs, gradX, gradY, edges=None, faces=None,
            deterministic=True, generator=None, L=None, vert=None)
    x_in: (V, C_in) or (B, V, C_in); operators batched to match. gradX/gradY
    are the dense (.., V, K) spectral gradient operators or `Ell`s; L (an
    `Ell` or a dense tensor) is read by implicit_dense diffusion.
    vert: None, or the `parallel.VertexGroup` of a surface whose V axis is
    split over several ranks: every V-sized input holds this rank's rows
    (evals, edges and faces are whole), the projections and the global
    mean are summed over the shards, an ELL gradient or an edge/face
    output reads the gathered surface. Vertex outputs are this rank's
    rows; the others are whole on every rank.

    generator: the torch.Generator the weights are drawn from (on the CPU);
    None means a generator seeded with 0. forward's `generator` is another
    one: the source of the dropout masks in training mode.

    compute_dtype: e.g. torch.bfloat16 (module docstring). use_pallas_fused:
    the blocks' spectral diffusion and gradient products as kernel B4 when
    V % pallas_tile_v == 0. On a CUDA device the flag is moot for dense
    spectral gradients: those blocks take B4 there either way, unless an
    operator requires grad (module docstring, `takes_b4`). remat_blocks: recompute each block in the backward pass
    (torch.utils.checkpoint) instead of keeping its activations; dropout
    masks are redrawn from the same generator state."""

    def __init__(self, c_in: int, c_out: int, c_width: int = 128,
                 n_block: int = 4,
                 last_activation: Optional[Callable] = None,
                 outputs_at: str = "vertices",
                 mlp_hidden_dims: Optional[Sequence[int]] = None,
                 dropout: bool = True,
                 with_gradient_features: bool = True,
                 with_gradient_rotations: bool = True,
                 diffusion_method: str = "spectral",
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None,
                 use_pallas_fused: bool = False,
                 pallas_tile_v: int = 1024,
                 remat_blocks: bool = False):
        super().__init__()
        if outputs_at not in ("vertices", "edges", "faces", "global_mean"):
            raise ValueError("invalid setting for outputs_at")
        if diffusion_method not in ("spectral", "implicit_dense"):
            raise ValueError("invalid setting for diffusion_method")
        self.c_in, self.c_out, self.c_width = c_in, c_out, c_width
        self.n_block = n_block
        self.dropout = dropout
        self.last_activation = last_activation
        self.outputs_at = outputs_at
        self.diffusion_method = diffusion_method
        self.with_gradient_features = with_gradient_features
        self.with_gradient_rotations = with_gradient_rotations
        self.compute_dtype = compute_dtype
        self.use_pallas_fused = use_pallas_fused
        self.pallas_tile_v = pallas_tile_v
        self.remat_blocks = remat_blocks
        hidden = (list(mlp_hidden_dims) if mlp_hidden_dims is not None
                  else [c_width, c_width])
        self.mlp_hidden_dims = hidden
        self.first_lin = _dense(c_in, c_width)
        self.blocks = nn.ModuleList(
            DiffusionNetBlock(c_width, hidden, dropout=dropout,
                              with_gradient_features=with_gradient_features,
                              with_gradient_rotations=with_gradient_rotations,
                              diffusion_method=diffusion_method,
                              compute_dtype=compute_dtype,
                              use_pallas_fused=use_pallas_fused,
                              pallas_tile_v=pallas_tile_v)
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

    def _run_block(self, block, x, deterministic, generator, vert, *ops):
        """One block; with remat_blocks (and autograd on) under
        torch.utils.checkpoint. checkpoint restores only torch's global RNG
        states, so the recompute first sets `generator` back to its state
        before the block, then returns it to where the forward left it."""
        if not (self.remat_blocks and torch.is_grad_enabled()):
            return block(x, *ops[:-1], deterministic, generator, L=ops[-1],
                         vert=vert)
        state = (generator.get_state()
                 if generator is not None and not deterministic else None)
        calls = [0]

        def run(x):
            after = None
            if state is not None and calls[0]:
                after = generator.get_state()
                generator.set_state(state)
            calls[0] += 1
            try:  # the recompute may be stopped early by an exception
                return block(x, *ops[:-1], deterministic, generator,
                             L=ops[-1], vert=vert)
            finally:
                if after is not None:
                    generator.set_state(after)
        return checkpoint(run, x, use_reentrant=False)

    def forward(self, x_in, mass, evals=None, evecs=None, gradX=None,
                gradY=None, edges=None, faces=None,
                deterministic: bool = True,
                generator: torch.Generator | None = None, L=None,
                vert=None):
        if x_in.shape[-1] != self.c_in:
            raise ValueError(
                f"DiffusionNet was constructed with C_in={self.c_in}, but "
                f"x_in has last dim={x_in.shape[-1]}")
        appended_batch_dim = x_in.ndim == 2
        if appended_batch_dim:
            x_in, mass, evals, evecs, gradX, gradY, edges, faces, L = (
                _expand(a) for a in (x_in, mass, evals, evecs, gradX, gradY,
                                     edges, faces, L))
        elif x_in.ndim != 3:
            raise ValueError("x_in should be tensor with shape [N,C] or [B,N,C]")

        inds = plan = None
        V = x_in.shape[-2] * (1 if vert is None else vert.size)
        if self.outputs_at in ("edges", "faces"):
            inds = (edges if self.outputs_at == "edges" else faces).long()
            if torch.is_grad_enabled():
                plan = MeanPlan(inds, V)
        cd = self.compute_dtype
        x = _linear(self.first_lin, x_in, cd)
        for block in self.blocks:
            x = self._run_block(block, x, deterministic, generator, vert,
                                mass, evals, evecs, gradX, gradY, L)
        x = _linear(self.last_lin, x, cd)

        if self.outputs_at == "vertices":
            x_out = x
        elif self.outputs_at in ("edges", "faces"):
            x_out = gather_mean(x if vert is None else vert.gather(x), inds,
                                plan)
        else:  # global_mean — mass-weighted, padding-invariant
            num = (x * mass[..., None]).sum(-2)
            den = mass.sum(-1, keepdim=True)
            if vert is not None:
                num, den = vert.sum(num), vert.sum(den)
            x_out = num / den

        if self.last_activation is not None:
            x_out = self.last_activation(x_out)
        if appended_batch_dim:
            x_out = x_out[0]
        return x_out
