"""The (data, vert) mesh of ranks, this rank's blocks of a tensor, and the
collectives that carry gradients. The counterpart of
diffusionnet_tpu/parallel/mesh.py.

The JAX package runs one controller over every device and lets shard_map
place each block. Here each process drives one card (or one CPU rank) and
holds only its own block: a `torch.distributed.device_mesh.DeviceMesh` of
shape (data, vert) names the process groups. `data` splits a batch of
surfaces (data parallelism); `vert` splits the V axis of one large surface
(vertex sharding), whose spectral projection x_hat = Phi^T (m x) is then a
sum of per-shard partials over `vert`.

Rank r of the world sits at (r // vert, r % vert), so a `vert` group is
consecutive ranks, which `distributed.make_pod_mesh` keeps inside one node.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "vert")


def make_mesh(data: int | None = None, vert: int = 1,
              device_type: str | None = None) -> DeviceMesh:
    """A (data, vert) DeviceMesh over the initialized world (every rank
    calls it). data defaults to world_size // vert. device_type defaults to
    'cuda' under nccl and 'cpu' otherwise (gloo carries CPU and CUDA
    tensors alike)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "diffusionnet_tpu_torch.parallel.initialize() "
                           "first (torchrun sets its environment)")
    n = dist.get_world_size()
    if data is None:
        data = n // vert
    if data * vert != n:
        raise ValueError(f"data*vert = {data * vert} != n_devices = {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, vert), mesh_dim_names=AXES)


def _block(x, mesh: DeviceMesh, axis_name: str, dim: int):
    """This rank's block of x along dim, split evenly over axis_name."""
    n = mesh.size(AXES.index(axis_name))
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"axis {dim} of size {size} does not split over "
                         f"{axis_name}={n}")
    r = mesh.get_local_rank(axis_name)
    step = size // n
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, r * step, step).contiguous()
    index = [slice(None)] * x.ndim
    index[dim] = slice(r * step, (r + 1) * step)
    return x[tuple(index)]


def data_parallel_sharding(mesh: DeviceMesh, x):
    """This rank's block of a batched array: the leading (batch) axis split
    over `data` (JAX: NamedSharding(mesh, P('data')))."""
    return _block(x, mesh, "data", 0)


def vertex_sharding(mesh: DeviceMesh, x, dim: int = 0):
    """This rank's rows of a per-vertex array: the V axis (dim; 0 for one
    surface's (V, ...) arrays) split over `vert` (JAX: P('vert'))."""
    return _block(x, mesh, "vert", dim)


def replicated_sharding(mesh: DeviceMesh, x):
    """Every rank holds the whole array (JAX: P())."""
    return x


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In place: t summed over the group's ranks (no autograd)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """psum with its transpose: the forward sums over the group, and so
    does the backward. Every shard's output is the same sum, and each
    shard's loss sends its own cotangent back through it; the input of
    shard i receives the sum of all of them. A bare all_reduce on the
    forward value would hand shard i only its own loss's cotangent and
    drop the cross-shard terms of every gradient behind it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the group, differentiable (jax.lax.psum)."""
    return _AllReduceSum.apply(t, group)


class _AllGather(torch.autograd.Function):
    """The blocks of every rank concatenated along dim (equal blocks, in
    rank order); the backward sums the cotangent over the group and keeps
    this rank's block."""

    @staticmethod
    def forward(ctx, t, dim, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.group, ctx.r, ctx.size = dim, group, r, t.shape[dim]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.narrow(ctx.dim, ctx.r * ctx.size, ctx.size), None, None


class VertexGroup:
    """The `vert` axis as model code sees it: this rank's index among the
    shards of one surface, and the two collectives a V-sharded forward
    needs. Passed as `vert=` to `DiffusionNet.forward`, `megablock_apply`'s
    xhat_reduce and `training.apply_model`."""

    def __init__(self, mesh: DeviceMesh):
        self.group = mesh.get_group("vert")
        self.rank = mesh.get_local_rank("vert")
        self.size = mesh.size(AXES.index("vert"))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the shards (the projection's partials)."""
        return all_reduce_sum(t, self.group)

    def gather(self, t: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The whole surface's rows from every shard's (an ELL gradient's
        columns are global vertex indices)."""
        return _AllGather.apply(t, dim % t.ndim, self.group)

    def local(self, t: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """This shard's rows of a whole-surface tensor."""
        step = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * step, step)


def collective_device(group=None) -> torch.device:
    """Where a collective's scratch tensors live: the current card under
    nccl, the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def both_axes(mesh: DeviceMesh):
    """The process group over both axes: the world's (a mesh of make_mesh
    spans it)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of "
                         f"{dist.get_world_size()} ranks; make_mesh spans "
                         "the world")
    return None


def all_reduce_tree(tree, group=None):
    """Every leaf of a pytree of scalars (tensors or numbers: counts, sums)
    summed over the group in one collective, in float64 (counts stay exact
    below 2^53), each returned in its own dtype."""
    from torch.utils._pytree import tree_flatten, tree_unflatten
    leaves, spec = tree_flatten(tree)
    ts = [torch.as_tensor(x) for x in leaves]
    dev = collective_device(group)
    buf = torch.stack([t.detach().reshape(()).to(dev, torch.float64)
                       for t in ts])
    all_reduce_(buf, group)
    out = [buf[i].to(t.device, t.dtype) for i, t in enumerate(ts)]
    return tree_unflatten(out, spec)


def any_rank(flag: bool, group=None) -> bool:
    """True on every rank when it is true on any: ranks agree on leaving a
    loop together (a rank that left alone would hang the others in their
    next collective)."""
    t = torch.tensor([1.0 if flag else 0.0], device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item() > 0)
