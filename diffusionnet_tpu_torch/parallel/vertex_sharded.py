"""Vertex-sharded inference and (data, vert)-sharded training of surfaces
too large for one card. The counterpart of
diffusionnet_tpu/parallel/vertex_sharded.py.

The V axis of every per-vertex array (x, mass, the rows of evecs and of the
ELL operators, the dense spectral gradients) is split over the `vert` axis
of the mesh, each rank holding its own rows. The spectral projection
x_hat = Phi^T (m x) is then a local product and a (K, C) sum over the
shards (`VertexGroup.sum`, with its transpose in the backward); the
back-projection and the gradient products are local; an ELL gradient reads
the surface gathered from every shard. On the megakernel path kernel B1
runs on each shard's rows and emits a partial x_hat, the only quantity the
shards exchange per block; B2 receives the sum's cotangent. On the eager
model's fused route kernel B4 does the same: its projection and apply
kernels on the shard's rows, and in the backward `spectral_ds` on them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..geometry.operators import Operators, grad_operators
from ..models.fast_path import megablock_apply
from ..models.params import module_state
from ..ops.sparse import Ell
from ..training.fit import Adam, AdamState
from ..utils import fold_generator
from .data_parallel import reduce_grads_
from .mesh import (VertexGroup, all_reduce_tree, both_axes,
                   data_parallel_sharding, vertex_sharding)


def _rows(ops: Operators, rows: Callable, whole: Callable) -> Operators:
    """ops with rows() applied to every per-vertex array (the idx and val
    of each Ell), whole() to evals."""
    def spec(g):
        return None if g is None else rows(g)
    return Operators(
        frames=rows(ops.frames), mass=rows(ops.mass),
        L=Ell(rows(ops.L.idx), rows(ops.L.val)), evals=whole(ops.evals),
        evecs=rows(ops.evecs),
        gradX=Ell(rows(ops.gradX.idx), rows(ops.gradX.val)),
        gradY=Ell(rows(ops.gradY.idx), rows(ops.gradY.val)),
        gradX_spec=spec(ops.gradX_spec), gradY_spec=spec(ops.gradY_spec))


def shard_operators_by_vertex(ops: Operators, mesh: DeviceMesh) -> Operators:
    """This rank's rows of one (unbatched, padded) surface's bundle: frames,
    mass, evecs, the ELL operators (their column indices stay global) and
    the spectral gradients split over `vert`; evals whole. numpy or tensors
    in, the same out."""
    return _rows(ops, lambda a: vertex_sharding(mesh, a, 0), lambda a: a)


def shard_batch(batch, mesh: DeviceMesh, labels_kind: str = "vertex"):
    """This rank's (data, vert) block of a PaddedBatch (the JAX package's
    `batch_pspecs`): every (B, V, ...) array over both axes; evals, faces
    and face_mask over `data` only; labels over both for 'vertex', over
    `data` only otherwise. Every rank builds the same batch (same seed)
    and keeps its block; a mesh with vert = 1 gives data parallelism's
    block."""
    def d(a):
        return data_parallel_sharding(mesh, a)

    def dv(a):
        return vertex_sharding(mesh, d(a), 1)
    return type(batch)(
        verts=dv(batch.verts), ops=_rows(batch.ops, dv, d),
        labels=dv(batch.labels) if labels_kind == "vertex" else d(
            batch.labels),
        faces=d(batch.faces), face_mask=d(batch.face_mask))


def _tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def vertex_sharded_megakernel_forward(params: dict, x_in, ops: Operators,
                                      mesh: DeviceMesh, n_block: int,
                                      tile_v: int = 1024,
                                      last_activation=None):
    """The megakernel fast path on this rank's rows of ONE large surface:
    B1 on the shard's rows, each block's partial x_hat summed over `vert`
    (a (K, C) all-reduce, the only exchange between the shards).

    params: the model's flat JAX-layout tensors (`models.flat_params`) on
    the rank's device, the same on every rank. x_in (V, C_in) and ops: the
    whole padded surface (numpy or tensors; every rank passes the same),
    with the dense spectral gradients (ops.gradX_spec); V must split over
    `vert`. Returns this rank's rows of the output, (V / vert, C_out)."""
    if ops.gradX_spec is None:
        raise ValueError("vertex-sharded megakernel needs spectral gradient "
                         "operators (ops.gradX_spec)")
    device = next(iter(params.values())).device
    vert = VertexGroup(mesh)
    loc = shard_operators_by_vertex(ops, mesh)
    x = vertex_sharding(mesh, x_in, 0)

    def b(a):
        return _tensor(a, device)[None]
    out = megablock_apply(
        params, b(x), b(loc.mass), b(loc.evals), b(loc.evecs),
        b(loc.gradX_spec), b(loc.gradY_spec), n_block=n_block,
        tile_v=tile_v, last_activation=last_activation,
        xhat_reduce=vert.sum)
    return out[0]


def vertex_sharded_forward(model, params: dict | None, x_in, ops: Operators,
                           mesh: DeviceMesh, **call_kwargs):
    """The eager model on this rank's rows of ONE large surface.

    params: flat JAX-layout tensors (the train state), or None for the
    module's own weights. x_in (V, C_in) and ops: the whole padded surface
    (numpy or tensors, the same on every rank); call_kwargs go to the
    model's forward (faces, edges, deterministic, ...) as given. The dense
    spectral gradients are used where the bundle has them (local products);
    else the ELL operators, which read the surface gathered from every
    shard. A fused block (kernel B4: use_pallas_fused, or dense spectral
    gradients on a card, where the shard's rows are a multiple of
    pallas_tile_v) runs B4 on the shard's rows, forward and backward, the
    shards exchanging x_hat's (K, C) partials and their cotangent. Returns
    this rank's rows of vertex outputs; face, edge and global-mean outputs
    whole on every rank."""
    if params is None:
        device = next(model.parameters()).device
        fn = model
    else:
        device = next(iter(params.values())).device

        def fn(*args, **kwargs):
            return torch.func.functional_call(model, module_state(params),
                                              args, kwargs)
    loc = _rows(shard_operators_by_vertex(ops, mesh),
                lambda a: _tensor(a, device), lambda a: _tensor(a, device))
    gX, gY = grad_operators(loc)
    x = _tensor(vertex_sharding(mesh, x_in, 0), device)
    kwargs = {k: _tensor(v, device) if isinstance(v, np.ndarray) else v
              for k, v in call_kwargs.items()}
    return fn(x, loc.mass, evals=loc.evals, evecs=loc.evecs, gradX=gX,
              gradY=gY, L=loc.L, vert=VertexGroup(mesh), **kwargs)


def make_two_axis_train_step(sum_loss_fn: Callable, optimizer: Adam,
                             mesh: DeviceMesh):
    """A (data, vert)-sharded train step.

    sum_loss_fn(params, batch, generator) -> (loss_sum, count, aux_sums):
    SUMS over this rank's (batch, vertex) block (`shard_batch`). The step
    sums count over both axes before dividing, so the objective
    sum(per-element loss) / sum(valid) is the single-process loss; the
    gradients (one flat buffer), the loss and aux are summed over both
    axes, and Adam runs replicated.
    generator: the step's, the same on every rank; the step folds in the
    data rank only, so the shards of one surface agree on its sample-level
    randomness (rotations); sum_loss_fn folds the vert rank into the
    per-vertex dropout (`training.apply_model(vert=...)`).

    Returns train_step(params, opt_state, batch, generator) ->
    (params, opt_state, loss, aux_sums)."""
    group = both_axes(mesh)
    data_rank = mesh.get_local_rank("data")

    def train_step(params, opt_state: AdamState, batch, generator=None):
        opt = opt_state.optimizer
        opt.zero_grad(set_to_none=True)
        S, N, aux = sum_loss_fn(params, batch,
                                fold_generator(generator, data_rank))
        N_g = all_reduce_tree(N, group)
        loss_i = S / torch.clamp(N_g.to(S.dtype), min=1)
        loss_i.backward()
        loss = reduce_grads_(params, opt_state, loss_i, group)
        opt.step()
        opt_state.scheduler.step()
        return params, opt_state, loss, all_reduce_tree(aux, group)

    return train_step


def make_two_axis_eval_step(sum_metric_fn: Callable, mesh: DeviceMesh):
    """sum_metric_fn(params, batch) -> a pytree of this rank's SUMS, run
    without autograd and summed over both axes."""
    group = both_axes(mesh)

    def eval_step(params, batch):
        with torch.no_grad():
            return all_reduce_tree(sum_metric_fn(params, batch), group)

    return eval_step

