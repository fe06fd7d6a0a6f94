"""Data-parallel training over the `data` axis of a mesh. The counterpart
of diffusionnet_tpu/parallel/data_parallel.py.

Each rank computes the loss and gradients of its own block of the batch;
the gradients and the loss are averaged over `data` (one all-reduce of one
flat buffer a step), aux sums are summed, and Adam runs replicated on every
rank, so the parameters stay equal bit for bit. The train state is the
port's flat JAX-layout dict (`models.flat_params`), not an nn.Module, so
this is an explicit step in place of DistributedDataParallel.

The semantics are the JAX step's: the loss is the mean over the data
shards of each shard's own loss (for a masked mean, not the mean over the
whole batch's valid elements when the shards hold different counts).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..training.fit import Adam, AdamState
from ..utils import fold_generator
from .mesh import AXES, all_reduce_, all_reduce_tree


def reduce_grads_(params: dict, opt_state: AdamState, loss: torch.Tensor,
                  group, mean_over: int = 1) -> torch.Tensor:
    """The gradients of params (in opt_state's order) and the loss, summed
    over the group in one flat buffer and divided by mean_over; each
    parameter's .grad becomes its view of the buffer. Returns the loss.
    A parameter without a gradient (the same on every rank: the ranks run
    one graph) keeps none, and Adam passes it over as in one process."""
    ps = [params[k] for k in opt_state.keys if params[k].grad is not None]
    buf = torch.cat([p.grad.reshape(-1) for p in ps]
                    + [loss.detach().reshape(1).float()])
    all_reduce_(buf, group)
    if mean_over != 1:
        buf /= mean_over
    off = 0
    for p in ps:
        p.grad = buf[off:off + p.numel()].view_as(p)
        off += p.numel()
    return buf[-1]


def make_dp_train_step(loss_fn: Callable, optimizer: Adam, mesh: DeviceMesh,
                       has_aux: bool = False):
    """A data-parallel train step.

    loss_fn(params, batch, generator) -> scalar loss (or (loss, aux) with
    has_aux; aux: a pytree of this rank's SUMS, summed over `data`).
    batch: this rank's block of the global batch (`shard_batch`).
    generator: the step's torch.Generator, the same on every rank; the step
    folds in the rank's index on `data` (the JAX step's fold_in of
    axis_index), so dropout and rotations decorrelate across ranks, and
    rank 0 draws what a single-process step draws.

    Returns train_step(params, opt_state, batch, generator) ->
    (params, opt_state, loss[, aux]), updating params and opt_state in
    place as `training.make_train_step` does."""
    group = mesh.get_group("data")
    n = mesh.size(AXES.index("data"))
    rank = mesh.get_local_rank("data")

    def train_step(params, opt_state: AdamState, batch, generator=None):
        opt = opt_state.optimizer
        opt.zero_grad(set_to_none=True)
        out = loss_fn(params, batch, fold_generator(generator, rank))
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        loss = reduce_grads_(params, opt_state, loss, group, n)
        opt.step()
        opt_state.scheduler.step()
        if has_aux:
            return params, opt_state, loss, all_reduce_tree(aux, group)
        return params, opt_state, loss

    return train_step


def make_dp_eval_step(metric_fn: Callable, mesh: DeviceMesh):
    """metric_fn(params, batch) -> a pytree of this rank's SUMS (correct
    counts, totals), run without autograd and summed over `data`."""
    group = mesh.get_group("data")

    def eval_step(params, batch):
        with torch.no_grad():
            return all_reduce_tree(metric_fn(params, batch), group)

    return eval_step
