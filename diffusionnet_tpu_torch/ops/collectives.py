"""A sum over a group of ranks that gives every rank the same bits, and
the registered operator that carries a vertex-sharded sum through
torch.export.

`ordered_sum` gathers every rank's tensor and adds them in rank order, the
same additions on every rank, so each holds the same result bit for bit
(an all-reduce's order is the library's choice). The device eigensolver's
sharded route makes host decisions on every rank from its reduced (n, n)
matrices; those agree only if the bits do.

`dnt_torch::vert_sum(Tensor t, str group) -> Tensor` is `ordered_sum` over
the process group registered under `group` (`register_group`). The
vertex-sharded serving artifact holds it as a graph node: its fake needs no
process group, so a program is traced in one process, and the loader
registers the `vert` group on each rank before the first call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import fused as _fused   # defines the dnt_torch namespace first


def ordered_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the group's ranks in rank order: a new tensor on t's
    device, the same bits on every rank (no autograd)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc


# ---------------------------------------------------------------------------
# dnt_torch::vert_sum

_GROUPS: dict = {}
_LIB = torch.library.Library(_fused.OPS_NAMESPACE, "FRAGMENT")
_LIB.define("vert_sum(Tensor t, str group) -> Tensor")


def register_group(name: str, group) -> None:
    """Make `group` (a ProcessGroup, or None for the world) the one that
    dnt_torch::vert_sum(t, name) sums over in this process."""
    _GROUPS[name] = group


def _vert_sum(t: torch.Tensor, group: str) -> torch.Tensor:
    if group not in _GROUPS:
        raise RuntimeError(
            f"dnt_torch::vert_sum: no process group registered as "
            f"{group!r} in this process (load_sharded_serving_model "
            "registers it after torch.distributed is initialized)")
    return ordered_sum(t, _GROUPS[group])


_LIB.impl("vert_sum", _vert_sum, "CPU")
_LIB.impl("vert_sum", _vert_sum, "CUDA")
vert_sum_op = torch.ops.dnt_torch.vert_sum.default


@torch.library.register_fake(vert_sum_op, lib=_LIB)
def _(t, group):
    return torch.empty_like(t)


class TracedVert:
    """The `vert=` argument of the model's forward inside a traced
    vertex-sharded program: `size` shards, and `sum` the registered
    dnt_torch::vert_sum over the group named `name`. A gather of the whole
    surface has no place in such a program (its outputs are per vertex or
    the global mean) and raises."""

    def __init__(self, size: int, name: str = "vert"):
        self.size = size
        self.name = name

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return vert_sum_op(t, self.name)

    def gather(self, t, dim: int = -2):
        raise ValueError("a vertex-sharded program holds no whole-surface "
                         "gather (ELL operators, implicit_dense, edge and "
                         "face outputs): serve those on one card")
