"""Checkpoints of the full train state, restorable mid-run: the counterpart
of diffusionnet_tpu/training/checkpoint.py.

The file is the JAX package's npz format (its Orbax-free branch): one array
per leaf, keyed by the leaf's path as `jax.tree_util.keystr` writes it
(`['params']['params']['block_0']['diffusion']['diffusion_time']`,
`['opt_state'][0].mu['params']...`). A state is a tree of dicts (keys in
sorted order), tuples and lists (`[i]`), NamedTuples (`.field`) and array
leaves (numpy arrays or tensors on any device); None has no leaves. So a
JAX checkpoint and a port checkpoint of the same train state have the same
keys, and each package restores the other's params.

The train state of `experiments.exp_common.fit` is `train_state(...)`:
params nested from the port's JAX-layout flat keys, the Adam state in
optax's layout (`(ScaleByAdamState(count, mu, nu),
ScaleByScheduleState(count))`, the second `()` without a schedule, as
optax's EmptyState), the epoch, and the generator's state as `rng`.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from ..utils import to_np
from .fit import AdamState, adam_state_from_flat, adam_state_to_flat


class ScaleByAdamState(NamedTuple):
    """optax.ScaleByAdamState's fields."""
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    """optax.ScaleByScheduleState's field."""
    count: Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _path_keys(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) per leaf in jax.tree_util's order, keyed as keystr."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _path_keys(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _path_keys(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree)
                for kv in _path_keys(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, leaves: dict, prefix: str = ""):
    """`tree`'s structure with each leaf taken from leaves[key]."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves,
                                     f"{prefix}.{f}") for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves, f"{prefix}[{i}]")
                          for i, x in enumerate(tree))
    return leaves[prefix]


def save_checkpoint(ckpt_dir: str, state: Any, step: int | None = None
                    ) -> str:
    """Write `state` to <ckpt_dir>/step_<step>.npz; returns its absolute
    path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir,
                        f"step_{step if step is not None else 0}.npz")
    np.savez(path, **{k: to_np(v) for k, v in _path_keys(state)})
    return path


def restore_checkpoint(path: str, template: Any) -> Any:
    """The checkpoint at `path` in `template`'s structure, numpy leaves. A
    params-only template (the `params` subtree of a train state) also
    restores from a full-train-state checkpoint. Relative paths are
    accepted."""
    path = os.path.abspath(path)
    with np.load(path) as npz:
        keys = [k for k, _ in _path_keys(template)]
        for prefix in ("", "['params']"):
            if all(prefix + k in npz.files for k in keys):
                return _rebuild(template,
                                {k: npz[prefix + k] for k in keys})
        raise ValueError(
            f"checkpoint '{path}' does not contain the template's leaves "
            f"(have {sorted(npz.files)[:4]}..., want {keys[:4]}...)")


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """Absolute path of the highest-step step_N.npz under ckpt_dir, or
    None."""
    best_step, best_path = -1, None
    if not os.path.isdir(ckpt_dir):
        return None
    for name in os.listdir(ckpt_dir):
        stem = name[:-4] if name.endswith(".npz") else name
        if not stem.startswith("step_"):
            continue
        try:
            step = int(stem[len("step_"):])
        except ValueError:
            continue
        if step > best_step:
            best_step = step
            best_path = os.path.join(os.path.abspath(ckpt_dir), name)
    return best_path


# ---------------------------------------------------------------------------
# The train state of experiments.exp_common.fit
# ---------------------------------------------------------------------------

def nest(flat: dict) -> dict:
    """'/'-joined flat keys -> nested dicts ('params/block_0/...' ->
    {'params': {'block_0': ...}}), the flax params tree."""
    tree: dict = {}
    for key, val in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def unnest(tree: dict, prefix: str = "") -> dict:
    """The inverse of `nest`."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(unnest(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = v
    return flat


def train_state(params: dict, opt_state: AdamState, epoch: int,
                generator: torch.Generator, scheduled: bool = True) -> dict:
    """{params, opt_state, epoch, rng} as fit saves it. params: the port's
    JAX-layout flat tensors; scheduled: the optimizer has a decay schedule
    (optax then keeps a schedule count beside Adam's)."""
    flat = adam_state_to_flat(opt_state)
    count = flat["count"]
    adam = ScaleByAdamState(
        count, nest({k: flat["mu/" + k] for k in opt_state.keys}),
        nest({k: flat["nu/" + k] for k in opt_state.keys}))
    return {"params": nest(params),
            "opt_state": (adam, ScaleByScheduleState(count) if scheduled
                          else ()),
            "epoch": np.asarray(epoch, np.int32),
            "rng": generator.get_state().numpy()}


def load_train_state(state: dict, params: dict, opt_state: AdamState,
                     generator: torch.Generator) -> int:
    """A restored `train_state` tree into the live train state, in place:
    params copied into their tensors, the Adam state and its schedule
    count, the generator's state. Returns the saved epoch."""
    with torch.no_grad():
        for k, v in unnest(state["params"]).items():
            params[k].copy_(torch.from_numpy(np.asarray(v)))
    adam = state["opt_state"][0]
    flat = {"count": adam.count}
    flat.update({"mu/" + k: v for k, v in unnest(adam.mu).items()})
    flat.update({"nu/" + k: v for k, v in unnest(adam.nu).items()})
    adam_state_from_flat(opt_state, flat)
    generator.set_state(torch.from_numpy(np.asarray(state["rng"])))
    return int(state["epoch"])
