"""Weight bridge between the JAX package's parameter tree and the port's
DiffusionNet.

The JAX side is the parameter tree flattened to '/'-joined keys, the
`params.npz` layout of diffusionnet_tpu/serving/export.py, e.g.
`params/block_0/mlp/dense_001/kernel`. A flax `Dense` kernel is (in, out);
an `nn.Linear.weight` is (out, in), so kernels are transposed both ways.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_PREFIX = "params/"


def _jax_to_torch_name(key: str) -> tuple[str, bool]:
    """JAX flat key -> (port state_dict key, transpose?)."""
    if not key.startswith(_PREFIX):
        raise KeyError(f"not a flax params key: {key!r}")
    parts = key[len(_PREFIX):].split("/")
    leaf = parts[-1]
    path = parts[:-1]
    out = []
    for p in path:
        m = re.fullmatch(r"block_(\d+)", p)
        d = re.fullmatch(r"dense_(\d+)", p)
        if m:
            out += ["blocks", str(int(m.group(1)))]
        elif d:
            out += ["layers", str(int(d.group(1)))]
        else:
            out.append(p)
    if leaf == "kernel":
        return ".".join(out + ["weight"]), True
    return ".".join(out + [leaf]), False


def _torch_to_jax_name(key: str) -> tuple[str, bool]:
    """Port state_dict key -> (JAX flat key, transpose?)."""
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts) - 1:
        p = parts[i]
        if p == "blocks":
            out.append(f"block_{int(parts[i + 1])}")
            i += 2
        elif p == "layers":
            out.append(f"dense_{int(parts[i + 1]):03d}")
            i += 2
        else:
            out.append(p)
            i += 1
    leaf = parts[-1]
    if leaf == "weight":
        return _PREFIX + "/".join(out + ["kernel"]), True
    return _PREFIX + "/".join(out + [leaf]), False


def from_flat_jax_params(flat: dict) -> dict[str, torch.Tensor]:
    """JAX flat params (numpy arrays, or tensors such as the train state of
    `training.fit`) -> a state_dict for the port's DiffusionNet:
    `model.load_state_dict(from_flat_jax_params(flat))`."""
    state = {}
    for key, val in flat.items():
        name, transpose = _jax_to_torch_name(key)
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().numpy()
        arr = np.asarray(val, dtype=np.float32)
        state[name] = torch.from_numpy(np.array(arr.T if transpose else arr,
                                                order="C"))
    return state


def to_flat_jax_params(model_or_state) -> dict[str, np.ndarray]:
    """The port's DiffusionNet (or its state_dict) -> JAX flat params, the
    inverse of from_flat_jax_params."""
    state = (model_or_state.state_dict()
             if isinstance(model_or_state, torch.nn.Module)
             else model_or_state)
    flat = {}
    for name, t in state.items():
        key, transpose = _torch_to_jax_name(name)
        arr = t.detach().cpu().numpy()
        flat[key] = np.ascontiguousarray(arr.T if transpose else arr)
    return flat


def module_state(params: dict) -> dict[str, torch.Tensor]:
    """JAX-layout flat tensors -> the port's state_dict names, as views that
    keep autograd: `torch.func.functional_call(model, module_state(params),
    ...)` runs the eager model on the train state, and its gradients land on
    the flat tensors."""
    state = {}
    for key, val in params.items():
        name, transpose = _jax_to_torch_name(key)
        state[name] = val.transpose(0, 1) if transpose else val
    return state
