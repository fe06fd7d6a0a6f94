"""Serving artifacts: the forward pass exported with torch.export.

The counterpart of diffusionnet_tpu/serving/export.py, its single-card
half. `export_forward` traces the deterministic forward ONCE per vertex
bucket with `torch.export` (the batch dimension symbolic) and writes each
ExportedProgram (`torch.export.save`) next to the params and a manifest. A
serving process calls `load_serving_model(dir)` and needs torch, numpy and
the port's kernel ops (`ops.fused` registers them): no model class, no
geometry, models, training, data or experiments module, no retracing.

The traced function is the JAX artifact's,
fwd(params, x, mass, evals, evecs, gX, gY[, inds]), with `params` the
nested tree of the JAX package's parameter names. The programs hold no
weights: `params.npz` is the weights' one source of truth. The loader
reads it and passes it to every call, as the JAX artifact takes params as
an input; the JAX package's own loader reads the same file.

A model built with use_pallas_fused runs its blocks on kernel B4. Its
programs hold B4's registered ops (dnt_torch::spectral_project,
::spectral_apply) as graph nodes: the hand-written kernels on a CUDA card,
their plain versions on the CPU. The kernels read dense operands, so a
prepared handle of such a program materializes its broadcast operators
for a batch of B > 1: one copy at a time, of the last such B.

Inputs are the production spectral path (the dense (V, K) spectral
gradient operators of geometry.operators.Operators): x, mass, evals,
evecs, gradX_spec, gradY_spec; no sparse operator crosses the serving
boundary. Vertex counts take a fixed set of static V buckets; the batch
dimension is symbolic (`torch.export.Dim("b", min=1)`, traced at batch 2,
since torch specialises sizes 0 and 1), so one program serves any batch
size. `outputs_at='edges'/'faces'` adds one int32 index input whose
element count is a second symbolic dimension.

Artifact directory layout:
    manifest.json     io spec, bucket list, metadata (the JAX keys)
    params.npz        parameters keyed by '/'-joined pytree path
    bucket_<V>.pt2    torch.export.ExportedProgram for vertex bucket V

The vertex-sharded artifact (the JAX package's kind="sharded_forward")
comes with ROADMAP item A.6.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fused as _fused  # registers the kernel ops before a load

MANIFEST_NAME = "manifest.json"
PARAMS_NAME = "params.npz"
FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# params (de)serialization: '/'-joined-path npz, rebuilt WITHOUT a template
# (the serving loader must not need the model definition to build one)

def _flatten_params(tree, prefix=""):
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            k = str(k)
            if "/" in k:
                raise ValueError(f"param key {k!r} contains '/'")
            flat.update(_flatten_params(v, f"{prefix}{k}/"))
    else:
        flat[prefix[:-1]] = tree
    return flat


def _unflatten_params(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _params_tree(flat: dict, device) -> dict:
    """The program's `params` input: f32 tensors on `device`, in sorted key
    order (a program checks its inputs' tree, insertion order included)."""
    return _unflatten_params({
        k: torch.as_tensor(np.asarray(flat[k]), dtype=torch.float32,
                           device=device) for k in sorted(flat)})


# ---------------------------------------------------------------------------
# export

def _io_kind(outputs_at: str) -> dict:
    if outputs_at in ("vertices", "global_mean"):
        return {"index_input": None}
    if outputs_at == "edges":
        return {"index_input": "edges", "index_width": 2}
    if outputs_at == "faces":
        return {"index_input": "faces", "index_width": 3}
    raise ValueError(f"unsupported outputs_at={outputs_at!r}")


def _device(device) -> torch.device:
    """An explicit device, honoured exactly: "cuda" without a card raises
    (no CPU artifact or program in its place)."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but "
                           "torch.cuda.is_available() is false")
    return device


def kernel_ops(program) -> dict[str, int]:
    """The port's registered kernel ops (dnt_torch::...) in an
    ExportedProgram's graph: op name -> node count."""
    found: dict[str, int] = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith(
                _fused.OPS_NAMESPACE + "."):
            key = name.split(".")[1]
            found[key] = found.get(key, 0) + 1
    return found


def host_reads(program) -> list[str]:
    """Nodes of an ExportedProgram's graph that copy a device value to the
    host (aten._local_scalar_dense, aten.item): none may be on the serving
    path."""
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith(
                ("aten._local_scalar_dense.", "aten.item."))]


class _Forward(torch.nn.Module):
    """fwd(params, x, mass, evals, evecs, gX, gY[, inds]): the model's
    deterministic forward on the weights in `params`. The model is held
    outside the module's state, so the program's only weights are its
    `params` input."""

    def __init__(self, model, index_input: str | None, module_state):
        super().__init__()
        self._model = (model,)
        self._index_input = index_input
        self._module_state = module_state

    def forward(self, params, x, mass, evals, evecs, gX, gY, inds=None):
        kw = dict(evals=evals, evecs=evecs, gradX=gX, gradY=gY,
                  deterministic=True)
        if self._index_input is not None:
            kw[self._index_input] = inds
        state = self._module_state(_flatten_params(params))
        return torch.func.functional_call(self._model[0], state, (x, mass),
                                          kw, strict=True)


def export_forward(model, v_buckets: Sequence[int], out_dir: str, k_eig: int,
                   device=None, extra_metadata: dict | None = None) -> str:
    """Export the port's DiffusionNet (deterministic forward, spectral
    path, its own weights) as a serving artifact under `out_dir`.

    v_buckets: static vertex paddings to export, e.g. (1024, 4096, 16384).
    k_eig: the spectral basis width the operators were computed with.
    device: the device the programs are traced for, recorded as the
    manifest's `platforms` (["cuda"] or ["cpu"]). An explicit device is
    honoured exactly ("cuda" without a card raises); the default is the
    device of the model's parameters.

    Returns out_dir. Loading needs only `load_serving_model`."""
    from ..models.params import module_state, to_flat_jax_params

    if model.diffusion_method != "spectral":
        raise ValueError("export_forward supports diffusion_method='spectral' "
                         "(the production serving path)")
    v_buckets = sorted(set(int(v) for v in v_buckets))
    if not v_buckets:
        raise ValueError("need at least one vertex bucket")
    io = _io_kind(model.outputs_at)
    dev = _device(next(model.parameters()).device if device is None
                  else device)
    flat = to_flat_jax_params(model)
    params = _params_tree(flat, dev)
    fwd = _Forward(model, io["index_input"], module_state)

    os.makedirs(out_dir, exist_ok=True)
    static = _unflatten_params({k: None for k in sorted(flat)})
    b = torch.export.Dim("b", min=1)
    batch = {0: b}
    for v in v_buckets:
        zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        args = (params, zeros(2, v, model.c_in), zeros(2, v) + 1,
                zeros(2, k_eig), zeros(2, v, k_eig), zeros(2, v, k_eig),
                zeros(2, v, k_eig))
        shapes = (static, batch, batch, batch, batch, batch, batch)
        if io["index_input"] is not None:
            args += (torch.zeros((2, 2, io["index_width"]), dtype=torch.int32,
                                 device=dev),)
            shapes += ({0: b, 1: torch.export.Dim("e", min=1)},)
        with torch.no_grad():
            program = torch.export.export(fwd, args, dynamic_shapes=shapes)
        reads = host_reads(program)
        if reads:
            raise RuntimeError(f"the traced forward reads device values on "
                               f"the host: {reads}")
        program.example_inputs = None  # not saved: bucket-sized zeros
        torch.export.save(program, os.path.join(out_dir, f"bucket_{v}.pt2"))

    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": "forward",
        "c_in": int(model.c_in),
        "c_out": int(model.c_out),
        "k_eig": int(k_eig),
        "outputs_at": model.outputs_at,
        "index_input": io["index_input"],
        "v_buckets": v_buckets,
        "platforms": [dev.type],
        "batch_symbolic": True,
        "metadata": extra_metadata or {},
    }
    np.savez(os.path.join(out_dir, PARAMS_NAME), **flat)
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


_SHARDED = ("the vertex-sharded serving artifact (one surface over several "
            "cards) comes with ROADMAP item A.6; export_forward and "
            "load_serving_model serve on one card")


def export_sharded_forward(*args, **kwargs):
    raise NotImplementedError(_SHARDED)


# ---------------------------------------------------------------------------
# load + serve

def _pad_rows(a: torch.Tensor, axis: int, amount: int) -> torch.Tensor:
    """Zero-pad one axis at its end, on a's device."""
    if amount == 0:
        return a
    axis %= a.ndim
    return F.pad(a, [0, 0] * (a.ndim - 1 - axis) + [0, amount])


class PreparedMesh:
    """Device-resident per-mesh serving handle (the production hot path).

    `ServingModel.prepare(...)` validates, K-truncates, pads to the bucket
    and uploads the per-mesh operators ONCE; each `handle(x)` then moves
    only the signal `x` (V, c_in) or (B, V, c_in), and its output stays on
    the device.

    Batched requests broadcast the resident operators to (B, ...) with
    `expand` (no copy), cached per batch size. A program that runs the
    kernel ops gets them materialized instead: the kernels read dense
    (B, V, K) operands. The handle keeps one such copy, of the last batch
    size B > 1 it served (3 B V K floats; a new B replaces it)."""

    def __init__(self, sm: "ServingModel", v: int, bucket: int, ops1, inds1):
        self._sm = sm
        self.v = v
        self.bucket = bucket
        self._ops1 = ops1    # (mass, evals, evecs, gX, gY) each batch-1 padded
        self._inds1 = inds1  # (1, E, w) int32 or None
        self._cache = {}     # batch size -> broadcast operand tuple

    def _batched(self, b: int):
        got = self._cache.get(b)
        if got is None:
            dense = self._sm.dense_operands and b > 1
            ops = (*self._ops1,
                   *(() if self._inds1 is None else (self._inds1,)))
            got = tuple(a.expand(b, *a.shape[1:]) for a in ops)
            if dense:
                got = tuple(a.contiguous() for a in got)
                self._cache = {1: self._cache[1]} if 1 in self._cache else {}
            self._cache[b] = got
        return got

    def __call__(self, x):
        sm, m = self._sm, self._sm.manifest
        x = sm._f32(x)
        unbatched = x.ndim == 2
        if x.shape[-1] != m["c_in"]:
            raise ValueError(f"x has {x.shape[-1]} channels; artifact "
                             f"expects c_in={m['c_in']}")
        if x.shape[-2] != self.v:
            raise ValueError(f"x has {x.shape[-2]} vertices; this handle was "
                             f"prepared for V={self.v}")
        if unbatched:
            x = x[None]
        x = _pad_rows(x, -2, self.bucket - self.v)
        out = sm._run(self.bucket, x, *self._batched(x.shape[0]))
        return sm._finish(out, self.v, self.bucket, unbatched)


class ServingModel:
    """A loaded serving artifact: callable, bucket-dispatching forward.

    call(x, mass, evals, evecs, gradX_spec, gradY_spec, inds=None)
      x: (V, c_in) or (B, V, c_in) float; operators shaped to match
      (geometry.Operators fields; inds = edges/faces indices when the
      artifact was exported with outputs_at='edges'/'faces'). Arrays or
      tensors; everything is moved to the model's device, and the output
      is a tensor there.
    Vertex counts are padded (on the device) up to the smallest exported
    bucket >= V; the output is sliced back to V (vertex outputs) or
    returned as-is (global_mean). K wider than the artifact's k_eig is
    truncated (the spectral basis is ordered); narrower is an error."""

    def __init__(self, manifest: dict, params: dict, programs: dict, device):
        self.manifest = manifest
        self.device = torch.device(device)
        # on the device from load time: every call passes them
        self.params = _params_tree(_flatten_params(params), self.device)
        self.programs = programs  # v -> torch.export.ExportedProgram
        self._fns = {v: ep.module() for v, ep in programs.items()}
        # the kernel ops read dense operands: no stride-0 broadcasts
        self.dense_operands = any(kernel_ops(ep) for ep in programs.values())

    @property
    def v_buckets(self):
        return sorted(self.programs)

    def pick_bucket(self, v: int) -> int:
        """Smallest exported vertex bucket >= v (the serving dispatch rule)."""
        for b in self.v_buckets:
            if v <= b:
                return b
        raise ValueError(
            f"mesh has {v} vertices but the largest exported bucket is "
            f"{self.v_buckets[-1]}; re-export with a larger bucket")

    def _f32(self, a) -> torch.Tensor:
        """On the device as f32 with no host round trip: a tensor there
        stays (a dtype cast runs there); host data uploads once."""
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _inds(self, inds, unbatched: bool):
        m = self.manifest
        if m["index_input"] is None:
            if inds is not None:
                raise ValueError("artifact takes no index input")
            return None
        if inds is None:
            raise ValueError(
                f"artifact was exported with outputs_at="
                f"{m['outputs_at']!r}; pass inds={m['index_input']}")
        inds = torch.as_tensor(inds, dtype=torch.int32, device=self.device)
        return inds[None] if unbatched else inds

    def _run(self, bucket: int, *args):
        with torch.no_grad():
            return self._fns[bucket](self.params, *args)

    def _finish(self, out, v: int, bucket: int, unbatched: bool):
        if self.manifest["outputs_at"] == "vertices" and bucket != v:
            out = out[..., :v, :]
        return out[0] if unbatched else out

    def __call__(self, x, mass, evals, evecs, gradX_spec, gradY_spec,
                 inds=None):
        m = self.manifest
        x, mass, evals, evecs, gX, gY = (
            self._f32(a) for a in (x, mass, evals, evecs, gradX_spec,
                                   gradY_spec))
        unbatched = x.ndim == 2
        if unbatched:
            x, mass, evals, evecs, gX, gY = (
                a[None] for a in (x, mass, evals, evecs, gX, gY))
        inds = self._inds(inds, unbatched)
        if x.shape[-1] != m["c_in"]:
            raise ValueError(f"x has {x.shape[-1]} channels; artifact "
                             f"expects c_in={m['c_in']}")
        evals, evecs, gX, gY = self._truncate_k(evals, evecs, gX, gY)

        v = x.shape[-2]
        bucket = self.pick_bucket(v)
        pad = bucket - v
        x, evecs, gX, gY = (_pad_rows(a, -2, pad).contiguous()
                            for a in (x, evecs, gX, gY))
        mass = _pad_rows(mass, -1, pad).contiguous()
        args = (x, mass, evals.contiguous(), evecs, gX, gY)
        out = self._run(bucket, *args, *(() if inds is None else (inds,)))
        return self._finish(out, v, bucket, unbatched)

    def _truncate_k(self, evals, evecs, gX, gY):
        """K wider than the artifact's k_eig truncates exactly (the spectral
        basis is ordered); narrower is an error."""
        k, want = evals.shape[-1], self.manifest["k_eig"]
        if k < want:
            raise ValueError(f"operators have K={k} < artifact k_eig="
                             f"{want}; recompute with larger k_eig")
        if k > want:
            evals, evecs = evals[..., :want], evecs[..., :want]
            gX, gY = gX[..., :want], gY[..., :want]
        return evals, evecs, gX, gY

    def prepare(self, mass, evals, evecs, gradX_spec, gradY_spec,
                inds=None) -> PreparedMesh:
        """Upload + pad the per-mesh operators ONCE; returns a PreparedMesh
        handle whose `handle(x)` streams only the signal per request.

        Operators are UNBATCHED: mass (V,), evals (K,), evecs/gradX_spec/
        gradY_spec (V, K); inds (E, 2)/(F, 3) when the artifact was
        exported with outputs_at='edges'/'faces'."""
        mass, evals, evecs, gX, gY = (
            self._f32(a) for a in (mass, evals, evecs, gradX_spec, gradY_spec))
        if evecs.ndim != 2 or mass.ndim != 1 or evals.ndim != 1:
            raise ValueError("prepare() takes UNBATCHED operators: mass (V,),"
                             " evals (K,), evecs/gradX_spec/gradY_spec (V, K)")
        evals, evecs, gX, gY = self._truncate_k(evals, evecs, gX, gY)
        v = evecs.shape[0]
        bucket = self.pick_bucket(v)
        pad = bucket - v
        mass, evecs, gX, gY = (_pad_rows(a, 0, pad)
                               for a in (mass, evecs, gX, gY))
        ops1 = tuple(a.contiguous()[None]
                     for a in (mass, evals, evecs, gX, gY))
        return PreparedMesh(self, v, bucket, ops1, self._inds(inds, True))

    def prepare_operators(self, ops) -> PreparedMesh:
        """prepare() from a geometry.Operators bundle (needs ops.gradX_spec;
        faces/edges indices must be passed to prepare() directly)."""
        if ops.gradX_spec is None:
            raise ValueError("Operators bundle lacks spectral gradient "
                             "operators (computed by compute_operators)")
        return self.prepare(ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
                            ops.gradY_spec)

    def call_operators(self, x, ops, inds=None):
        """Convenience: forward from a geometry.Operators bundle (uses the
        dense spectral gradient operators; requires ops.gradX_spec)."""
        if ops.gradX_spec is None:
            raise ValueError("Operators bundle lacks spectral gradient "
                             "operators (computed by compute_operators)")
        return self(x, ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
                    ops.gradY_spec, inds=inds)


def _read_manifest_params(artifact_dir: str):
    with open(os.path.join(artifact_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported artifact format_version="
            f"{manifest.get('format_version')} (this build reads "
            f"{FORMAT_VERSION})")
    npz = np.load(os.path.join(artifact_dir, PARAMS_NAME))
    params = _unflatten_params({k: npz[k] for k in npz.files})
    return manifest, params


def load_serving_model(artifact_dir: str, device="cuda") -> ServingModel:
    """Load an artifact written by export_forward onto `device` (the CUDA
    card unless the caller asks for the CPU; "cuda" without a card
    raises). Needs torch, numpy and the port's kernel ops only. A program
    traced for another device is moved with
    torch.export.passes.move_to_device_pass; a failure there raises."""
    manifest, params = _read_manifest_params(artifact_dir)
    kind = manifest.get("kind", "forward")
    if kind != "forward":
        raise ValueError(f"artifact kind={kind!r}; the sharded artifact "
                         "comes with ROADMAP item A.6")
    dev = _device(device)
    programs = {}
    for v in manifest["v_buckets"]:
        program = torch.export.load(
            os.path.join(artifact_dir, f"bucket_{v}.pt2"))
        if manifest["platforms"] != [dev.type]:
            from torch.export.passes import move_to_device_pass
            program = move_to_device_pass(program, dev)
        programs[int(v)] = program
    return ServingModel(manifest, params, programs, dev)


def load_sharded_serving_model(*args, **kwargs):
    raise NotImplementedError(_SHARDED)


class ShardedServingModel:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_SHARDED)


class PreparedSurface:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_SHARDED)
