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

The vertex-sharded artifact (kind="sharded_forward",
`export_sharded_forward` / `load_sharded_serving_model`) serves ONE large
surface over n ranks, one process a card. Its one program is one rank's
forward on v_bucket / n rows, traced once; every rank loads the same file.
The only exchange between the shards is each block's (K, C) projection sum
and global_mean's numerator and denominator: the registered operator
dnt_torch::vert_sum (ops/collectives.py), a graph node whose fake needs no
process group, so the export runs in one process; the loader registers the
rank's `vert` group for it. A use_pallas_fused model runs B4 on each
shard's rows, its projection summed between the two kernels.

Artifact directory layout:
    manifest.json       io spec, bucket list, metadata (the JAX keys)
    params.npz          parameters keyed by '/'-joined pytree path
    bucket_<V>.pt2      torch.export.ExportedProgram for vertex bucket V
    sharded_<V>x<n>.pt2 one rank's program (kind="sharded_forward")
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import collectives as _collectives  # registers dnt_torch::vert_sum
from ..ops import fused as _fused  # registers the kernel ops before a load
from ..training.profiling import count, span, wait

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
    (no CPU artifact or program in its place). "cuda" is the current card,
    by its index."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but "
                           "torch.cuda.is_available() is false")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
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

    def __init__(self, model, index_input: str | None, module_state,
                 vert=None):
        super().__init__()
        self._model = (model,)
        self._index_input = index_input
        self._module_state = module_state
        self._vert = vert   # a TracedVert: one shard's rows

    def forward(self, params, x, mass, evals, evecs, gX, gY, inds=None):
        kw = dict(evals=evals, evecs=evecs, gradX=gX, gradY=gY,
                  deterministic=True)
        if self._index_input is not None:
            kw[self._index_input] = inds
        if self._vert is not None:
            kw["vert"] = self._vert
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
        _save_program(fwd, args, os.path.join(out_dir, f"bucket_{v}.pt2"),
                      shapes)

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
    _write_params_manifest(out_dir, flat, manifest)
    return out_dir


def _write_params_manifest(out_dir: str, flat: dict, manifest: dict):
    np.savez(os.path.join(out_dir, PARAMS_NAME), **flat)
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)


def _save_program(fwd, args, path: str, dynamic_shapes=None):
    """Trace fwd(*args) without autograd, refuse host reads, save."""
    with torch.no_grad():
        program = torch.export.export(fwd, args,
                                      dynamic_shapes=dynamic_shapes)
    reads = host_reads(program)
    if reads:
        raise RuntimeError(f"the traced forward reads device values on "
                           f"the host: {reads}")
    program.example_inputs = None  # not saved: bucket-sized zeros
    torch.export.save(program, path)


def export_sharded_forward(model, v_bucket: int, out_dir: str, k_eig: int,
                           n_devices: int | None = None, mesh=None,
                           device=None,
                           extra_metadata: dict | None = None) -> str:
    """Export a VERTEX-SHARDED forward of ONE large surface as a serving
    artifact under `out_dir`: one program, one rank's deterministic forward
    on v_bucket / n rows (x, mass, evecs, gX, gY those rows; evals whole),
    each block's projection summed over the ranks by dnt_torch::vert_sum.
    The trace runs in this one process and needs no process group.

    n_devices: the rank count n to serve on; or mesh=, a DeviceMesh whose
    `vert` axis gives it. outputs_at must be 'vertices' or 'global_mean'
    (edge and face outputs gather across shards: serve those with
    export_forward); v_bucket must split over the n ranks, and for a
    use_pallas_fused model each rank's rows must be a multiple of its
    pallas_tile_v (B4's row tile). device: as export_forward's. Returns
    out_dir; load it with load_sharded_serving_model on every rank."""
    from ..models.params import module_state, to_flat_jax_params

    if model.diffusion_method != "spectral":
        raise ValueError("export_sharded_forward supports "
                         "diffusion_method='spectral'")
    if model.outputs_at not in ("vertices", "global_mean"):
        raise ValueError("sharded serving supports outputs_at='vertices' or "
                         "'global_mean'")
    if mesh is not None:
        n = mesh.size(mesh.mesh_dim_names.index("vert"))
    elif n_devices is None:
        raise ValueError("pass mesh= or n_devices=")
    else:
        n = int(n_devices)
    v = int(v_bucket)
    if n < 1 or v % n != 0:
        raise ValueError(f"v_bucket={v} not divisible by the {n} devices")
    rows = v // n
    if getattr(model, "use_pallas_fused", False) and (
            rows % model.pallas_tile_v):
        raise ValueError(
            f"v_bucket={v} over {n} devices gives {rows} rows a rank, not a "
            f"multiple of the fused model's pallas_tile_v="
            f"{model.pallas_tile_v}: B4 would not run on the shards")
    dev = _device(next(model.parameters()).device if device is None
                  else device)
    flat = to_flat_jax_params(model)
    fwd = _Forward(model, None, module_state, _collectives.TracedVert(n))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    args = (_params_tree(flat, dev), zeros(rows, model.c_in),
            zeros(rows) + 1, zeros(k_eig), zeros(rows, k_eig),
            zeros(rows, k_eig), zeros(rows, k_eig))
    os.makedirs(out_dir, exist_ok=True)
    _save_program(fwd, args, os.path.join(out_dir, f"sharded_{v}x{n}.pt2"))
    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": "sharded_forward",
        "c_in": int(model.c_in),
        "c_out": int(model.c_out),
        "k_eig": int(k_eig),
        "outputs_at": model.outputs_at,
        "v_bucket": v,
        "n_devices": n,
        "platforms": [dev.type],
        "metadata": extra_metadata or {},
    }
    _write_params_manifest(out_dir, flat, manifest)
    return out_dir


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

    def _upload(self, x) -> torch.Tensor:
        """x on the device as f32. Host data is copied there, counted in
        upload_bytes, and the copy blocks until the card has it."""
        dev = self._sm.device
        if torch.is_tensor(x) and x.device.type == dev.type:
            return self._sm._f32(x)
        with wait("dnt.wait.upload", dev):
            x = self._sm._f32(x)
        count("upload_bytes", x.numel() * x.element_size())
        return x

    def __call__(self, x):
        """The model's output for x (V, c_in) or (B, V, c_in), on the device.
        A call records the span dnt.serve, with dnt.serve.upload, .pad,
        .program and .finish inside it (`training.profiling`)."""
        sm, m = self._sm, self._sm.manifest
        with span("dnt.serve"):
            with span("dnt.serve.upload"):
                x = self._upload(x)
            unbatched = x.ndim == 2
            if x.shape[-1] != m["c_in"]:
                raise ValueError(f"x has {x.shape[-1]} channels; artifact "
                                 f"expects c_in={m['c_in']}")
            if x.shape[-2] != self.v:
                raise ValueError(f"x has {x.shape[-2]} vertices; this handle "
                                 f"was prepared for V={self.v}")
            with span("dnt.serve.pad"):
                if unbatched:
                    x = x[None]
                x = _pad_rows(x, -2, self.bucket - self.v)
            with span("dnt.serve.program"):
                out = sm._run(self.bucket, x, *self._batched(x.shape[0]))
            with span("dnt.serve.finish"):
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
    traced on another device (the CPU, another card) is moved there
    (`_load_program`)."""
    manifest, params = _read_manifest_params(artifact_dir)
    kind = manifest.get("kind", "forward")
    if kind != "forward":
        raise ValueError(f"artifact kind={kind!r}; use "
                         "load_sharded_serving_model for sharded artifacts")
    dev = _device(device)
    programs = {int(v): _load_program(artifact_dir, f"bucket_{v}.pt2", dev)
                for v in manifest["v_buckets"]}
    return ServingModel(manifest, params, programs, dev)


def _traced_device(program) -> torch.device | None:
    """The device a program was traced on: its first tensor input's."""
    for node in program.graph.nodes:
        val = node.meta.get("val") if node.op == "placeholder" else None
        if isinstance(val, torch.Tensor):
            return val.device
    return None


def _load_program(artifact_dir: str, name: str, dev):
    """An ExportedProgram on `dev`. A program traced on another device (the
    CPU, or another card: its graph asserts each input's device) is moved
    with torch.export.passes.move_to_device_pass; a failure there raises."""
    program = torch.export.load(os.path.join(artifact_dir, name))
    if _traced_device(program) != dev:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
    return program


class ShardedServingModel:
    """A loaded vertex-sharded artifact on one rank: serves ONE large
    surface with the other ranks of its `vert` group, each running the
    same program on its rows.

    call(x, mass, evals, evecs, gradX_spec, gradY_spec), unbatched (V, ...)
    inputs, the whole surface on every rank (arrays or tensors): V is
    padded to the exported bucket, each rank moves its rows to its card,
    and every rank returns the whole output (vertex outputs gathered from
    the ranks and sliced back to V; global_mean (c_out,)), on its card."""

    def __init__(self, manifest: dict, params: dict, program, device,
                 group=None):
        self.manifest = manifest
        self.device = torch.device(device)
        self.group = group
        self.params = _params_tree(_flatten_params(params), self.device)
        self.program = program
        self._fn = program.module()
        self.rows = manifest["v_bucket"] // manifest["n_devices"]
        self.rank = dist.get_rank(group)
        from ..parallel.mesh import _AllGather
        self._gather = _AllGather.apply

    def _local(self, a, v: int) -> torch.Tensor:
        """This rank's rows of a whole-surface (v, ...) array, padded to the
        bucket, f32 on the card (only the rank's rows are moved)."""
        a = torch.as_tensor(a, dtype=torch.float32)
        a = _pad_rows(a, 0, self.manifest["v_bucket"] - v)
        return a.narrow(0, self.rank * self.rows, self.rows).to(
            self.device).contiguous()

    def _check_x(self, x):
        if x.ndim != 2:
            raise ValueError("sharded serving takes ONE surface: x (V, c_in)")
        if x.shape[-1] != self.manifest["c_in"]:
            raise ValueError(f"x has {x.shape[-1]} channels; artifact "
                             f"expects c_in={self.manifest['c_in']}")

    def _normalize(self, mass, evals, evecs, gX, gY):
        """Validate, K-truncate, pad and keep this rank's rows; returns
        (mass, evals, evecs, gX, gY) on the card and the true V."""
        m = self.manifest
        k = np.shape(evals)[-1]
        if k < m["k_eig"]:
            raise ValueError(f"operators have K={k} < artifact k_eig="
                             f"{m['k_eig']}; recompute with larger k_eig")
        kk = m["k_eig"]
        v, bucket = np.shape(evecs)[0], m["v_bucket"]
        if v > bucket:
            raise ValueError(f"surface has {v} vertices > exported bucket "
                             f"{bucket}; re-export with a larger bucket")
        evals = torch.as_tensor(evals, dtype=torch.float32,
                                device=self.device)[:kk].contiguous()
        return (self._local(mass, v), evals,
                *(self._local(a[:, :kk], v) for a in (evecs, gX, gY))), v

    def _run(self, x, ops, v: int):
        with torch.no_grad():
            out = self._fn(self.params, x, *ops)
            if self.manifest["outputs_at"] == "vertices":
                out = self._gather(out, 0, self.group)[:v]
        return out

    def __call__(self, x, mass, evals, evecs, gradX_spec, gradY_spec):
        self._check_x(torch.as_tensor(x))
        ops, v = self._normalize(mass, evals, evecs, gradX_spec, gradY_spec)
        if np.shape(x)[0] != v:
            raise ValueError(f"x has {np.shape(x)[0]} vertices; the "
                             f"operators have V={v}")
        return self._run(self._local(x, v), ops, v)

    def prepare(self, mass, evals, evecs, gradX_spec,
                gradY_spec) -> "PreparedSurface":
        """Pad the surface's operators and move this rank's rows to its
        card ONCE; returns a PreparedSurface whose `handle(x)` ships only
        the signal."""
        ops, v = self._normalize(mass, evals, evecs, gradX_spec, gradY_spec)
        return PreparedSurface(self, v, ops)

    def prepare_operators(self, ops) -> "PreparedSurface":
        """prepare() from a geometry.Operators bundle (needs ops.gradX_spec)."""
        if ops.gradX_spec is None:
            raise ValueError("Operators bundle lacks spectral gradient "
                             "operators (computed by compute_operators)")
        return self.prepare(ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
                            ops.gradY_spec)

    def call_operators(self, x, ops):
        """Forward from a geometry.Operators bundle (needs ops.gradX_spec)."""
        if ops.gradX_spec is None:
            raise ValueError("Operators bundle lacks spectral gradient "
                             "operators (computed by compute_operators)")
        return self(x, ops.mass, ops.evals, ops.evecs, ops.gradX_spec,
                    ops.gradY_spec)


class PreparedSurface:
    """Device-resident sharded-serving handle: this rank's padded operator
    rows live on its card; each call ships only x (V, c_in), of which the
    rank moves its rows."""

    def __init__(self, ssm: ShardedServingModel, v: int, ops):
        self._ssm = ssm
        self.v = v
        self._ops = ops  # (mass, evals, evecs, gX, gY): this rank's rows

    def __call__(self, x):
        ssm = self._ssm
        ssm._check_x(torch.as_tensor(x))
        if x.shape[0] != self.v:
            raise ValueError(f"x has {x.shape[0]} vertices; this handle was "
                             f"prepared for V={self.v}")
        return ssm._run(ssm._local(x, self.v), self._ops, self.v)


def load_sharded_serving_model(artifact_dir: str, mesh=None,
                               device=None) -> ShardedServingModel:
    """Load an artifact written by export_sharded_forward on this rank,
    after torch.distributed is initialized (`parallel.initialize`): every
    rank of the group calls it. mesh: a DeviceMesh whose `vert` axis is the
    group to serve over (default: the whole world); its size must be the
    artifact's n_devices. The group is registered for dnt_torch::vert_sum.
    device: this rank's card (default cuda:LOCAL_RANK); "cpu" on the CPU.
    Needs the port's parallel package besides the kernel ops (the caller
    has initialized torch.distributed through it)."""
    manifest, params = _read_manifest_params(artifact_dir)
    kind = manifest.get("kind", "forward")
    if kind != "sharded_forward":
        raise ValueError(f"artifact kind={kind!r}; use load_serving_model "
                         "for bucketed single-device artifacts")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "diffusionnet_tpu_torch.parallel.initialize() on "
                           "every rank first")
    group = None if mesh is None else mesh.get_group("vert")
    n = dist.get_world_size(group)
    if n != manifest["n_devices"]:
        raise ValueError(f"artifact was exported for "
                         f"{manifest['n_devices']} devices; the vert group "
                         f"has {n}")
    from ..parallel.distributed import rank_device
    dev = _device(rank_device(device))
    _collectives.register_group("vert", group)
    program = _load_program(
        artifact_dir,
        f"sharded_{manifest['v_bucket']}x{manifest['n_devices']}.pt2", dev)
    return ShardedServingModel(manifest, params, program, dev, group)
