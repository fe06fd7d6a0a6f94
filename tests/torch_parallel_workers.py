"""The ranks of the port's parallel tests: module-level functions that
`diffusionnet_tpu_torch.parallel.launch` runs in spawned CPU processes over
gloo. This module imports torch, numpy and the port only (a spawned rank
imports it; jax stays in the pytest process). Each rank reads its inputs
from an npz that the test wrote and returns its results as arrays."""

from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np
import torch

from diffusionnet_tpu_torch.data import PaddedBatch, SurfaceDataset
from diffusionnet_tpu_torch.geometry import Operators
from diffusionnet_tpu_torch.models import DiffusionNet, module_state
from diffusionnet_tpu_torch.models import fast_path
from diffusionnet_tpu_torch.ops.megablock import keep_mask
from diffusionnet_tpu_torch.ops.sparse import Ell
from diffusionnet_tpu_torch.parallel import (
    VertexGroup, make_dp_eval_step, make_dp_train_step, make_mesh,
    make_pod_mesh, make_two_axis_train_step, shard_batch,
    vertex_sharded_forward, vertex_sharded_megakernel_forward,
    vertex_sharding)
from diffusionnet_tpu_torch.parallel.mesh import all_reduce_
from diffusionnet_tpu_torch.training import (TaskConfig, adam_state_from_flat,
                                             adam_state_to_flat,
                                             adam_with_step_decay, task)
from tests.meshgen import icosphere, torus

OPS_FIELDS = ("frames", "mass", "evals", "evecs")


# ---------------------------------------------------------------------------
# npz layout of an Operators bundle and a flat train state
# ---------------------------------------------------------------------------

def save_ops(d: dict, prefix: str, ops) -> None:
    """Operators-like bundle (either package's; numpy) -> npz entries."""
    for f in OPS_FIELDS:
        d[prefix + f] = np.asarray(getattr(ops, f))
    for f in ("L", "gradX", "gradY"):
        e = getattr(ops, f)
        d[prefix + f + "/idx"] = np.asarray(e.idx)
        d[prefix + f + "/val"] = np.asarray(e.val)
    if ops.gradX_spec is not None:
        d[prefix + "gradX_spec"] = np.asarray(ops.gradX_spec)
        d[prefix + "gradY_spec"] = np.asarray(ops.gradY_spec)


def load_ops(z: dict, prefix: str, spectral: bool = True) -> Operators:
    def ell(f):
        return Ell(z[prefix + f + "/idx"], z[prefix + f + "/val"])
    spec = spectral and prefix + "gradX_spec" in z
    return Operators(
        **{f: z[prefix + f] for f in OPS_FIELDS}, L=ell("L"),
        gradX=ell("gradX"), gradY=ell("gradY"),
        gradX_spec=z[prefix + "gradX_spec"] if spec else None,
        gradY_spec=z[prefix + "gradY_spec"] if spec else None)


def load_params(z: dict, prefix: str, grad: bool = True) -> dict:
    return {k[len(prefix):]: torch.tensor(v).requires_grad_(grad)
            for k, v in z.items() if k.startswith(prefix)}


def load_adam(z: dict, prefix: str, params: dict, lr: float):
    """Adam (no decay) over params, its state loaded from the npz entries
    (count, mu/<key>, nu/<key>; `adam_state_to_flat`'s layout)."""
    adam = adam_with_step_decay(lr)
    flat = {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}
    return adam, adam_state_from_flat(adam.init(params), flat)


def save_tensors(d: dict, prefix: str, tensors: dict) -> None:
    for k, v in tensors.items():
        d[prefix + k] = (v.detach().numpy() if isinstance(v, torch.Tensor)
                         else np.asarray(v))


def padded_batch(z: dict, prefix: str, spectral: bool = True) -> PaddedBatch:
    B = z[prefix + "x"].shape[0]
    return PaddedBatch(verts=z[prefix + "x"],
                       ops=load_ops(z, prefix + "ops/", spectral),
                       labels=z[prefix + "labels"],
                       faces=z.get(prefix + "faces",
                                   np.zeros((B, 4, 3), np.int32)),
                       face_mask=np.zeros((B, 4), bool))


def log_softmax(x):
    return torch.log_softmax(x, -1)


def mega_sums(params, b, n_block, vert=None):
    """(loss_sum, correct, total) of the megakernel path's per-vertex NLL,
    as the JAX package's parallel tests sum them."""
    logits = fast_path.megablock_apply(
        params, b.verts, b.ops.mass, b.ops.evals, b.ops.evecs,
        b.ops.gradX_spec, b.ops.gradY_spec, n_block=n_block, tile_v=128,
        xhat_reduce=None if vert is None else vert.sum)
    preds = log_softmax(logits)
    lbl = b.labels.long()
    valid = lbl >= 0
    per = -torch.gather(preds, -1, lbl.clamp(min=0)[..., None])[..., 0]
    return ((per * valid).sum(), ((preds.argmax(-1) == lbl) & valid).sum(),
            valid.sum())


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py: one world of 4 ranks
# ---------------------------------------------------------------------------

def _dp(z, out):
    """make_dp_train_step and make_dp_eval_step on data = 4: the JAX
    package's data-parallel test model (global mean, ELL gradients)."""
    mesh = make_mesh(data=4, vert=1)
    model = DiffusionNet(c_in=3, c_out=2, c_width=8, n_block=1,
                         dropout=False, outputs_at="global_mean",
                         last_activation=log_softmax)
    params = load_params(z, "dp/params/")
    adam, state = load_adam(z, "dp/adam0/", params, 1e-2)
    batch = shard_batch(padded_batch(z, "dp/", spectral=False), mesh,
                        "global").to("cpu")

    def fwd(params, b):
        o = b.ops
        return torch.func.functional_call(
            model, module_state(params), (b.verts, o.mass),
            dict(L=o.L, evals=o.evals, evecs=o.evecs, gradX=o.gradX,
                 gradY=o.gradY))

    def loss_fn(params, b, gen):
        logp = fwd(params, b)
        return -torch.gather(logp, -1, b.labels.long()[:, None]).mean()

    _, _, loss = make_dp_train_step(loss_fn, adam, mesh)(params, state,
                                                         batch)
    out["dp/loss"] = float(loss)
    save_tensors(out, "dp/param/", params)
    save_tensors(out, "dp/adam/", adam_state_to_flat(state))

    def metric_fn(params, b):
        pred = fwd(params, b).argmax(-1)
        return {"correct": (pred == b.labels.long()).sum(),
                "total": b.labels.shape[0]}
    m = make_dp_eval_step(metric_fn, mesh)(params, batch)
    out["dp/correct"], out["dp/total"] = int(m["correct"]), int(m["total"])


def _mega_forward(z, out):
    """vertex_sharded_megakernel_forward at vert = 4 (mesh (1, 4)) and
    vert = 2 (mesh (2, 2))."""
    params = load_params(z, "mf/params/", grad=False)
    ops = load_ops(z, "mf/ops/")
    for vert in (4, 2):
        mesh = make_mesh(vert=vert)
        y = vertex_sharded_megakernel_forward(params, z["mf/x"], ops, mesh,
                                              n_block=2, tile_v=64)
        out[f"mf/vert{vert}"] = y.detach().numpy()


def _sharded_forward(z, out):
    """vertex_sharded_forward on mesh (1, 4): the dense-spectral, ELL and
    implicit_dense routes at vertex outputs, face outputs, the ELL route's
    global mean, and the fused route (B4 on each rank's 64 rows); and the
    gradient of a weighted sum of the ELL and fused routes' outputs (each
    rank's rows, the gradients summed over the ranks)."""
    mesh = make_mesh(vert=4)
    x = z["sf/x"]
    w = vertex_sharding(mesh, torch.from_numpy(z["sf/weights"]))
    kw = dict(c_in=3, c_out=4, c_width=16, n_block=2, dropout=False)
    for route, spectral, outputs_at, method, fused in (
            ("dense", True, "vertices", "spectral", False),
            ("ell", False, "vertices", "spectral", False),
            ("faces", True, "faces", "spectral", False),
            ("ell_mean", False, "global_mean", "spectral", False),
            ("implicit", False, "vertices", "implicit_dense", False),
            ("fused", True, "vertices", "spectral", True)):
        model = DiffusionNet(**kw, outputs_at=outputs_at,
                             diffusion_method=method,
                             use_pallas_fused=fused, pallas_tile_v=64)
        key = "implicit" if method == "implicit_dense" else outputs_at
        grad = route in ("ell", "fused")
        params = load_params(z, f"sf/{key}/params/", grad=grad)
        extra = ({"faces": torch.from_numpy(z["sf/faces"])}
                 if outputs_at == "faces" else {})
        with torch.set_grad_enabled(grad):
            y = vertex_sharded_forward(model, params, x,
                                       load_ops(z, "sf/ops/", spectral),
                                       mesh, **extra)
        out[f"sf/{route}"] = y.detach().numpy()
        if grad:
            (y * w).sum().backward()
            for k, p in params.items():
                out[f"sf/{route}_grad/" + k] = all_reduce_(p.grad).numpy()


def _two_axis(z, out):
    """make_two_axis_train_step on (data 2, vert 2): the loss, every
    gradient, the parameters and Adam's state after one step."""
    mesh = make_mesh(data=2, vert=2)
    vert = VertexGroup(mesh)
    params = load_params(z, "ta/params/")
    adam, state = load_adam(z, "ta/adam0/", params, 1e-2)
    batch = shard_batch(padded_batch(z, "ta/"), mesh).to("cpu")

    def sum_loss(params, b, gen):
        S, C, N = mega_sums(params, b, 2, vert)
        return S, N, (C, N)
    _, _, loss, (c, t) = make_two_axis_train_step(sum_loss, adam, mesh)(
        params, state, batch, torch.Generator().manual_seed(1))
    out["ta/loss"], out["ta/correct"], out["ta/total"] = (float(loss),
                                                          int(c), int(t))
    save_tensors(out, "ta/grad/", {k: p.grad for k, p in params.items()})
    save_tensors(out, "ta/param/", params)
    save_tensors(out, "ta/adam/", adam_state_to_flat(state))


def fused_vertex_model():
    """The (data, vert) step's model on the eager fused route: B4 at
    pallas_tile_v 64 (128 rows a shard at vert 2, 256 on one process)."""
    return DiffusionNet(c_in=3, c_out=2, c_width=8, n_block=2, dropout=False,
                        use_pallas_fused=True, pallas_tile_v=64,
                        last_activation=log_softmax)


FUSED_TASK = TaskConfig(input_features="xyz", labels_kind="vertex",
                        use_megakernel=False)


def _two_axis_fused(z, out):
    """make_two_axis_train_step on (data 2, vert 2) of the fused model
    through training.apply_model (B4 on each shard's rows, x_hat and its
    cotangent summed over vert): the loss, every gradient, the parameters
    and Adam's state after one step."""
    mesh = make_mesh(data=2, vert=2)
    vert = VertexGroup(mesh)
    model = fused_vertex_model()
    params = load_params(z, "ta/params/")
    adam, state = load_adam(z, "ta/adam0/", params, 1e-2)
    batch = shard_batch(padded_batch(z, "ta/"), mesh).to("cpu")

    def sum_loss(params, b, gen):
        preds = task.apply_model(model, params, b, gen, FUSED_TASK, True,
                                 vert)
        S, C, N = task.loss_sums(preds, b, FUSED_TASK)
        return S, N, (C, N)
    _, _, loss, (c, t) = make_two_axis_train_step(sum_loss, adam, mesh)(
        params, state, batch, torch.Generator().manual_seed(1))
    out["taf/loss"], out["taf/correct"], out["taf/total"] = (float(loss),
                                                             int(c), int(t))
    save_tensors(out, "taf/grad/", {k: p.grad for k, p in params.items()})
    save_tensors(out, "taf/param/", params)
    save_tensors(out, "taf/adam/", adam_state_to_flat(state))


def _dropout_rule(z, out):
    """One two-axis step of a megakernel model with dropout and rotations
    on: the uniforms each rank's rotations came from and the dropout seeds
    of its blocks, with the keep mask of block 0's first dropout layer on
    the shard's first tile."""
    mesh = make_mesh(data=2, vert=2)
    vert = VertexGroup(mesh)
    model = DiffusionNet(c_in=3, c_out=2, c_width=8, n_block=2, dropout=True)
    cfg = TaskConfig(input_features="xyz", labels_kind="vertex",
                     use_megakernel=True, augment_rotate=True)
    params = load_params(z, "ta/params/")
    adam = adam_with_step_decay(1e-2)
    batch = shard_batch(padded_batch(z, "ta/"), mesh).to("cpu")
    uniforms, seeds = [], []
    rot, chained = task.rotation_from_uniforms, fast_path.megablock_chained

    def record_u(u):
        uniforms.append(u.clone())
        return rot(u)

    def record_seed(*a, seed=None, **kw):
        seeds.append(seed)
        return chained(*a, seed=seed, **kw)

    def sum_loss(params, b, gen):
        preds = task.apply_model(model, params, b, gen, cfg, False, vert)
        S, C, N = task.loss_sums(preds, b, cfg)
        return S, N, (C, N)
    task.rotation_from_uniforms = record_u
    fast_path.megablock_chained = record_seed
    try:
        make_two_axis_train_step(sum_loss, adam, mesh)(
            params, adam.init(params), batch,
            torch.Generator().manual_seed(1234))
    finally:
        task.rotation_from_uniforms = rot
        fast_path.megablock_chained = chained
    out["dr/uniforms"] = torch.cat(uniforms).numpy()
    out["dr/seeds"] = np.asarray(seeds, np.int64)
    out["dr/mask"] = keep_mask((128, 8), seeds[0], 0, 0, 1).numpy()


def _mesh_refusals(out):
    for name, fn in (("make_mesh", lambda: make_mesh(data=3, vert=2)),
                     ("pod_divisible", lambda: make_pod_mesh(vert=3))):
        try:
            fn()
            out["refuse/" + name] = ""
        except ValueError as e:
            out["refuse/" + name] = str(e)
    old = os.environ.get("LOCAL_WORLD_SIZE")
    os.environ["LOCAL_WORLD_SIZE"] = "3"   # vert 2 would straddle nodes
    try:
        make_pod_mesh(vert=2)
        out["refuse/pod_straddle"] = ""
    except ValueError as e:
        out["refuse/pod_straddle"] = str(e)
    finally:
        if old is None:
            del os.environ["LOCAL_WORLD_SIZE"]
        else:
            os.environ["LOCAL_WORLD_SIZE"] = old


def parallel_rank(rank: int, world: int, inputs: str) -> dict:
    torch.set_float32_matmul_precision("highest")
    z = dict(np.load(inputs))
    out: dict = {}
    _dp(z, out)
    _mega_forward(z, out)
    _sharded_forward(z, out)
    _two_axis(z, out)
    _two_axis_fused(z, out)
    _dropout_rule(z, out)
    _mesh_refusals(out)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_fit.py: fit over 4 ranks
# ---------------------------------------------------------------------------

def global_dataset(cache: str) -> SurfaceDataset:
    """The JAX package's data-parallel fit dataset: 8 jittered icospheres
    (class 0) and 8 tori (class 1), k 8."""
    rs = np.random.RandomState(0)
    ds = SurfaceDataset(labels_kind="global")
    for cls in range(2):
        for _ in range(8):
            v, f = (icosphere(subdivisions=1) if cls == 0
                    else torus(n_major=8, n_minor=6))
            ds.add(v * (1 + 0.05 * rs.randn(*v.shape)), f, cls)
    ds.precompute(k_eig=8, op_cache_dir=cache, verbose=False,
                  eigensolver="host", device="cpu")
    return ds


def vertex_dataset(cache: str) -> SurfaceDataset:
    """The JAX package's two-axis fit dataset: 4 jittered icospheres(2),
    hemisphere labels, k 16."""
    rs = np.random.RandomState(0)
    ds = SurfaceDataset(labels_kind="vertex")
    for _ in range(4):
        v, f = icosphere(subdivisions=2)
        v = v * (1 + 0.03 * rs.randn(*v.shape))
        ds.add(v, f, (v[:, 2] > 0).astype(np.int32))
    ds.precompute(k_eig=16, op_cache_dir=cache, verbose=False,
                  eigensolver="host", device="cpu")
    return ds


def global_model(dropout=False):
    from diffusionnet_tpu_torch.experiments.exp_common import build_model
    return build_model(n_class=2, c_width=16, outputs_at="global_mean",
                       dropout=dropout, input_features="xyz", n_block=1)


def vertex_model(dropout=False):
    from diffusionnet_tpu_torch.experiments.exp_common import build_model
    return build_model(n_class=2, c_width=16, outputs_at="vertices",
                       dropout=dropout, input_features="xyz", n_block=1)


def dp_config(**kw):
    from diffusionnet_tpu_torch.experiments.exp_common import FitConfig
    return FitConfig(**{**dict(n_epoch=8, lr=1e-2, batch_size=8,
                               input_features="xyz", labels_kind="global",
                               data_parallel=True), **kw})


def two_axis_config(**kw):
    from diffusionnet_tpu_torch.experiments.exp_common import FitConfig
    return FitConfig(**{**dict(n_epoch=6, lr=5e-3, batch_size=2,
                               input_features="xyz", labels_kind="vertex",
                               use_megakernel=True, buckets=(200,),
                               mesh_shape=(2, 2)), **kw})


def _run_fit(out, name, model, train, cfg, workdir, **kw):
    from diffusionnet_tpu_torch.experiments.exp_common import fit
    from diffusionnet_tpu_torch.parallel.distributed import params_hash
    save = os.path.join(workdir, name)
    params, hist, evaluate = fit(model, train, train, cfg,
                                 model_save_path=save,
                                 log_path=save + ".jsonl", verbose=False,
                                 device="cpu", **kw)
    out[name + "/history"] = np.asarray(
        [(e, a, -1.0 if t is None else t) for e, a, t in hist])
    out[name + "/hash"] = params_hash(params)
    save_tensors(out, name + "/param/", params)
    return evaluate, params


def fit_rank(rank: int, world: int, cache: str, workdir: str) -> dict:
    torch.set_float32_matmul_precision("highest")
    gds, vds = global_dataset(cache), vertex_dataset(cache)
    out: dict = {}
    # data parallelism: learns, with and without device_data; the history
    # of the run without dropout is held to one process's
    _run_fit(out, "dp", global_model(), gds, dp_config(), workdir)
    _run_fit(out, "dp_device", global_model(), gds,
             dp_config(device_data=True), workdir)
    # a (4, 1) mesh_shape is data parallelism: its batch check fires
    try:
        _run_fit(out, "dp_mesh", global_model(), gds,
                 dp_config(data_parallel=False, mesh_shape=(4, 1),
                           batch_size=6), workdir)
    except ValueError as e:
        out["dp_mesh/error"] = str(e)
    # (data 2, vert 2): learns; held to one process's run
    evaluate, params = _run_fit(out, "ta", vertex_model(), vds,
                                two_axis_config(), workdir)
    out["ta/evaluate"] = evaluate(params, vds)
    # stopped after epoch 0 and resumed: bit-identical to the uninterrupted
    # run, dropout and rotations on, on both routes
    for name, model, ds, cfg in (
            ("ta_drop", vertex_model(True), vds,
             two_axis_config(n_epoch=2, augment_rotate=True)),
            ("dp_drop", global_model(True), gds,
             dp_config(n_epoch=2, augment_rotate=True))):
        _run_fit(out, name + "_whole", model, ds, cfg, workdir)
        _run_fit(out, name + "_first", model, ds,
                 dataclasses.replace(cfg, n_epoch=1), workdir)
        _run_fit(out, name + "_resumed", model, ds, cfg, workdir,
                 resume_from=os.path.join(workdir, name + "_first_ckpt"))
    # SIGTERM reaching rank 1 alone during epoch 0 stops every rank there

    def sigterm_rank1(params, predict):
        if rank == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return 0.0
    _run_fit(out, "stop", vertex_model(), vds,
             two_axis_config(n_epoch=3, graceful_sigterm=True), workdir,
             geodesic_eval=sigterm_rank1)
    return out


def rna_rank(rank: int, world: int, argv: list) -> dict:
    """The RNA driver with --mesh in a world that launch() initialized."""
    from diffusionnet_tpu_torch.experiments.rna_mesh_segmentation import (
        rna_mesh_segmentation)
    res = rna_mesh_segmentation.main(argv)
    return {"test_acc": res["test_acc"],
            "history": np.asarray([(e, a, -1.0 if t is None else t)
                                   for e, a, t in res["history"]])}

