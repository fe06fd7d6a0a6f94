"""Process groups across cards and hosts. The counterpart of
diffusionnet_tpu/parallel/distributed.py.

One process drives one card. `initialize()` joins the processes into a
torch.distributed world (from its arguments, or from the environment that
`torchrun` sets), `make_pod_mesh` lays a (data, vert) mesh over it with
each `vert` group inside one node, and `launch` starts a world of local
processes (spawned, joined through a file:// rendezvous) for tests and
single-host runs. `run_multiprocess_dryrun` proves the paths whose
collectives cross process boundaries: a data-parallel step, a (data, vert)
step with `vert` spanning processes, and the host-sharded precompute into
one shared cache.

Launch sharded training on one node with

    torchrun --nproc_per_node=DATA*VERT -m <driver module> ... --mesh DATA,VERT
"""

from __future__ import annotations

import datetime
import hashlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               timeout_s: float | None = None) -> None:
    """Join this process to the world: init_process_group from the
    arguments, else from torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK; LOCAL_RANK picks the card). backend: 'nccl' where a
    card is visible, else 'gloo'. A no-op when already initialized, and in
    a single process with nothing to coordinate. A failure with an explicit
    init_method, or with a world of several, raises: going on would train N
    independent copies that diverge without an error."""
    if dist.is_initialized():
        print("torch.distributed already initialized; skipping")
        return
    env = os.environ
    explicit = init_method is not None
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is None:
        if world_size in (None, 1):
            print("torch.distributed initialize skipped: one process, "
                  "nothing to coordinate")
            return
        raise ValueError(f"world_size={world_size} needs an init_method or "
                         "torchrun's MASTER_ADDR/MASTER_PORT")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", (rank or 0)
                            % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    try:
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank, **kw)
    except (RuntimeError, ValueError) as e:
        if explicit or world_size not in (None, 1):
            raise
        print(f"torch.distributed initialize skipped: {e}")


def rank_device(device=None) -> torch.device:
    """`device`, or this rank's card: cuda:LOCAL_RANK (torchrun sets
    LOCAL_RANK; 0 without it). Raises when torch sees no such card."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA card cuda:{local} is visible to torch; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda", local)


def make_pod_mesh(vert: int = 1):
    """A (data, vert) mesh over the whole world with each `vert` group on
    consecutive ranks of one node (LOCAL_WORLD_SIZE ranks a node, as
    torchrun numbers them), so the per-block x_hat sums stay on the node's
    links. A vert group that would straddle nodes is refused."""
    n = dist.get_world_size()
    if n % vert != 0:
        raise ValueError(f"{n} devices not divisible by vert={vert}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if vert > 1 and local % vert != 0 and vert % local != 0:
        raise ValueError(
            f"vert={vert} does not tile the {local} devices per process "
            "group of a node; vert groups would span nodes (collectives "
            "over the network between them)")
    return make_mesh(data=n // vert, vert=vert)


# ---------------------------------------------------------------------------
# Local worlds of spawned processes
# ---------------------------------------------------------------------------

def _rank_main(rank, world_size, fn, args, backend, init_method, workdir,
               threads, timeout_s):
    """One spawned rank: join the world, run fn, save its result."""
    if threads is not None:
        torch.set_num_threads(threads)
    initialize(init_method, world_size, rank, backend, timeout_s)
    try:
        out = fn(rank, world_size, *args) or {}
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, args: tuple = (), backend: str = "gloo",
           workdir: str | None = None, timeout_s: float = 600.0,
           threads: int | None = 1) -> list[dict]:
    """Run fn(rank, world_size, *args) in world_size spawned processes
    joined into one torch.distributed world (backend; a file:// rendezvous
    under workdir, so concurrent worlds never share a port). fn is
    importable (a module-level function) and returns a dict of arrays or
    scalars, or None. Returns each rank's dict, in rank order. A rank that
    raises fails the launch (the others are stopped); so does the whole
    world outlasting timeout_s (collectives time out at the same bound).
    threads: torch's intra-op threads in each rank (None: torch's
    default)."""
    workdir = workdir or tempfile.mkdtemp(prefix="dnt_ranks_")
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "rendezvous")
    if os.path.exists(store):  # a file store must not be reused
        os.remove(store)
    for r in range(world_size):
        if os.path.exists(os.path.join(workdir, f"rank{r}.npz")):
            os.remove(os.path.join(workdir, f"rank{r}.npz"))
    ctx = torch.multiprocessing.start_processes(
        _rank_main, nprocs=world_size, join=False, start_method="spawn",
        args=(world_size, fn, args, backend, "file://" + store, workdir,
              threads, timeout_s))
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks did not finish "
                                   f"within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for r in range(world_size):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def params_hash(params: dict) -> str:
    """SHA1 of a flat train state's bits, in key order."""
    h = hashlib.sha1()
    for k in sorted(params):
        h.update(params[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _torus(n_major: int = 12, n_minor: int = 12, R=1.0, r=0.35):
    """A torus of n_major * n_minor vertices."""
    u = 2 * np.pi * np.arange(n_major)[:, None] / n_major
    v = 2 * np.pi * np.arange(n_minor)[None, :] / n_minor
    verts = np.stack(np.broadcast_arrays((R + r * np.cos(v)) * np.cos(u),
                                         (R + r * np.cos(v)) * np.sin(u),
                                         r * np.sin(v)), -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    a = i * n_minor + j
    b = (i + 1) % n_major * n_minor + j
    c = (i + 1) % n_major * n_minor + (j + 1) % n_minor
    d = i * n_minor + (j + 1) % n_minor
    faces = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)],
                     2).reshape(-1, 3)
    return verts, faces


def _two_axis_step(world_size: int) -> dict:
    """One (data = world / 2, vert = 2) megakernel train step whose vert
    collectives cross the process boundary (ranks 2d and 2d + 1 are one
    surface's shards, each holding real vertices of the 144-vertex torus),
    against the single-process step on the whole batch computed here.
    Returns the parameters' hash, the largest gradient error relative to
    the largest gradient, and the loss."""
    from ..data.dataset import PaddedBatch
    from ..geometry import compute_operators, stack_operators
    from ..models import DiffusionNet, flat_params
    from ..models.fast_path import megablock_apply
    from ..training import adam_with_step_decay, make_train_step
    from .mesh import VertexGroup
    from .vertex_sharded import make_two_axis_train_step, shard_batch

    mesh = make_mesh(vert=2)
    data, vert = mesh.shape
    verts, faces = _torus()
    n = len(verts)
    ops1 = compute_operators(verts, faces, k_eig=8, eigensolver="host",
                             device="cpu")
    B, v_pad = 2 * data, 128 * vert            # one 128-row tile a shard
    ops = stack_operators([ops1] * B, v_pad=v_pad)
    x = np.zeros((B, v_pad, 3), np.float32)
    x[:, :n] = verts
    labels = np.full((B, v_pad), -1, np.int32)
    labels[:, :n] = (verts[:, 2] > 0).astype(np.int32)
    batch = PaddedBatch(verts=x, ops=ops, labels=labels,
                        faces=np.zeros((B, 4, 3), np.int32),
                        face_mask=np.zeros((B, 4), bool))
    model = DiffusionNet(c_in=3, c_out=2, c_width=8, n_block=1,
                         dropout=False)

    def sums(params, b, vg):
        logits = megablock_apply(
            params, b.verts, b.ops.mass, b.ops.evals, b.ops.evecs,
            b.ops.gradX_spec, b.ops.gradY_spec, n_block=1, tile_v=128,
            xhat_reduce=None if vg is None else vg.sum)
        preds = torch.log_softmax(logits, -1)
        lbl = b.labels.long()
        valid = lbl >= 0
        per = -torch.gather(preds, -1, lbl.clamp(min=0)[..., None])[..., 0]
        return (per * valid).sum(), valid.sum()

    adam = adam_with_step_decay(1e-2)

    def state():
        params = flat_params(model, "cpu", requires_grad=True)
        return params, adam.init(params)

    p_sd, o_sd = state()

    def sd_loss(params, b, gen):
        S, N = sums(params, b, None)
        return S / N.clamp(min=1), N
    make_train_step(sd_loss, adam)(p_sd, o_sd, batch.to("cpu"))

    vg = VertexGroup(mesh)
    p_vs, o_vs = state()

    def vs_loss(params, b, gen):
        S, N = sums(params, b, vg)
        return S, N, N
    _, _, loss, _ = make_two_axis_train_step(vs_loss, adam, mesh)(
        p_vs, o_vs, shard_batch(batch, mesh).to("cpu"))
    scale = max(float(p.grad.abs().max()) for p in p_sd.values())
    err = max(float((p_vs[k].grad - p_sd[k].grad).abs().max()) for k in p_sd)
    rel = err / max(scale, 1e-30)
    if rel > 1e-3:
        raise RuntimeError(f"two-axis cross-process step diverged from the "
                           f"single-process step: max rel err {rel:.3e}")
    return {"param_hash": params_hash(p_vs), "vs_single_max_rel_err": rel,
            "mesh_shape": (data, vert), "loss": float(loss)}


def _tiny_mesh(i):
    t = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    ring = np.stack([np.cos(t), np.sin(t), np.zeros(8)], 1)
    verts = np.concatenate([[[0.0, 0.0, 0.2 + 0.01 * i]], ring])
    faces = np.array([[0, 1 + j, 1 + (j + 1) % 8] for j in range(8)])
    return verts, faces


def _dryrun_rank(rank: int, world_size: int, cache_dir: str) -> dict:
    """One rank of run_multiprocess_dryrun."""
    from ..geometry import get_operators
    from ..geometry.parallel_precompute import precompute_shard_for_host
    from ..training import adam_with_step_decay
    from .data_parallel import make_dp_train_step
    from .mesh import data_parallel_sharding

    # (a) one data-parallel step over every process
    mesh = make_mesh(vert=1)
    rs = np.random.RandomState(0)               # the same data in every rank
    X = torch.from_numpy(rs.randn(2 * world_size, 8).astype(np.float32))
    y = torch.from_numpy(rs.randn(2 * world_size, 1).astype(np.float32))
    params = {"w": torch.zeros(8, 1, requires_grad=True),
              "b": torch.zeros(1, requires_grad=True)}
    adam = adam_with_step_decay(1e-1)
    opt_state = adam.init(params)

    def loss_fn(p, batch, gen):
        Xb, yb = batch
        return ((Xb @ p["w"] + p["b"] - yb) ** 2).mean()
    _, _, loss = make_dp_train_step(loss_fn, adam, mesh)(
        params, opt_state, (data_parallel_sharding(mesh, X),
                            data_parallel_sharding(mesh, y)))
    report = {"process_id": rank, "process_count": dist.get_world_size(),
              "loss": float(loss), "param_hash": params_hash(params)}

    # (b) the two-axis step, vert across processes
    if world_size % 2 == 0:
        for k, v in _two_axis_step(world_size).items():
            report["two_axis/" + k] = v

    # (c) this rank's round-robin share of 4 meshes into the shared cache;
    # after a barrier every mesh loads from it
    meshes = [_tiny_mesh(i) for i in range(4)]
    mine = precompute_shard_for_host(
        [v for v, _ in meshes], [f for _, f in meshes], k_eig=3,
        op_cache_dir=cache_dir, n_workers=1)
    dist.barrier()
    loaded = [get_operators(v, f, k_eig=3, op_cache_dir=cache_dir,
                            cache_only=True) for v, f in meshes]
    report["computed_indices"] = np.asarray(mine, np.int64)
    report["all_cached_after_barrier"] = all(o is not None for o in loaded)
    return report


def run_multiprocess_dryrun(n_processes: int = 2, timeout_s: float = 600.0,
                            workdir: str | None = None) -> list[dict]:
    """n_processes CPU ranks over gloo: a data-parallel step whose
    parameters must agree bit for bit across processes, the (data, vert)
    megakernel step with vert spanning processes against a single-process
    step (an even count), and precompute_shard_for_host into one shared
    cache that every process then reads whole. Returns the reports; raises
    if a process fails, the replicas diverge or the cache misses."""
    workdir = workdir or tempfile.mkdtemp(prefix="dnt_dryrun_")
    reports = launch(_dryrun_rank, n_processes,
                     (os.path.join(workdir, "op_cache"),), backend="gloo",
                     workdir=workdir, timeout_s=timeout_s)
    reports = [{k: (v.item() if v.ndim == 0 else v.tolist())
                for k, v in r.items()} for r in reports]
    if len({r["param_hash"] for r in reports}) != 1:
        raise RuntimeError("param replicas diverged across processes: "
                           f"{[r['param_hash'] for r in reports]}")
    covered = sorted(i for r in reports for i in r["computed_indices"])
    if covered != list(range(4)):
        raise RuntimeError(f"precompute shards did not partition the "
                           f"dataset: {covered}")
    if not all(r["all_cached_after_barrier"] for r in reports):
        raise RuntimeError("some process missed cache entries after the "
                           "barrier")
    if n_processes % 2 == 0:
        if len({r["two_axis/param_hash"] for r in reports}) != 1:
            raise RuntimeError("two-axis param replicas diverged across "
                               "processes")
    return reports
