#!/usr/bin/env python3
"""Smoke run of the port's training over several cards, one process a card
over nccl (diffusionnet_tpu_torch.parallel).

    python3 parallel_smoke.py [--ranks 4]

Needs --ranks cards (2 or 4; 4 by default). It builds the kernels,
computes the operators of phase 8's four segmentation meshes and of the
torus (`chip_smoke.py`), then starts one rank a card
(`parallel.launch`, nccl) and on each:

  1. the vertex-sharded forward of the segmentation model's blocks (vertex
     outputs, full width) on the torus at vert = ranks, B1 on each rank's
     rows with each block's x_hat all-reduced;
  2. one data-parallel step at (ranks, 1) and one two-axis step at
     (ranks / 2, 2) on the batch of 4 meshes padded to 32768 with vertex
     labels, dropout off, and one two-axis step at (1, ranks) of the same
     configuration built with use_pallas_fused (`chip_smoke.
     fused_vertex_model`: B4 on each rank's rows, x_hat's partials and
     their cotangent all-reduced over vert), each then timed over 10 more
     steps (CUDA events on every rank; the step in lockstep over the
     cards);

  3. eigensolve_device_sharded at vert = ranks on a regular torus of
     about a million vertices (SHARD_TORUS), k 128, each rank holding its
     rows of every (V, n) block and gathering the iterate over nccl;
  4. the segmentation model (vertex outputs, fused and unfused) exported
     sharded for `ranks` devices at bucket 32768 and served on the
     20,160-vertex torus, B4 on each rank's rows for the fused artifact,
     warm requests through a PreparedSurface timed (host clock);

and holds them against one process on card 0: the forward against B1 on
the whole torus (`chip_smoke.PAR_FWD_TOL`), each step's loss and
gradients against one process's step with the same objective
(`chip_smoke.step_agreement`), whose time is printed beside (the fused
step with B4's three kernels and xhat_reduce launched
`chip_smoke.PAR_B4_WANT["fused_step"]` times on every rank); the sharded
solve against the single-card solve on B5 (eigenvalues within
chip_smoke.EIG_TOL of the largest, M-orthonormal, every rank's eigenvalues
bit-equal); each sharded artifact against the single-card ServingModel
(chip_smoke.SHARD_SERVE_TOL), with 4 + 4 B4 launches (and 4 of
xhat_reduce) a request on every rank of the fused one. Then it runs
the RNA driver as a user launches it, `torchrun --nproc_per_node=RANKS -m
...rna_mesh_segmentation --megakernel --mesh RANKS/2,2`, for one epoch on
its synthetic layout. The last line is one JSON object with the results;
any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


SHARD_TORUS = (1000, 1000)      # torus(n_major, n_minor): 1,000,000 vertices


def _precise():
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _model():
    from diffusionnet_tpu_torch.models import DiffusionNet
    return DiffusionNet(**{**cs.SEG_MODEL, "outputs_at": "vertices",
                           "dropout": False},
                        generator=torch.Generator().manual_seed(21),
                        last_activation=functools.partial(torch.log_softmax,
                                                          dim=-1))


def _losses(vert=None, fused=False):
    """(mean, sums): a batch's masked-mean NLL (a data-parallel rank's loss,
    and one process's two-axis objective), and a rank's sums for the
    two-axis step, its projections summed over vert. fused: the model on
    the eager fused route (B4), else on the megakernel (B1/B2)."""
    from diffusionnet_tpu_torch.training import (
        TaskConfig, apply_model, loss_and_counts, loss_sums)
    model = cs.fused_vertex_model() if fused else _model()
    cfg = TaskConfig(input_features="hks", labels_kind="vertex",
                     use_megakernel=not fused)

    def mean(p, b, g):
        return loss_and_counts(apply_model(model, p, b, g, cfg, True), b, cfg)

    def sums(p, b, g):
        S, C, N = loss_sums(apply_model(model, p, b, g, cfg, True, vert), b,
                            cfg)
        return S, N, (C, N)
    return mean, sums


def _step_timed(out, name, make, params0, block, timed=True):
    """One step from params0 (its loss, gradients and parameters into out),
    then (timed) the ms of one step over 10 more (CUDA events, median of
    3)."""
    from diffusionnet_tpu_torch.ops import fused as fu
    from diffusionnet_tpu_torch.ops import megablock as mb
    from diffusionnet_tpu_torch.training import adam_with_step_decay
    params = {k: v.clone().requires_grad_(True) for k, v in params0.items()}
    opt = adam_with_step_decay(1e-3)
    state = opt.init(params)
    step = make(opt)
    torch.cuda.synchronize()
    mb.reset_launches()
    fu.reset_launches()
    loss = step(params, state, block, None)[2]
    out[name + "/b4"] = cs._b4_launches(mb, fu)
    out[name + "/launches"] = np.asarray(
        [mb.LAUNCHES[k] for k in cs.PAR_KERNELS])
    out[name + "/loss"] = float(loss)
    for k, p in params.items():
        out[f"{name}/grad/{k}"] = p.grad.cpu().numpy()
        out[f"{name}/param/{k}"] = p.detach().cpu().numpy()
    if not timed:
        return
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            step(params, state, block, None)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    out[name + "/ms"] = float(np.median(times))


def _rank(rank, world, inputs, arts):
    """One rank: the forward, the two steps, the sharded solve and
    artifacts (see the module docstring)."""
    import torch.distributed as dist
    from diffusionnet_tpu_torch import _build
    from diffusionnet_tpu_torch.data import PaddedBatch
    from diffusionnet_tpu_torch.parallel import (
        VertexGroup, make_dp_train_step, make_mesh, make_two_axis_train_step,
        shard_batch, vertex_sharded_megakernel_forward)
    _precise()
    _build.load()
    z = dict(np.load(inputs))
    dev = torch.device("cuda", torch.cuda.current_device())
    params0 = {k[len("params/"):]: torch.from_numpy(v).to(dev)
               for k, v in z.items() if k.startswith("params/")}
    out = {"backend": dist.get_backend(), "card": str(dev)}
    y = vertex_sharded_megakernel_forward(
        params0, z["fwd/x"], cs._bundle(z, "fwd/ops/"),
        make_mesh(vert=world), n_block=cs.N_BLOCK)
    out["fwd/y"] = y.cpu().numpy()
    batch = PaddedBatch(verts=z["b/verts"], ops=cs._bundle(z, "b/ops/"),
                        labels=z["b/labels"], faces=z["b/faces"],
                        face_mask=z["b/face_mask"])
    mesh = make_mesh(data=world, vert=1)
    mean, _ = _losses()
    _step_timed(out, "dp", lambda opt: make_dp_train_step(
        mean, opt, mesh, has_aux=True), params0,
        shard_batch(batch, mesh, "vertex").to(dev))
    mesh = make_mesh(data=world // 2, vert=2)
    _, sums = _losses(VertexGroup(mesh))
    _step_timed(out, "two_axis", lambda opt: make_two_axis_train_step(
        sums, opt, mesh), params0, shard_batch(batch, mesh, "vertex").to(dev))
    mesh = make_mesh(data=1, vert=world)
    _, fsums = _losses(VertexGroup(mesh), fused=True)
    fparams0 = {k[len("fparams/"):]: torch.from_numpy(v).to(dev)
                for k, v in z.items() if k.startswith("fparams/")}
    _step_timed(out, "fused_step", lambda opt: make_two_axis_train_step(
        fsums, opt, mesh), fparams0,
        shard_batch(batch, mesh, "vertex").to(dev))
    _sharded(out, z, arts, make_mesh(vert=world), dev)
    return out


def _sharded(out, z, arts, mesh, dev):
    """The sharded solve of the large torus, then each sharded artifact
    (name=path) serving the 20,160-vertex torus: its output, B4's launches
    of one request, 10 warm requests through a PreparedSurface."""
    from diffusionnet_tpu_torch.geometry import eigen as teig
    from diffusionnet_tpu_torch.ops import fused as fu
    from diffusionnet_tpu_torch.ops import megablock as mbk
    from diffusionnet_tpu_torch.ops.sparse import Ell
    from diffusionnet_tpu_torch.serving import load_sharded_serving_model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev, evecs = teig.eigensolve_device_sharded(
        Ell(z["eig/idx"], z["eig/val"]), z["eig/mass"], cs.K_EIG, mesh,
        device=dev)
    torch.cuda.synchronize()
    out["eig/s"] = time.perf_counter() - t0
    out["eig/sweeps"] = teig.LAST_CONVERGE_INFO["sweeps"]
    out["eig/evals"] = ev.cpu().numpy()
    out["eig/evecs"] = evecs.cpu().numpy()
    del evecs
    if mesh.get_rank() == 0:
        cs.log(f"  rank 0: sharded solve {out['eig/s']:.2f} s")
    ops = [torch.from_numpy(z["srv/" + f]).to(dev)
           for f in ("mass", "evals", "evecs", "gX", "gY")]
    x = torch.from_numpy(z["srv/x"]).to(dev)
    for item in arts:
        name, d = item.split("=", 1)
        sm = load_sharded_serving_model(d, mesh=mesh, device=dev)
        torch.cuda.synchronize()
        fu.reset_launches()
        mbk.reset_launches()
        y = sm(x, *ops)
        torch.cuda.synchronize()
        out[name + "/launches"] = np.asarray(
            [fu.LAUNCHES["spectral_project"], fu.LAUNCHES["spectral_apply"],
             mbk.LAUNCHES["xhat_reduce"]])
        out[name + "/y"] = y.cpu().numpy()
        handle = sm.prepare(*ops)
        walls = []
        for _ in range(cs.SHARD_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            handle(x)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name + "/ms"] = np.asarray(walls[2:])
        if mesh.get_rank() == 0:
            cs.log(f"  rank 0: {name} artifact served")


def _sharded_inputs(d, ds, n, tmp):
    """Phase 3's and 4's inputs into d: the large torus's ELL and mass, the
    20,160-vertex torus's operators and HKS; the sharded artifacts for n
    devices under tmp. Returns (the artifacts as name=path, what the checks
    need)."""
    from diffusionnet_tpu_torch.data.features import get_features
    from diffusionnet_tpu_torch.geometry.laplacian import (cotan_laplacian,
                                                           vertex_areas)
    from diffusionnet_tpu_torch.ops.sparse import ell_from_coo
    from diffusionnet_tpu_torch.serving import export_sharded_forward
    t0 = time.perf_counter()
    v, f = cs.meshgen().torus(n_major=SHARD_TORUS[0], n_minor=SHARD_TORUS[1])
    L = cotan_laplacian(v, f)
    m = vertex_areas(v, f)
    c = L.tocoo()
    ell = ell_from_coo(c.row, c.col, c.data, L.shape[0])
    d["eig/idx"], d["eig/val"] = ell.idx, ell.val
    d["eig/mass"] = m.astype(np.float32)
    o = ds.ops_list[0]
    x = get_features("hks", None, torch.from_numpy(o.evals).cuda(),
                     torch.from_numpy(o.evecs).cuda()).contiguous()
    d["srv/x"] = x.cpu().numpy()
    for key, a in (("mass", o.mass), ("evals", o.evals), ("evecs", o.evecs),
                   ("gX", o.gradX_spec), ("gY", o.gradY_spec)):
        d["srv/" + key] = np.ascontiguousarray(a, np.float32)
    models = {"unfused": cs.segmentation_model(outputs_at="vertices",
                                               dropout=False),
              "fused": cs.segmentation_model(outputs_at="vertices",
                                             dropout=False,
                                             use_pallas_fused=True)}
    arts = []
    for name, model in models.items():
        path = os.path.join(tmp, "sharded_" + name)
        export_sharded_forward(model, cs.SHARD_SERVE_V, path, cs.K_EIG,
                               n_devices=n, device="cuda")
        arts.append(f"{name}={path}")
    cs.log(f"  torus{SHARD_TORUS} ({L.shape[0]} vertices) Laplacian and "
           f"the sharded artifacts for {n} devices: "
           f"{time.perf_counter() - t0:.2f} s")
    return arts, dict(ell=ell, mass=m, models=models, tmp=tmp)


def _sharded_checks(ranks, shard, card):
    """The sharded solve against the single-card solve (B5) on card 0, and
    each sharded artifact against the single-card ServingModel."""
    from diffusionnet_tpu_torch.geometry import eigen as teig
    from diffusionnet_tpu_torch.serving import (export_forward,
                                                load_serving_model)
    n = len(ranks)
    V = shard["ell"].idx.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev, vec = teig.eigensolve_device(shard["ell"],
                                     shard["mass"].astype(np.float32),
                                     cs.K_EIG, device="cuda")
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_sweeps = teig.LAST_CONVERGE_INFO["sweeps"]
    r0 = ranks[0]
    cs.check(all(r["eig/evals"].tobytes() == r0["eig/evals"].tobytes()
                 for r in ranks), "the ranks' evals differ")
    ev = ev.cpu().numpy()
    err = float(np.abs(r0["eig/evals"] - ev).max() / ev.max())
    secs = [float(r["eig/s"]) for r in ranks]
    cs.log(f"  sharded solve, vert {n}, torus{SHARD_TORUS} ({V} vertices), "
           f"k {cs.K_EIG}: {secs} s on the ranks, {int(r0['eig/sweeps'])} "
           f"sweeps; single card (B5) {single_s:.2f} s, {single_sweeps} "
           f"sweeps (host clock) [{card}]; evals against the single card "
           f"{err:.3e} of the largest")
    cs.check(err <= cs.EIG_TOL, "the sharded solve disagrees with B5's")
    evecs = np.concatenate([r["eig/evecs"] for r in ranks])
    E = evecs.astype(np.float64)
    orth = float(np.abs(E.T @ (shard["mass"][:, None] * E)
                        - np.eye(E.shape[1])).max())
    cs.log(f"  M-orthonormality of the sharded basis {orth:.3e}")
    cs.check(orth <= cs.EIG_TOL, "the sharded basis is not M-orthonormal")
    del vec, evecs, E
    res = {"eig_s": secs, "eig_sweeps": int(r0["eig/sweeps"]),
           "single_s": single_s, "evals_err": err}
    z = np.load(os.path.join(shard["tmp"], "inputs.npz"))
    ops = [torch.from_numpy(z["srv/" + f]).cuda()
           for f in ("mass", "evals", "evecs", "gX", "gY")]
    x = torch.from_numpy(z["srv/x"]).cuda()
    for name, model in shard["models"].items():
        single = os.path.join(shard["tmp"], "single_" + name)
        export_forward(model, (cs.SHARD_SERVE_V,), single, cs.K_EIG,
                       device="cuda")
        with torch.no_grad():
            ref = load_serving_model(single, device="cuda")(x, *ops)
        for r, rep in enumerate(ranks):
            cs.compare(f"rank {r} {name} sharded artifact (vert "
                       f"{len(ranks)}) against the single-card ServingModel",
                       torch.from_numpy(rep[name + "/y"]).cuda(), ref,
                       cs.SHARD_SERVE_TOL, quiet=r > 0)
            want = [cs.N_BLOCK] * 3 if name == "fused" else [0, 0, 0]
            got = rep[name + "/launches"].tolist()
            cs.check(got == want, f"rank {r} {name}: B4 (project, apply) "
                     f"and xhat_reduce launches {got}")
        ms = [float(np.median(rep[name + "/ms"])) for rep in ranks]
        cs.log(f"  {name} sharded artifact, vert {len(ranks)}: B4 (project, "
               f"apply) and xhat_reduce launches a request {[rep[name + '/launches'].tolist() for rep in ranks]}"
               f"; warm request through a PreparedSurface, median of "
               f"{cs.SHARD_REQUESTS - 2}: {ms} ms on the ranks (host clock) "
               f"[{card}]")
        res[name + "_ms"] = ms
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    n = args.ranks
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"parallel_smoke: {n} CUDA cards needed, torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    if n not in (2, 4):
        print("parallel_smoke: --ranks is 2 or 4 (the batch of 4 splits "
              "over the data ranks)", file=sys.stderr)
        return 1
    from diffusionnet_tpu_torch import _build, parallel
    from diffusionnet_tpu_torch.data import make_padded_batches
    from diffusionnet_tpu_torch.experiments import layouts
    from diffusionnet_tpu_torch.experiments.rna_mesh_segmentation.\
        rna_mesh_dataset import RNAMeshDataset
    from diffusionnet_tpu_torch.geometry import pad_operators
    from diffusionnet_tpu_torch.models import flat_params, megablock_apply
    from diffusionnet_tpu_torch.ops.spectral import compute_hks_autoscale
    from diffusionnet_tpu_torch.training import make_train_step
    _precise()
    card = cs.card_line()
    cs.log(f"== {n} x {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
           f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    cs.log(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    results = {"ranks": n}
    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.segmentation_dataset(os.path.join(tmp, "cache"))
        batch = next(make_padded_batches(ds, 4)).to("cuda")
        labels = torch.where(batch.ops.mass > 0,
                             (batch.verts[..., 2] > 0).int(), -1)
        batch = batch._replace(labels=labels)
        params = flat_params(_model(), "cpu")
        d = {"params/" + k: v.numpy() for k, v in params.items()}
        fparams = flat_params(cs.fused_vertex_model(), "cpu")
        d.update({"fparams/" + k: v.numpy() for k, v in fparams.items()})
        ops = pad_operators(ds.ops_list[0], cs.PAR_TORUS_V)   # the torus
        d["fwd/x"] = compute_hks_autoscale(torch.from_numpy(ops.evals),
                                           torch.from_numpy(ops.evecs),
                                           16).numpy()
        d.update(cs._bundle_arrays("fwd/ops/", ops))
        d.update(cs._bundle_arrays("b/ops/", batch.ops))
        for f in ("verts", "labels", "faces", "face_mask"):
            d["b/" + f] = getattr(batch, f).cpu().numpy()
        arts, shard = _sharded_inputs(d, ds, n, tmp)
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **d)
        t0 = time.perf_counter()
        ranks = parallel.launch(_rank, n, (inputs, arts), backend="nccl",
                                threads=None, timeout_s=900,
                                workdir=os.path.join(tmp, "ranks"))
        cs.log(f"  {n} nccl ranks ran in {time.perf_counter() - t0:.2f} s "
               f"(start-up and kernel load included); cards "
               f"{[str(r['card']) for r in ranks]}, backend "
               f"{str(ranks[0]['backend'])}")

        # one process on card 0
        dev = torch.device("cuda", 0)
        pc = {k: v.to(dev) for k, v in params.items()}

        def b(a):
            return torch.as_tensor(a).to(dev)[None]
        single = megablock_apply(pc, b(d["fwd/x"]), b(ops.mass),
                                 b(ops.evals), b(ops.evecs),
                                 b(ops.gradX_spec), b(ops.gradY_spec),
                                 n_block=cs.N_BLOCK)[0]
        got = torch.cat([torch.from_numpy(r["fwd/y"]) for r in ranks])
        results["fwd_max_abs_err"] = cs.compare(
            f"vertex-sharded forward (vert {n}) against one process's B1",
            got.to(dev), single, cs.PAR_FWD_TOL, scaled=True)
        mean, _ = _losses()
        fmean, _ = _losses(fused=True)
        fpc = {k: v.to(dev) for k, v in fparams.items()}
        one = {}   # the whole batch's step on one card: its time
        _step_timed(one, "one", lambda opt: make_train_step(mean, opt), pc,
                    batch)
        _step_timed(one, "fused", lambda opt: make_train_step(fmean, opt),
                    fpc, batch)

        def mean_of_blocks(p, bt, g):
            # the data-parallel objective: each rank's block's mean, averaged
            k = bt.verts.shape[0] // n
            parts = [mean(p, bt.map(lambda a, i=i: a[i * k:(i + 1) * k]),
                          g)[0] for i in range(n)]
            return sum(parts) / n, None
        meshes = {"dp": (n, 1), "two_axis": (n // 2, 2),
                  "fused_step": (1, n)}
        for name, ref, p0 in (("dp", mean_of_blocks, pc),
                              ("two_axis", mean, pc),
                              ("fused_step", fmean, fpc)):
            before = {k: v.detach() for k, v in p0.items()}
            ref_out = {}
            _step_timed(ref_out, "one", lambda opt: make_train_step(ref, opt),
                        p0, batch, timed=False)
            res = {"one process": (ref_out["one/loss"],
                                   {k: torch.from_numpy(
                                       ref_out["one/grad/" + k]).to(dev)
                                    for k in p0},
                                   {k: torch.from_numpy(
                                       ref_out["one/param/" + k]).to(dev)
                                    for k in p0})}
            for r, rep in enumerate(ranks):
                res[f"rank {r}"] = (
                    float(rep[name + "/loss"]),
                    {k: torch.from_numpy(rep[f"{name}/grad/{k}"]).to(dev)
                     for k in p0},
                    {k: torch.from_numpy(rep[f"{name}/param/{k}"]).to(dev)
                     for k in p0})
            same = all(np.array_equal(rep[f"{name}/param/{k}"],
                                      ranks[0][f"{name}/param/{k}"])
                       for rep in ranks for k in p0)
            ms = [float(rep[name + "/ms"]) for rep in ranks]
            one_ms = one["fused/ms" if name == "fused_step" else "one/ms"]
            launches = dict(zip(cs.PAR_KERNELS,
                                ranks[0][name + "/launches"].tolist()))
            b4 = [dict(zip(cs.PAR_B4_KERNELS, rep[name + "/b4"].tolist()))
                  for rep in ranks]
            launches.update(b4[0])
            cs.log(f"  {name.removesuffix('_step')} step, mesh "
                   f"{meshes[name]}: loss "
                   f"{res['rank 0'][0]:.8f} (one process "
                   f"{res['one process'][0]:.8f}); the ranks' parameters "
                   f"{'bit-identical' if same else 'DIFFER'}; ms a step "
                   f"(CUDA events, median of 3 x 10) on each card {ms}, one "
                   f"process's step on the batch of 4 on one card "
                   f"{one_ms:.3f} [{card}]; rank 0's launches "
                   f"{launches}")
            cs.check(same, f"{name}: the ranks' parameters differ")
            if name == "fused_step":
                want = dict(zip(cs.PAR_B4_KERNELS,
                                cs.PAR_B4_WANT["fused_step"]))
                cs.check(all(r == want for r in b4)
                         and not launches["megablock_fwd"]
                         and not launches["megablock_bwd_rows"],
                         f"fused step: B4 and xhat_reduce launches {b4} != "
                         f"{want} on every rank, or B1/B2 launched")
            else:
                cs.check(launches["megablock_fwd"] > 0
                         and launches["megablock_bwd_rows"] > 0,
                         f"{name}: B1/B2 not launched")
            cs.step_agreement("rank 0", "one process", res, before,
                              checked=("gradient",))
            results[name] = {"loss": float(res["rank 0"][0]),
                             "ms": ms, "one_process_ms": one_ms,
                             "launches": launches}

        results["sharded"] = _sharded_checks(ranks, shard, card)

        # the RNA driver as a user launches it
        root = layouts.rna(os.path.join(tmp, "rna"),
                           [cs._jittered_torus(k, 10 + i) for i, k in
                            enumerate(cs.DRIVER_TORI["rna"])], n_train=3)
        for train in (True, False):
            RNAMeshDataset(root, train=train, k_eig=cs.K_EIG,
                           op_cache_dir=os.path.join(root, "op_cache"))
        cmd = [sys.executable, "-m", "torch.distributed.run",
               f"--nproc_per_node={n}", "--master_addr=127.0.0.1",
               f"--master_port={cs._free_port()}", "-m",
               "diffusionnet_tpu_torch.experiments.rna_mesh_segmentation."
               "rna_mesh_segmentation", "--megakernel", "--mesh",
               f"{n // 2},2", "--n_epoch", "1", "--buckets", "16384,32768",
               "--data_dir", root, "--device", "cuda"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        secs = time.perf_counter() - t0
        # every rank prints the accuracy (the lines may interleave)
        accs = res.stdout.count("Overall test accuracy")
        epochs = [line for line in res.stdout.splitlines()
                  if line.startswith("Epoch 0")]
        cs.log(f"  torchrun RNA driver --mesh {n // 2},2 --megakernel, 1 "
               f"epoch: rc {res.returncode}, {secs:.2f} s with start-up; "
               f"rank 0's log {epochs}; accuracy printed by {accs} ranks")
        if res.returncode != 0:
            cs.log(res.stdout[-3000:] + res.stderr[-3000:])
        cs.check(res.returncode == 0 and accs == n and len(epochs) == 1,
                 "the torchrun RNA driver failed")
        results["rna"] = {"seconds": secs, "epoch_line": epochs[0]}
    cs.log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
