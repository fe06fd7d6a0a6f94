"""Pair training traffic: the functional-map correspondence driver's train
step over the ordered pairs of the configuration's shapes, P pairs a step,
epoch after epoch in the driver's pair order, for the window's length.

Set-up draws the dataset from the seed: a few distinct closed surfaces of
irregular valence (Delaunay triangulations of random points on a sphere,
radially perturbed) with the port's own operator precompute, each shared by
many shapes; per shape its own positions (the xyz input) and template
samples (for the ground-truth maps). It builds the model as the driver does
(`FunctionalMapCorrespondence`), draws the weights from the seed, and
composes the step from the driver's own functions: every padded shape
stacked on the card (`stack_shapes`), the ground-truth map of every pair on
the card (`gt_fmap_table`), the step's pairs gathered and rotated there
(`PairFeed`), the pair loss under `make_train_step` (`pair_loss_fn`) with
Adam at the driver's rate, one step generator a step from a CPU generator
seeded with the run's fit seed. It then drives that step through its first
`checked_steps` steps (keeping the losses, the first gradient and the
parameters' change) and `warm_steps` more. The window goes on with the same
objects, reading the loss on the host every step; each step's solve `info`
is summed on the card and read once after the window (a step with a
singular system is failed). After the window (and the trace) the reference
repeats the checked steps from the same inputs and draws; every reading
goes to standard error, and `limits/fmap_train.json` names those that
decide `correct`.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import sys
import time
from itertools import permutations

import numpy as np
import torch

from dnbench import by_span, compare, fmap_counts, inputs, spec
from reference import adam as ref_adam
from reference import diffusionnet as ref
from reference import draws as ref_draws
from reference import fmaps as ref_fm

CACHE = spec.BENCH_DIR.parent / "build" / "bench_cache" / "operators"


def surface(V: int, seed: int) -> tuple:
    """A closed surface of V vertices with irregular valence: the convex
    hull of V random directions (a Delaunay triangulation of the sphere),
    outward-oriented, each vertex's radius scaled by exp(0.1 N(0, 1)),
    centred and scaled to unit area as the driver's dataset normalises
    every shape."""
    from scipy.spatial import ConvexHull

    from diffusionnet_tpu_torch.utils import normalize_positions_np
    rs = np.random.RandomState(seed)
    p = rs.standard_normal((V, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    faces = ConvexHull(p).simplices.astype(np.int64)
    a, b, c = p[faces[:, 0]], p[faces[:, 1]], p[faces[:, 2]]
    flip = np.einsum("ij,ij->i", np.cross(b - a, c - a), a + b + c) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    verts = p * np.exp(0.1 * rs.standard_normal((V, 1)))
    verts = normalize_positions_np(verts, faces=faces, scale_method="area")
    return verts.astype(np.float32), faces


class Data:
    """The dataset's inputs, made from the seed: `ops` (the port's
    Operators of each distinct surface), per shape `bundle_of`, `V`,
    `verts` (its own positions) and `vts` (template samples), the ordered
    `pairs`, the padded sizes `v_pad`, `d_l`, `d_g`, and the initial
    weights (flat, under params/feature_extractor/)."""

    def __init__(self, conf: dict, seed: int, device):
        from diffusionnet_tpu_torch.geometry import get_operators
        from diffusionnet_tpu_torch.utils import round_up_to_multiple
        m, d = conf["model"], conf["dataset"]
        rs = np.random.RandomState(inputs.sub_seed(seed, "dataset"))
        n = d["distinct_surfaces"]
        vs = [int(v) for v in rs.randint(d["v_min"], d["v_max"] + 1, n)]
        self.ops = []
        for j, V in enumerate(vs):
            verts, faces = surface(V, inputs.sub_seed(seed, f"surface{j}"))
            self.ops.append((verts, get_operators(
                verts, faces, k_eig=m["k_eig"], op_cache_dir=str(CACHE),
                device=device)))
        self.bundle_of = [int(j) for j in
                          rs.permutation(np.arange(d["n_train"]) % n)]
        self.V = [vs[j] for j in self.bundle_of]
        self.verts, self.vts = [], []
        for j in self.bundle_of:
            base = self.ops[j][0]
            self.verts.append((base + 0.003 * rs.standard_normal(
                base.shape)).astype(np.float32))
            self.vts.append(rs.randint(0, vs[j], d["n_vts"]))
        self.ops = [o for _, o in self.ops]
        self.pairs = list(permutations(range(d["n_train"]), 2))
        self.v_pad = round_up_to_multiple(max(vs), 128)
        self.d_l = max(o.L.max_degree for o in self.ops)
        self.d_g = max(max(o.gradX.max_degree, o.gradY.max_degree)
                       for o in self.ops)
        flat = inputs.weights(dict(m, n_class=m["c_out"]), seed, device,
                              trained=False)
        self.weights = {k.replace("params/", "params/feature_extractor/", 1):
                        v for k, v in flat.items()}


def epoch_order(n_pairs: int, epoch: int) -> np.ndarray:
    """The published driver's pair order of an epoch."""
    return np.random.RandomState(1000 + epoch).permutation(n_pairs)


def first_batches(conf: dict, data: Data, fit_seed: int, n: int) -> tuple:
    """The pairs [(i1, i2), ...] of a run's first n steps and their step
    seeds."""
    P = conf["fit"]["batch_pairs"]
    order = epoch_order(len(data.pairs), 0)
    plan = [[data.pairs[int(k)] for k in order[s * P:(s + 1) * P]]
            for s in range(n)]
    return plan, ref_draws.step_seeds(fit_seed, n)


def reference_steps(conf: dict, data: Data, batches: list, step_seeds: list,
                    prec: str, device) -> dict:
    """The reference's first steps on the same inputs and draws: each
    step's loss, the first gradient's norm per leaf, each leaf's change
    over the steps."""
    m, f = conf["model"], conf["fit"]
    dt = torch.float64 if prec == "f64" else torch.float32
    widths = [3 * m["c_width"], *m["mlp_hidden_dims"]]
    k = m["n_fmap"]
    bundles = []
    for o in data.ops:
        V = o.mass.shape[0]

        def t(a):
            return torch.as_tensor(np.asarray(a), device=device)
        bundles.append(dict(
            mass=t(o.mass).to(dt), evals=t(o.evals).to(dt),
            evecs=t(o.evecs).to(dt),
            GX=ref_fm.sparse(t(o.gradX.idx), t(o.gradX.val).to(dt), V),
            GY=ref_fm.sparse(t(o.gradY.idx), t(o.gradY.val).to(dt), V)))
    gt = {}

    def c_gt(i1, i2):
        if (i1, i2) not in gt:
            b1, b2 = (bundles[data.bundle_of[i]] for i in (i1, i2))
            gt[i1, i2] = ref_fm.gt_map(
                b1["evecs"], b2["evecs"],
                torch.as_tensor(data.vts[i1], device=device),
                torch.as_tensor(data.vts[i2], device=device), k).to(dt)
        return gt[i1, i2]

    def loss_of_step(s):
        pairs = batches[s]
        n = len(pairs)
        rows = [a for a, _ in pairs] + [b for _, b in pairs]
        u, keep = ref_fm.draws(step_seeds[s], 2 * n, data.v_pad,
                               m["n_block"], widths, f["augment_rotate"],
                               device)
        R = None if u is None else ref_fm.rotation(u.to(dt))

        def loss(p):
            feats = []
            for r, i in enumerate(rows):
                b = bundles[data.bundle_of[i]]
                xyz = torch.as_tensor(data.verts[i], device=device,
                                      dtype=dt)
                if R is not None:
                    xyz = xyz @ R[r]

                def masks(blk, layer, nrows, width, r=r):
                    return keep[blk, layer][r, :nrows]
                feats.append(ref_fm.features(
                    p, xyz, b["mass"], b["evals"], b["evecs"], b["GX"],
                    b["GY"], m["n_block"],
                    masks if m["dropout"] else None))
            total = 0.0
            for j, (i1, i2) in enumerate(pairs):
                bx, by = (bundles[data.bundle_of[i]] for i in (i1, i2))
                C = ref_fm.fmap(feats[j], feats[n + j], bx["evals"],
                                by["evals"], bx["evecs"], by["evecs"],
                                bx["mass"], by["mass"], k, m["lambda"])
                total = total + torch.mean((C - c_gt(i1, i2)) ** 2)
            return total / n
        return loss

    p0 = {key: v.to(dt) for key, v in data.weights.items()}
    with ref.matmul_precision(prec):
        losses, g0, p = ref_adam.train(
            p0, [loss_of_step(s) for s in range(len(batches))], f["lr"], 0,
            1.0)
    return {"losses": losses,
            "grad_norms": {key: float(g.norm()) for key, g in g0.items()},
            "change_norms": {key: float((p[key] - p0[key]).norm())
                             for key in p}}


def readings(got: dict, want: dict) -> dict:
    """`compare.train_readings`, and two readings of the first gradient on
    the leaves that float32 rounding leaves alone at this model's
    unit-area shapes. Elsewhere it moves the gradient by up to its size,
    in the program and in the float32 reference alike (in float64 the
    program equals the reference to 1e-9), so grad_norm_gap, the worst
    leaf, is read but not judged. Both take grad_norm_gap's per-leaf
    measure, the worst leaf of a set:
      grad_norm_gap_last_mlp      the last block's MLP and last_lin: the
                                  head's backward and that MLP's lie
                                  behind them (and dropout's masks);
      grad_norm_gap_last_spatial  the last block's diffusion time and
                                  gradient-feature maps: the ELL
                                  products' backward and the
                                  diffusion's lie behind them too."""
    out = compare.train_readings(got, want)
    g, r = got["grad_norms"], want["grad_norms"]
    med = statistics.median(r.values())
    gap = {k: abs(g[k] - r[k]) / max(r[k], med, 1e-30) for k in r}
    last = max(int(k.split("/block_")[1].split("/")[0]) for k in r
               if "/block_" in k)
    blk = f"/block_{last}/"
    out["grad_norm_gap_last_mlp"] = max(
        v for k, v in gap.items()
        if blk + "mlp/" in k or "/last_lin/" in k)
    out["grad_norm_gap_last_spatial"] = max(
        v for k, v in gap.items() if blk in k and blk + "mlp/" not in k)
    return out


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float):
    """One run of the cell; returns the record the metric readers read."""
    from diffusionnet_tpu_torch import training
    from diffusionnet_tpu_torch.experiments.functional_correspondence import \
        functional_correspondence as fc
    from diffusionnet_tpu_torch.models import (FunctionalMapCorrespondence,
                                               to_flat_jax_params)
    if not hasattr(fc, "PairFeed"):
        raise RuntimeError("the port's correspondence driver does not batch "
                           "pairs (no PairFeed)")

    conf, traffic = cell.config, cell.traffic
    m, f = conf["model"], conf["fit"]
    P = f["batch_pairs"]
    fit_seed = inputs.sub_seed(seed, "fit")
    stages = {"start": time.perf_counter() - t0}
    data = Data(conf, seed, device)
    stages["inputs"] = time.perf_counter() - t0

    class Shapes:  # the driver's dataset, as its functions read it
        verts_list = data.verts
        ops_list = [data.ops[j] for j in data.bundle_of]
        vts_list = data.vts
        combinations = data.pairs
    model = FunctionalMapCorrespondence(
        c_in=m["c_in"], c_out=m["c_out"], c_width=m["c_width"],
        n_block=m["n_block"], n_fmap=m["n_fmap"], lambda_param=m["lambda"],
        input_features=m["input_features"]).to(device)
    want = {key: v.shape for key, v in to_flat_jax_params(model).items()}
    if want != {key: tuple(v.shape) for key, v in data.weights.items()}:
        raise ValueError("the configuration's parameters are not the ones "
                         "the driver's model has")
    if list(fc.pair_order(len(data.pairs), 0)) != list(
            epoch_order(len(data.pairs), 0)):
        raise RuntimeError("the port's pair order is not the driver's")
    feed = fc.PairFeed(
        fc.stack_shapes(Shapes, data.v_pad, data.d_l, data.d_g, m["k_eig"],
                        m["input_features"], device),
        fc.gt_fmap_table(Shapes, m["n_fmap"], device), data.pairs, device)
    stages["upload"] = time.perf_counter() - t0
    params = {key: v.clone().requires_grad_(True)
              for key, v in data.weights.items()}
    optimizer = training.adam_with_step_decay(f["lr"])
    opt_state = optimizer.init(params)
    train_step = training.make_train_step(fc.pair_loss_fn(model), optimizer)
    rng = torch.Generator().manual_seed(fit_seed)
    rotate = f["augment_rotate"]
    n_pairs = len(data.pairs)
    nnz = [0.5 * float((o.gradX.val != 0).sum() + (o.gradY.val != 0).sum())
           / o.mass.shape[0] for o in data.ops]
    flops_of = [fmap_counts.model_flops(
        V, nnz[j], m["k_eig"], m["c_in"], m["c_width"],
        m["mlp_hidden_dims"], m["c_out"], m["n_block"], m["n_fmap"])
        for V, j in zip(data.V, data.bundle_of)]
    head = fmap_counts.head_flops(m["c_out"], m["n_fmap"])
    ell_bytes = [fmap_counts.ell_shape_bytes(V, nnz[j], m["c_width"],
                                             m["n_block"])
                 for V, j in zip(data.V, data.bundle_of)]
    bad = torch.zeros((), dtype=torch.int64, device=device)
    where, tally = {}, {}

    def start_epoch(epoch):
        where.update(epoch=epoch, pos=0, plan=epoch_order(n_pairs, epoch),
                     order=feed.epoch(epoch))
    start_epoch(0)

    def reset():
        tally.update(steps=0, meshes=0, model_flops=0.0, ell_bytes=0.0,
                     batch_s=0.0, call_s=0.0, failed=0)
    reset()

    def one_step(spans: bool):
        nonlocal params, opt_state
        if where["pos"] >= n_pairs:
            start_epoch(where["epoch"] + 1)
        pos = where["pos"]
        n = min(P, n_pairs - pos)
        s = int(torch.randint(0, 2 ** 62, (), generator=rng))
        g = torch.Generator(device=device).manual_seed(s)
        with _span("bench.batch", spans):
            tb = time.perf_counter()
            batch = feed.batch(where["order"], pos, n, g if rotate else None)
            tally["batch_s"] += time.perf_counter() - tb
        with _span("bench.step", spans):
            tc = time.perf_counter()
            params, opt_state, loss, info = train_step(params, opt_state,
                                                       batch, g)
            bad.add_((info != 0).any().to(bad.dtype))
            tally["call_s"] += time.perf_counter() - tc
        with _span("bench.read", spans):
            value = float(loss)
        where["pos"] = pos + n
        rows = [data.pairs[int(k)] for k in where["plan"][pos:pos + n]]
        tally["steps"] += 1
        tally["meshes"] += 2 * n
        tally["model_flops"] += 3 * sum(flops_of[a] + flops_of[b] + head
                                        for a, b in rows)
        tally["ell_bytes"] += sum(ell_bytes[a] + ell_bytes[b]
                                  for a, b in rows)
        tally["failed"] += not math.isfinite(value)
        return rows, value

    stages["model"] = time.perf_counter() - t0
    checked = traffic["checked_steps"]
    first, prog_losses, grad_norms = [], [], {}
    for s in range(checked):
        rows, value = one_step(False)
        first.append(rows)
        prog_losses.append(value)
        stages[f"step{s + 1}"] = time.perf_counter() - t0
        if s == 0:
            st = opt_state.optimizer.state
            grad_norms = {key: float(st[params[key]]["exp_avg"].norm()) / 0.1
                          for key in params}
    change_norms = {key: float((params[key].detach()
                                - data.weights[key]).norm())
                    for key in params}
    for _ in range(traffic["warm_steps"]):
        one_step(False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    reset()
    bad.zero_()
    ends = [time.perf_counter()]
    while ends[-1] - ends[0] < seconds:
        one_step(False)
        ends.append(time.perf_counter())
    if device.type == "cuda":
        torch.cuda.synchronize()
    window = dict(tally, wall_s=time.perf_counter() - ends[0])
    window["failed"] += int(bad)  # the one read of the solves' info
    step_ms = np.diff(ends) * 1e3
    print(f"window: {window['steps']} steps, ms a step p10 "
          f"{np.percentile(step_ms, 10):.2f} p50 {np.median(step_ms):.2f} "
          f"p90 {np.percentile(step_ms, 90):.2f}, host ms in the step's "
          f"call {1e3 * window['call_s'] / window['steps']:.2f}, steps with "
          f"a singular system {int(bad)}", file=sys.stderr)

    record = dict(setup_s=setup_s, window=window, trace=None, trace_counts={},
                  setup_stages=stages)
    if trace:
        n = traffic["trace_steps"]
        before = tally["ell_bytes"]
        record["trace"], by = by_span.traced(
            lambda spans: [one_step(spans) for _ in range(n)])
        record["trace_counts"].update(
            steps=n, span_device_s=by,
            ell_bound_s=(tally["ell_bytes"] - before)
            / fmap_counts.HBM_BYTES_S)
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)

    # the program's state goes before the reference runs
    del params, opt_state, feed, train_step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    seeds = ref_draws.step_seeds(fit_seed, checked)
    want_ref = reference_steps(conf, data, first, seeds, "f32", device)
    got = {"losses": prog_losses, "grad_norms": grad_norms,
           "change_norms": change_norms}
    record["readings"] = readings(got, want_ref)
    print("readings: " + ", ".join(f"{k} {v:.4g}" for k, v in
                                   record["readings"].items()),
          file=sys.stderr)
    record["program"] = got
    record["attempted"] = window["steps"]
    record["failed"] = window["failed"]
    return record
