"""Training traffic: the train step that the port's `fit` composes, epoch
after epoch on the configuration's dataset, for the window's length.

Set-up builds the dataset (synthetic operator bundles with the published
shapes, a few distinct ones shared by many entries, each entry with its
own vertex count, faces, positions and labels), uploads it the way the
configuration's FitConfig says (`batch_source`: `DeviceDataset` with
device_data), builds the model by `build_model`, draws the weights from
the seed, and composes the step as `fit` does: `apply_model` and
`loss_and_counts` under `make_train_step` with Adam and the driver's step
decay, one step generator a step from a CPU generator seeded with the
run's fit seed, each epoch shuffled with RandomState(seed + epoch). It
then drives that step object through its first `checked_steps` steps,
keeping the losses, the first gradient (Adam's first moment after one
update, over 0.1) and the parameters' change after them, and through
`warm_steps` more. The window goes on with the same object, reading the
loss and counts on the host every step as `fit` does. After the window
(and the trace), the reference repeats the checked steps from the same
inputs and draws.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from dnbench import compare, counts, inputs
from reference import adam as ref_adam
from reference import diffusionnet as ref
from reference import draws as ref_draws

# the block kernels' dropout tile: the first of these that divides the
# padded V (the port's MEGA_TILES rule, which keys its masks)
MEGA_TILES = (2048, 1024, 512, 256, 128)


def _bucket(v: int, buckets) -> int:
    for b in buckets:
        if v <= b:
            return b
    return -(-v // 8192) * 8192


def groups(vs: list, buckets) -> list:
    """(padded V, dataset indices) of each vertex bucket in order: one
    group sized for the largest surface when buckets is None (the
    driver's default buckets then), else one per configured bucket."""
    default = (256, 1024, 4096, 8192, 16384, 32768, 65536, 131072, 262144)
    if buckets is None:
        return [(_bucket(max(vs), default), list(range(len(vs))))]
    out: dict = {}
    for i, v in enumerate(vs):
        out.setdefault(_bucket(v, buckets), []).append(i)
    return sorted(out.items())


def epoch_batches(grps: list, B: int, seed: int) -> list:
    """[(v_pad, dataset indices of the real rows)] of one epoch, in the
    order the port's batches come: each group permuted in turn by one
    RandomState(seed), cut into batches of B."""
    rs = np.random.RandomState(seed)
    out = []
    for v_pad, idx in grps:
        order = rs.permutation(len(idx))
        for s in range(0, len(idx), B):
            out.append((v_pad, [idx[j] for j in order[s:s + B]]))
    return out


class Data:
    """The dataset's inputs, made from the seed: `bundles` (dicts of
    tensors on the device, shared by entries; vertex counts at fixed
    quantiles of the configuration's range), per entry `V`, `bundle_of`,
    `verts`, `faces`, `labels` (numpy), and the initial weights."""

    def __init__(self, conf: dict, seed: int, device):
        m, d = conf["model"], conf["dataset"]
        rs = np.random.RandomState(inputs.sub_seed(seed, "dataset"))
        n = d["distinct_bundles"]
        # the same vertex counts for every seed (quantiles of the range),
        # each shared by as many entries, in a seeded order
        vs = [int(round(d["v_min"] + (j + 0.5) / n
                        * (d["v_max"] - d["v_min"]))) for j in range(n)]
        self.bundles = [inputs.bundle(v, m["k_eig"],
                                      inputs.sub_seed(seed, f"bundle{j}"),
                                      device) for j, v in enumerate(vs)]
        self.bundle_of = [int(j) for j in
                          rs.permutation(np.arange(d["n_train"]) % n)]
        self.V = [vs[j] for j in self.bundle_of]
        self.verts, self.faces, self.labels = [], [], []
        for i, V in enumerate(self.V):
            self.verts.append(rs.standard_normal((V, 3)).astype(np.float32))
            faces = inputs.grid_faces(V, inputs.sub_seed(seed, f"faces{i}"))
            self.faces.append(faces)
            if m["outputs_at"] == "faces":
                self.labels.append(rs.randint(0, m["n_class"], len(faces)))
            else:  # vertex labels: the template's vertex ids
                self.labels.append(np.arange(V) % m["n_class"])
        self.weights = inputs.weights(m, seed, device, trained=False)


def _program_dataset(data: Data, labels_kind: str):
    from diffusionnet_tpu_torch.data import SurfaceDataset
    from diffusionnet_tpu_torch.geometry.operators import Operators
    from diffusionnet_tpu_torch.ops.sparse import Ell

    def ops(b):
        V = b["mass"].shape[0]
        host = {k: v.cpu().numpy() for k, v in b.items()}
        # L, gradX, gradY (ELL) and frames: unread by the spectral route
        ell = Ell(np.zeros((V, 1), np.int32), np.zeros((V, 1), np.float32))
        return Operators(frames=np.zeros((V, 3, 3), np.float32),
                         mass=host["mass"], L=ell, evals=host["evals"],
                         evecs=host["evecs"], gradX=ell, gradY=ell,
                         gradX_spec=host["gX"], gradY_spec=host["gY"])
    bundles = [ops(b) for b in data.bundles]
    ds = SurfaceDataset(labels_kind)
    for i in range(len(data.V)):
        ds.add(data.verts[i], data.faces[i], data.labels[i])
    ds.ops_list = [bundles[j] for j in data.bundle_of]
    return ds


def first_batches(conf: dict, data: Data, fit_seed: int, n: int) -> tuple:
    """The (v_pad, rows) of a run's first n batches and their step seeds."""
    cfg = fit_config(conf, fit_seed)
    plan = epoch_batches(groups(data.V, cfg.buckets), cfg.batch_size,
                         cfg.seed)
    return plan[:n], ref_draws.step_seeds(cfg.seed, n)


def fit_config(conf: dict, fit_seed: int):
    from diffusionnet_tpu_torch.experiments.exp_common import FitConfig
    f = dict(conf["fit"])
    if f.get("buckets") is not None:
        f["buckets"] = tuple(f["buckets"])
    return FitConfig(seed=fit_seed, **f)


def reference_steps(conf: dict, data: Data, batches: list, step_seeds: list,
                    prec: str, device) -> dict:
    """The reference's first steps on the same inputs and draws: each
    step's loss, the first gradient's norm per leaf, each leaf's change
    over the steps."""
    m, f = conf["model"], conf["fit"]
    dt = torch.float64 if prec == "f64" else torch.float32
    widths = [3 * m["c_width"], *m["mlp_hidden_dims"]]
    mega = f["use_megakernel"]
    rotate = f["augment_rotate"] and m["input_features"] == "xyz"

    def loss_of_step(s):
        v_pad, rows = batches[s]
        B = f["batch_size"]
        if mega:
            tile = next(t for t in MEGA_TILES if v_pad % t == 0)
            draws = ref_draws.KernelDraws(step_seeds[s], B, m["n_block"],
                                          rotate)
        else:
            tile = 0
            draws = ref_draws.EagerDraws(step_seeds[s], B, v_pad,
                                         m["n_block"], widths, rotate,
                                         m["dropout"], device)

        def loss(p):
            total, count = 0.0, 0
            for j, i in enumerate(rows):
                b = {k: v.to(dt) for k, v in
                     data.bundles[data.bundle_of[i]].items()}
                if m["input_features"] == "hks":
                    feats = ref.hks(b["evals"], b["evecs"])
                else:
                    feats = torch.as_tensor(data.verts[i], device=device,
                                            dtype=dt)
                    if rotate:
                        R = ref.rotation_y(draws.rot_u[j:j + 1])[0]
                        feats = feats @ R.to(device, dt)
                masks = (draws.masks(j, tile, device) if m["dropout"]
                         else None)
                faces = (torch.as_tensor(data.faces[i], device=device)
                         if m["outputs_at"] == "faces" else None)
                logp = ref.forward(p, feats, b["mass"], b["evals"],
                                   b["evecs"], b["gX"], b["gY"],
                                   m["n_block"], faces=faces, masks=masks)
                lab = torch.as_tensor(data.labels[i], device=device)
                total = total - logp.gather(1, lab[:, None].long()).sum()
                count += lab.numel()
            return total / count
        return loss

    steps_per_epoch = -(-len(data.V) // f["batch_size"])
    p0 = {k: v.to(dt) for k, v in data.weights.items()}
    with ref.matmul_precision(prec):
        losses, g0, p = ref_adam.train(
            p0, [loss_of_step(s) for s in range(len(batches))],
            f["lr"], f["decay_every"] * steps_per_epoch, f["decay_rate"])
    return {"losses": losses,
            "grad_norms": {k: float(g.norm()) for k, g in g0.items()},
            "change_norms": {k: float((p[k] - p0[k]).norm()) for k in p}}


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float):
    """One run of the cell; returns the record the metric readers read."""
    from diffusionnet_tpu_torch import training
    from diffusionnet_tpu_torch.experiments import exp_common
    from diffusionnet_tpu_torch.models import to_flat_jax_params

    conf, traffic = cell.config, cell.traffic
    m, f = conf["model"], conf["fit"]
    fit_seed = inputs.sub_seed(seed, "fit")
    stages = {"start": time.perf_counter() - t0}
    data = Data(conf, seed, device)
    stages["inputs"] = time.perf_counter() - t0
    cfg = fit_config(conf, fit_seed)
    ds = _program_dataset(data, cfg.labels_kind)
    model = exp_common.build_model(
        n_class=m["n_class"], c_width=m["c_width"], outputs_at=m["outputs_at"],
        dropout=m["dropout"], input_features=m["input_features"],
        n_block=m["n_block"])
    want = {k: v.shape for k, v in to_flat_jax_params(model).items()}
    if want != {k: tuple(v.shape) for k, v in data.weights.items()}:
        raise ValueError("the configuration's parameters are not the ones "
                         "build_model makes")
    params = {k: v.clone().requires_grad_(True)
              for k, v in data.weights.items()}

    # the step, composed as `fit` composes it
    tcfg = exp_common.task_config(cfg)
    steps_per_epoch = max(1, -(-len(ds) // cfg.batch_size))
    optimizer = training.adam_with_step_decay(
        cfg.lr, cfg.decay_every * steps_per_epoch, cfg.decay_rate)
    opt_state = optimizer.init(params)
    rng = torch.Generator().manual_seed(cfg.seed)
    gen_device = torch.device("cpu") if cfg.use_megakernel else device

    def step_generator():
        s = int(torch.randint(0, 2 ** 62, (), generator=rng))
        return torch.Generator(device=gen_device).manual_seed(s)

    def loss_fn(p, batch, generator):
        preds = training.apply_model(model, p, batch, generator, tcfg,
                                     deterministic=False)
        return training.loss_and_counts(preds, batch, tcfg)

    train_step = training.make_train_step(loss_fn, optimizer)
    batches = exp_common.batch_source(cfg, device)
    grps = groups(data.V, cfg.buckets)

    def feed():
        epoch = 0
        while True:
            plan = epoch_batches(grps, cfg.batch_size, cfg.seed + epoch)
            n = 0
            for batch in batches(ds, shuffle=True, seed=cfg.seed + epoch):
                if n == len(plan):
                    raise RuntimeError("the port's epoch has more batches "
                                       "than the benchmark's plan")
                v_pad, rows = plan[n]
                n += 1
                yield v_pad, rows, batch
            if n != len(plan):
                raise RuntimeError(f"the port's epoch had {n} batches, the "
                                   f"benchmark's plan {len(plan)}")
            epoch += 1

    it = feed()
    flops_of = [3 * counts.model_flops(V, m["k_eig"], m["c_in"],
                                       m["c_width"], m["mlp_hidden_dims"],
                                       m["n_class"], m["n_block"],
                                       m["input_features"] == "hks")
                for V in data.V]
    tally = {}

    def reset():
        tally.update(steps=0, meshes=0, model_flops=0.0, batch_s=0.0,
                     call_s=0.0, failed=0)
    reset()

    def one_step(spans: bool):
        nonlocal params, opt_state
        with _span("bench.batch", spans):
            tb = time.perf_counter()
            v_pad, rows, batch = next(it)
            tally["batch_s"] += time.perf_counter() - tb
        with _span("bench.step", spans):
            tc = time.perf_counter()
            params, opt_state, loss, (c, t) = train_step(
                params, opt_state, batch, step_generator())
            tally["call_s"] += time.perf_counter() - tc
        with _span("bench.read", spans):
            int(c), int(t)
            value = float(loss)
        tally["steps"] += 1
        tally["meshes"] += len(rows)
        tally["model_flops"] += sum(flops_of[i] for i in rows)
        tally["failed"] += not math.isfinite(value)
        return v_pad, rows, value

    stages["model"] = time.perf_counter() - t0
    # the checked steps, then warm-up, all on the window's object
    checked = traffic["checked_steps"]
    first, prog_losses, grad_norms = [], [], {}
    for s in range(checked):
        v_pad, rows, value = one_step(False)
        first.append((v_pad, rows))
        prog_losses.append(value)
        stages[f"step{s + 1}"] = time.perf_counter() - t0
        if s == 0:
            st = opt_state.optimizer.state
            grad_norms = {k: float(st[params[k]]["exp_avg"].norm()) / 0.1
                          for k in params}
    change_norms = {k: float((params[k].detach() - data.weights[k]).norm())
                    for k in params}
    for _ in range(traffic["warm_steps"]):
        one_step(False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    reset()
    cpu0 = time.thread_time(), time.process_time()
    ends = [time.perf_counter()]
    while ends[-1] - ends[0] < seconds:
        one_step(False)
        ends.append(time.perf_counter())
    if device.type == "cuda":
        torch.cuda.synchronize()
    window = dict(tally, wall_s=time.perf_counter() - ends[0])
    cpu = time.thread_time() - cpu0[0], time.process_time() - cpu0[1]
    step_ms = np.diff(ends) * 1e3
    per_s = np.bincount((np.asarray(ends[1:]) - ends[0]).astype(int))
    print(f"window: {window['steps']} steps, ms a step p10 "
          f"{np.percentile(step_ms, 10):.2f} p50 {np.median(step_ms):.2f} "
          f"p90 {np.percentile(step_ms, 90):.2f}, host ms in the step's "
          f"call {1e3 * window['call_s'] / window['steps']:.2f}, CPU ms a "
          f"step: main thread {1e3 * cpu[0] / window['steps']:.2f}, process "
          f"{1e3 * cpu[1] / window['steps']:.2f}; steps in each second "
          f"{per_s.tolist()}", file=sys.stderr)

    record = dict(setup_s=setup_s, window=window, trace=None, trace_counts={},
                  setup_stages=stages)
    if trace:
        from dnbench import trace as tr
        n = traffic["trace_steps"]
        plans = {False: [], True: []}
        record["trace"] = tr.traced(
            lambda spans: plans[spans].extend(one_step(spans)
                                              for _ in range(n)))
        plan = plans[False]  # the measured stretch's steps
        if cfg.use_megakernel:
            widths = [3 * m["c_width"], *m["mlp_hidden_dims"], m["c_width"]]
            record["trace_counts"]["megablock_bound_s"] = sum(
                counts.megablock_step_bound_s(cfg.batch_size, v_pad,
                                              m["k_eig"], m["c_width"],
                                              widths, m["n_block"])
                for v_pad, _, _ in plan)
        record["trace_counts"]["steps"] = n
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)

    # the program's state goes before the reference runs
    del params, opt_state, it, batches, ds, train_step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    seeds = ref_draws.step_seeds(cfg.seed, checked)
    want = reference_steps(conf, data, first, seeds, "f32", device)
    got = {"losses": prog_losses, "grad_norms": grad_norms,
           "change_norms": change_norms}
    record["readings"] = compare.train_readings(got, want)
    record["program"] = got
    record["attempted"] = window["steps"]
    record["failed"] = window["failed"]
    return record
