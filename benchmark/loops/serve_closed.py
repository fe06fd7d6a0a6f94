"""Serving traffic: a closed loop of single requests on known meshes, one
client, one card, one stream.

Set-up draws the weights of a trained model from the seed, builds the
configuration's model (with the serving route it names), exports it with
`export_forward` for the mix's vertex buckets into a directory under the
temporary directory, loads the artifact with `load_serving_model` and
removes the directory, then prepares the mix's pool of meshes (vertex
counts at fixed log-spaced quantiles of the mix's range, the same for
every seed; operators and grid faces made on the card from the seed), one
`PreparedMesh` each, and calls every handle twice.

The client sends the next request as soon as the last one's output is on
the host, until the window's end; the request running then completes, and
the window's wall time runs to its output. The meshes come in
permutations of the pool drawn from the seed, so every seed sends the
same sizes in its own order. Each request sends a fresh (V, c_in) signal
from the host, a seeded slice of one random buffer in page-locked memory,
and its output comes back into a page-locked buffer, as a server's
request and response buffers would be. Its latency runs from the call to
its output on the host.

Requests whose index falls on a seeded stride, and the first request on
the largest mesh, keep their output; after the window the reference
recomputes each of those from the same weights, operators and signal.
"""

from __future__ import annotations

import contextlib
import functools
import math
import shutil
import tempfile
import time

import numpy as np
import torch

from dnbench import counts, inputs
from reference import diffusionnet as ref


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class Pool:
    """The mix's meshes: vertex counts at log-spaced quantiles of
    [v_min, v_max]; per mesh a dict of operator tensors on the device
    (from the seed) and its faces (numpy)."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        n, lo, hi = traffic["pool"], traffic["v_min"], traffic["v_max"]
        self.V = [int(round(math.exp(math.log(lo) + (j + 0.5) / n
                                     * (math.log(hi) - math.log(lo)))))
                  for j in range(n)]
        k = conf["model"]["k_eig"]
        self.ops = [inputs.bundle(V, k, inputs.sub_seed(seed, f"mesh{j}"),
                                  device) for j, V in enumerate(self.V)]
        self.faces = [inputs.grid_faces(V, inputs.sub_seed(seed, f"faces{j}"))
                      for j, V in enumerate(self.V)]


class Requests:
    """The request stream: request r goes to mesh `mesh[r]` (permutations
    of the pool, seeded) with the signal at `offset[r]` (seeded); `keep(r)`
    (seeded) says whether its output is kept for the check."""

    def __init__(self, traffic: dict, pool: Pool, seed: int, c_in: int,
                 pinned: bool = False):
        n, P = traffic["max_requests"], len(pool.V)
        rs = np.random.RandomState(inputs.sub_seed(seed, "requests"))
        self.mesh = np.concatenate([rs.permutation(P)
                                    for _ in range(-(-n // P))])[:n]
        self.offset = rs.randint(0, traffic["signal_slack"], n)
        self.stride = traffic["sample_stride"]
        self.phase = int(rs.randint(self.stride))
        self.first_largest = int(np.argmax(self.mesh == int(np.argmax(pool.V))))
        self.signal = torch.from_numpy(rs.random_sample(
            max(pool.V) * c_in + traffic["signal_slack"]).astype(np.float32))
        if pinned:
            self.signal = self.signal.pin_memory()
        self.c_in, self.V, self.n = c_in, pool.V, n

    def x(self, r: int) -> torch.Tensor:
        V, o = self.V[self.mesh[r]], self.offset[r]
        return self.signal[o:o + V * self.c_in].reshape(V, self.c_in)

    def keep(self, r: int) -> bool:
        return r % self.stride == self.phase or r == self.first_largest


def build_model(m: dict, serving: dict, flat: dict, device):
    from diffusionnet_tpu_torch.models import (DiffusionNet,
                                               from_flat_jax_params)
    model = DiffusionNet(
        c_in=m["c_in"], c_out=m["n_class"], c_width=m["c_width"],
        n_block=m["n_block"], mlp_hidden_dims=m["mlp_hidden_dims"],
        dropout=m["dropout"], outputs_at=m["outputs_at"],
        last_activation=functools.partial(torch.log_softmax, dim=-1),
        use_pallas_fused=serving["use_pallas_fused"])
    model.load_state_dict(from_flat_jax_params(
        {k: v.cpu() for k, v in flat.items()}))
    return model.to(device)


def reference_out(conf: dict, pool: Pool, reqs: Requests, flat: dict,
                  r: int, prec: str, device) -> torch.Tensor:
    """The reference's log-probabilities for request r."""
    m, b = conf["model"], pool.ops[reqs.mesh[r]]
    x = torch.as_tensor(reqs.x(r), device=device)
    faces = (torch.as_tensor(pool.faces[reqs.mesh[r]], device=device)
             if m["outputs_at"] == "faces" else None)
    with ref.matmul_precision(prec), torch.no_grad():
        return ref.forward(flat, x, b["mass"], b["evals"], b["evecs"],
                           b["gX"], b["gY"], m["n_block"], faces=faces)


def reference_gap(conf: dict, pool: Pool, reqs: Requests, flat: dict,
                  kept: dict, device) -> float:
    """The largest |log p - log p_ref| over the kept outputs, the
    reference in float32."""
    worst = 0.0
    for r, out in kept.items():
        want = reference_out(conf, pool, reqs, flat, r, "f32", device)
        gap = (torch.as_tensor(out, device=device) - want).abs().max()
        worst = max(worst, float(gap))
    return worst


class Server:
    """The cell's set-up (weights, artifact, pool, handles, warm-up) and
    its requests."""

    def __init__(self, cell, seed: int, device, t0: float):
        from diffusionnet_tpu_torch.serving import (export_forward,
                                                    load_serving_model)
        self.conf, self.traffic, self.device = cell.config, cell.traffic, device
        m = self.m = self.conf["model"]
        self.stages = {"start": time.perf_counter() - t0}
        self.flat = inputs.weights(m, seed, device, trained=True)
        model = build_model(m, self.conf["serving"], self.flat, device)
        art = tempfile.mkdtemp(prefix="bench_artifact_")
        try:
            export_forward(model, self.traffic["buckets"], art, m["k_eig"],
                           device=device)
            self.sm = load_serving_model(art, device=device)
        finally:
            shutil.rmtree(art)
        self.stages["export_load"] = time.perf_counter() - t0
        self.pool = Pool(self.conf, self.traffic, seed, device)
        cuda = device.type == "cuda"
        self.reqs = Requests(self.traffic, self.pool, seed, m["c_in"], cuda)
        n_out = max(self.pool.V if m["outputs_at"] == "vertices"
                    else [len(f) for f in self.pool.faces]) * m["n_class"]
        self.out = torch.empty(n_out, pin_memory=cuda)
        self.handles = [self.sm.prepare(b["mass"], b["evals"], b["evecs"],
                                        b["gX"], b["gY"],
                                        inds=f.astype(np.int32))
                        for b, f in zip(self.pool.ops, self.pool.faces)]
        self.stages["prepare"] = time.perf_counter() - t0
        for h in self.handles:
            for _ in range(2):
                h(self.reqs.signal[:h.v * m["c_in"]].reshape(
                    h.v, m["c_in"])).cpu()
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.kept, self.next = {}, 0

    def serve_one(self, spans: bool = False) -> tuple:
        """Request `next`, now: (host seconds of the call, seconds to the
        output on the host)."""
        r = self.next
        self.next += 1
        x = self.reqs.x(r)
        ts = time.perf_counter()
        with _span("bench.call", spans):
            out = self.handles[self.reqs.mesh[r]](x)
        th = time.perf_counter()
        with _span("bench.to_host", spans):
            host = self.out[:out.numel()].view(out.shape)
            host.copy_(out)
        if self.reqs.keep(r):
            self.kept[r] = host.numpy().copy()
        return th - ts, time.perf_counter() - ts

    def window(self, seconds: float) -> dict:
        """Requests back to back until `seconds` have passed; the last one
        completes and the wall time runs to its output."""
        lat, call, first = [], 0.0, self.next
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            if self.next == self.reqs.n:
                raise RuntimeError("the window outran the mix's "
                                   f"{self.reqs.n} requests")
            c, s = self.serve_one()
            lat.append(s)
            call += c
        wall = time.perf_counter() - t0
        m = self.m
        flops = sum(counts.model_flops(
            self.reqs.V[self.reqs.mesh[r]], m["k_eig"], m["c_in"],
            m["c_width"], m["mlp_hidden_dims"], m["n_class"], m["n_block"],
            False) for r in range(first, self.next))
        return dict(wall_s=wall, requests=len(lat),
                    latencies_ms=[1e3 * t for t in lat], call_s=call,
                    model_flops=flops)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float):
    """One run of the cell; returns the record the metric readers read."""
    srv = Server(cell, seed, device, t0)
    setup_s = time.perf_counter() - t0
    window = srv.window(seconds)
    n_window = srv.next
    record = dict(setup_s=setup_s, window=window, trace=None,
                  trace_counts={}, setup_stages=srv.stages)
    if trace:
        from dnbench import trace as tr
        n = cell.traffic["trace_requests"]
        done = [srv.reqs.mesh[srv.next + i] for i in range(n)]
        # the first of the two stretches is measured: its n requests
        record["trace"] = tr.traced(
            lambda spans: [srv.serve_one(spans) for _ in range(n)])
        m = srv.m
        record["trace_counts"] = dict(requests=n, fused_bound_s=sum(
            m["n_block"] * counts.fused_bound_s(
                1, srv.handles[j].bucket, m["k_eig"], m["c_width"])
            for j in done))
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    # only the window's answers are judged; the program's state goes first
    kept = {r: out for r, out in srv.kept.items() if r < n_window}
    pool, reqs, flat = srv.pool, srv.reqs, srv.flat
    del srv
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["readings"] = {"serve_max_gap": reference_gap(
        cell.config, pool, reqs, flat, kept, device)}
    record["attempted"] = window["requests"]
    record["failed"] = sum(not np.isfinite(o).all() for o in kept.values())
    record["sampled"] = len(kept)
    return record
