#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diffusionnet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero. Where
a phase holds a hand-written kernel to "the eager model" or "the unfused
model" on the card, that model runs on the dense route (`dense_route`:
torch products on cuBLAS), checked to launch no B4 kernel: the card's
eager model would otherwise run its spectral products on B4 too.

  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the hand-written kernels from csrc/ with nvcc;
  3. kernels against their plain PyTorch versions, at the full width of the
     segmentation model (B=2, V=32768, K=128, C=128, hidden [128, 128]), of
     the sampling_invariance model (B=1, V=32768, C=256, hidden [256, 256],
     K 128 and 256: B1's row kernel with one warpgroup a CTA and feat in a
     device scratch in f32, x_hat_next in 128 x 128 pieces), at a small ragged shape, and at the
     shapes of B1's earlier wide route (C=256 with hidden [1024, 1024], the
     hidden layers in device scratch; C = 12, padded to 16), f32 and bf16
     operands, emit_next on and off, each launched twice and bit-identical;
     B1's x_hat kernel alone against its plain version (the same split of
     V) with the fixed-order sum of its partials bit-equal to the plain
     sum; the x_hat partial sum bit-equal to its plain version at the
     split counts of B=1, V=32768 and B=8, V=20480, and timed there beside
     torch.sum;
  4. the slice: InferenceSession(use_megakernel=True) on the card serves
     three meshes with the segmentation model (seeded weights); the launch
     counters show each request ran n_block block kernels, and the eager
     DiffusionNet on the same card agrees;
  5. times of B1 against its plain version (CUDA events around 10 calls
     back to back, median of 10 such runs after warm-up): the whole block,
     its row kernel and its x_hat kernel (beside one torch.einsum), each
     first held to its plain version with two launches bit-identical;
  6. B1 with dropout against its plain version (B=2, V=32768, tile_v 2048
     and 1024, f32 and bf16, two launches bit-identical), and with all-ones
     inputs, where the kept pattern must equal the plain masks exactly;
  7. B2 (the block's backward: the rows kernel, the grads kernel and the
     partial sums) against the plain backward, at full width and at a small
     ragged shape, f32 and bf16, emit_next on and off, dropout on and off;
     then each of B2's two kernels against its own plain version at B=1,
     V=32768, K=128, C=128 and 256, f32 and bf16, with dropout (ReLU-tie
     rows given zero cotangent), each bit-identical over two launches, and
     the fixed-order sums of the grads kernel's partials bit-equal to the
     plain sums;
  8. the training slice: 5 Adam steps of the segmentation model (dropout
     on) on a SurfaceDataset of four synthetic meshes, batch 4, through
     apply_model on the megakernel path; the counters must show 4 B1 and 4
     B2 launches (rows and grads) per step; then one step with dropout off
     through the fast
     path and through the eager model with autograd, from the same state,
     must agree in loss, every gradient and the updated parameters;
  9. times: B2 against its plain backward, and its rows kernel, grads
     kernel and partial sums each beside its plain version and bound, B1's
     dropout cost, B1 and B2 at C = 256 (K 128 and 256, hidden [256, 256];
     K 128, hidden [1024, 1024]), B1 held to its plain version
     with two launches bit-identical before each time, and the whole
     train step at bench.py's shapes (B=8, V=20480, f32 and bf16
     operands) with its peak memory and a profiler breakdown averaged over
     three steps;
 10. B5 (the sliced-ELL SpMM of the device eigensolver) against its plain
     version, and bit-identical over two launches, on the cotan Laplacians
     of torus(144, 140) and delaunay_sphere(100_000) and on a matrix with
     one hub row of degree > 500 and empty rows, at C = 160, 96 and 97
     (the kernel's scalar path); the format's bytes beside those of the
     dense panels it replaced;
 11. times of B5, its plain version and torch.sparse.mm on the same matrix
     in CSR (a yardstick the port never calls) at C = 160, with B5's bound:
     device time (device_ms: CUDA events around calls queued behind a spin
     kernel), and CUDA events around back-to-back calls, which also count
     the host's time to issue each;
 12. the precompute slice: get_operators(k_eig=128, eigensolver="device")
     on the card for torus(144, 140), icosphere(5) and
     delaunay_sphere(100_000) from a fresh cache; B5 must launch on every
     mesh, and the solves of the torus and the icosphere may not fall back
     to ARPACK. The Delaunay sphere's sliver triangles leave the f32 sweeps
     short of what the f64 certification accepts, so there the solver falls
     back to ARPACK as the JAX package's does; the run prints why. On every
     mesh the eigenvalues and a cluster-closed subspace are held to host
     ARPACK and both cold precomputes are timed; on the two smaller ones a
     cold InferenceSession(use_megakernel=True) request of the segmentation
     model is held to a session on ARPACK operators.

 13. B4 (`spectral_project` with `xhat_reduce`, `spectral_apply`, and the
     whole fused block) against its plain version (the projection's: the
     split-V partials and their fixed-order sum) at the segmentation
     training shape (B=4, V=32768, K=C=128), at B=1 and at a ragged V
     (1000, tile_v 8; K=C=128 and K=16, C=8), f32, a bf16 x beside f32
     operators and bf16
     operators, each kernel launched twice and bit-identical; the
     projection's lowp mode (B3's) on the operators in bf16 beside every x;
     the backward's ds on the projection's kernel (spectral_ds) against its
     plain version (f32 and bf16 cotangents); B3 (the op
     `megablock`) at B=2, V=32768, hidden [128, 128], f32 and bf16,
     dropout off and on, forward and every gradient (ReLU-tie rows given
     zero cotangent, as in phase 7);
 14. the fused slice: the segmentation model built with
     use_pallas_fused=True takes 5 Adam steps (dropout on) through
     apply_model(use_megakernel=False) on phase 8's batch; the counters must
     show 4 spectral_project, 4 spectral_ds (the backward's, on the same
     kernel) and 4 spectral_apply launches per step, and no B1 or B2; one step
     with dropout off from the same state, fused and
     unfused, must agree in loss, gradients and updated parameters; a warm
     InferenceSession(use_megakernel=False) request on torus(144, 140) must
     launch B4 four times and agree with the unfused model; then the B3 op
     takes 3 Adam steps of one block's parameters at full width with
     dropout (1 projection, 1 B1, 1 B2 launch a step);
 15. times: B4's kernels and the whole block beside their plain versions
     and bounds at B=4 and B=1, f32 and bf16 x, the projection beside one
     torch.einsum and spectral_apply beside one torch.matmul over Phi, GX
     and GY stacked as (3B, V, K), the backward's ds (B=4 and 1, f32)
     beside one torch.einsum over the stacked pairs; B3 beside its plain
     version; the fused
     and the unfused train step of phase 14 with a profiler breakdown and,
     printed only, the step's largest cuBLAS kernels attributed to the
     operators (and autograd nodes) that launched them;
 16. the sampling_invariance model (c_width 256, hidden [256, 256], 4
     blocks, k 128, vertex outputs over 6890 classes, xyz input, dropout
     on) takes 3 Adam steps at the experiment's default batch of 2 (torus(144, 140) and
     icosphere(5) padded to 32768) through apply_model(use_megakernel=True):
     4 B1 and 4 B2 launches a step; one step with dropout off against the
     eager model with autograd; the step's time;
 16b. two models at widths the earlier kernels did not take, c_width 100
     (default hidden [100, 100]; B1 and B2 pad C to 104) and c_width 256
     with hidden [1024, 1024] (B1's hidden layers in device scratch), in
     the segmentation model's configuration: 5 Adam steps each (dropout
     on) on phase 8's batch through the fast path, 4 B1 and 4 B2 launches a
     step, each step's loss and gradients against the same step with the
     blocks' plain version on the card; a step's time; a warm
     InferenceSession(use_megakernel=True) request against the eager model;
 17. the training harness (experiments.exp_common.fit): (a) B1 and B2
     against their plain versions at the synthetic SHREC example's shapes
     (B=10, V=256 with padding rows, K=32, C=64, hidden [64, 64]; f32 and
     bf16, emit_next on and off, dropout off and on), each launched twice
     and bit-identical; (b) fit on the human_segmentation_original
     configuration at full width (phase 8's meshes, batch 4, k 128, face
     labels, dropout on, use_megakernel) for 2 epochs: B1 and B2 must
     launch, a run resumed from the epoch-0 checkpoint and a run on
     device_data must end with the uninterrupted run's weights bit for bit
     (the eager route's pair is printed), seconds per epoch printed,
     prefetched batches equal to directly copied ones, the prefetch
     epoch's host stacking and copies timed alone, and the face mean's
     backward (gather_mean: a fixed-order sum over each vertex's entries)
     must repeat its bits over five passes (gather's and an embedding
     lookup's printed, all three timed); (c)
     the synthetic SHREC example with --mega at its defaults, whose test
     accuracy must reach EXAMPLE_ACC_BOUND; (d) the two point-cloud
     examples at their defaults: fmaps_synthetic (held-out fmap L2, mean
     angular error) and sampling_invariance_synthetic --gate (the
     per-mutation table; the gate failing fails the phase);
 18a. ops.sparse.ell_matvec's fixed-order backward at the segmentation
     shape (B=4, V=32768, C=128, torus(144, 140)'s ELL gradient operator)
     must repeat its bits over five passes (the gather's own autograd
     backward printed beside it), and a 2-epoch fit of an implicit_dense
     model resumed from its epoch-0 checkpoint must end with the
     uninterrupted run's weights bit for bit;
 18. the serving slice (serving.export): the fused segmentation model
     exported on the card (buckets 16384 and 32768; the graphs must hold
     B4's registered ops), loaded in the script and in a fresh process
     barred from importing the model stack, serves torus(144, 140) and
     icosphere(5) at batch 1 and 4 through ServingModel.__call__ and a
     PreparedMesh within SLICE_TOL of the eager model (4 spectral_project,
     4 spectral_apply and 4 xhat_reduce launches a request), with no host
     sync on the hot path (torch.cuda.set_sync_debug_mode("error")); then
     the warm request (batch 1, the torus) on three routes,
     InferenceSession with a cache hit, __call__ with the operators on the
     card, and a PreparedMesh's handle(x): median and p90, busy, idle share;
 19. the E5 cloud split: two point clouds (6,890 Fibonacci-sphere points
     deformed by the examples' `bumpy`, normals from their hull mesh; the
     20,160 vertices of torus(144, 140) with the mesh's normals) through
     get_operators(faces=None, k_eig=128) on the device solver from a fresh
     cache: stage seconds, fallbacks and B5's launches printed, B5 must
     launch, the eigenvalues and a cluster-closed subspace held to host
     ARPACK; then E5's model (c_width 256, 6890 classes, xyz, seeded
     weights) through apply_model(use_megakernel=True) at batch 1 (buckets
     8192 and 32768) held to the eager model at SLICE_TOL, 4 B1 launches a
     request, and the warm request timed (CUDA events; host clock; busy
     and idle share from the profiler);
 19b. all_pairs_heat_device on the card for the 6,890-vertex hull mesh and
     torus(144, 140) against the host heat method on 256 seeded sources
     (within 1e-3 of the diameter), seconds and peak device memory; then
     geodesic_label_errors(method="heat_device") of phase 19's predictions;
 20. the five experiment drivers, each through its main([...]) with
     --device cuda on its suite's layout (experiments.layouts, jittered
     tori of 260-20,160 vertices) at the driver's own width:
     human_segmentation_original (--megakernel, 2 epochs, then --evaluate
     of its best checkpoint on the eager route within SEG_EVAL_PP of fit's
     logged accuracy), rna_mesh_segmentation (the eager default, buckets
     16384 and 32768, 1 epoch), classification_shrec11 (simplified, 30
     classes x 3 meshes, --megakernel, 1 epoch), sampling_invariance
     (6,890 classes at C 256, --megakernel, heat_device geodesics, 1
     epoch) and functional_correspondence (--evaluate on the reference's
     faust_hks.npz on the card and on the CPU, which must agree within
     FMAPS_CPU_TOL, then 1 epoch); each driver's seconds by stage, result
     and B1, B2, partial-sum and B5 launches (B1/B2 must launch on the
     --megakernel runs, B5 in each precompute of meshes past the solver's
     dense route);
 21. training over several ranks: (a) over one nccl rank (a world of 1),
     fit with data_parallel=True and with mesh_shape=(1, 1) on phase 17b's
     configuration must end with phase 17b's 40 tensors bit for bit; (b)
     two ranks over gloo sharing the card (NCCL refuses two ranks on one
     device; gloo carries the CUDA tensors, every product runs in B1/B2):
     vertex_sharded_megakernel_forward at vert 2 on the torus (16,384 rows
     a rank) against one process's B1 within PAR_FWD_TOL, one (1, 2) and
     one (2, 1) step (dropout off, phase 8's batch with vertex labels)
     against one process's step within STEP_TOL, and the RNA driver with
     --mesh 1,2 --megakernel for one epoch (equal histories); each rank's
     B1, B2 and partial-sum launches, added to the kernels line; then the
     same configuration built with use_pallas_fused on the same two ranks:
     vertex_sharded_forward on the torus (B4 on each rank's rows, x_hat's
     partials all-reduced) against one process's fused model within
     PAR_FWD_TOL, and one (1, 2) make_two_axis_train_step step through
     apply_model (x_hat's cotangent all-reduced in the backward, spectral_ds
     on each rank's rows) against one process's fused step within
     STEP_TOL; each rank must launch B4's three kernels and xhat_reduce
     exactly PAR_B4_WANT times and B1/B2 never, added to the kernels line;
     the fused step on one card at B=4 and B=1 (a vert-4 rank's share of
     the products) timed in CUDA events and device time;
 22. the vertex-sharded eigensolver and serving artifact, the band and DIA
     formats: (a) over one nccl rank, eigensolve_device_sharded at vert 1
     on the torus against eigensolve_device(banded=False) (bit-identity
     expected and printed); (b) two gloo ranks sharing the card: the
     sharded solve of icosphere(5) (10,244 rows) at vert 2 against ARPACK
     and the single-card solve, every rank's evals bit-equal; (c) on the
     same ranks, the segmentation model (vertex outputs, fused and
     unfused on the dense route, and a global_mean head, unfused, on the
     card's default B4) exported sharded at bucket 32768 serves the torus
     against the single-card ServingModel within the serving tests'
     tolerance, B4 launched 4 + 4 times a request on each rank of the
     fused and global_mean artifacts (and xhat_reduce 4 times, one a
     projection) and never by the dense one, warm requests timed; (d) one matvec of the DIA format
     (torus) and of the dense band (icosphere(5)) against B5 and
     torch.sparse.mm, and their solves against ARPACK beside the B5 and
     ELL solves. B4's and xhat_reduce's sharded launches join the kernels
     line.

Since phase 12's slice the port's default eigensolver is the device one,
so the cold requests of phases 4 and 14 and the dataset precompute of
phase 8 run on B5 as well.

The last two lines of standard output are the card's name and power limit
as nvidia-smi reports them, then {"ok": true, "device": {...}}; the line
before them is a JSON summary of the kernels.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

N_BLOCK = 4
# launches of a train step of N_BLOCK blocks on the megakernel path: B1's
# row kernel per block and its x_hat kernel and partial sum for all but the
# last, B2's two kernels per block and three partial sums each (ds, the
# parameters, db)
B2_PER_STEP = {"megablock_fwd": N_BLOCK, "megablock_fwd_xhat": N_BLOCK - 1,
               "xhat_reduce": N_BLOCK - 1,
               "megablock_bwd_rows": N_BLOCK, "megablock_bwd_grads": N_BLOCK,
               "grad_reduce": 3 * N_BLOCK}
SEG_MODEL = dict(c_in=16, c_out=8, c_width=128, n_block=N_BLOCK,
                 mlp_hidden_dims=[128, 128], dropout=True, outputs_at="faces")
K_EIG = 128
BENCH_B, BENCH_V = 8, 20480  # bench.py's train step: BATCH, V_PAD

# Kernel against plain version, elementwise |kernel - plain| <= atol + rtol |plain|.
# f32: the same f32 products summed in another order (K = 128 to 3C = 384
# terms per output; V = 32768 terms per x_hat_next entry).
# bf16: both round the same operands to bf16, but a sum taken in another
# order can round an intermediate (gx, gy, a hidden activation) to the
# neighbouring bf16 value, and `out` is stored in bf16: a few steps of 2^-8.
TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
# the slice against the eager model: f32 log-probabilities after four blocks
# whose products are summed in other orders (the kernel's three TF32 passes
# against cuBLAS in f32)
SLICE_TOL = dict(rtol=1e-3, atol=1e-3)
# B2 against the plain backward. f32: |kernel - plain| <= rtol |plain| +
# atol * max |plain| (gradients are sums over every row of the batch, 65,536
# at full width, so the bound scales with the output's largest entry): three
# TF32 passes and another summation order. bf16: relative L2 error. Both
# sides round the same operands to bf16, but where an f32 sum lands next to
# a bf16 rounding boundary the two round it apart (2^-8 relative), and a
# ReLU input downstream of it can then change sign: that row's whole
# contribution moves, so no elementwise bound holds on every row.
GRAD_TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(l2=2e-2)}
# Rows whose smallest ReLU input is within TIE of 0 (relative to its layer's
# largest) can take the other ReLU branch in the kernel and in the plain
# version (the sums differ in their last bits), which moves that row's whole
# contribution to every gradient; phase 7 gives such rows zero cotangent
# (dout = 0, mass = 0). At full width they are about 1% of the rows.
TIE = 1e-5
# one train step, fast path against the eager model with autograd (f32). The
# loss within rtol 1e-4. Gradients and the Adam updates (parameters after
# minus before) in L2 norm: here ReLU ties cannot be excluded, and each
# moves one row's whole contribution (measured on the card: 6 tie rows of
# 65,536 moved dW by 1.2e-3 of its norm, all other rows agreeing within
# 2e-5). The whole gradient (all tensors as one vector) within `whole`;
# each tensor within `own` of its own norm plus `whole` of the whole
# gradient's, since a tensor whose gradient nearly cancels over the batch
# (dA_im sums ddots (gx_i gy_j - gy_i gx_j)) has a small norm next to the
# one-row changes a tie makes. The same for the Adam updates.
STEP_TOL = dict(loss=1e-4, own=1e-2, whole=1e-3)
# B4's bf16 outputs against the plain version, elementwise, atol times
# max |plain|: both round the same f32 sums (of the same f32 products, in
# another order) to bf16 once, so they differ by at most one bf16 step
# (2^-7 relative) where a sum lands by a rounding boundary, plus the f32
# sums' own difference near zero.
B4_BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)


def log(*a):
    print(*a, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def meshgen():
    """tests/meshgen.py (icosphere, torus, delaunay_sphere). tests/ is not a
    package: a `tests` package installed elsewhere would shadow it, so the
    mesh generator (numpy and scipy only) is imported by its path."""
    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.join(here, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(here, "tests"))
    import meshgen as mg
    return mg


def block_inputs(B, V, K, C, hidden, dtype, seed, n_pad=0):
    """Random inputs of one block on the card; the last n_pad rows are
    bucket padding (mass 0, zero operator rows)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale
    x = r(B, V, C)
    evecs, gX, gY = (r(B, V, K, scale=V ** -0.5) for _ in range(3))
    mass = torch.rand(B, V, generator=g, device="cuda")
    if n_pad:
        for t in (evecs, gX, gY, mass):
            t[:, V - n_pad:] = 0
    coefs = torch.rand(B, K, C, generator=g, device="cuda")
    A_re, A_im = r(C, C, scale=C ** -0.5), r(C, C, scale=C ** -0.5)
    w = (3 * C, *hidden, C)
    Ws = [r(w[i], w[i + 1], scale=w[i] ** -0.5) for i in range(len(w) - 1)]
    bs = [r(w[i + 1], scale=0.1) for i in range(len(w) - 1)]
    x_hat = evecs.transpose(1, 2) @ (x * mass[..., None])
    return (x.to(dtype), evecs.to(dtype), gX.to(dtype), gY.to(dtype), mass,
            coefs, A_re, A_im, Ws, bs, x_hat)


def compare(name, got, want, tol, scaled=False, quiet=False):
    """Elementwise check (or, with tol {"l2": bound}, one of the relative L2
    error); returns the max abs error. scaled: atol is relative to
    max |want|. quiet: log only a failure."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = (got - want).abs()
    max_abs = err.max().item()
    scale = want.abs().max().item()
    if "l2" in tol:
        rel = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
        ok = rel <= tol["l2"]
        if not (quiet and ok):
            log(f"  {name}: relative L2 err {rel:.3e} (tolerance "
                f"{tol['l2']}), max abs err {max_abs:.3e}, max abs err / "
                f"max |plain| {max_abs / max(scale, 1e-30):.3e} "
                f"{'ok' if ok else 'FAILED'}")
        check(ok, f"{name} disagrees with the plain version")
        return max_abs
    atol = tol["atol"] * (max(scale, 1e-30) if scaled else 1.0)
    bound = atol + tol["rtol"] * want.abs()
    ok = bool((err <= bound).all())
    if not (quiet and ok):
        log(f"  {name}: max abs err {max_abs:.3e}, max abs err / max |plain| "
            f"{max_abs / max(scale, 1e-30):.3e} (tolerance rtol "
            f"{tol['rtol']}, atol {tol['atol']}"
            f"{' x max|plain|' if scaled else ''}) {'ok' if ok else 'FAILED'}")
    check(ok, f"{name} disagrees with the plain version")
    return max_abs


def time_ms(fn, reps=10, calls=10, warmup=3) -> float:
    """Median over `reps` runs of the time per call of `calls` calls made
    back to back between two CUDA events: the device's time per call, not
    the host's time to issue one."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, calls=20, reps=5, warmup=3) -> float:
    """Device time per call with the host's time to issue a call left out
    (for a kernel of a few microseconds that time is longer than the
    kernel): a spin kernel (torch.cuda._sleep) holds the stream while the
    host issues `calls` calls behind it, so the CUDA events around the calls
    time them run back to back on the device, the device's gaps between
    kernels included; the median of `reps` runs. If the device had already
    reached the start event when the host finished issuing, the run is made
    again with twice the spin. A function that waits on the device itself
    (the B5 plain version sizes its loop on the host) reaches it however
    long the spin; after three tries it is timed without one, its waits
    included. Needs no profiler, whose device activities a card does not
    always report."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = max(int(4 * issue_s * 2e9), 1 << 20)    # cycles at up to 2 GHz
    waits = False
    runs = []
    for _ in range(reps):
        for _ in range(1 if waits else 3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if not waits:
                torch.cuda._sleep(spin)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            caught_up = start.query()
            end.synchronize()
            if not caught_up:
                break
            spin *= 2
        else:
            waits = True
        runs.append(start.elapsed_time(end) / calls)
    return statistics.median(runs)


def b1_twice(mb, tag, args, **kw):
    """B1 launched twice on the same inputs: the two results must be the
    same bits. Returns the first (out, x_hat_next) and the launch counts of
    one call."""
    mb.reset_launches()
    out, xn = mb.megablock_chained_fwd(*args, **kw)
    again = mb.megablock_chained_fwd(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(out, again[0]), f"{tag}: two launches differ in out")
    check(xn is None or torch.equal(xn, again[1]),
          f"{tag}: two launches differ in x_hat_next")
    return out, xn, {k: v // 2 for k, v in mb.LAUNCHES.items()}


def b1_launches(mb, C, hidden, lowp, emit):
    """The row kernel's layout for one B1 call, and the call's launches:
    the row kernel (and with emit_next its x_hat kernel and partial sum)."""
    layout = mb.fwd_route(C, (3 * C, *hidden, C), lowp, mb._smem_limit(0))
    want = dict.fromkeys(mb.LAUNCHES, 0)
    want.update(megablock_fwd=1, megablock_fwd_xhat=int(emit),
                xhat_reduce=int(emit))
    return layout, want


def layout_name(layout) -> str:
    """A row-kernel layout (`fwd_route`) in words."""
    wgs, resident, spilled = layout
    slots = ("gx/xd", "gy", "feat")[resident:]
    return (f"{wgs} warpgroup{'s' if wgs > 1 else ''} a CTA"
            + (f", {' and '.join(slots)} spilled" if slots else "")
            + (", hidden layers spilled" if spilled else ""))


def xhat_kernel_check(mb, tag, args, out, lowp):
    """B1's x_hat kernel alone on the row kernel's out (f32) and the mass,
    against its plain version with the same split of V; two launches give
    the same bits, and the fixed-order sum of its partials equals the plain
    sum of the same partials bit for bit. Returns the largest error of the
    written (K, C) corners."""
    B, V, K = args[1].shape
    C = out.shape[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = mb.xhat_splits(B, V, K, C, sms)
    src = out.float().contiguous()
    part = mb.megablock_fwd_xhat(args[1], src, args[4], splits, lowp)
    again = mb.megablock_fwd_xhat(args[1], src, args[4], splits, lowp)
    plain = mb.megablock_fwd_xhat_reference(args[1], src, args[4], splits,
                                            lowp)
    torch.cuda.synchronize()
    kr, cr = min(K, mb.SLOT), min(C, mb.SLOT)
    got, want = part[..., :kr, :cr], plain[..., :kr, :cr]
    check(torch.equal(got, again[..., :kr, :cr]),
          f"{tag}: two launches of the x_hat kernel differ")
    e = compare(f"{tag} x_hat kernel partials {tuple(part.shape[:4])} "
                f"(splits {splits})", got, want, GRAD_TOL["f32"], scaled=True)
    total = mb.reduce_pieces(part, B, K, C)
    check(torch.equal(total.cpu(), mb.reduce_pieces(part.cpu(), B, K, C)),
          f"{tag}: xhat_reduce of the kernel's partials is not the plain sum")
    return e


def phase_kernels(mb):
    log("== phase 3: kernels against their plain versions")
    errs = {"megablock_fwd": 0.0, "megablock_fwd_xhat": 0.0}
    # the last two: the earlier wide route's shapes, on the row kernel with
    # the hidden layers spilled, and with C padded to 16
    shapes = [(2, 32768, 128, 128, (128, 128), 0),     # full width
              (1, 32768, 128, 256, (256, 256), 0),     # C = 256
              (1, 32768, 256, 256, (256, 256), 0),     # K = C = 256
              (2, 1000, 16, 8, (16, 32, 8), 100),      # ragged last tile
              (1, 8192, 128, 256, (1024, 1024), 0),    # hidden 1024
              (2, 1000, 16, 12, (12,), 100)]           # C % 8 != 0
    for B, V, K, C, hidden, n_pad in shapes:
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args = block_inputs(B, V, K, C, hidden, dtype, seed=V + K,
                                n_pad=n_pad)
            lowp = kind == "bf16"
            for emit in (True, False):
                tag = (f"B={B} V={V} K={K} C={C} hidden={list(hidden)} "
                       f"{kind} emit_next={emit}")
                layout, want = b1_launches(mb, C, hidden, lowp, emit)
                out, xn, got = b1_twice(mb, tag, args, emit_next=emit,
                                        lowp=lowp)
                check(got == want, f"{tag}: launches {got} != {want}")
                ref, ref_xn = mb.megablock_chained_reference(
                    *args, emit_next=emit, lowp=lowp)
                torch.cuda.synchronize()
                tag += (f" ({layout_name(layout)}; two launches "
                        "bit-identical)")
                check(out.dtype == args[0].dtype and out.shape == ref.shape,
                      f"{tag}: out dtype/shape")
                e = compare(f"{tag} out", out, ref, TOL[kind])
                if emit:
                    e = max(e, compare(f"{tag} x_hat_next", xn, ref_xn,
                                       TOL[kind]))
                else:
                    check(xn is None, f"{tag}: x_hat_next without emit_next")
                if kind == "f32" and V >= 8192:
                    errs["megablock_fwd"] = max(errs["megablock_fwd"], e)
                if not emit:
                    ex = xhat_kernel_check(mb, tag, args, out, lowp)
                    if kind == "f32" and V >= 8192:
                        errs["megablock_fwd_xhat"] = max(
                            errs["megablock_fwd_xhat"], ex)
            del args
    # the partial-sum kernel at the main paths' shapes (B1's split counts at
    # B=1, V=32768 and at bench.py's B=8, V=20480), bit-equal to its plain
    # version and to itself
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(7)
    partials = [torch.randn(B, mb.xhat_splits(B, V, 128, 128, sms)[0],
                            mb.SLOT, mb.SLOT, generator=g, device="cuda")
                for B, V in ((1, 32768), (BENCH_B, BENCH_V))]
    errs["xhat_reduce"] = 0.0
    for partial in partials:
        got = mb.xhat_reduce(partial, 128, 128)
        again = mb.xhat_reduce(partial, 128, 128)
        ref = mb.xhat_reduce_reference(partial, 128, 128)
        torch.cuda.synchronize()
        tag = (f"xhat_reduce {tuple(partial.shape)} "
               f"({mb.xhat_chunks(partial.shape[1])} chunks)")
        check(torch.equal(got, again), f"{tag}: two launches differ")
        errs["xhat_reduce"] = max(errs["xhat_reduce"], compare(
            f"{tag} (bit-equal, and over two launches)", got, ref,
            dict(rtol=0.0, atol=0.0)))
        check(torch.equal(got, ref), f"{tag}: not bit-equal to plain")
    return errs, partials


def segmentation_model(**kw):
    """The segmentation model with seeded weights and seeded diffusion
    times (trained models have non-zero ones); kw: more constructor
    arguments (use_pallas_fused) or SEG_MODEL's entries replaced
    (outputs_at, dropout)."""
    from diffusionnet_tpu_torch.models import DiffusionNet
    gen = torch.Generator().manual_seed(0)
    model = DiffusionNet(**{**SEG_MODEL, **kw}, generator=gen,
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    with torch.no_grad():
        for blk in model.blocks:
            t = blk.diffusion.diffusion_time
            t.copy_(torch.rand(t.shape, generator=gen) * 0.05)
    return model


# The plain side of the checks against the hand-written kernels. On a card
# a block with dense spectral gradients runs B4 wherever V is a multiple of
# its pallas_tile_v (models/diffusion_net.py::takes_b4); with a row tile
# that divides no bucket (each a power of two) it keeps the dense route,
# torch products on cuBLAS, on the same inputs.
OFF_TILE_V = 3


def dense_route(model):
    """A copy of `model`, same weights, whose blocks keep the dense route
    on the card."""
    model = copy.deepcopy(model)
    model.pallas_tile_v = OFF_TILE_V
    for blk in model.blocks:
        blk.pallas_tile_v = OFF_TILE_V
    return model


def without_b4(fn, tag):
    """fn()'s result, checked to have launched no B4 kernel and counted
    only `block.dense` routes (training.profiling): the dense route."""
    from diffusionnet_tpu_torch.ops import fused as fu
    from diffusionnet_tpu_torch.training import profiling
    before = dict(fu.LAUNCHES)
    profiling.reset()
    out = fn()
    t = profiling.totals()
    routes = {}
    for counters in (t["counters"], *(r["counters"]
                                      for r in t["records"].values())):
        for k, (n, _) in counters.items():
            if k.startswith("block."):
                routes[k] = routes.get(k, 0) + n
    check(fu.LAUNCHES == before and set(routes) == {"block.dense"},
          f"{tag}: the dense route launched B4 ({before} -> {fu.LAUNCHES}) "
          f"or counted {routes}")
    return out


def phase_slice(mb):
    """The main path: three requests through InferenceSession on the card.
    Returns the launch counts of the three requests."""
    from diffusionnet_tpu_torch.training import InferenceSession
    mg = meshgen()
    icosphere, torus = mg.icosphere, mg.torus

    log("== phase 4: the slice, InferenceSession(use_megakernel=True) on cuda")
    model = segmentation_model()
    requests = [("torus(144, 140)", torus(n_major=144, n_minor=140)),
                ("icosphere(5)", icosphere(subdivisions=5)),
                ("torus(144, 140) again", torus(n_major=144, n_minor=140))]
    with tempfile.TemporaryDirectory() as cache:
        session = InferenceSession(model, k_eig=K_EIG, op_cache_dir=cache,
                                   use_megakernel=True, device="cuda")
        per_block = {"megablock_fwd": N_BLOCK,
                     "megablock_fwd_xhat": N_BLOCK - 1,
                     "xhat_reduce": N_BLOCK - 1,
                     "megablock_bwd_rows": 0, "megablock_bwd_grads": 0,
                     "grad_reduce": 0}
        preds, stamps = [], []
        mb.reset_launches()
        for name, (verts, faces) in requests:
            before = dict(mb.LAUNCHES)
            preds.append(session(verts, faces))
            rise = {k: mb.LAUNCHES[k] - before[k] for k in before}
            files = sorted(os.listdir(cache))
            stamps.append({f: os.stat(os.path.join(cache, f)).st_mtime_ns
                           for f in files})
            log(f"  {name}: V={verts.shape[0]} F={faces.shape[0]}, "
                f"precompute {session.timings['precompute_s']:.3f} s, "
                f"forward {session.timings['forward_s'] * 1e3:.2f} ms, "
                f"launches {rise}")
            check(rise == per_block, f"{name}: launches {rise} != {per_block}")
        launches = dict(mb.LAUNCHES)
        check(stamps[2] == stamps[1] and len(stamps[1]) == 2,
              "the repeated mesh did not hit the operator cache")

        eager = InferenceSession(dense_route(model), k_eig=K_EIG,
                                 op_cache_dir=cache, device="cuda")
        for (name, (verts, faces)), p in zip(requests, preds):
            check(p.shape == (faces.shape[0], SEG_MODEL["c_out"]),
                  f"{name}: predictions {p.shape}")
            check(bool(torch.isfinite(torch.from_numpy(p)).all()),
                  f"{name}: non-finite predictions")
            psum = torch.from_numpy(p).double().exp().sum(-1)
            sum_err = (psum - 1).abs().max().item()
            check(sum_err < 1e-4, f"{name}: probabilities sum off by {sum_err}")
            ref = without_b4(lambda: eager(verts, faces), name)
            compare(f"{name}: predictions {p.shape} against the eager model "
                    f"(probabilities sum to 1 within {sum_err:.1e})",
                    torch.from_numpy(p), torch.from_numpy(ref), SLICE_TOL)
    return launches


def xhat_bound(B, V, K, C, S, lowp):
    """B1's x_hat kernel's least time: Phi (B V K), out (B V C, f32) and
    the mass read once, the partial slots' (K, C) corners (B S K C, f32)
    written once; 2 B V K C operations at three TF32 passes or the bf16
    rate."""
    n_bytes = B * V * (K * (2 if lowp else 4) + 4 * C + 4) + 4 * B * S * K * C
    return bound(n_bytes, 2 * B * V * K * C,
                 BF16_FLOPS if lowp else TF32_FLOPS / 3)


def phase_times(mb, card):
    log("== phase 5: B1 against its plain version, CUDA events, median of "
        "10 runs of 10 calls")
    ms = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    widths = (384, 128, 128, 128)
    for B, V in ((1, 32768), (BENCH_B, BENCH_V)):
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args = block_inputs(B, V, 128, 128, (128, 128), dtype, seed=B)
            lowp = kind == "bf16"
            tag = f"B={B} V={V} {kind}"
            out, xn, _ = b1_twice(mb, tag, args, emit_next=True, lowp=lowp)
            ref, ref_xn = mb.megablock_chained_reference(*args, emit_next=True,
                                                         lowp=lowp)
            compare(f"{tag} out (two launches bit-identical)", out, ref,
                    TOL[kind])
            compare(f"{tag} x_hat_next", xn, ref_xn, TOL[kind])
            del out, xn, ref_xn
            k = time_ms(lambda: mb.megablock_chained(*args, emit_next=True,
                                                     lowp=lowp))
            p = time_ms(lambda: mb.megablock_chained_reference(
                *args, emit_next=True, lowp=lowp))
            rk = time_ms(lambda: mb.megablock_chained_fwd(
                *args, emit_next=False, lowp=lowp))
            rp = time_ms(lambda: mb.megablock_chained_reference(
                *args, emit_next=False, lowp=lowp))
            # the x_hat kernel on the f32 out and the mass (an f32 x's
            # operands), beside its plain version and one torch.einsum of
            # the same x_hat_next
            src, evecs, mass = ref.float().contiguous(), args[1], args[4]
            splits = mb.xhat_splits(B, V, 128, 128, sms)
            xk = time_ms(lambda: mb.megablock_fwd_xhat(evecs, src, mass,
                                                       splits, lowp))
            xp = time_ms(lambda: mb.megablock_fwd_xhat_reference(
                evecs, src, mass, splits, lowp), reps=3)
            lib = (evecs, mass.to(evecs.dtype), src.to(evecs.dtype))
            xl = time_ms(lambda: torch.einsum("bvk,bv,bvc->bkc", *lib))
            rb = megablock_bound(B, V, 128, 128, widths, False, False, lowp)
            xb = xhat_bound(B, V, 128, 128, splits[0], lowp)
            ms[(B, V, kind)] = dict(total=(k, p), rows=(rk, rp, rb),
                                    xhat=(xk, xp, xb, xl))
            log(f"  time megablock_chained emit_next B={B} V={V} K=128 C=128 "
                f"{kind}: kernels {k:.4f} ms, plain {p:.4f} ms; row kernel "
                f"{rk:.4f} ms (plain {rp:.4f}, bound {rb[0]:.4f} ms, {rb[1]}, "
                f"share {rb[0] / rk:.3f}); x_hat kernel {xk:.4f} ms (plain "
                f"{xp:.4f}, torch.einsum {xl:.4f}, bound {xb[0]:.4f} ms, "
                f"{xb[1]}, share {xb[0] / xk:.3f}; splits {splits}) [{card}]")
            del args, ref, src, lib
    return ms


def xhat_reduce_times(mb, partials, card):
    """xhat_reduce, its plain version and one torch.sum over the same slots
    at (1, SMs, 128, 128) and (8, 16, 128, 128), in device time (device_ms)
    and, for the kernel and torch.sum, with CUDA events around calls issued
    back to back (time_ms, host issue included); the bound: the slots'
    (K, C) corners read once and x_hat written once. Returns, per (B, S),
    the device times and bound of the kernels line."""
    out = {}
    for partial in partials:
        B, S = partial.shape[:2]
        def kern():
            return mb.xhat_reduce(partial, 128, 128)
        def lib_sum():
            return partial[:, :, :128, :128].sum(1)
        k, lib = device_ms(kern), device_ms(lib_sum)
        p = device_ms(lambda: mb.xhat_reduce_reference(partial, 128, 128))
        k_ev, lib_ev = time_ms(kern), time_ms(lib_sum)
        bnd = bound(B * (S + 1) * 128 * 128 * 4, B * S * 128 * 128,
                    F32_FLOPS)
        out[(B, S)] = dict(ms=k, plain_ms=p, bound=bnd, library_ms=lib)
        log(f"  time xhat_reduce ({B}, {S}, 128, 128), device time: kernel "
            f"{k:.4f} ms, plain {p:.4f} ms, torch.sum of the slots "
            f"{lib:.4f} ms ({lib / k:.2f}x the kernel's time); bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}), roofline share {bnd[0] / k:.4f}; "
            f"CUDA events around back-to-back calls: kernel {k_ev:.4f} ms, "
            f"torch.sum {lib_ev:.4f} ms [{card}]")
    return out


def phase_dropout(mb):
    """B1 with dropout against the plain version, then with all-ones inputs
    where out - x is exactly 4 where both hidden masks keep, else 0."""
    log("== phase 6: B1 with dropout against its plain version")
    err = 0.0
    B, V, K, C = 2, 32768, 128, 128
    for tile_v in (2048, 1024):
        seed = 2 ** 31 - 2 - tile_v
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            lowp = kind == "bf16"
            args = block_inputs(B, V, K, C, (128, 128), dtype, seed=tile_v)
            tag = f"dropout B={B} V={V} tile_v={tile_v} {kind}"
            out, xn, _ = b1_twice(mb, tag, args, emit_next=True, lowp=lowp,
                                  seed=seed, tile_v=tile_v)
            ref, ref_xn = mb.megablock_chained_reference(
                *args, emit_next=True, lowp=lowp, seed=seed, tile_v=tile_v)
            e = max(compare(f"{tag} out (two launches bit-identical)", out,
                            ref, TOL[kind]),
                    compare(f"{tag} x_hat_next", xn, ref_xn, TOL[kind]))
            if kind == "f32":
                err = max(err, e)
            del args, out, xn, ref, ref_xn
            # all-ones: the first layer gives 1 everywhere, the next two are
            # identities, so out - x = 2 keep_0 * 2 keep_1 exactly
            dt = dtype
            z = functools.partial(torch.zeros, device="cuda")
            Ws = [z(3 * C, C), torch.eye(C, device="cuda"),
                  torch.eye(C, device="cuda")]
            bs = [torch.ones(C, device="cuda"), z(C), z(C)]
            out, _ = mb.megablock_chained_fwd(
                z(B, V, C, dtype=dt), z(B, V, K, dtype=dt),
                z(B, V, K, dtype=dt), z(B, V, K, dtype=dt),
                torch.ones(B, V, device="cuda"), z(B, K, C), z(C, C),
                z(C, C), Ws, bs, z(B, K, C), emit_next=False, lowp=lowp,
                seed=seed, tile_v=tile_v)
            keep = [mb.dropout_masks(B, V, C, seed, layer, tile_v,
                                     device="cuda") for layer in (0, 1)]
            want = 4.0 * (keep[0] & keep[1]).float()
            same = bool(torch.equal(out.float(), want))
            log(f"  {tag} all-ones: kept {keep[0].float().mean().item():.4f} "
                f"and {keep[1].float().mean().item():.4f} of layers 0 and 1, "
                f"pattern equal to the plain masks: {same}")
            check(same, f"{tag}: dropout pattern differs from the plain masks")
    return err


def phase_backward(mb):
    """B2 and its partial-sum kernel against the plain backward; returns the
    largest f32 full-width error and a gradient-slot tensor at the main
    path's shape."""
    log("== phase 7: B2 (backward) against the plain backward")
    err = 0.0
    cases = [(2, 32768, 128, 128, (128, 128), 0, 2048, (False, True)),
             (2, 1000, 16, 8, (16, 32, 8), 100, None, (False,)),  # ragged
             (2, 1024, 16, 8, (16, 32, 8), 100, 256, (True,))]
    for B, V, K, C, hidden, n_pad, tile_v, drops in cases:
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            lowp = kind == "bf16"
            args = block_inputs(B, V, K, C, hidden, dtype, seed=V + 7 * K,
                                n_pad=n_pad)
            g = torch.Generator(device="cuda").manual_seed(V)
            dout = torch.randn(B, V, C, generator=g, device="cuda").to(dtype)
            for emit in (True, False):
                dxn = (torch.randn(B, K, C, generator=g, device="cuda")
                       if emit else None)
                for drop in drops:
                    seed = 1234567 if drop else None
                    kw = dict(lowp=lowp, seed=seed,
                              tile_v=tile_v or mb.DEFAULT_TILE_V)
                    ties = mb.relu_margin(*args, **kw) < TIE
                    targs = list(args)
                    targs[4] = args[4].masked_fill(ties, 0.0)  # mass
                    d = dout.masked_fill(ties[..., None], 0.0)
                    got = mb.megablock_chained_bwd(*targs, d, dxn, **kw)
                    torch.cuda.synchronize()
                    want = mb.megablock_chained_bwd_reference(*targs, d, dxn,
                                                              **kw)
                    torch.cuda.synchronize()
                    tag = (f"bwd B={B} V={V} K={K} C={C} hidden="
                           f"{list(hidden)} {kind} emit_next={emit} "
                           f"dropout={drop}")
                    check(got[0].dtype == dtype, f"{tag}: dx dtype")
                    names = ["dx_direct", "ds", "dA_re", "dA_im"]
                    pairs = list(zip(got[:4], want[:4]))
                    for l in range(len(got[4])):
                        names += [f"dW{l}", f"db{l}"]
                        pairs += [(got[4][l], want[4][l]),
                                  (got[5][l], want[5][l])]
                    e, worst = 0.0, (0.0, "")
                    for name, (a, b) in zip(names, pairs):
                        ea = compare(f"{tag} {name}", a, b, GRAD_TOL[kind],
                                     scaled=True, quiet=True)
                        e = max(e, ea)
                        r = ea / max(b.float().abs().max().item(), 1e-30)
                        worst = max(worst, (r, name))
                    log(f"  {tag}: {len(names)} outputs ok ("
                        + ("elementwise" if "atol" in GRAD_TOL[kind]
                           else "relative L2") + f"), largest max abs err / "
                        f"max |plain| {worst[0]:.2e} ({worst[1]}); "
                        f"{int(ties.sum())} of {B * V} rows with a ReLU input "
                        f"within {TIE} of 0 given zero cotangent")
                    if kind == "f32" and V == 32768:
                        err = max(err, e)
                    del got, want
            del args
    return err


def bwd_groups(mb, K, C, widths):
    """(name, first column, width) of each group of the rows kernel's R."""
    lay = mb.bwd_layout(K, C, widths)
    n = len(widths) - 1
    return ([(f"in{l}", lay["off_in"][l], widths[l]) for l in range(n)]
            + [(f"dpre{l}", lay["off_dp"][l], widths[l + 1])
               for l in range(n)]
            + [("gx|gy", lay["off_gg"], 2 * C), ("dvb", lay["off_dvb"], 2 * C),
               ("dxd|dgx|dgy", lay["off_ds"], 3 * C)])


def phase_b2_kernels(mb):
    """B2's rows kernel and grads kernel one at a time against their plain
    versions, at B=1, V=32768, K=128, C=128 and 256 (hidden [C, C]), f32 and
    bf16, dropout on, emit_next on. The grads kernel and its plain version
    read the rows kernel's own R, with the same split of V; its partials
    are products of the same values summed in another order in both
    types (f32 tolerance). Two launches of each kernel must give the same
    bits, and the partial sums of the grads kernel's partials equal the
    plain sums bit for bit. Returns the largest f32 errors at C = 128 and
    the parameter partials of that case (for grad_reduce's time)."""
    log("== phase 7b: B2's rows and grads kernels, each against its plain "
        "version")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {"megablock_bwd_rows": 0.0, "megablock_bwd_grads": 0.0,
            "grad_reduce": 0.0}
    kept = None
    B, V, K = 1, 32768, 128
    for C in (128, 256):
        widths = (3 * C, C, C, C)
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            lowp = kind == "bf16"
            args = list(block_inputs(B, V, K, C, (C, C), dtype, seed=C + 11))
            kw = dict(lowp=lowp, seed=4242, tile_v=2048)
            ties = mb.relu_margin(*args, **kw) < TIE
            args[4] = args[4].masked_fill(ties, 0.0)
            g = torch.Generator(device="cuda").manual_seed(C)
            dout = torch.randn(B, V, C, generator=g, device="cuda").to(
                dtype).masked_fill(ties[..., None], 0.0)
            dxn = torch.randn(B, K, C, generator=g, device="cuda")
            tag = f"B={B} V={V} K={K} C={C} hidden [{C}, {C}] {kind} dropout"
            rows = mb.megablock_bwd_rows(*args, dout, dxn, **kw)
            again = mb.megablock_bwd_rows(*args, dout, dxn, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(rows, again)),
                  f"{tag}: two launches of the rows kernel differ")
            del again
            dx, R, dbp = rows
            dx_r, R_r, dbp_r = mb.megablock_bwd_rows_reference(
                *args, dout, dxn, **kw)
            e = compare(f"{tag} rows: dx_direct", dx, dx_r, GRAD_TOL[kind],
                        scaled=True, quiet=True)
            for name, o, w in bwd_groups(mb, K, C, widths):
                e = max(e, compare(f"{tag} rows: R {name}", R[:, o:o + w],
                                   R_r[:, o:o + w], GRAD_TOL[kind],
                                   scaled=True, quiet=True))
            e = max(e, compare(f"{tag} rows: db partials", dbp, dbp_r,
                               GRAD_TOL[kind], scaled=True, quiet=True))
            log(f"  {tag} rows kernel: dx_direct, the 11 groups of R and "
                f"the db partials within tolerance ({kind}), largest max "
                f"abs err {e:.3e}; {int(ties.sum())} ReLU-tie rows given "
                f"zero cotangent; two launches bit-identical")
            del R_r, dx_r, dbp_r
            splits = mb.grads_splits(B, V, K, C, widths, sms)
            pp, pd = mb.megablock_bwd_grads(R, *args[1:4], C, widths, splits,
                                            lowp)
            pp2, pd2 = mb.megablock_bwd_grads(R, *args[1:4], C, widths,
                                              splits, lowp)
            torch.cuda.synchronize()
            check(torch.equal(pp, pp2) and torch.equal(pd, pd2),
                  f"{tag}: two launches of the grads kernel differ")
            del pp2, pd2
            pp_r, pd_r = mb.megablock_bwd_grads_reference(
                R, *args[1:4], C, widths, splits, lowp)
            eg = max(compare(f"{tag} grads: parameter partials {tuple(pp.shape)}",
                             pp, pp_r, GRAD_TOL["f32"], scaled=True),
                     compare(f"{tag} grads: ds partials {tuple(pd.shape)}",
                             pd, pd_r, GRAD_TOL["f32"], scaled=True))
            got = mb.bwd_grads_finish(pp, pd, dbp, K, C, widths)
            plain = [mb.grad_reduce_reference(pd, 0, K * C),
                     mb.grad_reduce_reference(pp.unsqueeze(0), 0, pp.shape[1]),
                     mb.grad_reduce_reference(dbp.unsqueeze(0), 0,
                                              dbp.shape[1])]
            sums = [mb.grad_reduce(pd, 0, K * C),
                    mb.grad_reduce(pp.unsqueeze(0), 0, pp.shape[1]),
                    mb.grad_reduce(dbp.unsqueeze(0), 0, dbp.shape[1])]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(sums, plain))
            log(f"  {tag} grads kernel: splits (S_par, L_par, S_ds, L_ds) "
                f"{splits}; two launches bit-identical; grad_reduce of its "
                f"partials bit-equal to the plain sums: {same}; "
                f"{len(got[3])} dW, dA, ds, {len(got[4])} db finite")
            check(same, f"{tag}: grad_reduce differs from the plain sums")
            check(all(bool(torch.isfinite(t).all()) for t in
                      [*got[:3], *got[3], *got[4]]), f"{tag}: non-finite")
            if kind == "f32" and C == 128:
                errs["megablock_bwd_rows"] = e
                errs["megablock_bwd_grads"] = eg
                kept = (args, dout, dxn, splits, pp)
            del rows, dx, R, dbp, pp, pd, pp_r, pd_r, got, sums, plain
            del args, dout
    return errs, kept


def segmentation_dataset(cache):
    """Four synthetic meshes with face labels from the face centroids:
    4 sectors of azimuth times 2 halves in z, 8 classes."""
    import numpy as np
    from diffusionnet_tpu_torch.data import SurfaceDataset
    mg = meshgen()
    icosphere, torus = mg.icosphere, mg.torus
    meshes = [("torus(144, 140)", torus(n_major=144, n_minor=140)),
              ("icosphere(5)", icosphere(subdivisions=5)),
              ("torus(96, 80)", torus(n_major=96, n_minor=80)),
              ("icosphere(4)", icosphere(subdivisions=4))]
    ds = SurfaceDataset(labels_kind="face")
    for _, (v, f) in meshes:
        c = v[f].mean(axis=1)
        sector = np.floor((np.arctan2(c[:, 1], c[:, 0]) + np.pi)
                          / (2 * np.pi) * 4).astype(np.int64) % 4
        ds.add(v, f, sector * 2 + (c[:, 2] > 0))
    t0 = time.perf_counter()
    ds.precompute(K_EIG, op_cache_dir=cache, verbose=False)
    log(f"  precompute of {', '.join(n for n, _ in meshes)} "
        f"(V = {[v.shape[0] for _, (v, _) in meshes]}): "
        f"{time.perf_counter() - t0:.2f} s")
    return ds


def step_agreement(name_a, name_b, res, before, checked, exempt=(),
                   tol=STEP_TOL, per_tensor=True, label="dropout off"):
    """Two results of one train step from the same state, res[name] =
    (loss, gradients, parameters after): the loss within STEP_TOL["loss"],
    then for each of gradients, Adam updates (parameters after minus
    before) and updated parameters the whole (all tensors as one vector)
    and each tensor (STEP_TOL's `own` of its own norm plus `whole` of the
    whole's), checked for the kinds named in `checked` and printed for the
    others. Tensors whose names contain a string of `exempt` are printed
    but left out of the Adam updates' check (their gradients stay
    checked). tol: STEP_TOL, or a wider `whole` where a phase measures its
    configuration's own sensitivity. per_tensor: print each tensor's
    difference too (it is checked either way). label: the lines' prefix."""
    (la, ga, pa), (lb, gb, pb) = res[name_a], res[name_b]
    rel = abs(la - lb) / abs(lb)
    log(f"  {label}: loss {name_a} {la:.8f}, {name_b} {lb:.8f} "
        f"(relative difference {rel:.2e}, tolerance {tol['loss']})")
    check(rel <= tol["loss"], f"loss: {name_a} and {name_b} differ")
    kinds = (("gradient", ga, gb),
             ("Adam update", {k: pa[k] - before[k].detach() for k in pa},
              {k: pb[k] - before[k].detach() for k in pb}),
             ("updated parameter", pa, pb))
    for what, a, b in kinds:
        gate = what in checked
        held = [k for k in b if what != "Adam update"
                or not any(e in k for e in exempt)]

        def norm(ks, d=lambda k: b[k]):
            return math.sqrt(sum(d(k).float().norm().item() ** 2 for k in ks))
        whole, held_whole = norm(b), norm(held)
        diff = norm(held, lambda k: a[k].float() - b[k].float())
        log(f"  {label}, {what}s ({'checked' if gate else 'not checked'}"
            f"): whole {diff / held_whole:.2e} of the whole norm "
            f"{held_whole:.3e} (tolerance {tol['whole']}"
            + (f"; {len(b) - len(held)} tensors matching {exempt} printed, "
               "not checked" if len(held) < len(b) else "")
            + "); per tensor, |difference| / |own| (own norm / whole):")
        rows, bad = [], []
        for k in b:
            own = b[k].float().norm().item()
            e = (a[k].float() - b[k].float()).norm().item()
            rows.append(f"{k.split('/', 1)[1]} {e / max(own, 1e-30):.1e} "
                        f"({own / whole:.1e})")
            if k in held and e > (tol["own"] * own
                                  + tol["whole"] * held_whole):
                bad.append(k)
        for i in range(0, len(rows) if per_tensor else 0, 4):
            log("    " + "; ".join(rows[i:i + 4]))
        if gate:
            check(diff <= tol["whole"] * held_whole,
                  f"{what}s as a whole")
            check(not bad, f"{what}s of {bad} past their tolerance")


def phase_train(mb):
    """The training slice on the card. Returns the launch counts of its five
    steps, the torus's operators (for the bench-shape step), the batch and
    the dataset."""
    from diffusionnet_tpu_torch.data import make_padded_batches
    from diffusionnet_tpu_torch.models import DiffusionNet, flat_params
    from diffusionnet_tpu_torch.training import (
        TaskConfig, adam_state_from_flat, adam_state_to_flat,
        adam_with_step_decay, apply_model, loss_and_counts, make_train_step)

    log("== phase 8: the training slice, 5 Adam steps of the segmentation "
        "model on cuda")
    with tempfile.TemporaryDirectory() as cache:
        ds = segmentation_dataset(cache)
    batch = next(make_padded_batches(ds, 4)).to("cuda")
    B, V = batch.verts.shape[:2]
    check((B, V) == (4, 32768), f"batch shape {(B, V)}")
    model = DiffusionNet(**SEG_MODEL, generator=torch.Generator().manual_seed(0),
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    params = flat_params(model, "cuda", requires_grad=True)
    cfg = TaskConfig(input_features="hks", labels_kind="face")
    opt = adam_with_step_decay(1e-3, 50, 0.5)
    state = opt.init(params)

    def make_step(c, deterministic, m=model):
        return make_train_step(
            lambda p, b, g: loss_and_counts(
                apply_model(m, p, b, g, c, deterministic), b, c), opt)
    step = make_step(cfg, False)
    before = {k: v.detach().clone() for k, v in params.items()}
    gen = torch.Generator().manual_seed(1)
    torch.cuda.synchronize()
    mb.reset_launches()
    losses = []
    for i in range(5):
        t0 = time.perf_counter()
        _, _, loss, (correct, total) = step(params, state, batch, gen)
        losses.append(loss.item())
        log(f"  step {i}: loss {losses[-1]:.6f}, correct {int(correct)} of "
            f"{int(total)} faces, {1e3 * (time.perf_counter() - t0):.1f} ms")
    launches = dict(mb.LAUNCHES)
    per_step = B2_PER_STEP
    log(f"  launches in 5 steps: {launches}")
    check(launches == {k: 5 * v for k, v in per_step.items()},
          f"launches {launches} != 5 x {per_step}")
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    still = [k for k in params if torch.equal(params[k].detach(), before[k])]
    check(not still, f"parameters that did not move: {still}")

    # one more step with dropout off, from the same state, through the fast
    # path and through the eager model with autograd on the dense route
    flat_state = adam_state_to_flat(state)
    res = {}
    dense = dense_route(model)
    for name, use_mk in (("fast path", True), ("eager model", False)):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        s = adam_state_from_flat(opt.init(p), flat_state)
        c = TaskConfig(input_features="hks", labels_kind="face",
                       use_megakernel=use_mk)
        one = make_step(c, True, model if use_mk else dense)
        _, _, loss, _ = (one(p, s, batch, None) if use_mk else without_b4(
            lambda: one(p, s, batch, None), "phase 8's eager step"))
        res[name] = (loss.item(), {k: v.grad for k, v in p.items()},
                     {k: v.detach() for k, v in p.items()})
    step_agreement("fast path", "eager model", res, params,
                   checked=("gradient", "Adam update"))
    return launches, ds.ops_list[0], ds.verts_list[0], batch, ds


def phase_wide_times(mb, card):
    """B1 and B2 at C = 256 (B=1, V=32768, emit_next), f32 and bf16, beside
    their plain versions and bounds: hidden [256, 256] at K 128 and 256,
    the sampling_invariance model's widths; hidden [1024, 1024] at K 128,
    the earlier wide route's shape, on the row kernel with the hidden
    layers spilled. B1 is first held to its plain version, two launches
    bit-identical. Returns the times by (K, hidden[0], kind)."""
    log("== phase 9b: B1 and B2 at C = 256, hidden [256, 256] and [1024, "
        "1024] (CUDA events, median of 10 runs of 10 calls)")
    out = {}
    for K, hidden in ((128, (256, 256)), (256, (256, 256)),
                      (128, (1024, 1024))):
        widths = (768, *hidden, 256)
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            lowp = kind == "bf16"
            args = block_inputs(1, 32768, K, 256, hidden, dtype, seed=K)
            layout, want = b1_launches(mb, 256, hidden, lowp, True)
            tag = (f"B=1 V=32768 K={K} C=256 hidden {list(hidden)} {kind} "
                   f"({layout_name(layout)})")
            o, xn, got = b1_twice(mb, tag, args, lowp=lowp)
            check(got == want, f"{tag}: launches {got} != {want}")
            ref, ref_xn = mb.megablock_chained_reference(*args, lowp=lowp)
            compare(f"{tag} out (two launches bit-identical)", o, ref,
                    TOL[kind])
            compare(f"{tag} x_hat_next", xn, ref_xn, TOL[kind])
            del o, xn, ref, ref_xn
            f = time_ms(lambda: mb.megablock_chained_fwd(*args, lowp=lowp))
            fp = time_ms(lambda: mb.megablock_chained_reference(*args,
                                                               lowp=lowp))
            fb = megablock_bound(1, 32768, K, 256, widths, True, False, lowp)
            g = torch.Generator(device="cuda").manual_seed(4)
            dout = torch.randn(1, 32768, 256, generator=g, device="cuda").to(
                dtype)
            dxn = torch.randn(1, K, 256, generator=g, device="cuda")
            b = time_ms(lambda: mb.megablock_chained_bwd(*args, dout, dxn,
                                                         lowp=lowp))
            bp = time_ms(lambda: mb.megablock_chained_bwd_reference(
                *args, dout, dxn, lowp=lowp), reps=3)
            bb = megablock_bound(1, 32768, K, 256, widths, True, True, lowp)
            out[(K, hidden[0], kind)] = dict(fwd=(f, fp, fb), bwd=(b, bp, bb))
            log(f"  time {tag}: "
                f"B1 {f:.4f} ms (plain {fp:.4f}, bound {fb[0]:.4f} ms, "
                f"{fb[1]}, share {fb[0] / f:.3f}); B2 {b:.4f} ms (plain "
                f"{bp:.4f}, bound {bb[0]:.4f} ms, {bb[1]}, share "
                f"{bb[0] / b:.3f}) [{card}]")
            del args, dout, dxn
    return out


def b2_bounds(B, V, K, C, widths, lowp, emit_next=True):
    """Least times of B2's two kernels, splitting megablock_bound's backward
    count. rows: the forward recompute up to the last layer's input (3 2KC,
    8C^2, the MLP but its last layer), 2KC for m Phi dx_hat, the MLP's
    backward products d = dpre W^T (2 sum w_l w_l+1) and dvb cmap^T (8C^2);
    bytes x, dout and dx, Phi, GX, GY and mass once, and R written once
    (and, under lowp, its f32 side scratch). grads: the V-reductions dW
    (2 sum w_l w_l+1), P (8C^2) and ds (3 2KC); bytes R and the operators
    read once. Operations at three TF32 passes (f32) or the bf16 rate."""
    mlp = [2 * a * b for a, b in zip(widths[:-1], widths[1:])]
    xb = 2 if lowp else 4
    peak = BF16_FLOPS if lowp else TF32_FLOPS / 3
    r_vals = 3 * C + sum(widths[1:-1]) + sum(widths[1:]) + 7 * C
    rows_flops = (6 * K * C + (2 * K * C if emit_next else 0) + 16 * C * C
                  + sum(mlp[:-1]) + sum(mlp))
    rows_bytes = (3 * C + 3 * K + r_vals) * xb + 4 + (24 * C if lowp else 0)
    grads_flops = sum(mlp) + 8 * C * C + 6 * K * C
    grads_bytes = (r_vals + 3 * K) * xb
    return (bound(B * V * rows_bytes, B * V * rows_flops, peak),
            bound(B * V * grads_bytes, B * V * grads_flops, peak))


def phase_bwd_times(mb, card):
    """B2's time, end to end and kernel by kernel: the rows kernel, the
    grads kernel on its R and the three partial sums, each beside its plain
    version and bound (K = C = 128, hidden [128, 128], emit_next)."""
    log("== phase 9: times (CUDA events, median of 10 runs of 10 calls)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    widths = (384, 128, 128, 128)
    ms = {}
    for B, V in ((1, 32768), (BENCH_B, BENCH_V)):
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            lowp = kind == "bf16"
            args = block_inputs(B, V, 128, 128, (128, 128), dtype, seed=B)
            g = torch.Generator(device="cuda").manual_seed(3)
            dout = torch.randn(B, V, 128, generator=g, device="cuda").to(dtype)
            dxn = torch.randn(B, 128, 128, generator=g, device="cuda")
            k = time_ms(lambda: mb.megablock_chained_bwd(*args, dout, dxn,
                                                         lowp=lowp))
            p = time_ms(lambda: mb.megablock_chained_bwd_reference(
                *args, dout, dxn, lowp=lowp))
            rows = lambda: mb.megablock_bwd_rows(*args, dout, dxn, lowp=lowp)
            rk = time_ms(rows)
            rp = time_ms(lambda: mb.megablock_bwd_rows_reference(
                *args, dout, dxn, lowp=lowp), reps=3)
            _, R, dbp = rows()
            splits = mb.grads_splits(B, V, 128, 128, widths, sms)
            grads = lambda: mb.megablock_bwd_grads(R, *args[1:4], 128, widths,
                                                   splits, lowp)
            gk = time_ms(grads)
            gp = time_ms(lambda: mb.megablock_bwd_grads_reference(
                R, *args[1:4], 128, widths, splits, lowp), reps=3)
            pp, pd = grads()
            sums = lambda: (mb.grad_reduce(pd, 0, 128 * 128),
                            mb.grad_reduce(pp.unsqueeze(0), 0, pp.shape[1]),
                            mb.grad_reduce(dbp.unsqueeze(0), 0, dbp.shape[1]))
            sk = device_ms(sums)
            sp = device_ms(lambda: (
                mb.grad_reduce_reference(pd, 0, 128 * 128),
                mb.grad_reduce_reference(pp.unsqueeze(0), 0, pp.shape[1]),
                mb.grad_reduce_reference(dbp.unsqueeze(0), 0, dbp.shape[1])))
            rb, gb = b2_bounds(B, V, 128, 128, widths, lowp)
            sb = bound(4 * (pp.numel() + pp.shape[1] + pd.numel() + B * 128
                            * 128 + dbp.numel() + dbp.shape[1]),
                       pp.numel() + pd.numel() + dbp.numel(), F32_FLOPS)
            ms[(B, V, kind)] = dict(total=(k, p), rows=(rk, rp, rb),
                                    grads=(gk, gp, gb), sums=(sk, sp, sb))
            log(f"  time megablock_chained_bwd emit_next B={B} V={V} K=128 "
                f"C=128 {kind}: kernels {k:.4f} ms, plain {p:.4f} ms; rows "
                f"kernel {rk:.4f} ms (plain {rp:.4f}, bound {rb[0]:.4f} ms, "
                f"{rb[1]}, share {rb[0] / rk:.3f}), grads kernel {gk:.4f} ms "
                f"(plain {gp:.4f}, bound {gb[0]:.4f} ms, {gb[1]}, share "
                f"{gb[0] / gk:.3f}; splits {splits}), the three partial sums "
                f"{sk:.4f} ms device (plain {sp:.4f}, bound {sb[0]:.4f} ms) "
                f"[{card}]")
            if B == 1:
                tag = f"B1 with dropout B=1 V={V} {kind}"
                out, xn, _ = b1_twice(mb, tag, args, lowp=lowp, seed=5,
                                      tile_v=2048)
                ref, ref_xn = mb.megablock_chained_reference(
                    *args, lowp=lowp, seed=5, tile_v=2048)
                compare(f"{tag} out (two launches bit-identical)", out, ref,
                        TOL[kind])
                compare(f"{tag} x_hat_next", xn, ref_xn, TOL[kind])
                del out, xn, ref, ref_xn
                on = time_ms(lambda: mb.megablock_chained_fwd(
                    *args, lowp=lowp, seed=5, tile_v=2048))
                off = time_ms(lambda: mb.megablock_chained_fwd(*args,
                                                               lowp=lowp))
                log(f"  time megablock_chained emit_next B=1 V={V} {kind}: "
                    f"dropout on {on:.4f} ms, off {off:.4f} ms [{card}]")
            del args, dout, dxn, R, dbp, pp, pd
    return ms


def phase_step_times(mb, card, torus_ops, torus_verts, profiled=True):
    """The whole train step at bench.py's shapes: B=8 copies of the torus
    padded to V=20480, k 128, 4 blocks of width 128, c_in 3 (xyz), c_out 8,
    dropout off, vertex outputs, the masked sum-of-squares loss. Returns
    the ms per step and the peak device memory of a step (GiB,
    torch.cuda.max_memory_allocated), f32 and bf16 operands; profiled: also
    a profiler breakdown of three steps."""
    import numpy as np
    from diffusionnet_tpu_torch.geometry import stack_operators
    from diffusionnet_tpu_torch.models import (DiffusionNet, flat_params,
                                               megablock_apply)
    from diffusionnet_tpu_torch.training import (adam_with_step_decay,
                                                 make_train_step)
    from torch.profiler import ProfilerActivity, profile

    ops = stack_operators([torus_ops] * BENCH_B, v_pad=BENCH_V).to("cuda")
    x = np.zeros((BENCH_B, BENCH_V, 3), np.float32)
    x[:, :torus_verts.shape[0]] = torus_verts
    x = torch.from_numpy(x).cuda()
    mask = (ops.mass > 0)[..., None]
    model = DiffusionNet(c_in=3, c_out=8, c_width=128, n_block=N_BLOCK,
                         dropout=False,
                         generator=torch.Generator().manual_seed(2))
    step_ms = {}
    for kind in ("f32", "bf16"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        consts = [t.to(dt) for t in (x, ops.evecs, ops.gradX_spec,
                                     ops.gradY_spec)]
        params = flat_params(model, "cuda", requires_grad=True)
        opt = adam_with_step_decay(1e-3)

        def loss_fn(p, batch, g):
            out = megablock_apply(p, consts[0], ops.mass, ops.evals,
                                  *consts[1:], n_block=N_BLOCK,
                                  tile_v=2048).float()
            return ((out * mask) ** 2).sum() / mask.sum(), None
        step = make_train_step(loss_fn, opt)
        state = opt.init(params)
        t = time_ms(lambda: step(params, state, None, None), reps=5)
        step_ms[kind] = t
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(params, state, None, None)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms[kind + " peak GiB"] = peak
        log(f"  time train step B={BENCH_B} V={BENCH_V} K=128 4x128 {kind} "
            f"operands: {t:.3f} ms per step, {BENCH_B / (t / 1e3):.1f} "
            f"meshes/s; peak device memory of a step {peak:.3f} GiB "
            f"[{card}]")
        if not profiled:
            del params, state, consts
            continue
        # where a step's time goes: three steps under the profiler
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                step(params, state, None, None)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
        groups = {"B1 rows": 0.0, "B1 x_hat": 0.0, "B2 rows": 0.0,
                  "B2 grads": 0.0, "reduces": 0.0, "Adam": 0.0, "other": 0.0}
        top = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = us if us is not None else e.self_cuda_time_total
            name = e.key
            top.append((us, name))
            if "megablock_fwd_rows_kernel" in name:
                groups["B1 rows"] += us
            elif "megablock_fwd_xhat_kernel" in name:
                groups["B1 x_hat"] += us
            elif "megablock_bwd_rows_kernel" in name:
                groups["B2 rows"] += us
            elif "megablock_bwd_grads_kernel" in name:
                groups["B2 grads"] += us
            elif "reduce_kernel" in name and ("xhat" in name or "grad" in name):
                groups["reduces"] += us
            elif "adam" in name.lower() or "multi_tensor" in name:
                groups["Adam"] += us
            else:
                groups["other"] += us
        busy = sum(groups.values()) / 3 / 1e3
        log(f"  profile {kind}: wall {wall:.3f} ms per step, device busy "
            f"{busy:.3f} ms (idle share {1 - busy / wall:.4f}); per step: "
            + ", ".join(f"{k} {v / 3 / 1e3:.3f} ms" for k, v in groups.items()))
        for us, name in sorted(top, reverse=True)[:8]:
            log(f"    {us / 3 / 1e3:9.3f} ms  {name[:100]}")
        del params, state, consts
    return step_ms


# --- B5 and the device eigensolver (phases 10-12) ---------------------------

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM rate, f32 outside
# the tensor cores, TF32 on them (f32-accurate products take three TF32
# passes, as B1 and B2 run them). Bounds below are against these, at the
# card's power limit printed beside them.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
B5_TOL = 5e-6      # B5 against its plain version, times max |plain|: f32
                   # sums of a row's products in the same order, fused
                   # multiply-adds against a multiply and an add
C_SUBSPACE = 160   # the solver's block width at k_eig = 128 (k + k // 4)
ROT_TOL = 1e-6     # device vectors of a cut eigen-cluster inside ARPACK's:
                   # the certified f64 residuals put them there to ~1e-8


def bound(n_bytes, flops, peak):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over `peak`."""
    tb, to = n_bytes / HBM_BYTES_S, flops / peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def megablock_bound(B, V, K, C, widths, emit_next, backward, lowp=False):
    """B1's (or B2's) least time: operations counted from the code (the
    block's products, per vertex: Phi s, GX s, GY s 3 * 2KC; the complex
    map 8C^2; the MLP 2 sum w_l w_l+1; x_hat_next 2KC. B2 recomputes the
    forward up to the last layer, then the MLP's two products per layer,
    16C^2 for the complex map, 3 * 2KC for ds and 2KC for m Phi dx_hat),
    at three TF32 passes (f32) or the bf16 rate; bytes: x, Phi, GX, GY,
    mass, out (and dout, dx) once."""
    mlp = [2 * a * b for a, b in zip(widths[:-1], widths[1:])]
    fwd = 6 * K * C + 8 * C * C + sum(mlp)
    if backward:
        flops = (fwd - mlp[-1] + 2 * sum(mlp) + 16 * C * C + 6 * K * C
                 + (2 * K * C if emit_next else 0))
        rows = 3 * C * (2 if lowp else 4) + 3 * K * (2 if lowp else 4) + 4
    else:
        flops = fwd + (2 * K * C if emit_next else 0)
        rows = 2 * C * (2 if lowp else 4) + 3 * K * (2 if lowp else 4) + 4
    peak = BF16_FLOPS if lowp else TF32_FLOPS / 3
    return bound(B * V * rows, B * V * flops, peak)


def b5_bound(nnz, V, C):
    """B5's least time: what the matrix needs (CSR values, column indices,
    row pointers), x read once and y written once; 2 nnz C operations at
    the f32 rate."""
    return bound(nnz * 8 + (V + 1) * 4 + 2 * V * C * 4, 2 * nnz * C,
                 F32_FLOPS)


def b5_meshes():
    mg = meshgen()
    return [("torus(144, 140)", mg.torus(n_major=144, n_minor=140)),
            ("delaunay_sphere(100000)", mg.delaunay_sphere(100_000))]


def hub_matrix(V=700, hub=600):
    """A symmetric matrix with one hub row of degree > hub (a slice that
    wide), a path, and 60 empty rows: B5's widest-slice case."""
    import numpy as np
    import scipy.sparse
    rs = np.random.RandomState(0)
    nbrs = rs.choice(np.arange(1, V - 60), hub, replace=False)
    path = np.arange(1, V - 60)
    r = np.concatenate([np.zeros(hub, np.int64), path[:-1]])
    c = np.concatenate([nbrs, path[1:]])
    A = scipy.sparse.coo_matrix((rs.rand(r.size) + 0.1, (r, c)),
                                shape=(V, V))
    A = A + A.T
    return scipy.sparse.csr_matrix(
        scipy.sparse.diags(np.asarray(A.sum(1)).ravel()) - A)


def phase_b5(be, lap):
    """B5 against its plain version, and bit-identical across launches.
    Returns the largest max abs error at the main path's width (C = 160)."""
    log("== phase 10: B5 (sliced-ELL SpMM) against its plain version")
    err = 0.0
    for name, L in lap + [("hub matrix", hub_matrix())]:
        V = L.shape[0]
        b = be.blocked_ell_from_sparse(L, device="cuda")
        w = b.widths().float()
        log(f"  {name}: V={V} nnz={L.nnz}: n_pad {b.n_pad}, {b.n_slices} "
            f"slices of 32 rows, width mean {w.mean().item():.3f} max "
            f"{int(w.max().item())}, slots per nonzero "
            f"{b.cols.numel() / L.nnz:.3f}; format {b.nbytes() / 1e6:.3f} "
            f"MB against {b.n_pad * 8 * 128 * 4 / 1e6:.1f} MB of the dense "
            "panels it replaced (n_pad x 8 x 128 x 4 bytes)")
        g = torch.Generator(device="cuda").manual_seed(V)
        for C in (C_SUBSPACE, 96, 97):
            x = torch.zeros(b.n_pad, C, device="cuda")
            x[:V] = torch.randn(V, C, generator=g, device="cuda")
            be.reset_launches()
            y = be.blocked_ell_matvec(b, x)
            again = be.blocked_ell_matvec(b, x)
            torch.cuda.synchronize()
            check(be.LAUNCHES["blocked_ell"] == 2,
                  f"B5 launches {be.LAUNCHES}")
            check(torch.equal(y, again), f"{name} C={C}: two launches differ")
            ref = be.blocked_ell_matvec_reference(b, x)
            torch.cuda.synchronize()
            e = compare(f"{name} C={C} (bit-identical over two launches)", y,
                        ref, dict(rtol=0.0, atol=B5_TOL), scaled=True)
            pad = y[V:].abs().max().item() if b.n_pad > V else 0.0
            check(pad == 0.0, f"{name}: padded rows {pad}")
            if C == C_SUBSPACE and name != "hub matrix":
                err = max(err, e)
            del x, y, again, ref
        del b
    return err


def phase_b5_times(be, lap, card):
    """B5, its plain version and torch.sparse.mm (cuSPARSE CSR SpMM, a
    yardstick only) on the same permuted matrix at C = 160."""
    import scipy.sparse
    log("== phase 11: B5 times (device time: median of 5 runs of 20 calls "
        "queued behind a spin kernel; and CUDA events), C = 160")
    rows = {}
    for name, L in lap:
        V, C = L.shape[0], C_SUBSPACE
        b = be.blocked_ell_from_sparse(L, device="cuda")
        Lp = scipy.sparse.csr_matrix(L)[b.perm][:, b.perm].astype("float32")
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(Lp.indptr.astype("int64")),
            torch.from_numpy(Lp.indices.astype("int64")),
            torch.from_numpy(Lp.data), size=Lp.shape).to("cuda")
        g = torch.Generator(device="cuda").manual_seed(11)
        x = torch.zeros(b.n_pad, C, device="cuda")
        x[:V] = torch.randn(V, C, generator=g, device="cuda")
        xv = x[:V].contiguous()
        lib_y = torch.sparse.mm(csr, xv)
        y = be.blocked_ell_matvec(b, x)
        torch.cuda.synchronize()
        compare(f"{name} torch.sparse.mm against B5", lib_y, y[:V],
                dict(rtol=0.0, atol=B5_TOL), scaled=True)
        def kern():
            return be.blocked_ell_matvec(b, x)
        def lib_mm():
            return torch.sparse.mm(csr, xv)
        k, lib = device_ms(kern), device_ms(lib_mm)
        p = device_ms(lambda: be.blocked_ell_matvec_reference(b, x))
        k_ev, lib_ev = time_ms(kern), time_ms(lib_mm)
        bms, by = b5_bound(Lp.nnz, V, C)
        rows[name] = dict(ms=k, plain_ms=p, library_ms=lib, bound_ms=bms,
                          bound_by=by)
        log(f"  time B5 {name} V={V} nnz={Lp.nnz} C={C}, device time: "
            f"kernel {k:.4f} ms, plain {p:.4f} ms, torch.sparse.mm CSR "
            f"{lib:.4f} ms ({lib / k:.2f}x the kernel's time); bound "
            f"{bms:.4f} ms ({by}), roofline share {bms / k:.4f}; CUDA "
            f"events around back-to-back calls: kernel {k_ev:.4f} ms, "
            f"torch.sparse.mm {lib_ev:.4f} ms [{card}]")
        del b, csr, x, xv, y, lib_y
    return rows


def _cluster_closed_cut(ev, k):
    """The largest j <= k preceded by a relative gap >= 1e-3 (the subspace
    of the first j pairs is then well defined)."""
    gaps = (ev[1:k] - ev[:k - 1]) / max(ev[k - 1], 1e-12)
    closed = [i + 1 for i in range(k - 1) if gaps[i] >= 1e-3]
    return closed[-1] if closed else 0


def _angle_err(A, B, mass):
    import numpy as np
    s = np.linalg.svd(A.T @ (mass[:, None] * B), compute_uv=False)
    return float(np.abs(s - 1).max())


def _host_reference_cache(ops_mod, verts, faces, dev_ops, cache):
    """A cache entry of host-ARPACK operators for a session, with the basis
    of the eigenvalue cluster that k = K_EIG cuts (both test meshes have
    one: an exactly degenerate eigenspace of which the truncation keeps a
    part) rotated to the device basis' choice of that part. The model is
    invariant to signs and to rotations within whole degenerate clusters,
    but not within a cut one, where any basis is as right as another
    (a random rotation there moves the predictions by 0.4-1.7% of their
    max on these meshes). The device vectors must lie in the ARPACK
    cluster: the singular values of their M-products with it are held to
    1 - ROT_TOL. Returns (the cluster, those singular values)."""
    import numpy as np
    kk = K_EIG + 8
    host, sparse_mats = ops_mod.compute_operators(
        verts, faces, kk, eigensolver="host", _return_sparse=True)
    ev = host.evals.astype(np.float64)
    E = host.evecs.astype(np.float64)
    lam = ev[K_EIG - 1]
    members = np.nonzero(np.abs(ev - lam) <= 1e-6 * lam)[0]
    lo, hi = int(members.min()), int(members.max())
    check(hi < kk - 1, "the cut cluster reaches past the host basis")
    evecs = E[:, :K_EIG].copy()
    s = np.ones(1)
    if hi >= K_EIG:
        H = E[:, lo:hi + 1]
        D = dev_ops.evecs[:, lo:K_EIG].astype(np.float64)
        mass = host.mass.astype(np.float64)
        U, s, Vt = np.linalg.svd(H.T @ (mass[:, None] * D),
                                 full_matrices=False)
        check(float(s.min()) >= 1.0 - ROT_TOL,
              f"device vectors {lo}..{K_EIG - 1} leave the ARPACK cluster "
              f"{lo}..{hi}: smallest singular value {float(s.min()):.9f}")
        evecs[:, lo:K_EIG] = H @ (U @ Vt)
    evecs = evecs.astype(np.float32)
    gX, gY = ops_mod.spectral_gradients(sparse_mats[1], sparse_mats[2],
                                        evecs)
    ref = host._replace(evals=host.evals[:K_EIG], evecs=evecs,
                        gradX_spec=gX, gradY_spec=gY)
    _write_entry(ops_mod, cache, verts, faces, ref, sparse_mats)
    return (lo, hi), s


def _write_entry(ops_mod, cache, verts, faces, ops, sparse_mats):
    """Write `ops` as get_operators' cache entry of this mesh."""
    import numpy as np
    from diffusionnet_tpu_torch import utils
    utils.ensure_dir_exists(cache)
    key = utils.hash_arrays((np.asarray(verts, np.float32),
                             np.asarray(faces, np.int64)))
    ops_mod._write_cache(os.path.join(cache, f"{key}_0.npz"),
                         np.asarray(verts, np.float64),
                         np.asarray(faces, np.int64),
                         ops.evals.shape[0], ops, sparse_mats)


def phase_precompute(be, card):
    """The slice of this phase: the cold operator precompute with the
    device eigensolver on the card. Returns B5's launches in it."""
    import warnings
    import numpy as np
    from diffusionnet_tpu_torch.geometry import eigen as eig
    from diffusionnet_tpu_torch.geometry import operators as ops_mod
    from diffusionnet_tpu_torch.training import InferenceSession
    mg = meshgen()
    log("== phase 12: the precompute slice, get_operators(k_eig=128, "
        "eigensolver='device') on cuda")
    meshes = [("torus(144, 140)", mg.torus(n_major=144, n_minor=140)),
              ("icosphere(5)", mg.icosphere(subdivisions=5)),
              ("delaunay_sphere(100000)", mg.delaunay_sphere(100_000))]
    dev_ops = {}
    with tempfile.TemporaryDirectory() as cache:
        torch.cuda.synchronize()
        be.reset_launches()
        for i, (name, (verts, faces)) in enumerate(meshes):
            before = be.LAUNCHES["blocked_ell"]
            fallbacks = ops_mod.EIGEN_FALLBACKS
            tm = {}
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ops = ops_mod.get_operators(verts, faces, k_eig=K_EIG,
                                            op_cache_dir=cache,
                                            eigensolver="device", timings=tm)
            wall = time.perf_counter() - t0
            rise = be.LAUNCHES["blocked_ell"] - before
            fell = ops_mod.EIGEN_FALLBACKS - fallbacks
            dev_ops[name] = ops
            log(f"  {name}: V={verts.shape[0]}: cold precompute {wall:.3f} s "
                f"[{card}], B5 launches {rise}, fallbacks to ARPACK {fell}; "
                "stages (s): "
                + ", ".join(f"{k} {v:.3f}" for k, v in tm.items()))
            log(f"    {name}: eigen_band_build "
                f"{tm.get('eigen_band_build', 0.0):.3f} s, eigen_sweeps "
                f"{tm.get('eigen_sweeps', 0.0):.3f} s, B5 launches {rise} "
                f"[{card}]")
            log(f"    converge: {eig.LAST_CONVERGE_INFO}")
            for w in caught:
                log(f"    warning: {w.message}")
            check(rise > 0, f"{name}: B5 did not launch")
            if i < 2:
                check(fell == 0, f"{name}: the device solve fell back to "
                      "ARPACK")
            check(ops.evecs.shape == (verts.shape[0], K_EIG)
                  and bool(np.isfinite(ops.evecs).all())
                  and bool(np.isfinite(ops.evals).all()),
                  f"{name}: operators not finite or misshapen")
        launches = be.LAUNCHES["blocked_ell"]

    model = segmentation_model()
    for i, (name, (verts, faces)) in enumerate(meshes):
        d = dev_ops[name]
        t0 = time.perf_counter()
        host, host_sparse = ops_mod.compute_operators(
            verts, faces, K_EIG, eigensolver="host", _return_sparse=True)
        host_s = time.perf_counter() - t0
        ev_err = float(np.abs(d.evals.astype(np.float64) - host.evals).max()
                       / host.evals.max())
        ev_h = host.evals.astype(np.float64)
        j = _cluster_closed_cut(ev_h, K_EIG)
        ang = _angle_err(d.evecs[:, :j].astype(np.float64),
                         host.evecs[:, :j].astype(np.float64),
                         host.mass.astype(np.float64))
        log(f"  {name}: host ARPACK cold precompute {host_s:.3f} s [{card}]; "
            f"evals max |device - host| / max {ev_err:.3e} (tolerance 1e-6); "
            f"principal angles on the cluster-closed cut j={j}: "
            f"max |s - 1| {ang:.3e} (tolerance 1e-6)")
        check(ev_err <= 1e-6, f"{name}: eigenvalues off ARPACK")
        check(ang <= 1e-6, f"{name}: subspace off ARPACK")
        if i == 2:  # the session requests run on the two smaller meshes
            continue

        with tempfile.TemporaryDirectory() as tmp:
            sess = InferenceSession(model, k_eig=K_EIG,
                                    op_cache_dir=os.path.join(tmp, "cold"),
                                    use_megakernel=True)
            be.reset_launches()
            p_dev = sess(verts, faces)
            cold_launches = be.LAUNCHES["blocked_ell"]
            cold_s = sess.timings["precompute_s"]
            check(cold_launches > 0, f"{name}: the cold request ran no B5")
            sess_ops = ops_mod.get_operators(
                verts, faces, K_EIG, op_cache_dir=os.path.join(tmp, "cold"))
            (lo, hi), s = _host_reference_cache(
                ops_mod, verts, faces, sess_ops, os.path.join(tmp, "host"))
            ref = InferenceSession(model, k_eig=K_EIG,
                                   op_cache_dir=os.path.join(tmp, "host"),
                                   use_megakernel=True)
            p_ref = ref(verts, faces)
            _write_entry(ops_mod, os.path.join(tmp, "raw"), verts, faces,
                         host, host_sparse)
            raw = InferenceSession(model, k_eig=K_EIG,
                                   op_cache_dir=os.path.join(tmp, "raw"),
                                   use_megakernel=True)
            p_raw = raw(verts, faces)
        scale = float(np.abs(p_ref).max())
        diff = float(np.abs(p_dev - p_ref).max())
        raw_diff = float(np.abs(p_dev - p_raw).max())
        log(f"  {name}: cold InferenceSession request on cuda "
            f"(precompute {cold_s:.3f} s, {cold_launches} B5 launches): "
            f"predictions {p_dev.shape}, max |device - ARPACK| / max "
            f"{diff / scale:.3e} (tolerance 1e-3), with the cut cluster "
            f"{lo}..{hi} of ARPACK rotated to the device's choice (device "
            f"vectors inside the ARPACK cluster: singular values "
            f"{float(s.min()):.9f}..{float(s.max()):.9f}); against raw "
            f"ARPACK operators {raw_diff / scale:.3e}")
        check(bool(np.isfinite(p_dev).all()), f"{name}: non-finite outputs")
        check(diff <= 1e-3 * scale, f"{name}: predictions off ARPACK's")
    return launches


# --- B4 (the fused spectral block) and B3 (the one-block op): phases 13-15 --

def fused_inputs(B, V, K, C, x_dtype, seed, n_pad=0):
    """Random inputs of the fused block on the card (f32 operators); the
    last n_pad rows are bucket padding."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, V, C, generator=g, device="cuda").to(x_dtype)
    ops = [torch.randn(B, V, K, generator=g, device="cuda") * V ** -0.5
           for _ in range(3)]
    mass = torch.rand(B, V, generator=g, device="cuda")
    if n_pad:
        for t in (*ops, mass):
            t[:, V - n_pad:] = 0
    coefs = torch.rand(B, K, C, generator=g, device="cuda")
    return (x, *ops, mass, coefs)


def phase_b4_b3(mb, fu):
    """B4's two kernels and B3 against their plain versions. Returns the
    largest f32 full-width errors."""
    log("== phase 13: B4 (spectral_project, xhat_reduce, spectral_apply) "
        "and B3 (megablock) against their plain versions")
    errs = {"spectral_project": 0.0, "spectral_apply": 0.0, "spectral_ds": 0.0,
            "megablock": 0.0}
    f32, bf16 = torch.float32, torch.bfloat16
    for B, V, K, C, tile, n_pad in ((4, 32768, 128, 128, 1024, 0),
                                    (1, 32768, 128, 128, 1024, 0),
                                    (2, 1000, 128, 128, 8, 100),
                                    (2, 1000, 16, 8, 8, 100)):
        for kind, dt, ops_dt in (("f32", f32, f32), ("bf16 x", bf16, f32),
                                 ("bf16 operators", bf16, bf16)):
            x, evecs, gX, gY, mass, coefs = fused_inputs(B, V, K, C, dt,
                                                         seed=V + K,
                                                         n_pad=n_pad)
            evecs, gX, gY = (t.to(ops_dt) for t in (evecs, gX, gY))
            tag = f"B={B} V={V} K={K} C={C} tile_v={tile} {kind}"
            x_hat = fu.spectral_project(x, evecs, mass)
            outs = fu.spectral_apply(x_hat, coefs, evecs, gX, gY, x.dtype)
            again = (fu.spectral_project(x, evecs, mass),
                     *fu.spectral_apply(x_hat, coefs, evecs, gX, gY,
                                        x.dtype))
            whole = fu.fused_spectral_block_batched(x, evecs, gX, gY, mass,
                                                    coefs, tile)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b)
                      for a, b in zip((x_hat, *outs), again)),
                  f"{tag}: two launches of B4's kernels differ")
            e = compare(f"{tag} x_hat", x_hat,
                        fu.spectral_project_reference(x, evecs, mass),
                        TOL["f32"])
            refs = fu.spectral_apply_reference(x_hat, coefs, evecs, gX, gY,
                                               x.dtype)
            lowp = dt == bf16
            tol = B4_BF16_TOL if lowp else TOL["f32"]
            ea = 0.0
            for name, a, b in zip(("y", "ygx", "ygy"), outs, refs):
                check(a.dtype == x.dtype and a.shape == b.shape,
                      f"{tag} {name}: dtype/shape")
                ea = max(ea, compare(f"{tag} {name}", a, b, tol, scaled=lowp))
            for name, a, b in zip(("y", "ygx", "ygy"), whole,
                                  fu.fused_spectral_block_reference(
                                      x, evecs, gX, gY, mass, coefs)):
                compare(f"{tag} whole function {name}", a, b, tol,
                        scaled=lowp, quiet=True)
            # B3's projection on bf16 operators (the op takes any x)
            ev16 = evecs.to(bf16)
            lp = fu.spectral_project(x, ev16, mass, lowp=True)
            check(torch.equal(lp, fu.spectral_project(x, ev16, mass,
                                                      lowp=True)),
                  f"{tag}: two launches of the lowp projection differ")
            compare(f"{tag} x_hat lowp", lp, fu.spectral_project_reference(
                x, ev16, mass, lowp=True), TOL["f32"])
            del ev16
            if ops_dt == f32:  # the backward's ds on the same kernel
                g = torch.Generator(device="cuda").manual_seed(B + V)
                cts = [torch.randn(B, V, C, generator=g, device="cuda").to(dt)
                       for _ in range(3)]
                ds = fu.spectral_ds(evecs, gX, gY, *cts)
                check(torch.equal(ds, fu.spectral_ds(evecs, gX, gY, *cts)),
                      f"{tag}: two launches of ds differ")
                ed = compare(f"{tag} ds", ds, fu.spectral_ds_reference(
                    evecs, gX, gY, *cts), TOL["f32"], scaled=True)
                if (B, V, kind) == (4, 32768, "f32"):
                    errs["spectral_ds"] = ed
                del cts, ds
            if (B, V, kind) == (4, 32768, "f32"):
                errs["spectral_project"] = e
                errs["spectral_apply"] = ea
            log(f"  {tag}: two launches bit-identical")
            del x, evecs, gX, gY, outs, refs, whole, again
    B, V, K, C = 2, 32768, 128, 128
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        lowp = kind == "bf16"
        base = block_inputs(B, V, K, C, (128, 128), dtype, seed=33)[:10]
        g = torch.Generator(device="cuda").manual_seed(34)
        dout = torch.randn(B, V, C, generator=g, device="cuda").to(dtype)
        for seed in (None, 2 ** 31 - 7):
            tag = f"megablock B={B} V={V} {kind} dropout={seed is not None}"
            kw = dict(lowp=lowp, seed=seed, tile_v=1024)
            x_hat = fu.spectral_project_reference(base[0], base[1], base[4],
                                                  lowp)
            ties = mb.relu_margin(*base, x_hat, **kw) < TIE
            d = dout.masked_fill(ties[..., None], 0.0)
            res = []
            for k, fn in enumerate((mb.megablock, mb.megablock_reference)):
                args = [[t.clone().requires_grad_(True) for t in a]
                        if isinstance(a, list) else
                        (a.clone().requires_grad_(True) if i in (0, 5, 6, 7)
                         else a) for i, a in enumerate(base)]
                out = (fn(*args, seed or 0, 1024, seed is not None) if k == 0
                       else fn(*args, seed, 1024, lowp))
                (out.float() * d.float()).sum().backward()
                torch.cuda.synchronize()
                res.append([out] + [args[i].grad for i in (0, 5, 6, 7)]
                           + [t.grad for t in args[8] + args[9]])
            e = compare(f"{tag} out", res[0][0], res[1][0], TOL[kind])
            if kind == "f32":
                errs["megablock"] = max(errs["megablock"], e)
            names = ["dx", "dcoefs", "dA_re", "dA_im", "dW0", "dW1", "dW2",
                     "db0", "db1", "db2"]
            worst = (0.0, "")
            for name, a, b in zip(names, res[0][1:], res[1][1:]):
                ea = compare(f"{tag} {name}", a, b, GRAD_TOL[kind],
                             scaled=True, quiet=True)
                worst = max(worst, (ea / max(b.float().abs().max().item(),
                                             1e-30), name))
            log(f"  {tag}: forward ok, {len(names)} gradients ok "
                f"(largest max abs err / max |plain| {worst[0]:.2e}, "
                f"{worst[1]}); {int(ties.sum())} ReLU-tie rows given zero "
                f"cotangent")
            del res
        del base, dout
    return errs


def phase_fused_slice(mb, fu, batch):
    """The slice of this phase: the segmentation model built with
    use_pallas_fused trains through apply_model(use_megakernel=False) and
    serves through InferenceSession(use_megakernel=False); then the B3 op's
    own path. Returns the launch counts of each run."""
    from diffusionnet_tpu_torch.models import flat_params
    from diffusionnet_tpu_torch.training import (
        InferenceSession, TaskConfig, adam_state_from_flat,
        adam_state_to_flat, adam_with_step_decay, apply_model,
        loss_and_counts, make_train_step)
    log("== phase 14: the fused slice, DiffusionNet(use_pallas_fused=True) "
        "on cuda: 5 Adam steps through the eager model, then a request")
    B, V = batch.verts.shape[:2]
    fused_model = segmentation_model(use_pallas_fused=True)
    plain_model = dense_route(segmentation_model())
    params = flat_params(fused_model, "cuda", requires_grad=True)
    cfg = TaskConfig(input_features="hks", labels_kind="face",
                     use_megakernel=False)
    opt = adam_with_step_decay(1e-3, 50, 0.5)
    state = opt.init(params)

    def make_step(model, deterministic):
        return make_train_step(
            lambda p, b, g: loss_and_counts(
                apply_model(model, p, b, g, cfg, deterministic), b, cfg), opt)
    step = make_step(fused_model, False)
    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.cuda.synchronize()
    mb.reset_launches()
    fu.reset_launches()
    losses = []
    for i in range(5):
        t0 = time.perf_counter()
        _, _, loss, (correct, total) = step(params, state, batch, gen)
        losses.append(loss.item())
        log(f"  step {i}: loss {losses[-1]:.6f}, correct {int(correct)} of "
            f"{int(total)} faces, {1e3 * (time.perf_counter() - t0):.1f} ms")
    launches = {**fu.LAUNCHES, **mb.LAUNCHES}
    # each block: the projection, spectral_apply and the backward's ds
    per_step = {"spectral_project": N_BLOCK, "spectral_apply": N_BLOCK,
                "spectral_ds": N_BLOCK,
                "megablock_fwd": 0, "megablock_fwd_xhat": 0,
                "xhat_reduce": 2 * N_BLOCK,
                "megablock_bwd_rows": 0, "megablock_bwd_grads": 0,
                "grad_reduce": 0}
    log(f"  launches in 5 steps (B={B}, V={V}): {launches}")
    check(launches == {k: 5 * v for k, v in per_step.items()},
          f"launches {launches} != 5 x {per_step}")
    check(all(map(math.isfinite, losses)), f"losses {losses}")

    # one step with dropout off from the same state, fused and unfused (the
    # dense route)
    flat_state = adam_state_to_flat(state)
    res = {}
    for name, model in (("fused", fused_model), ("unfused", plain_model)):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        s = adam_state_from_flat(opt.init(p), flat_state)
        one = make_step(model, True)
        _, _, loss, _ = (one(p, s, batch, None) if name == "fused" else
                         without_b4(lambda: one(p, s, batch, None),
                                    "phase 14's unfused step"))
        res[name] = (loss.item(), {k: v.grad for k, v in p.items()},
                     {k: v.detach() for k, v in p.items()})
    # the loss, the gradients, the Adam updates and the updated parameters
    # within STEP_TOL. A_im's updates are printed, not checked: its
    # gradient nearly cancels over the batch (own norm about 3e-7 of the
    # whole), so another summation order of gx and gy moves it by several
    # percent of itself (its gradient row above, checked within STEP_TOL),
    # and Adam, which divides by the running RMS, turns that into an update
    # as far off
    step_agreement("fused", "unfused", res, params,
                   checked=("gradient", "Adam update", "updated parameter"),
                   exempt=("A_im",))

    # one warm request with the fused model, against the unfused model
    mg = meshgen()
    verts, faces = mg.torus(n_major=144, n_minor=140)
    with tempfile.TemporaryDirectory() as cache:
        sess = InferenceSession(fused_model, k_eig=K_EIG, op_cache_dir=cache,
                                device="cuda")
        sess(verts, faces)  # cold: fills the operator cache
        torch.cuda.synchronize()
        mb.reset_launches()
        fu.reset_launches()
        pred = sess(verts, faces)
        served = {**fu.LAUNCHES, **mb.LAUNCHES}
        ref = without_b4(lambda: InferenceSession(
            plain_model, k_eig=K_EIG, op_cache_dir=cache,
            device="cuda")(verts, faces), "phase 14's unfused request")
    per_req = {"spectral_project": N_BLOCK, "spectral_apply": N_BLOCK,
               "spectral_ds": 0,
               "megablock_fwd": 0, "megablock_fwd_xhat": 0,
               "xhat_reduce": N_BLOCK,
               "megablock_bwd_rows": 0, "megablock_bwd_grads": 0,
               "grad_reduce": 0}
    log(f"  warm request torus(144, 140) (V={verts.shape[0]}, bucket "
        f"32768): forward {sess.timings['forward_s'] * 1e3:.2f} ms, "
        f"launches {served}")
    check(served == per_req, f"request launches {served} != {per_req}")
    compare(f"fused request {pred.shape} against the unfused model",
            torch.from_numpy(pred), torch.from_numpy(ref), SLICE_TOL)

    # the B3 op's own path: 3 Adam steps of one block's parameters through
    # `megablock` at full width with dropout, as its callers drive it
    log("  the one-block op: 3 Adam steps through ops.megablock.megablock, "
        "B=2 V=32768 K=C=128 hidden [128, 128], dropout on")
    base = block_inputs(2, 32768, 128, 128, (128, 128), torch.float32,
                        seed=35)
    x, evecs, gX, gY, mass = base[:5]
    leaves = [t.clone().requires_grad_(True)
              for t in (*base[6:8], *base[8], *base[9])]
    t_diff = torch.full((128,), 0.02, device="cuda", requires_grad=True)
    evals = torch.linspace(0, 40, 128, device="cuda").expand(2, 128)
    target = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(36), device="cuda")
    adam = torch.optim.Adam(leaves + [t_diff], lr=1e-3)
    torch.cuda.synchronize()
    mb.reset_launches()
    fu.reset_launches()
    for i in range(3):
        adam.zero_grad()
        coefs = torch.exp(-evals[..., None] * t_diff).contiguous()
        out = mb.megablock(x, evecs, gX, gY, mass, coefs, leaves[0],
                           leaves[1], leaves[2:5], leaves[5:8], 1000 + i,
                           1024, True)
        loss = (((out - target) ** 2) * mass[..., None]).sum() / mass.sum()
        loss.backward()
        adam.step()
        check(math.isfinite(loss.item()), f"B3 path loss {loss.item()}")
        log(f"    step {i}: loss {loss.item():.6f}")
    one = {**fu.LAUNCHES, **mb.LAUNCHES}
    want = {"spectral_project": 3, "spectral_apply": 0, "spectral_ds": 0,
            "megablock_fwd": 3,
            "megablock_fwd_xhat": 0, "xhat_reduce": 3, "megablock_bwd_rows": 3,
            "megablock_bwd_grads": 3, "grad_reduce": 9}
    log(f"    launches: {one}")
    check(one == want, f"B3 path launches {one} != {want}")
    return launches, served, one


def fused_bound(B, V, K, C, x_bytes, parts=("project", "apply")):
    """B4's least time: bytes of x and mass (projection), Phi, GX and GY
    and the three outputs, each once; 2VKC operations per product (one for
    the projection, three for the outputs) at the f32 rate of three TF32
    passes."""
    n_bytes = flops = 0
    if "project" in parts:
        n_bytes += B * V * (C * x_bytes + K * 4 + 4) + B * K * C * 4
        flops += 2 * B * V * K * C
    if "apply" in parts:
        n_bytes += B * V * (3 * K * 4 + 3 * C * x_bytes) + 2 * B * K * C * 4
        flops += 6 * B * V * K * C
    return bound(n_bytes, flops, TF32_FLOPS / 3)


def phase_fused_times(mb, fu, card, batch):
    """B4 and B3 beside their plain versions and bounds, and the fused
    train step beside the unfused one with a profiler breakdown."""
    from diffusionnet_tpu_torch.models import flat_params
    from diffusionnet_tpu_torch.training import (
        TaskConfig, adam_with_step_decay, apply_model, loss_and_counts,
        make_train_step)
    from torch.profiler import ProfilerActivity, profile
    log("== phase 15: times (CUDA events, median of 10 runs of 10 calls)")
    rows = {}
    for B in (4, 1):
        for kind, dt in (("f32", torch.float32), ("bf16 x", torch.bfloat16)):
            x, evecs, gX, gY, mass, coefs = fused_inputs(B, 32768, 128, 128,
                                                         dt, seed=B)
            xb = 2 if dt == torch.bfloat16 else 4
            x_hat = fu.spectral_project(x, evecs, mass)
            tp = time_ms(lambda: fu.spectral_project(x, evecs, mass))
            # its device time: at B=1 CUDA events time the wrappers' host
            # work, about as long as the two kernels
            dp = device_ms(lambda: fu.spectral_project(x, evecs, mass))
            pp = time_ms(lambda: fu.spectral_project_reference(x, evecs,
                                                               mass))
            # the library call of the projection: one einsum (f32 only; it
            # takes no bf16 x beside f32 operators)
            lp = (time_ms(lambda: torch.einsum("bvk,bv,bvc->bkc", evecs,
                                               mass, x))
                  if dt == torch.float32 else None)
            ta = time_ms(lambda: fu.spectral_apply(x_hat, coefs, evecs, gX,
                                                   gY, dt))
            pa = time_ms(lambda: fu.spectral_apply_reference(
                x_hat, coefs, evecs, gX, gY, dt))
            # the library call of spectral_apply: one torch.matmul over the
            # operators stacked as (3B, V, K) and s (f32, "highest"), both
            # made before the timed region
            stacked = torch.cat((evecs, gX, gY))
            s3 = (coefs * x_hat).repeat(3, 1, 1)
            la = time_ms(lambda: torch.matmul(stacked, s3))
            del stacked, s3
            tw = time_ms(lambda: fu.fused_spectral_block_batched(
                x, evecs, gX, gY, mass, coefs))
            pw = time_ms(lambda: fu.fused_spectral_block_reference(
                x, evecs, gX, gY, mass, coefs))
            bp = fused_bound(B, 32768, 128, 128, xb, ("project",))
            ba = fused_bound(B, 32768, 128, 128, xb, ("apply",))
            bw = fused_bound(B, 32768, 128, 128, xb)
            rows[(B, kind)] = dict(project=(tp, pp, bp, lp),
                                   apply=(ta, pa, ba, la),
                                   whole=(tw, pw, bw, None))
            if dt == torch.float32:
                # the backward's ds on the projection's kernel, beside its
                # plain version and one einsum over the stacked pairs
                g = torch.Generator(device="cuda").manual_seed(5)
                cts = [torch.randn(B, 32768, 128, generator=g, device="cuda")
                       for _ in range(3)]
                ops3, cts3 = torch.stack((evecs, gX, gY)), torch.stack(cts)
                td = time_ms(lambda: fu.spectral_ds(evecs, gX, gY, *cts))
                pd = time_ms(lambda: fu.spectral_ds_reference(evecs, gX, gY,
                                                              *cts))
                ld = time_ms(lambda: torch.einsum("tbvk,tbvc->bkc", ops3,
                                                  cts3))
                bd = bound(3 * B * 32768 * 128 * 8 + B * 128 * 128 * 4,
                           6 * B * 32768 * 128 * 128, TF32_FLOPS / 3)
                rows[(B, kind)]["ds"] = (td, pd, bd, ld)
                del cts, ops3, cts3
            library = {"project": "einsum", "apply": "stacked matmul",
                       "ds": "einsum over the stacked pairs"}
            for name, (k, p, bd, lib) in rows[(B, kind)].items():
                log(f"  time B4 {name} B={B} V=32768 K=C=128 {kind}: kernel "
                    f"{k:.4f} ms, plain {p:.4f} ms"
                    + (f", library ({library[name]}) {lib:.4f} ms" if lib
                       else "")
                    + (f", device time {dp:.4f} ms" if name == "project"
                       else "")
                    + f"; bound {bd[0]:.4f} ms ({bd[1]}), share "
                    f"{bd[0] / k:.4f} [{card}]")
            del x, evecs, gX, gY, x_hat
    widths = (3 * 128, 128, 128, 128)
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = block_inputs(1, 32768, 128, 128, (128, 128), dtype,
                            seed=37)[:10]
        lowp = kind == "bf16"
        k = time_ms(lambda: mb.megablock(*args, 0, 1024, False))
        p = time_ms(lambda: mb.megablock_reference(*args, None, 1024, lowp))
        bd = megablock_bound(1, 32768, 128, 128, widths, True, False, lowp)
        rows[("B3", kind)] = (k, p, bd, None)
        log(f"  time B3 megablock B=1 V=32768 K=C=128 hidden [128, 128] "
            f"{kind}: kernels {k:.4f} ms, plain {p:.4f} ms; bound "
            f"{bd[0]:.4f} ms ({bd[1]}), share {bd[0] / k:.4f} [{card}]")
        del args

    # the train step of phase 14, fused and unfused (the dense route),
    # dropout on
    cfg = TaskConfig(input_features="hks", labels_kind="face",
                     use_megakernel=False)
    gen = torch.Generator(device="cuda").manual_seed(9)
    steps = {}
    for name, kw in (("fused", dict(use_pallas_fused=True)),
                     ("unfused", dict(pallas_tile_v=OFF_TILE_V))):
        model = segmentation_model(**kw)
        params = flat_params(model, "cuda", requires_grad=True)
        opt = adam_with_step_decay(1e-3)
        state = opt.init(params)
        step = make_train_step(
            lambda p, b, g: loss_and_counts(
                apply_model(model, p, b, g, cfg, False), b, cfg), opt)
        if name == "unfused":
            without_b4(lambda: step(params, state, batch, gen),
                       "phase 15's unfused step")
        t = time_ms(lambda: step(params, state, batch, gen), reps=5, calls=3,
                    warmup=2)
        steps[name] = t
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                step(params, state, batch, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
        groups = {"B4 spectral_project (x_hat, ds)": 0.0,
                  "B4 spectral_apply": 0.0,
                  "xhat_reduce": 0.0, "matmul (cuBLAS)": 0.0, "Adam": 0.0,
                  "other": 0.0}
        top = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = us if us is not None else e.self_cuda_time_total
            top.append((us, e.key))
            key = e.key.lower()
            if "spectral_project" in key:
                groups["B4 spectral_project (x_hat, ds)"] += us
            elif "spectral_apply" in key:
                groups["B4 spectral_apply"] += us
            elif "xhat_reduce" in key:
                groups["xhat_reduce"] += us
            elif "gemm" in key or "sm90" in key or "cutlass" in key:
                groups["matmul (cuBLAS)"] += us
            elif "adam" in key or "multi_tensor" in key:
                groups["Adam"] += us
            else:
                groups["other"] += us
        busy = sum(groups.values()) / 3 / 1e3
        log(f"  time train step B={batch.verts.shape[0]} "
            f"V={batch.verts.shape[1]} segmentation model {name}, dropout "
            f"on, eager path: {t:.3f} ms per step [{card}]; profile: wall "
            f"{wall:.3f} ms, device busy {busy:.3f} ms (idle share "
            f"{1 - busy / wall:.4f}); per step: "
            + ", ".join(f"{k} {v / 3 / 1e3:.3f} ms" for k, v in groups.items()))
        for us, key in sorted(top, reverse=True)[:6]:
            log(f"    {us / 3 / 1e3:9.3f} ms  {key[:100]}")
        gemms = [key for us, key in sorted(top, reverse=True)
                 if any(w in key.lower() for w in ("gemm", "sm90", "cutlass"))]
        kernel_callers(prof, gemms[:2], steps=3)
        del params, state, model
    return rows, steps


def kernel_callers(prof, kernels, steps, n_callers=8):
    """Prints, for each named kernel of a profile, the operators that
    launched it (name and input shapes) under the autograd node or the
    forward that ran them, with their device time per step. Printed only:
    no check reads the profiler's device events, which a card does not
    always report."""
    for kernel in kernels:
        callers = {}
        for e in prof.events():
            us = sum(k.duration for k in getattr(e, "kernels", [])
                     if k.name == kernel)
            if not us:
                continue
            node, up = "forward", e.cpu_parent
            while up is not None:
                if "Backward" in up.name or "backward" in up.name:
                    node = up.name.split(": ")[-1]
                    break
                up = up.cpu_parent
            key = (node, e.name, str(e.input_shapes))
            callers[key] = callers.get(key, 0.0) + us
        total = sum(callers.values())
        log(f"    callers of {kernel[:80]} ({total / steps / 1e3:.3f} ms "
            "per step):")
        ranked = sorted(callers.items(), key=lambda kv: -kv[1])
        for (node, op, shapes), us in ranked[:n_callers]:
            log(f"      {us / steps / 1e3:8.3f} ms  {node} / {op} {shapes}")



# the sampling_invariance experiment's model (experiments/sampling_invariance:
# build_model(n_class, c_width=256, outputs_at="vertices", dropout=True),
# hidden [256, 256] by default, xyz input), over FAUST's 6890 template
# vertices as classes
SI_MODEL = dict(c_in=3, c_out=6890, c_width=256, n_block=N_BLOCK,
                mlp_hidden_dims=[256, 256], dropout=True,
                outputs_at="vertices")


def phase_c256_train(mb, card):
    """The path that B1 and B2 at C = 256 open: the sampling_invariance
    model takes 3 Adam steps (dropout on) at the experiment's default batch of 2 through
    apply_model(use_megakernel=True); the counters must show 4 B1 and 4 B2
    launches a step. Then one step with dropout off from the same state,
    through the fast path and through the eager model with autograd. Returns
    the launch counts of the 3 steps."""
    import numpy as np
    from diffusionnet_tpu_torch.data import SurfaceDataset, make_padded_batches
    from diffusionnet_tpu_torch.models import DiffusionNet, flat_params
    from diffusionnet_tpu_torch.training import (
        TaskConfig, adam_state_from_flat, adam_state_to_flat,
        adam_with_step_decay, apply_model, loss_and_counts, make_train_step)

    log("== phase 16: the sampling_invariance model (C = 256), 3 Adam steps "
        "through apply_model(use_megakernel=True) on cuda")
    mg = meshgen()
    ds = SurfaceDataset(labels_kind="vertex")
    for v, f in (mg.torus(n_major=144, n_minor=140),
                 mg.icosphere(subdivisions=5)):
        ds.add(v, f, np.arange(v.shape[0]) % SI_MODEL["c_out"])
    with tempfile.TemporaryDirectory() as cache:
        ds.precompute(K_EIG, op_cache_dir=cache, verbose=False)
    batch = next(make_padded_batches(ds, 2)).to("cuda")
    B, V = batch.verts.shape[:2]
    check((B, V) == (2, 32768), f"batch shape {(B, V)}")
    model = DiffusionNet(**SI_MODEL,
                         generator=torch.Generator().manual_seed(16),
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    params = flat_params(model, "cuda", requires_grad=True)
    opt = adam_with_step_decay(1e-3, 50, 0.5)
    state = opt.init(params)

    def make_step(c, deterministic, m=model):
        return make_train_step(
            lambda p, b, g: loss_and_counts(
                apply_model(m, p, b, g, c, deterministic), b, c), opt)
    cfg = TaskConfig(input_features="xyz", labels_kind="vertex")
    step = make_step(cfg, False)
    before = {k: v.detach().clone() for k, v in params.items()}
    gen = torch.Generator().manual_seed(2)
    torch.cuda.synchronize()
    mb.reset_launches()
    losses, times = [], []
    for i in range(3):
        t0 = time.perf_counter()
        _, _, loss, (correct, total) = step(params, state, batch, gen)
        losses.append(loss.item())
        times.append(1e3 * (time.perf_counter() - t0))
        log(f"  step {i}: loss {losses[-1]:.6f}, correct {int(correct)} of "
            f"{int(total)} vertices, {times[-1]:.1f} ms (host clock to the "
            f"loss on the host) [{card}]")
    launches = dict(mb.LAUNCHES)
    log(f"  launches in 3 steps (B={B}, V={V}, C=256): {launches}")
    check(launches == {k: 3 * v for k, v in B2_PER_STEP.items()},
          f"launches {launches} != 3 x {B2_PER_STEP}")
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    still = [k for k in params if torch.equal(params[k].detach(), before[k])]
    check(not still, f"parameters that did not move: {still}")
    t = time_ms(lambda: step(params, state, batch, gen), reps=3, calls=3,
                warmup=1)
    log(f"  time train step B={B} V={V} sampling_invariance model (C=256, "
        f"dropout on), megakernel path: {t:.3f} ms per step [{card}]")

    # the eager model on the dense route (cuBLAS)
    flat_state = adam_state_to_flat(state)
    res = {}
    dense = dense_route(model)
    for name, use_mk in (("fast path", True), ("eager model", False)):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        s = adam_state_from_flat(opt.init(p), flat_state)
        c = TaskConfig(input_features="xyz", labels_kind="vertex",
                       use_megakernel=use_mk)
        one = make_step(c, True, model if use_mk else dense)
        _, _, loss, _ = (one(p, s, batch, None) if use_mk else without_b4(
            lambda: one(p, s, batch, None), "phase 16's eager step"))
        res[name] = (loss.item(), {k: v.grad for k, v in p.items()},
                     {k: v.detach() for k, v in p.items()})
    # This configuration's gradient moves by about 1e-3 of its norm under a
    # rounding-level change of the input (xyz features through first_lin
    # put many ReLU inputs by 0): the eager model against itself with
    # first_lin's kernel scaled by 1 + 1e-6, printed below, moves about as
    # far as the fast path does from it. So the step is held to 4x what the
    # same change does to the eager model's own step, measured here, where
    # that exceeds STEP_TOL's `whole`.
    p = {k: (v.detach() * (1 + 1e-6) if k.endswith("first_lin/kernel")
             else v.detach()).clone().requires_grad_(True)
         for k, v in params.items()}
    s = adam_state_from_flat(opt.init(p), flat_state)
    c = TaskConfig(input_features="xyz", labels_kind="vertex",
                   use_megakernel=False)
    without_b4(lambda: make_step(c, True, dense)(p, s, batch, None),
               "phase 16's nudged eager step")
    ge, gp = res["eager model"][1], {k: v.grad for k, v in p.items()}
    ue = {k: res["eager model"][2][k] - params[k].detach() for k in ge}
    up = {k: p[k].detach() - params[k].detach() for k in ge}

    def rel(a, b):
        return math.sqrt(sum((a[k].float() - b[k].float()).norm().item() ** 2
                             for k in a)
                         / sum(b[k].float().norm().item() ** 2 for k in b))
    sens = max(rel(gp, ge), rel(up, ue))
    tol = dict(STEP_TOL, whole=max(STEP_TOL["whole"], 4 * sens))
    log(f"  the eager model against itself with first_lin's kernel scaled by "
        f"1 + 1e-6: gradients {rel(gp, ge):.2e}, Adam updates "
        f"{rel(up, ue):.2e} of the whole; tolerance of the fast path's "
        f"whole: {tol['whole']:.2e}")
    step_agreement("fast path", "eager model", res, params,
                   checked=("gradient", "Adam update"), tol=tol)
    return launches


# Phase 16b's two models: the segmentation model's configuration (HKS
# input, 8 face classes, 4 blocks, k 128, dropout on) at widths the JAX
# package's fast path takes and the port's kernels did not take before:
# c_width 100 with the default hidden [100, 100] (C % 8 != 0: B1 and B2 run
# with C padded to 104) and c_width 256 with hidden [1024, 1024] (B1's row
# kernel with the hidden layers in device scratch)
WIDE_MODELS = {"c_width 100": dict(c_width=100, mlp_hidden_dims=None),
               "c_width 256, hidden [1024, 1024]": dict(
                   c_width=256, mlp_hidden_dims=[1024, 1024])}


@contextlib.contextmanager
def plain_blocks(mb):
    """The fast path with each block's plain PyTorch version in place of
    B1 and B2 (differentiable through autograd), on the same tensors."""
    from diffusionnet_tpu_torch.models import fast_path
    saved = fast_path.megablock_chained
    fast_path.megablock_chained = mb.megablock_chained_reference
    try:
        yield
    finally:
        fast_path.megablock_chained = saved


def phase_wide_train(mb, card, batch):
    """Each of WIDE_MODELS takes 5 Adam steps (dropout on) on phase 8's
    batch through make_train_step on the fast path: every step launches B1
    and B2 as phase 8's do, and is held, in loss and gradients, to the same
    step from the same state and dropout generator with the blocks' plain
    version on the card. Then a train step's time, and a cold and a warm
    InferenceSession(use_megakernel=True) request on torus(144, 140), the
    warm one against the eager model. Returns the launch counts of the
    kernel steps and the warm requests."""
    from diffusionnet_tpu_torch.models import DiffusionNet, flat_params
    from diffusionnet_tpu_torch.training import (
        InferenceSession, TaskConfig, adam_state_from_flat,
        adam_state_to_flat, adam_with_step_decay, apply_model,
        loss_and_counts, make_train_step)

    log("== phase 16b: models at c_width 100 and at c_width 256 with hidden "
        "[1024, 1024], 5 Adam steps each through the fast path on cuda, "
        "each against the blocks' plain version, and a served request")
    B, V = batch.verts.shape[:2]
    cfg = TaskConfig(input_features="hks", labels_kind="face")
    verts, faces = meshgen().torus(n_major=144, n_minor=140)
    launches = dict.fromkeys(mb.LAUNCHES, 0)
    per_req = {**dict.fromkeys(mb.LAUNCHES, 0), "megablock_fwd": N_BLOCK,
               "megablock_fwd_xhat": N_BLOCK - 1, "xhat_reduce": N_BLOCK - 1}
    for name, kw in WIDE_MODELS.items():
        model = DiffusionNet(**{**SEG_MODEL, **kw},
                             generator=torch.Generator().manual_seed(5),
                             last_activation=functools.partial(
                                 torch.log_softmax, dim=-1))
        C = kw["c_width"]
        widths = (3 * C, *(kw["mlp_hidden_dims"] or (C, C)), C)
        log(f"  {name}: B1's layout, f32 operands: "
            f"{layout_name(mb.fwd_route(C, widths, False, mb._smem_limit(0)))}"
            f"; bf16: "
            f"{layout_name(mb.fwd_route(C, widths, True, mb._smem_limit(0)))}")
        params = flat_params(model, "cuda", requires_grad=True)
        opt = adam_with_step_decay(1e-3, 50, 0.5)
        state = opt.init(params)
        step = make_train_step(
            lambda p, b, g: loss_and_counts(
                apply_model(model, p, b, g, cfg, False), b, cfg), opt)
        gen = torch.Generator().manual_seed(6)
        losses = []
        for i in range(5):
            # the same step with the plain version, from copies of the
            # state and of the generator (so the same dropout seeds)
            p_ref = {k: v.detach().clone().requires_grad_(True)
                     for k, v in params.items()}
            s_ref = adam_state_from_flat(opt.init(p_ref),
                                         adam_state_to_flat(state))
            g_ref = torch.Generator()
            g_ref.set_state(gen.get_state())
            with plain_blocks(mb):
                _, _, loss_ref, _ = step(p_ref, s_ref, batch, g_ref)
            before = {k: v.detach().clone() for k, v in params.items()}
            torch.cuda.synchronize()
            mb.reset_launches()
            t0 = time.perf_counter()
            _, _, loss, (correct, total) = step(params, state, batch, gen)
            losses.append(loss.item())
            got = dict(mb.LAUNCHES)
            log(f"  {name} step {i}: loss {losses[-1]:.6f} (plain "
                f"{loss_ref.item():.6f}), correct {int(correct)} of "
                f"{int(total)} faces, "
                f"{1e3 * (time.perf_counter() - t0):.1f} ms [{card}]")
            check(got == B2_PER_STEP,
                  f"{name} step {i}: launches {got} != {B2_PER_STEP}")
            for k in launches:
                launches[k] += got[k]
            res = {"kernels": (losses[-1],
                               {k: v.grad for k, v in params.items()},
                               {k: v.detach() for k, v in params.items()}),
                   "plain version": (
                       loss_ref.item(), {k: v.grad for k, v in p_ref.items()},
                       {k: v.detach() for k, v in p_ref.items()})}
            step_agreement("kernels", "plain version", res, before,
                           checked=("gradient",), per_tensor=i == 0,
                           label=f"step {i} (dropout on)")
            del p_ref, s_ref, res
        check(all(map(math.isfinite, losses)), f"{name}: losses {losses}")
        t = time_ms(lambda: step(params, state, batch, gen), reps=3,
                    calls=3, warmup=1)
        log(f"  time train step B={B} V={V} {name} (dropout on), fast path: "
            f"{t:.3f} ms per step [{card}]")
        del params, state, step
        with tempfile.TemporaryDirectory() as cache:
            session = InferenceSession(model, k_eig=K_EIG, op_cache_dir=cache,
                                       use_megakernel=True, device="cuda")
            session(verts, faces)
            torch.cuda.synchronize()
            mb.reset_launches()
            t0 = time.perf_counter()
            pred = session(verts, faces)
            warm = time.perf_counter() - t0
            got = dict(mb.LAUNCHES)
            check(got == per_req,
                  f"{name}: request launches {got} != {per_req}")
            for k in launches:
                launches[k] += got[k]
            ref = without_b4(lambda: InferenceSession(
                dense_route(model), k_eig=K_EIG, op_cache_dir=cache,
                device="cuda")(verts, faces), f"{name}: the eager request")
        log(f"  {name}: warm request torus(144, 140) (V={verts.shape[0]}): "
            f"{warm * 1e3:.1f} ms host clock, forward "
            f"{session.timings['forward_s'] * 1e3:.2f} ms [{card}]")
        compare(f"{name}: predictions {pred.shape} against the eager model",
                torch.from_numpy(pred), torch.from_numpy(ref), SLICE_TOL)
        del session, model
    log(f"  launches of phase 16b: {launches}")
    return launches


# the synthetic SHREC example's shapes on the megakernel path: batch 10 of
# meshes of 160-200 vertices padded to the 256 bucket (n_pad: the rows of a
# 196-vertex mesh's padding), k 32, c_width 64, hidden [64, 64]; the
# dropout tile of V = 256 is 256
EXAMPLE_BLOCK = dict(B=10, V=256, K=32, C=64, hidden=(64, 64), n_pad=60)
# the example's test accuracy at its defaults with --mega must reach this.
# On the card seeds 0-4 all classified the 30 test meshes right (1.0; also
# the eager route and bf16 operands at seed 0; PERF.md section 6);
# the bound allows three of 30 wrong, while a run that does not learn stays
# near chance (0.1)
EXAMPLE_ACC_BOUND = 0.9


def phase_example_kernels(mb):
    """17a: B1 and B2 against their plain versions at the example's shapes,
    f32 and bf16, emit_next on and off, dropout off and on (tile 256), each
    launched twice and bit-identical; B1's x_hat kernel alone where
    emit_next is off."""
    B, V, K, C = (EXAMPLE_BLOCK[k] for k in "BVKC")
    hidden, n_pad = EXAMPLE_BLOCK["hidden"], EXAMPLE_BLOCK["n_pad"]
    log(f"== phase 17a: B1 and B2 at the synthetic SHREC example's shapes "
        f"(B={B}, V={V}, K={K}, C={C}, hidden {list(hidden)}, {n_pad} "
        "padding rows)")
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        lowp = kind == "bf16"
        args = block_inputs(B, V, K, C, hidden, dtype, seed=17, n_pad=n_pad)
        g = torch.Generator(device="cuda").manual_seed(17)
        dout = torch.randn(B, V, C, generator=g, device="cuda").to(dtype)
        for emit in (True, False):
            for seed in (None, 2 ** 31 - 17):
                tag = (f"example B={B} V={V} K={K} C={C} {kind} "
                       f"emit_next={emit} dropout={seed is not None}")
                kw = dict(lowp=lowp, seed=seed, tile_v=V)
                layout, want = b1_launches(mb, C, hidden, lowp, emit)
                out, xn, got = b1_twice(mb, tag, args, emit_next=emit, **kw)
                check(got == want, f"{tag}: launches {got} != {want}")
                ref, ref_xn = mb.megablock_chained_reference(
                    *args, emit_next=emit, **kw)
                compare(f"{tag} out (two launches bit-identical)", out, ref,
                        TOL[kind])
                if emit:
                    compare(f"{tag} x_hat_next", xn, ref_xn, TOL[kind])
                elif seed is None:
                    xhat_kernel_check(mb, tag, args, out, lowp)
                # B2, rows whose ReLU input ties 0 given zero cotangent
                ties = mb.relu_margin(*args, **kw) < TIE
                targs = list(args)
                targs[4] = args[4].masked_fill(ties, 0.0)
                d = dout.masked_fill(ties[..., None], 0.0)
                dxn = (torch.randn(B, K, C, generator=g, device="cuda")
                       if emit else None)
                grads = mb.megablock_chained_bwd(*targs, d, dxn, **kw)
                again = mb.megablock_chained_bwd(*targs, d, dxn, **kw)
                want_g = mb.megablock_chained_bwd_reference(*targs, d, dxn,
                                                            **kw)
                torch.cuda.synchronize()
                flat = [*grads[:4], *grads[4], *grads[5]]
                flat2 = [*again[:4], *again[4], *again[5]]
                flat_w = [*want_g[:4], *want_g[4], *want_g[5]]
                check(all(torch.equal(a, b) for a, b in zip(flat, flat2)),
                      f"{tag}: two launches of B2 differ")
                worst = max(compare(f"{tag} B2 output {i}", a, b,
                                    GRAD_TOL[kind], scaled=True, quiet=True)
                            / max(b.float().abs().max().item(), 1e-30)
                            for i, (a, b) in enumerate(zip(flat, flat_w)))
                log(f"  {tag} B2: {len(flat)} outputs ok, two launches "
                    f"bit-identical, largest max abs err / max |plain| "
                    f"{worst:.2e}; {int(ties.sum())} of {B * V} tie rows")
        del args


def phase_harness(mb, card, seg_ds):
    """17b-c: the training harness (experiments.exp_common.fit) on the card.
    (b) the human_segmentation_original configuration at full width (8
    classes, c_width 128, dropout on, HKS, k 128, face labels) on phase 8's
    meshes (batch 4, the 32768 bucket) for 2 epochs through B1/B2: a run
    resumed from its epoch-0 checkpoint ends with the uninterrupted run's
    weights bit for bit, and device_data gives the prefetch path's weights
    bit for bit. (c) the synthetic SHREC example with --mega at its
    defaults must reach EXAMPLE_ACC_BOUND. Returns the launch counts of
    (b)'s uninterrupted run and of the example."""
    from diffusionnet_tpu_torch.examples import synthetic_shrec
    from diffusionnet_tpu_torch.experiments.exp_common import (
        FitConfig, build_model, fit)
    from diffusionnet_tpu_torch.ops import blocked_ell as be

    log("== phase 17b: the harness at full width: the human_segmentation_"
        "original configuration, fit(use_megakernel=True), 2 epochs")
    model = build_model(8, 128, "faces", True, "hks")
    t_phase = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(name, n_epoch, device_data=False, resume=None, mega=True):
            cfg = FitConfig(n_epoch=n_epoch, batch_size=4,
                            input_features="hks", labels_kind="face",
                            use_megakernel=mega, device_data=device_data)
            save = os.path.join(tmp, name)
            logp = save + ".jsonl"
            t0 = time.perf_counter()
            params, hist, _ = fit(
                model, seg_ds, seg_ds, cfg, model_save_path=save,
                log_path=logp, verbose=False,
                resume_from=(os.path.join(tmp, resume) + "_ckpt"
                             if resume else None))
            torch.cuda.synchronize()
            with open(logp) as f:
                secs = [json.loads(line)["epoch_seconds"] for line in f]
            log(f"  {name}: {n_epoch} epochs, history {hist}, epoch seconds "
                f"{secs} (host clock, evaluation included), "
                f"{time.perf_counter() - t0:.2f} s in all [{card}]")
            runs[name] = {k: v.detach() for k, v in params.items()}

        mb.reset_launches()
        run("whole", 2)
        launches = dict(mb.LAUNCHES)
        log(f"  launches of the uninterrupted run (2 train steps, 2 "
            f"evaluations): {launches}")
        for k in ("megablock_fwd", "megablock_fwd_xhat", "xhat_reduce",
                  "megablock_bwd_rows", "megablock_bwd_grads",
                  "grad_reduce"):
            check(launches[k] > 0, f"{k} was not launched by fit")
        run("first", 1)
        run("resumed", 2, resume="first")
        run("device_data", 2, device_data=True)
        # the eager route (its blocks' spectral products on B4 on the card,
        # the rest on cuBLAS): printed only
        run("eager whole", 2, mega=False)
        run("eager first", 1, mega=False)
        run("eager resumed", 2, resume="eager first", mega=False)
    same = [k for k in runs["eager whole"]
            if torch.equal(runs["eager whole"][k], runs["eager resumed"][k])]
    rel = max(((runs["eager whole"][k] - runs["eager resumed"][k]).norm()
               / runs["eager whole"][k].norm().clamp(min=1e-30)).item()
              for k in runs["eager whole"])
    log(f"  eager route, resumed against uninterrupted (printed, not "
        f"checked): {len(same)} of {len(runs['eager whole'])} tensors "
        f"bit-identical, largest relative L2 difference {rel:.3e}")
    for other in ("resumed", "device_data"):
        diff = [k for k in runs["whole"]
                if not torch.equal(runs["whole"][k], runs[other][k])]
        log(f"  {other} against the uninterrupted run: "
            f"{len(runs['whole']) - len(diff)} of {len(runs['whole'])} "
            "tensors bit-identical")
        check(not diff, f"{other}: weights differ from the uninterrupted "
              f"run in {diff}")

    # prefetched batches (pinned copies on a side stream, read as they come)
    # against the same batches copied directly
    from diffusionnet_tpu_torch.data import (make_padded_batches,
                                             prefetch_to_device)

    def arrays(batch):
        out = []
        batch.map(lambda a: out.append(a) or a)
        return out
    n_batches = 0
    for bs in (1, 3):
        direct = make_padded_batches(seg_ds, bs, shuffle=True, seed=bs)
        for got, want in zip(prefetch_to_device(make_padded_batches(
                seg_ds, bs, shuffle=True, seed=bs)), direct):
            same = all(torch.equal(a, b) for a, b in
                       zip(arrays(got), arrays(want.to("cuda"))))
            check(same, f"a prefetched batch (batch size {bs}) differs from "
                  "the directly copied one")
            n_batches += 1
    log(f"  prefetch_to_device: {n_batches} batches (batch sizes 1 and 3) "
        "equal to the directly copied ones")

    # the prefetch path's epoch, taken apart: the host stacking alone, and
    # with the copies to the card (no training)
    for name, wrap in (("host stacking alone", lambda it: it),
                       ("stacking and copies (prefetch_to_device)",
                        prefetch_to_device)):
        t0 = time.perf_counter()
        for b in wrap(make_padded_batches(seg_ds, 4, shuffle=True, seed=0)):
            pass
        torch.cuda.synchronize()
        log(f"  an epoch's batches (batch 4), {name}: "
            f"{time.perf_counter() - t0:.4f} s (host clock) [{card}]")

    # the face mean at the segmentation batch's shapes: its backward by
    # gather (atomic adds), by an embedding lookup (sort-based) and by
    # gather_mean (a fixed-order sum over each vertex's entries, its plan
    # made first as the models make it), five passes each; gather_mean
    # must repeat its bits and give the forward of the gather form;
    # forward and backward timed
    from diffusionnet_tpu_torch.models.diffusion_net import (MeanPlan,
                                                             gather_mean)
    batch = next(make_padded_batches(seg_ds, 4)).to("cuda")
    faces = batch.faces.long()
    B, F = faces.shape[:2]
    V, C = batch.verts.shape[1], 8
    g = torch.Generator(device="cuda").manual_seed(170)
    x0 = torch.randn(B, V, C, generator=g, device="cuda")
    dout = torch.randn(B, F, C, generator=g, device="cuda")
    safe = faces.clamp(0, V - 1)

    def by_gather(x):
        return sum(torch.gather(x, -2, safe[..., i, None].expand(B, F, C))
                   for i in range(3)) / 3.0

    def by_embedding(x):
        flat = safe + V * torch.arange(B, device="cuda").view(B, 1, 1)
        rows = torch.nn.functional.embedding(flat, x.reshape(B * V, C))
        return sum(rows[..., i, :] for i in range(3)) / 3.0
    forms = (("gather", by_gather), ("embedding lookup", by_embedding),
             ("gather_mean", lambda x: gather_mean(x, faces,
                                                   MeanPlan(faces, V))))
    repeats = {}
    for name, fn in forms:
        grads = []
        for _ in range(5):
            x = x0.clone().requires_grad_(True)
            fn(x).backward(dout)
            grads.append(x.grad)
        repeats[name] = sum(torch.equal(grads[0], q) for q in grads[1:])
        diff = max((grads[0] - q).abs().max().item() for q in grads[1:])
        x = x0.clone().requires_grad_(True)
        ms = time_ms(lambda: fn(x).backward(dout))
        log(f"  face mean by {name}, B={B} V={V} F={F} (padded) C={C}: "
            f"forward and backward {ms:.4f} ms (CUDA events) [{card}]; "
            f"backward passes 2-5 bit-identical to the first: "
            f"{repeats[name]} of 4 (largest difference {diff:.3e})")
    check(torch.equal(by_gather(x0), gather_mean(x0, faces)),
          "gather_mean's forward differs from the gather form")
    check(repeats["gather_mean"] == 4,
          "gather_mean's backward does not repeat its bits")

    log("== phase 17c: the synthetic SHREC example, --mega, its defaults")
    mb.reset_launches()
    be.reset_launches()
    t0 = time.perf_counter()
    acc = synthetic_shrec.main(["--mega"])
    ex_launches = dict(mb.LAUNCHES, blocked_ell=be.LAUNCHES["blocked_ell"])
    log(f"  test accuracy {acc:.4f} (bound {EXAMPLE_ACC_BOUND}), "
        f"{time.perf_counter() - t0:.2f} s with its precompute [{card}]; "
        f"launches {ex_launches}")
    check(ex_launches["megablock_fwd"] > 0
          and ex_launches["megablock_bwd_rows"] > 0,
          "the example did not run on B1/B2")
    check(acc >= EXAMPLE_ACC_BOUND,
          f"example test accuracy {acc} below {EXAMPLE_ACC_BOUND}")
    log(f"  phase 17b-c: {time.perf_counter() - t_phase:.1f} s")
    return launches, ex_launches, runs["whole"]


def phase_ell_repeat(card):
    """18a (ROADMAP C.2): `ops.sparse.ell_matvec` gathers by advanced
    indexing, whose autograd backward accumulates by index (printed); its
    own fixed-order backward (`_EllMatvec`) at the
    segmentation shape (B=4, V=32768, C=128; torus(144, 140)'s ELL gradient
    operator, stacked four times, and unstacked) must repeat its bits over
    five passes, and a 2-epoch fit of an implicit_dense model (the ELL
    gradient route; dropout on), resumed from its epoch-0 checkpoint, must
    end with the uninterrupted run's weights bit for bit."""
    import numpy as np
    from diffusionnet_tpu_torch.data import SurfaceDataset
    from diffusionnet_tpu_torch.experiments.exp_common import FitConfig, fit
    from diffusionnet_tpu_torch.geometry import compute_operators
    from diffusionnet_tpu_torch.models import DiffusionNet
    from diffusionnet_tpu_torch.ops.sparse import (Ell, _ell_forward,
                                                   ell_matvec, ell_pad)

    log("== phase 18a: ell_matvec's backward and an implicit_dense resume "
        "repeat their bits")
    mg = meshgen()
    verts, faces = mg.torus(n_major=144, n_minor=140)
    grad = ell_pad(compute_operators(verts, faces, k_eig=0, device="cuda",
                                     ).gradX, 32768)
    B, V, C = 4, 32768, 128
    idx = torch.from_numpy(np.asarray(grad.idx)).cuda()
    val = torch.from_numpy(np.asarray(grad.val)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(180)
    x0 = torch.randn(B, V, C, generator=gen, device="cuda")
    dout = torch.randn(B, V, C, generator=gen, device="cuda")
    stacked = Ell(idx.expand(B, -1, -1), val.expand(B, -1, -1))
    # ell_matvec, and (printed only) the gather's own autograd backward
    # that it had before (index_put_ with accumulate)
    forms = (("ell_matvec, operator stacked (B, V, D)",
              lambda x: ell_matvec(stacked, x), True),
             ("ell_matvec, one operator (V, D)",
              lambda x: ell_matvec(Ell(idx, val), x), True),
             ("the gather's autograd, operator stacked",
              lambda x: _ell_forward(stacked.idx.long(), stacked.val, x),
              False))
    for name, fn, checked in forms:
        grads = []
        for _ in range(5):
            x = x0.clone().requires_grad_(True)
            fn(x).backward(dout)
            grads.append(x.grad)
        same = sum(torch.equal(grads[0], q) for q in grads[1:])
        diff = max((grads[0] - q).abs().max().item() for q in grads[1:])
        x = x0.clone().requires_grad_(True)
        ms = time_ms(lambda: fn(x).backward(dout))
        log(f"  {name}, D={idx.shape[-1]}, x ({B}, {V}, {C}): forward and "
            f"backward {ms:.4f} ms (CUDA events) [{card}]; backward passes "
            f"2-5 bit-identical to the first: {same} of 4 (largest "
            f"difference {diff:.3e})")
        check(same == 4 or not checked,
              f"{name}: the backward does not repeat its bits")

    ds = SurfaceDataset(labels_kind="face")
    for v, f in (mg.icosphere(subdivisions=2), mg.torus(n_major=20,
                                                         n_minor=14),
                 mg.torus(n_major=24, n_minor=16),
                 mg.icosphere(subdivisions=2)):
        c = v[f].mean(axis=1)
        sector = np.floor((np.arctan2(c[:, 1], c[:, 0]) + np.pi)
                          / (2 * np.pi) * 4).astype(np.int64) % 4
        ds.add(v, f, sector * 2 + (c[:, 2] > 0))
    ds.precompute(0, verbose=False, device="cuda")
    # k_eig = 0 leaves (V, 0) spectral operators: drop them, so that the
    # blocks take the ELL gradients
    ds.ops_list = [o._replace(gradX_spec=None, gradY_spec=None)
                   for o in ds.ops_list]
    model = DiffusionNet(c_in=3, c_out=8, c_width=128, n_block=4,
                         outputs_at="faces", diffusion_method="implicit_dense",
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, n_epoch, resume in (("whole", 2, None), ("first", 1, None),
                                      ("resumed", 2, "first")):
            cfg = FitConfig(n_epoch=n_epoch, batch_size=4,
                            input_features="xyz", labels_kind="face",
                            buckets=(512,))
            t0 = time.perf_counter()
            params, hist, _ = fit(
                model, ds, ds, cfg, model_save_path=os.path.join(tmp, name),
                verbose=False, device="cuda",
                resume_from=(os.path.join(tmp, resume + "_ckpt")
                             if resume else None))
            torch.cuda.synchronize()
            log(f"  implicit_dense fit {name}: {n_epoch} epochs, history "
                f"{hist}, {time.perf_counter() - t0:.2f} s [{card}]")
            runs[name] = {k: v.detach() for k, v in params.items()}
    diff = [k for k in runs["whole"]
            if not torch.equal(runs["whole"][k], runs["resumed"][k])]
    log(f"  implicit_dense resumed against uninterrupted: "
        f"{len(runs['whole']) - len(diff)} of {len(runs['whole'])} tensors "
        "bit-identical")
    check(not diff, f"implicit_dense resume: weights differ in {diff}")


SERVE_BUCKETS = (16384, 32768)
SERVE_BATCH = 4
# the serving process of phase 18: loads the artifact with the model stack
# (and jax) barred from import, serves each mesh at batch 1 and SERVE_BATCH
# through __call__ and a PreparedMesh, and saves the outputs. Barred as in
# tests/test_torch_serving.py: the port's models, geometry, data,
# experiments and training modules, all but training.profiling (the spans
# and counters the kernel wrappers and the serving call record into)
SERVE_BARRED = ("models", "geometry", "training.inference", "training.fit",
                "training.task", "training.checkpoint", "data", "experiments")
HERMETIC_SERVER = r"""
import json, sys
import numpy as np
import torch
BARRED = ("jax", "jaxlib", "flax", "optax", "diffusionnet_tpu")
PORT_BARRED = tuple("diffusionnet_tpu_torch." + m for m in %r)
class Bar:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BARRED or name.startswith(PORT_BARRED):
            raise ImportError("the serving process may not import " + name)
sys.meta_path.insert(0, Bar())
torch.set_float32_matmul_precision("highest")
from diffusionnet_tpu_torch.serving import load_serving_model
from diffusionnet_tpu_torch.ops import fused, megablock
artifact, inputs, out_path, dev = sys.argv[1:5]
sm = load_serving_model(artifact, device=dev)
z = np.load(inputs)
outs, launches = {}, []
for tag in [str(t) for t in z["tags"]]:
    ops = [torch.from_numpy(z[tag + "_" + k]).to(dev)
           for k in ("mass", "evals", "evecs", "gX", "gY")]
    faces = torch.from_numpy(z[tag + "_faces"]).to(dev)
    handle = sm.prepare(*ops, inds=faces)
    for b in ("1", "n"):
        x = torch.from_numpy(z[tag + "_x" + b]).to(dev)
        for route, fn in (("call", lambda: sm(
                x, *([o.expand(x.shape[0], *o.shape) for o in ops]
                     if x.ndim == 3 else ops),
                inds=faces.expand(x.shape[0], *faces.shape)
                if x.ndim == 3 else faces)),
                          ("handle", lambda: handle(x))):
            fused.reset_launches()
            megablock.reset_launches()
            outs[tag + "_" + route + b] = fn().cpu().numpy()
            launches.append({**fused.LAUNCHES, **megablock.LAUNCHES})
np.savez(out_path, **outs)
print(json.dumps({"modules": sorted(sys.modules), "launches": launches}))
"""


def request_times(fn, n=20):
    """Warm requests (fn ends in a host copy or a synchronize): host-clock
    median and p90 over n requests, then the device's busy time per
    request from the profiler over n more (None where the profiler reports
    no device time), its idle share, and the five host operators with the
    most self time per request."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    us = 0.0
    host = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += t if t is not None else e.self_cuda_time_total
        else:
            host.append((e.self_cpu_time_total / n / 1e3, e.key))
    busy = us / n / 1e3 if us > 0 else None
    return {"median_ms": statistics.median(walls),
            "p90_ms": walls[int(math.ceil(0.9 * n)) - 1],
            "busy_ms": busy, "profiled_wall_ms": wall,
            "idle_share": None if busy is None else 1 - busy / wall,
            "host_top": sorted(host, reverse=True)[:5]}


def phase_serving(mb, fu, card, seg_ds):
    """18: the serving slice. The segmentation model at full width (c_in 16
    HKS, c_out 8, c_width 128, 4 blocks, k 128, face outputs,
    use_pallas_fused, seeded weights) is exported on the card for the
    buckets SERVE_BUCKETS, loaded in this process and in a fresh one that
    may not import the model stack, and serves torus(144, 140) (bucket
    32768) and icosphere(5) (bucket 16384) through ServingModel.__call__
    and a PreparedMesh at batch 1 and SERVE_BATCH, held to the eager model
    on the dense route (`dense_route`) on the same card within SLICE_TOL.
    Each request launches B4's two kernels once a block; the hot path makes
    no host sync (torch.cuda.set_sync_debug_mode("error")). Then the warm
    request (batch 1, the torus) on three routes: InferenceSession with a
    cache hit, __call__ with the operators on the card, a PreparedMesh's
    handle(x). An artifact exported and loaded with both ends' defaults
    (traced on the CPU, moved to the card) serves icosphere(5) too.
    Returns the launch counts of phase 18's requests in this process."""
    import numpy as np
    from diffusionnet_tpu_torch.data.features import get_features
    from diffusionnet_tpu_torch.serving import (export_forward,
                                                load_serving_model)
    from diffusionnet_tpu_torch.serving.export import kernel_ops
    from diffusionnet_tpu_torch.training import InferenceSession

    log("== phase 18: the serving slice: export_forward of the fused "
        f"segmentation model on cuda, buckets {SERVE_BUCKETS}")
    t_phase = time.perf_counter()
    fused_model = segmentation_model(use_pallas_fused=True)
    plain_model = dense_route(segmentation_model()).to("cuda").eval()
    per_req = {"spectral_project": N_BLOCK, "spectral_apply": N_BLOCK,
               "spectral_ds": 0, "megablock_fwd": 0, "megablock_fwd_xhat": 0,
               "xhat_reduce": N_BLOCK,
               "megablock_bwd_rows": 0, "megablock_bwd_grads": 0,
               "grad_reduce": 0}
    tmp = tempfile.TemporaryDirectory()
    art = os.path.join(tmp.name, "artifact")
    t0 = time.perf_counter()
    export_forward(fused_model, SERVE_BUCKETS, art, K_EIG, device="cuda")
    export_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art))
    t0 = time.perf_counter()
    sm = load_serving_model(art, device="cuda")
    load_s = time.perf_counter() - t0
    graph_ops = {v: kernel_ops(ep) for v, ep in sm.programs.items()}
    log(f"  export {export_s:.2f} s, artifact {size} bytes "
        f"({sorted(os.listdir(art))}), load {load_s:.2f} s (host clock) "
        f"[{card}]; kernel ops in each bucket's graph: {graph_ops}")
    for v, found in graph_ops.items():
        check(found == {"spectral_project": N_BLOCK,
                        "spectral_apply": N_BLOCK},
              f"bucket {v}: the program's kernel ops are {found}")

    # the two meshes on the card, unbatched; a batch of SERVE_BATCH
    # distinct signals (HKS scaled per element)
    meshes = {}
    for tag, i, bucket in (("torus", 0, 32768), ("ico5", 1, 16384)):
        o = seg_ds.ops_list[i]
        ops = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
               for a in (o.mass, o.evals, o.evecs, o.gradX_spec,
                         o.gradY_spec)]
        faces = torch.from_numpy(seg_ds.faces_list[i].astype(np.int32)).cuda()
        x1 = get_features("hks", None, ops[1], ops[2]).contiguous()
        xn = torch.stack([x1 * (1 + 0.25 * j) for j in range(SERVE_BATCH)])
        check(sm.pick_bucket(x1.shape[0]) == bucket,
              f"{tag}: bucket {sm.pick_bucket(x1.shape[0])} != {bucket}")
        # the eager model on the same card, at the same bucket, on the dense
        # route
        pad = bucket - x1.shape[0]
        padded = [torch.nn.functional.pad(a, (0, 0, 0, pad)) for a in
                  (ops[2], ops[3], ops[4])]
        mass_p = torch.nn.functional.pad(ops[0], (0, pad))
        refs = {}
        with torch.no_grad():
            for b, x in (("1", x1), ("n", xn)):
                B = 1 if b == "1" else SERVE_BATCH
                xx = torch.nn.functional.pad(x.reshape(B, *x1.shape),
                                             (0, 0, 0, pad))
                rep = lambda a: a.expand(B, *a.shape).contiguous()
                out = without_b4(lambda: plain_model(
                    xx, rep(mass_p), rep(ops[1]), *(rep(a) for a in padded),
                    faces=rep(faces).long()), f"{tag}: the eager model")
                refs[b] = out[0] if b == "1" else out
        meshes[tag] = (ops, faces, x1, xn, refs)

    # in this process: __call__ and a PreparedMesh, batch 1 and SERVE_BATCH
    total = dict.fromkeys(per_req, 0)
    for tag, (ops, faces, x1, xn, refs) in meshes.items():
        handle = sm.prepare(*ops, inds=faces)
        for b, x in (("1", x1), ("n", xn)):
            B = x.shape[0] if x.ndim == 3 else 1
            bops = ([a.expand(B, *a.shape) for a in ops] if x.ndim == 3
                    else ops)
            bf = faces.expand(B, *faces.shape) if x.ndim == 3 else faces
            for route, fn in (("__call__", lambda: sm(x, *bops, inds=bf)),
                              ("handle", lambda: handle(x))):
                torch.cuda.synchronize()
                fu.reset_launches()
                mb.reset_launches()
                out = fn()
                torch.cuda.synchronize()
                got = {**fu.LAUNCHES, **mb.LAUNCHES}
                check(got == per_req, f"{tag} {route} batch {B}: launches "
                      f"{got} != {per_req}")
                total = {k: total[k] + got[k] for k in total}
                compare(f"{tag} {route} batch {B} {tuple(out.shape)} against "
                        "the eager model", out, refs[b], SLICE_TOL)

    # the defaults of both ends: export_forward traces for the model's
    # device (the CPU, where the model was built) and load_serving_model
    # loads onto the card, moving the programs with move_to_device_pass
    art_cpu = os.path.join(tmp.name, "artifact_cpu")
    t0 = time.perf_counter()
    export_forward(fused_model, SERVE_BUCKETS[:1], art_cpu, K_EIG)
    with open(os.path.join(art_cpu, "manifest.json")) as f:
        platforms = json.load(f)["platforms"]
    sm_cpu = load_serving_model(art_cpu)
    check(platforms == ["cpu"] and sm_cpu.device.type == "cuda",
          f"default export/load: platforms {platforms}, loaded on "
          f"{sm_cpu.device}")
    found = kernel_ops(sm_cpu.programs[SERVE_BUCKETS[0]])
    check(found == {"spectral_project": N_BLOCK, "spectral_apply": N_BLOCK},
          f"the moved program's kernel ops are {found}")
    ops, faces, x1, xn, refs = meshes["ico5"]
    handle = sm_cpu.prepare(*ops, inds=faces)
    for route, fn, want in (
            ("__call__ batch 1", lambda: sm_cpu(x1, *ops, inds=faces),
             refs["1"]),
            (f"handle batch {SERVE_BATCH}", lambda: handle(xn), refs["n"])):
        torch.cuda.synchronize()
        fu.reset_launches()
        mb.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {**fu.LAUNCHES, **mb.LAUNCHES}
        check(got == per_req, f"CPU-traced artifact on the card, {route}: "
              f"launches {got} != {per_req}")
        total = {k: total[k] + got[k] for k in total}
        compare(f"CPU-traced artifact on the card, ico5 {route} "
                f"{tuple(out.shape)} against the eager model", out, want,
                SLICE_TOL)
    log(f"  CPU-traced artifact (platforms {platforms}) loaded on the card "
        f"with the defaults: {time.perf_counter() - t0:.2f} s for export, "
        "load and 2 requests")

    # no host sync on the hot path: warm __call__ with the operators on
    # the card and handle(x), batch 1 and SERVE_BATCH
    ops, faces, x1, xn, refs = meshes["torus"]
    handle = sm.prepare(*ops, inds=faces)
    handle(x1), handle(xn), sm(x1, *ops, inds=faces)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = (sm(x1, *ops, inds=faces), handle(x1), handle(xn))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for out, want in zip(outs, (refs["1"], refs["1"], refs["n"])):
        check(out.shape == want.shape, f"no-sync run: {tuple(out.shape)}")
    log("  no host sync on the hot path (set_sync_debug_mode('error')): "
        "__call__ with the operators on the card, handle(x) at batch 1 and "
        f"{SERVE_BATCH}")

    # the same artifact in a fresh process that may not import the model
    # stack (nor jax)
    here = os.path.dirname(os.path.abspath(__file__))
    inputs = os.path.join(tmp.name, "inputs.npz")
    arrays = {"tags": np.array(list(meshes))}
    for tag, (ops, faces, x1, xn, refs) in meshes.items():
        for k, a in zip(("mass", "evals", "evecs", "gX", "gY"), ops):
            arrays[f"{tag}_{k}"] = a.cpu().numpy()
        arrays[f"{tag}_faces"] = faces.cpu().numpy()
        arrays[f"{tag}_x1"], arrays[f"{tag}_xn"] = (x1.cpu().numpy(),
                                                    xn.cpu().numpy())
    np.savez(inputs, **arrays)
    script = os.path.join(tmp.name, "server.py")
    with open(script, "w") as f:
        f.write(HERMETIC_SERVER % (SERVE_BARRED,))
    out_path = os.path.join(tmp.name, "served.npz")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, script, art, inputs, out_path, "cuda"],
        capture_output=True, text=True, timeout=300, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
    check(res.returncode == 0, f"the serving process failed:\n{res.stderr}")
    report = json.loads(res.stdout.strip().splitlines()[-1])
    barred = [m for m in report["modules"]
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                     "diffusionnet_tpu")
              or m.startswith(tuple(
                  "diffusionnet_tpu_torch." + p for p in SERVE_BARRED))]
    check(not barred, f"the serving process imported {barred}")
    check(all(got == per_req for got in report["launches"]),
          f"the serving process's launches {report['launches']}")
    served = np.load(out_path)
    for tag, (ops, faces, x1, xn, refs) in meshes.items():
        for b in ("1", "n"):
            for route in ("call", "handle"):
                compare(f"hermetic {tag} {route} batch {b}",
                        torch.from_numpy(served[f"{tag}_{route}{b}"]),
                        refs[b].cpu(), SLICE_TOL)
    log(f"  the serving process: {time.perf_counter() - t0:.2f} s (start, "
        f"load, 8 requests); {len(report['modules'])} modules, none of the "
        f"model stack; launches per request {report['launches'][0]}")

    # the warm request, batch 1, torus(144, 140): three routes
    mg = meshgen()
    verts, tfaces = mg.torus(n_major=144, n_minor=140)
    ops, faces, xd = meshes["torus"][:3]
    routes = {}
    with tempfile.TemporaryDirectory() as cache:
        sess = InferenceSession(fused_model, k_eig=K_EIG, op_cache_dir=cache,
                                device="cuda")
        sess(verts, tfaces)  # cold: fills the cache
        routes["(a) InferenceSession, fused model, cache hit"] = (
            request_times(lambda: sess(verts, tfaces)))
    routes["(b) ServingModel.__call__, operators on the card"] = (
        request_times(lambda: sm(xd, *ops, inds=faces)))
    routes["(c) PreparedMesh handle(x), x on the card"] = request_times(
        lambda: handle(xd))
    for name, r in routes.items():
        busy = ("not measured" if r["busy_ms"] is None else
                f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.4f}")
        log(f"  warm request {name}: median {r['median_ms']:.3f} ms, p90 "
            f"{r['p90_ms']:.3f} ms (host clock, 20 requests); device busy "
            f"{busy} (profiled wall {r['profiled_wall_ms']:.3f} ms) [{card}]"
            "; host self time per request, largest: " + ", ".join(
                f"{k[:40]} {ms:.3f} ms" for ms, k in r["host_top"]))
    tmp.cleanup()
    log(f"  phase 18: {time.perf_counter() - t_phase:.1f} s")
    return total



# --- point clouds, geodesics and the two examples: phases 19, 19b, 17d ------

# E5 (experiments/sampling_invariance.py:136): build_model(n_class=6890,
# c_width=256, outputs_at="vertices", dropout=True, input_features="xyz"),
# evaluated on the cloud split
E5_CLASSES = 6890


def e5_clouds():
    """The two clouds of phase 19, each (name, points, normals, hull mesh or
    None): 6,890 Fibonacci-sphere points (FAUST's vertex count) deformed by
    the examples' `bumpy`, with normals from their hull mesh (as
    sampling_invariance_synthetic builds its cloud split); and the 20,160
    vertices of torus(144, 140) with the mesh's normals."""
    from diffusionnet_tpu_torch.examples import (
        sampling_invariance_synthetic as si)
    from diffusionnet_tpu_torch.geometry import mesh_vertex_normals_np
    mg = meshgen()
    dirs, faces = si.sphere_hull_mesh(si.fibonacci_sphere(E5_CLASSES))
    verts = si.bumpy(dirs)
    tv, tf = mg.torus(n_major=144, n_minor=140)
    return [("fibonacci_bumpy(6890)", verts,
             mesh_vertex_normals_np(verts, faces), (verts, faces)),
            ("torus(144, 140) cloud", tv, mesh_vertex_normals_np(tv, tf),
             (tv, tf))]


def phase_clouds(mb, be, card):
    """19: the E5 cloud split at full width. Each cloud's operators through
    get_operators(faces=None, k_eig=128) on the device solver (stage
    seconds, fallbacks, B5 launches; the eigenspaces held to host ARPACK by
    phase 12's measure), then E5's model (seeded weights) through
    apply_model on the megakernel path at batch 1, held to the eager model
    at SLICE_TOL; the warm request timed. Returns (the launches of B1 and
    B5 in the phase, each cloud's predictions)."""
    import warnings
    import numpy as np
    from diffusionnet_tpu_torch.data import SurfaceDataset, make_padded_batches
    from diffusionnet_tpu_torch.experiments.exp_common import build_model
    from diffusionnet_tpu_torch.geometry import eigen as eig
    from diffusionnet_tpu_torch.geometry import operators as ops_mod
    from diffusionnet_tpu_torch.models import flat_params
    from diffusionnet_tpu_torch.training import TaskConfig, apply_model

    log("== phase 19: the E5 cloud split: get_operators(faces=None, "
        "k_eig=128) on the device solver, E5's model (c_width 256, 6890 "
        "classes, xyz) through apply_model(use_megakernel=True) on cuda")
    model = build_model(n_class=E5_CLASSES, c_width=256,
                        outputs_at="vertices", dropout=True,
                        input_features="xyz")
    model.reset_parameters(torch.Generator().manual_seed(19))
    dense = dense_route(model)
    params = flat_params(model, "cuda")
    mega = TaskConfig(input_features="xyz", labels_kind="vertex",
                      use_megakernel=True)
    eager = TaskConfig(input_features="xyz", labels_kind="vertex",
                       use_megakernel=False)
    torch.cuda.synchronize()
    mb.reset_launches()
    be.reset_launches()
    preds, clouds = {}, e5_clouds()
    for name, verts, normals, _ in clouds:
        tm = {}
        fallbacks = ops_mod.EIGEN_FALLBACKS
        b5 = be.LAUNCHES["blocked_ell"]
        with tempfile.TemporaryDirectory() as cache, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            ops = ops_mod.get_operators(verts, None, k_eig=K_EIG,
                                        op_cache_dir=cache, normals=normals,
                                        timings=tm)
            wall = time.perf_counter() - t0
        rise = be.LAUNCHES["blocked_ell"] - b5
        fell = ops_mod.EIGEN_FALLBACKS - fallbacks
        log(f"  {name}: V={verts.shape[0]}: cold precompute {wall:.3f} s "
            f"[{card}]; stages (s): triangulation "
            f"{tm.get('triangulation', 0.0):.3f}, laplacian "
            f"{tm.get('laplacian', 0.0):.3f}, eigensolve "
            f"{tm.get('eigensolve', 0.0):.3f}, build_grad "
            f"{tm.get('build_grad', 0.0):.3f}; all: "
            + ", ".join(f"{k} {v:.3f}" for k, v in tm.items()))
        log(f"    EIGEN_FALLBACKS +{fell} (now {ops_mod.EIGEN_FALLBACKS}), "
            f"B5 launches {rise}; converge: {eig.LAST_CONVERGE_INFO}")
        for w in caught:
            log(f"    warning: {w.message}")
        check(rise > 0, f"{name}: B5 did not launch")
        check(ops.evecs.shape == (verts.shape[0], K_EIG)
              and bool(np.isfinite(ops.evecs).all()),
              f"{name}: operators not finite or misshapen")
        t0 = time.perf_counter()
        host = ops_mod.compute_operators(verts, None, K_EIG, normals=normals,
                                         eigensolver="host")
        host_s = time.perf_counter() - t0
        ev_h = host.evals.astype(np.float64)
        ev_err = float(np.abs(ops.evals - ev_h).max() / ev_h.max())
        j = _cluster_closed_cut(ev_h, K_EIG)
        ang = _angle_err(ops.evecs[:, :j].astype(np.float64),
                         host.evecs[:, :j].astype(np.float64),
                         host.mass.astype(np.float64))
        log(f"    host ARPACK {host_s:.3f} s [{card}]; evals max |device - "
            f"host| / max {ev_err:.3e} (tolerance 1e-6); principal angles on "
            f"the cluster-closed cut j={j}: max |s - 1| {ang:.3e} "
            "(tolerance 1e-6)")
        check(ev_err <= 1e-6, f"{name}: eigenvalues off ARPACK")
        check(ang <= 1e-6, f"{name}: subspace off ARPACK")

        ds = SurfaceDataset(labels_kind="vertex")
        ds.add(verts, None, np.arange(verts.shape[0]) % E5_CLASSES)
        ds.ops_list = [ops]
        batch = next(make_padded_batches(ds, 1)).to("cuda")
        want_v = 8192 if verts.shape[0] <= 8192 else 32768
        check(tuple(batch.verts.shape[:2]) == (1, want_v),
              f"{name}: batch {tuple(batch.verts.shape)}")

        def request(cfg=mega, m=model):
            with torch.no_grad():
                return apply_model(m, params, batch, None, cfg,
                                   deterministic=True)
        before = dict(mb.LAUNCHES)
        out = request()
        torch.cuda.synchronize()
        got = {k: mb.LAUNCHES[k] - before[k] for k in before}
        ref = without_b4(lambda: request(eager, dense), f"{name}: the eager "
                         "model")
        n = verts.shape[0]
        err = compare(f"{name}: E5 model on B1 against the eager model "
                      f"(B=1, V={want_v})", out[0, :n], ref[0, :n],
                      SLICE_TOL)
        check(got["megablock_fwd"] == N_BLOCK, f"{name}: B1 launches {got}")
        log(f"    B1 launches in one request: {got}; max abs err {err:.3e}")
        preds[name] = out[0, :n].argmax(-1).cpu().numpy()
        ev_ms = time_ms(request, reps=10, calls=1, warmup=2)
        rt = request_times(lambda: request().sum().item(), n=10)
        busy = ("not measured" if rt["busy_ms"] is None
                else f"{rt['busy_ms']:.3f} ms, idle share "
                     f"{rt['idle_share']:.4f}")
        log(f"    warm request (batch 1, V={want_v}): CUDA events median "
            f"{ev_ms:.3f} ms; host clock median {rt['median_ms']:.3f} ms, "
            f"p90 {rt['p90_ms']:.3f} ms; device busy {busy} [{card}]")
        del batch, ds, ops, host, out, ref
    torch.cuda.synchronize()
    launches = dict(mb.LAUNCHES, blocked_ell=be.LAUNCHES["blocked_ell"])
    log(f"  launches of phase 19 (two clouds' precompute; per cloud two "
        f"megakernel requests and the timed ones): {launches}")
    check(launches["megablock_fwd"] > 0 and launches["blocked_ell"] > 0,
          f"phase 19 launched no B1 or no B5: {launches}")
    return launches, preds, clouds


def phase_geodesics(card, preds, clouds):
    """19b: all_pairs_heat_device on the card for the 6,890-vertex hull mesh
    and torus(144, 140), against the host heat method (HeatMethodSolver at
    the device solver's diffusion time) on 256 seeded sources within 1e-3
    of the diameter (tests/test_geometry.py:462's bound); seconds and peak
    device memory; then geodesic_label_errors(method='heat_device') of
    phase 19's predictions on the hull mesh."""
    import numpy as np
    from diffusionnet_tpu_torch.geometry import (HeatMethodSolver,
                                                 all_pairs_heat_device,
                                                 geodesic_label_errors)
    log("== phase 19b: heat-method geodesics on the card "
        "(all_pairs_heat_device)")
    for name, _, _, (verts, faces) in clouds:
        V = verts.shape[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        table = all_pairs_heat_device(verts, faces)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        src = np.sort(np.random.RandomState(19).choice(V, 256,
                                                       replace=False))
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]])
        h = np.linalg.norm(verts[edges[:, 0]] - verts[edges[:, 1]],
                           axis=1).mean()
        diam = np.linalg.norm(verts.max(axis=0) - verts.min(axis=0))
        t_eff = max(h * h, (diam / 60.0) ** 2)
        t0 = time.perf_counter()
        host = HeatMethodSolver(verts, faces,
                                t_coef=t_eff / (h * h)).distance(src)
        host_s = time.perf_counter() - t0
        err = float(np.abs(table[src] - host).max() / host.max())
        log(f"  {name} mesh: V={V}: all-pairs table ({V} x {V}) on the card "
            f"{secs:.3f} s, peak device memory {peak / 2**30:.3f} GiB "
            f"[{card}]; host heat method on 256 sources {host_s:.3f} s; "
            f"max |device - host| / diameter {err:.3e} (tolerance 1e-3)")
        check(bool(np.isfinite(table).all()), f"{name}: non-finite table")
        check(err < 1e-3, f"{name}: heat_device off the host heat method")
        del table
    name, _, _, (verts, faces) = clouds[0]
    pred = preds[name]
    info = {}
    with tempfile.TemporaryDirectory() as cache:
        t0 = time.perf_counter()
        errs = geodesic_label_errors(verts, faces, pred,
                                     np.arange(verts.shape[0]),
                                     geodesic_cache_dir=cache,
                                     method="heat_device", info=info)
        secs = time.perf_counter() - t0
    log(f"  geodesic_label_errors(method='heat_device') of phase 19's "
        f"predictions on {name} (seeded weights, untrained): mean "
        f"{float(errs.mean()):.4f}, max {float(errs.max()):.4f} of the "
        f"diameter, {secs:.3f} s, ran {info.get('ran')} [{card}]")
    check(errs.shape == pred.shape and bool(np.isfinite(errs).all())
          and float(errs.min()) >= 0.0 and float(errs.max()) <= 1.0,
          "geodesic label errors out of [0, 1]")


def phase_examples(mb, be, card):
    """17d: the two ported examples at their defaults on the card:
    fmaps_synthetic (held-out fmap L2 and mean angular error) and
    sampling_invariance_synthetic --gate (the per-mutation table; the gate
    failing fails the phase). Returns their launches of B1 and B5."""
    import math as _math
    from diffusionnet_tpu_torch.examples import (
        fmaps_synthetic, sampling_invariance_synthetic)
    log("== phase 17d: the examples fmaps_synthetic and "
        "sampling_invariance_synthetic --gate at their defaults on cuda")
    torch.cuda.synchronize()
    mb.reset_launches()
    be.reset_launches()
    t0 = time.perf_counter()
    res = fmaps_synthetic.main([])
    secs = time.perf_counter() - t0
    log(f"  fmaps_synthetic: held-out fmap L2 {res['test_fmap_l2']:.4e}, "
        f"mean angular error {res['mean_angular_err_deg']:.2f} deg, exact "
        f"matches {100 * res['exact_match']:.1f}%; {secs:.2f} s [{card}]")
    check(all(_math.isfinite(v) for v in res.values()),
          f"fmaps_synthetic: {res}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec = sampling_invariance_synthetic.main(
            ["--gate", "--out", os.path.join(tmp, "table.jsonl")])
        secs = time.perf_counter() - t0
    for mname, r in rec["per_mutation"].items():
        log(f"  sampling_invariance {mname:>6}: V={r['n_verts']}, "
            f"exact-label acc {r['exact_label_acc_pct']:.2f}%, mean angular "
            f"err {r['mean_angular_err_deg']:.3f} deg")
    log(f"  gate {rec['gate']}; {secs:.2f} s [{card}]")
    check(rec["gate"]["ok"], "sampling_invariance gate failed")
    torch.cuda.synchronize()
    launches = dict(mb.LAUNCHES, blocked_ell=be.LAUNCHES["blocked_ell"])
    log(f"  launches of phase 17d (both examples): {launches}")
    return launches


# phase 20: each suite's layout at the suite's real sizes. Meshes are
# jittered tori of meshgen: torus(106, 65) has FAUST's 6,890 vertices,
# torus(144, 140) 20,160; RNA's 15-20k; SHREC11's MeshCNN meshes about 250
# (torus(20, 13), 260). A driver's output tolerances: fmaps --evaluate on
# the card against the CPU (test loss rtol, geodesic error absolute, the
# number being normalized by sqrt(area)); human segmentation --evaluate (the
# eager route) against fit's logged accuracy of the same weights (fit ran
# B1: an argmax tie may flip), in percentage points.
DRIVER_TORI = dict(faust=(106, 65), big=(144, 140),
                   rna=((120, 125), (128, 125), (130, 140), (144, 140)),
                   shrec=(20, 13), qes=(90, 60), mc=(100, 70))
DRIVER_SHREC_PER_CLASS = (2, 1)   # meshes in each class's train, test dir
FMAPS_CPU_TOL = dict(loss_rtol=1e-4, geo_atol=1e-3, own=4.0, perturb=1e-7)
SEG_EVAL_PP = 0.5
DRIVER_KERNELS = ("megablock_fwd", "megablock_fwd_xhat", "xhat_reduce",
                  "megablock_bwd_rows", "megablock_bwd_grads", "grad_reduce",
                  "blocked_ell")


def suite_pretrained(suite):
    from diffusionnet_tpu_torch.experiments.exp_common import suite_dir
    return os.path.join(suite_dir(suite), "pretrained_models")


def _jittered_torus(key, seed, scale=0.002):
    import numpy as np
    mg = meshgen()
    v, f = mg.torus(*key)
    return v + scale * np.random.RandomState(seed).randn(*v.shape), f


def phase_drivers(mb, be, card, device="cuda"):
    """20: the five experiment drivers of the port, each through its
    main([...]) on its suite's layout (experiments.layouts) in a temporary
    directory, at the driver's own width, on the card:
    human_segmentation_original (--megakernel, 2 epochs, then --evaluate of
    its best checkpoint), rna_mesh_segmentation (the eager default, buckets
    16384 and 32768, 1 epoch), classification_shrec11 (simplified layout,
    --megakernel, 1 epoch), sampling_invariance (6,890 classes at C 256,
    --megakernel, heat_device geodesics, 1 epoch) and functional_
    correspondence (--evaluate on the reference's faust_hks.npz on the card
    and on the CPU, then 1 epoch). Prints each driver's seconds, result and
    launches; returns the launches of all five."""
    from diffusionnet_tpu_torch.experiments import layouts
    from diffusionnet_tpu_torch.experiments.classification_shrec11 import (
        classification_shrec11 as shrec)
    from diffusionnet_tpu_torch.experiments.functional_correspondence \
        import functional_correspondence as fmaps
    from diffusionnet_tpu_torch.experiments.human_segmentation_original \
        import human_segmentation_original as hseg
    from diffusionnet_tpu_torch.experiments.rna_mesh_segmentation import (
        rna_mesh_segmentation as rna)
    from diffusionnet_tpu_torch.experiments.sampling_invariance import (
        sampling_invariance as si)
    import numpy as np
    from diffusionnet_tpu_torch.geometry import mesh_vertex_normals_np
    from scipy.spatial import cKDTree

    log("== phase 20: the five drivers on the card, each through main() "
        "on its layout at full width")
    t_phase = time.perf_counter()
    total = dict.fromkeys(DRIVER_KERNELS, 0)
    dev = ["--device", device]

    def drive(name, main, argv):
        torch.cuda.synchronize()
        mb.reset_launches()
        be.reset_launches()
        t0 = time.perf_counter()
        res = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: (be.LAUNCHES if k == "blocked_ell" else mb.LAUNCHES)[k]
               for k in DRIVER_KERNELS}
        for k in DRIVER_KERNELS:
            total[k] += got[k]
        stages = {k: round(v, 3) for k, v in res["seconds"].items()}
        log(f"  {name}: {secs:.2f} s in all; stages {stages}; precompute "
            f"stages {sorted(res['precompute_stages'])}; launches {got} "
            f"[{card}]")
        return res, got

    with tempfile.TemporaryDirectory() as tmp:
        # human_segmentation_original: 4 train meshes, 2 test geometries
        # on the 18 shrec names
        faust, big = DRIVER_TORI["faust"], DRIVER_TORI["big"]
        root = layouts.human_segmentation(
            os.path.join(tmp, "hseg"),
            [_jittered_torus(faust, 0), _jittered_torus(faust, 1),
             _jittered_torus(big, 2), _jittered_torus(big, 3)],
            [_jittered_torus(faust, 4), _jittered_torus(big, 5)])
        res, got = drive("human_segmentation_original --megakernel, 2 "
                         "epochs", hseg.main,
                         ["--n_epoch", "2", "--megakernel", "--data_dir",
                          root] + dev)
        check(got["megablock_fwd"] > 0 and got["megablock_bwd_rows"] > 0
              and got["blocked_ell"] > 0,
              f"human segmentation: B1, B2 or B5 not launched: {got}")
        best = max(res["history"], key=lambda h: h[2])
        ckpt = os.path.join(res["model_save_path"] + "_ckpt",
                            f"step_{best[0]}.npz")
        ev, _ = drive(f"human_segmentation_original --evaluate of step "
                      f"{best[0]}", hseg.main,
                      ["--evaluate", "--load_model", ckpt, "--data_dir",
                       root] + dev)
        diff = 100 * abs(ev["test_acc"] - best[2])
        log(f"  human segmentation: history {res['history']}; final test "
            f"accuracy {100 * res['test_acc']:.3f}%; --evaluate of epoch "
            f"{best[0]}'s checkpoint {100 * ev['test_acc']:.3f}% against "
            f"fit's {100 * best[2]:.3f}% ({diff:.3f} pp, bound "
            f"{SEG_EVAL_PP})")
        check(diff <= SEG_EVAL_PP, "human segmentation --evaluate disagrees "
              "with fit's logged accuracy")

        # rna_mesh_segmentation: 3 train, 1 test, the eager default route
        root = layouts.rna(os.path.join(tmp, "rna"),
                           [_jittered_torus(k, 10 + i) for i, k in
                            enumerate(DRIVER_TORI["rna"])], n_train=3)
        res, got = drive("rna_mesh_segmentation (eager), 1 epoch", rna.main,
                         ["--n_epoch", "1", "--buckets", "16384,32768",
                          "--data_dir", root] + dev)
        log(f"  rna: test accuracy {100 * res['test_acc']:.3f}% (260 "
            f"classes), history {res['history']}")
        check(got["blocked_ell"] > 0 and got["megablock_fwd"] == 0,
              f"rna: B5 not launched, or B1 on the eager route: {got}")

        # classification_shrec11, simplified: 30 classes x 3 meshes
        n_tr, n_te = DRIVER_SHREC_PER_CLASS
        root = layouts.shrec11_simplified(
            os.path.join(tmp, "shrec"),
            lambda c, t, i: _jittered_torus(DRIVER_TORI["shrec"],
                                            100 + 3 * c + i + n_tr
                                            * (t == "test"), scale=0.01),
            n_train=n_tr, n_test=n_te)
        res, got = drive("classification_shrec11 --megakernel, 1 epoch",
                         shrec.main,
                         ["--dataset_type", "simplified", "--split_size",
                          "2", "--n_epoch", "1", "--megakernel",
                          "--data_dir", root] + dev)
        log(f"  shrec11: test accuracy {100 * res['test_acc']:.3f}% (30 "
            f"classes); B5 has no launch here: meshes of at most "
            f"min(12 n_cols, 4096) rows take the solver's dense route, as "
            f"in the JAX package")
        check(got["megablock_fwd"] > 0 and got["megablock_bwd_rows"] > 0,
              f"shrec11: B1 or B2 not launched: {got}")

        # sampling_invariance: 2 training registrations and 1 held-out
        # shape in the six mutations; labels of a remeshing: the nearest
        # template vertex
        regs = [_jittered_torus(faust, 20 + i) for i in range(3)]
        tree = cKDTree(regs[0][0])
        v, f = regs[2]

        def remesh(key, seed):
            rv, rf = _jittered_torus(key, seed)
            return rv, rf, tree.query(rv)[1]
        muts = {"iso": [remesh(faust, 30)], "qes": [remesh(DRIVER_TORI["qes"],
                                                           31)],
                "mc": [remesh(DRIVER_TORI["mc"], 32)],
                "dense": [remesh(big, 33)],
                "cloud": [(v, mesh_vertex_normals_np(v, f),
                           np.arange(len(v)))]}
        root = layouts.sampling_invariance(os.path.join(tmp, "si"), regs,
                                           muts)
        res, got = drive("sampling_invariance --megakernel (C 256, 6,890 "
                         "classes), 1 epoch", si.main,
                         ["--n_epoch", "1", "--megakernel", "--n_train", "2",
                          "--n_test", "1", "--geodesic_method",
                          "heat_device", "--data_dir", root] + dev)
        means = {m: round(100 * e, 3) for m, e in
                 res["geodesic_means"].items()}
        log(f"  sampling_invariance: test accuracy "
            f"{100 * res['test_acc']:.3f}%; per-mutation mean geodesic "
            f"error (heat_device, % of the diameter) {means}")
        check(got["megablock_fwd"] > 0 and got["megablock_bwd_rows"] > 0
              and got["blocked_ell"] > 0,
              f"sampling_invariance: B1, B2 or B5 not launched: {got}")
        check(all(math.isfinite(e) for e in means.values()),
              f"sampling_invariance: geodesic means {means}")

        # functional_correspondence: 5 shapes with .vts; --evaluate on the
        # reference's faust_hks.npz on the card, then on the CPU from a copy
        # of the data with its caches (the same operators and geodesic
        # table: the CPU's heat_device takes 37 s at 6,890 vertices, and
        # phase 19b holds the card's table to the host's), then 1 epoch
        root = layouts.fmaps(os.path.join(tmp, "fmaps"),
                             [_jittered_torus(faust, 40 + i)
                              for i in range(5)], n_vts=200)
        fm = ["--n_train", "3", "--n_test", "2", "--geodesic_method",
              "heat_device"]
        res, got = drive("functional_correspondence --evaluate "
                         "(faust_hks.npz)", fmaps.main,
                         ["--evaluate", "--data_dir", root] + fm + dev)
        cpu_root = os.path.join(tmp, "fmaps_cpu")
        shutil.copytree(root, cpu_root)
        res_cpu, _ = drive("functional_correspondence --evaluate on the "
                           "CPU", fmaps.main,
                           ["--evaluate", "--data_dir", cpu_root] + fm
                           + ["--device", "cpu"])
        # the evaluation's own rounding sensitivity: the CPU run again on
        # the weights changed by 1e-7 relative (the map is a regularized
        # f32 solve, and the vertex map a nearest-neighbour choice); the
        # card must agree within the stated bounds, or within FMAPS_CPU_TOL
        # ["own"] times that change where it is larger
        from diffusionnet_tpu_torch.experiments.tools.\
            convert_torch_checkpoint import load_converted
        rs = np.random.RandomState(0)
        npz = os.path.join(suite_pretrained("functional_correspondence"),
                           "faust_hks.npz")
        nudged = os.path.join(tmp, "faust_hks_nudged.npz")
        np.savez(nudged, **{
            k[len("params/"):]: (v * (1 + FMAPS_CPU_TOL["perturb"]
                                      * rs.randn(*v.shape))).astype(v.dtype)
            for k, v in load_converted(npz).items()})
        res_own, _ = drive("functional_correspondence --evaluate on the CPU,"
                           " weights changed by 1e-7", fmaps.main,
                           ["--evaluate", "--load_model", nudged,
                            "--data_dir", cpu_root] + fm
                           + ["--device", "cpu"])
        d_loss = abs(res["test_loss"] - res_cpu["test_loss"])
        d_geo = abs(res["geodesic_error"] - res_cpu["geodesic_error"])
        own_loss = abs(res_own["test_loss"] - res_cpu["test_loss"])
        own_geo = abs(res_own["geodesic_error"] - res_cpu["geodesic_error"])
        b_loss = max(FMAPS_CPU_TOL["loss_rtol"] * res_cpu["test_loss"],
                     FMAPS_CPU_TOL["own"] * own_loss)
        b_geo = max(FMAPS_CPU_TOL["geo_atol"], FMAPS_CPU_TOL["own"] * own_geo)
        log(f"  fmaps --evaluate: test loss {res['test_loss']:.6e} (card) "
            f"{res_cpu['test_loss']:.6e} (CPU), geodesic error "
            f"{res['geodesic_error']:.6e} / {res_cpu['geodesic_error']:.6e}"
            f"; differences {d_loss:.3e} ({d_loss / res_cpu['test_loss']:.3e}"
            f" relative), {d_geo:.3e}; the CPU's own change under the "
            f"nudge {own_loss:.3e} ({own_loss / res_cpu['test_loss']:.3e} "
            f"relative), {own_geo:.3e}; bounds {b_loss:.3e}, {b_geo:.3e} "
            f"({FMAPS_CPU_TOL})")
        check(d_loss <= b_loss and d_geo <= b_geo,
              "fmaps --evaluate on the card disagrees with the CPU")
        check(res_cpu["precompute_stages"] == {},
              "the CPU evaluation did not read the card's operators")
        res, got = drive("functional_correspondence, 1 epoch (6 pairs)",
                         fmaps.main,
                         ["--n_epoch", "1", "--data_dir", root] + fm + dev)
        log(f"  fmaps training: {res['log']}")
        check(all(math.isfinite(x["train_loss"]) for x in res["log"]),
              f"fmaps: {res['log']}")
    log(f"  launches of phase 20 (all five drivers): {total}; phase "
        f"{time.perf_counter() - t_phase:.2f} s [{card}]")
    return total

# --- training over several ranks: phase 21 -----------------------------------

# the kernels a sharded step or forward launches (B1, its x_hat kernel and
# partial sum, B2's two kernels and partial sums)
PAR_KERNELS = ("megablock_fwd", "megablock_fwd_xhat", "xhat_reduce",
               "megablock_bwd_rows", "megablock_bwd_grads", "grad_reduce")
# phase 21b's vertex-sharded forward against one process's B1 (elementwise,
# atol of max |single|): the same products, with each block's x_hat summed
# as two half-V partials and an all-reduce instead of one split-V sum,
# through four blocks
PAR_FWD_TOL = SLICE_TOL
PAR_TORUS_V = 32768   # the torus's bucket (16,384 rows a rank)
# the kernels of the fused model's sharded forward and step (B4's three and
# the partial sum of its projections); each block launches the projection,
# the apply and one xhat_reduce forward, and in the backward spectral_ds
# and its xhat_reduce, on every rank
PAR_B4_KERNELS = ("spectral_project", "spectral_apply", "spectral_ds",
                  "xhat_reduce")
PAR_B4_WANT = {"fused_fwd": (N_BLOCK, N_BLOCK, 0, N_BLOCK),
               "fused_step": (N_BLOCK, N_BLOCK, N_BLOCK, 2 * N_BLOCK)}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _bundle_arrays(prefix, ops) -> dict:
    """An Operators bundle (numpy or tensors) as npz entries."""
    import numpy as np
    out = {}
    for f, a in ops._asdict().items():
        if a is None:
            continue
        if hasattr(a, "idx"):
            out[f"{prefix}{f}/idx"], out[f"{prefix}{f}/val"] = a.idx, a.val
        else:
            out[prefix + f] = a
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in out.items()}


def _bundle(z, prefix):
    from diffusionnet_tpu_torch.geometry import Operators
    from diffusionnet_tpu_torch.ops.sparse import Ell
    fields = {}
    for f in Operators._fields:
        if prefix + f + "/idx" in z:
            fields[f] = Ell(z[prefix + f + "/idx"], z[prefix + f + "/val"])
        else:
            fields[f] = z.get(prefix + f)
    return Operators(**fields)


def _par_launches(mb):
    torch.cuda.synchronize()
    return {k: mb.LAUNCHES[k] for k in PAR_KERNELS}


def _b4_launches(mb, fu):
    """B4's launches and xhat_reduce's, in PAR_B4_KERNELS' order."""
    import numpy as np
    torch.cuda.synchronize()
    return np.asarray([fu.LAUNCHES.get(k, mb.LAUNCHES.get(k))
                       for k in PAR_B4_KERNELS])


def fused_vertex_model():
    """Phase 21b's fused model: the segmentation model (seeded weights and
    diffusion times) with vertex outputs, dropout off, on B4."""
    return segmentation_model(outputs_at="vertices", dropout=False,
                              use_pallas_fused=True)


def _par_rank(rank, world, inputs, rna_root):
    """One of phase 21b's two ranks, on the one card over gloo (CUDA
    tensors): the vertex-sharded forward at vert 2, one (1, 2) step, one
    (2, 1) step, the fused model's vertex-sharded forward and (1, 2) step,
    and the RNA driver with --mesh 1,2; returns each one's results and
    launches."""
    import numpy as np
    import torch.distributed as dist
    from diffusionnet_tpu_torch import _build
    from diffusionnet_tpu_torch.data import PaddedBatch
    from diffusionnet_tpu_torch.experiments.rna_mesh_segmentation import (
        rna_mesh_segmentation as rna)
    from diffusionnet_tpu_torch.models import DiffusionNet
    from diffusionnet_tpu_torch.ops import fused as fu
    from diffusionnet_tpu_torch.ops import megablock as mb
    from diffusionnet_tpu_torch.parallel import (
        VertexGroup, make_dp_train_step, make_mesh, make_two_axis_train_step,
        shard_batch, vertex_sharded_forward,
        vertex_sharded_megakernel_forward)
    from diffusionnet_tpu_torch.training import (
        TaskConfig, adam_with_step_decay, apply_model, loss_and_counts,
        loss_sums)

    torch.cuda.set_device(0)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    z = dict(np.load(inputs))
    out = {"backend": dist.get_backend()}
    dev = torch.device("cuda", 0)
    params0 = {k[len("params/"):]: torch.from_numpy(v).to(dev)
               for k, v in z.items() if k.startswith("params/")}

    # the vertex-sharded forward: B1 on this rank's 16,384 rows
    mesh = make_mesh(vert=2)
    mb.reset_launches()
    y = vertex_sharded_megakernel_forward(params0, z["fwd/x"],
                                          _bundle(z, "fwd/ops/"), mesh,
                                          n_block=N_BLOCK)
    out["fwd/launches"] = _par_launches(mb)
    out["fwd/y"] = y.cpu().numpy()

    model = DiffusionNet(**{**SEG_MODEL, "outputs_at": "vertices",
                            "dropout": False},
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    cfg = TaskConfig(input_features="hks", labels_kind="vertex")
    batch = PaddedBatch(verts=z["b/verts"], ops=_bundle(z, "b/ops/"),
                        labels=z["b/labels"], faces=z["b/faces"],
                        face_mask=z["b/face_mask"])

    def run(name, mesh, make_step, loss_fn, p0=params0):
        params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        opt = adam_with_step_decay(1e-3)
        block = shard_batch(batch, mesh, "vertex").to(dev)
        torch.cuda.synchronize()
        mb.reset_launches()
        fu.reset_launches()
        _, _, loss, _ = make_step(loss_fn, opt, mesh)(params, opt.init(params),
                                                      block, None)
        out[name + "/b4"] = _b4_launches(mb, fu)
        out[name + "/launches"] = _par_launches(mb)
        out[name + "/loss"] = float(loss)
        for k, p in params.items():
            out[f"{name}/grad/{k}"] = p.grad.cpu().numpy()
            out[f"{name}/param/{k}"] = p.detach().cpu().numpy()

    # (data 1, vert 2): the masked mean over the whole batch
    mesh = make_mesh(data=1, vert=2)
    vert = VertexGroup(mesh)

    def sum_loss(p, b, g):
        S, C, N = loss_sums(apply_model(model, p, b, g, cfg, True, vert), b,
                            cfg)
        return S, N, (C, N)
    run("two_axis", mesh, make_two_axis_train_step, sum_loss)

    # (data 2, vert 1): each rank's mean over its 2 surfaces, averaged
    def mean_loss(p, b, g):
        return loss_and_counts(apply_model(model, p, b, g, cfg, True), b,
                               cfg)
    run("dp", make_mesh(data=2, vert=1),
        functools.partial(make_dp_train_step, has_aux=True), mean_loss)

    # the fused model: B4 on this rank's rows, x_hat's partials and their
    # cotangent summed over vert; the forward on the torus, then one (1, 2)
    # step through apply_model
    fmodel = fused_vertex_model()
    fparams0 = {k[len("fparams/"):]: torch.from_numpy(v).to(dev)
                for k, v in z.items() if k.startswith("fparams/")}
    fparams = {k: v.clone().requires_grad_(True) for k, v in fparams0.items()}
    torch.cuda.synchronize()
    mb.reset_launches()
    fu.reset_launches()
    y = vertex_sharded_forward(fmodel, fparams, z["fwd/x"],
                               _bundle(z, "fwd/ops/"), make_mesh(vert=2))
    out["fused_fwd/b4"] = _b4_launches(mb, fu)
    out["fused_fwd/launches"] = _par_launches(mb)
    out["fused_fwd/y"] = y.detach().cpu().numpy()
    del y
    fcfg = TaskConfig(input_features="hks", labels_kind="vertex",
                      use_megakernel=False)
    mesh = make_mesh(data=1, vert=2)
    vert = VertexGroup(mesh)

    def fused_sum_loss(p, b, g):
        S, C, N = loss_sums(apply_model(fmodel, p, b, g, fcfg, True, vert),
                            b, fcfg)
        return S, N, (C, N)
    run("fused_step", mesh, make_two_axis_train_step, fused_sum_loss,
        fparams0)

    # the RNA driver, --mesh 1,2 on the megakernel
    mb.reset_launches()
    res = rna.main(["--n_epoch", "1", "--megakernel", "--mesh", "1,2",
                    "--buckets", "16384,32768", "--data_dir", rna_root,
                    "--device", "cuda"])
    out["rna/launches"] = _par_launches(mb)
    out["rna/history"] = np.asarray([(e, a, -1.0 if t is None else t)
                                     for e, a, t in res["history"]])
    out["rna/seconds"] = res["seconds"]["fit"]
    return {k: (np.asarray([v[q] for q in PAR_KERNELS])
                if k.endswith("/launches") else v) for k, v in out.items()}


def phase_parallel(mb, card, seg_ds, seg_batch, whole, torus_ops):
    """21: training over several ranks on the one card.
    (a) one rank over nccl: fit with data_parallel=True, and with
    mesh_shape=(1, 1), on phase 17b's configuration (the
    human_segmentation_original model at full width, batch 4 of the 32768
    bucket, 2 epochs, B1/B2, dropout on) ends with phase 17b's 40 tensors
    bit for bit (an all-reduce over one rank is the identity).
    (b) two ranks over gloo on the card (NCCL refuses two ranks on one
    device; gloo carries the CUDA tensors, every product runs in B1/B2 on
    the card): the vertex-sharded forward of the segmentation model's
    blocks (vertex outputs) on the torus (20,160 vertices in the 32768
    bucket, 16,384 rows a rank) against one process's B1; one (1, 2) step
    and one (2, 1) step, dropout off, on phase 8's batch with vertex labels,
    each against one process's step on the whole batch (the (2, 1) step's
    objective, as the JAX package's, is the mean of each rank's mean); the
    RNA driver with --mesh 1,2 --megakernel for one epoch on its synthetic
    layout. Then the same model built with use_pallas_fused (seeded
    diffusion times) on B4: its vertex-sharded forward on the torus against
    one process's fused model, and one (1, 2) step through apply_model
    against one process's fused step on the whole batch, each rank
    launching B4's three kernels and xhat_reduce (PAR_B4_WANT); then the
    fused step on one card at B=4 and B=1 timed (CUDA events and device
    time). Returns the launches of (a)'s data-parallel run and of (b)'s
    ranks, summed."""
    import numpy as np
    import torch.distributed as dist
    from diffusionnet_tpu_torch import parallel
    from diffusionnet_tpu_torch.experiments import layouts
    from diffusionnet_tpu_torch.experiments.exp_common import (
        FitConfig, build_model, fit)
    from diffusionnet_tpu_torch.experiments.rna_mesh_segmentation.\
        rna_mesh_dataset import RNAMeshDataset
    from diffusionnet_tpu_torch.geometry import pad_operators
    from diffusionnet_tpu_torch.models import (DiffusionNet, flat_params,
                                               megablock_apply)
    from diffusionnet_tpu_torch.ops.spectral import compute_hks_autoscale
    from diffusionnet_tpu_torch.training import (
        TaskConfig, adam_with_step_decay, apply_model, loss_and_counts,
        make_train_step)

    t_phase = time.perf_counter()
    total = dict.fromkeys(PAR_KERNELS, 0)
    log("== phase 21a: fit over one nccl rank, data_parallel=True and "
        "mesh_shape=(1, 1), against phase 17b's uninterrupted run")
    parallel.initialize(f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                        rank=0, backend="nccl")
    try:
        model = build_model(8, 128, "faces", True, "hks")
        for name, kw in (("data_parallel=True", dict(data_parallel=True)),
                         ("mesh_shape=(1, 1)", dict(mesh_shape=(1, 1)))):
            cfg = FitConfig(n_epoch=2, batch_size=4, input_features="hks",
                            labels_kind="face", use_megakernel=True, **kw)
            torch.cuda.synchronize()
            mb.reset_launches()
            t0 = time.perf_counter()
            params, hist, _ = fit(model, seg_ds, seg_ds, cfg, verbose=False,
                                  device="cuda")
            got = _par_launches(mb)
            same = sum(torch.equal(whole[k], params[k].detach())
                       for k in whole)
            log(f"  {name} ({dist.get_backend()}, world "
                f"{dist.get_world_size()}): history {hist}, "
                f"{time.perf_counter() - t0:.2f} s; {same} of {len(whole)} "
                f"tensors bit-identical to phase 17b's; launches {got} "
                f"[{card}]")
            check(same == len(whole) and len(params) == len(whole),
                  f"{name}: weights differ from phase 17b's run")
            check(got["megablock_fwd"] > 0 and got["megablock_bwd_rows"] > 0,
                  f"{name}: B1/B2 not launched")
            if "data_parallel" in kw:
                for k in PAR_KERNELS:
                    total[k] += got[k]
    finally:
        dist.destroy_process_group()

    log("== phase 21b: two ranks on the card over gloo (CUDA tensors): the "
        "vertex-sharded forward, a (1, 2) and a (2, 1) step, the fused "
        "model's vertex-sharded forward and (1, 2) step, the RNA driver "
        "with --mesh 1,2")
    model = DiffusionNet(**{**SEG_MODEL, "outputs_at": "vertices",
                            "dropout": False},
                         generator=torch.Generator().manual_seed(21),
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    params = flat_params(model, "cpu")
    d = {"params/" + k: v.numpy() for k, v in params.items()}
    fmodel = fused_vertex_model()
    fparams = flat_params(fmodel, "cpu")
    d.update({"fparams/" + k: v.numpy() for k, v in fparams.items()})
    ops = pad_operators(torus_ops, PAR_TORUS_V)
    x = compute_hks_autoscale(torch.from_numpy(ops.evals),
                              torch.from_numpy(ops.evecs), 16)
    d["fwd/x"] = x.numpy()
    d.update(_bundle_arrays("fwd/ops/", ops))
    mass = seg_batch.ops.mass
    labels = torch.where(mass > 0, (seg_batch.verts[..., 2] > 0).int(), -1)
    batch = seg_batch._replace(labels=labels)
    d.update(_bundle_arrays("b/ops/", batch.ops))
    for f in ("verts", "labels", "faces", "face_mask"):
        d["b/" + f] = getattr(batch, f).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **d)
        root = layouts.rna(os.path.join(tmp, "rna"),
                           [_jittered_torus(k, 10 + i) for i, k in
                            enumerate(DRIVER_TORI["rna"])], n_train=3)
        t0 = time.perf_counter()
        for train in (True, False):   # the ranks read the operator cache
            RNAMeshDataset(root, train=train, k_eig=K_EIG,
                           op_cache_dir=os.path.join(root, "op_cache"))
        log(f"  the RNA layout's operators cached in "
            f"{time.perf_counter() - t0:.2f} s; inputs written")
        t0 = time.perf_counter()
        ranks = parallel.launch(_par_rank, 2, (inputs, root),
                                backend="gloo", threads=None,
                                workdir=os.path.join(tmp, "ranks"),
                                timeout_s=600)
        log(f"  two ranks ran in {time.perf_counter() - t0:.2f} s "
            f"(start-up, kernel load and the RNA driver included)")
    for r, rep in enumerate(ranks):
        counts = {}
        for stage in ("fwd", "two_axis", "dp", "rna"):
            got = dict(zip(PAR_KERNELS, rep[stage + "/launches"].tolist()))
            counts[stage] = got
            for k in PAR_KERNELS:
                total[k] += got[k]
            check(got["megablock_fwd"] > 0
                  and (stage == "fwd" or got["megablock_bwd_rows"] > 0),
                  f"rank {r}, {stage}: B1/B2 not launched: {got}")
        log(f"  rank {r} (backend {rep['backend']}): launches {counts}")
        b4 = {}
        for stage, want in PAR_B4_WANT.items():
            got = rep[stage + "/b4"].tolist()
            b4[stage] = dict(zip(PAR_B4_KERNELS, got))
            for k, n in zip(PAR_B4_KERNELS, got):
                total[k] = total.get(k, 0) + n
            mega = rep[stage + "/launches"].tolist()
            check(tuple(got) == want and not any(
                mega[PAR_KERNELS.index(k)] for k in PAR_KERNELS
                if k != "xhat_reduce"),
                f"rank {r}, {stage}: B4 and xhat_reduce launches {got} != "
                f"{want}, B1/B2 {mega}")
        log(f"  rank {r}: the fused model's launches of {PAR_B4_KERNELS}: "
            f"{b4}")

    # the forward against one process's B1 on the whole torus
    dev = torch.device("cuda")
    pc = {k: v.to(dev) for k, v in params.items()}

    def b(a):
        return torch.as_tensor(a).to(dev)[None]
    single = megablock_apply(pc, b(d["fwd/x"]), b(ops.mass), b(ops.evals),
                             b(ops.evecs), b(ops.gradX_spec),
                             b(ops.gradY_spec), n_block=N_BLOCK)[0]
    got = torch.cat([torch.from_numpy(rep["fwd/y"]) for rep in ranks])
    err = compare("vertex-sharded forward (vert 2) against one process's B1",
                  got.to(dev), single, PAR_FWD_TOL, scaled=True)

    # the steps against one process's step on the whole batch
    cfg = TaskConfig(input_features="hks", labels_kind="vertex")
    before = {k: v.detach() for k, v in pc.items()}

    def one_process(loss_fn):
        p = {k: v.clone().requires_grad_(True) for k, v in pc.items()}
        opt = adam_with_step_decay(1e-3)
        _, _, loss, _ = make_train_step(loss_fn, opt)(p, opt.init(p), batch,
                                                      None)
        return (loss.item(), {k: v.grad for k, v in p.items()},
                {k: v.detach() for k, v in p.items()})

    def whole_mean(p, bt, g):
        return loss_and_counts(apply_model(model, p, bt, g, cfg, True), bt,
                               cfg)

    def mean_of_halves(p, bt, g):
        halves = [bt.map(lambda a, i=i: a[2 * i:2 * i + 2]) for i in (0, 1)]
        losses = [whole_mean(p, h, g)[0] for h in halves]
        return (losses[0] + losses[1]) / 2, None
    for name, ref in (("two_axis", whole_mean), ("dp", mean_of_halves)):
        res = {"one process": one_process(ref)}
        for r, rep in enumerate(ranks):
            res[f"rank {r}"] = (
                rep[name + "/loss"],
                {k: torch.from_numpy(rep[f"{name}/grad/{k}"]).to(dev)
                 for k in pc},
                {k: torch.from_numpy(rep[f"{name}/param/{k}"]).to(dev)
                 for k in pc})
        worst = max(((res["rank 0"][1][k] - res["one process"][1][k]).abs()
                     .max() / res["one process"][1][k].abs().max()
                     .clamp(min=1e-30)).item() for k in pc)
        log(f"  {name} step ({'(1, 2)' if name == 'two_axis' else '(2, 1)'})"
            f": loss rank 0 {res['rank 0'][0]:.8f}, rank 1 "
            f"{res['rank 1'][0]:.8f}, one process "
            f"{res['one process'][0]:.8f}; largest gradient error relative "
            f"to its tensor's largest entry {worst:.3e} (printed; the check "
            f"is STEP_TOL's, in L2)")
        check(all(torch.equal(res["rank 0"][2][k], res["rank 1"][2][k])
                  for k in pc), f"{name}: the ranks' parameters differ")
        step_agreement("rank 0", "one process", res, before,
                       checked=("gradient",))

    # the fused model: the forward against one process's fused model on the
    # whole torus, the (1, 2) step against one process's fused step
    from diffusionnet_tpu_torch.models import module_state
    fc = {k: v.to(dev) for k, v in fparams.items()}
    with torch.no_grad():
        single = torch.func.functional_call(
            fmodel, module_state(fc), (b(d["fwd/x"])[0], b(ops.mass)[0]),
            dict(evals=b(ops.evals)[0], evecs=b(ops.evecs)[0],
                 gradX=b(ops.gradX_spec)[0], gradY=b(ops.gradY_spec)[0]))
    got = torch.cat([torch.from_numpy(rep["fused_fwd/y"]) for rep in ranks])
    ferr = compare("fused vertex-sharded forward (vert 2, B4 a rank) against "
                   "one process's fused model", got.to(dev), single,
                   PAR_FWD_TOL, scaled=True)
    fcfg = TaskConfig(input_features="hks", labels_kind="vertex",
                      use_megakernel=False)

    def fused_mean(p, bt, g):
        return loss_and_counts(apply_model(fmodel, p, bt, g, fcfg, True), bt,
                               fcfg)
    p = {k: v.clone().requires_grad_(True) for k, v in fc.items()}
    opt = adam_with_step_decay(1e-3)
    _, _, loss, _ = make_train_step(fused_mean, opt)(p, opt.init(p), batch,
                                                     None)
    res = {"one process": (loss.item(), {k: v.grad for k, v in p.items()},
                           {k: v.detach() for k, v in p.items()})}
    for r, rep in enumerate(ranks):
        res[f"rank {r}"] = (
            rep["fused_step/loss"],
            {k: torch.from_numpy(rep[f"fused_step/grad/{k}"]).to(dev)
             for k in fc},
            {k: torch.from_numpy(rep[f"fused_step/param/{k}"]).to(dev)
             for k in fc})
    log(f"  fused step (1, 2): loss rank 0 {res['rank 0'][0]:.8f}, rank 1 "
        f"{res['rank 1'][0]:.8f}, one process {res['one process'][0]:.8f}")
    check(all(torch.equal(res["rank 0"][2][k], res["rank 1"][2][k])
              for k in fc), "fused step: the ranks' parameters differ")
    step_agreement("rank 0", "one process", res, fc, checked=("gradient",),
                   label="fused (1, 2) step")
    # a rank of parallel_smoke.py's fused (1, 4) step does a quarter of the
    # batch's products with the same launches: the fused step on one card
    # at B=4 and at B=1 (the quarter), CUDA events around back-to-back steps
    # (the host's issue and the step's own waits on the card included; the
    # step waits on the card, so device_ms cannot hold it behind its spin)
    for nb in (4, 1):
        bt = batch.map(lambda a, nb=nb: a[:nb])
        p = {k: v.clone().requires_grad_(True) for k, v in fc.items()}
        opt = adam_with_step_decay(1e-3)
        state = opt.init(p)
        step = make_train_step(fused_mean, opt)

        def run():
            step(p, state, bt, None)
        log(f"  fused step on one card, B={nb} V={PAR_TORUS_V}: "
            f"{time_ms(run, reps=3):.3f} ms (CUDA events) [{card}]")

    hist = [rep["rna/history"] for rep in ranks]
    log(f"  RNA driver, --mesh 1,2 --megakernel, 1 epoch: history "
        f"{hist[0].tolist()}, fit {float(ranks[0]['rna/seconds']):.2f} s "
        f"[{card}]")
    check(np.array_equal(hist[0], hist[1]) and len(hist[0]) == 1
          and np.isfinite(hist[0]).all(),
          "RNA driver: the ranks' histories differ or are not one epoch")
    log(f"  launches of phase 21 (a's data-parallel fit, b's two ranks): "
        f"{total}; max abs err of the forward {err:.3e}, of the fused "
        f"forward {ferr:.3e}")
    log(f"  phase 21: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 22: the vertex-sharded eigensolver and serving artifact, and the
# band and DIA formats
# ---------------------------------------------------------------------------

SHARD_SERVE_V = 32768            # the sharded artifact's bucket (2 ranks)
SHARD_SERVE_TOL = dict(rtol=2e-5, atol=2e-6)   # the serving tests' own
SHARD_ICO_PAD = 10244            # icosphere(5)'s 10,242 vertices, 2 padded
SHARD_REQUESTS = 12              # warm requests a rank; the first 2 dropped
EIG_TOL = 1e-4                   # evals within 1e-4 of the largest (f32)
SOLVE_REPS = 3                   # phase 22d's solves of each route


def _laplacian(seg_ds, i, v_pad=None):
    """(L scipy, mass f64, ELL numpy, mass f32) of seg_ds's i-th mesh,
    padded to v_pad rows (zero rows, zero mass)."""
    import numpy as np
    from diffusionnet_tpu_torch.geometry.laplacian import (cotan_laplacian,
                                                           vertex_areas)
    from diffusionnet_tpu_torch.ops.sparse import ell_from_coo, ell_pad
    v, f = seg_ds.verts_list[i], seg_ds.faces_list[i]
    L = cotan_laplacian(v, f)
    m = vertex_areas(v, f)
    c = L.tocoo()
    ell = ell_from_coo(c.row, c.col, c.data, L.shape[0])
    m32 = m.astype(np.float32)
    if v_pad is not None:
        ell = ell_pad(ell, v_pad)
        m32 = np.concatenate([m32, np.zeros(v_pad - len(m), np.float32)])
    return L, m, ell, m32


def _basis_checks(name, ev, evecs, ev_ref, mass, V):
    """evals within EIG_TOL of ARPACK's largest, M-orthonormal valid rows,
    padded rows exactly 0; returns the evals' error relative to the
    largest."""
    import numpy as np
    err = float(np.abs(ev - ev_ref).max() / ev_ref.max())
    E = evecs[:V].astype(np.float64)
    orth = float(np.abs(E.T @ (mass[:, None] * E)
                        - np.eye(E.shape[1])).max())
    pad = float(np.abs(evecs[V:]).max()) if evecs.shape[0] > V else 0.0
    log(f"  {name}: evals against ARPACK {err:.3e} of the largest, "
        f"M-orthonormality {orth:.3e}, padded rows max |.| {pad}")
    check(err <= EIG_TOL and orth <= EIG_TOL and pad == 0.0,
          f"{name}: basis checks failed")
    return err


def _sharded_rank(rank, world, inputs, arts):
    """One of phase 22's two ranks, on the one card over gloo: the sharded
    solve of icosphere(5) at vert 2, then each sharded artifact of `arts`
    (name=path) serving the torus: its output, B4's launches of one
    request (with xhat_reduce's, one a projection), and warm requests
    through a PreparedSurface."""
    import numpy as np
    from diffusionnet_tpu_torch import _build
    from diffusionnet_tpu_torch.geometry import eigen as teig
    from diffusionnet_tpu_torch.ops import fused as fu
    from diffusionnet_tpu_torch.ops import megablock as mbk
    from diffusionnet_tpu_torch.ops.sparse import Ell
    from diffusionnet_tpu_torch.parallel import make_mesh
    from diffusionnet_tpu_torch.serving import load_sharded_serving_model

    torch.cuda.set_device(0)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    z = dict(np.load(inputs))
    mesh = make_mesh(vert=world)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev, evecs = teig.eigensolve_device_sharded(
        Ell(z["eig/idx"], z["eig/val"]), z["eig/mass"], K_EIG, mesh,
        device="cuda:0")
    torch.cuda.synchronize()
    out["eig/s"] = time.perf_counter() - t0
    out["eig/sweeps"] = teig.LAST_CONVERGE_INFO["sweeps"]
    out["eig/evals"], out["eig/evecs"] = (ev.cpu().numpy(),
                                          evecs.cpu().numpy())
    ops = [torch.from_numpy(z["srv/" + f]).cuda()
           for f in ("mass", "evals", "evecs", "gX", "gY")]
    x = torch.from_numpy(z["srv/x"]).cuda()
    for item in arts:
        name, d = item.split("=", 1)
        sm = load_sharded_serving_model(d, mesh=mesh, device="cuda:0")
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
        for _ in range(SHARD_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yp = handle(x)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name + "/ms"] = np.asarray(walls[2:])
        out[name + "/prepared_y"] = yp.cpu().numpy()
    return out


def _format_times(name, L, fmt, apply_fmt, time_fmt, be, card,
                  C=C_SUBSPACE):
    """One matvec on `fmt` (the band or DIA, plain torch) beside B5 and
    torch.sparse.mm on the same matrix at C columns. apply_fmt(x) is A x
    in the original order, held to B5's; time_fmt(x) the format's own
    product on its (permuted, padded) input, which is what is timed
    (device time). Returns the times."""
    import numpy as np
    import scipy.sparse
    V = L.shape[0]
    b = be.blocked_ell_from_sparse(L, device="cuda")
    perm = torch.from_numpy(b.perm).cuda()
    g = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(V, C, generator=g, device="cuda")
    xb = torch.zeros(b.n_pad, C, device="cuda")
    xb[:V] = x[perm]
    Lp = scipy.sparse.csr_matrix(L)[b.perm][:, b.perm].astype(np.float32)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(Lp.indptr.astype(np.int64)),
        torch.from_numpy(Lp.indices.astype(np.int64)),
        torch.from_numpy(Lp.data), size=Lp.shape).to("cuda")
    xv = xb[:V].contiguous()
    y_b5 = be.blocked_ell_matvec(b, xb)[:V]
    y_fmt = apply_fmt(x)[perm]
    torch.cuda.synchronize()
    compare(f"{name} {fmt} matvec against B5", y_fmt, y_b5,
            dict(rtol=0.0, atol=B5_TOL), scaled=True)
    t_fmt = device_ms(time_fmt(x))
    t_b5 = device_ms(lambda: be.blocked_ell_matvec(b, xb))
    t_lib = device_ms(lambda: torch.sparse.mm(csr, xv))
    bms, by = b5_bound(Lp.nnz, V, C)
    log(f"  time {fmt} matvec {name} V={V} C={C}, device time: {fmt} "
        f"{t_fmt:.4f} ms, B5 {t_b5:.4f} ms, torch.sparse.mm {t_lib:.4f} "
        f"ms; B5's bound {bms:.4f} ms ({by}) [{card}]")
    return dict(fmt_ms=t_fmt, b5_ms=t_b5, library_ms=t_lib, bound_ms=bms)


def phase_sharded(fu, be, card, seg_ds):
    """22: the vertex-sharded eigensolver and serving artifact, and the
    dense band and DIA formats of the device solver.
    (a) one nccl rank (a world of 1): eigensolve_device_sharded at vert 1
    on torus(144, 140), k 128, against eigensolve_device(banded=False) (the
    same start block and reductions: expected bit-identical; evals within
    EIG_TOL of the largest checked, the largest difference printed).
    (b) two gloo ranks sharing the card: the sharded solve of icosphere(5)
    padded to 10,244 rows at vert 2 against ARPACK (evals within EIG_TOL
    of the largest, M-orthonormality within EIG_TOL, padded rows exactly
    0), against the single-card solve (B5), every rank's evals bit-equal.
    (c) on the same ranks: the segmentation model (vertex outputs, fused
    and unfused on the dense route, `dense_route`; and a global_mean head,
    unfused, which the card runs on B4) exported sharded at bucket 32768
    (16,384 rows a rank) serves the torus, each against the single-card
    ServingModel of the same model within SHARD_SERVE_TOL; the fused and
    global_mean artifacts launch B4's two kernels once a block on each
    rank, the dense route's none; warm
    requests through a PreparedSurface (host clock, median of 10).
    (d) the DIA format on the torus and the dense band on icosphere(5):
    one matvec against B5 and torch.sparse.mm (device time), and the
    solve (banded='dia' / True) against ARPACK, beside the B5 and ELL
    solves (host clock, median of SOLVE_REPS, with the format-build and
    sweep stages).
    Returns B4's launches of (c)'s ranks, summed."""
    import numpy as np
    import torch.distributed as dist
    from diffusionnet_tpu_torch import parallel
    from diffusionnet_tpu_torch.data.features import get_features
    from diffusionnet_tpu_torch.geometry import eigen as teig
    from diffusionnet_tpu_torch.ops import banded as bd
    from diffusionnet_tpu_torch.parallel import make_mesh
    from diffusionnet_tpu_torch.serving import (export_forward,
                                                export_sharded_forward,
                                                load_serving_model)
    from diffusionnet_tpu_torch.serving.export import kernel_ops

    t_phase = time.perf_counter()

    def solve(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    L_t, m_t, ell_t, m32_t = _laplacian(seg_ds, 0)
    log("== phase 22a: eigensolve_device_sharded over one nccl rank on "
        "torus(144, 140), k 128, against eigensolve_device(banded=False)")
    parallel.initialize(f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                        rank=0, backend="nccl")
    try:
        (ev_s, vec_s), s_sh = solve(lambda: teig.eigensolve_device_sharded(
            ell_t, m32_t, K_EIG, make_mesh(vert=1), device="cuda"))
        sweeps_sh = teig.LAST_CONVERGE_INFO["sweeps"]
    finally:
        dist.destroy_process_group()
    (ev_1, vec_1), s_1 = solve(lambda: teig.eigensolve_device(
        ell_t, m32_t, K_EIG, banded=False, device="cuda"))
    same = torch.equal(ev_s, ev_1) and torch.equal(vec_s, vec_1)
    d_ev = (ev_s - ev_1).abs().max().item()
    d_vec = (vec_s - vec_1).abs().max().item()
    log(f"  sharded (vert 1) {s_sh:.2f} s, {sweeps_sh} sweeps; single card "
        f"(ELL) {s_1:.2f} s, {teig.LAST_CONVERGE_INFO['sweeps']} sweeps "
        f"(host clock) [{card}]; evals and evecs "
        f"{'bit-identical' if same else 'NOT bit-identical'}: largest "
        f"differences {d_ev:.3e} (evals), {d_vec:.3e} (evecs)")
    check(d_ev <= EIG_TOL * ev_1.max().item(),
          "the vert-1 sharded solve disagrees with the ELL route")
    del vec_s, vec_1

    log("== phase 22b/c: two gloo ranks on the card: the sharded solve of "
        "icosphere(5) at vert 2, the sharded artifacts on the torus")
    L_i, m_i, ell_i, m32_i = _laplacian(seg_ds, 1, SHARD_ICO_PAD)
    V_i = L_i.shape[0]
    t0 = time.perf_counter()
    ev_h, _ = teig.eigensolve_host(L_i, m_i, K_EIG)
    ev_ht, _ = teig.eigensolve_host(L_t, m_t, K_EIG)
    log(f"  ARPACK on icosphere(5) and the torus, k 128: "
        f"{time.perf_counter() - t0:.2f} s (host)")
    (ev_b5, _), s_b5 = solve(lambda: teig.eigensolve_device(
        ell_i, m32_i, K_EIG, device="cuda"))

    o = seg_ds.ops_list[0]
    x_t = get_features("hks", None, torch.from_numpy(o.evals).cuda(),
                       torch.from_numpy(o.evecs).cuda()).contiguous()
    models = {"unfused": dense_route(segmentation_model(
                  outputs_at="vertices", dropout=False)),
              "fused": segmentation_model(outputs_at="vertices",
                                          dropout=False,
                                          use_pallas_fused=True),
              "global_mean": segmentation_model(outputs_at="global_mean",
                                                dropout=False)}
    tmp = tempfile.TemporaryDirectory()
    arts, graph_ops = [], {}
    t0 = time.perf_counter()
    for name, model in models.items():
        d = os.path.join(tmp.name, name)
        export_sharded_forward(model, SHARD_SERVE_V, d, K_EIG, n_devices=2,
                               device="cuda")
        arts.append(f"{name}={d}")
        graph_ops[name] = kernel_ops(torch.export.load(os.path.join(
            d, f"sharded_{SHARD_SERVE_V}x2.pt2")))
    log(f"  three sharded exports {time.perf_counter() - t0:.2f} s; kernel "
        f"ops in each program: {graph_ops}")
    check(graph_ops["fused"] == {"spectral_project": N_BLOCK,
                                 "spectral_apply": N_BLOCK,
                                 "vert_sum": N_BLOCK},
          f"the fused program's ops are {graph_ops['fused']}")
    d = {"eig/idx": ell_i.idx, "eig/val": ell_i.val, "eig/mass": m32_i,
         "srv/x": x_t.cpu().numpy()}
    for f, a in (("mass", o.mass), ("evals", o.evals), ("evecs", o.evecs),
                 ("gX", o.gradX_spec), ("gY", o.gradY_spec)):
        d["srv/" + f] = np.ascontiguousarray(a, np.float32)
    inputs = os.path.join(tmp.name, "inputs.npz")
    np.savez(inputs, **d)
    t0 = time.perf_counter()
    ranks = parallel.launch(_sharded_rank, 2, (inputs, arts),
                            backend="gloo", threads=None, timeout_s=600,
                            workdir=os.path.join(tmp.name, "ranks"))
    log(f"  two ranks ran in {time.perf_counter() - t0:.2f} s (start-up "
        "and kernel load included)")

    r0 = ranks[0]
    log(f"  sharded solve (vert 2): {float(r0['eig/s']):.2f} s, "
        f"{int(r0['eig/sweeps'])} sweeps (host clock, gloo gathers through "
        f"the host); single card (B5) {s_b5:.2f} s [{card}]")
    check(all(r["eig/evals"].tobytes() == r0["eig/evals"].tobytes()
              for r in ranks), "the ranks' evals differ")
    evecs = np.concatenate([r["eig/evecs"] for r in ranks])
    _basis_checks("icosphere(5), vert 2", r0["eig/evals"], evecs, ev_h, m_i,
                  V_i)
    e1 = float(np.abs(r0["eig/evals"] - ev_b5.cpu().numpy()).max()
               / ev_h.max())
    log(f"  against the single-card solve: evals {e1:.3e} of the largest")
    check(e1 <= EIG_TOL, "the sharded solve disagrees with the single card")

    total = {"spectral_project": 0, "spectral_apply": 0, "xhat_reduce": 0}
    ops_dev = [torch.from_numpy(d["srv/" + f]).cuda()
               for f in ("mass", "evals", "evecs", "gX", "gY")]
    for name, model in models.items():
        single_dir = os.path.join(tmp.name, "single_" + name)
        export_forward(model, (SHARD_SERVE_V,), single_dir, K_EIG,
                       device="cuda")
        with torch.no_grad():
            ref = load_serving_model(single_dir, device="cuda")(
                x_t, *ops_dev)
        for r, rep in enumerate(ranks):
            for call in ("y", "prepared_y"):
                compare(f"rank {r} {name} sharded artifact ({call}) "
                        "against the single-card ServingModel",
                        torch.from_numpy(rep[f"{name}/{call}"]).cuda(), ref,
                        SHARD_SERVE_TOL, quiet=r > 0 or call != "y")
            launches = rep[name + "/launches"].tolist()
            want = [0, 0, 0] if name == "unfused" else [N_BLOCK] * 3
            check(launches == want, f"rank {r} {name}: B4 and xhat_reduce "
                  f"launches {launches} a request, expected {want}")
            total["spectral_project"] += launches[0]
            total["spectral_apply"] += launches[1]
            total["xhat_reduce"] += launches[2]
        ms = [float(np.median(rep[name + "/ms"])) for rep in ranks]
        log(f"  {name}: B4 (project, apply) and xhat_reduce launches a "
            f"request on each rank "
            f"{[rep[name + '/launches'].tolist() for rep in ranks]}; warm "
            f"request through a PreparedSurface, median of "
            f"{SHARD_REQUESTS - 2}: {ms} ms on the two ranks (two gloo "
            f"ranks sharing one card; host clock) [{card}]")
    tmp.cleanup()

    log("== phase 22d: the DIA format (torus) and the dense band "
        "(icosphere(5)) against B5, torch.sparse.mm and ARPACK")
    dia = bd.dia_from_sparse(L_t)
    check(dia is not None, "the torus is not DIA-structured")
    data = torch.from_numpy(dia[0]).cuda()

    band = bd.banded_from_sparse_device(L_i, device="cuda")
    n_pad = band.band.shape[0] * band.band.shape[1]
    bperm = torch.from_numpy(band.perm).cuda()
    log(f"  torus: {len(dia[1])} diagonals; icosphere(5): band width "
        f"{band.width}, {band.band.shape[0]} tiles of {band.tile_rows} rows, "
        f"{band.band.numel() * 4 / 1e6:.1f} MB")

    def band_in(x):
        xp = torch.zeros(n_pad, x.shape[1], device="cuda")
        xp[:x.shape[0]] = x[bperm]
        return xp

    def band_apply(x):
        y = torch.empty_like(x)
        y[bperm] = bd.banded_matvec(band, band_in(x))[:x.shape[0]]
        return y

    def band_time(x):
        xp = band_in(x)
        return lambda: bd.banded_matvec(band, xp)
    times = {
        "dia": _format_times(
            "torus(144, 140)", L_t, "dia",
            lambda x: bd.dia_matvec(data, dia[1], x),
            lambda x: (lambda: bd.dia_matvec(data, dia[1], x)), be, card),
        "band": _format_times("icosphere(5)", L_i, "band", band_apply,
                              band_time, be, card)}
    for fmt, (L, m, ell, m32, ev_ref, banded) in (
            ("dia", (L_t, m_t, ell_t, m32_t, ev_ht, "dia")),
            ("band", (L_i, m_i, ell_i, m32_i, ev_h, True))):
        parts = []
        for route in (banded, "blocked", False):
            tag = {"dia": "dia", True: "band", "blocked": "B5",
                   False: "ELL"}[route]
            runs = []
            for _ in range(SOLVE_REPS):
                timings = {}
                (ev, vec), s = solve(lambda: teig.eigensolve_device(
                    ell, m32, K_EIG, banded=route, timings=timings,
                    device="cuda"))
                runs.append((s, timings.get("eigen_band_build", 0.0),
                             timings["eigen_sweeps"]))
            if tag in ("dia", "band"):
                _basis_checks(f"{fmt} solve", ev.cpu().numpy(),
                              vec.cpu().numpy(), ev_ref, m, L.shape[0])
            med = [statistics.median(r[i] for r in runs) for i in range(3)]
            times[fmt][tag + "_solve_s"] = med[0]
            times[fmt][tag + "_sweeps_s"] = med[2]
            parts.append(f"{tag} {med[0]:.3f} s (format {med[1]:.3f}, "
                         f"sweeps {med[2]:.3f}; "
                         f"{teig.LAST_CONVERGE_INFO['sweeps']} sweeps)")
        log(f"  {fmt} mesh, whole solve k 128, median of {SOLVE_REPS} "
            f"(host clock; stages from `timings`): " + ", ".join(parts)
            + f" [{card}]")
    log(f"  launches of phase 22 (c's two ranks): {total}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need a CUDA card", file=sys.stderr)
        return 1
    from diffusionnet_tpu_torch import _build
    from diffusionnet_tpu_torch.ops import megablock as mb

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: device")
    card = card_line()
    log(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("== phase 2: build")
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    log(f"  built {so.name} in {time.perf_counter() - t0:.2f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if ("registers" in line or "spill" in line
                or "entry function" in line or "Performance" in line):
            log("  " + line.strip())

    errs, partials = phase_kernels(mb)
    serve_launches = phase_slice(mb)
    times = phase_times(mb, card)
    xr1 = xhat_reduce_times(mb, partials, card)[(1, partials[0].shape[1])]
    errs["megablock_fwd"] = max(errs["megablock_fwd"], phase_dropout(mb))
    phase_backward(mb)
    b2_errs, (b2_args, _, _, _, slots) = phase_b2_kernels(mb)
    errs.update(b2_errs)
    del b2_args
    launches, torus_ops, torus_verts, seg_batch, seg_ds = phase_train(mb)
    log(f"  launches of the inference slice: {serve_launches}; of the "
        f"training slice: {launches}")
    bwd_times = phase_bwd_times(mb, card)
    phase_wide_times(mb, card)
    # grad_reduce over the parameter partials of the grads kernel at B=1,
    # V=32768, f32 (phase 7b), beside its plain version and torch.sum
    par = slots.unsqueeze(0)
    n_par = par.shape[2]
    gr_ms = device_ms(lambda: mb.grad_reduce(par, 0, n_par))
    gr_plain = device_ms(lambda: mb.grad_reduce_reference(par, 0, n_par))
    gr_lib = device_ms(lambda: par.sum(1))
    gr_b = bound((par.shape[1] + 1) * n_par * 4, par.shape[1] * n_par,
                 F32_FLOPS)
    log(f"  time grad_reduce {tuple(par.shape)}, device time: kernel "
        f"{gr_ms:.4f} ms, plain {gr_plain:.4f} ms, torch.sum {gr_lib:.4f} "
        f"ms; bound {gr_b[0]:.4f} ms ({gr_b[1]}) [{card}]")
    phase_step_times(mb, card, torus_ops, torus_verts)

    from diffusionnet_tpu_torch.ops import blocked_ell as be
    from diffusionnet_tpu_torch.geometry.laplacian import cotan_laplacian
    lap = [(name, cotan_laplacian(v, f, denom_eps=1e-10))
           for name, (v, f) in b5_meshes()]
    b5_err = phase_b5(be, lap)
    b5_ms = phase_b5_times(be, lap, card)
    b5_launches = phase_precompute(be, card)
    log(f"  launches of the precompute slice (phase 12, three meshes): B5 "
        f"{b5_launches}")

    from diffusionnet_tpu_torch.ops import fused as fu
    errs.update(phase_b4_b3(mb, fu))
    fused_launches, served_launches, b3_launches = phase_fused_slice(
        mb, fu, seg_batch)
    fused_ms, step_ms = phase_fused_times(mb, fu, card, seg_batch)
    log(f"  launches of the fused slice: 5 train steps {fused_launches}; "
        f"one request {served_launches}; the B3 op's 3 steps {b3_launches}")

    si_launches = phase_c256_train(mb, card)
    wide16b = phase_wide_train(mb, card, seg_batch)
    phase_example_kernels(mb)
    harness_launches, example_launches, harness_whole = phase_harness(
        mb, card, seg_ds)
    ex17d = phase_examples(mb, be, card)
    phase_ell_repeat(card)
    serve18 = phase_serving(mb, fu, card, seg_ds)
    cloud19, cloud_preds, clouds = phase_clouds(mb, be, card)
    phase_geodesics(card, cloud_preds, clouds)
    drivers20 = phase_drivers(mb, be, card)
    par21 = phase_parallel(mb, card, seg_ds, seg_batch, harness_whole,
                           torus_ops)
    shard22 = phase_sharded(fu, be, card, seg_ds)

    widths = (3 * 128, 128, 128, 128)
    b1 = times[(1, 32768, "f32")]
    b2 = bwd_times[(1, 32768, "f32")]
    fwd_b = megablock_bound(1, 32768, 128, 128, widths, True, False)
    bwd_b = megablock_bound(1, 32768, 128, 128, widths, True, True)
    t5 = b5_ms["torus(144, 140)"]
    log(f"  bounds (H100 SXM peaks, [{card}]): B1 B=1 V=32768 f32 "
        f"{fwd_b[0]:.4f} ms ({fwd_b[1]}, three TF32 passes; its row kernel "
        f"{b1['rows'][2][0]:.4f} ms, x_hat kernel {b1['xhat'][2][0]:.4f} "
        f"ms), B2 "
        f"{bwd_b[0]:.4f} ms ({bwd_b[1]}; its rows kernel "
        f"{b2['rows'][2][0]:.4f} ms, grads kernel {b2['grads'][2][0]:.4f} "
        f"ms), xhat_reduce {xr1['bound'][0]:.4f} ms, grad_reduce "
        f"{gr_b[0]:.4f} ms, B5 torus C=160 {t5['bound_ms']:.4f} ms "
        f"({t5['bound_by']})")
    # the whole blocks' bounds at the other shapes the kernel table times
    whole_b = {f"{blk} B={B} V={V} {kind}": megablock_bound(
        B, V, 128, 128, widths, True, blk == "B2", kind == "bf16")
        for blk in ("B1", "B2") for B, V in ((1, 32768), (BENCH_B, BENCH_V))
        for kind in ("f32", "bf16")}
    whole_b["B4a B=1 V=32768 bf16 x"] = fused_bound(1, 32768, 128, 128, 2)
    log("  bounds of the whole blocks (K=C=128, hidden [128, 128]; H100 SXM "
        "peaks, [" + card + "]): " + "; ".join(
            f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in whole_b.items()))
    log(f"  launches of the sampling_invariance model's 3 steps (phase 16): "
        f"{si_launches}; of the wide models' 10 steps and 2 requests "
        f"(phase 16b): {wide16b}")
    log(f"  launches of the harness (phase 17b, 2 epochs at full width): "
        f"{harness_launches}; of the synthetic SHREC example (phase 17c): "
        f"{example_launches}; of the two point-cloud examples (phase 17d): "
        f"{ex17d}; of the serving slice (phase 18, 10 requests): "
        f"{serve18}; of the E5 cloud split (phase 19): {cloud19}")

    log(f"  launches of the five drivers (phase 20): {drivers20}; of "
        f"training over several ranks (phase 21): {par21}; of the sharded "
        f"artifact's two ranks (phase 22): {shard22}")

    def slice_launches(name):
        """A kernel's launches on the main paths that the summary counts:
        phase 8's train steps (B1, B2) or phase 12's precompute (B5), the
        wide models' steps and requests of phase 16b, the point-cloud
        slice's phases 17d and 19, the drivers' phase 20 and phase 21's
        ranks."""
        return (wide16b.get(name, 0) + ex17d.get(name, 0)
                + cloud19.get(name, 0) + drivers20.get(name, 0)
                + par21.get(name, 0))

    def row(name, source, replaces, n, err, ms, plain, bnd, lib):
        return {"name": name, "route": "cuda",
                "source": "diffusionnet_tpu_torch/csrc/" + source,
                "replaces": "diffusionnet_tpu/ops/" + replaces,
                "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": lib}
    summary = {"kernels": [
        # B1 at B=1, V=32768, f32: its row kernel, its x_hat kernel (the
        # plain version of each on the same inputs)
        row("megablock_fwd", "megablock_fwd.cu", "pallas_megablock.py:259",
            launches["megablock_fwd"] + slice_launches("megablock_fwd"),
            errs["megablock_fwd"], *b1["rows"], None),
        row("megablock_fwd_xhat", "megablock_fwd.cu",
            "pallas_megablock.py:309",
            launches["megablock_fwd_xhat"]
            + slice_launches("megablock_fwd_xhat"),
            errs["megablock_fwd_xhat"], *b1["xhat"]),
        # launches: the training slice's (phase 8), the serving slice's
        # (phase 18), the sharded artifact's ranks (phase 22) and the
        # slices of phases 17d, 19, 20 and 21
        row("xhat_reduce", "megablock_fwd.cu", "pallas_megablock.py:305",
            launches["xhat_reduce"] + serve18["xhat_reduce"]
            + shard22["xhat_reduce"] + slice_launches("xhat_reduce"),
            errs["xhat_reduce"], xr1["ms"],
            xr1["plain_ms"], xr1["bound"], xr1["library_ms"]),
        # B2 at B=1, V=32768, f32: its two kernels (the plain version of
        # each on the same inputs) and the partial sums
        row("megablock_bwd_rows", "megablock_bwd.cu",
            "pallas_megablock.py:379",
            launches["megablock_bwd_rows"]
            + slice_launches("megablock_bwd_rows"),
            errs["megablock_bwd_rows"], *b2["rows"], None),
        row("megablock_bwd_grads", "megablock_bwd.cu",
            "pallas_megablock.py:379",
            launches["megablock_bwd_grads"]
            + slice_launches("megablock_bwd_grads"),
            errs["megablock_bwd_grads"], *b2["grads"], None),
        row("grad_reduce", "megablock_bwd.cu", "pallas_megablock.py:486",
            launches["grad_reduce"] + slice_launches("grad_reduce"),
            errs["grad_reduce"], gr_ms, gr_plain,
            gr_b, gr_lib),
        row("blocked_ell", "blocked_ell.cu", "blocked_ell.py:331",
            b5_launches + slice_launches("blocked_ell"), b5_err, t5["ms"],
            t5["plain_ms"], (t5["bound_ms"], t5["bound_by"]),
            t5["library_ms"]),
        # B4 at the training shape (B=4, V=32768, f32); B4a is B=1;
        # launches: the fused slice's 5 steps (phase 14), the serving
        # slice's 10 requests (phase 18), the fused model's sharded forward
        # and step on phase 21b's two ranks, and the sharded artifact's
        # first request on each of its two ranks (phase 22)
        row("spectral_project", "spectral_fused.cu", "pallas_fused.py:200",
            fused_launches["spectral_project"] + serve18["spectral_project"]
            + par21["spectral_project"] + shard22["spectral_project"],
            errs["spectral_project"], *fused_ms[(4, "f32")]["project"]),
        row("spectral_apply", "spectral_fused.cu", "pallas_fused.py:200",
            fused_launches["spectral_apply"] + serve18["spectral_apply"]
            + par21["spectral_apply"] + shard22["spectral_apply"],
            errs["spectral_apply"], *fused_ms[(4, "f32")]["apply"]),
        # the backward's ds (JAX's plain einsums, `_bwd_b`) on the
        # projection's kernel with three pairs
        row("spectral_ds", "spectral_fused.cu", "pallas_fused.py:239",
            fused_launches["spectral_ds"] + par21["spectral_ds"],
            errs["spectral_ds"], *fused_ms[(4, "f32")]["ds"]),
        # B3: spectral_project, xhat_reduce and B1 (B=1, V=32768, f32);
        # launches: the op's calls on its own path
        row("megablock", "spectral_fused.cu", "pallas_megablock.py:244",
            b3_launches["spectral_project"], errs["megablock"],
            *fused_ms[("B3", "f32")]),
    ]}
    log(json.dumps(summary))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
