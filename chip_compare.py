#!/usr/bin/env python3
"""Times kernels of the PyTorch port for the package of a given tree, on one
CUDA card.

    python3 chip_compare.py [--block | --fused | --eager] [TREE]

TREE (default: this checkout) is a directory that holds a
diffusionnet_tpu_torch package, such as an unpacked `git archive` of another
commit; its package is imported in place of this checkout's, and its
kernels are built there. To compare two trees, run both on one card in
turns (A, B, B, A): each run prints one JSON line. Measured, on the card,
with --block (the block kernels and the train step they carry):

  * B1 (megablock_chained_fwd, emit_next) and B2 (megablock_chained_bwd,
    emit_next) at K = C = 128, hidden [128, 128], B=1, V=32768 and B=8,
    V=20480, f32 and bf16 operands (chip_smoke.time_ms); where the tree's
    B2 is two kernels (megablock_bwd_rows, megablock_bwd_grads), each of
    them and the three partial sums of its partials, beside the bounds of
    chip_smoke.b2_bounds; where the tree's B1 is a row kernel and an x_hat
    kernel (megablock_fwd_xhat), each of them (the row kernel as B1 without
    emit_next; the x_hat kernel on the f32 out and the mass) beside its
    bound (chip_smoke.megablock_bound without emit_next,
    chip_smoke.xhat_bound); and a digest of the bits of B1's, B2's and the
    x_hat kernel's results on these inputs (`digest`), which two trees
    share where their kernels sum in the same order;
  * B1 at C = 256, hidden [256, 256], K = 128, B=1, V=32768 (the
    sampling_invariance model's widths), the same way; B1 and B2 at C = 256
    with hidden [1024, 1024] (a tree's wide route, where it has one);
  * xhat_reduce at B1's split counts (1, 128) and (8, 16), and at
    (1, 132), in device time (chip_smoke.device_ms);
  * the train step at bench.py's shapes (chip_smoke.phase_step_times,
    without its profile), f32 and bf16 operands, on torus(144, 140)'s
    operators from the host eigensolver, cached under build/dev/.

With --fused (the fused spectral block B4 and the paths that run it):

  * spectral_project, spectral_apply and the whole fused block
    (fused_spectral_block_batched) at B=4 and B=1, V=32768, K=C=128, a
    f32 and a bf16 x beside f32 operators (chip_smoke.time_ms), beside the
    bounds of chip_smoke.fused_bound, the projection also in device time
    (chip_smoke.device_ms: at B=1 CUDA events time the wrappers' host
    work) and in host time (`host_ms`); where the tree has it, the
    backward's ds kernel (spectral_ds);
  * the B3 op (ops.megablock.megablock, dropout off) at B=1, V=32768,
    hidden [128, 128], f32 and bf16 operands, in CUDA events, in device
    time and in host time;
  * the fused segmentation train step of chip_smoke.py's phase 14 (the
    segmentation model with use_pallas_fused=True through
    apply_model(use_megakernel=False), dropout on, B=4 padded to 32768),
    its dataset's operators cached under build/dev/.

With --eager (the eager model as the drivers build it, without
use_pallas_fused, on seeded dense spectral operators, K 128):

  * one train step (forward, autograd backward, torch.optim.Adam) of
    classification_shrec11's model (c_width 64, HKS in, 30 classes,
    global_mean, dropout on) at B=8, V = 1024 and 4096;
  * one request (forward under no_grad, batch 1) of the segmentation
    model with vertex outputs (chip_smoke.SEG_MODEL) at V = 1024, 4096 and
    16384;

  each in CUDA events around calls back to back (chip_smoke.time_ms, 30
  runs: the pace, the host's or the device's), in device time
  (chip_smoke.device_ms) and in host time (`host_ms`), with B4's launches
  in one call (none where the tree runs these blocks on the dense route).
  The last two hold the device with a spin while the host issues, so they
  issue one step, or four requests, a run: more would fill the card's
  launch queue (about a thousand launches), and the host would wait.

Without --block, --fused or --eager:

  * B5 at C = 160 on the cotan Laplacians of torus(144, 140) and
    delaunay_sphere(100000): device time (chip_smoke.device_ms) and CUDA
    events around back-to-back calls (chip_smoke.time_ms), beside
    torch.sparse.mm on the same permuted matrix in CSR; whether two launches
    give the same bits; the format's bytes;
  * xhat_reduce at (1, 132, 128, 128) and (8, 16, 128, 128), the same two
    ways, beside torch.sum of the slots;
  * the device eigensolver (k 128, the operators' own call without the f64
    polish) on those two meshes and icosphere(5): the eigen_band_build and
    eigen_sweeps seconds, B5's launches and the sweep count; on the torus
    also the device's busy time in one more solve under torch.profiler.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import json
import os
import statistics
import sys
import time

import numpy as np
import torch


def digest(*results) -> str:
    """The first 16 hex digits of a SHA-256 of the results' bits (tensors,
    or lists and tuples of them, None skipped), in order."""
    h = hashlib.sha256()

    def add(r):
        if isinstance(r, (list, tuple)):
            for t in r:
                add(t)
        elif r is not None:
            h.update(r.detach().contiguous().cpu().view(torch.uint8)
                     .numpy().tobytes())
    add(results)
    return h.hexdigest()[:16]


def host_ms(fn, calls=20, reps=11, warmup=3) -> float:
    """The host's time to issue one call of fn (the wrappers' Python work
    and the launches), median of `reps` runs of `calls` calls issued while
    a spin kernel holds the device, so that no call waits on it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(1 << 27)  # about 0.07-0.1 s at 1.4-2 GHz
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return statistics.median(runs)


def b1_route(mb, C, widths, lowp) -> list:
    """B1's route or layout at these widths in the tree's own terms (its
    fwd_route took K first while it had a wide route)."""
    limit = mb._smem_limit(0)
    if "K" in inspect.signature(mb.fwd_route).parameters:
        return list(mb.fwd_route(128, C, widths, lowp, limit))
    return list(mb.fwd_route(C, widths, lowp, limit))


def block_times(cs, out):
    """B1 and B2 (and their kernels where the tree has them), B1 at C = 256,
    xhat_reduce and the bench-shape train step, into `out`."""
    from diffusionnet_tpu_torch.geometry import operators as ops_mod
    from diffusionnet_tpu_torch.ops import megablock as mb
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    widths = (384, 128, 128, 128)
    split = hasattr(mb, "megablock_bwd_rows")
    fwd_split = hasattr(mb, "megablock_fwd_xhat")

    def b1(r, args, B, V, C, widths, lowp):
        r["b1_ms"] = cs.time_ms(lambda: mb.megablock_chained_fwd(
            *args, emit_next=True, lowp=lowp))
        r["b1_digest"] = digest(mb.megablock_chained_fwd(
            *args, emit_next=True, lowp=lowp))
        if not fwd_split:
            return
        src = mb.megablock_chained_reference(
            *args, emit_next=False, lowp=lowp)[0].float().contiguous()
        sp = mb.xhat_splits(B, V, 128, C, sms)
        r["b1_xhat_digest"] = digest(mb.reduce_pieces(mb.megablock_fwd_xhat(
            args[1], src, args[4], sp, lowp), B, 128, C))
        r.update(
            b1_rows_ms=cs.time_ms(lambda: mb.megablock_chained_fwd(
                *args, emit_next=False, lowp=lowp)),
            b1_xhat_ms=cs.time_ms(lambda: mb.megablock_fwd_xhat(
                args[1], src, args[4], sp, lowp)),
            b1_rows_bound_ms=cs.megablock_bound(B, V, 128, C, widths, False,
                                                False, lowp)[0],
            b1_xhat_bound_ms=cs.xhat_bound(B, V, 128, C, sp[0], lowp)[0],
            b1_route=b1_route(mb, C, widths, lowp),
            xhat_splits=sp)
        del src

    for B, V in ((1, 32768), (cs.BENCH_B, cs.BENCH_V)):
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            lowp = kind == "bf16"
            args = cs.block_inputs(B, V, 128, 128, (128, 128), dtype, seed=B)
            g = torch.Generator(device="cuda").manual_seed(3)
            dout = torch.randn(B, V, 128, generator=g, device="cuda").to(dtype)
            dxn = torch.randn(B, 128, 128, generator=g, device="cuda")
            r = {}
            b1(r, args, B, V, 128, widths, lowp)
            r["b2_ms"] = cs.time_ms(lambda: mb.megablock_chained_bwd(
                *args, dout, dxn, lowp=lowp))
            r["b2_digest"] = digest(mb.megablock_chained_bwd(
                *args, dout, dxn, lowp=lowp))
            if split:
                _, R, dbp = mb.megablock_bwd_rows(*args, dout, dxn, lowp=lowp)
                sp = mb.grads_splits(B, V, 128, 128, widths, sms)
                pp, pd = mb.megablock_bwd_grads(R, *args[1:4], 128, widths,
                                                sp, lowp)
                rb, gb = cs.b2_bounds(B, V, 128, 128, widths, lowp)
                r.update(
                    rows_ms=cs.time_ms(lambda: mb.megablock_bwd_rows(
                        *args, dout, dxn, lowp=lowp)),
                    grads_ms=cs.time_ms(lambda: mb.megablock_bwd_grads(
                        R, *args[1:4], 128, widths, sp, lowp)),
                    sums_device_ms=cs.device_ms(lambda: (
                        mb.grad_reduce(pd, 0, 128 * 128),
                        mb.grad_reduce(pp.unsqueeze(0), 0, pp.shape[1]),
                        mb.grad_reduce(dbp.unsqueeze(0), 0, dbp.shape[1]))),
                    rows_bound_ms=rb[0], grads_bound_ms=gb[0], splits=sp)
                del R, dbp, pp, pd
            out[f"block B={B} V={V} {kind}"] = r
            del args, dout, dxn
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = cs.block_inputs(1, 32768, 128, 256, (256, 256), dtype, seed=1)
        r = {}
        b1(r, args, 1, 32768, 256, (768, 256, 256, 256), kind == "bf16")
        out[f"block C=256 B=1 V=32768 K=128 {kind}"] = r
        del args
    widths = (768, 1024, 1024, 256)
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        lowp = kind == "bf16"
        args = cs.block_inputs(1, 32768, 128, 256, widths[1:3], dtype, seed=1)
        g = torch.Generator(device="cuda").manual_seed(3)
        dout = torch.randn(1, 32768, 256, generator=g, device="cuda").to(dtype)
        dxn = torch.randn(1, 128, 256, generator=g, device="cuda")
        r = {}
        b1(r, args, 1, 32768, 256, widths, lowp)
        r.update(
            b1_bound_ms=cs.megablock_bound(1, 32768, 128, 256, widths, True,
                                           False, lowp)[0],
            b2_ms=cs.time_ms(lambda: mb.megablock_chained_bwd(
                *args, dout, dxn, lowp=lowp)),
            b2_digest=digest(mb.megablock_chained_bwd(*args, dout, dxn,
                                                      lowp=lowp)))
        out[f"block C=256 hidden [1024, 1024] B=1 V=32768 K=128 {kind}"] = r
        del args, dout, dxn
    g = torch.Generator(device="cuda").manual_seed(7)
    for B, S in ((1, 128), (8, 16), (1, 132)):
        p = torch.randn(B, S, mb.SLOT, mb.SLOT, generator=g, device="cuda")
        out[f"xhat_reduce ({B}, {S})"] = dict(
            device_ms=cs.device_ms(lambda: mb.xhat_reduce(p, 128, 128)))
        del p
    mg = cs.meshgen()
    verts, faces = mg.torus(n_major=144, n_minor=140)
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "dev", "compare_cache")
    torus_ops = ops_mod.get_operators(verts, faces, k_eig=cs.K_EIG,
                                      op_cache_dir=cache,
                                      eigensolver="host")
    steps = cs.phase_step_times(mb, out["card"], torus_ops, verts,
                                profiled=False)
    out["train step ms"] = steps


def fused_times(cs, out):
    """B4's kernels and whole block, the B3 op and the fused train step,
    into `out`."""
    from diffusionnet_tpu_torch.data import make_padded_batches
    from diffusionnet_tpu_torch.models import flat_params
    from diffusionnet_tpu_torch.ops import fused as fu
    from diffusionnet_tpu_torch.ops import megablock as mb
    from diffusionnet_tpu_torch.training import (
        TaskConfig, adam_with_step_decay, apply_model, loss_and_counts,
        make_train_step)
    for B in (4, 1):
        for kind, dt in (("f32", torch.float32), ("bf16 x", torch.bfloat16)):
            x, evecs, gX, gY, mass, coefs = cs.fused_inputs(
                B, 32768, 128, 128, dt, seed=B)
            xb = 2 if dt == torch.bfloat16 else 4
            x_hat = fu.spectral_project(x, evecs, mass)
            r = out[f"B4 B={B} V=32768 {kind}"] = dict(
                project_ms=cs.time_ms(lambda: fu.spectral_project(
                    x, evecs, mass)),
                project_device_ms=cs.device_ms(lambda: fu.spectral_project(
                    x, evecs, mass)),
                project_host_ms=host_ms(lambda: fu.spectral_project(
                    x, evecs, mass)),
                apply_ms=cs.time_ms(lambda: fu.spectral_apply(
                    x_hat, coefs, evecs, gX, gY, dt)),
                whole_ms=cs.time_ms(lambda: fu.fused_spectral_block_batched(
                    x, evecs, gX, gY, mass, coefs)),
                project_bound_ms=cs.fused_bound(B, 32768, 128, 128, xb,
                                                ("project",))[0],
                apply_bound_ms=cs.fused_bound(B, 32768, 128, 128, xb,
                                              ("apply",))[0])
            if hasattr(fu, "spectral_ds"):
                cts = [torch.randn_like(x) for _ in range(3)]
                r["ds_ms"] = cs.time_ms(lambda: fu.spectral_ds(
                    evecs, gX, gY, *cts))
                del cts
            del x, evecs, gX, gY, mass, coefs, x_hat
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = cs.block_inputs(1, 32768, 128, 128, (128, 128), dtype,
                               seed=37)[:10]
        op = (lambda: mb.megablock(*args, 0, 1024, False))
        out[f"B3 B=1 V=32768 {kind}"] = dict(ms=cs.time_ms(op),
                                             device_ms=cs.device_ms(op),
                                             host_ms=host_ms(op))
        del args
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "dev", "compare_cache")
    batch = next(make_padded_batches(cs.segmentation_dataset(cache),
                                     4)).to("cuda")
    model = cs.segmentation_model(use_pallas_fused=True)
    params = flat_params(model, "cuda", requires_grad=True)
    cfg = TaskConfig(input_features="hks", labels_kind="face",
                     use_megakernel=False)
    opt = adam_with_step_decay(1e-3)
    state = opt.init(params)
    step = make_train_step(
        lambda p, b, g: loss_and_counts(
            apply_model(model, p, b, g, cfg, False), b, cfg), opt)
    gen = torch.Generator(device="cuda").manual_seed(9)
    out["fused train step ms"] = cs.time_ms(
        lambda: step(params, state, batch, gen), reps=5, calls=3, warmup=2)


def _eager_operands(B, V, K, c_in, seed):
    """Seeded inputs and dense spectral operators on the card, scaled as a
    surface's (mass summing to 1, eigenvalues growing by about 4 pi,
    gradients of size sqrt(evals / 2)); the last V / 8 rows are padding."""
    g = torch.Generator().manual_seed(seed)
    n_pad = V // 8
    x = torch.randn(B, V, c_in, generator=g)
    mass = torch.rand(B, V, generator=g) + 0.5
    mass[:, V - n_pad:] = 0
    mass = mass / mass.sum(-1, keepdim=True)
    evals = torch.cumsum(4 * np.pi * (0.5 + torch.rand(B, K, generator=g)),
                         -1)
    evecs = torch.randn(B, V, K, generator=g)
    gX, gY = (torch.randn(B, V, K, generator=g) * (evals[:, None] / 2).sqrt()
              for _ in range(2))
    for t in (x, evecs, gX, gY):
        t[:, V - n_pad:] = 0
    return [t.to("cuda") for t in (x, mass, evals, evecs, gX, gY)]


def eager_times(cs, out):
    """Small buckets on the eager model: SHREC11's train step and a batch-1
    request of the segmentation model, into `out`."""
    from diffusionnet_tpu_torch.models import DiffusionNet
    from diffusionnet_tpu_torch.ops import fused as fu

    def timed(fn, calls, held):
        fu.reset_launches()
        fn()
        torch.cuda.synchronize()
        launches = sum(fu.LAUNCHES.values())
        return dict(ms=cs.time_ms(fn, reps=30, calls=calls),
                    device_ms=cs.device_ms(fn, calls=held, reps=9),
                    host_ms=host_ms(fn, calls=held, reps=21),
                    b4_launches=launches)

    log_softmax = functools.partial(torch.log_softmax, dim=-1)
    for V in (1024, 4096):
        model = DiffusionNet(
            c_in=16, c_out=30, c_width=64, n_block=4, dropout=True,
            outputs_at="global_mean", last_activation=log_softmax,
            generator=torch.Generator().manual_seed(1)).to("cuda").train()
        inputs = _eager_operands(8, V, 128, 16, seed=V)
        labels = torch.arange(8, device="cuda") % 30
        adam = torch.optim.Adam(model.parameters(), lr=1e-3)

        def step():
            adam.zero_grad(set_to_none=True)
            loss = torch.nn.functional.nll_loss(model(*inputs), labels)
            loss.backward()
            adam.step()
        out[f"shrec11 step B=8 V={V}"] = timed(step, calls=3, held=1)
        del model, inputs, adam
    model = DiffusionNet(**{**cs.SEG_MODEL, "outputs_at": "vertices"},
                         last_activation=log_softmax,
                         generator=torch.Generator().manual_seed(2)
                         ).to("cuda").eval()
    for V in (1024, 4096, 16384):
        inputs = _eager_operands(1, V, 128, 16, seed=V + 1)

        def request():
            with torch.no_grad():
                return model(*inputs)
        out[f"segmentation request B=1 V={V}"] = timed(request, calls=10,
                                                       held=4)
        del inputs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_compare: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    argv = sys.argv[1:]
    block, fused = "--block" in argv, "--fused" in argv
    eager = "--eager" in argv
    argv = [a for a in argv if a not in ("--block", "--fused", "--eager")]
    tree = os.path.abspath(argv[0] if argv else here)
    import chip_smoke as cs        # this checkout's, whatever the tree
    sys.path.insert(0, tree)       # the tree's package before this one's
    import scipy.sparse
    from diffusionnet_tpu_torch.geometry import eigen
    from diffusionnet_tpu_torch.geometry import operators as ops_mod
    from diffusionnet_tpu_torch.geometry.laplacian import (cotan_laplacian,
                                                          vertex_areas)
    from diffusionnet_tpu_torch.ops import blocked_ell as be
    from diffusionnet_tpu_torch.ops import megablock as mb
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False

    out = {"tree": tree, "card": cs.card_line()}
    if block or fused or eager:
        (block_times if block else fused_times if fused else eager_times)(
            cs, out)
        print(json.dumps(out), flush=True)
        return 0
    for name, (v, f) in cs.b5_meshes():
        L = cotan_laplacian(v, f, denom_eps=1e-10)
        V, C = L.shape[0], cs.C_SUBSPACE
        b = be.blocked_ell_from_sparse(L, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(11)
        x = torch.zeros(b.n_pad, C, device="cuda")
        x[:V] = torch.randn(V, C, generator=g, device="cuda")
        Lp = scipy.sparse.csr_matrix(L)[b.perm][:, b.perm].astype("float32")
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(Lp.indptr.astype("int64")),
            torch.from_numpy(Lp.indices.astype("int64")),
            torch.from_numpy(Lp.data), size=Lp.shape).to("cuda")
        xv = x[:V].contiguous()
        y, again = be.blocked_ell_matvec(b, x), be.blocked_ell_matvec(b, x)
        ref = be.blocked_ell_matvec_reference(b, x)
        torch.cuda.synchronize()
        out[f"b5 {name}"] = dict(
            device_ms=cs.device_ms(lambda: be.blocked_ell_matvec(b, x)),
            events_ms=cs.time_ms(lambda: be.blocked_ell_matvec(b, x)),
            sparse_mm_device_ms=cs.device_ms(lambda: torch.sparse.mm(csr, xv)),
            sparse_mm_events_ms=cs.time_ms(lambda: torch.sparse.mm(csr, xv)),
            bit_identical=bool(torch.equal(y, again)),
            err=(y - ref).abs().max().item() / ref.abs().max().item(),
            format_bytes=b.nbytes())
        del b, x, xv, csr, y, again, ref

    g = torch.Generator(device="cuda").manual_seed(7)
    for B, S in ((1, 132), (8, 16)):
        p = torch.randn(B, S, mb.SLOT, mb.SLOT, generator=g, device="cuda")
        out[f"xhat_reduce ({B}, {S})"] = dict(
            device_ms=cs.device_ms(lambda: mb.xhat_reduce(p, 128, 128)),
            events_ms=cs.time_ms(lambda: mb.xhat_reduce(p, 128, 128)),
            sum_device_ms=cs.device_ms(lambda: p[:, :, :128, :128].sum(1)),
            sum_events_ms=cs.time_ms(lambda: p[:, :, :128, :128].sum(1)))

    mg = cs.meshgen()
    meshes = cs.b5_meshes()
    meshes.insert(1, ("icosphere(5)", mg.icosphere(subdivisions=5)))
    for name, (v, f) in meshes:
        L = cotan_laplacian(v, f, denom_eps=1e-10)
        m = vertex_areas(v, f)
        m = m + 1e-8 * np.mean(m)
        ell = ops_mod._csc_to_ell(L, dtype=np.float32)

        def solve(tm):
            eigen.eigensolve_device(ell, m.astype(np.float32), cs.K_EIG,
                                    eps=1e-8, timings=tm, device="cuda")
        tm = {}
        be.reset_launches()
        torch.cuda.synchronize()
        solve(tm)
        out[f"eigen {name}"] = dict(
            band_build_s=tm.get("eigen_band_build"),
            sweeps_s=tm.get("eigen_sweeps"),
            b5_launches=be.LAUNCHES["blocked_ell"],
            sweeps=eigen.LAST_CONVERGE_INFO.get("sweeps"))
        if name.startswith("torus"):
            from torch.profiler import ProfilerActivity, profile
            tm = {}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                solve(tm)
            busy = 0.0
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    t = getattr(e, "self_device_time_total", None)
                    busy += t if t is not None else e.self_cuda_time_total
            out[f"eigen {name} profiled"] = dict(
                sweeps_s=tm.get("eigen_sweeps"), device_busy_s=busy / 1e6)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
