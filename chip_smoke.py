#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diffusionnet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the hand-written kernels from csrc/ with nvcc;
  3. kernels against their plain PyTorch versions, at the full width of the
     segmentation model (B=2, V=32768, K=128, C=128, hidden [128, 128]) and
     at a small ragged shape, f32 and bf16 operands, emit_next on and off;
  4. the slice: InferenceSession(use_megakernel=True) on the card serves
     three meshes with the segmentation model (seeded weights); the launch
     counters show each request ran n_block block kernels, and the eager
     DiffusionNet on the same card agrees;
  5. times of the block kernel against its plain version (CUDA events
     around 10 calls back to back, median of 10 such runs after warm-up).

The last two lines of standard output are the card's name and power limit
as nvidia-smi reports them, then {"ok": true, "device": {...}}; the line
before them is a JSON summary of the kernels.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

N_BLOCK = 4
SEG_MODEL = dict(c_in=16, c_out=8, c_width=128, n_block=N_BLOCK,
                 mlp_hidden_dims=[128, 128], dropout=True, outputs_at="faces")
K_EIG = 128

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


def compare(name, got, want, tol):
    """Elementwise check; returns the max abs error."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = (got - want).abs()
    max_abs = err.max().item()
    scale = want.abs().max().item()
    bound = tol["atol"] + tol["rtol"] * want.abs()
    ok = bool((err <= bound).all())
    log(f"  {name}: max abs err {max_abs:.3e}, max abs err / max |plain| "
        f"{max_abs / max(scale, 1e-30):.3e} (tolerance rtol {tol['rtol']}, "
        f"atol {tol['atol']}) {'ok' if ok else 'FAILED'}")
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


def phase_kernels(mb):
    log("== phase 3: kernels against their plain versions")
    errs = {"megablock_fwd": 0.0}
    shapes = [(2, 32768, 128, 128, (128, 128), 0),     # full width
              (2, 1000, 16, 8, (16, 32, 8), 100)]      # ragged last tile
    for B, V, K, C, hidden, n_pad in shapes:
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args = block_inputs(B, V, K, C, hidden, dtype, seed=V + K,
                                n_pad=n_pad)
            lowp = kind == "bf16"
            for emit in (True, False):
                out, xn = mb.megablock_chained(*args, emit_next=emit,
                                               lowp=lowp)
                torch.cuda.synchronize()
                ref, ref_xn = mb.megablock_chained_reference(
                    *args, emit_next=emit, lowp=lowp)
                torch.cuda.synchronize()
                tag = (f"B={B} V={V} K={K} C={C} hidden={list(hidden)} "
                       f"{kind} emit_next={emit}")
                check(out.dtype == args[0].dtype and out.shape == ref.shape,
                      f"{tag}: out dtype/shape")
                e = compare(f"{tag} out", out, ref, TOL[kind])
                if emit:
                    e = max(e, compare(f"{tag} x_hat_next", xn, ref_xn,
                                       TOL[kind]))
                else:
                    check(xn is None, f"{tag}: x_hat_next without emit_next")
                if kind == "f32" and V == 32768:
                    errs["megablock_fwd"] = max(errs["megablock_fwd"], e)
    # the partial-sum kernel at the main path's shape (B=1: one CTA per SM)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(7)
    partial = torch.randn(1, sms, mb.SLOT, mb.SLOT, generator=g, device="cuda")
    got = mb.xhat_reduce(partial, 128, 128)
    torch.cuda.synchronize()
    errs["xhat_reduce"] = compare(f"xhat_reduce (1, {sms}, 128, 128)", got,
                                  mb.xhat_reduce_reference(partial, 128, 128),
                                  dict(rtol=0.0, atol=0.0))
    return errs, partial


def phase_slice(mb):
    """The main path: three requests through InferenceSession on the card.
    Returns the launch counts of the three requests."""
    from diffusionnet_tpu_torch.models import DiffusionNet
    from diffusionnet_tpu_torch.training import InferenceSession
    # tests/ is not a package: a `tests` package installed elsewhere would
    # shadow it, so the mesh generator (numpy only) is imported by its path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    from meshgen import icosphere, torus

    log("== phase 4: the slice, InferenceSession(use_megakernel=True) on cuda")
    gen = torch.Generator().manual_seed(0)
    model = DiffusionNet(**SEG_MODEL, generator=gen,
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    with torch.no_grad():  # trained models have non-zero diffusion times
        for blk in model.blocks:
            t = blk.diffusion.diffusion_time
            t.copy_(torch.rand(t.shape, generator=gen) * 0.05)
    requests = [("torus(144, 140)", torus(n_major=144, n_minor=140)),
                ("icosphere(5)", icosphere(subdivisions=5)),
                ("torus(144, 140) again", torus(n_major=144, n_minor=140))]
    with tempfile.TemporaryDirectory() as cache:
        session = InferenceSession(model, k_eig=K_EIG, op_cache_dir=cache,
                                   use_megakernel=True, device="cuda")
        per_block = {"megablock_fwd": N_BLOCK, "xhat_reduce": N_BLOCK - 1}
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

        eager = InferenceSession(model, k_eig=K_EIG, op_cache_dir=cache,
                                 device="cuda")
        for (name, (verts, faces)), p in zip(requests, preds):
            check(p.shape == (faces.shape[0], SEG_MODEL["c_out"]),
                  f"{name}: predictions {p.shape}")
            check(bool(torch.isfinite(torch.from_numpy(p)).all()),
                  f"{name}: non-finite predictions")
            psum = torch.from_numpy(p).double().exp().sum(-1)
            sum_err = (psum - 1).abs().max().item()
            check(sum_err < 1e-4, f"{name}: probabilities sum off by {sum_err}")
            ref = eager(verts, faces)
            compare(f"{name}: predictions {p.shape} against the eager model "
                    f"(probabilities sum to 1 within {sum_err:.1e})",
                    torch.from_numpy(p), torch.from_numpy(ref), SLICE_TOL)
    return launches


def phase_times(mb, card):
    log("== phase 5: block kernel against its plain version, CUDA events, "
        "median of 10 runs of 10 calls")
    ms = {}
    for B, V in ((1, 32768), (8, 20480)):
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args = block_inputs(B, V, 128, 128, (128, 128), dtype, seed=B)
            lowp = kind == "bf16"
            out, xn = mb.megablock_chained(*args, emit_next=True, lowp=lowp)
            torch.cuda.synchronize()
            ref, ref_xn = mb.megablock_chained_reference(*args, emit_next=True,
                                                         lowp=lowp)
            compare(f"B={B} V={V} {kind} out", out, ref, TOL[kind])
            compare(f"B={B} V={V} {kind} x_hat_next", xn, ref_xn, TOL[kind])
            del out, xn, ref, ref_xn
            k = time_ms(lambda: mb.megablock_chained(*args, emit_next=True,
                                                     lowp=lowp))
            p = time_ms(lambda: mb.megablock_chained_reference(
                *args, emit_next=True, lowp=lowp))
            ms[(B, V, kind)] = (k, p)
            log(f"  time megablock_chained emit_next B={B} V={V} K=128 C=128 "
                f"{kind}: kernel {k:.4f} ms, plain {p:.4f} ms [{card}]")
            del args
    return ms


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
        if "registers" in line or "spill" in line or "entry function" in line:
            log("  " + line.strip())

    errs, partial = phase_kernels(mb)
    launches = phase_slice(mb)
    times = phase_times(mb, card)
    xr_ms = time_ms(lambda: mb.xhat_reduce(partial, 128, 128))
    xr_plain = time_ms(lambda: mb.xhat_reduce_reference(partial, 128, 128))
    log(f"  time xhat_reduce (1, {partial.shape[1]}, 128, 128): kernel "
        f"{xr_ms:.4f} ms, plain {xr_plain:.4f} ms [{card}]")

    k_ms, p_ms = times[(1, 32768, "f32")]
    summary = {"kernels": [
        {"name": "megablock_fwd", "route": "cuda",
         "source": "diffusionnet_tpu_torch/csrc/megablock_fwd.cu",
         "replaces": "diffusionnet_tpu/ops/pallas_megablock.py:259",
         "launches": launches["megablock_fwd"],
         "max_abs_err": errs["megablock_fwd"], "ms": k_ms, "plain_ms": p_ms},
        {"name": "xhat_reduce", "route": "cuda",
         "source": "diffusionnet_tpu_torch/csrc/megablock_fwd.cu",
         "replaces": "diffusionnet_tpu/ops/pallas_megablock.py:305",
         "launches": launches["xhat_reduce"],
         "max_abs_err": errs["xhat_reduce"], "ms": xr_ms,
         "plain_ms": xr_plain},
    ]}
    log(json.dumps(summary))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
