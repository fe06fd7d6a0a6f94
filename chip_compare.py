#!/usr/bin/env python3
"""Times the PyTorch port's kernel B5 (the sliced-ELL SpMM), its x_hat
partial sum `xhat_reduce` and the device eigensolver's sweeps, for the
package of a given tree, on one CUDA card.

    python3 chip_compare.py [TREE]

TREE (default: this checkout) is a directory that holds a
diffusionnet_tpu_torch package, such as an unpacked `git archive` of another
commit; its package is imported in place of this checkout's, and its
kernels are built there. To compare two trees, run both on one card in
turns (A, B, B, A): each run prints one JSON line. Measured, on the card:

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

import json
import os
import sys

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_compare: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here)
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
