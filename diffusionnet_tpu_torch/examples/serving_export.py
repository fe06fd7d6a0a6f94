"""Export a DiffusionNet forward as a serving artifact, then load and serve
it back: the deployment path. The counterpart of examples/serving_export.py.

The artifact (diffusionnet_tpu_torch.serving) is a directory of
torch.export programs (one per vertex bucket, batch dimension symbolic),
params and a manifest. The loading side needs only torch, numpy and the
port's kernel ops: no model class, no geometry stack. It exports on the
card unless --device cpu is given, and serves icosphere(3) and
torus(48, 24) back.

    python -m diffusionnet_tpu_torch.examples.serving_export
        [--out_dir DIR] [--k_eig 32] [--buckets 1024 4096] [--device cuda]

Without --out_dir the artifact goes to a new directory under the system's
temporary directory (TMPDIR), named in the first printed line.

The mesh generator is the repository's tests/meshgen.py, loaded by its
path when the example runs.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..geometry import compute_operators
from ..models import DiffusionNet
from ..serving import export_forward, load_serving_model
from .synthetic_shrec import _meshgen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", default=None,
                    help="artifact directory (default: a new one under "
                    "TMPDIR)")
    ap.add_argument("--k_eig", type=int, default=32)
    ap.add_argument("--buckets", type=int, nargs="+", default=[1024, 4096])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.out_dir is None:
        args.out_dir = tempfile.mkdtemp(prefix="dnt_artifact_")
    mg = _meshgen()

    # --- export side (has the model definition and its weights) ----------
    model = DiffusionNet(c_in=3, c_out=8, c_width=64, n_block=4,
                         dropout=False, outputs_at="vertices")
    t0 = time.time()
    export_forward(model, v_buckets=args.buckets, out_dir=args.out_dir,
                   k_eig=args.k_eig, device=args.device)
    size = sum(os.path.getsize(os.path.join(args.out_dir, f))
               for f in os.listdir(args.out_dir))
    print(f"exported {args.buckets} buckets to {args.out_dir} "
          f"({size / 1e6:.2f} MB) in {time.time() - t0:.1f}s")

    # --- serving side (artifact + operators only) --------------------------
    sm = load_serving_model(args.out_dir, device=args.device)
    for name, (v, f) in [("sphere", mg.icosphere(subdivisions=3)),
                         ("torus", mg.torus(48, 24))]:
        mops = compute_operators(v, f, k_eig=args.k_eig, device=args.device)
        t0 = time.time()
        out = sm.call_operators(v.astype(np.float32), mops)
        if out.is_cuda:
            torch.cuda.synchronize()
        print(f"{name}: {v.shape[0]} verts -> logits {tuple(out.shape)} "
              f"(bucket {sm.pick_bucket(v.shape[0])}, "
              f"{1e3 * (time.time() - t0):.1f} ms, the first request)")


if __name__ == "__main__":
    main()
