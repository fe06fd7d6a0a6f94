"""Synthetic SHREC-style classification: 10 classes of parametric shapes
(spheres, ellipsoids, tori, capsules, ...) with per-sample jitter, trained
with the reference's E1 configuration (DiffusionNet 4 x 64, global_mean
outputs, label smoothing 0.2, HKS-16 features, k_eig 32, batch 10, Adam
1e-3 halved every 50 epochs; reference classification_shrec11.py:30-91).
The counterpart of examples/synthetic_shrec.py: the same shape families,
seeds and configuration. It needs no download.

    python -m diffusionnet_tpu_torch.examples.synthetic_shrec [--mega]
        [--bf16] [--input_features xyz] [--n_epoch 40] [--per_class 10]
        [--seed 0] [--device cuda]

The mesh generator is the repository's tests/meshgen.py, loaded by its
path when the example runs.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data import SurfaceDataset
from ..experiments.exp_common import FitConfig, build_model, fit
from ..utils import normalize_positions_np


def _meshgen():
    """tests/meshgen.py of this checkout (numpy only), imported by path: a
    `tests` package installed elsewhere would shadow it."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "tests")
    if not os.path.isfile(os.path.join(tests, "meshgen.py")):
        raise FileNotFoundError(f"no meshgen.py under {tests}")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import meshgen
    return meshgen


def make_shape(cls: int, rs: np.random.RandomState, mg):
    """10 parametric shape classes with geometric jitter."""
    icosphere, torus = mg.icosphere, mg.torus
    if cls == 0:      # sphere
        v, f = icosphere(subdivisions=2)
    elif cls == 1:    # prolate ellipsoid
        v, f = icosphere(subdivisions=2)
        v = v * np.array([1.0, 1.0, 1.9])
    elif cls == 2:    # oblate ellipsoid
        v, f = icosphere(subdivisions=2)
        v = v * np.array([1.4, 1.4, 0.55])
    elif cls == 3:    # fat torus
        v, f = torus(n_major=16, n_minor=10, r=0.42)
    elif cls == 4:    # thin torus
        v, f = torus(n_major=16, n_minor=10, r=0.16)
    elif cls == 5:    # squashed torus
        v, f = torus(n_major=16, n_minor=10, r=0.3)
        v = v * np.array([1.0, 1.0, 0.45])
    elif cls == 6:    # capsule (stretched sphere, pinched middle)
        v, f = icosphere(subdivisions=2)
        v = v * np.array([0.7, 0.7, 1.8])
        v[:, 0] *= 1.0 + 0.35 * np.abs(v[:, 2]) / 1.8
    elif cls == 7:    # bumpy sphere (low-frequency displacement)
        v, f = icosphere(subdivisions=2)
        v = v * (1.0 + 0.22 * np.sin(3.0 * v[:, [2]]))
    elif cls == 8:    # star-torus (modulated tube)
        v, f = torus(n_major=20, n_minor=10, r=0.3)
        ang = np.arctan2(v[:, 1], v[:, 0])
        v = v * (1.0 + 0.18 * np.cos(4 * ang))[:, None]
    else:             # egg (asymmetric ellipsoid)
        v, f = icosphere(subdivisions=2)
        v = v * np.array([0.9, 0.9, 1.3])
        v[:, 2] += 0.25 * v[:, 2] ** 2 / 1.3
    v = v * (1.0 + 0.04 * rs.randn(*v.shape))   # vertex jitter
    v = normalize_positions_np(v)
    return v.astype(np.float32), f


def build_dataset(per_class: int, seed: int, mg, device="cuda"):
    rs = np.random.RandomState(seed)
    ds = SurfaceDataset(labels_kind="global")
    for cls in range(10):
        for _ in range(per_class):
            v, f = make_shape(cls, rs, mg)
            ds.add(v, f, cls)
    ds.precompute(k_eig=32, verbose=False, device=device)
    return ds


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_epoch", type=int, default=40)
    ap.add_argument("--per_class", type=int, default=10)
    ap.add_argument("--input_features", type=str, default="hks")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 operands (f32 parameters and sums)")
    ap.add_argument("--mega", action="store_true",
                    help="blocks on the block kernels B1/B2")
    ap.add_argument("--seed", type=int, default=0,
                    help="FitConfig.seed: initial weights, shuffles and "
                         "rotations (the datasets keep seeds 0 and 1)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    mg = _meshgen()
    print("building synthetic datasets...")
    train_ds = build_dataset(args.per_class, 0, mg, args.device)
    test_ds = build_dataset(max(3, args.per_class // 3), 1, mg, args.device)

    cfg = FitConfig(n_epoch=args.n_epoch, lr=1e-3, decay_every=50,
                    decay_rate=0.5, batch_size=10,
                    input_features=args.input_features,
                    augment_rotate=(args.input_features == "xyz"),
                    label_smoothing=0.2, labels_kind="global",
                    use_megakernel=args.mega, seed=args.seed)
    model = build_model(n_class=10, c_width=64, outputs_at="global_mean",
                        dropout=False, input_features=args.input_features,
                        n_block=4, bf16=args.bf16)
    params, history, evaluate = fit(model, train_ds, test_ds, cfg,
                                    device=args.device)
    acc = evaluate(params, test_ds)
    print(f"Overall test accuracy: {100 * acc:06.3f}%")
    return acc


if __name__ == "__main__":
    main()
