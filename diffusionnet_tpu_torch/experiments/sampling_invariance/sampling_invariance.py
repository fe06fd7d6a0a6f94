"""Sampling-invariance stress test: 6890-class template-vertex
correspondence, trained on FAUST templates and tested on six
discretizations of held-out shapes. The counterpart of
experiments/sampling_invariance/sampling_invariance.py, the reference's
configuration (C_width 256, 4 blocks, outputs at vertices, dropout on, xyz
features with rotations about the y axis only, Adam 1e-3 halved every 50
epochs); the evaluation reports each mutation's mean geodesic error on the
first training mesh, normalized by its geodesic diameter (reference
:212-225).

    python -m diffusionnet_tpu_torch.experiments.sampling_invariance.sampling_invariance \
        [--megakernel] [--geodesic_method exact|heat|heat_device|steiner|graph] \
        [--device cuda] [--evaluate --load_model PATH] [--data_dir DIR]

The data is what experiments/sampling_invariance/prepare_data.py lays out.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ...data import make_padded_batches
from ...geometry import geodesic_label_errors, read_mesh
from ...training import TaskConfig, apply_model
from ...utils import normalize_positions_np
from ..exp_common import (FitConfig, Stopwatch, add_device_arg, build_model,
                          driver_device, fit, load_weights, make_evaluate,
                          suite_dir)
from .faust_with_robust_test_dataset import (FaustWithRobustTestDataset,
                                             registration_path)

SUITE = "sampling_invariance"


def per_mutation_geodesic_errors(model, params, test_ds, cfg: FitConfig,
                                 verts_ref, faces_ref, geodesic_cache_dir,
                                 method="exact", device="cuda"):
    """Each mutation's geodesic errors on the training-reference mesh,
    normalized by its diameter (reference sampling_invariance.py:212-225):
    the eager model at batch 1 on the ELL gradient operators, as the JAX
    package evaluates it, and the table of `method` computed on `device`
    where the method runs there ('heat_device'). Returns {mutation: errors}
    and prints each mutation's mean."""
    tcfg = TaskConfig(input_features=cfg.input_features,
                      labels_kind="vertex", use_megakernel=False)
    mut_errors = {}
    for i_shape, batch in enumerate(make_padded_batches(test_ds, 1,
                                                        shuffle=False)):
        batch = batch._replace(ops=batch.ops._replace(
            gradX_spec=None, gradY_spec=None)).to(device)
        with torch.no_grad():
            preds = apply_model(model, params, batch, None, tcfg,
                                deterministic=True)
        pred_labels = preds.argmax(-1)[0].cpu().numpy()
        labels = batch.labels[0].cpu().numpy()
        valid = labels >= 0
        errors = geodesic_label_errors(
            verts_ref, faces_ref, pred_labels[valid], labels[valid],
            normalization="diameter", geodesic_cache_dir=geodesic_cache_dir,
            method=method, device=device)
        mut = test_ds.mut_list[i_shape]
        mut_errors.setdefault(mut, []).extend(np.asarray(errors).tolist())
    print("\n== Geodesic errors ==")
    for mut, errs in mut_errors.items():
        print(f"    {mut:>8}  mean: {100 * np.mean(errs):.2f}")
    return mut_errors


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--load_model", type=str, default=None)
    parser.add_argument("--input_features", type=str, default="xyz")
    parser.add_argument("--n_epoch", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--k_eig", type=int, default=128)
    parser.add_argument("--device_data", action="store_true",
                        help="keep the stacked dataset on the card and "
                             "gather batches there (no per-step host copy)")
    parser.add_argument("--megakernel", action="store_true",
                        help="the blocks on kernels B1/B2")
    parser.add_argument("--geodesic_method", type=str, default="exact",
                        help="'exact' (reference parity) | 'heat' (fast "
                             "approximate) | 'heat_device' (the full table "
                             "on --device) | 'steiner' | 'graph'")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="checkpoint dir: continue a stopped run")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--n_train", type=int, default=80)
    parser.add_argument("--n_test", type=int, default=20)
    parser.add_argument("--data_dir", type=str, default=None,
                        help=f"dataset root (default: experiments/{SUITE}/"
                             "data)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = driver_device(args.device)

    dataset_path = args.data_dir or os.path.join(suite_dir(SUITE), "data")
    op_cache_dir = os.path.join(dataset_path, "op_cache")
    geodesic_cache_dir = os.path.join(dataset_path, "geodesic_cache")
    model_save_path = os.path.join(
        dataset_path, "saved_models",
        f"categorical_correspondence_{args.input_features}_4x256")
    sw, stages = Stopwatch(), {}

    with sw("precompute"):
        test_dataset = FaustWithRobustTestDataset(
            dataset_path, train=False, k_eig=args.k_eig,
            op_cache_dir=op_cache_dir, n_train=args.n_train,
            n_test=args.n_test, device=device, timings=stages)
        if args.evaluate:
            # only the template is needed (verts_ref, faces_ref, n_class):
            # no precompute of the training set
            verts_ref, faces_ref = read_mesh(registration_path(dataset_path,
                                                               0))
            verts_ref = normalize_positions_np(verts_ref, method="bbox")
        else:
            train_dataset = FaustWithRobustTestDataset(
                dataset_path, train=True, k_eig=args.k_eig,
                op_cache_dir=op_cache_dir, n_train=args.n_train,
                n_test=args.n_test, device=device, timings=stages)
            verts_ref = train_dataset.verts_list[0]
            faces_ref = train_dataset.faces_list[0]
    # 6890 on FAUST (reference sampling_invariance.py:30 hardcodes it); from
    # the template, so that predictions always index its vertices
    n_class = verts_ref.shape[0]
    cfg = FitConfig(
        n_epoch=args.n_epoch, lr=1e-3, decay_every=50, decay_rate=0.5,
        batch_size=args.batch_size, input_features=args.input_features,
        augment_rotate=(args.input_features == "xyz"), rotate_axis="y",
        labels_kind="vertex", use_megakernel=args.megakernel, bf16=args.bf16,
        device_data=args.device_data, graceful_sigterm=True)
    model = build_model(n_class=n_class, c_width=256, outputs_at="vertices",
                        dropout=True, input_features=args.input_features,
                        bf16=args.bf16)
    result = {"model_save_path": model_save_path}

    if args.evaluate:
        if not args.load_model:
            raise ValueError("--evaluate requires --load_model")
        params = load_weights(args.load_model, model, device)
        eval_cfg = FitConfig(batch_size=cfg.batch_size,
                             input_features=cfg.input_features,
                             labels_kind="vertex")
        evaluate, _ = make_evaluate(model, eval_cfg, device)
    else:
        with sw("fit"):
            params, history, evaluate = fit(
                model, train_dataset, test_dataset, cfg,
                model_save_path=model_save_path,
                log_path=model_save_path + "_log.jsonl",
                resume_from=args.resume_from, device=device)
        result["history"] = history
    with sw("evaluate"):
        acc = evaluate(params, test_dataset)
        print(f"Overall test accuracy: {100 * acc:06.3f}%")
        mut_errors = per_mutation_geodesic_errors(
            model, params, test_dataset, cfg, verts_ref, faces_ref,
            geodesic_cache_dir, method=args.geodesic_method, device=device)
    return dict(result, test_acc=acc, seconds=sw.seconds,
                precompute_stages=stages,
                geodesic_means={m: float(np.mean(e))
                                for m, e in mut_errors.items()})


if __name__ == "__main__":
    main()
