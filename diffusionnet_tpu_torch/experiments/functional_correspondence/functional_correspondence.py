"""Supervised functional-map correspondence on FAUST/SCAPE: the counterpart
of experiments/functional_correspondence/functional_correspondence.py, the
reference's configuration: a DiffusionNet feature extractor (C_out 128)
shared by both shapes of a pair and the parameter-free regularized fmap
solver (n_fmap 30, lambda 1e-3); the L2 loss between the predicted and the
ground-truth map; Adam at 5e-4 for 5 epochs. The evaluation reports the L2
loss and the mean geodesic error of the induced vertex map (kNN in the
spectrally aligned embedding, reference :181-204), normalized by
sqrt(area).

    python -m diffusionnet_tpu_torch.experiments.functional_correspondence.functional_correspondence \
        --train_dataset faust --test_dataset faust [--input_features hks] \
        [--device cuda] [--evaluate [--load_model PATH]] [--data_dir DIR]

The data is what experiments/functional_correspondence/prepare_data.py lays
out. --evaluate without --load_model takes the converted reference weights
pretrained_models/<test_dataset>_<input_features>.npz.

A run's randomness comes from one torch.Generator on the CPU (seed 0):
each training pair draws one seed from it for the pair's own generator on
the device, from which the two rotations (xyz features) and then the
dropout masks are drawn. Epoch e visits the pairs in numpy
RandomState(1000 + e) order, as the JAX driver does. A checkpoint holds the
full train state, the epoch, the pair position and the generator's state,
so --resume_from continues at the exact pair where a run stopped.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ...data.features import FEATURE_DIMS
from ...geometry import geodesic_label_errors
from ...models import flat_params, module_state
from ...models.fmaps import (FunctionalMapCorrespondence, shape_dict,
                             vertex_map)
from ...ops.sparse import Ell
from ...training import adam_with_step_decay, make_train_step
from ...training.checkpoint import (latest_checkpoint, load_train_state,
                                    restore_checkpoint, save_checkpoint,
                                    train_state)
from ...utils import random_rotate_points, round_up_to_multiple
from ..exp_common import (Stopwatch, add_device_arg, driver_device,
                          graceful_stop, load_weights, suite_dir)
from .faust_scape_dataset import FaustScapeDataset

SUITE = "functional_correspondence"


def _tree_map(fn, *shapes):
    """fn over the leaves of shape dicts (tensors, and the idx and val of
    each Ell)."""
    out = {}
    for k, v in shapes[0].items():
        if isinstance(v, Ell):
            out[k] = Ell(fn(*(s[k].idx for s in shapes)),
                         fn(*(s[k].val for s in shapes)))
        else:
            out[k] = fn(*(s[k] for s in shapes))
    return out


def make_shape_fn(ds, v_pad, d_l, d_g, k_eig, input_features, device,
                  device_data=False):
    """shape(i, generator=None): the model's input dict of shape i on
    `device` (ELL gradient operators, as the JAX driver feeds them), its
    xyz features rotated by a rotation drawn from `generator` when one is
    given. device_data: every padded shape uploaded once, stacked; a shape
    is then a gather on the device."""
    def host_shape(i):
        return shape_dict(ds.verts_list[i], ds.ops_list[i], v_pad, k_eig,
                          device, input_features, d_l=d_l, d_g=d_g,
                          spectral_grads=False)

    if device_data:
        stacked = _tree_map(lambda *xs: torch.stack(xs),
                            *[host_shape(i) for i in range(len(ds.verts_list))])

        def base(i):
            return _tree_map(lambda a: a[i], stacked)
    else:
        base = host_shape

    def shape(i, generator=None):
        s = base(i)
        if generator is not None:
            # xyz features are the positions
            s = dict(s, features=random_rotate_points(s["features"],
                                                      generator))
        return s
    return shape


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--train_dataset", type=str, default="faust")
    parser.add_argument("--test_dataset", type=str, default="faust")
    parser.add_argument("--input_features", type=str, default="hks")
    parser.add_argument("--load_model", type=str, default=None)
    parser.add_argument("--n_epoch", type=int, default=5)
    parser.add_argument("--k_eig", type=int, default=128)
    parser.add_argument("--n_fmap", type=int, default=30)
    parser.add_argument("--n_feat", type=int, default=128)
    parser.add_argument("--n_train", type=int, default=None,
                        help="train-shape count (default: reference 80/51)")
    parser.add_argument("--n_test", type=int, default=20)
    parser.add_argument("--data_dir", type=str, default=None,
                        help=f"dataset root (default: experiments/{SUITE}/"
                             "data)")
    parser.add_argument("--geodesic_method", type=str, default="exact",
                        help="'exact' (reference parity) | 'heat' (fast "
                             "approximate) | 'heat_device' (the full table "
                             "on --device) | 'steiner' | 'graph'")
    parser.add_argument("--device_data", action="store_true",
                        help="keep all padded shapes on the card and gather "
                             "pairs there (no per-step host copy)")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="checkpoint dir: continue a stopped run at the "
                             "exact training pair it stopped at")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = driver_device(args.device)

    k_eig, n_fmap, n_feat = args.k_eig, args.n_fmap, args.n_feat
    input_features = args.input_features
    augment = input_features == "xyz"
    base_path = suite_dir(SUITE)
    dataset_path = args.data_dir or os.path.join(base_path, "data")
    op_cache_dir = os.path.join(dataset_path, "op_cache")
    geodesic_cache_dir = os.path.join(dataset_path, "geodesic_cache")
    model_save_path = os.path.join(
        dataset_path, "saved_models", f"{args.train_dataset}_{input_features}")
    train = not args.evaluate
    sw, stages = Stopwatch(), {}

    def dataset(name, is_train):
        return FaustScapeDataset(dataset_path, name=name, train=is_train,
                                 k_eig=k_eig, n_fmap=n_fmap,
                                 op_cache_dir=op_cache_dir,
                                 n_train=args.n_train, n_test=args.n_test,
                                 device=device, timings=stages)

    with sw("precompute"):
        train_ds = dataset(args.train_dataset, True) if train else None
        test_ds = dataset(args.test_dataset, False)
    # static shapes over the union of the shapes used
    all_ds = [train_ds, test_ds] if train else [test_ds]
    v_pad = round_up_to_multiple(
        max(v.shape[0] for d in all_ds for v in d.verts_list), 128)
    d_l = max(o.L.max_degree for d in all_ds for o in d.ops_list)
    d_g = max(max(o.gradX.max_degree, o.gradY.max_degree)
              for d in all_ds for o in d.ops_list)

    model = FunctionalMapCorrespondence(
        c_in=FEATURE_DIMS[input_features], c_out=n_feat, c_width=n_feat,
        n_fmap=n_fmap, lambda_param=1e-3,
        generator=torch.Generator().manual_seed(0)).to(device)
    with sw("upload"):
        shape_of = {id(d): make_shape_fn(d, v_pad, d_l, d_g, k_eig,
                                         input_features, device,
                                         args.device_data)
                    for d in all_ds}

    if not args.load_model and args.evaluate:
        cand = os.path.join(base_path, "pretrained_models",
                            f"{args.test_dataset}_{input_features}.npz")
        if os.path.exists(cand):  # converted reference weights
            args.load_model = cand
    if args.evaluate and not args.load_model:
        raise ValueError("--evaluate requires --load_model")
    params = (load_weights(args.load_model, model, device)
              if args.load_model else flat_params(model, device))
    for p in params.values():
        p.requires_grad_(True)

    def predict(params, s1, s2, deterministic=True, generator=None):
        return torch.func.functional_call(
            model, module_state(params), (s1, s2),
            {"deterministic": deterministic, "generator": generator})[0]

    def test(params, with_geodesic_error=False):
        losses, geo_errs = [], []
        sf = shape_of[id(test_ds)]
        for idx in range(len(test_ds)):
            i1, i2, C_gt = test_ds[idx]
            with torch.no_grad():
                C_pred = predict(params, sf(i1), sf(i2)).cpu().numpy()
            losses.append(float(np.mean((C_pred - C_gt) ** 2)))
            if with_geodesic_error:
                # the vertex map by kNN in the aligned spectral embedding
                # (reference functional_correspondence.py:193-201)
                pred_2to1 = vertex_map(
                    test_ds.ops_list[i1].evecs[:, :n_fmap],
                    test_ds.ops_list[i2].evecs[:, :n_fmap], C_pred)
                vts1, vts2 = test_ds.vts_list[i1], test_ds.vts_list[i2]
                errors = geodesic_label_errors(
                    test_ds.verts_list[i1], test_ds.faces_list[i1],
                    pred_2to1[vts2], vts1, normalization="area",
                    geodesic_cache_dir=geodesic_cache_dir,
                    method=args.geodesic_method, device=device)
                geo_errs.append(float(np.mean(errors)))
        return (float(np.mean(losses)),
                float(np.mean(geo_errs)) if with_geodesic_error else -1.0)

    result = {"model_save_path": model_save_path, "seconds": sw.seconds,
              "precompute_stages": stages, "log": []}
    if train:
        print("Training...")
        optimizer = adam_with_step_decay(5e-4)
        opt_state = optimizer.init(params)
        rng = torch.Generator().manual_seed(0)

        def loss_fn(params, pair, generator):
            s1, s2, C_gt = pair
            C_pred = predict(params, s1, s2, deterministic=False,
                             generator=generator)
            return torch.mean((C_pred - C_gt) ** 2), None

        train_step = make_train_step(loss_fn, optimizer)
        sf = shape_of[id(train_ds)]
        # one directory per config: faust and scape share parameter
        # shapes, and a shared one would resume the other's weights
        ckpt_dir = model_save_path + "_ckpt"
        log_path = model_save_path + "_log.jsonl"
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        # the pair order of an epoch is seeded by the epoch, so (epoch,
        # pair_pos) and the generator's state pin the exact resume point
        start_epoch, start_pos = 0, 0
        if args.resume_from is not None:
            path = latest_checkpoint(args.resume_from)
            if path is None:
                raise FileNotFoundError(
                    f"no checkpoint under {args.resume_from}")
            template = dict(train_state(params, opt_state, 0, rng, False),
                            pair_pos=np.zeros((), np.int32))
            st = restore_checkpoint(path, template)
            start_epoch = load_train_state(st, params, opt_state, rng)
            start_pos = int(st["pair_pos"])
            print(f"resumed from {path}: epoch {start_epoch}, "
                  f"pair {start_pos}")

        def save_state(epoch, pair_pos, step):
            save_checkpoint(ckpt_dir,
                            dict(train_state(params, opt_state, epoch, rng,
                                             False),
                                 pair_pos=np.asarray(pair_pos, np.int32)),
                            step=step)

        # a stop (SIGTERM/SIGINT) is taken at a PAIR boundary: an epoch of
        # real data is thousands of pairs, longer than an eviction's grace
        with graceful_stop() as stop_requested, sw("train"):
            for epoch in range(start_epoch, args.n_epoch):
                epoch_t0 = time.time()
                losses = []
                order = np.random.RandomState(1000 + epoch).permutation(
                    len(train_ds))
                pos0 = start_pos if epoch == start_epoch else 0
                for pos in range(pos0, len(order)):
                    i1, i2, C_gt = train_ds[int(order[pos])]
                    seed = int(torch.randint(0, 2 ** 62, (), generator=rng))
                    g = torch.Generator(device=device).manual_seed(seed)
                    pair = (sf(i1, g if augment else None),
                            sf(i2, g if augment else None),
                            torch.from_numpy(C_gt).to(device))
                    _, _, loss, _ = train_step(params, opt_state, pair, g)
                    losses.append(float(loss))
                    if stop_requested:
                        save_state(epoch, pos + 1, step=epoch)
                        print(f"preemption checkpoint: epoch {epoch}, "
                              f"pair {pos + 1}; resume with --resume_from")
                        return dict(result, stopped=(epoch, pos + 1),
                                    params=params)
                test_loss, test_geo = test(params, with_geodesic_error=True)
                # a resume that landed on an epoch boundary replays the
                # epoch with no pairs: its loss is None, not NaN
                train_loss = float(np.mean(losses)) if losses else None
                tl = f"{train_loss:.5e}" if train_loss is not None else "--"
                print(f"Epoch {epoch} - Train: {tl}  Test: {test_loss:.5e}"
                      f"  Test geodesic error: {test_geo:.5e}")
                line = {"epoch": epoch, "train_loss": train_loss,
                        "test_loss": test_loss,
                        "test_geodesic_error": test_geo,
                        "epoch_seconds": round(time.time() - epoch_t0, 3)}
                result["log"].append(line)
                with open(log_path, "a") as f:
                    f.write(json.dumps(line) + "\n")
                save_state(epoch + 1, 0, step=epoch)

    with sw("evaluate"):
        mean_loss, mean_geo = test(params, with_geodesic_error=True)
    print(f"Overall test loss: {mean_loss:.5e}  geodesic error: "
          f"{mean_geo:.5e}")
    return dict(result, test_loss=mean_loss, geodesic_error=mean_geo,
                params=params)


if __name__ == "__main__":
    main()
