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

A step trains --batch_pairs P pairs (default 1, the reference's one pair a
step). Every padded training shape and the ground-truth map of every
training pair are uploaded once (`stack_shapes`, `gt_fmap_table`), a step's
pairs are gathered on the device (`PairFeed`), and both shapes of all P
pairs run through one call of the feature extractor. The loss is the mean
over the P pairs of each pair's mean squared map error (`pair_loss`).

A run's randomness comes from one torch.Generator on the CPU (seed 0):
each step draws one seed from it for the step's own generator on the
device, from which the 2P rotations (xyz features) and then the dropout
masks are drawn. Epoch e visits the pairs in numpy RandomState(1000 + e)
order, as the JAX driver does. A checkpoint holds the full train state,
the epoch, the pair position and the generator's state, so --resume_from
continues at the exact pair where a run stopped.
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
from ...training.profiling import span
from ...utils import rotation_from_uniforms, round_up_to_multiple
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
    """shape(i): the model's input dict of shape i on `device` (ELL
    gradient operators, as the JAX driver feeds them), for evaluation.
    device_data: every padded shape uploaded once, stacked; a shape is then
    a gather on the device."""
    if device_data:
        stacked = stack_shapes(ds, v_pad, d_l, d_g, k_eig, input_features,
                               device)
        return lambda i: _tree_map(lambda a: a[i], stacked)
    return lambda i: shape_dict(ds.verts_list[i], ds.ops_list[i], v_pad,
                                k_eig, device, input_features, d_l=d_l,
                                d_g=d_g, spectral_grads=False)


def stack_shapes(ds, v_pad, d_l, d_g, k_eig, input_features, device):
    """Every shape of ds padded (to v_pad rows, ELL degrees d_l and d_g),
    uploaded once and stacked: the model's input dict with a leading axis
    of len(ds.verts_list) shapes (ELL gradient operators)."""
    return _tree_map(lambda *xs: torch.stack(xs), *[
        shape_dict(v, ops, v_pad, k_eig, device, input_features, d_l=d_l,
                   d_g=d_g, spectral_grads=False)
        for v, ops in zip(ds.verts_list, ds.ops_list)])


def gt_fmap_table(ds, n_fmap: int, device) -> torch.Tensor:
    """(N, N, n_fmap, n_fmap) float32 on `device`: the ground-truth map
    (`models.fmaps.gt_fmap`, float64 least squares) of every ordered pair
    of ds's N shapes, [i1, i2] the pair (i1, i2). One solve a first shape,
    on `device`, the samples of every second shape its right-hand sides;
    every shape has as many samples (vts_list)."""
    E = [torch.as_tensor(ops.evecs[:, :n_fmap][vts], dtype=torch.float64,
                         device=device)
         for ops, vts in zip(ds.ops_list, ds.vts_list)]
    N, k = len(E), n_fmap
    rhs = torch.cat(E, 1)                                # (S, N k)
    rows = [torch.linalg.lstsq(e, rhs).solution.view(k, N, k)
            for e in E]                                  # [i1] (k, N, k)
    return torch.stack(rows).permute(0, 2, 3, 1).float().contiguous()


def pair_order(n_pairs: int, epoch: int) -> np.ndarray:
    """The pairs' order in epoch `epoch` (the JAX driver's)."""
    return np.random.RandomState(1000 + epoch).permutation(n_pairs)


def rotate_shapes(shapes: dict, generator) -> dict:
    """shapes (B, V, 3) xyz features, each right-multiplied by its own
    uniform random rotation, from one draw of (B, 3) uniforms."""
    x = shapes["features"]
    u = torch.rand((x.shape[0], 3), generator=generator,
                   device=generator.device)
    R = rotation_from_uniforms(u).to(x.device, x.dtype)
    return dict(shapes, features=x @ R)


class PairFeed:
    """A step's pairs, gathered on the card: `stacked` (stack_shapes),
    `table` (gt_fmap_table), and the ordered pairs (i1, i2) of `pairs`.

    batch(epoch_order, start, n, generator) -> (shapes, C_gt): the pairs
    at positions [start, start + n) of the epoch's order (a device tensor
    of `epoch`), shapes the model's input dict of the n first shapes, then
    the n second ones (2n, ...), rotated with `generator` where one is
    given; C_gt (n, K, K). One span dnt.batch; nothing waits for the
    card."""

    def __init__(self, stacked: dict, table: torch.Tensor, pairs, device):
        self.stacked, self.table, self.device = stacked, table, device
        self.pairs = torch.as_tensor(np.asarray(pairs, np.int64),
                                     device=device)

    def epoch(self, epoch: int) -> torch.Tensor:
        order = torch.from_numpy(pair_order(len(self.pairs), epoch))
        if self.device.type == "cuda":
            order = order.pin_memory()
        return order.to(self.device, non_blocking=True)

    def batch(self, epoch_order, start: int, n: int, generator=None):
        with span("dnt.batch"):
            pair = self.pairs[epoch_order[start:start + n]]     # (n, 2)
            rows = pair.t().reshape(-1)                         # (2n,)
            shapes = _tree_map(lambda a: a[rows], self.stacked)
            if generator is not None:
                shapes = rotate_shapes(shapes, generator)
            return shapes, self.table[pair[:, 0], pair[:, 1]]


def pair_loss(C_pred: torch.Tensor, C_gt: torch.Tensor) -> torch.Tensor:
    """The mean over the pairs (leading axes) of each pair's mean squared
    map error."""
    return torch.mean((C_pred - C_gt) ** 2)


def pair_loss_fn(model):
    """loss_fn(params, (shapes, C_gt), generator) -> (loss, info) over a
    PairFeed batch, one extractor call for its 2P shapes, for
    `make_train_step`. info: the head's solve info (P, K) on the device
    (non-zero where a system was singular)."""
    def loss_fn(params, batch, generator):
        shapes, C_gt = batch
        C_pred, _, _, info = torch.func.functional_call(
            model, module_state(params), (shapes,),
            {"deterministic": False, "generator": generator,
             "return_info": True})
        return pair_loss(C_pred, C_gt), info
    return loss_fn


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
                        help="keep all padded test shapes on the card too "
                             "(training always gathers its pairs there)")
    parser.add_argument("--batch_pairs", type=int, default=1,
                        help="training pairs a step, their 2P shapes run "
                             "through one extractor call")
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
    P = args.batch_pairs
    if P < 1:
        raise ValueError("--batch_pairs must be at least 1")
    with sw("upload"):
        test_shape = make_shape_fn(test_ds, v_pad, d_l, d_g, k_eig,
                                   input_features, device, args.device_data)
        if train:
            feed = PairFeed(
                stack_shapes(train_ds, v_pad, d_l, d_g, k_eig,
                             input_features, device),
                gt_fmap_table(train_ds, n_fmap, device),
                train_ds.combinations, device)

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
        sf = test_shape
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
        train_step = make_train_step(pair_loss_fn(model), optimizer)
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
                order = feed.epoch(epoch)
                pos0 = start_pos if epoch == start_epoch else 0
                for pos in range(pos0, len(order), P):
                    seed = int(torch.randint(0, 2 ** 62, (), generator=rng))
                    g = torch.Generator(device=device).manual_seed(seed)
                    batch = feed.batch(order, pos, P, g if augment else None)
                    _, _, loss, _ = train_step(params, opt_state, batch, g)
                    losses.append(float(loss))
                    end = min(pos + P, len(order))
                    if stop_requested:
                        save_state(epoch, end, step=epoch)
                        print(f"preemption checkpoint: epoch {epoch}, "
                              f"pair {end}; resume with --resume_from")
                        return dict(result, stopped=(epoch, end),
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
