"""The correspondence driver's pair batches on the CPU: its batched train
step against the plain reference (benchmark/reference/fmaps.py), a planted
fault that the comparison catches, P pairs in one step against P calls of
one pair, and the head's solve, which does not wait for the card.

Sizes: 3 shapes of 300-600 vertices on 2 distinct surfaces (the benchmark
loop's seeded Delaunay spheres and the port's precompute), K 24, C 16,
n_fmap 8, 2 blocks, seeded weights."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.experiments.functional_correspondence import \
    functional_correspondence as fc
from diffusionnet_tpu_torch.models import (FunctionalMapCorrespondence,
                                           compute_fmap, from_flat_jax_params,
                                           module_state)
from diffusionnet_tpu_torch.training import (adam_with_step_decay,
                                             make_train_step)
from tests.torch_threads import one_torch_thread  # noqa: F401

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import adam as ref_adam  # noqa: E402
from reference import diffusionnet as ref  # noqa: E402
from reference import fmaps as ref_fm  # noqa: E402

torch.set_float32_matmul_precision("highest")
SEED = 2 ** 31 + 77
CONF = {"model": {"input_features": "xyz", "c_in": 3, "c_width": 16,
                  "c_out": 16, "n_block": 2, "mlp_hidden_dims": [16, 16],
                  "k_eig": 24, "n_fmap": 8, "lambda": 1e-3,
                  "outputs_at": "vertices", "dropout": True,
                  "dtype": "float32"},
        "fit": {"lr": 5e-4, "batch_pairs": 2, "augment_rotate": True},
        "dataset": {"n_train": 3, "v_min": 300, "v_max": 600,
                    "distinct_surfaces": 2, "n_vts": 200}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_loop_train_pairs", BENCH / "loops" / "train_pairs.py")
    loop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop)
    loop.CACHE = tmp_path_factory.mktemp("ops")
    return loop.Data(CONF, SEED, torch.device("cpu"))


def _program(data, conf=CONF, lam=None):
    """The driver's model, feed and batched loss on the dataset."""
    m = conf["model"]

    class Shapes:
        verts_list = data.verts
        ops_list = [data.ops[j] for j in data.bundle_of]
        vts_list = data.vts
        combinations = data.pairs
    cpu = torch.device("cpu")
    model = FunctionalMapCorrespondence(
        c_in=3, c_out=m["c_out"], c_width=m["c_width"], n_block=m["n_block"],
        n_fmap=m["n_fmap"],
        lambda_param=m["lambda"] if lam is None else lam)
    feed = fc.PairFeed(
        fc.stack_shapes(Shapes, data.v_pad, data.d_l, data.d_g, m["k_eig"],
                        "xyz", cpu),
        fc.gt_fmap_table(Shapes, m["n_fmap"], cpu), data.pairs, cpu)
    return model, feed


def _reference_maps(data, p, pairs, seed, rotate=True, dropout=True):
    """The reference's maps and loss of one step's pairs."""
    m = CONF["model"]
    n = len(pairs)
    rows = [a for a, _ in pairs] + [b for _, b in pairs]
    u, keep = ref_fm.draws(seed, 2 * n, data.v_pad, m["n_block"],
                           [3 * m["c_width"], *m["mlp_hidden_dims"]], rotate,
                           "cpu")
    feats = []
    for r, i in enumerate(rows):
        o = data.ops[data.bundle_of[i]]
        V = o.mass.shape[0]
        xyz = torch.from_numpy(data.verts[i])
        if rotate:
            xyz = xyz @ ref_fm.rotation(u)[r]
        GX = ref_fm.sparse(torch.from_numpy(o.gradX.idx),
                           torch.from_numpy(o.gradX.val), V)
        GY = ref_fm.sparse(torch.from_numpy(o.gradY.idx),
                           torch.from_numpy(o.gradY.val), V)
        masks = ((lambda b, l, nr, w, r=r: keep[b, l][r, :nr]) if dropout
                 else None)
        feats.append(ref_fm.features(
            p, xyz, torch.from_numpy(o.mass), torch.from_numpy(o.evals),
            torch.from_numpy(o.evecs), GX, GY, m["n_block"], masks))
    maps, total = [], 0.0
    for j, (i1, i2) in enumerate(pairs):
        ox, oy = (data.ops[data.bundle_of[i]] for i in (i1, i2))
        C = ref_fm.fmap(feats[j], feats[n + j], torch.from_numpy(ox.evals),
                        torch.from_numpy(oy.evals), torch.from_numpy(ox.evecs),
                        torch.from_numpy(oy.evecs), torch.from_numpy(ox.mass),
                        torch.from_numpy(oy.mass), m["n_fmap"], m["lambda"])
        gt = ref_fm.gt_map(torch.from_numpy(ox.evecs),
                           torch.from_numpy(oy.evecs),
                           torch.from_numpy(data.vts[i1]),
                           torch.from_numpy(data.vts[i2]),
                           m["n_fmap"]).float()
        maps.append(C)
        total = total + torch.mean((C - gt) ** 2)
    return torch.stack(maps), total / n


def _step_gaps(data, fault=None):
    """The program's first batched step (maps, loss, every gradient)
    against the reference's, as relative gaps; `fault` plants one."""
    model, feed = _program(data, lam=0.0 if fault == "lambda" else None)
    order = feed.epoch(0)
    pairs = [data.pairs[int(k)] for k in order[:2]]
    seed = 1234567
    g = torch.Generator().manual_seed(seed)
    shapes, C_gt = feed.batch(order, 0, 2, g)
    if fault == "pairs":  # each pair's second shape from the other pair
        shapes = fc._tree_map(lambda a: a[[0, 1, 3, 2]], shapes)
    params = {k: v.clone().requires_grad_(True)
              for k, v in data.weights.items()}
    # the program's maps, from the masks' generator state after the
    # rotations (the step's forward draws the same masks)
    g_masks = torch.Generator()
    g_masks.set_state(g.get_state())
    with torch.no_grad():
        maps = torch.func.functional_call(
            model, module_state(params), (shapes,),
            {"deterministic": False, "generator": g_masks})[0]
    opt = adam_with_step_decay(5e-4)
    st = opt.init(params)
    _, _, loss, info = make_train_step(fc.pair_loss_fn(model), opt)(
        params, st, (shapes, C_gt), g)
    assert int((info != 0).sum()) == 0
    grads = {k: st.optimizer.state[params[k]]["exp_avg"] / 0.1
             for k in params}
    p0 = {k: v.clone() for k, v in data.weights.items()}
    with ref.matmul_precision("f32"):
        want_maps, _ = _reference_maps(data, p0, pairs, seed)
        losses, g0, _ = ref_adam.train(
            p0, [lambda p: _reference_maps(data, p, pairs, seed)[1]], 5e-4,
            0, 1.0)
    med = float(np.median([float(v.norm()) for v in g0.values()]))
    scale = {k: max(float(v.norm()), med) for k, v in g0.items()}
    return {"map": float((maps - want_maps).abs().max()
                         / want_maps.abs().max()),
            "loss": abs(float(loss) - losses[0]) / abs(losses[0]),
            "grad": max(float((grads[k] - g0[k]).norm()) / scale[k]
                        for k in g0)}


def test_batched_step_matches_the_reference(data):
    """Two pairs, rotations and dropout on. The port pads to 640 rows and
    sums the ELL rows, the projections and the solve's pivots in other
    orders than the reference's sparse products and row-by-row solves on
    the real vertices, all in f32; the readings here are about 5e-6. So
    the maps within 1e-4 of their largest entry, the loss within 1e-4
    relative, and every leaf's gradient within 1e-4 of the larger of its
    norm and the median leaf's (a leaf whose gradient is 0, as the first
    block's A_im with zero diffusion times, is held on that floor)."""
    gaps = _step_gaps(data)
    assert gaps["map"] < 1e-4, gaps
    assert gaps["loss"] < 1e-4, gaps
    assert gaps["grad"] < 1e-4, gaps


@pytest.mark.parametrize("fault", ["pairs", "lambda"])
def test_a_planted_fault_fails_the_comparison(data, fault):
    """Each pair's second shape taken from the other pair, or the
    regulariser dropped: the maps and the loss leave the tolerances of the
    test above by orders of magnitude."""
    gaps = _step_gaps(data, fault)
    assert gaps["map"] > 1e-2 and gaps["loss"] > 1e-3, gaps


def test_three_pairs_in_one_step_are_three_single_pair_calls(data):
    """P = 3 pairs in one extractor call give the maps and losses of three
    P = 1 batches and of the driver's per-pair forward (two extractor
    calls), deterministic and unrotated: the same products over other
    batch shapes, within f32 rounding."""
    model, feed = _program(data)
    model.load_state_dict(from_flat_jax_params(data.weights))
    order = feed.epoch(0)
    with torch.no_grad():
        shapes, C_gt = feed.batch(order, 0, 3)
        C3, _, _, info = model(shapes, return_info=True)
        assert C3.shape == (3, 8, 8) and info.shape == (3, 8)
        loss3 = fc.pair_loss(C3, C_gt)
        singles, losses = [], []
        for j in range(3):
            s1, g1 = feed.batch(order, j, 1)
            C1 = model(s1)[0]
            x = fc._tree_map(lambda a: a[0], s1)
            y = fc._tree_map(lambda a: a[1], s1)
            C_two = model(x, y)[0]
            torch.testing.assert_close(C1[0], C_two, rtol=1e-5, atol=1e-6)
            singles.append(C1[0])
            losses.append(fc.pair_loss(C1, g1))
    torch.testing.assert_close(C3, torch.stack(singles), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(loss3, torch.stack(losses).mean(), rtol=1e-5,
                               atol=0)


def test_the_solve_equals_linalg_solve_and_reports_singular_systems():
    """compute_fmap's Cholesky solve against torch.linalg.solve's LU on the
    same systems (condition numbers up to about 1e2 here: within 1e-5
    relative); a system made singular (zero features and lambda 0) sets
    info in its rows and raises nothing."""
    rs = np.random.RandomState(0)
    B, V, C, K = 2, 120, 16, 8
    fx, fy = (torch.from_numpy(rs.randn(B, V, C).astype(np.float32))
              for _ in range(2))
    ex, ey = (torch.from_numpy(np.sort(rs.rand(B, K) * 40, -1)
                               .astype(np.float32)) for _ in range(2))
    tx, ty = (torch.from_numpy((rs.randn(B, K, V) / np.sqrt(V))
                               .astype(np.float32)) for _ in range(2))
    C, info = compute_fmap(fx, fy, ex, ey, tx, ty)
    A, Bc = tx @ fx, ty @ fy
    D = (ey[..., :, None] - ex[..., None, :]) ** 2
    sys_ = ((A @ A.transpose(-1, -2))[..., None, :, :]
            + 1e-3 * torch.diag_embed(D))
    want = torch.linalg.solve(sys_, (Bc @ A.transpose(-1, -2))[..., None])
    torch.testing.assert_close(C, want[..., 0], rtol=1e-5, atol=1e-6)
    assert info.shape == (B, K) and int(info.abs().sum()) == 0
    C0, info0 = compute_fmap(torch.zeros_like(fx), fy, ex, ex, tx, ty,
                             lambda_param=0.0)
    assert bool((info0 != 0).all())
    assert not bool(torch.isfinite(C0).all())
