"""Inputs and traffic are a function of the seed alone, and the frozen
counts give hand-worked values."""

import numpy as np
import pytest
import torch

from dnbench import counts, inputs


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(a, b)


@pytest.mark.parametrize("workload", ["hseg_train", "siv_train"])
def test_training_data_is_the_seeds(tiny, workload):
    from dnbench import spec
    cell = tiny(workload)
    loop = spec.loop_module(cell)
    cpu = torch.device("cpu")
    a, b = (loop.Data(cell.config, 2 ** 31 + 5, cpu) for _ in range(2))
    c = loop.Data(cell.config, 2 ** 31 + 6, cpu)
    assert a.V == b.V and a.bundle_of == b.bundle_of
    for x, y in zip(a.bundles, b.bundles):
        assert all(_same(x[k], y[k]) for k in x)
    for field in ("verts", "faces", "labels"):
        assert all(_same(x, y) for x, y in zip(getattr(a, field),
                                                getattr(b, field)))
    assert all(_same(a.weights[k], b.weights[k]) for k in a.weights)
    assert not all(_same(x, y) for x, y in zip(a.verts, c.verts))
    # the epoch order is fit's: one RandomState(seed + epoch)
    grps = loop.groups(a.V, cell.config["fit"]["buckets"])
    B = cell.config["fit"]["batch_size"]
    first = loop.epoch_batches(grps, B, 7)
    assert first == loop.epoch_batches(grps, B, 7)
    assert sorted(i for _, rows in first for i in rows) == list(
        range(len(a.V)))


def test_serving_traffic_is_the_seeds(tiny):
    from dnbench import spec
    cell = tiny("hseg_serve")
    loop = spec.loop_module(cell)
    cpu = torch.device("cpu")
    pools = [loop.Pool(cell.config, cell.traffic, s, cpu) for s in (3, 3, 4)]
    reqs = [loop.Requests(cell.traffic, p, s, 16)
            for p, s in zip(pools, (3, 3, 4))]
    # every seed sends the same sizes, in its own order
    assert pools[0].V == pools[1].V == pools[2].V
    assert all(v >= 300 and v <= 900 for v in pools[0].V)
    assert torch.equal(pools[0].ops[1]["evecs"], pools[1].ops[1]["evecs"])
    assert not torch.equal(pools[0].ops[1]["evecs"], pools[2].ops[1]["evecs"])
    assert np.array_equal(reqs[0].mesh, reqs[1].mesh)
    assert not np.array_equal(reqs[0].mesh, reqs[2].mesh)
    assert np.array_equal(reqs[0].x(17), reqs[1].x(17))
    assert not np.array_equal(reqs[0].x(17), reqs[2].x(17))
    for r in reqs:
        # each run of len(pool) requests visits every mesh once
        assert (np.sort(r.mesh[:300].reshape(100, 3), axis=1)
                == np.arange(3)).all()
    kept = [r for r in range(40) if reqs[0].keep(r)]
    assert kept == [r for r in range(40) if reqs[1].keep(r)]
    assert reqs[0].first_largest in kept or reqs[0].first_largest >= 40


def test_bundle_is_mass_orthonormal():
    b = inputs.bundle(500, 16, 9, torch.device("cpu"))
    gram = b["evecs"].T @ (b["mass"][:, None] * b["evecs"])
    assert torch.allclose(gram, torch.eye(16), atol=1e-4)
    assert b["evals"][0] == 0 and bool((b["evals"].diff() > 0).all())
    assert abs(float(b["mass"].sum()) - 1.0) < 1e-5


def test_grid_faces_are_about_two_per_vertex():
    f = inputs.grid_faces(20000, 4)
    assert f.min() >= 0 and f.max() < 20000
    assert 1.9 * 20000 < len(f) < 2.0 * 20000
    assert len(set(f.ravel().tolist())) > 0.99 * 20000


def test_counts_match_hand_worked_values():
    # megablock forward, B=1, V=1, K=1, C=1, widths [3, 1, 1]: products
    # 6KC + 8C^2 + 2(3 + 1) = 22, + 2KC = 24 with emit_next; bytes
    # 2C*4 + 3K*4 + 4 = 24 -> bytes bound 24 / 3.35e12
    assert counts.megablock_bound_s(1, 1, 1, 1, [3, 1, 1], True, False) \
        == pytest.approx(24 / 3.35e12)
    # at B=4, V=1024, K=C=128, widths [384, 128, 128, 128] the backward
    # is bound by its products: fwd = 98304 + 131072 + 131072 (mlp
    # 98304 + 32768 * 2) ... per vertex
    mlp = [2 * 384 * 128, 2 * 128 * 128, 2 * 128 * 128]
    fwd = 6 * 128 * 128 + 8 * 128 * 128 + sum(mlp)
    bwd = fwd - mlp[-1] + 2 * sum(mlp) + 16 * 128 * 128 + 6 * 128 * 128
    assert counts.megablock_bound_s(4, 1024, 128, 128, [384, 128, 128, 128],
                                    False, True) \
        == pytest.approx(4 * 1024 * bwd / 495e12)
    # B4 at B=1, V=131072, K=C=128: 8 V K C = 1.718e10 operations
    # (34.7 us) against (V (512 + 516) + 65536 + V (1536 + 1536)
    # + 131072) bytes = 5.376e8 (160.5 us): bytes bound
    n_bytes = 131072 * (512 + 512 + 4) + 65536 + 131072 * 3072 + 131072
    assert counts.fused_bound_s(1, 131072, 128, 128) \
        == pytest.approx(n_bytes / 3.35e12)
    # one vertex of the segmentation model: HKS 4096, first_lin 4096,
    # 4 blocks of 131072 + 131072 + 163840, last_lin 2048
    assert counts.model_flops(1, 128, 16, 128, [128, 128], 8, 4, True) \
        == 4096 + 4096 + 4 * 425984 + 2048
