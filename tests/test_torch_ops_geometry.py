"""The port's utilities and device geometry ops against the JAX package's
on the CPU: rotations from the same uniforms, their law, the smoothed log
loss, position normalization, kNN, farthest-point sampling, vector math and
tangent frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusionnet_tpu.ops as jops
import diffusionnet_tpu.utils as jutils
import diffusionnet_tpu_torch.ops as tops
import diffusionnet_tpu_torch.utils as tutils
from tests.meshgen import icosphere, torus

torch.set_float32_matmul_precision("highest")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rotation_from_jax_uniforms_matches_jax():
    """The matrices of JAX's own uniforms (jax.random.uniform(key, (3,)),
    and the scalar angle of the Y rotation) equal the JAX package's to
    1e-6."""
    for seed in range(16):
        key = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(key, (3,), dtype=jnp.float32))
        want = np.asarray(jutils.random_rotation_matrix(key))
        np.testing.assert_allclose(tutils.rotation_from_uniforms(_t(u)),
                                   want, atol=1e-6)
        pts = np.random.RandomState(seed).randn(20, 3).astype(np.float32)
        a = np.asarray(jax.random.uniform(key, (), dtype=jnp.float32))
        want_y = np.asarray(jutils.random_rotate_points_y(jnp.asarray(pts),
                                                          key))
        got_y = _t(pts) @ tutils.rotation_y_from_uniform(_t(a))
        np.testing.assert_allclose(got_y, want_y, atol=1e-6)


def test_random_rotations_law():
    """4096 draws: orthonormal with det 1 (1e-5), R e_x averages to 0
    (within 0.05: uniform on SO(3)); the Y rotation keeps y; the batched
    draw and the single draw use the same formula."""
    g = torch.Generator().manual_seed(0)
    R = tutils.rotation_from_uniforms(torch.rand(4096, 3, generator=g))
    eye = torch.eye(3).expand(4096, 3, 3)
    assert torch.allclose(R @ R.transpose(1, 2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(R), torch.ones(4096), atol=1e-5)
    assert R[:, :, 0].mean(0).abs().max() < 0.05
    pts = torch.randn(50, 3, generator=g)
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    rotated = tutils.random_rotate_points(pts, g1)
    assert torch.equal(rotated, pts @ tutils.rotation_from_uniforms(
        torch.rand(3, generator=g2)))
    ry = tutils.random_rotate_points_y(pts, g1)
    assert torch.equal(ry[:, 1], pts[:, 1])
    assert torch.allclose(ry.norm(dim=1), pts.norm(dim=1), atol=1e-5)


def test_label_smoothing_log_loss_and_to_np():
    rs = np.random.RandomState(0)
    pred = np.log(rs.dirichlet(np.ones(5), size=(4, 7))).astype(np.float32)
    labels = rs.randint(0, 5, (4, 7))
    want = float(jutils.label_smoothing_log_loss(jnp.asarray(pred),
                                                 jnp.asarray(labels), 0.2))
    got = tutils.label_smoothing_log_loss(_t(pred), _t(labels), 0.2)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    np.testing.assert_array_equal(tutils.to_np(_t(pred)), pred)
    np.testing.assert_array_equal(tutils.to_np([1, 2]), [1, 2])


@pytest.mark.parametrize("method,scale", [("mean", "max_rad"),
                                          ("bbox", "max_rad"),
                                          ("mean", "area")])
def test_normalize_positions_match_jax(method, scale):
    """normalize_positions_np exactly equal to the JAX package's (both
    numpy); the device version within rtol 1e-5, batched for max_rad."""
    v, f = torus(10, 8)
    v = v * np.array([1.0, 2.0, 0.5]) + 3.0
    kw = dict(faces=f if scale == "area" else None, method=method,
              scale_method=scale)
    np.testing.assert_array_equal(tutils.normalize_positions_np(v, **kw),
                                  jutils.normalize_positions_np(v, **kw))
    v32 = v.astype(np.float32)
    pos = np.stack([v32, 2 * v32]) if scale == "max_rad" else v32
    tkw = dict(kw, faces=None if kw["faces"] is None else _t(f))
    want = jops.normalize_positions(jnp.asarray(pos), **kw)
    got = tops.normalize_positions(_t(pos), **tkw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def _cloud(n, seed):
    return np.random.RandomState(seed).rand(n, 3).astype(np.float32)


def _tie_free_clouds(omit_diagonal, largest, k):
    """The first seeded (source, target) clouds whose k + 1 nearest (or
    farthest) squared distances per row are apart by more than 2e-5 (f32
    rounding of either package is below 1e-6 there)."""
    for seed in range(200):
        src = _cloud(96, seed)
        tgt = src if omit_diagonal else _cloud(64, 1000 + seed)
        d2 = ((src[:, None].astype(np.float64) - tgt[None]) ** 2).sum(-1)
        if omit_diagonal:
            np.fill_diagonal(d2, -np.inf if largest else np.inf)
        d2 = np.sort(d2)
        d2 = d2[:, ::-1] if largest else d2
        if np.abs(np.diff(d2[:, :k + 1])).min() > 2e-5:
            return src, tgt
    raise AssertionError("no tie-free cloud in 200 seeds")


@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("omit_diagonal", [False, True])
def test_find_knn_matches_jax(largest, omit_diagonal):
    """Seeded tie-free clouds: indices equal to the JAX package's, distances
    within rtol 1e-5; several chunks."""
    k = 6
    src, tgt = _tie_free_clouds(omit_diagonal, largest, k)
    want_d, want_i = jops.find_knn(jnp.asarray(src), jnp.asarray(tgt), k,
                                   largest=largest,
                                   omit_diagonal=omit_diagonal,
                                   chunk_size=40)
    got_d, got_i = tops.find_knn(_t(src), _t(tgt), k, largest=largest,
                                 omit_diagonal=omit_diagonal, chunk_size=40)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5,
                               atol=1e-6)


def test_find_knn_refusals():
    x = _t(_cloud(10, 0))
    with pytest.raises(ValueError, match="same shape"):
        tops.find_knn(x, x[:5], 2, omit_diagonal=True)
    with pytest.raises(NotImplementedError, match="A.5"):
        tops.find_knn(x, x, 2, method="cpu_kd")


def test_farthest_point_sampling_matches_jax():
    pts = _cloud(400, 3)
    for n in (1, 17, 64):
        want = np.asarray(jops.farthest_point_sampling(jnp.asarray(pts), n))
        got = tops.farthest_point_sampling(_t(pts), n).numpy()
        assert got.sum() == n
        np.testing.assert_array_equal(got, want)
    dup = np.repeat(pts[:5], 3, axis=0)   # duplicates: never re-picked
    got = tops.farthest_point_sampling(_t(dup), 12).numpy()
    assert got.sum() == 12


def test_vector_ops_match_jax():
    rs = np.random.RandomState(4)
    a, b = rs.randn(2, 30, 3).astype(np.float32)
    v, f = icosphere(2)
    v = v.astype(np.float32)
    n = a / np.linalg.norm(a, axis=1, keepdims=True)
    pairs = [("norm", (a,)), ("norm2", (a,)), ("normalize", (a,)),
             ("dot", (a, b)), ("cross", (a, b)),
             ("project_to_tangent", (b, n)), ("face_coords", (v, f)),
             ("face_area", (v, f)), ("face_normals", (v, f))]
    for name, args in pairs:
        want = getattr(jops, name)(*map(jnp.asarray, args))
        got = getattr(tops, name)(*map(_t, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    with pytest.raises(ValueError):
        tops.normalize(_t(a[0]))


def test_frames_match_jax():
    """Mesh vertex normals (with a padded face masked out), tangent frames
    and edge tangent vectors within rtol 1e-5; cloud normals by plane fits
    equal up to the SVD's sign."""
    rs = np.random.RandomState(5)
    v, f = torus(12, 8)
    v = (v * (1 + 0.05 * rs.randn(*v.shape))).astype(np.float32)
    fp = np.concatenate([f, f[:1]])
    mask = np.ones(len(fp), np.float32)
    mask[-1] = 0.0
    got = tops.mesh_vertex_normals(_t(v), _t(fp), _t(mask))
    want = jops.mesh_vertex_normals(jnp.asarray(v), jnp.asarray(fp),
                                    jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    got_f = tops.build_tangent_frames(_t(v), _t(f))
    want_f = jops.build_tangent_frames(jnp.asarray(v), jnp.asarray(f))
    np.testing.assert_allclose(got_f, np.asarray(want_f), rtol=1e-5,
                               atol=1e-6)
    edges = np.concatenate([f[:, :2].T, f[:, 1:].T], axis=1)
    got_e = tops.edge_tangent_vectors(_t(v), got_f, _t(edges))
    want_e = jops.edge_tangent_vectors(jnp.asarray(v), want_f,
                                       jnp.asarray(edges))
    np.testing.assert_allclose(got_e, np.asarray(want_e), rtol=1e-5,
                               atol=1e-6)
    got_c = tops.vertex_normals(_t(v), None, n_neighbors_cloud=12).numpy()
    want_c = np.asarray(jops.vertex_normals(jnp.asarray(v), None,
                                            n_neighbors_cloud=12))
    sign = np.sign((got_c * want_c).sum(-1, keepdims=True))
    np.testing.assert_allclose(got_c * sign, want_c, rtol=1e-5, atol=1e-5)
