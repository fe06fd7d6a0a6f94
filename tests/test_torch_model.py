"""The port's eager DiffusionNet, HKS and weight bridge against the JAX
package (f32 on CPU, both at full matmul precision)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.models import DiffusionNet as JaxDiffusionNet
from diffusionnet_tpu.ops.spectral import compute_hks_autoscale as jax_hks
from diffusionnet_tpu.serving.export import _flatten_params, _unflatten_params
from diffusionnet_tpu_torch.geometry import compute_operators, pad_operators
from diffusionnet_tpu_torch.models import (DiffusionNet, from_flat_jax_params,
                                           to_flat_jax_params)
from diffusionnet_tpu_torch.ops.spectral import compute_hks_autoscale
from tests.meshgen import icosphere

torch.set_float32_matmul_precision("highest")

V_PAD, K = 256, 16


@pytest.fixture(scope="module")
def meshes():
    """Two padded meshes with one face list: a sphere and an ellipsoid."""
    verts, faces = icosphere(2)
    out = []
    for scale in ((1.0, 1.0, 1.0), (1.0, 0.7, 1.3)):
        v = verts * np.asarray(scale)
        ops = pad_operators(compute_operators(v, faces, k_eig=K,
                                              eigensolver="host"), V_PAD)
        x = np.pad(v.astype(np.float32), ((0, V_PAD - v.shape[0]), (0, 0)))
        out.append(dict(x=x, mass=ops.mass, evals=ops.evals, evecs=ops.evecs,
                        gX=ops.gradX_spec, gY=ops.gradY_spec))
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    edges = np.unique(np.sort(e, axis=1), axis=0)
    return out, faces, edges


def test_hks_matches_jax(meshes):
    m = meshes[0][0]
    want = np.asarray(jax_hks(jnp.asarray(m["evals"]), jnp.asarray(m["evecs"])))
    got = compute_hks_autoscale(torch.from_numpy(m["evals"]),
                                torch.from_numpy(m["evecs"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


CASES = [  # (outputs_at, batched, with_gradient_rotations)
    ("vertices", False, True),
    ("faces", False, True),
    ("global_mean", False, True),
    ("edges", False, True),
    ("vertices", True, True),
    ("faces", True, False),
    ("global_mean", True, False),
]


@pytest.mark.parametrize("outputs_at,batched,rotations", CASES)
def test_eager_model_matches_jax(meshes, outputs_at, batched, rotations):
    """Bridged weights (random diffusion times) give the JAX model's
    log-probabilities within rtol 1e-5 / atol 1e-6; rows past the mesh are
    padding (mass 0)."""
    ms, faces, edges = meshes
    ms = ms if batched else ms[:1]
    arr = {k: np.stack([m[k] for m in ms]) for k in ms[0]}
    if not batched:
        arr = {k: a[0] for k, a in arr.items()}
    inds = {"faces": faces, "edges": edges}.get(outputs_at)
    if inds is not None and batched:
        inds = np.stack([inds] * len(ms))

    jmodel = JaxDiffusionNet(c_in=3, c_out=5, c_width=8, n_block=2,
                             mlp_hidden_dims=(16, 8), dropout=False,
                             outputs_at=outputs_at,
                             with_gradient_rotations=rotations,
                             last_activation=jax.nn.log_softmax)
    kw = {outputs_at: jnp.asarray(inds)} if inds is not None else {}
    jargs = dict(evals=jnp.asarray(arr["evals"]), evecs=jnp.asarray(arr["evecs"]),
                 gradX=jnp.asarray(arr["gX"]), gradY=jnp.asarray(arr["gY"]), **kw)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(arr["x"]),
                         jnp.asarray(arr["mass"]), **jargs)
    flat = _flatten_params(jax.tree.map(np.asarray, params))
    rs = np.random.RandomState(1)
    for k in flat:
        if k.endswith("diffusion_time"):
            flat[k] = (rs.rand(*flat[k].shape) * 0.05).astype(np.float32)
    want = np.asarray(jmodel.apply(_unflatten_params(flat),
                                   jnp.asarray(arr["x"]),
                                   jnp.asarray(arr["mass"]), **jargs))

    tmodel = DiffusionNet(c_in=3, c_out=5, c_width=8, n_block=2,
                          mlp_hidden_dims=(16, 8), dropout=False,
                          outputs_at=outputs_at,
                          with_gradient_rotations=rotations,
                          last_activation=functools.partial(
                              torch.log_softmax, dim=-1))
    tmodel.load_state_dict(from_flat_jax_params(flat))
    t = {k: torch.from_numpy(a) for k, a in arr.items()}
    tkw = ({outputs_at: torch.from_numpy(inds)} if inds is not None else {})
    with torch.no_grad():
        got = tmodel(t["x"], t["mass"], evals=t["evals"], evecs=t["evecs"],
                     gradX=t["gX"], gradY=t["gY"], **tkw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_flat_params_round_trip_exact():
    model = JaxDiffusionNet(c_in=16, c_out=8, c_width=8, n_block=3,
                            mlp_hidden_dims=(8, 8), dropout=True)
    x = jnp.zeros((32, 16))
    z = jnp.zeros((32, 4))
    params = model.init(jax.random.PRNGKey(2), x, jnp.ones(32),
                        evals=jnp.zeros(4), evecs=z, gradX=z, gradY=z)
    flat = _flatten_params(jax.tree.map(np.asarray, params))
    port = DiffusionNet(c_in=16, c_out=8, c_width=8, n_block=3,
                        mlp_hidden_dims=(8, 8))
    port.load_state_dict(from_flat_jax_params(flat))
    back = to_flat_jax_params(port)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_init_follows_flax_dense_defaults():
    """lecun-normal kernels (truncated at 2 sigma, fan-in scaled), zero
    biases and diffusion times; one seed, one set of weights."""
    def make(seed):
        return DiffusionNet(c_in=16, c_out=8, c_width=128, n_block=1,
                            generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("weight"):
            fan_in = p.shape[1]
            sigma = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            assert p.abs().max() <= 2 * sigma
            assert abs(p.std().item() * fan_in ** 0.5 - 1.0) < 0.1, name
            assert not torch.equal(p, r)
        else:
            assert not p.any(), name


def _gather_mean_by_gather(x, inds):
    """The face (or edge) mean through torch.gather on clamped indices,
    whose autograd backward is the reference."""
    B, E, m = inds.shape
    i = inds.clamp(0, x.shape[1] - 1)
    return sum(torch.gather(x, -2, i[..., k, None].expand(B, E, x.shape[2]))
               for k in range(m)) / m


@pytest.mark.parametrize("m", [3, 2])
@pytest.mark.parametrize("max_degree", [32, 1])
@pytest.mark.parametrize("early_plan", [False, True])
def test_gather_mean_matches_gather(monkeypatch, m, max_degree, early_plan):
    """gather_mean's forward equals the gather form bit for bit, and its
    backward (the fixed-order segment sum, and with max_degree 1 the
    embedding fallback; its MeanPlan made by the caller or by the
    backward) equals gather's autograd backward to 1e-12 (f64), with -1
    padding rows and indices >= V among the entries."""
    from diffusionnet_tpu_torch.models import diffusion_net as dn
    monkeypatch.setattr(dn._GatherMean, "MAX_DEGREE", max_degree)
    g = torch.Generator().manual_seed(m)
    B, V, E, C = 3, 40, 70, 5
    x = torch.randn(B, V, C, dtype=torch.float64, generator=g,
                    requires_grad=True)
    inds = torch.randint(0, V, (B, E, m), generator=g)
    inds[0, -9:] = -1
    inds[2, :3, 1] = V + 2
    plan = dn.MeanPlan(inds, V) if early_plan else None
    out = dn.gather_mean(x, inds, plan)
    want = _gather_mean_by_gather(x, inds)
    assert torch.equal(out, want)
    dout = torch.randn(out.shape, dtype=torch.float64, generator=g)
    (got,), (ref,) = (torch.autograd.grad(o, x, dout) for o in (out, want))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-12)


def test_gather_mean_padding_faces_read_row_zero():
    """-1 padded faces give what faces clamped to 0 give: the forward bit
    for bit, the backward to f32 rounding (the padding entries are summed
    apart from vertex 0's own); each element reads its own rows."""
    from diffusionnet_tpu_torch.models.diffusion_net import gather_mean
    g = torch.Generator().manual_seed(7)
    B, V, F, C = 2, 30, 50, 4
    x = torch.randn(B, V, C, generator=g, requires_grad=True)
    faces = torch.randint(0, V, (B, F, 3), generator=g)
    faces[1, -12:] = -1
    clamped = faces.clamp(min=0)
    out, want = gather_mean(x, faces), gather_mean(x, clamped)
    assert torch.equal(out, want)
    np.testing.assert_array_equal(out[1, -12:].detach().numpy(),
                                  x[1, :1].expand(12, C).detach().numpy())
    dout = torch.randn(out.shape, generator=g)
    (got,), (ref,) = (torch.autograd.grad(o, x, dout) for o in (out, want))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("stacked", [True, False],
                         ids=["stacked-operator", "one-operator"])
def test_ell_matvec_backward_matches_gather(stacked):
    """ell_matvec's fixed-order backward (the embedding lookup's sort-based
    sum for x, a gather for val) equals the plain gather's autograd
    gradients to 1e-12 (f64), with rows of repeated columns and padding
    entries (val 0, column 0), and repeats its bits over f32 passes (the
    gather's own backward adds with atomics on the CPU's threads)."""
    from diffusionnet_tpu_torch.ops.sparse import (Ell, _gather_rows,
                                                   ell_matvec)
    g = torch.Generator().manual_seed(11)
    B, n, D, C = 3, 2000, 7, 6
    idx = torch.randint(0, n, (B, n, D), generator=g, dtype=torch.int32)
    idx[:, :50, :4] = 5
    idx[:, -30:, -3:] = 0
    val = torch.randn((B, n, D), dtype=torch.float64, generator=g)
    val[:, -30:, -3:] = 0
    if not stacked:
        idx, val = idx[0], val[0]
    x0 = torch.randn(B, n, C, dtype=torch.float64, generator=g)
    dy = torch.randn(B, n, C, dtype=torch.float64, generator=g)

    def grads(fn, dtype):
        x = x0.to(dtype).requires_grad_(True)
        v = val.to(dtype).requires_grad_(True)
        return torch.autograd.grad(fn(x, v), (x, v), dy.to(dtype))

    def by_gather(x, v):
        return torch.einsum("...nd,...ndc->...nc", v,
                            _gather_rows(idx.long(), x))
    got = grads(lambda x, v: ell_matvec(Ell(idx, v), x), torch.float64)
    want = grads(by_gather, torch.float64)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    first = grads(lambda x, v: ell_matvec(Ell(idx, v), x), torch.float32)
    for _ in range(3):
        again = grads(lambda x, v: ell_matvec(Ell(idx, v), x), torch.float32)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
