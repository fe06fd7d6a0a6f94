"""The rest of the model surface against the JAX package on the CPU (both at
full matmul precision, bridged weights with random diffusion times): the
fused route on kernel B4 (Pallas in interpret mode on the JAX side), ELL
gradient operators, implicit_dense diffusion on k_eig=0 operators,
compute_dtype=bf16, and remat_blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.models import DiffusionNet as JaxDiffusionNet
from diffusionnet_tpu.ops.sparse import Ell as JaxEll
from diffusionnet_tpu.serving.export import _flatten_params, _unflatten_params
from diffusionnet_tpu_torch.geometry import (compute_operators, pad_operators,
                                             stack_operators)
from diffusionnet_tpu_torch.models import DiffusionNet, module_state
from diffusionnet_tpu_torch.ops import fused
from diffusionnet_tpu_torch.ops.sparse import Ell
from tests.meshgen import icosphere, torus
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

V_PAD, K = 256, 16
ARCH = dict(c_in=3, c_out=5, c_width=8, n_block=2, mlp_hidden_dims=(16, 8),
            dropout=False)


@pytest.fixture(scope="module")
def meshes():
    """A sphere and an ellipsoid (one face list), padded to 256."""
    verts, faces = icosphere(2)
    out = []
    for scale in ((1.0, 1.0, 1.0), (1.0, 0.7, 1.3)):
        v = verts * np.asarray(scale)
        ops = pad_operators(compute_operators(v, faces, k_eig=K,
                                              eigensolver="host"), V_PAD)
        x = np.pad(v.astype(np.float32), ((0, V_PAD - v.shape[0]), (0, 0)))
        out.append((x, ops))
    return out


def _jax_ell(e):
    return JaxEll(jnp.asarray(e.idx), jnp.asarray(e.val))


def _torch_ell(e):
    return Ell(torch.from_numpy(np.asarray(e.idx)),
               torch.from_numpy(np.asarray(e.val)))


def _operands(x, ops, ell: bool, with_L: bool = False, spectral=True):
    """(x, mass, JAX kwargs, torch kwargs) of one numpy operator bundle."""
    jkw, tkw = {}, {}
    if spectral:
        for k in ("evals", "evecs"):
            a = getattr(ops, k)
            jkw[k], tkw[k] = jnp.asarray(a), torch.from_numpy(a)
    for name, field in (("gradX", "gradX"), ("gradY", "gradY"),
                        ("L", "L")):
        if name == "L" and not with_L:
            continue
        if ell or name == "L":
            e = getattr(ops, field)
            jkw[name], tkw[name] = _jax_ell(e), _torch_ell(e)
        else:
            a = getattr(ops, field + "_spec")
            jkw[name], tkw[name] = jnp.asarray(a), torch.from_numpy(a)
    return x, ops.mass, jkw, tkw


def _batched(meshes, batched, ell, **kw):
    if not batched:
        return _operands(*meshes[0], ell, **kw)
    ops = stack_operators([o for _, o in meshes])
    return _operands(np.stack([x for x, _ in meshes]), ops, ell, **kw)


def _jax_params(jmodel, x, mass, jkw, seed=1):
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(mass), **jkw)
    flat = _flatten_params(jax.tree.map(np.asarray, params))
    rs = np.random.RandomState(seed)
    for k in flat:
        if k.endswith("diffusion_time"):
            flat[k] = (rs.rand(*flat[k].shape) * 0.05).astype(np.float32)
    return flat


def _compare(jarch, tarch, x, mass, jkw, tkw, fwd_tol, grad_rtol,
             valid=None):
    """Forward and every parameter gradient of a loss sum(out * ct) over the
    valid rows; returns the port's output."""
    jmodel = JaxDiffusionNet(**jarch)
    flat = _jax_params(jmodel, x, mass, jkw)
    jx, jm = jnp.asarray(x), jnp.asarray(mass)
    want = np.asarray(jmodel.apply(_unflatten_params(flat), jx, jm, **jkw))
    ct = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    if valid is not None:
        ct = ct * valid[..., None]

    def jloss(p):
        return jnp.sum(jmodel.apply(_unflatten_params(p), jx, jm, **jkw) * ct)
    jgrad = jax.grad(jloss)({k: jnp.asarray(v) for k, v in flat.items()})

    tmodel = DiffusionNet(**tarch)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in flat.items()}
    out = torch.func.functional_call(
        tmodel, module_state(params),
        (torch.from_numpy(x), torch.from_numpy(mass)), tkw)
    (out * torch.from_numpy(ct)).sum().backward()
    got = out.detach().numpy()
    assert got.shape == want.shape
    rows = (slice(None) if valid is None else valid.astype(bool))
    np.testing.assert_allclose(got[rows], want[rows], **fwd_tol)
    for k in flat:
        w = np.asarray(jgrad[k])
        np.testing.assert_allclose(params[k].grad.numpy(), w, rtol=grad_rtol,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-3),
                                   err_msg=k)
    return out


@pytest.mark.parametrize("batched", [False, True])
def test_fused_route_matches_jax(meshes, batched, monkeypatch):
    """use_pallas_fused with V % pallas_tile_v == 0: the port's blocks run
    kernel B4 (its plain version on the CPU), the JAX blocks the Pallas op
    in interpret mode. Forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4
    (atol 1e-5 of the largest): f32 sums in other orders. A bucket that
    pallas_tile_v does not divide takes the dense route, as in the JAX
    package."""
    x, mass, jkw, tkw = _batched(meshes, batched, ell=False)
    calls = []
    real = fused._SpectralProject.apply
    monkeypatch.setattr(fused._SpectralProject, "apply",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for tile, n_fused in ((128, ARCH["n_block"]), (96, 0)):
        calls.clear()
        arch = dict(ARCH, use_pallas_fused=True, pallas_tile_v=tile)
        _compare(arch, arch, x, mass, jkw, tkw, dict(rtol=1e-5, atol=1e-6),
                 1e-4)
        assert len(calls) == n_fused


@pytest.mark.parametrize("flag,tile,ell,want", [
    (False, 128, False, {"block.dense": 2}),
    (True, 128, False, {"block.b4": 2}),
    (True, 96, False, {"block.dense": 2}),
    (False, 128, True, {"block.ell": 2})],
    ids=["dense", "b4", "b4-off-tile", "ell"])
def test_blocks_count_their_route(meshes, monkeypatch, flag, tile, ell,
                                  want):
    """A block with dense spectral gradients counts the route it took
    (training.profiling.count): on the CPU use_pallas_fused picks it,
    `block.b4` for B4 (its plain versions), `block.dense` for the dense
    route, also where pallas_tile_v does not divide V; an ELL-gradient
    block counts `block.ell`. Both dense-spectral routes give the same output
    (rtol 1e-5, atol 1e-6: f32 sums in other orders)."""
    from diffusionnet_tpu_torch.training import profiling
    x, mass, _, tkw = _batched(meshes, True, ell=ell)

    def run(use_fused):
        model = DiffusionNet(**ARCH, use_pallas_fused=use_fused,
                             pallas_tile_v=tile)
        with torch.no_grad():
            for blk in model.blocks:
                blk.diffusion.diffusion_time.fill_(0.02)
            return model(torch.from_numpy(x), torch.from_numpy(mass), **tkw)
    monkeypatch.setattr(profiling, "_REG", profiling.Registry())
    out = run(flag)
    got = {k: n for k, (n, _) in profiling.totals()["counters"].items()
           if k.startswith("block.")}
    assert got == want
    np.testing.assert_allclose(out.numpy(), run(False).numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("flag,cuda,tile,grad,want", [
    (False, False, 128, False, False),
    (True, False, 128, False, True),
    (False, True, 128, False, True),
    (False, True, 128, True, False),
    (True, True, 128, True, True),
    (True, True, 96, False, False),
    (False, True, 96, False, False)],
    ids=["cpu", "cpu-flag", "card", "card-op-grad", "card-flag-op-grad",
         "flag-off-tile", "card-off-tile"])
def test_takes_b4(flag, cuda, tile, grad, want):
    """The dense-spectral block's route: B4 only where V is a multiple of
    the tile; there where use_pallas_fused asks for it, or on a CUDA tensor
    whose operators require no grad (B4 gives them none, the dense route
    does). `is_cuda` is the tensor's own attribute, so the card's cases
    stand in an object that has the attributes the predicate reads."""
    from types import SimpleNamespace
    from diffusionnet_tpu_torch.models.diffusion_net import takes_b4
    x = SimpleNamespace(shape=(2, 256, 8), is_cuda=cuda)
    ops = [SimpleNamespace(requires_grad=False) for _ in range(4)]
    ops[2].requires_grad = grad
    assert takes_b4(x, ops, flag, tile) is want


def test_block_with_operator_grads_counts_dense(meshes, monkeypatch):
    """A dense-spectral block whose operators require grad takes the dense
    route on the CPU (`block.dense`), and the operators get their gradient
    from it, as from the JAX package's unfused model."""
    from diffusionnet_tpu_torch.training import profiling
    x, mass, _, tkw = _batched(meshes, True, ell=False)
    model = DiffusionNet(**ARCH, pallas_tile_v=128)
    ops = {k: v.clone().requires_grad_(True) for k, v in tkw.items()}
    monkeypatch.setattr(profiling, "_REG", profiling.Registry())
    out = model(torch.from_numpy(x), torch.from_numpy(mass), **ops)
    got = {k: n for k, (n, _) in profiling.totals()["counters"].items()
           if k.startswith("block.")}
    assert got == {"block.dense": ARCH["n_block"]}
    out.square().sum().backward()
    for k in ("evecs", "gradX", "gradY"):
        assert ops[k].grad is not None and ops[k].grad.abs().sum() > 0, k


@pytest.mark.parametrize("batched", [False, True])
def test_ell_gradient_route_matches_jax(meshes, batched):
    """gradX/gradY as ELL operators (the block tells them from the dense
    spectral ones by type): ell_matvec of the diffused signal."""
    x, mass, jkw, tkw = _batched(meshes, batched, ell=True)
    _compare(ARCH, ARCH, x, mass, jkw, tkw, dict(rtol=1e-5, atol=1e-6), 1e-4)


def test_implicit_dense_keig0_matches_jax():
    """k_eig=0 operators of icosphere(1) padded to 64: implicit_dense
    diffusion (a batched Cholesky of t L + diag(mass), identity rows on the
    padding) and ELL gradients. Forward rtol 1e-4 on the real rows (the JAX
    test checks only finiteness), gradients rtol 1e-4."""
    verts, faces = icosphere(subdivisions=1)
    ops = pad_operators(compute_operators(verts, faces, k_eig=0), 64)
    assert ops.evecs.shape == (64, 0)
    x = np.pad(verts.astype(np.float32), ((0, 64 - 42), (0, 0)))
    x, mass, jkw, tkw = _operands(x, ops, ell=True, with_L=True,
                                  spectral=False)
    arch = dict(ARCH, diffusion_method="implicit_dense")
    valid = (np.arange(64) < 42).astype(np.float32)
    out = _compare(arch, arch, x, mass, jkw, tkw, dict(rtol=1e-4, atol=1e-5),
                   1e-4, valid=valid)
    assert torch.isfinite(out).all()


def test_implicit_dense_batched_matches_jax():
    """The batched pair of tests/test_keig0_implicit.py (icosphere(1) and
    torus(8, 6), stacked and padded to 64; L arrives as a (B, V, D) ELL and
    is densified per batch element)."""
    v1, f1 = icosphere(subdivisions=1)
    v2, f2 = torus(n_major=8, n_minor=6)
    ops = stack_operators([compute_operators(v1, f1, k_eig=0),
                           compute_operators(v2, f2, k_eig=0)], v_pad=64)
    x = np.zeros((2, 64, 3), np.float32)
    x[0, :42] = v1
    x[1, :48] = v2
    x, mass, jkw, tkw = _operands(x, ops, ell=True, with_L=True,
                                  spectral=False)
    arch = dict(ARCH, n_block=1, c_out=2, diffusion_method="implicit_dense")
    valid = (mass > 0).astype(np.float32)
    _compare(arch, arch, x, mass, jkw, tkw, dict(rtol=1e-4, atol=1e-5),
             1e-4, valid=valid)


@pytest.mark.parametrize("route", ["spectral", "fused"])
def test_compute_dtype_bf16_forward_matches_jax(meshes, route):
    """compute_dtype=bf16: every Dense returns bf16 and the basis products
    take bf16 operands with f32 accumulation. The two frameworks round at
    other places, so the output is compared in relative L2 (2e-2)."""
    x, mass, jkw, tkw = _batched(meshes, True, ell=False)
    extra = (dict(use_pallas_fused=True, pallas_tile_v=128)
             if route == "fused" else {})
    jmodel = JaxDiffusionNet(**ARCH, **extra, compute_dtype=jnp.bfloat16)
    flat = _jax_params(jmodel, x, mass, jkw)
    want = np.asarray(jmodel.apply(_unflatten_params(flat), jnp.asarray(x),
                                   jnp.asarray(mass), **jkw), np.float32)
    tmodel = DiffusionNet(**ARCH, **extra, compute_dtype=torch.bfloat16)
    tmodel.load_state_dict({k: v for k, v in module_state(
        {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}).items()})
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(mass), **tkw)
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    got = got.float().numpy()
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("dropout", [False, True])
def test_remat_blocks_equals_plain(meshes, dropout):
    """remat_blocks recomputes each block in the backward. Dropout off: the
    loss and every gradient equal remat off exactly. Dropout on, the same
    generator seed: the recompute redraws the same masks, so again equal,
    and the generator ends where remat off leaves it (the next step's masks
    are not the previous step's)."""
    x, mass, _, tkw = _batched(meshes, True, ell=False)
    res = []
    for remat in (False, True):
        model = DiffusionNet(**dict(ARCH, dropout=dropout),
                             remat_blocks=remat,
                             generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            for blk in model.blocks:
                blk.diffusion.diffusion_time.fill_(0.02)
        gen = torch.Generator().manual_seed(11)
        out = model(torch.from_numpy(x), torch.from_numpy(mass), **tkw,
                    deterministic=False, generator=gen)
        loss = (out ** 2).sum()
        loss.backward()
        res.append((loss.detach(), {n: p.grad for n, p in
                                    model.named_parameters()},
                    gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = res
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert torch.equal(s0, s1)
