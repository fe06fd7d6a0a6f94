"""The port's fused spectral block (kernel B4, ops/fused.py) against the JAX
package's Pallas op in interpret mode, on the CPU (both at full matmul
precision): forward, the autograd Function's VJP, the vertex-sharded
block's autograd pieces on in-process shards, bf16 x, the tile check;
the projection's split-V plain version (the order the card sums in) and
the layout in which spectral_apply stages s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.ops.pallas_fused import (
    _bwd_b, fused_spectral_block as jax_fused,
    fused_spectral_block_batched as jax_fused_batched)
from diffusionnet_tpu_torch.ops import fused, megablock as mb
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


def _inputs(seed, B=None, V=1024, K=32, C=16):
    """numpy inputs, with a leading batch dim B unless B is None."""
    rs = np.random.RandomState(seed)
    lead = () if B is None else (B,)

    def r(*shape, scale=1.0):
        return (rs.randn(*lead, *shape) * scale).astype(np.float32)
    return (r(V, C), r(V, K, scale=V ** -0.5), r(V, K, scale=V ** -0.5),
            r(V, K, scale=V ** -0.5), rs.rand(*lead, V).astype(np.float32),
            rs.rand(*lead, K, C).astype(np.float32))


@pytest.mark.parametrize("batched", [False, True], ids=["B4a", "B4b"])
def test_fused_forward_matches_pallas(batched):
    """(y, ygx, ygy) within rtol 1e-4 / atol 1e-5, the JAX test's own bound:
    f32 sums of the same products in another order. No launch on the CPU."""
    args = _inputs(0, B=3 if batched else None)
    jfn, tfn = ((jax_fused_batched, fused.fused_spectral_block_batched)
                if batched else (jax_fused, fused.fused_spectral_block))
    want = jfn(*map(jnp.asarray, args), 256, True)
    fused.reset_launches()
    got = tfn(*map(torch.from_numpy, args), 256)
    assert fused.LAUNCHES == {"spectral_project": 0, "spectral_apply": 0,
                              "spectral_ds": 0}
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("batched", [False, True], ids=["B4a", "B4b"])
def test_fused_vjp_matches_jax_grad(batched):
    """dx and dcoefs of the autograd Function against jax.grad of the Pallas
    op (its custom VJP), rtol and atol 1e-4, for a loss that weights the
    three outputs differently."""
    x, evecs, gX, gY, mass, coefs = _inputs(1, B=2 if batched else None,
                                            V=512, K=16, C=8)
    jfn, tfn = ((jax_fused_batched, fused.fused_spectral_block_batched)
                if batched else (jax_fused, fused.fused_spectral_block))
    ops = [jnp.asarray(a) for a in (evecs, gX, gY, mass)]

    def jloss(x, coefs):
        y, a, b = jfn(x, *ops, coefs, 256, True)
        return jnp.sum(y ** 2) + jnp.sum(a ** 2) + 2 * jnp.sum(b ** 3)
    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(coefs))

    tx = torch.from_numpy(x).requires_grad_(True)
    tc = torch.from_numpy(coefs).requires_grad_(True)
    y, a, b = tfn(tx, *map(torch.from_numpy, (evecs, gX, gY, mass)), tc, 256)
    ((y ** 2).sum() + (a ** 2).sum() + 2 * (b ** 3).sum()).backward()
    for g, w in zip((tx.grad, tc.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_sharded_pieces_match_jax_grad():
    """The vertex-sharded block's two autograd pieces on 4 shards of a
    batch of 2 surfaces (V = 512, 128 rows a shard, every row real), in
    one process: each shard's `_SpectralProject`, their sum (its transpose
    hands every shard the whole cotangent, as VertexGroup.sum's does), each
    shard's `_SpectralApply`. The outputs assembled from the shards and dx
    and dcoefs (summed over the shards' applies, each from its own ds_r)
    against the whole surface's Pallas op and its jax.grad: rtol 1e-4,
    atol 1e-5 of the largest entry (forward) and 1e-4 (gradients). A
    dcoefs from the summed ds would be 4 times too large."""
    x, evecs, gX, gY, mass, coefs = _inputs(2, B=2, V=512, K=16, C=8)
    ops = [jnp.asarray(a) for a in (evecs, gX, gY, mass)]

    def jloss(x, coefs):
        y, a, b = jax_fused_batched(x, *ops, coefs, 128, True)
        return jnp.sum(y ** 2) + jnp.sum(a ** 2) + 2 * jnp.sum(b ** 3)
    want_out = jax_fused_batched(jnp.asarray(x), *ops, jnp.asarray(coefs),
                                 128, True)
    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(coefs))

    tx = torch.from_numpy(x).requires_grad_(True)
    tc = torch.from_numpy(coefs).requires_grad_(True)
    t_ops = [torch.from_numpy(a) for a in (evecs, gX, gY, mass)]
    rows = [slice(128 * r, 128 * (r + 1)) for r in range(4)]
    x_hat = sum(fused._SpectralProject.apply(tx[:, s], t_ops[0][:, s],
                                          t_ops[3][:, s]) for s in rows)
    outs = [fused._SpectralApply.apply(x_hat, tc, *(o[:, s] for o in t_ops[:3]),
                                    tx.dtype) for s in rows]
    got = [torch.cat(o, dim=1) for o in zip(*outs)]
    for g, w in zip(got, want_out):
        _scaled_close(g.detach().numpy(), np.asarray(w), 1e-4, 1e-5)
    y, a, b = got
    ((y ** 2).sum() + (a ** 2).sum() + 2 * (b ** 3).sum()).backward()
    for g, w in zip((tx.grad, tc.grad), want):
        _scaled_close(g.numpy(), np.asarray(w), 1e-4, 1e-4)


def test_fused_bf16_x_with_f32_operators():
    """compute_dtype=bf16 hands B4 a bf16 x beside f32 operators: the
    outputs are bf16 and agree with the Pallas op (same inputs) within 2e-2
    relative L2; the two frameworks round at other places."""
    x, evecs, gX, gY, mass, coefs = _inputs(2, B=2, V=512, K=16, C=8)
    want = jax_fused_batched(jnp.asarray(x, jnp.bfloat16),
                             *map(jnp.asarray, (evecs, gX, gY, mass, coefs)),
                             256, True)
    got = fused.fused_spectral_block_batched(
        torch.from_numpy(x).to(torch.bfloat16),
        *map(torch.from_numpy, (evecs, gX, gY, mass, coefs)), 256)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)


def test_fused_refuses_ragged_tile():
    """V % tile_v != 0 raises the JAX op's ValueError in both forms."""
    args = [torch.from_numpy(a) for a in _inputs(3, B=1, V=300, K=8, C=4)]
    for fn, a in ((fused.fused_spectral_block_batched, args),
                  (fused.fused_spectral_block, [t[0] for t in args])):
        with pytest.raises(ValueError, match="multiple of tile_v=128"):
            fn(*a, 128)


def test_project_and_apply_plain_pieces():
    """The kernels' plain versions compose to the whole function, and the
    projection's lowp mode rounds both operands to bf16 (B3 on bf16
    operators)."""
    x, evecs, gX, gY, mass, coefs = map(torch.from_numpy,
                                        _inputs(4, B=2, V=256, K=8, C=8))
    x_hat = fused.spectral_project(x, evecs, mass)
    outs = fused.spectral_apply(x_hat, coefs, evecs, gX, gY, torch.float32)
    for a, b in zip(outs, fused.fused_spectral_block_reference(
            x, evecs, gX, gY, mass, coefs)):
        assert torch.equal(a, b)
    lowp = fused.spectral_project(x, evecs.to(torch.bfloat16), mass, True)
    r = (lambda t: t.to(torch.bfloat16).double())
    want = r(evecs).transpose(1, 2) @ r(x * mass[..., None])
    torch.testing.assert_close(lowp.double(), want, rtol=1e-5, atol=1e-6)
    # the CPU wrapper takes one range of V: one product a batch element
    assert fused.project_splits(2, 256, 8, 8, x.device) == (1, 256)
    assert torch.equal(x_hat, fused.spectral_project_reference(
        x, evecs, mass, splits=(1, 256)))
    for b in range(2):
        torch.testing.assert_close(
            x_hat[b], evecs[b].T @ (x[b] * mass[b][:, None]), rtol=1e-6,
            atol=1e-7)


# n_sm for each split count at B = 2, V = 1000, K = C = 8 (two pieces)
SPLIT_SMS = {1: 2, 4: 8, 16: 32}


def _scaled_close(got, want, rtol, atol):
    """|got - want| <= rtol |want| + atol max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rtol * np.abs(want) + atol * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("kind", ["f32", "bf16-x", "lowp"])
@pytest.mark.parametrize("S", [1, 4, 16])
def test_split_projection_matches_jax(S, kind):
    """The projection as the card sums it (the split-V kernel's plain
    version over S ranges of a ragged V = 1000, then the fixed-order sum):
    with a f32 or bf16 x, the whole block through it against the Pallas op
    in interpret mode (f32: rtol 1e-4, atol 1e-5 of each output's largest
    entry; bf16 outputs within one bf16 step, rtol 2^-7, as both round the
    same f32 sums once), and x_hat against an f64 product; lowp (both
    operands rounded to bf16) against the f64 product of the rounded
    operands. No launch on the CPU."""
    x, evecs, gX, gY, mass, coefs = _inputs(7, B=2, V=1000, K=8, C=8)
    splits = mb.xhat_splits(2, 1000, 8, 8, SPLIT_SMS[S])
    assert splits[0] == S
    t = [torch.from_numpy(a) for a in (x, evecs, gX, gY, mass, coefs)]
    xt = t[0].to(torch.bfloat16) if kind == "bf16-x" else t[0]
    fused.reset_launches()
    mb.reset_launches()
    lowp = kind == "lowp"
    ev = t[1].to(torch.bfloat16) if lowp else t[1]
    x_hat = fused.spectral_project_reference(xt, ev, t[4], lowp, splits)
    assert fused.LAUNCHES == {"spectral_project": 0, "spectral_apply": 0,
                              "spectral_ds": 0}
    assert mb.LAUNCHES["xhat_reduce"] == 0
    assert x_hat.dtype == torch.float32 and x_hat.shape == (2, 8, 8)
    r = ((lambda a: a.to(torch.bfloat16).double()) if lowp
         else (lambda a: a.double()))
    want = (r(ev).transpose(1, 2)
            @ r(xt.double() * t[4][..., None].double()))
    _scaled_close(x_hat.numpy(), want.numpy(), 1e-5, 1e-6)
    if lowp:
        return
    outs = fused.spectral_apply_reference(x_hat, t[5], t[1], t[2], t[3],
                                          xt.dtype)
    jx = jnp.asarray(x, jnp.bfloat16) if kind == "bf16-x" else jnp.asarray(x)
    ref = jax_fused_batched(jx, *map(jnp.asarray, (evecs, gX, gY, mass,
                                                   coefs)), 8, True)
    for g, w in zip(outs, ref):
        assert g.dtype == xt.dtype and g.shape == w.shape
        w = np.asarray(w, np.float32)
        if kind == "f32":
            _scaled_close(g.numpy(), w, 1e-4, 1e-5)
        else:
            _scaled_close(g.float().numpy(), w, 2 ** -7, 1e-5)


@pytest.mark.parametrize("S", [1, 4, 16])
def test_split_ds_matches_jax_bwd(S):
    """The backward's ds = Phi^T dy + GX^T dgx + GY^T dgy as the card sums
    it (the plain version of the projection's kernel with three pairs: the
    pairs' partials per V range of a ragged V = 1000, then the fixed-order
    sum) against JAX's `_bwd_b`, whose dcoefs is ds itself where x_hat is
    1; and dx through `project_vjp` of coefs (.) ds against its dx. rtol
    1e-4, atol 1e-5 of each result's largest entry."""
    x, evecs, gX, gY, mass, coefs = _inputs(9, B=2, V=1000, K=8, C=8)
    rs = np.random.RandomState(10)
    cts = [rs.randn(2, 1000, 8).astype(np.float32) for _ in range(3)]
    ones = np.ones((2, 8, 8), np.float32)
    res = tuple(map(jnp.asarray, (x, evecs, gX, gY, mass, coefs, ones)))
    dx_j, *_, ds_j = _bwd_b(8, True, res, tuple(map(jnp.asarray, cts)))
    splits = mb.xhat_splits(2, 1000, 8, 8, SPLIT_SMS[S])
    assert splits[0] == S
    t = [torch.from_numpy(a) for a in (x, evecs, gX, gY, mass, coefs)]
    ds = fused.spectral_ds_reference(t[1], t[2], t[3],
                                     *map(torch.from_numpy, cts), splits)
    _scaled_close(ds.numpy(), np.asarray(ds_j), 1e-4, 1e-5)
    dx = fused.project_vjp(ds * t[5], t[1], t[4], torch.float32)
    _scaled_close(dx.numpy(), np.asarray(dx_j), 1e-4, 1e-5)


def _staged_s(s, k0, c0):
    """spectral_apply's staging of s (csrc/spectral_fused.cu, `stage_s`),
    value by value: rows k0.. and columns c0.. of s (K, C) as 4 chunks of
    (TF32 hi, lo) x 4096 floats; physical row pp = 8 q + 2 st + r of a
    chunk goes to k group u = 2 st + r, place q of 16-byte unit
    ((n / 8) 8 + u) 8 + n % 8; zeros past K and C."""
    K, C = s.shape
    kk, n = torch.meshgrid(torch.arange(128), torch.arange(128),
                           indexing="ij")
    k, c = k0 + kk, c0 + n
    inside = (k < K) & (c < C)
    v = torch.where(inside, s[k.clamp(max=K - 1), c.clamp(max=C - 1)],
                    torch.zeros(()))
    hi = mb.tf32_round(v)
    lo = mb.tf32_round(v - hi)
    pp = kk % 32
    u = 2 * ((pp % 8) // 2) + pp % 2
    unit = ((n // 8) * 8 + u) * 8 + n % 8
    out = torch.zeros(4, 2, 4096)
    out[kk // 32, 0, 4 * unit + pp // 8] = hi
    out[kk // 32, 1, 4 * unit + pp // 8] = lo
    return out


@pytest.mark.parametrize("K,C,k0,c0", [(128, 128, 0, 0), (40, 20, 0, 0),
                                       (200, 136, 128, 128)],
                         ids=["full", "ragged", "second-pieces"])
def test_apply_s_tiles_follow_b_tiles(K, C, k0, c0):
    """The B operand spectral_apply stages, s = coefs (.) x_hat in 128 x 128
    pieces, is laid out as `b_tiles` lays B1's s^T out (each 32-value
    chunk in the permuted order of a thread's A fragments), bit for bit;
    read back as wgmma reads it (K-major core matrices, `_chunk_order`) its
    hi and lo planes are the TF32 split of coefs (.) x_hat, bit for bit,
    with zeros past K and C."""
    rs = np.random.RandomState(K + C)
    x_hat = torch.from_numpy(rs.randn(K, C).astype(np.float32))
    coefs = torch.from_numpy(rs.rand(K, C).astype(np.float32))
    s = coefs * x_hat
    got = _staged_s(s, k0, c0)
    piece = torch.zeros(128, 128)
    kn, cn = min(K - k0, 128), min(C - c0, 128)
    piece[:kn, :cn] = s[k0:k0 + kn, c0:c0 + cn]
    assert torch.equal(got, mb.b_tiles(piece.t(), False)[0])
    order = mb._chunk_order(False)
    n = torch.arange(128)
    back = torch.zeros(2, 128, 128)  # (plane, n, k)
    for ch in range(4):
        for j in range(32):
            o = ((n // 8) * 8 + j // 4) * 32 + (n % 8) * 4 + j % 4
            back[:, n, ch * 32 + order[j]] = got[ch, :, o]
    hi = mb.tf32_round(piece)
    assert torch.equal(back[0].t(), hi)
    assert torch.equal(back[1].t(), mb.tf32_round(piece - hi))
    assert not back[:, cn:].any() and not back[:, :, kn:].any()
