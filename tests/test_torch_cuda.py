"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need a CUDA card (marker `cuda`) and skip without one. The file
imports neither jax nor the JAX package, so it runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.ops import megablock as mb
# tests/ itself, not a `tests` package: the machine with the card may have
# one installed that would shadow it
from torch_threads import one_torch_thread  # noqa: F401

# |kernel - plain| <= atol + rtol |plain|. f32: the same products summed in
# another order. bf16: an intermediate can round to the neighbouring bf16
# value when its f32 sum is taken in another order (2^-8 relative), and
# `out` is stored in bf16.
TOL = {False: dict(rtol=1e-4, atol=1e-4), True: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _block(device, lowp, B=2, V=1000, K=16, C=8, hidden=(16, 32, 8)):
    """Seeded inputs; V = 1000 leaves a ragged last row tile, and the last
    100 rows are padding (mass 0, zero operator rows)."""
    rs = np.random.RandomState(0)
    dt = torch.bfloat16 if lowp else torch.float32

    def r(*shape, scale=1.0, dtype=torch.float32):
        a = (rs.randn(*shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dtype)
    x = r(B, V, C, dtype=dt)
    ops = [r(B, V, K, scale=V ** -0.5) for _ in range(3)]
    mass = torch.from_numpy(rs.rand(B, V).astype(np.float32)).to(device)
    for t in (*ops, mass):
        t[:, V - 100:] = 0
    coefs = torch.from_numpy(rs.rand(B, K, C).astype(np.float32)).to(device)
    widths = (3 * C, *hidden, C)
    Ws = [r(widths[i], widths[i + 1], scale=widths[i] ** -0.5)
          for i in range(len(widths) - 1)]
    bs = [r(widths[i + 1], scale=0.1) for i in range(len(widths) - 1)]
    x_hat = ops[0].transpose(1, 2) @ (x.float() * mass[..., None])
    return (x, *(o.to(dt) for o in ops), mass, coefs, r(C, C, scale=0.3),
            r(C, C, scale=0.3), Ws, bs, x_hat)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("emit_next", [True, False])
def test_block_kernel_matches_plain(cuda, emit_next, lowp):
    args = _block(cuda, lowp)
    mb.reset_launches()
    out, xn = mb.megablock_chained(*args, emit_next=emit_next, lowp=lowp)
    torch.cuda.synchronize()
    assert mb.LAUNCHES == {"megablock_fwd": 1,
                           "megablock_fwd_xhat": int(emit_next),
                           "xhat_reduce": int(emit_next),
                           "megablock_bwd_rows": 0, "megablock_bwd_grads": 0,
                           "grad_reduce": 0}
    ref, ref_xn = mb.megablock_chained_reference(*args, emit_next=emit_next,
                                                 lowp=lowp)
    assert out.dtype == args[0].dtype
    torch.testing.assert_close(out.float(), ref.float(), **TOL[lowp])
    if emit_next:
        torch.testing.assert_close(xn, ref_xn, **TOL[lowp])
    else:
        assert xn is None


@pytest.mark.cuda
def test_block_kernel_refuses_what_it_does_not_take(cuda):
    """Wrong dtype, non-contiguous input, and a layout the card's shared
    memory does not hold (the message names the bytes; every width fits
    the smallest layout on an H100, so a limit below it stands in): the
    wrapper raises before launching."""
    args = list(_block(cuda, False))
    mb.reset_launches()
    bad = list(args)
    bad[5] = bad[5].double()  # coefs
    with pytest.raises(ValueError, match="coefs dtype"):
        mb.megablock_chained(*bad)
    bad = list(args)
    bad[1] = bad[1].transpose(1, 2).contiguous().transpose(1, 2)  # evecs
    with pytest.raises(ValueError, match="contiguous"):
        mb.megablock_chained(*bad)
    need = mb.fwd_rows_smem_bytes(256, (768, 2048, 256), False,
                                  mb.FWD_LAYOUTS[-1])
    assert need <= mb._smem_limit(0)
    with pytest.raises(ValueError, match=f"needs at least {need} bytes of "
                       r"shared memory .* more than the card's \d+ bytes"):
        mb.fwd_route(256, (768, 2048, 256), False, need - 1)
    assert all(v == 0 for v in mb.LAUNCHES.values())


def _close_l2(name, got, want, tol=1e-2):
    """Relative L2 error within tol: gradients through ReLUs, where no
    elementwise bound holds. A pre-activation within rounding of 0 takes
    the other side in another summation order and moves its row's whole
    contribution, about 1/sqrt(rows) of a sum of random-sign cotangents
    (at sampling_invariance's shapes the f32 CPU model's worst leaf sits
    6e-4 from its f64 gradient). The default, 1e-2, is the benchmark's
    limit on the same gap in its siv_train cell."""
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(got).all(), name
    rel = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
    assert rel <= tol, f"{name}: relative L2 error {rel:.3e}"


def _close_grad(name, got, want, lowp):
    """f32: as `_close`. bf16: relative L2 error within 2e-2, as
    chip_smoke.py holds B2 in bf16: where an f32 sum lands next to a bf16
    rounding boundary the two sides round it apart (2^-8 relative), and a
    ReLU input downstream can then change sign, which moves that row's
    whole contribution, so no elementwise bound holds on every row."""
    if not lowp:
        return _close(name, got, want, False)
    _close_l2(name, got, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [128, 256])
def test_block_kernels_at_c256(cuda, K, lowp):
    """B1 and B2 at C = 256, hidden [256, 256] (the sampling_invariance
    model's widths), K 128 and 256, with dropout, against their plain
    versions: B1's row kernel (one warpgroup a CTA; feat spilled to a
    device scratch in f32),
    its x_hat_next in 128 x 128 pieces; B2's rows and grads kernels.
    ReLU-tie rows get zero cotangent."""
    args = list(_block(cuda, lowp, V=512, K=K, C=256, hidden=(256, 256)))
    assert mb.fwd_route(256, (768, 256, 256, 256), lowp,
                        mb._smem_limit(0)) == (1, 2 if not lowp else 3, False)
    kw = dict(lowp=lowp, seed=321, tile_v=128)
    out, xn = mb.megablock_chained_fwd(*args, emit_next=True, **kw)
    ref, ref_xn = mb.megablock_chained_reference(*args, emit_next=True, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[lowp])
    _close("x_hat_next", xn, ref_xn, lowp)
    ties = mb.relu_margin(*args, **kw) < 1e-5
    args[4] = args[4].masked_fill(ties, 0.0)
    g = torch.Generator(device=cuda).manual_seed(5)
    dout = torch.randn(args[0].shape, generator=g, device=cuda).to(
        args[0].dtype).masked_fill(ties[..., None], 0.0)
    dxn = torch.randn(args[-1].shape, generator=g, device=cuda)
    mb.reset_launches()
    got = mb.megablock_chained_bwd(*args, dout, dxn, **kw)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["megablock_bwd_rows"] == 1
    assert mb.LAUNCHES["megablock_bwd_grads"] == 1
    want = mb.megablock_chained_bwd_reference(*args, dout, dxn, **kw)
    for name, a, b in zip(("dx_direct", "ds", "dA_re", "dA_im"), got[:4],
                          want[:4]):
        _close_grad(name, a, b, lowp)
    for l in range(3):
        _close_grad(f"dW{l}", got[4][l], want[4][l], lowp)
        _close_grad(f"db{l}", got[5][l], want[5][l], lowp)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [None, 31], ids=["nodrop", "drop"])
@pytest.mark.parametrize("C", [128, 256])
def test_row_and_xhat_kernels_each_match_plain(cuda, C, seed, lowp):
    """B1's two kernels one at a time at the models' widths (hidden [C, C],
    K = 128, a ragged last 64-row tile): the row kernel's `out` against the
    plain forward; the x_hat kernel's partials against their plain version
    on the same f32 out (the same split of V); two launches of each give the
    same bits; `xhat_reduce` of the kernel's partials equals the plain
    fixed-order sum of the same partials bit for bit."""
    args = _block(cuda, lowp, V=2000, K=128, C=C, hidden=(C, C))
    kw = dict(lowp=lowp, seed=seed, tile_v=1000)
    if seed is not None:
        args = _block(cuda, lowp, V=2048, K=128, C=C, hidden=(C, C))
        kw["tile_v"] = 1024
    mb.reset_launches()
    out, _ = mb.megablock_chained_fwd(*args, emit_next=False, **kw)
    again, _ = mb.megablock_chained_fwd(*args, emit_next=False, **kw)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["megablock_fwd"] == 2
    assert mb.LAUNCHES["megablock_fwd_xhat"] == 0
    assert torch.equal(out, again)
    f = mb._forward_parts(*args, lowp, seed, kw["tile_v"])
    torch.testing.assert_close(out.float(), f["out"].float(), **TOL[lowp])
    B, V = out.shape[:2]
    splits = mb.xhat_splits(B, V, 128, C, mb._sm_count(0))
    src = f["out"].float().contiguous()
    part = mb.megablock_fwd_xhat(args[1], src, args[4], splits, lowp)
    part2 = mb.megablock_fwd_xhat(args[1], src, args[4], splits, lowp)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["megablock_fwd_xhat"] == 2
    # K = 128 and C a multiple of 128: every slot is written whole
    assert torch.equal(part, part2)
    plain = mb.megablock_fwd_xhat_reference(args[1], src, args[4], splits,
                                            lowp)
    _close("x_hat partials", part, plain, False)
    got = mb.reduce_pieces(part, B, 128, C)
    assert torch.equal(got.cpu(), mb.reduce_pieces(part.cpu(), B, 128, C))
    _close("x_hat_next", got, mb.megablock_chained_reference(
        *args, emit_next=True, **kw)[1], lowp)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
def test_wide_route_matches_plain(cuda, lowp):
    """The shapes of the earlier wide route run on the row kernel: hidden
    widths whose 64-row buffers exceed shared memory (C = 256, hidden [1024,
    1024]) with the hidden layers, gy and feat in device scratch, C = 384
    (the default MLP) with every activation in device scratch in f32, and
    C % 8 != 0 (C = 12, padded to 16 around the kernels); B1 and B2
    against their plain versions, with dropout (ReLU-tie rows given zero
    cotangent)."""
    # the layouts in f32 and in bf16
    for C, hidden, layouts in (
            (256, (1024, 1024), ((2, 1, True), (2, 1, True))),
            (384, (384, 384), ((2, 0, True), (1, 2, False))),
            (12, (12,), ((2, 3, False), (2, 3, False)))):
        args = list(_block(cuda, lowp, V=512, K=128, C=C, hidden=hidden))
        assert mb.fwd_route(C, (3 * C, *hidden, C), lowp,
                            mb._smem_limit(0)) == layouts[lowp]
        kw = dict(lowp=lowp, seed=77, tile_v=128)
        mb.reset_launches()
        out, xn = mb.megablock_chained_fwd(*args, emit_next=True, **kw)
        torch.cuda.synchronize()
        assert mb.LAUNCHES["megablock_fwd"] == 1
        ref, ref_xn = mb.megablock_chained_reference(*args, emit_next=True,
                                                     **kw)
        assert out.shape == ref.shape
        torch.testing.assert_close(out.float(), ref.float(), **TOL[lowp])
        _close("x_hat_next", xn, ref_xn, lowp)
        ties = mb.relu_margin(*args, **kw) < 1e-5
        args[4] = args[4].masked_fill(ties, 0.0)
        g = torch.Generator(device=cuda).manual_seed(9)
        dout = torch.randn(args[0].shape, generator=g, device=cuda).to(
            args[0].dtype).masked_fill(ties[..., None], 0.0)
        dxn = torch.randn(args[-1].shape, generator=g, device=cuda)
        got = mb.megablock_chained_bwd(*args, dout, dxn, **kw)
        torch.cuda.synchronize()
        assert mb.LAUNCHES["megablock_bwd_rows"] == 1
        want = mb.megablock_chained_bwd_reference(*args, dout, dxn, **kw)
        for name, a, b in zip(("dx_direct", "ds", "dA_re", "dA_im"),
                              got[:4], want[:4]):
            assert a.shape == b.shape, name
            _close_grad(name, a, b, lowp)
        for l in range(len(hidden) + 1):
            _close_grad(f"dW{l}", got[4][l], want[4][l], lowp)
            _close_grad(f"db{l}", got[5][l], want[5][l], lowp)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
def test_block_kernels_at_odd_widths(cuda, lowp):
    """K = 19 (operator rows not 16-byte aligned: B2's element-wise loads)
    and hidden widths 13 and 7 (partial quads in B2's epilogues), at a
    ragged V: B1 and B2 against their plain versions."""
    args = list(_block(cuda, lowp, V=1000, K=19, C=8, hidden=(13, 7)))
    out, xn = mb.megablock_chained_fwd(*args, emit_next=True, lowp=lowp)
    ref, ref_xn = mb.megablock_chained_reference(*args, emit_next=True,
                                                 lowp=lowp)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[lowp])
    _close("x_hat_next", xn, ref_xn, lowp)
    ties = mb.relu_margin(*args, lowp=lowp) < 1e-5
    args[4] = args[4].masked_fill(ties, 0.0)
    g = torch.Generator(device=cuda).manual_seed(11)
    dout = torch.randn(args[0].shape, generator=g, device=cuda).to(
        args[0].dtype).masked_fill(ties[..., None], 0.0)
    dxn = torch.randn(args[-1].shape, generator=g, device=cuda)
    got = mb.megablock_chained_bwd(*args, dout, dxn, lowp=lowp)
    want = mb.megablock_chained_bwd_reference(*args, dout, dxn, lowp=lowp)
    for name, a, b in zip(("dx_direct", "ds", "dA_re", "dA_im"), got[:4],
                          want[:4]):
        _close_grad(name, a, b, lowp)
    for l in range(3):
        _close_grad(f"dW{l}", got[4][l], want[4][l], lowp)
        _close_grad(f"db{l}", got[5][l], want[5][l], lowp)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("emit_next", [True, False])
def test_backward_kernels_each_match_plain(cuda, emit_next, lowp):
    """B2's two kernels one at a time: the rows kernel against its plain
    version (dx_direct, every group of the scratch R, db's partials), and
    the grads kernel against its plain version on the rows kernel's own R
    (the same split of V into ranges); two launches of the grads kernel
    give the same bits, and the fixed-order sum of its partials equals the
    plain sum bit for bit."""
    args = list(_block(cuda, lowp, V=1056, hidden=(16, 32, 8)))
    kw = dict(lowp=lowp, seed=777, tile_v=352)  # a ragged last 64-row tile
    ties = mb.relu_margin(*args, **kw) < 1e-5
    args[4] = args[4].masked_fill(ties, 0.0)
    g = torch.Generator(device=cuda).manual_seed(9)
    dout = torch.randn(args[0].shape, generator=g, device=cuda).to(
        args[0].dtype).masked_fill(ties[..., None], 0.0)
    dxn = (torch.randn(args[-1].shape, generator=g, device=cuda)
           if emit_next else None)
    mb.reset_launches()
    dx, R, dbp = mb.megablock_bwd_rows(*args, dout, dxn, **kw)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["megablock_bwd_rows"] == 1
    dx_r, R_r, dbp_r = mb.megablock_bwd_rows_reference(*args, dout, dxn,
                                                       **kw)
    _close_grad("dx_direct", dx, dx_r, lowp)
    widths = (24, 16, 32, 8, 8)
    lay = mb.bwd_layout(16, 8, widths)
    groups = [(f"in{l}", lay["off_in"][l], widths[l]) for l in range(4)]
    groups += [(f"dpre{l}", lay["off_dp"][l], widths[l + 1])
               for l in range(4)]
    groups += [("gx|gy", lay["off_gg"], 16), ("dvb", lay["off_dvb"], 16),
               ("dxd|dgx|dgy", lay["off_ds"], 24)]
    for name, o, w in groups:
        _close_grad(name, R[:, o:o + w], R_r[:, o:o + w], lowp)
    _close_grad("db partials", dbp, dbp_r, lowp)
    splits = mb.grads_splits(2, 1056, 16, 8, widths, 4)
    pp, pd = mb.megablock_bwd_grads(R, *args[1:4], 8, widths, splits, lowp)
    pp2, pd2 = mb.megablock_bwd_grads(R, *args[1:4], 8, widths, splits, lowp)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["megablock_bwd_grads"] == 2
    assert torch.equal(pp, pp2) and torch.equal(pd, pd2)
    pp_r, pd_r = mb.megablock_bwd_grads_reference(R, *args[1:4], 8, widths,
                                                  splits, lowp)
    _close("parameter partials", pp, pp_r, False)
    _close("ds partials", pd, pd_r, False)
    got = mb.bwd_grads_finish(pp, pd, dbp, 16, 8, widths)
    plain = mb.bwd_grads_finish(pp.cpu(), pd.cpu(), dbp.cpu(), 16, 8, widths)
    for a, b in zip([*got[:3], *got[3], *got[4]],
                    [*plain[:3], *plain[3], *plain[4]]):
        assert torch.equal(a.cpu(), b)


def _close(name, got, want, lowp):
    """|kernel - plain| <= rtol |plain| + atol * max |plain|: gradients are
    sums over every row of the batch, so the bound scales with the largest
    entry. f32: the kernel's three TF32 passes and another summation order;
    bf16: a cotangent that rounds to the neighbouring bf16 value carries
    2^-8 relative into every later product."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), name
    scale = max(want.abs().max().item(), 1e-6)
    rtol, atol = (2e-2, 2e-2) if lowp else (1e-4, 1e-4)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol * scale,
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
def test_block_kernel_dropout_matches_plain(cuda, lowp):
    """Masks from (seed, b, tile of 256 rows, layer), bit-identical to the
    plain version's: with all-ones inputs the kept pattern shows exactly."""
    args = _block(cuda, lowp, V=1024)
    out, xn = mb.megablock_chained_fwd(*args, emit_next=True, lowp=lowp,
                                       seed=12345, tile_v=256)
    ref, ref_xn = mb.megablock_chained_reference(*args, emit_next=True,
                                                 lowp=lowp, seed=12345,
                                                 tile_v=256)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[lowp])
    torch.testing.assert_close(xn, ref_xn, **TOL[lowp])
    # one hidden layer of width 16, identity beyond it: out - x is the
    # dropped, scaled activation of an all-ones hidden layer
    B, V, C = 2, 1024, 16
    dt = torch.bfloat16 if lowp else torch.float32
    ones = torch.ones
    Ws = [torch.zeros(3 * C, C, device=cuda), torch.eye(C, device=cuda)]
    bs = [torch.ones(C, device=cuda), torch.zeros(C, device=cuda)]
    ops = [torch.zeros(B, V, 16, device=cuda, dtype=dt) for _ in range(3)]
    x = torch.zeros(B, V, C, device=cuda, dtype=dt)
    out, _ = mb.megablock_chained_fwd(
        x, *ops, ones(B, V, device=cuda), ones(B, 16, C, device=cuda),
        torch.zeros(C, C, device=cuda), torch.zeros(C, C, device=cuda), Ws, bs,
        torch.zeros(B, 16, C, device=cuda), emit_next=False, lowp=lowp,
        seed=2 ** 31 - 2, tile_v=512)
    keep = mb.dropout_masks(B, V, C, 2 ** 31 - 2, 0, 512, device=cuda)
    assert torch.equal(out.float(), keep.float() * 2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("emit_next", [True, False])
@pytest.mark.parametrize("V,seed", [(1000, None), (1024, 777)],
                         ids=["ragged", "dropout"])
def test_backward_kernel_matches_plain(cuda, V, seed, emit_next, lowp):
    """B2 and its partial-sum kernel against the plain backward: every
    output, at a ragged V (last row tile partly past V) and with dropout."""
    args = _block(cuda, lowp, V=V)
    g = torch.Generator(device=cuda).manual_seed(1)
    dout = torch.randn(args[0].shape, generator=g, device=cuda).to(
        args[0].dtype)
    dxn = (torch.randn(args[-1].shape, generator=g, device=cuda)
           if emit_next else None)
    mb.reset_launches()
    got = mb.megablock_chained_bwd(*args, dout, dxn, lowp=lowp, seed=seed,
                                   tile_v=256)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["megablock_bwd_rows"] == 1
    assert mb.LAUNCHES["megablock_bwd_grads"] == 1
    assert mb.LAUNCHES["grad_reduce"] == 3
    want = mb.megablock_chained_bwd_reference(*args, dout, dxn, lowp=lowp,
                                              seed=seed, tile_v=256)
    assert got[0].dtype == args[0].dtype
    for name, a, b in zip(("dx_direct", "ds", "dA_re", "dA_im"), got[:4],
                          want[:4]):
        _close(name, a, b, lowp)
    for l, (a, b) in enumerate(zip(got[4], want[4])):
        _close(f"dW{l}", a, b, lowp)
    for l, (a, b) in enumerate(zip(got[5], want[5])):
        _close(f"db{l}", a, b, lowp)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [None, 99], ids=["nodrop", "drop"])
def test_function_gradients_match_autograd_of_plain(cuda, seed):
    """The autograd Function on the card (B1 forward, B2 backward) against
    torch.autograd through the plain forward on the same card."""
    def leaves(args):
        out = []
        for i, a in enumerate(args):
            if isinstance(a, list):
                out.append([t.detach().clone().requires_grad_(True)
                            for t in a])
            elif i in (0, 5, 6, 7, 10):
                out.append(a.detach().clone().requires_grad_(True))
            else:
                out.append(a)
        return out
    base = _block(cuda, False, V=1024)
    g = torch.Generator(device=cuda).manual_seed(2)
    dout = torch.randn(base[0].shape, generator=g, device=cuda)
    dxn = torch.randn(base[-1].shape, generator=g, device=cuda)
    grads = []
    for fn in (mb.megablock_chained, mb.megablock_chained_reference):
        args = leaves(base)
        out, xn = fn(*args, emit_next=True, seed=seed, tile_v=256)
        ((out * dout).sum() + (xn * dxn).sum()).backward()
        grads.append([args[i].grad for i in (0, 5, 6, 7, 10)]
                     + [t.grad for t in args[8] + args[9]])
    for k, (a, b) in enumerate(zip(*grads)):
        _close(f"grad {k}", a, b, False)


@pytest.mark.cuda
def test_dropout_and_backward_refusals(cuda):
    """tile_v not a multiple of the kernel's 64-row tile, V not a multiple
    of tile_v with dropout, dout in another dtype: raised before any
    launch. C % 8 != 0 is no longer refused: B2 pads C to a multiple of 8
    around its kernels and matches its plain version at C = 12."""
    args = _block(cuda, False, V=1024)
    dout = torch.zeros_like(args[0])
    mb.reset_launches()
    with pytest.raises(ValueError, match="multiple of the kernel's 64-row"):
        mb.megablock_chained_fwd(*args, seed=1, tile_v=48)
    with pytest.raises(ValueError, match="multiple of tile_v"):
        mb.megablock_chained_fwd(*_block(cuda, False, V=1000), seed=1,
                                 tile_v=256)
    with pytest.raises(ValueError, match="dout must be"):
        mb.megablock_chained_bwd(*args, dout.double())
    assert all(v == 0 for v in mb.LAUNCHES.values())
    small = list(_block(cuda, False, V=64, C=12, hidden=(12,)))
    ties = mb.relu_margin(*small) < 1e-5
    small[4] = small[4].masked_fill(ties, 0.0)
    dout = torch.randn(small[0].shape, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(3)
                       ).masked_fill(ties[..., None], 0.0)
    got = mb.megablock_chained_bwd(*small, dout)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["megablock_bwd_rows"] == 1
    assert mb.LAUNCHES["megablock_bwd_grads"] == 1
    want = mb.megablock_chained_bwd_reference(*small, dout)
    for name, a, b in zip(("dx_direct", "ds", "dA_re", "dA_im"), got[:4],
                          want[:4]):
        assert a.shape == b.shape, name
        _close(name, a, b, False)
    for l in range(2):
        _close(f"dW{l}", got[4][l], want[4][l], False)
        _close(f"db{l}", got[5][l], want[5][l], False)


# --- B5: the sliced-ELL SpMM (csrc/blocked_ell.cu) --------------------------

def _torus_laplacian(with_mass=False):
    """The cotan Laplacian of torus(40, 30) (numpy and scipy only, so the
    file stays free of jax and the JAX package), and its lumped mass."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from meshgen import torus
    from diffusionnet_tpu_torch.geometry.laplacian import (cotan_laplacian,
                                                          vertex_areas)
    v, f = torus(40, 30)
    L = cotan_laplacian(v, f)
    return (L, vertex_areas(v, f)) if with_mass else L


def _hub_matrix(V=700, hub=600):
    """A symmetric matrix with one hub row of degree > hub (a slice that
    wide), a path through the rows after it, and 60 empty rows (numpy and
    scipy only; tests/test_torch_blocked_ell.py uses it too)."""
    import scipy.sparse
    rs = np.random.RandomState(0)
    nbrs = rs.choice(np.arange(1, V - 60), hub, replace=False)
    path = np.arange(1, V - 60)
    r = np.concatenate([np.zeros(hub, np.int64), path[:-1]])
    c = np.concatenate([nbrs, path[1:]])
    A = scipy.sparse.coo_matrix((rs.rand(r.size) + 0.1, (r, c)),
                                shape=(V, V))
    A = A + A.T
    return scipy.sparse.csr_matrix(
        scipy.sparse.diags(np.asarray(A.sum(1)).ravel()) - A)


@pytest.mark.cuda
@pytest.mark.parametrize("mat,C", [
    ("torus", 160), ("torus", 96), ("torus", 18), ("torus", 150),
    ("torus", 100), ("torus", 1), ("torus", 328), ("hub", 97), ("hub", 160)],
    ids=["C160", "C96", "ragged-C18", "ragged-C150", "C100", "C1", "C328",
         "hub-C97", "hub-C160"])
def test_blocked_ell_kernel_matches_plain(cuda, mat, C):
    """B5 against its plain version within 5e-6 of max |plain| (f32 sums of
    the same products, FMA against multiply-add); padded rows exactly 0;
    one launch; a second launch bit-identical. C=18, 150, 1 and 97 take the
    kernel's scalar path, C=96 and 100 the float4 path with idle lanes,
    C=328 two column tiles; the hub matrix has a slice over 500 slots wide
    and rows with no entries."""
    from diffusionnet_tpu_torch.ops import blocked_ell as be
    L = _torus_laplacian() if mat == "torus" else _hub_matrix()
    b = be.blocked_ell_from_sparse(L, tile_rows=256, device=cuda)
    V = L.shape[0]
    g = torch.Generator(device=cuda).manual_seed(C)
    x = torch.zeros(b.n_pad, C, device=cuda)
    x[:V] = torch.randn(V, C, generator=g, device=cuda)
    be.reset_launches()
    y = be.blocked_ell_matvec(b, x)
    torch.cuda.synchronize()
    assert be.LAUNCHES == {"blocked_ell": 1}
    assert torch.equal(y, be.blocked_ell_matvec(b, x))
    ref = be.blocked_ell_matvec_reference(b, x)
    scale = ref.abs().max().item()
    assert (y - ref).abs().max().item() <= 5e-6 * scale
    assert y[V:].abs().max().item() == 0.0


@pytest.mark.cuda
def test_blocked_ell_kernel_refusals(cuda):
    """An f64 or f16 x, an f64 format, a non-contiguous x, an x of other
    rows than n_pad and a format on another device are refused before any
    launch."""
    from diffusionnet_tpu_torch.ops import blocked_ell as be
    b = be.blocked_ell_from_sparse(_torus_laplacian(), device=cuda)
    x = torch.zeros(b.n_pad, 32, device=cuda)
    be.reset_launches()
    with pytest.raises(ValueError, match="contiguous f32"):
        be.blocked_ell_matvec(b, x.double())
    with pytest.raises(ValueError, match="contiguous f32"):
        be.blocked_ell_matvec(b, x.half())
    with pytest.raises(ValueError, match="must be f32"):
        be.blocked_ell_matvec(b._replace(vals=b.vals.double()), x)
    with pytest.raises(ValueError, match="contiguous"):
        be.blocked_ell_matvec(b, torch.zeros(32, b.n_pad, device=cuda).T)
    with pytest.raises(ValueError, match="expected"):
        be.blocked_ell_matvec(b, x[:-32])
    cpu_fmt = b._replace(cols=b.cols.cpu())
    with pytest.raises(ValueError, match="different devices"):
        be.blocked_ell_matvec(cpu_fmt, x)
    assert be.LAUNCHES == {"blocked_ell": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K,C", [(1, 132, 128, 128), (8, 16, 128, 128),
                                     (2, 37, 24, 10), (3, 5, 128, 72)])
def test_xhat_reduce_bit_equal_to_plain(cuda, B, S, K, C):
    """The partial-sum kernel equals its plain version bit for bit (the
    same f32 additions in the same order), and itself across launches."""
    g = torch.Generator(device=cuda).manual_seed(S)
    partial = torch.randn(B, S, mb.SLOT, mb.SLOT, generator=g, device=cuda)
    mb.reset_launches()
    got = mb.xhat_reduce(partial, K, C)
    again = mb.xhat_reduce(partial, K, C)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["xhat_reduce"] == 2
    assert got.shape == (B, K, C)
    assert torch.equal(got, again)
    assert torch.equal(got, mb.xhat_reduce_reference(partial, K, C))


@pytest.mark.cuda
def test_device_eigensolver_runs_on_b5(cuda):
    """eigensolve_device on the card takes the blocked route through B5 and
    agrees with host ARPACK within 1e-6 of the largest eigenvalue."""
    import numpy as np
    import scipy.sparse
    from diffusionnet_tpu_torch.geometry import eigen
    from diffusionnet_tpu_torch.ops import blocked_ell as be
    from diffusionnet_tpu_torch.ops.sparse import ell_from_coo
    L, m = _torus_laplacian(with_mass=True)
    coo = scipy.sparse.coo_matrix(L)
    ell = ell_from_coo(coo.row, coo.col, coo.data, L.shape[0])
    be.reset_launches()
    ev, _ = eigen.eigensolve_device(ell, m.astype(np.float32), 16,
                                    polish=(L, m), device=cuda)
    assert be.LAUNCHES["blocked_ell"] > 0
    h, _ = eigen.eigensolve_host(L, m, 16)
    assert np.abs(ev - h).max() / h.max() < 1e-6


# --- B4 (csrc/spectral_fused.cu) and B3 (ops.megablock.megablock) -----------

def _fused_inputs(device, x_dtype, ops_dtype, B=2, V=1000, K=16, C=8):
    """Seeded inputs of the fused block; the last 100 rows are padding."""
    g = torch.Generator(device=device).manual_seed(V + K + C)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale
    x = r(B, V, C).to(x_dtype)
    ops = [r(B, V, K, scale=V ** -0.5) for _ in range(3)]
    mass = torch.rand(B, V, generator=g, device=device)
    for t in (*ops, mass):
        t[:, V - 100:] = 0
    coefs = torch.rand(B, K, C, generator=g, device=device)
    return (x, *(o.to(ops_dtype) for o in ops), mass, coefs)


F32, BF16 = torch.float32, torch.bfloat16


# (B, V, K, C): the fused training shape, one surface, a ragged V with K =
# C = 8 and K = 16 and with K = C = 128 (the projection's last chunk of
# each range takes cp.async copies, the others bulk copies), K and C past
# one 128-wide piece, C not a multiple of 4
FUSED_SHAPES = {"B4": (4, 32768, 128, 128), "B1": (1, 32768, 128, 128),
                "ragged": (2, 1000, 8, 8), "small": (2, 1000, 16, 8),
                "ragged-128": (2, 1000, 128, 128),
                "past-128": (2, 1000, 200, 136), "C%4": (2, 1000, 24, 10)}


@pytest.mark.cuda
@pytest.mark.parametrize("x_dt,ops_dt", [(F32, F32), (BF16, F32),
                                         (BF16, BF16)],
                         ids=["f32", "bf16-x", "bf16"])
@pytest.mark.parametrize("shape", list(FUSED_SHAPES))
def test_fused_kernels_match_plain(cuda, x_dt, ops_dt, shape):
    """spectral_project (+ xhat_reduce) against its split-V plain version
    and spectral_apply against its plain version on the same x_hat, with
    the last 100 rows padding: |kernel - plain| <= rtol |plain| + atol max
    |plain|, 1e-4 for f32 results (three TF32 passes, sums in another
    order), 2e-2 for bf16 outputs (one rounding step of 2^-8 apart); also
    the projection's lowp mode (B3's) on the operators in bf16. Each kernel
    launches once per call, two launches give the same bits, and padding
    rows come out 0."""
    from diffusionnet_tpu_torch.ops import fused
    B, V, K, C = FUSED_SHAPES[shape]
    x, evecs, gX, gY, mass, coefs = _fused_inputs(cuda, x_dt, ops_dt, B=B,
                                                  V=V, K=K, C=C)
    fused.reset_launches()
    mb.reset_launches()
    x_hat = fused.spectral_project(x, evecs, mass)
    outs = fused.spectral_apply(x_hat, coefs, evecs, gX, gY, x.dtype)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {"spectral_project": 1, "spectral_apply": 1,
                              "spectral_ds": 0}
    assert mb.LAUNCHES["xhat_reduce"] == 1
    assert torch.equal(x_hat, fused.spectral_project(x, evecs, mass))
    again = fused.spectral_apply(x_hat, coefs, evecs, gX, gY, x.dtype)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))
    _close("x_hat", x_hat, fused.spectral_project_reference(x, evecs, mass),
           False)
    want = fused.spectral_apply_reference(x_hat, coefs, evecs, gX, gY,
                                          x.dtype)
    for name, a, b in zip(("y", "ygx", "ygy"), outs, want):
        assert a.dtype == x.dtype
        _close(name, a, b, x.dtype == BF16)
        assert a[:, -100:].float().abs().max().item() == 0.0
    # the lowp projection on bf16 operators, for every x dtype (the op
    # megablock takes an f32 x beside bf16 operators)
    ev16 = evecs.to(BF16)
    lowp = fused.spectral_project(x, ev16, mass, lowp=True)
    assert torch.equal(lowp, fused.spectral_project(x, ev16, mass,
                                                    lowp=True))
    _close("x_hat lowp", lowp, fused.spectral_project_reference(
        x, ev16, mass, lowp=True), False)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dt", [F32, BF16], ids=["f32", "bf16-x"])
@pytest.mark.parametrize("shape", ["B4", "ragged", "ragged-128", "past-128",
                                   "C%4"])
def test_fused_backward_ds_matches_plain(cuda, x_dt, shape):
    """The backward's ds on the projection's kernel (three operator and
    cotangent pairs, no scale; cotangents in x's dtype) against its split-V
    plain version within 1e-4 of its largest entry (sums over V): one
    launch a call, counted as spectral_ds's, and two launches give the same
    bits."""
    from diffusionnet_tpu_torch.ops import fused
    B, V, K, C = FUSED_SHAPES[shape]
    _, evecs, gX, gY, _, _ = _fused_inputs(cuda, x_dt, F32, B=B, V=V, K=K,
                                           C=C)
    g = torch.Generator(device=cuda).manual_seed(8)
    cts = [torch.randn(B, V, C, generator=g, device=cuda).to(x_dt)
           for _ in range(3)]
    fused.reset_launches()
    mb.reset_launches()
    ds = fused.spectral_ds(evecs, gX, gY, *cts)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {"spectral_project": 0, "spectral_apply": 0,
                              "spectral_ds": 1}
    assert mb.LAUNCHES["xhat_reduce"] == 1
    assert torch.equal(ds, fused.spectral_ds(evecs, gX, gY, *cts))
    _close("ds", ds, fused.spectral_ds_reference(evecs, gX, gY, *cts), False)


@pytest.mark.cuda
def test_fused_function_gradients_match_autograd_of_plain(cuda):
    """The autograd Function on the card (B4 forward) against autograd
    through the plain forward."""
    from diffusionnet_tpu_torch.ops import fused
    base = _fused_inputs(cuda, F32, F32, V=1024)
    g = torch.Generator(device=cuda).manual_seed(4)
    cts = [torch.randn(base[0].shape, generator=g, device=cuda)
           for _ in range(3)]
    grads = []
    for fn in (fused.fused_spectral_block_batched,
               fused.fused_spectral_block_reference):
        x = base[0].clone().requires_grad_(True)
        coefs = base[5].clone().requires_grad_(True)
        outs = (fn(x, *base[1:5], coefs, 256) if fn is not
                fused.fused_spectral_block_reference
                else fn(x, *base[1:5], coefs))
        sum((o * c).sum() for o, c in zip(outs, cts)).backward()
        grads.append((x.grad, coefs.grad))
    for name, a, b in zip(("dx", "dcoefs"), *grads):
        _close(name, a, b, False)


def _eager_model_run(device, model, inputs, op_grads=False):
    """One forward (deterministic) of `model` moved to `device` and the
    backward of sum(out * ct): (out, x's gradient, each parameter's
    gradient, the block route counters of the forward). op_grads: evecs,
    gradX and gradY require grad too, their gradients among the
    parameters'."""
    from diffusionnet_tpu_torch.training import profiling
    x, ct, *ops = (t.detach().to(device) for t in inputs)
    op_names = ("evecs", "gradX", "gradY") if op_grads else ()
    for t in [x, *ops[2:2 + len(op_names)]]:
        t.requires_grad_(True)
    model = model.to(device)
    profiling.reset()
    out = model(x, *ops)
    routes = {k: n for k, (n, _) in profiling.totals()["counters"].items()
              if k.startswith("block.")}
    (out * ct).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads.update((n, t.grad) for n, t in zip(op_names, ops[2:]))
    return out.detach(), x.grad, grads, routes


def _eager_siv_case(V, C=256, K=128, B=2, n_class=6890):
    """sampling_invariance's model as `exp_common.build_model` makes it
    (xyz in, width 256, MLP [256, 256], log-softmax over 6890 classes at
    vertices, no use_pallas_fused) with seeded diffusion times, and seeded dense
    spectral operators at B, V, K on the CPU, scaled as a surface's are
    (as the benchmark's bundles: mass summing to 1, evecs about
    mass-orthonormal, eigenvalues growing by about 4 pi, gradients of
    size sqrt(evals / 2)) and positions of a unit-sized surface, so the
    gradient features' tanh is rarely saturated, the last 100 rows
    padding."""
    from diffusionnet_tpu_torch.experiments import exp_common
    model = exp_common.build_model(n_class=n_class, c_width=C,
                                   outputs_at="vertices", dropout=True,
                                   input_features="xyz")
    assert not model.use_pallas_fused
    g = torch.Generator().manual_seed(V + K)
    with torch.no_grad():
        for blk in model.blocks:
            blk.diffusion.diffusion_time.copy_(
                torch.rand(C, generator=g) * 0.01)
    x = torch.randn(B, V, 3, generator=g) * 0.3
    mass = 0.5 + torch.rand(B, V, generator=g)
    mass[:, V - 100:] = 0
    mass = mass / mass.sum(-1, keepdim=True)
    evecs = torch.randn(B, V, K, generator=g)
    evals = torch.cumsum(4 * np.pi * (0.5 + torch.rand(B, K, generator=g)),
                         -1)
    gX, gY = (torch.randn(B, V, K, generator=g) * (evals[:, None] / 2).sqrt()
              for _ in range(2))
    for t in (x, evecs, gX, gY):
        t[:, V - 100:] = 0
    ct = torch.randn(B, V, n_class, generator=g)
    return model, (x, ct, mass, evals, evecs, gX, gY)


@pytest.mark.cuda
def test_eager_model_runs_b4_on_the_card_at_siv_shapes(cuda):
    """The eager model without use_pallas_fused at sampling_invariance's
    shapes (B 2, V 8192, K 128, width 256): on the card each block takes
    B4 (one projection, apply and ds each, `block.b4` 4 times a forward,
    `block.dense` never), on the CPU the dense route. The output agrees
    within the fused tests' f32 tolerance, x's gradient and every
    parameter's within `_close_l2`."""
    import copy
    from diffusionnet_tpu_torch.ops import fused
    model, inputs = _eager_siv_case(8192)
    want = _eager_model_run(torch.device("cpu"), copy.deepcopy(model),
                            inputs)
    assert want[3] == {"block.dense": 4}
    fused.reset_launches()
    got = _eager_model_run(cuda, model, inputs)
    torch.cuda.synchronize()
    assert got[3] == {"block.b4": 4}
    assert fused.LAUNCHES == {"spectral_project": 4, "spectral_apply": 4,
                              "spectral_ds": 4}
    _close("out", got[0], want[0].to(cuda), False)
    _close_l2("dx", got[1], want[1])
    for name in want[2]:
        _close_l2(name, got[2][name], want[2][name])


@pytest.mark.cuda
def test_eager_model_with_operator_grads_takes_the_dense_route(cuda):
    """V = 2048, on the tile, but evecs, gradX and gradY require grad: B4
    gives the operators no gradient, so the card's blocks keep the dense
    route (`block.dense` 4 times, no B4 launch), and the operators'
    gradients agree with the CPU's as the parameters' do."""
    import copy
    from diffusionnet_tpu_torch.ops import fused
    model, inputs = _eager_siv_case(2048, n_class=64)
    want = _eager_model_run(torch.device("cpu"), copy.deepcopy(model),
                            inputs, op_grads=True)
    fused.reset_launches()
    got = _eager_model_run(cuda, model, inputs, op_grads=True)
    torch.cuda.synchronize()
    assert got[3] == want[3] == {"block.dense": 4}
    assert fused.LAUNCHES == {"spectral_project": 0, "spectral_apply": 0,
                              "spectral_ds": 0}
    _close("out", got[0], want[0].to(cuda), False)
    assert {"evecs", "gradX", "gradY"} <= set(want[2])
    for name in want[2]:
        _close_l2(name, got[2][name], want[2][name])


@pytest.mark.cuda
def test_eager_model_off_the_tile_takes_the_dense_route_on_the_card(cuda):
    """V = 8000, not a multiple of pallas_tile_v (1024): the card's blocks
    keep the dense route (`block.dense` 4 times, no B4 launch) and agree
    with the CPU's."""
    import copy
    from diffusionnet_tpu_torch.ops import fused
    model, inputs = _eager_siv_case(8000, n_class=64)
    want = _eager_model_run(torch.device("cpu"), copy.deepcopy(model),
                            inputs)
    fused.reset_launches()
    got = _eager_model_run(cuda, model, inputs)
    torch.cuda.synchronize()
    assert got[3] == want[3] == {"block.dense": 4}
    assert fused.LAUNCHES == {"spectral_project": 0, "spectral_apply": 0,
                              "spectral_ds": 0}
    _close("out", got[0], want[0].to(cuda), False)
    for name in want[2]:
        _close_l2(name, got[2][name], want[2][name])


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [None, 4321], ids=["nodrop", "drop"])
def test_megablock_one_matches_plain(cuda, lowp, seed):
    """B3 (projection kernel, xhat_reduce, B1; backward B2 and its partial
    sums) against autograd through `megablock_reference` on the same card:
    the forward and the gradients in x, coefs, A_re, A_im, Ws and bs."""
    base = _block(cuda, lowp, V=1024)[:10]
    g = torch.Generator(device=cuda).manual_seed(6)
    dout = torch.randn(base[0].shape, generator=g, device=cuda).to(
        base[0].dtype)
    res = []
    for k, fn in enumerate((mb.megablock, mb.megablock_reference)):
        args = [[t.clone().requires_grad_(True) for t in a]
                if isinstance(a, list) else
                (a.clone().requires_grad_(True) if i in (0, 5, 6, 7) else a)
                for i, a in enumerate(base)]
        mb.reset_launches()
        if k == 0:
            out = fn(*args, seed or 0, 256, seed is not None)
        else:
            out = fn(*args, seed, 256, lowp)
        (out.float() * dout.float()).sum().backward()
        if k == 0:
            torch.cuda.synchronize()
            assert mb.LAUNCHES == {"megablock_fwd": 1,
                                   "megablock_fwd_xhat": 0, "xhat_reduce": 1,
                                   "megablock_bwd_rows": 1,
                                   "megablock_bwd_grads": 1,
                                   "grad_reduce": 3}
        res.append([out] + [args[i].grad for i in (0, 5, 6, 7)]
                   + [t.grad for t in args[8] + args[9]])
    for k, (a, b) in enumerate(zip(*res)):
        _close(f"output {k}", a, b, lowp)


def _serving_inputs(device, V=200, K=16, c_in=3, seed=5):
    """One surface's signal and operators, seeded (random, not a mesh's:
    this file needs no geometry)."""
    rs = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return (t(rs.randn(V, c_in)), t(rs.rand(V)), t(np.sort(rs.rand(K)) * 10),
            *(t(rs.randn(V, K) / np.sqrt(V)) for _ in range(3)))


@pytest.mark.cuda
def test_serving_artifact_on_the_card(cuda, tmp_path):
    """A fused model (pallas_tile_v 128) exported and loaded on the card:
    each bucket's program holds B4's two ops once a block; __call__ and a
    PreparedMesh agree with the eager model (use_pallas_fused=False) on
    the card within phase 14's tolerance of chip_smoke.py (1e-3), each
    request launches B4's two kernels once a block, and warm requests
    (__call__ with the operators on the card, handle(x) at batch 1 and 3)
    make no host sync (torch.cuda.set_sync_debug_mode("error"))."""
    from diffusionnet_tpu_torch.models import DiffusionNet
    from diffusionnet_tpu_torch.ops import fused
    from diffusionnet_tpu_torch.serving import (export_forward,
                                                load_serving_model)
    from diffusionnet_tpu_torch.serving.export import kernel_ops
    arch = dict(c_in=3, c_out=5, c_width=16, n_block=2, dropout=False)
    d = str(tmp_path / "artifact")
    export_forward(DiffusionNet(**arch, use_pallas_fused=True,
                                pallas_tile_v=128), (256, 512), d, 16,
                   device="cuda")
    sm = load_serving_model(d)
    for ep in sm.programs.values():
        assert kernel_ops(ep) == {"spectral_project": 2, "spectral_apply": 2}
    x, mass, evals, evecs, gX, gY = _serving_inputs(cuda)
    x3 = torch.stack([x, 2 * x, 3 * x])  # three signals on one surface
    plain = DiffusionNet(**arch).to(cuda)
    with torch.no_grad():
        ref = plain(x, mass, evals, evecs, gX, gY)
        ref3 = plain(x3, *(a.expand(3, *a.shape)
                           for a in (mass, evals, evecs, gX, gY)))
    handle = sm.prepare(mass, evals, evecs, gX, gY)
    for fn, want in ((lambda: sm(x, mass, evals, evecs, gX, gY), ref),
                     (lambda: handle(x), ref), (lambda: handle(x3), ref3)):
        fused.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        assert fused.LAUNCHES == {"spectral_project": 2,
                                  "spectral_apply": 2, "spectral_ds": 0}
        torch.testing.assert_close(out, want, rtol=1e-3, atol=1e-3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = (sm(x, mass, evals, evecs, gX, gY), handle(x), handle(x3))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for out, want in zip(outs, (ref, ref, ref3)):
        torch.testing.assert_close(out, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_serving_artifact_traced_on_the_cpu_runs_on_the_card(cuda, tmp_path):
    """Both ends' defaults: a fused model built on the CPU exports a CPU
    artifact (platforms ["cpu"]), and load_serving_model puts it on the
    card (move_to_device_pass). The moved program keeps B4's two ops,
    launches their kernels once a block, and agrees with the eager model
    on the card within 1e-3."""
    import json
    from diffusionnet_tpu_torch.models import DiffusionNet
    from diffusionnet_tpu_torch.ops import fused
    from diffusionnet_tpu_torch.serving import (export_forward,
                                                load_serving_model)
    from diffusionnet_tpu_torch.serving.export import kernel_ops
    arch = dict(c_in=3, c_out=5, c_width=16, n_block=2, dropout=False)
    d = str(tmp_path / "artifact")
    export_forward(DiffusionNet(**arch, use_pallas_fused=True,
                                pallas_tile_v=128), (256,), d, 16)
    with open(f"{d}/manifest.json") as f:
        assert json.load(f)["platforms"] == ["cpu"]
    sm = load_serving_model(d)
    assert sm.device.type == "cuda"
    assert kernel_ops(sm.programs[256]) == {"spectral_project": 2,
                                            "spectral_apply": 2}
    x, mass, evals, evecs, gX, gY = _serving_inputs(cuda)
    x3 = torch.stack([x, 2 * x, 3 * x])
    plain = DiffusionNet(**arch).to(cuda)
    with torch.no_grad():
        ref = plain(x, mass, evals, evecs, gX, gY)
        ref3 = plain(x3, *(a.expand(3, *a.shape)
                           for a in (mass, evals, evecs, gX, gY)))
    handle = sm.prepare(mass, evals, evecs, gX, gY)
    for fn, want in ((lambda: sm(x, mass, evals, evecs, gX, gY), ref),
                     (lambda: handle(x3), ref3)):
        fused.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        assert out.is_cuda
        assert fused.LAUNCHES == {"spectral_project": 2,
                                  "spectral_apply": 2, "spectral_ds": 0}
        torch.testing.assert_close(out, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["icosphere3", "torus"])
def test_heat_device_on_the_card_matches_cpu(cuda, mesh):
    """The device heat method on the card against the same solver on the
    CPU (both f32; cuSOLVER/cuBLAS at full f32 against LAPACK/BLAS):
    within 1e-4 of the diameter, with TF32 allowed by the caller (the
    solver's guard must hold full f32 anyway)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from meshgen import icosphere, torus
    from diffusionnet_tpu_torch.geometry import DeviceHeatMethodSolver
    v, f = icosphere(3) if mesh == "icosphere3" else torus(48, 32)
    src = np.arange(0, v.shape[0], 7)
    want = DeviceHeatMethodSolver(v, f, source_block=256,
                                  device="cpu").distance(src)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = DeviceHeatMethodSolver(v, f, source_block=256,
                                     device=cuda).distance(src)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert np.abs(got - want).max() / want.max() < 1e-4


@pytest.mark.cuda
def test_driver_one_epoch_on_the_card(cuda, tmp_path):
    """The human segmentation driver on its layout (jittered 642-vertex
    icospheres, k 16: past the eigensolver's dense route for small
    meshes) for one epoch with --megakernel on the card: its precompute
    runs B5 (a fresh operator cache), its steps B1 and B2, and its test
    accuracy is a fraction."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from meshgen import icosphere
    from diffusionnet_tpu_torch.experiments import layouts
    from diffusionnet_tpu_torch.experiments.human_segmentation_original \
        import human_segmentation_original as driver
    from diffusionnet_tpu_torch.ops import blocked_ell as be

    def mesh(seed):
        v, f = icosphere(subdivisions=3)
        return v + 0.01 * np.random.RandomState(seed).randn(*v.shape), f
    root = layouts.human_segmentation(str(tmp_path / "seg"),
                                      [mesh(i) for i in range(4)],
                                      [mesh(10), mesh(11)])
    mb.reset_launches()
    be.reset_launches()
    res = driver.main(["--n_epoch", "1", "--k_eig", "16", "--megakernel",
                       "--data_dir", root, "--device", "cuda"])
    torch.cuda.synchronize()
    assert 0.0 <= res["test_acc"] <= 1.0
    assert be.LAUNCHES["blocked_ell"] > 0, be.LAUNCHES
    assert mb.LAUNCHES["megablock_fwd"] > 0, mb.LAUNCHES
    assert mb.LAUNCHES["megablock_bwd_rows"] > 0, mb.LAUNCHES


def _torus_problem():
    """torus(40, 30)'s cotan Laplacian, mass and ELL (numpy)."""
    from diffusionnet_tpu_torch.ops.sparse import ell_from_coo
    L, m = _torus_laplacian(with_mass=True)
    c = L.tocoo()
    return L, m, ell_from_coo(c.row, c.col, c.data, L.shape[0])


def _one_rank_world(backend="nccl"):
    """A world of one process (this one) over a free localhost port."""
    import socket
    from diffusionnet_tpu_torch import parallel
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    parallel.initialize(f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                        backend=backend)


@pytest.mark.cuda
def test_sharded_solver_at_vert_1_is_the_ell_route(cuda):
    """eigensolve_device_sharded over one nccl rank (vert = 1): the same
    start block and reductions as eigensolve_device(banded=False), so the
    same eigenvalues and vectors bit for bit."""
    import torch.distributed as dist
    from diffusionnet_tpu_torch.geometry import eigen
    from diffusionnet_tpu_torch.parallel import make_mesh
    L, m, ell = _torus_problem()
    _one_rank_world()
    try:
        ev_s, vec_s = eigen.eigensolve_device_sharded(
            ell, m.astype(np.float32), 16, make_mesh(vert=1), device="cuda")
    finally:
        dist.destroy_process_group()
    ev, vec = eigen.eigensolve_device(ell, m.astype(np.float32), 16,
                                      banded=False, device="cuda")
    assert torch.equal(ev_s, ev) and torch.equal(vec_s, vec)


@pytest.mark.cuda
def test_fused_sharded_program_launches_b4_on_one_rank(cuda, tmp_path):
    """A fused model's sharded artifact (n_devices 1) on one nccl rank:
    its program holds B4's two ops and the sum between them once a block,
    a request launches B4's two kernels (and xhat_reduce) once a block,
    and the output agrees with the single-card ServingModel of the same
    model."""
    import torch.distributed as dist
    from diffusionnet_tpu_torch.models import DiffusionNet
    from diffusionnet_tpu_torch.ops import fused
    from diffusionnet_tpu_torch.ops import megablock as mb
    from diffusionnet_tpu_torch.parallel import make_mesh
    from diffusionnet_tpu_torch.serving import (
        export_forward, export_sharded_forward, load_serving_model,
        load_sharded_serving_model)
    from diffusionnet_tpu_torch.serving.export import kernel_ops
    model = DiffusionNet(c_in=3, c_out=5, c_width=16, n_block=2,
                         dropout=False, use_pallas_fused=True,
                         pallas_tile_v=128)
    d, single = str(tmp_path / "sharded"), str(tmp_path / "single")
    export_sharded_forward(model, 256, d, 16, n_devices=1, device="cuda")
    export_forward(model, (256,), single, 16, device="cuda")
    x, mass, evals, evecs, gX, gY = _serving_inputs(cuda)
    ref = load_serving_model(single)(x, mass, evals, evecs, gX, gY)
    _one_rank_world()
    try:
        sm = load_sharded_serving_model(d, mesh=make_mesh(vert=1))
        assert kernel_ops(sm.program) == {"spectral_project": 2,
                                          "spectral_apply": 2, "vert_sum": 2}
        torch.cuda.synchronize()
        fused.reset_launches()
        mb.reset_launches()
        out = sm(x, mass, evals, evecs, gX, gY)
        torch.cuda.synchronize()
        assert fused.LAUNCHES == {"spectral_project": 2,
                                  "spectral_apply": 2, "spectral_ds": 0}
        assert mb.LAUNCHES["xhat_reduce"] == 2
    finally:
        dist.destroy_process_group()
    assert out.is_cuda and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("banded", ["dia", True])
def test_band_and_dia_solves_match_b5(cuda, banded):
    """The DIA and dense-band routes on the torus against the B5 route:
    polished eigenvalues within 1e-6 of the largest."""
    from diffusionnet_tpu_torch.geometry import eigen
    from diffusionnet_tpu_torch.ops import blocked_ell as be
    L, m, ell = _torus_problem()
    pol = (L, np.asarray(m, np.float64))
    be.reset_launches()
    ev_b5, _ = eigen.eigensolve_device(ell, m.astype(np.float32), 16,
                                       polish=pol, device="cuda")
    assert be.LAUNCHES["blocked_ell"] > 0
    be.reset_launches()
    ev, _ = eigen.eigensolve_device(ell, m.astype(np.float32), 16,
                                    banded=banded, polish=pol, device="cuda")
    assert be.LAUNCHES["blocked_ell"] == 0
    assert np.abs(ev - ev_b5).max() <= 1e-6 * ev_b5.max()


@pytest.mark.cuda
def test_fmaps_pair_step_at_size_makes_no_sync(cuda, tmp_path):
    """One train step of the correspondence driver's pair batches at the
    fmap_train cell's shapes (8 pairs, 16 shapes of 4,900-5,100 vertices
    padded to 5,120, widths 128, k 128, n_fmap 30; 2 distinct surfaces)
    runs under torch.cuda.set_sync_debug_mode("error"): nothing in the
    batch's gather, the step or the head's solve waits for the card. Its
    loss agrees with the plain reference's on the CPU, from the masks and
    rotations the card drew, within 3e-4 relative, fmap_train's limit:
    f32 sums in other orders (TF32 off), which the extractor amplifies at
    unit-area shapes (the cell's program reads up to 9.7e-5 on the card).
    """
    import importlib.util
    import json
    import os
    import sys
    bench = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                         os.pardir, "benchmark"))
    if bench not in sys.path:
        sys.path.insert(0, bench)
    spec = importlib.util.spec_from_file_location(
        "bench_loop_train_pairs", os.path.join(bench, "loops",
                                               "train_pairs.py"))
    loop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop)
    from reference import fmaps as ref_fm
    from diffusionnet_tpu_torch.experiments.functional_correspondence import \
        functional_correspondence as fc
    from diffusionnet_tpu_torch.models import FunctionalMapCorrespondence
    from diffusionnet_tpu_torch.training import (adam_with_step_decay,
                                                 make_train_step)
    loop.CACHE = tmp_path
    with open(os.path.join(bench, "configs",
                           "fmaps_faust_xyz_c128.json")) as f:
        conf = json.load(f)
    conf["dataset"].update(n_train=16, distinct_surfaces=2)
    m, P = conf["model"], conf["fit"]["batch_pairs"]
    data = loop.Data(conf, 2 ** 31 + 5, cuda)
    assert data.v_pad == 5120

    class Shapes:
        verts_list = data.verts
        ops_list = [data.ops[j] for j in data.bundle_of]
        vts_list = data.vts
        combinations = data.pairs
    feed = fc.PairFeed(
        fc.stack_shapes(Shapes, data.v_pad, data.d_l, data.d_g, m["k_eig"],
                        "xyz", cuda),
        fc.gt_fmap_table(Shapes, m["n_fmap"], cuda), data.pairs, cuda)
    model = FunctionalMapCorrespondence(
        c_in=3, c_out=m["c_out"], c_width=m["c_width"], n_block=m["n_block"],
        n_fmap=m["n_fmap"], lambda_param=m["lambda"]).to(cuda)
    params = {k: v.clone().requires_grad_(True)
              for k, v in data.weights.items()}
    opt = adam_with_step_decay(conf["fit"]["lr"])
    st = opt.init(params)
    step = make_train_step(fc.pair_loss_fn(model), opt)
    order = feed.epoch(0)

    def one(pos, seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return step(params, st, feed.batch(order, pos, P, g), g)
    one(0, 11)  # first use: cuBLAS and cuSOLVER handles, allocations
    torch.cuda.synchronize()
    p0 = {k: v.detach().clone() for k, v in params.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, loss, info = one(P, 12)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int((info != 0).sum()) == 0
    assert loss.shape == () and torch.isfinite(loss)

    pairs = [data.pairs[int(k)] for k in order[P:2 * P].cpu()]
    rows = [a for a, _ in pairs] + [b for _, b in pairs]
    u, keep = ref_fm.draws(12, 2 * P, data.v_pad, m["n_block"],
                           [3 * m["c_width"], *m["mlp_hidden_dims"]], True,
                           cuda)
    R = ref_fm.rotation(u.cpu())
    p = {k: v.cpu() for k, v in p0.items()}
    feats = []
    for r, i in enumerate(rows):
        o = data.ops[data.bundle_of[i]]
        V = o.mass.shape[0]
        t = torch.from_numpy
        feats.append(ref_fm.features(
            p, t(data.verts[i]) @ R[r], t(o.mass), t(o.evals), t(o.evecs),
            ref_fm.sparse(t(o.gradX.idx), t(o.gradX.val), V),
            ref_fm.sparse(t(o.gradY.idx), t(o.gradY.val), V), m["n_block"],
            lambda b, l, nr, w, r=r: keep[b, l][r, :nr].cpu()))
    total = 0.0
    for j, (i1, i2) in enumerate(pairs):
        ox, oy = (data.ops[data.bundle_of[i]] for i in (i1, i2))
        t = torch.from_numpy
        C = ref_fm.fmap(feats[j], feats[P + j], t(ox.evals), t(oy.evals),
                        t(ox.evecs), t(oy.evecs), t(ox.mass), t(oy.mass),
                        m["n_fmap"], m["lambda"])
        gt = ref_fm.gt_map(t(ox.evecs), t(oy.evecs), t(data.vts[i1]),
                           t(data.vts[i2]), m["n_fmap"]).float()
        total = total + torch.mean((C - gt) ** 2)
    want = float(total / P)
    assert abs(float(loss) - want) <= 3e-4 * abs(want), (float(loss), want)
