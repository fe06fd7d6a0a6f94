"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need a CUDA card (marker `cuda`) and skip without one. The file
imports neither jax nor the JAX package, so it runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.ops import megablock as mb

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
    assert mb.LAUNCHES == {"megablock_fwd": 1, "xhat_reduce": int(emit_next)}
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
    """Wrong dtype, non-contiguous input, widths past the kernel's bounds:
    the wrapper raises before launching."""
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
    big = _block(cuda, False, V=64, K=256, C=8, hidden=(8,))
    with pytest.raises(ValueError, match="K, C <= 128"):
        mb.megablock_chained(*big)
    assert mb.LAUNCHES == {"megablock_fwd": 0, "xhat_reduce": 0}
