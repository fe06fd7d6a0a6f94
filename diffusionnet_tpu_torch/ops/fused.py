"""The fused spectral block: the counterpart of
diffusionnet_tpu/ops/pallas_fused.py (kernels B4a and B4b; B4a is B4b at
B = 1). For each surface it computes

    x_hat = Phi^T (m . x)            (spectral projection, mass-weighted)
    s     = coefs . x_hat            (learned per-channel heat diffusion)
    y     = Phi s;  ygx = GX s;  ygy = GY s

with two hand-written kernels (csrc/spectral_fused.cu): `spectral_project`
(x_hat through per-CTA slots summed by B1's `xhat_reduce`) and
`spectral_apply` (the three outputs). The projection kernel is also B3's
phase 0 (`ops.megablock.megablock`).

Dispatch: tensors on the CPU go to the plain PyTorch versions
(`spectral_project_reference`, `spectral_apply_reference`); tensors on a
CUDA device go to the kernels or raise. There is no fallback between the
two. The backward is plain torch matmuls, as the JAX VJP is plain einsums
(`_bwd_b`); evecs, gX, gY and mass get no gradient.
"""

from __future__ import annotations

import torch

from .megablock import (SLOT, _cdt, _mm, _mm_t, _nsplit, _raise_on,
                        reduce_pieces)

DEFAULT_TILE_V = 1024

# launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel, and nowhere else (the x_hat partial sums
# count in ops.megablock.LAUNCHES["xhat_reduce"])
LAUNCHES = {"spectral_project": 0, "spectral_apply": 0}

PROJECT_ROWS = 32  # spectral_project's row tile (PR in the source)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_tile(V: int, tile_v: int) -> None:
    if V % tile_v:
        raise ValueError(f"V={V} must be a multiple of tile_v={tile_v} "
                         "(pad to a bucket)")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError("spectral_fused: " + msg)


def _device_of(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    _check(len(devices) == 1, f"tensors on several devices: {devices}")
    dev = devices.pop()
    _check(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' references)
# ---------------------------------------------------------------------------

def spectral_project_reference(x, evecs, mass, lowp: bool = False):
    """x_hat = Phi^T (m x): x (..., V, C), evecs (..., V, K), mass (..., V)
    -> (..., K, C) in f32 (f64 for f64 inputs). m x is taken in f32; with
    lowp both operands are rounded to bf16 first."""
    dt = _cdt(x, evecs)
    xm = x.to(dt) * mass[..., None].to(dt)
    return _mm_t(evecs, xm, lowp)


def spectral_apply_reference(x_hat, coefs, evecs, gX, gY, out_dtype):
    """s = coefs x_hat; (Phi s, GX s, GY s) in out_dtype, accumulated in
    f32 (f64 for f64 inputs)."""
    s = coefs.to(_cdt(coefs, x_hat)) * x_hat
    return tuple(_mm(op, s, False).to(out_dtype) for op in (evecs, gX, gY))


def fused_spectral_block_reference(x, evecs, gX, gY, mass, coefs):
    """The whole function in plain torch, batched or not: (y, ygx, ygy) in
    x's dtype."""
    return spectral_apply_reference(spectral_project_reference(x, evecs, mass),
                                    coefs, evecs, gX, gY, x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_FLOATS = (torch.float32, torch.bfloat16)


def _pieces(n: int) -> int:
    return -(-n // SLOT)


def spectral_project(x, evecs, mass, lowp: bool = False) -> torch.Tensor:
    """x_hat (B, K, C) f32 of x (B,V,C), evecs (B,V,K) (each f32 or bf16)
    and mass (B,V) f32: the kernel and `xhat_reduce` for CUDA tensors, the
    plain version for CPU tensors."""
    dev = _device_of([x, evecs, mass])
    if dev.type == "cpu":
        return spectral_project_reference(x, evecs, mass, lowp)
    _check(x.ndim == 3 and evecs.ndim == 3 and mass.ndim == 2,
           "x (B,V,C), evecs (B,V,K), mass (B,V)")
    B, V, C = x.shape
    K = evecs.shape[-1]
    _check(evecs.shape[:2] == (B, V) and tuple(mass.shape) == (B, V),
           f"shapes x {tuple(x.shape)}, evecs {tuple(evecs.shape)}, "
           f"mass {tuple(mass.shape)}")
    _check(x.dtype in _FLOATS and evecs.dtype in _FLOATS
           and mass.dtype == torch.float32,
           f"dtypes x {x.dtype}, evecs {evecs.dtype}, mass {mass.dtype}")
    _check(x.is_contiguous() and evecs.is_contiguous()
           and mass.is_contiguous(), "inputs must be contiguous")
    _check(K >= 1 and C >= 1 and V >= 1, f"empty shape V={V} K={K} C={C}")
    nkt, nct = _pieces(K), _pieces(C)
    groups = B * nkt * nct
    nsplit = _nsplit(dev, groups, -(-V // PROJECT_ROWS))
    partial = torch.empty((groups, nsplit, SLOT, SLOT), dtype=torch.float32,
                          device=dev)
    from .. import _build
    lib = _build.load()
    bf16 = torch.bfloat16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sf_project_launch(
            x.data_ptr(), evecs.data_ptr(), mass.data_ptr(),
            partial.data_ptr(), B, V, K, C, nsplit, int(x.dtype == bf16),
            int(evecs.dtype == bf16), int(lowp), stream)
    _raise_on(lib, code, "spectral_project launch")
    LAUNCHES["spectral_project"] += 1
    # one slot per (b, 128-row piece of K, 128-column piece of C)
    return reduce_pieces(partial, B, K, C)


def spectral_apply(x_hat, coefs, evecs, gX, gY, out_dtype):
    """(Phi s, GX s, GY s) with s = coefs x_hat, in out_dtype (f32 or bf16):
    the kernel for CUDA tensors, the plain version for CPU tensors. x_hat,
    coefs (B,K,C) f32; evecs, gX, gY (B,V,K), one dtype, f32 or bf16."""
    dev = _device_of([x_hat, coefs, evecs, gX, gY])
    if dev.type == "cpu":
        return spectral_apply_reference(x_hat, coefs, evecs, gX, gY,
                                        out_dtype)
    _check(evecs.ndim == 3, "evecs must be (B,V,K)")
    B, V, K = evecs.shape
    C = x_hat.shape[-1]
    for name, t, shape, dtypes in (
            ("x_hat", x_hat, (B, K, C), (torch.float32,)),
            ("coefs", coefs, (B, K, C), (torch.float32,)),
            ("gX", gX, (B, V, K), (evecs.dtype,)),
            ("gY", gY, (B, V, K), (evecs.dtype,)),
            ("evecs", evecs, (B, V, K), _FLOATS)):
        _check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != "
               f"{shape}")
        _check(t.dtype in dtypes, f"{name} dtype {t.dtype}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(out_dtype in _FLOATS, f"out dtype {out_dtype}")
    outs = [torch.empty((B, V, C), dtype=out_dtype, device=dev)
            for _ in range(3)]
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sf_apply_launch(
            x_hat.data_ptr(), coefs.data_ptr(), evecs.data_ptr(),
            gX.data_ptr(), gY.data_ptr(), *(o.data_ptr() for o in outs),
            B, V, K, C, int(evecs.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    _raise_on(lib, code, "spectral_apply launch")
    LAUNCHES["spectral_apply"] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# The autograd Function and the JAX package's two entry points
# ---------------------------------------------------------------------------

def spectral_chain_vjp(ds, x_hat, coefs, evecs, mass, x_dtype,
                       dx_direct=None):
    """The VJP of s = coefs (.) x_hat with x_hat = Phi^T (m x), given ds:
    dcoefs = ds (.) x_hat and dx = m (.) Phi (ds (.) coefs), plus dx_direct
    (what x receives past the projection) if given; dx in x_dtype."""
    dt = _cdt(ds, x_hat, coefs)
    dx = mass[..., None].to(dt) * (evecs.to(dt) @ (ds * coefs).to(dt))
    if dx_direct is not None:
        dx = dx_direct.to(dt) + dx
    return dx.to(x_dtype), (ds * x_hat).to(coefs.dtype)


class _FusedSpectralBlock(torch.autograd.Function):
    """Forward: the two kernels (x_hat kept as the residual, straight from
    the projection). Backward: plain matmuls (`_bwd_b`)."""

    @staticmethod
    def forward(ctx, x, evecs, gX, gY, mass, coefs):
        x_hat = spectral_project(x, evecs, mass)
        outs = spectral_apply(x_hat, coefs, evecs, gX, gY, x.dtype)
        ctx.save_for_backward(evecs, gX, gY, mass, coefs, x_hat)
        ctx.x_dtype = x.dtype
        return outs

    @staticmethod
    def backward(ctx, dy, dgx, dgy):
        evecs, gX, gY, mass, coefs, x_hat = ctx.saved_tensors
        dt = _cdt(coefs, x_hat)
        # ds = Phi^T dy + GX^T dgx + GY^T dgy
        ds = sum(op.to(dt).transpose(-1, -2) @ d.to(dt)
                 for op, d in ((evecs, dy), (gX, dgx), (gY, dgy)))
        dx, dcoefs = spectral_chain_vjp(ds, x_hat, coefs, evecs, mass,
                                        ctx.x_dtype)
        return dx, None, None, None, None, dcoefs


def fused_spectral_block_batched(x, evecs, gX, gY, mass, coefs,
                                 tile_v: int = DEFAULT_TILE_V):
    """(y, ygx, ygy) for a batch: x (B,V,C) f32 or bf16; evecs, gX, gY
    (B,V,K); mass (B,V); coefs (B,K,C). Outputs in x's dtype. V must be a
    multiple of tile_v, the JAX kernel's row tile (the CUDA kernels pick
    their own and mask the ragged edge). Differentiable in x and coefs."""
    _check_tile(x.shape[-2], tile_v)
    return _FusedSpectralBlock.apply(x, evecs, gX, gY, mass, coefs)


def fused_spectral_block(x, evecs, gX, gY, mass, coefs,
                         tile_v: int = DEFAULT_TILE_V):
    """(y, ygx, ygy) for ONE surface: x (V,C); evecs/gX/gY (V,K); mass
    (V,); coefs (K,C): the batched form at B = 1."""
    _check_tile(x.shape[-2], tile_v)
    outs = _FusedSpectralBlock.apply(x[None], evecs[None], gX[None],
                                     gY[None], mass[None], coefs[None])
    return tuple(o[0] for o in outs)
