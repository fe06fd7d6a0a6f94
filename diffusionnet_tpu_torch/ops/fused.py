"""The fused spectral block: the counterpart of
diffusionnet_tpu/ops/pallas_fused.py (kernels B4a and B4b; B4a is B4b at
B = 1). For each surface it computes

    x_hat = Phi^T (m . x)            (spectral projection, mass-weighted)
    s     = coefs . x_hat            (learned per-channel heat diffusion)
    y     = Phi s;  ygx = GX s;  ygy = GY s

with two hand-written kernels (csrc/spectral_fused.cu): `spectral_project`
(x_hat as TN products on a split-V grid, the partials summed by B1's
`xhat_reduce` in a fixed order) and `spectral_apply` (a 64-row wgmma row
kernel writing the three outputs, s staged once per CTA). The projection
kernel is also B3's phase 0 (`ops.megablock.megablock`) and, with three
(operator, cotangent) pairs, the backward's ds = Phi^T dy + GX^T dgx +
GY^T dgy (`spectral_ds`), long-V transposed products that cuBLAS runs on
small tiles (PERF.md, section 5). The rest of the backward (dx = m (.)
Phi (ds (.) coefs), dcoefs) is plain torch, as the JAX VJP (`_bwd_b`) is
plain einsums; evecs, gX, gY and mass get no gradient.

Dispatch: the three entry points are registered operators
(dnt_torch::spectral_project, ::spectral_apply, ::spectral_ds; see "The
registered operators" below). Tensors on the CPU go to the plain PyTorch
versions (`spectral_project_reference`, `spectral_apply_reference`,
`spectral_ds_reference`); tensors on a CUDA device go to the kernels or
raise. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from .megablock import (SLOT, _cdt, _mm, _mm_t, _raise_on, _sm_count,
                        megablock_fwd_xhat_reference, reduce_pieces,
                        xhat_reduce_reference, xhat_splits)

DEFAULT_TILE_V = 1024

# launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel, and nowhere else (spectral_ds launches the
# projection's kernel with three pairs; the x_hat partial sums count in
# ops.megablock.LAUNCHES["xhat_reduce"])
LAUNCHES = {"spectral_project": 0, "spectral_apply": 0, "spectral_ds": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_tile(V: int, tile_v: int) -> None:
    if V % tile_v:
        raise ValueError(f"V={V} must be a multiple of tile_v={tile_v} "
                         "(pad to a bucket)")


def _check(cond: bool, msg) -> None:
    """Raise ValueError unless cond. msg: the message, or a function that
    makes it: the wrappers' messages are formatted only on failure (their
    formatting cost more host time than the launches)."""
    if not cond:
        raise ValueError("spectral_fused: " + (msg() if callable(msg)
                                               else msg))


def _device_of(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    _check(len(devices) == 1,
           lambda: f"tensors on several devices: {devices}")
    dev = devices.pop()
    _check(dev.type in ("cpu", "cuda"), lambda: f"unsupported device {dev}")
    return dev


def project_splits(B: int, V: int, K: int, C: int,
                   device: torch.device) -> tuple:
    """(S, L): the V ranges the projection's kernel takes on `device`, a
    card (`xhat_splits` for its SMs); one range (1, V) on the CPU."""
    if device.type == "cpu":
        return 1, V
    return xhat_splits(B, V, K, C, _sm_count(device.index or 0))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' references)
# ---------------------------------------------------------------------------

def spectral_project_reference(x, evecs, mass, lowp: bool = False,
                               splits=None):
    """x_hat = Phi^T (m x) summed as the kernel sums it: x (..., V, C),
    evecs (..., V, K), mass (..., V) -> (..., K, C) f32, the split-V
    kernel's plain version (partials over the V ranges `splits`, by default
    `project_splits`: the card's for CUDA tensors, one range on the CPU,
    then their fixed-order sum). m x is taken in f32; with
    lowp both operands are rounded to bf16 first. f64 inputs: one plain f64
    product."""
    if _cdt(x, evecs, mass) == torch.float64:
        return _mm_t(evecs, x.double() * mass[..., None].double(), lowp)
    if x.ndim == 2:
        return spectral_project_reference(x[None], evecs[None], mass[None],
                                          lowp, splits)[0]
    B, V, C = x.shape
    K = evecs.shape[-1]
    if splits is None:
        splits = project_splits(B, V, K, C, x.device)
    part = megablock_fwd_xhat_reference(evecs, x, mass, splits, lowp)
    return reduce_pieces(part, B, K, C, xhat_reduce_reference)


def spectral_ds_reference(evecs, gX, gY, dy, dgx, dgy, splits=None):
    """ds = Phi^T dy + GX^T dgx + GY^T dgy (B, K, C) f32 summed as the
    kernel sums it: per V range of `splits` (default `project_splits`) the
    three products' partials added, then the fixed-order sum over the
    ranges. f64 inputs: plain f64 products."""
    pairs = ((evecs, dy), (gX, dgx), (gY, dgy))
    if _cdt(evecs, dy) == torch.float64:
        return sum(_mm_t(op.double(), d.double(), False) for op, d in pairs)
    B, V, K = evecs.shape
    C = dy.shape[-1]
    if splits is None:
        splits = project_splits(B, V, K, C, dy.device)
    part = sum(megablock_fwd_xhat_reference(op, d, None, splits)
               for op, d in pairs)
    return reduce_pieces(part, B, K, C, xhat_reduce_reference)


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


def _split_products(ops, srcs, mass, lowp: bool, what: str) -> torch.Tensor:
    """sum_t ops[t]^T (mass (.) srcs[t]) (B, K, C) f32 on the card: the
    split-V kernel's partials (one launch, counted under `what`), then
    `xhat_reduce`. ops (B,V,K), one dtype; srcs (B,V,C), one dtype
    (each f32 or bf16); mass (B,V) f32 or None."""
    ts = [*ops, *srcs] + ([] if mass is None else [mass])
    dev = _device_of(ts)
    B, V, K = ops[0].shape
    C = srcs[0].shape[-1]
    _check(all(t.shape == ops[0].shape and t.dtype == ops[0].dtype
               for t in ops) and all(t.shape == (B, V, C)
                                     and t.dtype == srcs[0].dtype
                                     for t in srcs),
           what + ": shapes or dtypes of the operands differ")
    _check(mass is None or (tuple(mass.shape) == (B, V)
                            and mass.dtype == torch.float32),
           what + ": mass must be f32 (B,V)")
    _check(ops[0].dtype in _FLOATS and srcs[0].dtype in _FLOATS,
           lambda: f"{what}: dtypes {ops[0].dtype}, {srcs[0].dtype}")
    _check(all(t.is_contiguous() for t in ts),
           what + ": inputs must be contiguous")
    _check(K >= 1 and C >= 1 and V >= 1,
           lambda: f"empty shape V={V} K={K} C={C}")
    S, L = project_splits(B, V, K, C, dev)
    part = torch.empty((B, -(-K // SLOT), -(-C // SLOT), S, SLOT, SLOT),
                       dtype=torch.float32, device=dev)
    n = len(ops)
    a = [t.data_ptr() for t in ops] + [None] * (3 - n)
    b = [t.data_ptr() for t in srcs] + [None] * (3 - n)
    from .. import _build
    lib = _build.load()
    bf16 = torch.bfloat16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sf_project_launch(
            *a, *b, n, None if mass is None else mass.data_ptr(),
            part.data_ptr(), B, V, K, C, S, L, int(ops[0].dtype == bf16),
            int(srcs[0].dtype == bf16), int(lowp), stream)
    _raise_on(lib, code, f"{what} launch")
    LAUNCHES[what] += 1
    return reduce_pieces(part, B, K, C)


Tensor = torch.Tensor


def _project_cuda(x: Tensor, evecs: Tensor, mass: Tensor,
                  lowp: bool) -> Tensor:
    _check(x.ndim == 3 and evecs.ndim == 3 and mass.ndim == 2
           and evecs.shape[:2] == x.shape[:2],
           lambda: f"x (B,V,C), evecs (B,V,K), mass (B,V): shapes "
           f"{tuple(x.shape)}, {tuple(evecs.shape)}, {tuple(mass.shape)}")
    return _split_products([evecs], [x], mass, lowp, "spectral_project")


def _ds_cuda(evecs: Tensor, gX: Tensor, gY: Tensor, dy: Tensor, dgx: Tensor,
             dgy: Tensor) -> Tensor:
    _check(evecs.ndim == 3 and dy.ndim == 3
           and evecs.shape[:2] == dy.shape[:2],
           lambda: f"operators (B,V,K), cotangents (B,V,C): "
           f"{tuple(evecs.shape)}, {tuple(dy.shape)}")
    return _split_products([evecs, gX, gY], [t.contiguous() for t in
                                             (dy, dgx, dgy)], None, False,
                           "spectral_ds")


def _apply_cuda(x_hat: Tensor, coefs: Tensor, evecs: Tensor, gX: Tensor,
                gY: Tensor, out_dtype: torch.dtype
                ) -> tuple[Tensor, Tensor, Tensor]:
    dev = x_hat.device
    _check(evecs.ndim == 3, "evecs must be (B,V,K)")
    B, V, K = evecs.shape
    C = x_hat.shape[-1]
    for name, t, shape, dtypes in (
            ("x_hat", x_hat, (B, K, C), (torch.float32,)),
            ("coefs", coefs, (B, K, C), (torch.float32,)),
            ("gX", gX, (B, V, K), (evecs.dtype,)),
            ("gY", gY, (B, V, K), (evecs.dtype,)),
            ("evecs", evecs, (B, V, K), _FLOATS)):
        _check(tuple(t.shape) == shape,
               lambda: f"{name} shape {tuple(t.shape)} != {shape}")
        _check(t.dtype in dtypes, lambda: f"{name} dtype {t.dtype}")
        _check(t.is_contiguous(), lambda: f"{name} must be contiguous")
    _check(out_dtype in _FLOATS, lambda: f"out dtype {out_dtype}")
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
            int(out_dtype == torch.bfloat16), _sm_count(dev.index or 0),
            stream)
    _raise_on(lib, code, "spectral_apply launch")
    LAUNCHES["spectral_apply"] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# The registered operators
# ---------------------------------------------------------------------------
# The three entry points are custom operators of the namespace `dnt_torch`
# (schemas from the CUDA functions' annotations): the dispatcher sends CUDA
# tensors to the kernels above and CPU tensors to the plain versions, and
# torch.export keeps each call as one node of its graph (the serving
# artifacts carry them), with the shapes that the op's fake gives. What the
# kernels read of B and of the card (`project_splits`) is read only when
# they run, never in a trace. They are defined with torch.library.Library,
# not torch.library.custom_op: the blocks call the ops from inside their
# own autograd Function, so the ops need no autograd layer of their own,
# and Library registers plain dispatcher kernels without one.

OPS_NAMESPACE = "dnt_torch"
_LIB = torch.library.Library(OPS_NAMESPACE, "DEF")


def _op(name: str, cuda_fn, cpu_fn):
    _LIB.define(name + torch.library.infer_schema(cuda_fn, mutates_args=()))
    _LIB.impl(name, cuda_fn, "CUDA")
    _LIB.impl(name, cpu_fn, "CPU")
    return getattr(getattr(torch.ops, OPS_NAMESPACE), name).default


_project_op = _op("spectral_project", _project_cuda,
                  spectral_project_reference)
_ds_op = _op("spectral_ds", _ds_cuda, spectral_ds_reference)
_apply_op = _op("spectral_apply", _apply_cuda, spectral_apply_reference)


def _same_sizes(a, b, what: str) -> None:
    for i, (m, n) in enumerate(zip(a, b)):
        torch._check(m == n, lambda: f"spectral_fused: {what}: size {i} "
                     f"{m} != {n}")


@torch.library.register_fake(_project_op, lib=_LIB)
def _(x, evecs, mass, lowp):
    _same_sizes(x.shape[:-1], evecs.shape[:-1], "x and evecs")
    _same_sizes(x.shape[:-1], mass.shape, "x and mass")
    return x.new_empty((*x.shape[:-2], evecs.shape[-1], x.shape[-1]),
                       dtype=_cdt(x, evecs, mass))


@torch.library.register_fake(_ds_op, lib=_LIB)
def _(evecs, gX, gY, dy, dgx, dgy):
    for op in (gX, gY):
        _same_sizes(op.shape, evecs.shape, "operators")
    for d in (dy, dgx, dgy):
        _same_sizes(d.shape[:-1], evecs.shape[:-1], "cotangents")
    return dy.new_empty((*evecs.shape[:-2], evecs.shape[-1], dy.shape[-1]),
                        dtype=_cdt(evecs, dy))


@torch.library.register_fake(_apply_op, lib=_LIB)
def _(x_hat, coefs, evecs, gX, gY, out_dtype):
    _same_sizes(coefs.shape, x_hat.shape, "coefs and x_hat")
    for op in (gX, gY):
        _same_sizes(op.shape, evecs.shape, "operators")
    _same_sizes(x_hat.shape[:-2], evecs.shape[:-2], "batch")
    _same_sizes(x_hat.shape[-2:-1], evecs.shape[-1:], "K")
    shape = (*evecs.shape[:-1], x_hat.shape[-1])
    return tuple(evecs.new_empty(shape, dtype=out_dtype) for _ in range(3))


def spectral_project(x, evecs, mass, lowp: bool = False) -> torch.Tensor:
    """x_hat (B, K, C) f32 of x (B,V,C), evecs (B,V,K) (each f32 or bf16)
    and mass (B,V) f32: the kernel and `xhat_reduce` for CUDA tensors, the
    plain version for CPU tensors (the op dnt_torch::spectral_project)."""
    _device_of([x, evecs, mass])
    return _project_op(x, evecs, mass, lowp)


def spectral_ds(evecs, gX, gY, dy, dgx, dgy) -> torch.Tensor:
    """B4's backward ds = Phi^T dy + GX^T dgx + GY^T dgy (B, K, C) f32:
    the projection's kernel with three (operator, cotangent) pairs and no
    scale, then `xhat_reduce`, for CUDA tensors; the plain version for CPU
    tensors (the op dnt_torch::spectral_ds)."""
    _device_of((evecs, gX, gY, dy, dgx, dgy))
    return _ds_op(evecs, gX, gY, dy, dgx, dgy)


def spectral_apply(x_hat, coefs, evecs, gX, gY, out_dtype):
    """(Phi s, GX s, GY s) with s = coefs x_hat, in out_dtype (f32 or bf16):
    the kernel for CUDA tensors, the plain version for CPU tensors (the op
    dnt_torch::spectral_apply). x_hat, coefs (B,K,C) f32; evecs, gX, gY
    (B,V,K), one dtype, f32 or bf16."""
    _device_of([x_hat, coefs, evecs, gX, gY])
    return _apply_op(x_hat, coefs, evecs, gX, gY, out_dtype)


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
    the projection). Backward (`_bwd_b`): ds on the projection's kernel
    (`spectral_ds`), dx and dcoefs plain matmuls."""

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
        ds = spectral_ds(evecs, gX, gY, dy, dgx, dgy)
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
