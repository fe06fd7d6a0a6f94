"""Whole-DiffusionNet-block forward, chained form: the counterpart of
diffusionnet_tpu/ops/pallas_megablock.py::megablock_chained (kernel B1).

Given this block's x_hat = Phi^T (m x), one call computes

    s     = coefs . x_hat
    xd    = Phi s;   gx = GX s;   gy = GY s
    vb_re = gx A_re - gy A_im;  vb_im = gy A_re + gx A_im
    feat  = tanh(gx . vb_re + gy . vb_im)
    out   = MLP([x, xd, feat]) + x

and, with emit_next, the next block's x_hat = Phi^T (m out).

Dispatch: tensors on the CPU go to `megablock_chained_reference`, the plain
PyTorch version; tensors on a CUDA device go to the hand-written kernel
(csrc/megablock_fwd.cu) or raise. There is no fallback between the two.

lowp (bf16 operands) is an argument: both operands of every product are
rounded to bf16 and accumulated in f32, as the TPU kernel's `_dot` does.
Dropout in the kernel comes with the training slice (ROADMAP item A.3).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel, and nowhere else
LAUNCHES = {"megablock_fwd": 0, "xhat_reduce": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _mm(a, b, lowp: bool):
    """a @ b in f32; with lowp both operands are first rounded to bf16 (the
    products of bf16 values are exact in f32, so this is bf16 operands with
    f32 accumulation)."""
    if lowp:
        return _round_bf16(a) @ _round_bf16(b)
    return a.float() @ b.float()


def megablock_chained_reference(x, evecs, gX, gY, mass, coefs, A_re, A_im,
                                Ws, bs, x_hat_in, emit_next: bool = True,
                                lowp: bool = False):
    """Plain PyTorch version of B1, with the kernel's casts.
    Returns (out in x's dtype, x_hat_next f32 or None)."""
    s = coefs * x_hat_in
    xf = x.float()
    xd = _mm(evecs, s, lowp)
    gx = _mm(gX, s, lowp)
    gy = _mm(gY, s, lowp)
    vb_re = _mm(gx, A_re, lowp) - _mm(gy, A_im, lowp)
    vb_im = _mm(gy, A_re, lowp) + _mm(gx, A_im, lowp)
    feat = torch.tanh(gx * vb_re + gy * vb_im)
    h = torch.cat([xf, xd, feat], dim=-1)
    n = len(Ws)
    for l, (W, b) in enumerate(zip(Ws, bs)):
        h = _mm(h, W, lowp) + b
        if l < n - 1:
            h = torch.relu(h)
    out = xf + h
    x_hat_next = None
    if emit_next:
        x_hat_next = _mm(evecs.transpose(-1, -2), out * mass[..., None], lowp)
    return out.to(x.dtype), x_hat_next


def xhat_reduce_reference(partial: torch.Tensor, K: int, C: int
                          ) -> torch.Tensor:
    """Plain version of the partial-sum kernel: the (K, C) corners of the
    per-CTA slots (B, S, SLOT, SLOT), summed in the kernel's order s = 0, 1,
    ... -> (B, K, C)."""
    out = partial[:, 0, :K, :C].clone()
    for s in range(1, partial.shape[1]):
        out += partial[:, s, :K, :C]
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError("megablock_chained: " + msg)


def _device_of(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    _check(len(devices) == 1, f"tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"megablock_chained: unsupported device {dev}")
    return dev


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: "
                           + lib.mb_error_string(code).decode())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nsplit(dev: torch.device, B: int, n_tiles: int) -> int:
    """CTAs per batch element: about one wave over the SMs (the kernel runs
    one CTA per SM), never more than the row tiles."""
    return max(1, min(n_tiles, _sm_count(dev.index) // B))


TILE_ROWS = 32  # the kernel's row tile (TV in csrc/megablock_fwd.cu)
SLOT = 128      # side of a CTA's x_hat partial slot (MAX_KC there)


def xhat_reduce(partial: torch.Tensor, K: int, C: int) -> torch.Tensor:
    """Sum per-CTA x_hat partials, slots (B, S, SLOT, SLOT) of which the
    (K, C) corner is used, -> (B, K, C) in a fixed order."""
    if partial.device.type == "cpu":
        return xhat_reduce_reference(partial, K, C)
    _check(partial.device.type == "cuda", f"unsupported device {partial.device}")
    _check(partial.dtype == torch.float32 and partial.ndim == 4
           and partial.shape[2:] == (SLOT, SLOT) and partial.is_contiguous(),
           f"partial must be contiguous f32 (B,S,{SLOT},{SLOT})")
    _check(1 <= K <= SLOT and 1 <= C <= SLOT, f"K={K}, C={C} past {SLOT}")
    from .. import _build
    lib = _build.load()
    B, S = partial.shape[:2]
    out = torch.empty((B, K, C), dtype=torch.float32, device=partial.device)
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mb_xhat_reduce_launch(partial.data_ptr(), out.data_ptr(),
                                         B, S, K, C, stream)
    _raise_on(lib, code, "xhat_reduce launch")
    LAUNCHES["xhat_reduce"] += 1
    return out


def _weight_layout(W: torch.Tensor) -> torch.Tensor:
    """W (k, n) as the kernel reads its weights from global memory: rows 32-byte
    aligned, zero rows up to a multiple of 8 and columns up to one of 16. W
    itself where it already is so (every width a multiple of 16), else a
    zero-padded copy."""
    k, n = W.shape
    kp, np_ = -(-k // 8) * 8, -(-n // 16) * 16
    if (kp, np_) == (k, n) and W.data_ptr() % 32 == 0:
        return W
    out = W.new_zeros((kp, np_))
    out[:k, :n] = W
    return out


def megablock_chained(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                      x_hat_in, emit_next: bool = True, lowp: bool = False):
    """One whole DiffusionNet block for a batch of surfaces, forward only.

    x (B,V,C) f32 or bf16; evecs/gX/gY (B,V,K) f32 or bf16 (one dtype);
    mass (B,V) f32; coefs (B,K,C) f32; A_re/A_im (C,C) f32; Ws/bs the MLP's
    (w_in, w_out) kernels and (w_out,) biases, f32, first input 3C, last
    output C; x_hat_in (B,K,C) f32.
    Returns (out (B,V,C) in x's dtype, x_hat_next (B,K,C) f32 or None)."""
    Ws, bs = tuple(Ws), tuple(bs)
    dev = _device_of([x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat_in,
                      *Ws, *bs])
    if dev.type == "cpu":
        return megablock_chained_reference(x, evecs, gX, gY, mass, coefs,
                                           A_re, A_im, Ws, bs, x_hat_in,
                                           emit_next, lowp)
    return _megablock_chained_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im,
                                   Ws, bs, x_hat_in, emit_next, lowp)


def _megablock_chained_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws,
                            bs, x_hat_in, emit_next, lowp):
    f32, bf16 = torch.float32, torch.bfloat16
    _check(x.ndim == 3, "x must be (B,V,C)")
    B, V, C = x.shape
    _check(evecs.ndim == 3 and evecs.shape[:2] == (B, V),
           "evecs must be (B,V,K)")
    K = evecs.shape[-1]
    _check(x.dtype in (f32, bf16), f"x dtype {x.dtype}")
    _check(evecs.dtype in (f32, bf16), f"evecs dtype {evecs.dtype}")
    for name, t, shape, dtype in (
            ("gX", gX, (B, V, K), evecs.dtype),
            ("gY", gY, (B, V, K), evecs.dtype),
            ("mass", mass, (B, V), f32),
            ("coefs", coefs, (B, K, C), f32),
            ("A_re", A_re, (C, C), f32),
            ("A_im", A_im, (C, C), f32),
            ("x_hat_in", x_hat_in, (B, K, C), f32)):
        _check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        _check(t.dtype == dtype, f"{name} dtype {t.dtype} != {dtype}")
    n_dense = len(Ws)
    _check(n_dense == len(bs) and n_dense >= 1, "need matching Ws and bs")
    widths = [W.shape[0] for W in Ws] + [Ws[-1].shape[1]]
    _check(widths[0] == 3 * C and widths[-1] == C,
           f"MLP widths {widths} must run 3C -> ... -> C")
    for l, (W, b) in enumerate(zip(Ws, bs)):
        _check(tuple(W.shape) == (widths[l], widths[l + 1])
               and tuple(b.shape) == (widths[l + 1],),
               f"layer {l}: W {tuple(W.shape)}, b {tuple(b.shape)}")
        _check(W.dtype == f32 and b.dtype == f32, f"layer {l} dtype")
    tensors = [x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat_in, *Ws, *bs]
    _check(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _check(K <= 128 and C <= 128 and n_dense <= 8 and max(widths) <= 512,
           f"kernel supports K, C <= 128, <= 8 layers, widths <= 512 "
           f"(got K={K}, C={C}, widths={widths})")

    from .. import _build
    lib = _build.load()
    dev = x.device
    out = torch.empty_like(x)
    n_tiles = -(-V // TILE_ROWS)
    nsplit = _nsplit(dev, B, n_tiles)
    partial = (torch.empty((B, nsplit, SLOT, SLOT), dtype=f32, device=dev)
               if emit_next else None)
    # the complex map as one product: [vb_re | vb_im] = [gx | gy] cmap
    cmap = _weight_layout(torch.cat((torch.cat((A_re, A_im), 1),
                                     torch.cat((-A_im, A_re), 1))))
    Wk = [_weight_layout(W) for W in Ws]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ws = (vp * n_dense)(*[W.data_ptr() for W in Wk])
    ldw = (ci * n_dense)(*[W.shape[1] for W in Wk])
    bsp = (vp * n_dense)(*[b.data_ptr() for b in bs])
    wid = (ci * (n_dense + 1))(*widths)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mb_fwd_launch(
            x.data_ptr(), evecs.data_ptr(), gX.data_ptr(), gY.data_ptr(),
            mass.data_ptr(), coefs.data_ptr(), cmap.data_ptr(),
            cmap.shape[1], ws, ldw, bsp, wid, n_dense, x_hat_in.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            B, V, K, C, nsplit, int(x.dtype == bf16),
            int(evecs.dtype == bf16), int(lowp), stream)
    _raise_on(lib, code, "megablock_fwd launch")
    LAUNCHES["megablock_fwd"] += 1
    if not emit_next:
        return out, None
    return out, xhat_reduce(partial, K, C)
