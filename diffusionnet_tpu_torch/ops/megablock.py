"""Whole-DiffusionNet-block kernels: the counterparts of
diffusionnet_tpu/ops/pallas_megablock.py::megablock_chained (forward kernel
B1, backward kernel B2) and of its `megablock` (B3: the projection kernel of
ops/fused.py, then B1 without emit_next; backward B2, see the end of this
module).

Given this block's x_hat = Phi^T (m x), the forward computes

    s     = coefs . x_hat
    xd    = Phi s;   gx = GX s;   gy = GY s
    vb_re = gx A_re - gy A_im;  vb_im = gy A_re + gx A_im
    feat  = tanh(gx . vb_re + gy . vb_im)
    out   = MLP([x, xd, feat]) + x     (Dense, [Dropout]-ReLU-Dense, ...)

and, with emit_next, the next block's x_hat = Phi^T (m out). The backward
recomputes the forward per row tile and returns (dx_direct, ds, dA_re,
dA_im, dW_l, db_l); `megablock_chained` wraps both in a
torch.autograd.Function.

Dispatch: tensors on the CPU go to the plain PyTorch versions
(`megablock_chained_reference`, `megablock_chained_bwd_reference`); tensors
on a CUDA device go to the hand-written kernels (csrc/megablock_fwd.cu,
csrc/megablock_bwd.cu) or raise. There is no fallback between the two.

lowp (bf16 operands) is an argument: both operands of every product are
rounded to bf16 and accumulated in f32, as the TPU kernel's `_dot` does.

Dropout (rate 0.5, before every dense layer except the first) draws its
masks from the counter hash the JAX kernel uses in interpret mode
(`_hash_bits` / `_keep_mask`), keyed on (seed, batch, tile of tile_v rows,
layer): the masks here, in the kernels and in `interpret_dropout_mask` are
bit-identical. torch has little uint32 arithmetic, so the plain hash runs in
int64 and wraps to 32 bits after every shift, add and multiply.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .spectral import lowp_matmul

DEFAULT_TILE_V = 1024
DROPOUT_RATE = 0.5   # the reference's fixed MiniMLP rate
_SCALE = 1.0 / (1.0 - DROPOUT_RATE)

# launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel, and nowhere else
LAUNCHES = {"megablock_fwd": 0, "xhat_reduce": 0, "megablock_bwd": 0,
            "grad_reduce": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# The dropout hash (pallas_megablock.py:72-110), in int64 wrapped to 32 bits
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
# keep where bits >= round(rate * 2^32)
_THRESHOLD = round(DROPOUT_RATE * float(2 ** 32))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h, c < 2^32 without leaving int64: c is split in
    16-bit halves, so no partial product reaches 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def hash_bits(idx: torch.Tensor, *seeds) -> torch.Tensor:
    """`_hash_bits` of the JAX kernel: the splitmix/xorshift hash of the
    counter idx with each seed folded in, then the finaliser. idx and seeds
    are int64 tensors (broadcast together) or ints in [0, 2^32); returns
    int64 values in [0, 2^32)."""
    h = idx.to(torch.int64) & _M32
    for s in seeds:
        s = torch.as_tensor(s, dtype=torch.int64, device=h.device) & _M32
        h = h ^ ((s + 0x9E3779B9 + ((h << 6) & _M32) + (h >> 2)) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _dropout_key(b, i, layer):
    """(batch, tile, layer) folded into one int32, as `_keep_mask` does."""
    return (b * 65536 + i) * 16 + layer


def keep_mask(shape, seed, b, i, layer, device=None) -> torch.Tensor:
    """The keep mask of one (tile_v, width) tile: equal, bit for bit, to
    `interpret_dropout_mask(shape, 0.5, seed, b, i, layer)`."""
    rows, width = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    return hash_bits(r * width + c, seed, _dropout_key(b, i, layer)) \
        >= _THRESHOLD


def dropout_masks(B: int, V: int, width: int, seed, layer: int, tile_v: int,
                  device=None) -> torch.Tensor:
    """Keep masks (B, V, width) of one dropout layer for a whole batch: row
    v of batch element b uses tile i = v // tile_v, row v % tile_v of it."""
    if V % tile_v:
        raise ValueError(f"V={V} must be a multiple of tile_v={tile_v} "
                         "with dropout (pad to a bucket)")
    v = torch.arange(V, dtype=torch.int64, device=device)
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None, None]
    row = (v % tile_v)[None, :, None]
    col = torch.arange(width, dtype=torch.int64, device=device)
    key = _dropout_key(b, (v // tile_v)[None, :, None], layer)
    return hash_bits(row * width + col, seed, key) >= _THRESHOLD


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' references)
# ---------------------------------------------------------------------------

def _cdt(*ts) -> torch.dtype:
    """Compute dtype of the plain versions: f32, or f64 if an input is f64."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in ts)
            else torch.float32)


def _mm(a, b, lowp: bool):
    """a @ b in f32 (f64 for f64 inputs); with lowp both operands are first
    rounded to bf16 (the products of bf16 values are exact in f32, so this
    is bf16 operands with f32 accumulation)."""
    if lowp:
        return lowp_matmul(a, b, torch.bfloat16, torch.float32)
    dt = _cdt(a, b)
    return a.to(dt) @ b.to(dt)


def _mm_t(a, b, lowp: bool):
    """a^T b over the row axis, per batch element: (B,V,M),(B,V,N)->(B,M,N)."""
    return _mm(a.transpose(-1, -2), b, lowp)


def _forward_parts(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                   x_hat_in, lowp, seed, tile_v):
    """The block's forward with everything the backward reads."""
    dt = _cdt(x, coefs, x_hat_in, *Ws)
    s = coefs.to(dt) * x_hat_in.to(dt)
    xf = x.to(dt)
    xd = _mm(evecs, s, lowp)
    gx = _mm(gX, s, lowp)
    gy = _mm(gY, s, lowp)
    vb_re = _mm(gx, A_re, lowp) - _mm(gy, A_im, lowp)
    vb_im = _mm(gy, A_re, lowp) + _mm(gx, A_im, lowp)
    feat = torch.tanh(gx * vb_re + gy * vb_im)
    h = torch.cat([xf, xd, feat], dim=-1)
    B, V = x.shape[:2]
    n = len(Ws)
    inputs, pres, masks = [], [], []
    for l, (W, b) in enumerate(zip(Ws, bs)):
        if l > 0 and seed is not None:
            keep = dropout_masks(B, V, h.shape[-1], seed, l - 1, tile_v,
                                 device=h.device)
            h = torch.where(keep, h * _SCALE, torch.zeros_like(h))
            masks.append(keep)
        inputs.append(h)
        pre = _mm(h, W, lowp) + b.to(dt)
        pres.append(pre)
        h = torch.relu(pre) if l < n - 1 else pre
    return dict(s=s, xf=xf, gx=gx, gy=gy, vb_re=vb_re, vb_im=vb_im,
                feat=feat, out=xf + h, inputs=inputs, pres=pres, masks=masks)


def megablock_chained_reference(x, evecs, gX, gY, mass, coefs, A_re, A_im,
                                Ws, bs, x_hat_in, emit_next: bool = True,
                                lowp: bool = False, seed=None,
                                tile_v: int = DEFAULT_TILE_V):
    """Plain PyTorch version of B1, with the kernel's casts and dropout masks
    (seed None: dropout off). Returns (out in x's dtype, x_hat_next f32 or
    None)."""
    f = _forward_parts(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                       x_hat_in, lowp, seed, tile_v)
    out = f["out"]
    x_hat_next = None
    if emit_next:
        x_hat_next = _mm_t(evecs, out * mass[..., None].to(out.dtype), lowp)
    return out.to(x.dtype), x_hat_next


def megablock_chained_bwd_reference(x, evecs, gX, gY, mass, coefs, A_re,
                                    A_im, Ws, bs, x_hat_in, dout,
                                    dx_hat_next=None, lowp: bool = False,
                                    seed=None, tile_v: int = DEFAULT_TILE_V):
    """Plain PyTorch version of B2 (`_make_bwd_kernel`), product by product
    with the kernel's casts. dx_hat_next: the cotangent of the emitted
    x_hat_next, or None (emit_next off).

    Returns (dx_direct (B,V,C) in x's dtype, ds (B,K,C), dA_re, dA_im (C,C),
    dWs, dbs), the parameter gradients summed over the batch."""
    f = _forward_parts(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                       x_hat_in, lowp, seed, tile_v)
    dt = f["xf"].dtype
    g = dout.to(dt)
    if dx_hat_next is not None:
        # this block's output also fed the next block's x_hat = Phi^T(m out)
        g = g + mass[..., None].to(dt) * _mm(evecs, dx_hat_next, lowp)
    n = len(Ws)
    dWs, dbs = [None] * n, [None] * n
    d = g
    for l in range(n - 1, -1, -1):
        dpre = (d if l == n - 1
                else torch.where(f["pres"][l] > 0, d, torch.zeros_like(d)))
        dWs[l] = _mm_t(f["inputs"][l], dpre, lowp).sum(0)
        dbs[l] = dpre.sum(-2).sum(0)
        d = _mm(dpre, Ws[l].transpose(0, 1), lowp)
        if l > 0 and seed is not None:
            d = torch.where(f["masks"][l - 1], d * _SCALE, torch.zeros_like(d))
    C = x.shape[-1]
    dx_direct = d[..., :C] + g
    dxd, dfeat = d[..., C:2 * C], d[..., 2 * C:]
    feat, gx, gy = f["feat"], f["gx"], f["gy"]
    ddots = dfeat * (1.0 - feat * feat)
    dgx = ddots * f["vb_re"]
    dgy = ddots * f["vb_im"]
    dvb_re = ddots * gx
    dvb_im = ddots * gy
    dA_re = (_mm_t(gx, dvb_re, lowp) + _mm_t(gy, dvb_im, lowp)).sum(0)
    dA_im = (_mm_t(gx, dvb_im, lowp) - _mm_t(gy, dvb_re, lowp)).sum(0)
    dgx = dgx + _mm(dvb_re, A_re.transpose(0, 1), lowp)
    dgx = dgx + _mm(dvb_im, A_im.transpose(0, 1), lowp)
    dgy = dgy + _mm(dvb_im, A_re.transpose(0, 1), lowp)
    dgy = dgy - _mm(dvb_re, A_im.transpose(0, 1), lowp)
    ds = (_mm_t(evecs, dxd, lowp) + _mm_t(gX, dgx, lowp)
          + _mm_t(gY, dgy, lowp))
    return dx_direct.to(x.dtype), ds, dA_re, dA_im, dWs, dbs


def relu_margin(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat_in,
                lowp: bool = False, seed=None, tile_v: int = DEFAULT_TILE_V
                ) -> torch.Tensor:
    """(B, V): per row, the smallest |pre-activation| of the MLP's ReLUs,
    each relative to its layer's largest. Where it is within rounding of 0,
    two correct implementations whose sums differ in the last bits can take
    the two ReLU branches, and their gradients then differ by that row's
    whole contribution: comparisons of the backward exclude such rows."""
    f = _forward_parts(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                       x_hat_in, lowp, seed, tile_v)
    out = None
    for pre in f["pres"][:-1]:
        r = (pre.abs() / pre.abs().max().clamp(min=1e-30)).amin(-1)
        out = r if out is None else torch.minimum(out, r)
    return out if out is not None else torch.ones_like(mass)


XR_CHUNKS = 16  # chunks of the x_hat partial sum (XR_CHUNKS in the kernel)


def xhat_reduce_reference(partial: torch.Tensor, K: int, C: int
                          ) -> torch.Tensor:
    """Plain version of the partial-sum kernel: the (K, C) corners of the
    per-CTA slots (B, S, SLOT, SLOT) -> (B, K, C), in the kernel's order:
    the S slots cut into XR_CHUNKS chunks of L = ceil(S / XR_CHUNKS)
    consecutive slots (the last ones short or empty), each chunk summed from
    +0 in ascending s, then the chunk sums added from +0 in ascending chunk
    order. The empty tail is summed as zeros, which leaves every sum as it
    is (a sum from +0 is never -0), so on the card this equals the kernel
    bit for bit."""
    B, S = partial.shape[:2]
    L = -(-S // XR_CHUNKS)
    p = partial[:, :, :K, :C]
    p = torch.cat([p, p.new_zeros((B, XR_CHUNKS * L - S, K, C))], dim=1)
    p = p.view(B, XR_CHUNKS, L, K, C)
    chunk = p.new_zeros((B, XR_CHUNKS, K, C))
    for j in range(L):
        chunk += p[:, :, j]
    out = p.new_zeros((B, K, C))
    for g in range(XR_CHUNKS):
        out += chunk[:, g]
    return out


def grad_reduce_reference(partial: torch.Tensor, off: int, n: int
                          ) -> torch.Tensor:
    """Plain version of B2's partial-sum kernel: elements [off, off + n) of
    the slots (G, S, P), summed in the order s = 0, 1, ... -> (G, n)."""
    out = partial[:, 0, off:off + n].clone()
    for s in range(1, partial.shape[1]):
        out += partial[:, s, off:off + n]
    return out


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

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
    """CTAs per batch element: about one wave over the SMs (the kernels run
    one CTA per SM), never more than the row tiles."""
    return max(1, min(n_tiles, _sm_count(dev.index) // B))


TILE_ROWS = 32  # the kernels' row tile (TV in csrc/megablock_common.cuh)
SLOT = 128      # side of a CTA's x_hat partial slot (MAX_KC there)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def xhat_reduce(partial: torch.Tensor, K: int, C: int) -> torch.Tensor:
    """Sum per-CTA x_hat partials, slots (B, S, SLOT, SLOT) of which the
    (K, C) corner is used, -> (B, K, C) in the fixed order that
    `xhat_reduce_reference` states (bit-equal to it on the card)."""
    if partial.device.type == "cpu":
        return xhat_reduce_reference(partial, K, C)
    _check(partial.device.type == "cuda", f"unsupported device {partial.device}")
    _check(partial.dtype == torch.float32 and partial.ndim == 4
           and partial.shape[2:] == (SLOT, SLOT) and partial.is_contiguous()
           and partial.data_ptr() % 16 == 0,
           f"partial must be contiguous, 16-byte aligned f32 "
           f"(B,S,{SLOT},{SLOT})")
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


def grad_reduce(partial: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """Sum elements [off, off + n) of per-CTA gradient slots (G, S, P) over
    S in a fixed order -> (G, n)."""
    if partial.device.type == "cpu":
        return grad_reduce_reference(partial, off, n)
    _check(partial.device.type == "cuda", f"unsupported device {partial.device}")
    _check(partial.dtype == torch.float32 and partial.ndim == 3
           and partial.is_contiguous(), "partial must be contiguous f32 (G,S,P)")
    G, S, P = partial.shape
    _check(0 <= off and n >= 1 and off + n <= P, f"region [{off}, {off + n})")
    from .. import _build
    lib = _build.load()
    out = torch.empty((G, n), dtype=torch.float32, device=partial.device)
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mb_grad_reduce_launch(partial.data_ptr(), out.data_ptr(),
                                         G, S, P, off, n, stream)
    _raise_on(lib, code, "grad_reduce launch")
    LAUNCHES["grad_reduce"] += 1
    return out


def _weight_layout(W: torch.Tensor, rows: int = 8, cols: int = 16
                   ) -> torch.Tensor:
    """W (k, n) as a kernel reads its weights from global memory: rows 32-byte
    aligned, zero rows up to a multiple of `rows` and columns up to one of
    `cols` (B1 reads W in 8-row, 16-column fragments; B2 also reads W^T, so
    it pads both to 16). W itself where it already is so, else a zero-padded
    copy."""
    k, n = W.shape
    kp, np_ = _up(k, rows), _up(n, cols)
    if (kp, np_) == (k, n) and W.data_ptr() % 32 == 0:
        return W
    out = W.new_zeros((kp, np_))
    out[:k, :n] = W
    return out


def _check_block(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                 x_hat_in, seed, tile_v):
    """The checks both kernels share; returns (B, V, K, C, widths)."""
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
    if seed is not None:
        _check(tile_v % TILE_ROWS == 0,
               f"tile_v={tile_v} must be a multiple of the kernel's "
               f"{TILE_ROWS}-row tile, so each lies inside one dropout tile")
        _check(V % tile_v == 0, f"V={V} must be a multiple of "
               f"tile_v={tile_v} with dropout (pad to a bucket)")
        _check(0 <= int(seed) < 2 ** 31, f"seed {seed} outside [0, 2^31)")
    return B, V, K, C, widths


def _dropout_args(seed, tile_v):
    return (int(seed is not None), 0 if seed is None else int(seed),
            int(tile_v))


def _megablock_fwd_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                        x_hat_in, emit_next, lowp, seed, tile_v):
    B, V, K, C, widths = _check_block(x, evecs, gX, gY, mass, coefs, A_re,
                                      A_im, Ws, bs, x_hat_in, seed, tile_v)
    n_dense = len(Ws)
    from .. import _build
    lib = _build.load()
    dev = x.device
    out = torch.empty_like(x)
    n_tiles = -(-V // TILE_ROWS)
    nsplit = _nsplit(dev, B, n_tiles)
    partial = (torch.empty((B, nsplit, SLOT, SLOT), dtype=torch.float32,
                           device=dev) if emit_next else None)
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
            B, V, K, C, nsplit, int(x.dtype == torch.bfloat16),
            int(evecs.dtype == torch.bfloat16), int(lowp),
            *_dropout_args(seed, tile_v), stream)
    _raise_on(lib, code, "megablock_fwd launch")
    LAUNCHES["megablock_fwd"] += 1
    if not emit_next:
        return out, None
    return out, xhat_reduce(partial, K, C)


def grad_slot_layout(K: int, C: int, widths) -> dict:
    """Where B2's per-CTA gradient slot keeps each partial, in floats: ds
    (K16, C16), dA_re and dA_im (C16, C16), each dW_l (w16_l, w16_{l+1})
    and each db_l (w16_{l+1},), every side rounded up to 16 (the kernel
    accumulates 16x16 blocks). Mirrors csrc/megablock_bwd.cu."""
    K16, C16 = _up(K, 16), _up(C, 16)
    w16 = [_up(w, 16) for w in widths]
    off = K16 * C16
    lay = {"K16": K16, "C16": C16, "w16": w16, "are": off,
           "aim": off + C16 * C16}
    off += 2 * C16 * C16
    lay["dw"] = []
    for l in range(len(widths) - 1):
        lay["dw"].append(off)
        off += w16[l] * w16[l + 1]
    lay["db"] = []
    for l in range(len(widths) - 1):
        lay["db"].append(off)
        off += w16[l + 1]
    lay["P"] = off
    return lay


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(B, k, n) f32 -> contiguous, 32-byte aligned (B, rows, cols), zero
    past (k, n)."""
    B, k, n = t.shape
    if ((k, n) == (rows, cols) and t.is_contiguous()
            and t.data_ptr() % 32 == 0):
        return t
    out = t.new_zeros((B, rows, cols))
    out[:, :k, :n] = t
    return out


def _megablock_bwd_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                        x_hat_in, dout, dx_hat_next, lowp, seed, tile_v):
    B, V, K, C, widths = _check_block(x, evecs, gX, gY, mass, coefs, A_re,
                                      A_im, Ws, bs, x_hat_in, seed, tile_v)
    _check(C % 8 == 0, f"the backward kernel needs C % 8 == 0 (got C={C})")
    _check(tuple(dout.shape) == (B, V, C) and dout.dtype == x.dtype
           and dout.device == x.device, "dout must be (B,V,C) in x's dtype")
    if dx_hat_next is not None:
        _check(tuple(dx_hat_next.shape) == (B, K, C)
               and dx_hat_next.dtype == torch.float32
               and dx_hat_next.device == x.device,
               "dx_hat_next must be (B,K,C) f32")
    n_dense = len(Ws)
    lay = grad_slot_layout(K, C, widths)
    K16, C16, P = lay["K16"], lay["C16"], lay["P"]
    from .. import _build
    lib = _build.load()
    dev = x.device
    dout = dout.contiguous()
    dx = torch.empty_like(x)
    n_tiles = -(-V // TILE_ROWS)
    nsplit = _nsplit(dev, B, n_tiles)
    partial = torch.empty((B, nsplit, P), dtype=torch.float32, device=dev)
    # s = coefs (.) x_hat and dx_hat_next are read like weights (16-padded)
    s = _padded(coefs * x_hat_in, K16, C16)
    dxn = (None if dx_hat_next is None
           else _padded(dx_hat_next, K16, C16))
    cmap = _weight_layout(torch.cat((torch.cat((A_re, A_im), 1),
                                     torch.cat((-A_im, A_re), 1))), 16, 16)
    Wk = [_weight_layout(W, 16, 16) for W in Ws]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ws = (vp * n_dense)(*[W.data_ptr() for W in Wk])
    ldw = (ci * n_dense)(*[W.shape[1] for W in Wk])
    bsp = (vp * n_dense)(*[b.data_ptr() for b in bs])
    wid = (ci * (n_dense + 1))(*widths)
    off_dw = (ci * n_dense)(*lay["dw"])
    off_db = (ci * n_dense)(*lay["db"])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mb_bwd_launch(
            x.data_ptr(), evecs.data_ptr(), gX.data_ptr(), gY.data_ptr(),
            mass.data_ptr(), s.data_ptr(), s.shape[-1], cmap.data_ptr(),
            cmap.shape[1],
            ws, ldw, bsp, wid, n_dense, dout.data_ptr(),
            None if dxn is None else dxn.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), P, lay["are"], lay["aim"], off_dw, off_db,
            B, V, K, C, nsplit, int(x.dtype == torch.bfloat16),
            int(evecs.dtype == torch.bfloat16), int(lowp),
            *_dropout_args(seed, tile_v), stream)
    _raise_on(lib, code, "megablock_bwd launch")
    LAUNCHES["megablock_bwd"] += 1
    # ds per batch element; parameter gradients over every CTA of the batch
    ds = grad_reduce(partial, 0, K16 * C16).view(B, K16, C16)[:, :K, :C]
    par = grad_reduce(partial.view(1, B * nsplit, P), lay["are"],
                      P - lay["are"])[0]

    def region(off, rows, cols, r, c):
        o = off - lay["are"]
        return par[o:o + rows * cols].view(rows, cols)[:r, :c]
    dA_re = region(lay["are"], C16, C16, C, C)
    dA_im = region(lay["aim"], C16, C16, C, C)
    w16 = lay["w16"]
    dWs = [region(lay["dw"][l], w16[l], w16[l + 1], widths[l], widths[l + 1])
           for l in range(n_dense)]
    dbs = [region(lay["db"][l], 1, w16[l + 1], 1, widths[l + 1])[0]
           for l in range(n_dense)]
    return dx, ds, dA_re, dA_im, dWs, dbs


# ---------------------------------------------------------------------------
# Dispatch and the autograd Function
# ---------------------------------------------------------------------------

def megablock_chained_fwd(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                          x_hat_in, emit_next=True, lowp=False, seed=None,
                          tile_v=DEFAULT_TILE_V):
    """B1 alone (no autograd): the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    Ws, bs = tuple(Ws), tuple(bs)
    dev = _device_of([x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat_in,
                      *Ws, *bs])
    if dev.type == "cpu":
        return megablock_chained_reference(x, evecs, gX, gY, mass, coefs,
                                           A_re, A_im, Ws, bs, x_hat_in,
                                           emit_next, lowp, seed, tile_v)
    return _megablock_fwd_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws,
                               bs, x_hat_in, emit_next, lowp, seed, tile_v)


def megablock_chained_bwd(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                          x_hat_in, dout, dx_hat_next=None, lowp=False,
                          seed=None, tile_v=DEFAULT_TILE_V):
    """B2 alone: (dx_direct, ds, dA_re, dA_im, dWs, dbs), the kernel and its
    partial-sum launches for CUDA tensors, the plain version for CPU ones."""
    Ws, bs = tuple(Ws), tuple(bs)
    extra = [dout] + ([] if dx_hat_next is None else [dx_hat_next])
    dev = _device_of([x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat_in,
                      *Ws, *bs, *extra])
    if dev.type == "cpu":
        return megablock_chained_bwd_reference(
            x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat_in,
            dout, dx_hat_next, lowp, seed, tile_v)
    return _megablock_bwd_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws,
                               bs, x_hat_in, dout, dx_hat_next, lowp, seed,
                               tile_v)


class _MegablockChained(torch.autograd.Function):
    """Forward B1, backward B2 (the JAX package's `_mbc_fwd` / `_mbc_bwd`):
    the inputs are saved and the backward recomputes each tile."""

    @staticmethod
    def forward(ctx, x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat_in,
                seed, tile_v, emit_next, lowp, n_dense, *wb):
        Ws, bs = wb[:n_dense], wb[n_dense:]
        out, xn = megablock_chained_fwd(x, evecs, gX, gY, mass, coefs, A_re,
                                        A_im, Ws, bs, x_hat_in, emit_next,
                                        lowp, seed, tile_v)
        ctx.save_for_backward(x, evecs, gX, gY, mass, coefs, A_re, A_im,
                              x_hat_in, *wb)
        ctx.cfg = (seed, tile_v, emit_next, lowp, n_dense)
        return (out, xn) if emit_next else out

    @staticmethod
    def backward(ctx, dout, dxn=None):
        (x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat_in,
         *wb) = ctx.saved_tensors
        seed, tile_v, emit_next, lowp, n_dense = ctx.cfg
        Ws, bs = wb[:n_dense], wb[n_dense:]
        if dout is None:
            dout = torch.zeros_like(x)
        if emit_next and dxn is None:
            dxn = torch.zeros_like(x_hat_in)
        dx, ds, dA_re, dA_im, dWs, dbs = megablock_chained_bwd(
            x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat_in,
            dout, dxn if emit_next else None, lowp, seed, tile_v)
        # the spectral chain: s = coefs (.) x_hat_in
        dcoefs = ds * x_hat_in
        dxhat_in = ds * coefs
        return (dx, None, None, None, None, dcoefs, dA_re, dA_im, dxhat_in,
                None, None, None, None, None, *dWs, *dbs)


def megablock_chained(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                      x_hat_in, emit_next: bool = True, lowp: bool = False,
                      seed=None, tile_v: int = DEFAULT_TILE_V):
    """One whole DiffusionNet block for a batch of surfaces, differentiable
    in x, coefs, A_re, A_im, Ws, bs and x_hat_in.

    x (B,V,C) f32 or bf16; evecs/gX/gY (B,V,K) f32 or bf16 (one dtype);
    mass (B,V) f32; coefs (B,K,C) f32; A_re/A_im (C,C) f32; Ws/bs the MLP's
    (w_in, w_out) kernels and (w_out,) biases, f32, first input 3C, last
    output C; x_hat_in (B,K,C) f32. seed: None (dropout off) or an int in
    [0, 2^31) keying the dropout masks, whose tiles are tile_v rows (V must
    then be a multiple of tile_v). The CUDA kernels keep their own 32-row
    tiles either way.
    Returns (out (B,V,C) in x's dtype, x_hat_next (B,K,C) f32 or None)."""
    Ws, bs = tuple(Ws), tuple(bs)
    res = _MegablockChained.apply(x, evecs, gX, gY, mass, coefs, A_re, A_im,
                                  x_hat_in, seed, tile_v, emit_next, lowp,
                                  len(Ws), *Ws, *bs)
    return res if emit_next else (res, None)


# ---------------------------------------------------------------------------
# B3: one whole block with its own projection (the JAX op `megablock`)
# ---------------------------------------------------------------------------

def megablock_reference(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                        seed=None, tile_v: int = DEFAULT_TILE_V,
                        lowp: bool = False):
    """Plain version of B3 (JAX's `megablock_reference`): x_hat = Phi^T(m x),
    then the block on it, with the kernels' casts (lowp) and dropout masks
    (seed None: off; the masks equal `interpret_dropout_mask`). Returns out
    in x's dtype; differentiable through torch autograd."""
    from .fused import spectral_project_reference
    x_hat = spectral_project_reference(x, evecs, mass, lowp)
    out, _ = megablock_chained_reference(x, evecs, gX, gY, mass, coefs, A_re,
                                         A_im, Ws, bs, x_hat, False, lowp,
                                         seed, tile_v)
    return out


class _Megablock(torch.autograd.Function):
    """Forward: the projection kernel (x_hat kept as the residual), then B1
    with emit_next off. Backward: B2 with no dx_hat_next, then the spectral
    chain outside the kernel (the JAX package's `_mb_bwd`)."""

    @staticmethod
    def forward(ctx, x, evecs, gX, gY, mass, coefs, A_re, A_im, seed, tile_v,
                lowp, n_dense, *wb):
        from .fused import spectral_project
        Ws, bs = wb[:n_dense], wb[n_dense:]
        x_hat = spectral_project(x, evecs, mass, lowp)
        out, _ = megablock_chained_fwd(x, evecs, gX, gY, mass, coefs, A_re,
                                       A_im, Ws, bs, x_hat, False, lowp, seed,
                                       tile_v)
        ctx.save_for_backward(x, evecs, gX, gY, mass, coefs, A_re, A_im,
                              x_hat, *wb)
        ctx.cfg = (seed, tile_v, lowp, n_dense)
        return out

    @staticmethod
    def backward(ctx, dout):
        (x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat,
         *wb) = ctx.saved_tensors
        seed, tile_v, lowp, n_dense = ctx.cfg
        Ws, bs = wb[:n_dense], wb[n_dense:]
        dx_direct, ds, dA_re, dA_im, dWs, dbs = megablock_chained_bwd(
            x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat,
            dout.contiguous(), None, lowp, seed, tile_v)
        from .fused import spectral_chain_vjp
        dx, dcoefs = spectral_chain_vjp(ds, x_hat, coefs, evecs, mass,
                                        x.dtype, dx_direct)
        return (dx, None, None, None, None, dcoefs, dA_re, dA_im, None, None,
                None, None, *dWs, *dbs)


def megablock(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, seed,
              tile_v: int = DEFAULT_TILE_V, dropout: bool = False):
    """One whole DiffusionNet block for a batch of surfaces, with its own
    projection x_hat = Phi^T (m x): the JAX op `megablock`, in its argument
    order. x (B,V,C) f32 or bf16; evecs/gX/gY (B,V,K), one dtype (bf16
    operators run every product on bf16 operands, as `_lowp_for` decides);
    mass (B,V); coefs (B,K,C); Ws/bs the MLP, first input 3C, last output C;
    seed an int in [0, 2^31) keying the dropout masks, ignored unless
    dropout (then V must be a multiple of tile_v). Differentiable in x,
    coefs, A_re, A_im, Ws and bs. Returns out (B,V,C) in x's dtype."""
    if x.shape[-2] % tile_v:
        raise ValueError(f"V={x.shape[-2]} must be a multiple of "
                         f"tile_v={tile_v} (pad to a bucket)")
    Ws, bs = tuple(Ws), tuple(bs)
    lowp = evecs.dtype == torch.bfloat16
    return _Megablock.apply(x, evecs, gX, gY, mass, coefs, A_re, A_im,
                            int(seed) if dropout else None, tile_v, lowp,
                            len(Ws), *Ws, *bs)
