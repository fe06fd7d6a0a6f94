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

and, with emit_next, the next block's x_hat = Phi^T (m out). On the card
the forward is two kernels and a partial sum (csrc/megablock_fwd.cu):
`megablock_fwd` runs the block per 64-row tile on wgmma and writes `out`;
`megablock_fwd_xhat` runs x_hat_next's V-reduction on a split-V grid; and
`xhat_reduce` sums its partials in a fixed order. `fwd_route` chooses the
row kernel's layout before launch: which activations sit in shared memory
and which in a device scratch, at any width. Both directions take C % 8 ==
0 on the card: `pad_block` pads another C with zero channels. The backward
returns (dx_direct, ds, dA_re, dA_im, dW_l, db_l); `megablock_chained` wraps
both in a torch.autograd.Function. On the card the backward is two kernels
and a partial sum: `megablock_bwd_rows` recomputes the forward per 64-row
tile and writes dx_direct, a row scratch R of the V-reductions' operands
and db's per-tile partials; `megablock_bwd_grads` runs the V-reductions
(dW, dA, ds) on a split-V grid; `grad_reduce` sums the partials in a fixed
order (csrc/megablock_bwd.cu).

Dispatch: tensors on the CPU go to the plain PyTorch versions
(`megablock_chained_reference`, `megablock_chained_bwd_reference`); tensors
on a CUDA device go to the hand-written kernels or raise. There is no
fallback between the two. The plain versions of the split kernels
(`megablock_fwd_xhat_reference`, `megablock_bwd_rows_reference`,
`megablock_bwd_grads_reference`) are what the card's kernels are held to.

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
import time

import torch

from ..training.profiling import count, since, wait
from .spectral import lowp_matmul

DEFAULT_TILE_V = 1024
DROPOUT_RATE = 0.5   # the reference's fixed MiniMLP rate
_SCALE = 1.0 / (1.0 - DROPOUT_RATE)

# launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel, and nowhere else, and beside it counts
# launch.<kernel> in `training.profiling` with the host seconds from its
# entry to the launch's return
LAUNCHES = {"megablock_fwd": 0, "megablock_fwd_xhat": 0, "xhat_reduce": 0,
            "megablock_bwd_rows": 0, "megablock_bwd_grads": 0,
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


def cmap_of(A_re, A_im) -> torch.Tensor:
    """The complex map as one (2C, 2C) matrix: [vb_re | vb_im] = [gx | gy]
    cmap."""
    return torch.cat((torch.cat((A_re, A_im), 1), torch.cat((-A_im, A_re), 1)))


def _forward_parts(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                   x_hat_in, lowp, seed, tile_v, one_cmap=False):
    """The block's forward with everything the backward reads. one_cmap:
    the complex map as one product over [gx | gy] (as the backward's rows
    kernel runs it), else as the JAX kernel writes it, four products."""
    dt = _cdt(x, coefs, x_hat_in, *Ws)
    s = coefs.to(dt) * x_hat_in.to(dt)
    xf = x.to(dt)
    xd = _mm(evecs, s, lowp)
    gx = _mm(gX, s, lowp)
    gy = _mm(gY, s, lowp)
    if one_cmap:
        vb = _mm(torch.cat((gx, gy), -1), cmap_of(A_re, A_im).to(dt), lowp)
        C = x.shape[-1]
        vb_re, vb_im = vb[..., :C], vb[..., C:]
    else:
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


# ---------------------------------------------------------------------------
# B2 on the card: the rows kernel's scratch, and the plain versions of the
# two backward kernels
# ---------------------------------------------------------------------------

ROW_TILE = 64  # rows per CTA of B1's and B2's row kernels (RT in csrc/)
GRAD_BLOCK = 128  # side of an output block of the grads kernel


def bwd_layout(K: int, C: int, widths) -> dict:
    """Where the rows kernel keeps each V-reduction operand in a row of its
    scratch R (column offsets; each group padded to a multiple of 32), the
    column of each layer's db partial, and the grads kernel's parameter
    products (A's and B's first columns in R, M, N, and the product's offset
    in a parameter slot): dW_l = in_l^T dpre_l for every layer, then
    P = [gx | gy]^T [dvb_re | dvb_im]. Mirrors csrc/megablock_bwd.cu."""
    n = len(widths) - 1
    off = 0

    def grp(w):
        nonlocal off
        o, off = off, off + _up(w, 32)
        return o
    off_in = [grp(3 * C)] + [grp(widths[l]) for l in range(1, n)]
    off_dp = [grp(widths[l + 1]) for l in range(n)]
    off_gg, off_dvb, off_ds = grp(2 * C), grp(2 * C), grp(3 * C)
    prods, o = [], 0
    for l in range(n):
        prods.append((off_in[l], off_dp[l], widths[l], widths[l + 1], o))
        o += widths[l] * widths[l + 1]
    prods.append((off_gg, off_dvb, 2 * C, 2 * C, o))
    return dict(off_in=off_in, off_dp=off_dp, off_gg=off_gg, off_dvb=off_dvb,
                off_ds=off_ds, ldr=off,
                off_db=[sum(widths[1:l + 1]) for l in range(n)],
                ld_db=sum(widths[1:]), prods=prods, P_par=o + 4 * C * C)


def grads_splits(B: int, V: int, K: int, C: int, widths, n_sm: int):
    """(S_par, L_par, S_ds, L_ds): the grads kernel's V ranges. Split s of a
    parameter product covers rows [s L_par, (s + 1) L_par) of all B V rows,
    split s of ds rows [s L_ds, (s + 1) L_ds) of one batch element's V (the
    last ones short or empty). L is chosen so that about 4 CTAs per SM share
    the work (ds reads three operand pairs per row), a multiple of 32."""
    def blocks(m, n):
        return -(-m // GRAD_BLOCK) * -(-n // GRAD_BLOCK)
    nb_par = (sum(blocks(a, b) for a, b in zip(widths[:-1], widths[1:]))
              + blocks(2 * C, 2 * C))
    work = nb_par * B * V + 3 * B * blocks(K, C) * V
    L = max(32, _up(-(-work // (4 * n_sm)), 32))
    S_ds = max(1, -(-3 * V // L))
    L_ds = _up(-(-V // S_ds), 32)
    return -(-(B * V) // L), L, -(-V // L_ds), L_ds


def megablock_bwd_rows_reference(x, evecs, gX, gY, mass, coefs, A_re, A_im,
                                 Ws, bs, x_hat_in, dout, dx_hat_next=None,
                                 lowp: bool = False, seed=None,
                                 tile_v: int = DEFAULT_TILE_V):
    """Plain version of the rows kernel, with its products (the complex map
    as one product over [gx | gy], dvb cmap^T as one) and casts. Returns
    (dx_direct (B,V,C) in x's dtype, R (B V, ldr) in the product type
    (bf16 with lowp, else f32; `bwd_layout` places the groups, padding
    zero), dbp (B n_tiles, ld_db) f32: each 64-row tile's column sums of
    every dpre_l)."""
    f = _forward_parts(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                       x_hat_in, lowp, seed, tile_v, one_cmap=True)
    dt = f["xf"].dtype
    B, V, C = x.shape
    n = len(Ws)
    widths = [W.shape[0] for W in Ws] + [Ws[-1].shape[1]]
    lay = bwd_layout(evecs.shape[-1], C, widths)
    g = dout.to(dt)
    if dx_hat_next is not None:
        g = g + mass[..., None].to(dt) * _mm(evecs, dx_hat_next, lowp)
    dpres = [None] * n
    d = g
    for l in range(n - 1, -1, -1):
        dpres[l] = (d if l == n - 1
                    else torch.where(f["pres"][l] > 0, d, torch.zeros_like(d)))
        d = _mm(dpres[l], Ws[l].transpose(0, 1), lowp)
        if l > 0 and seed is not None:
            d = torch.where(f["masks"][l - 1], d * _SCALE, torch.zeros_like(d))
    dx_direct = d[..., :C] + g
    ddots = d[..., 2 * C:] * (1.0 - f["feat"] * f["feat"])
    dvb = torch.cat((ddots * f["gx"], ddots * f["gy"]), -1)
    dgxy = (torch.cat((ddots * f["vb_re"], ddots * f["vb_im"]), -1)
            + _mm(dvb, cmap_of(A_re, A_im).transpose(0, 1).to(dt), lowp))
    rdt = torch.bfloat16 if lowp else torch.float32
    R = torch.zeros((B * V, lay["ldr"]), dtype=rdt, device=x.device)

    def put(off, t):
        R[:, off:off + t.shape[-1]] = t.reshape(B * V, -1).to(rdt)
    for l in range(n):
        put(lay["off_in"][l], f["inputs"][l])
        put(lay["off_dp"][l], dpres[l])
    put(lay["off_gg"], torch.cat((f["gx"], f["gy"]), -1))
    put(lay["off_dvb"], dvb)
    put(lay["off_ds"], torch.cat((d[..., C:2 * C], dgxy), -1))
    n_tiles = -(-V // ROW_TILE)
    dbp = torch.zeros((B * n_tiles, lay["ld_db"]), dtype=torch.float32,
                      device=x.device)
    for l in range(n):
        w = widths[l + 1]
        t = torch.zeros((B, n_tiles * ROW_TILE, w), dtype=dt, device=x.device)
        t[:, :V] = dpres[l]
        o = lay["off_db"][l]
        dbp[:, o:o + w] = t.view(B * n_tiles, ROW_TILE, w).sum(1).float()
    return dx_direct.to(x.dtype), R, dbp


def _split_tn(a, b, S, L):
    """(S, M, N): per split of L consecutive rows (the last ones short or
    empty), a^T b over its rows, in f32."""
    pad = S * L - a.shape[0]
    a = torch.nn.functional.pad(a, (0, 0, 0, pad)).view(S, L, -1)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).view(S, L, -1)
    return a.transpose(1, 2) @ b


def megablock_bwd_grads_reference(R, evecs, gX, gY, C: int, widths, splits,
                                  lowp: bool = False):
    """Plain version of the grads kernel: (part_par (S_par, P_par),
    part_ds (B, S_ds, K C)), f32. Split s of each product is its rows'
    product, as the kernel's CTAs split V (`grads_splits`): the parameter
    products of `bwd_layout` over all B V rows of R, and ds_b = Phi_b^T dxd
    + GX_b^T dgx + GY_b^T dgy over batch element b's rows (operators rounded
    to bf16 with lowp; R is already in the product type)."""
    B, V, K = evecs.shape
    lay = bwd_layout(K, C, widths)
    S_par, L_par, S_ds, L_ds = splits
    Rf = R.float()
    part_par = torch.zeros((S_par, lay["P_par"]), dtype=torch.float32,
                           device=R.device)
    for a_off, b_off, M, N, o in lay["prods"]:
        part_par[:, o:o + M * N] = _split_tn(
            Rf[:, a_off:a_off + M], Rf[:, b_off:b_off + N], S_par,
            L_par).reshape(S_par, -1)
    ops = [(op.to(torch.bfloat16) if lowp else op).float()
           for op in (evecs, gX, gY)]
    part_ds = torch.zeros((B, S_ds, K * C), dtype=torch.float32,
                          device=R.device)
    off = lay["off_ds"]
    for b in range(B):
        rows = Rf[b * V:(b + 1) * V]
        acc = sum(_split_tn(ops[t][b], rows[:, off + t * C:off + (t + 1) * C],
                            S_ds, L_ds) for t in range(3))
        part_ds[b] = acc.reshape(S_ds, -1)
    return part_par, part_ds


def bwd_grads_finish(part_par, part_ds, dbp, K: int, C: int, widths):
    """(ds (B,K,C), dA_re, dA_im, dWs, dbs) from the partials: `grad_reduce`
    sums ds over its splits per batch element, the parameters over their
    splits and db over the row tiles (kernels for CUDA tensors); dA_re =
    P00 + P11, dA_im = P01 - P10."""
    lay = bwd_layout(K, C, widths)
    n = len(widths) - 1
    B = part_ds.shape[0]
    ds = grad_reduce(part_ds, 0, K * C).view(B, K, C)
    par = grad_reduce(part_par.unsqueeze(0), 0, lay["P_par"])[0]
    db = grad_reduce(dbp.unsqueeze(0), 0, lay["ld_db"])[0]
    dWs = [par[o:o + M * N].view(M, N) for _, _, M, N, o in lay["prods"][:n]]
    o = lay["prods"][n][4]
    P = par[o:o + 4 * C * C].view(2 * C, 2 * C)
    dA_re = P[:C, :C] + P[C:, C:]
    dA_im = P[:C, C:] - P[C:, :C]
    dbs = [db[o:o + widths[l + 1]] for l, o in enumerate(lay["off_db"])]
    return ds, dA_re, dA_im, dWs, dbs


XR_MAX_CHUNKS = 16  # chunks of the x_hat partial sum (as in the kernel)
XR_PER_CHUNK = 8    # slots a chunk takes before the chunk count grows


def xhat_chunks(S: int) -> int:
    """The partial sum's chunk count for S slots: min(16, ceil(S / 8))."""
    return min(XR_MAX_CHUNKS, -(-S // XR_PER_CHUNK))


def xhat_reduce_reference(partial: torch.Tensor, K: int, C: int
                          ) -> torch.Tensor:
    """Plain version of the partial-sum kernel: the (K, C) corners of the
    per-CTA slots (B, S, SLOT, SLOT) -> (B, K, C), in the kernel's order:
    the S slots cut into G = `xhat_chunks(S)` chunks of L = ceil(S / G)
    consecutive slots (the last ones short or empty), each chunk summed from
    +0 in ascending s, then the chunk sums added from +0 in ascending chunk
    order. The empty tail is summed as zeros, which leaves every sum as it
    is (a sum from +0 is never -0), so on the card this equals the kernel
    bit for bit."""
    B, S = partial.shape[:2]
    G = xhat_chunks(S)
    L = -(-S // G)
    p = partial[:, :, :K, :C]
    p = torch.cat([p, p.new_zeros((B, G * L - S, K, C))], dim=1)
    p = p.view(B, G, L, K, C)
    chunk = p.new_zeros((B, G, K, C))
    for j in range(L):
        chunk += p[:, :, j]
    out = p.new_zeros((B, K, C))
    for g in range(G):
        out += chunk[:, g]
    return out


def xhat_splits(B: int, V: int, K: int, C: int, n_sm: int) -> tuple:
    """(S, L): the x_hat_next kernel's V ranges. Split s covers rows
    [s L, (s + 1) L) of each batch element's V (the last ones short or
    empty); L, a multiple of 32, is chosen so that the CTAs (one per batch
    element, 128 x 128 piece of (K, C) and split) make about one wave over
    the SMs (the kernel runs one CTA per SM)."""
    pieces = B * -(-K // SLOT) * -(-C // SLOT)
    L = max(32, _up(-(-V // max(1, n_sm // pieces)), 32))
    return -(-V // L), L


def megablock_fwd_xhat_reference(evecs, src, scale, splits,
                                 lowp: bool = False) -> torch.Tensor:
    """Plain version of the x_hat_next kernel: partial slots (B, nkt, nct,
    S, SLOT, SLOT) f32, nkt = ceil(K / SLOT), nct = ceil(C / SLOT); slot
    (b, kt, ct, s) holds, in its (K, C) corner, Phi_b^T (scale (.) src)_b
    over rows [s L, (s + 1) L) of V, for K rows 128 kt.. and C columns
    128 ct.. (zeros past K and C). src (B,V,C) is `out` (f32; or x, f32 or
    bf16, for B4's projection), scale (B,V) the mass (or None where src
    already is m (.) out). lowp: both operands rounded to bf16 (scale (.)
    src after the product in f32)."""
    B, V, K = evecs.shape
    C = src.shape[-1]
    S, L = splits
    y = src.float() if scale is None else src.float() * scale[..., None]
    ph = evecs
    if lowp:
        y = y.to(torch.bfloat16)
        ph = ph.to(torch.bfloat16)
    nkt, nct = -(-K // SLOT), -(-C // SLOT)
    part = torch.zeros((B, nkt * SLOT, nct * SLOT, S), dtype=torch.float32,
                       device=src.device)
    for b in range(B):
        part[b, :K, :C] = _split_tn(ph[b].float(), y[b].float(), S,
                                    L).permute(1, 2, 0)
    return (part.view(B, nkt, SLOT, nct, SLOT, S)
            .permute(0, 1, 3, 5, 2, 4).contiguous())


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


SLOT = 128  # side of an x_hat partial slot: (K, C) in SLOT x SLOT pieces
MAX_DENSE = 16  # MLP layers a launch's arguments hold (MAX_DENSE there)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def xhat_reduce(partial: torch.Tensor, K: int, C: int) -> torch.Tensor:
    """Sum per-CTA x_hat partials, slots (G, S, SLOT, SLOT) of which the
    (K, C) corner is used, -> (G, K, C) in the fixed order that
    `xhat_reduce_reference` states (bit-equal to it on the card)."""
    t0 = time.perf_counter_ns()
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
    count("launch.xhat_reduce", seconds=since(t0))
    return out


def grad_reduce(partial: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """Sum elements [off, off + n) of per-CTA gradient slots (G, S, P) over
    S in a fixed order -> (G, n)."""
    t0 = time.perf_counter_ns()
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
    count("launch.grad_reduce", seconds=since(t0))
    return out


def reduce_pieces(partial: torch.Tensor, B: int, K: int, C: int,
                  reduce=xhat_reduce) -> torch.Tensor:
    """x_hat (B, K, C) from per-CTA slots (B, nkt, nct, S, SLOT, SLOT), one
    slot per (b, 128-row piece of K, 128-column piece of C): one
    `xhat_reduce` launch over every piece (`reduce`: or its plain version,
    on any device), then the pieces put together."""
    nkt, nct = -(-K // SLOT), -(-C // SLOT)
    kr = K if nkt == 1 else SLOT
    cr = C if nct == 1 else SLOT
    x_hat = reduce(partial.view(B * nkt * nct, -1, SLOT, SLOT), kr, cr)
    if nkt == nct == 1:
        return x_hat
    return (x_hat.view(B, nkt, nct, kr, cr).permute(0, 1, 3, 2, 4)
            .reshape(B, nkt * kr, nct * cr)[:, :K, :C].contiguous())


def pad_block(x, coefs, A_re, A_im, Ws, bs, *per_channel):
    """The block's inputs with C padded to round8(C) by zero channels, as
    the kernels take them (they read rows of C values 16 bytes at a time):
    x, coefs, A_re and A_im, W_0's rows at each third of [x | xd | feat],
    the last layer's columns and bias, and the (..., C) tensors
    `per_channel` (x_hat_in, dout, dx_hat_next; None stays None). Returns
    them in that order; at C % 8 == 0 the inputs themselves.

    Exact: in a padded channel s, xd, gx, gy and vb are 0, feat is
    tanh(0) = 0, the first layer reads it through a zero row and the last
    writes 0 + 0 to out; so x_hat_next and every gradient there are 0, and
    the real channels' sums only gain zero terms. The hidden widths stay
    as they are (the kernels take any), so dropout, which acts on the
    hidden layers only, draws the model's own masks."""
    C = x.shape[-1]
    C8 = _up(C, 8)
    if C8 == C:
        return (x, coefs, A_re, A_im, tuple(Ws), tuple(bs), *per_channel)
    pad = torch.nn.functional.pad

    def ch(t):
        return None if t is None else pad(t, (0, C8 - C))
    Ws, bs = list(Ws), list(bs)
    w1 = Ws[0].shape[1]
    Ws[0] = pad(Ws[0].reshape(3, C, w1), (0, 0, 0, C8 - C)).view(3 * C8, w1)
    Ws[-1] = ch(Ws[-1])
    bs[-1] = ch(bs[-1])
    return (ch(x), ch(coefs), pad(A_re, (0, C8 - C, 0, C8 - C)),
            pad(A_im, (0, C8 - C, 0, C8 - C)), tuple(Ws), tuple(bs),
            *map(ch, per_channel))


def unpad_grads(C: int, ds, dA_re, dA_im, dWs, dbs):
    """The gradients of `pad_block`'s padded parameters cut back to the
    model's C: ds (B, K, C), dA_re, dA_im, dWs, dbs."""
    C8 = ds.shape[-1]
    if C8 == C:
        return ds, dA_re, dA_im, dWs, dbs
    dWs, dbs = list(dWs), list(dbs)
    dWs[-1] = dWs[-1][:, :C]
    dbs[-1] = dbs[-1][:C]
    dWs[0] = dWs[0].reshape(3, C8, -1)[:, :C].reshape(3 * C, -1)
    return (ds[..., :C].contiguous(), dA_re[:C, :C].contiguous(),
            dA_im[:C, :C].contiguous(), [w.contiguous() for w in dWs],
            [b.contiguous() for b in dbs])


def fwd_rows_ldb(C: int, widths, hidden_spilled: bool = False) -> int:
    """Row stride, in floats, of the row kernel's activation buffers:
    round32(C) + 4, or round32(max(C, hidden widths)) + 4 where they also
    hold the hidden layers."""
    return _up(max([C] + ([] if hidden_spilled else list(widths[1:-1]))),
               32) + 4


def fwd_rows_smem_bytes(C: int, widths, lowp: bool, layout) -> int:
    """The row kernel's shared memory (csrc/megablock_fwd.cu) in a layout
    (warpgroups a CTA, resident buffers, hidden layers spilled): a ring of
    B stages (128 x 32 values, TF32 hi and lo in f32, bf16 under lowp; 3
    stages for one warpgroup, 2 for two) and, per warpgroup, the resident
    64-row activation buffers (of gx then xd, gy and feat, in that order)."""
    wgs, resident, spilled = layout
    stage = 128 * 32 * (2 if lowp else 8)
    return ((3 if wgs == 1 else 2) * stage
            + wgs * resident * ROW_TILE * fwd_rows_ldb(C, widths, spilled)
            * 4)


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    """The card's opt-in shared memory per block, in bytes."""
    from .. import _build
    with torch.cuda.device(index):
        return int(_build.load().mb_smem_optin())


# the row kernel's layouts in the order the route tries them: (warpgroups a
# CTA, activation buffers in shared memory, hidden layers in a device
# scratch). With the hidden layers in the buffers of gx and gy, those two
# stay in shared memory.
FWD_LAYOUTS = ((2, 3, False), (2, 2, False), (1, 3, False), (1, 2, False),
               (2, 3, True), (2, 2, True), (2, 1, True), (2, 0, True))


def fwd_route(C: int, widths, lowp: bool, limit: int) -> tuple:
    """B1's row-kernel layout at these widths (C padded as `pad_block`
    pads it), chosen before launch from the shared memory each layout
    needs, computed from the shapes: the first of `FWD_LAYOUTS` whose
    bytes fit in `limit`, so the hidden layers in shared memory before a
    scratch, two warpgroups (two tiles) a CTA before one, and more of the
    activations in shared memory before fewer. Raises with the bytes
    needed where not even the B ring fits."""
    C8 = _up(C, 8)
    widths = (3 * C8, *widths[1:-1], C8)
    for layout in FWD_LAYOUTS:
        if fwd_rows_smem_bytes(C8, widths, lowp, layout) <= limit:
            return layout
    raise ValueError(
        f"megablock_chained: the row kernel needs at least "
        f"{fwd_rows_smem_bytes(C8, widths, lowp, FWD_LAYOUTS[-1])} bytes of "
        f"shared memory (C={C}, widths={list(widths)}), more than the "
        f"card's {limit} bytes")


def _check_block(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                 x_hat_in, seed, tile_v, lowp=False, fwd=False):
    """The checks both kernels share (fwd: also B1's, that its row tile lies
    inside one dropout tile); returns (B, V, K, C, widths, B1's layout).
    Shapes are refused only where B1's smallest layout, computed from them,
    exceeds the card's shared memory (B2's kernels take the same shared
    memory at every width)."""
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
    _check(n_dense <= MAX_DENSE, f"{n_dense} dense layers: a launch's "
           f"arguments hold {MAX_DENSE}")
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
    layout = fwd_route(C, widths, lowp, _smem_limit(x.device.index or 0))
    if seed is not None:
        # the JAX package's key packing (pallas_megablock.py:90-104)
        _check(B <= 2048 and V // tile_v <= 65536 and n_dense - 1 <= 16,
               f"dropout keys pack batch <= 2048, tiles <= 65536 and <= 16 "
               f"dropout layers (got B={B}, {V // tile_v} tiles, "
               f"{n_dense - 1} layers)")
        _check(not fwd or tile_v % ROW_TILE == 0,
               f"tile_v={tile_v} must be a multiple of the kernel's "
               f"{ROW_TILE}-row tile, so each lies inside one dropout tile")
        _check(V % tile_v == 0, f"V={V} must be a multiple of "
               f"tile_v={tile_v} with dropout (pad to a bucket)")
        _check(0 <= int(seed) < 2 ** 31, f"seed {seed} outside [0, 2^31)")
    return B, V, K, C, widths, layout


def _dropout_args(seed, tile_v):
    return (int(seed is not None), 0 if seed is None else int(seed),
            int(tile_v))


def _megablock_fwd_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                        x_hat_in, emit_next, lowp, seed, tile_v, layout):
    """The row kernel (and with emit_next the x_hat kernel and its sum) on
    inputs that `pad_block` padded, in `layout` (`fwd_route`)."""
    t0 = time.perf_counter_ns()
    B, V, C = x.shape
    K = evecs.shape[-1]
    widths = [W.shape[0] for W in Ws] + [Ws[-1].shape[1]]
    n = len(Ws)
    from .. import _build
    lib = _build.load()
    dev = x.device
    out = torch.empty_like(x)
    wgs, resident, spilled = layout

    def scratch(cols):
        return torch.empty((B * V, cols), dtype=torch.float32, device=dev)
    # the activation slots past the resident ones, and the hidden layers by
    # turns, in device scratch
    spill = [None if i < resident else scratch(C) for i in range(3)]
    ldh = _up(max(widths[1:-1], default=1), 4)
    hid = [scratch(ldh) if spilled and i < n - 1 else None for i in range(2)]
    # x_hat_next reads the f32 `out`: where out is stored in bf16, the row
    # kernel also writes y = m (.) out in f32 for it
    y = (torch.empty((B, V, C), dtype=torch.float32, device=dev)
         if emit_next and x.dtype == torch.bfloat16 else None)
    tiles, ptr = _fwd_b_operands(coefs, x_hat_in, A_re, A_im, Ws, lowp)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mb_fwd_launch(
            x.data_ptr(), evecs.data_ptr(), gX.data_ptr(), gY.data_ptr(),
            mass.data_ptr(), ptr[0], ptr[1],
            (ctypes.c_void_p * n)(*ptr[2:]), _ptrs(bs), _ints(widths), n,
            out.data_ptr(), _ptrs(spill), _ptrs(hid), ldh,
            None if y is None else y.data_ptr(), B, V, K, C,
            fwd_rows_ldb(C, widths, spilled), wgs,
            int(x.dtype == torch.bfloat16),
            int(evecs.dtype == torch.bfloat16), int(lowp),
            *_dropout_args(seed, tile_v), stream)
    _raise_on(lib, code, "megablock_fwd launch")
    LAUNCHES["megablock_fwd"] += 1
    count("launch.megablock_fwd", seconds=since(t0))
    del spill, hid, tiles
    if not emit_next:
        return out, None
    splits = xhat_splits(B, V, K, C, _sm_count(dev.index or 0))
    part = (megablock_fwd_xhat(evecs, out, mass, splits, lowp) if y is None
            else megablock_fwd_xhat(evecs, y, None, splits, lowp))
    return out, reduce_pieces(part, B, K, C)


def megablock_fwd_xhat(evecs, src, scale, splits, lowp: bool = False
                       ) -> torch.Tensor:
    """x_hat_next's split-V kernel for CUDA tensors, its plain version for
    CPU ones: the partial slots that `megablock_fwd_xhat_reference` states
    (on the card only the (K, C) corner of each piece is written), to be
    summed by `reduce_pieces`. src (B,V,C) f32, scale (B,V) f32 or None."""
    t0 = time.perf_counter_ns()
    dev = _device_of([evecs, src] + ([] if scale is None else [scale]))
    if dev.type == "cpu":
        return megablock_fwd_xhat_reference(evecs, src, scale, splits, lowp)
    B, V, K = evecs.shape
    C = src.shape[-1]
    S, L = splits
    _check(src.dtype == torch.float32 and tuple(src.shape) == (B, V, C)
           and src.is_contiguous() and src.data_ptr() % 16 == 0
           and C % 4 == 0, "src must be contiguous, 16-byte aligned f32 "
           "(B,V,C) with C % 4 == 0")
    _check(scale is None or (scale.dtype == torch.float32
                             and tuple(scale.shape) == (B, V)
                             and scale.is_contiguous()),
           "scale must be contiguous f32 (B,V)")
    _check(evecs.is_contiguous() and evecs.dtype in (torch.float32,
                                                     torch.bfloat16),
           "evecs must be contiguous f32 or bf16")
    _check(S * L >= V, f"splits {splits} do not cover V={V}")
    from .. import _build
    lib = _build.load()
    nkt, nct = -(-K // SLOT), -(-C // SLOT)
    part = torch.empty((B, nkt, nct, S, SLOT, SLOT), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mb_fwd_xhat_launch(
            evecs.data_ptr(), src.data_ptr(),
            None if scale is None else scale.data_ptr(), part.data_ptr(),
            B, V, K, C, S, L, int(evecs.dtype == torch.bfloat16), int(lowp),
            stream)
    _raise_on(lib, code, "megablock_fwd_xhat launch")
    LAUNCHES["megablock_fwd_xhat"] += 1
    count("launch.megablock_fwd_xhat", seconds=since(t0))
    return part


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 rounds."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _chunk_order(lowp: bool) -> list:
    """The rows kernel's contraction order inside a chunk of 32 values
    (wg::RowA): logical value j of the chunk is physical column order[j],
    so that a thread's 16-byte loads are its wgmma fragments. tf32, step s
    of 8 values: j = 8 s + q is column 8 q + 2 s (q < 4) or 8 (q - 4) +
    2 s + 1; bf16, step s of 16: j = 16 s + q is column 8 (q % 8 // 2) +
    4 s + q % 2, plus 2 for q >= 8."""
    if lowp:
        return [8 * (q % 8 // 2) + 4 * s + q % 2 + (2 if q >= 8 else 0)
                for s in range(2) for q in range(16)]
    return [8 * (q % 4) + 2 * s + q // 4 for s in range(4) for q in range(8)]


@functools.lru_cache(maxsize=None)
def _tile_index(N: int, k: int, lowp: bool, device) -> torch.Tensor:
    """For each value of `b_tiles`' output of one (N, k) matrix, its flat
    index in the matrix, or N k (a zero appended) for padding."""
    npass, nk = -(-N // 128), -(-k // 32)
    rows = torch.arange(npass * 128)[:, None, None]
    cols = (torch.arange(nk)[None, :, None] * 32
            + torch.tensor(_chunk_order(lowp))[None, None, :])
    flat = torch.where((rows < N) & (cols < k), rows * k + cols, N * k)
    e = 8 if lowp else 4
    flat = (flat.reshape(npass, 16, 8, nk, 32 // e, e)
            .permute(0, 3, 1, 4, 2, 5).reshape(-1))
    return flat.to(device)


@functools.lru_cache(maxsize=None)
def _interleave(C: int, device) -> torch.Tensor:
    """[0, C, 1, C + 1, ...]: the rows re_c, im_c of cmap^T in turn."""
    return torch.stack((torch.arange(C), torch.arange(C) + C), 1).reshape(
        -1).to(device)


def b_tiles(bt: torch.Tensor, lowp: bool) -> torch.Tensor:
    """A B operand of the rows kernel, given as B^T (..., N, k), laid out as
    the kernel copies it into shared memory: N in passes of 128 rows and k
    in chunks of 32 (zero-padded), each (pass, chunk) one stage: the chunk's
    values in the kernel's contraction order (`_chunk_order`), as wgmma's
    K-major core matrices of 8 rows x 16 bytes in (row group, k group)
    order. f32: each stage holds the TF32 hi part, then the lo part, of
    every value (..., passes, chunks, 2, 4096); lowp: bf16 (..., passes,
    chunks, 4096)."""
    *lead, N, k = bt.shape
    npass, nk = -(-N // 128), -(-k // 32)
    flat = torch.cat((bt.reshape(-1, N * k).float(),
                      bt.new_zeros((max(1, bt.numel() // max(1, N * k)), 1),
                                   dtype=torch.float32)), 1)
    x = flat[:, _tile_index(N, k, lowp, bt.device)].view(
        *lead, npass, nk, 128 * 32)
    if lowp:
        return x.to(torch.bfloat16).contiguous()
    hi = tf32_round(x)
    return torch.stack((hi, tf32_round(x - hi)), -2).contiguous()


def _operand_index(N: int, k: int, lowp: bool, off: int, lead: int, R0: int,
                   R1: int, trans: bool, zero: int, colmap=None, kmap=None
                   ) -> list:
    """Indices, into concatenated sources, of the values of one B operand's
    stages (`b_tiles`' layout of B^T (N, k)), for `lead` copies of an
    (R0, R1) source matrix M at stride R0 R1 from `off`: B^T[n][j] = M[j][n]
    (trans) or M[n][j]. colmap: B^T's row n reads M's index colmap[n].
    kmap: B^T has len(kmap) contraction values, value j reading M's kmap[j]
    (-1: zero). Padding reads `zero`."""
    kl = k if kmap is None else len(kmap)
    base = _tile_index(N, kl, lowp, "cpu")
    pad = base == N * kl
    n, kk = (base // kl).clamp(max=N - 1), base % kl
    if kmap is not None:
        km = torch.as_tensor(kmap, dtype=torch.int64)[kk]
        pad = pad | (km < 0)
        kk = km.clamp(min=0)
    if colmap is not None:
        n = colmap[n]
    m = kk * R1 + n if trans else n * R1 + kk
    return [torch.where(pad, zero, off + li * R0 * R1 + m)
            for li in range(lead)]


class _Plan:
    """One gather that tiles several B operands at once: `add` appends an
    operand's indices (`_operand_index`) and records its first stage."""

    def __init__(self, src_lens):
        self.src_off = [sum(src_lens[:i]) for i in range(len(src_lens))]
        self.zero = sum(src_lens)
        self.pieces, self.firsts, self.stage = [], [], 0

    def add(self, src, lead, R0, R1, trans, lowp, colmap=None, kmap=None):
        N, k = (R1, R0) if trans else (R0, R1)
        idx = _operand_index(N, k, lowp, self.src_off[src], lead, R0, R1,
                             trans, self.zero, colmap, kmap)
        self.firsts.append(self.stage)
        self.pieces += idx
        self.stage += len(idx) * (idx[0].numel() // 4096)

    def done(self, device) -> tuple:
        index = torch.cat(self.pieces)
        with wait("dnt.wait.tile_plan", device):
            index = index.to(device)
        return index, tuple(self.firsts), self.zero


def _gather_tiles(srcs, index, firsts, lowp):
    """The tiles of a plan from its sources (a zero appended): TF32 hi and
    lo per stage (f32) or bf16 (lowp); returns (the tiles, the first byte of
    each operand in them, or None)."""
    x = torch.cat([*srcs, srcs[0].new_zeros(1)])[index].view(-1, 4096)
    if lowp:
        tiles = x.to(torch.bfloat16)
    else:
        hi = tf32_round(x)
        tiles = torch.stack((hi, tf32_round(x - hi)), 1)
    sb = 4096 * (2 if lowp else 8)  # bytes of a stage
    return tiles, [None if f is None else tiles.data_ptr() + f * sb
                   for f in firsts]


@functools.lru_cache(maxsize=64)
def _rows_b_plan(B: int, K: int, C: int, widths: tuple, lowp: bool,
                 emit_next: bool, device) -> tuple:
    """One gather that tiles every B operand of B2's rows kernel at once, as
    `b_tiles` tiles each: from the concatenated sources [s (B,K,C),
    dx_hat_next (B,K,C) with emit_next, cmap (2C,2C), W_0 .. W_{n-1}] and
    a zero after them, the values of the operands' stages in the order sT,
    dxnT, cmapF, cmapB, wf[0..n-2], wb[0..n-1]. Returns (index, the first
    stage of each operand, the sources' length)."""
    plan = _Plan([B * K * C] * (2 if emit_next else 1) + [4 * C * C] + [
        a * b for a, b in zip(widths[:-1], widths[1:])])
    il = _interleave(C, "cpu")
    plan.add(0, B, K, C, True, lowp)                    # sT = s^T
    if emit_next:
        plan.add(1, B, K, C, True, lowp)                # dxnT
    else:
        plan.firsts.append(None)
    q = 2 if emit_next else 1
    plan.add(q, 1, 2 * C, 2 * C, True, lowp, il)        # cmapF = cmap^T, il
    plan.add(q, 1, 2 * C, 2 * C, False, lowp)           # cmapB = cmap
    for l in range(len(widths) - 2):                   # wf = W_l^T
        plan.add(q + 1 + l, 1, widths[l], widths[l + 1], True, lowp)
    for l in range(len(widths) - 1):                   # wb = W_l
        plan.add(q + 1 + l, 1, widths[l], widths[l + 1], False, lowp)
    return plan.done(device)


def _rows_b_operands(coefs, x_hat_in, dx_hat_next, A_re, A_im, Ws, lowp):
    """B2's rows kernel's B operands, tiled by one gather (`_rows_b_plan`):
    (the tiles, the first byte of each operand in them, or None)."""
    B, K, C = coefs.shape
    widths = tuple([W.shape[0] for W in Ws] + [Ws[-1].shape[1]])
    index, firsts, _ = _rows_b_plan(B, K, C, widths, lowp,
                                    dx_hat_next is not None, coefs.device)
    srcs = [(coefs * x_hat_in).reshape(-1)]
    if dx_hat_next is not None:
        srcs.append(dx_hat_next.reshape(-1))
    srcs += [cmap_of(A_re, A_im).reshape(-1)] + [W.reshape(-1) for W in Ws]
    return _gather_tiles(srcs, index, firsts, lowp)


def segment_map(C: int, nseg: int) -> list:
    """The row kernel's contraction over nseg C-wide segments ([gx | gy],
    [x | xd | feat]), each padded to a multiple of 32: value j reads row
    (j // c32) C + j % c32 of the source, or -1 (zero) past C in its
    segment."""
    c32 = _up(C, 32)
    return [(j // c32) * C + j % c32 if j % c32 < C else -1
            for j in range(nseg * c32)]


@functools.lru_cache(maxsize=64)
def _fwd_b_plan(B: int, K: int, C: int, widths: tuple, lowp: bool,
                device) -> tuple:
    """One gather that tiles every B operand of B1's row kernel: from the
    concatenated sources [s (B,K,C), cmap (2C,2C), W_0 .. W_{n-1}] and a
    zero, the operands sT (per batch element), cmapF (cmap^T, rows
    interleaved re_c, im_c, contraction over the padded [gx | gy]) and wf[l]
    = W_l^T (W_0's contraction over the padded [x | xd | feat]). Returns
    (index, the first stage of each operand, the sources' length)."""
    plan = _Plan([B * K * C, 4 * C * C] + [
        a * b for a, b in zip(widths[:-1], widths[1:])])
    plan.add(0, B, K, C, True, lowp)
    plan.add(1, 1, 2 * C, 2 * C, True, lowp, _interleave(C, "cpu"),
             segment_map(C, 2))
    plan.add(2, 1, widths[0], widths[1], True, lowp, None, segment_map(C, 3))
    for l in range(1, len(widths) - 1):
        plan.add(2 + l, 1, widths[l], widths[l + 1], True, lowp)
    return plan.done(device)


def _fwd_b_operands(coefs, x_hat_in, A_re, A_im, Ws, lowp):
    """B1's row kernel's B operands (sT, cmapF, wf[0..n-1]), tiled by one
    gather (`_fwd_b_plan`): (the tiles, the first byte of each)."""
    B, K, C = coefs.shape
    widths = tuple([W.shape[0] for W in Ws] + [Ws[-1].shape[1]])
    index, firsts, _ = _fwd_b_plan(B, K, C, widths, lowp, coefs.device)
    srcs = [(coefs * x_hat_in).reshape(-1), cmap_of(A_re, A_im).reshape(-1)]
    srcs += [W.reshape(-1) for W in Ws]
    return _gather_tiles(srcs, index, firsts, lowp)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[None if t is None else t.data_ptr()
                                         for t in ts])


def _ints(vals):
    return (ctypes.c_int * len(vals))(*vals)


def _check_bwd(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat_in,
               dout, dx_hat_next, seed, tile_v):
    B, V, K, C, widths, _ = _check_block(x, evecs, gX, gY, mass, coefs,
                                         A_re, A_im, Ws, bs, x_hat_in, seed,
                                         tile_v)
    _check(tuple(dout.shape) == (B, V, C) and dout.dtype == x.dtype
           and dout.device == x.device, "dout must be (B,V,C) in x's dtype")
    if dx_hat_next is not None:
        _check(tuple(dx_hat_next.shape) == (B, K, C)
               and dx_hat_next.dtype == torch.float32
               and dx_hat_next.device == x.device,
               "dx_hat_next must be (B,K,C) f32")
    return B, V, K, C, widths


def _bwd_rows_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                   x_hat_in, dout, dx_hat_next, lowp, seed, tile_v):
    """The rows kernel on checked inputs with C % 8 == 0."""
    t0 = time.perf_counter_ns()
    B, V, C = x.shape
    K = evecs.shape[-1]
    widths = [W.shape[0] for W in Ws] + [Ws[-1].shape[1]]
    n = len(Ws)
    lay = bwd_layout(K, C, widths)
    from .. import _build
    lib = _build.load()
    dev = x.device
    pdt = torch.bfloat16 if lowp else torch.float32  # the product type
    dout = dout.contiguous()
    dx = torch.empty_like(x)
    R = torch.empty((B * V, lay["ldr"]), dtype=pdt, device=dev)
    E = (torch.empty((B * V, 6 * C), dtype=torch.float32, device=dev)
         if lowp else None)
    n_tiles = -(-V // ROW_TILE)
    dbp = torch.empty((B * n_tiles, lay["ld_db"]), dtype=torch.float32,
                      device=dev)
    # the B operands, tiled once per call by one gather
    tiles, ptr = _rows_b_operands(coefs, x_hat_in, dx_hat_next, A_re, A_im,
                                  Ws, lowp)
    sT, dxnT, cmapF, cmapB = ptr[:4]
    wf = ptr[4:4 + n - 1] + [None]
    wb = ptr[4 + n - 1:]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mb_bwd_rows_launch(
            x.data_ptr(), evecs.data_ptr(), gX.data_ptr(), gY.data_ptr(),
            mass.data_ptr(), sT, dxnT, cmapF, cmapB,
            (ctypes.c_void_p * n)(*wf), (ctypes.c_void_p * n)(*wb),
            _ptrs(bs), _ints(widths), n,
            dout.data_ptr(), dx.data_ptr(), R.data_ptr(), lay["ldr"],
            _ints(lay["off_in"]), _ints(lay["off_dp"]), lay["off_gg"],
            lay["off_dvb"], lay["off_ds"],
            None if E is None else E.data_ptr(), dbp.data_ptr(),
            lay["ld_db"], _ints(lay["off_db"]), B, V, K, C,
            int(x.dtype == torch.bfloat16),
            int(evecs.dtype == torch.bfloat16), int(lowp),
            *_dropout_args(seed, tile_v), stream)
    _raise_on(lib, code, "megablock_bwd_rows launch")
    LAUNCHES["megablock_bwd_rows"] += 1
    count("launch.megablock_bwd_rows", seconds=since(t0))
    return dx, R, dbp


def megablock_bwd_rows(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                       x_hat_in, dout, dx_hat_next=None, lowp: bool = False,
                       seed=None, tile_v: int = DEFAULT_TILE_V):
    """B2's rows kernel for CUDA tensors, its plain version for CPU ones:
    (dx_direct, R, dbp) as `megablock_bwd_rows_reference` states them."""
    Ws, bs = tuple(Ws), tuple(bs)
    extra = [dout] + ([] if dx_hat_next is None else [dx_hat_next])
    dev = _device_of([x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat_in,
                      *Ws, *bs, *extra])
    if dev.type == "cpu":
        fn = megablock_bwd_rows_reference
    else:
        C = _check_bwd(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                       x_hat_in, dout, dx_hat_next, seed, tile_v)[3]
        _check(C % 8 == 0, f"the rows kernel takes C % 8 == 0 (got C={C}; "
               "megablock_chained_bwd pads C with pad_block)")
        fn = _bwd_rows_cuda
    return fn(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat_in,
              dout, dx_hat_next, lowp, seed, tile_v)


def megablock_bwd_grads(R, evecs, gX, gY, C: int, widths, splits,
                        lowp: bool = False):
    """B2's grads kernel for CUDA tensors, its plain version for CPU ones:
    (part_par, part_ds) as `megablock_bwd_grads_reference` states them."""
    t0 = time.perf_counter_ns()
    dev = _device_of([R, evecs, gX, gY])
    if dev.type == "cpu":
        return megablock_bwd_grads_reference(R, evecs, gX, gY, C, widths,
                                             splits, lowp)
    B, V, K = evecs.shape
    lay = bwd_layout(K, C, widths)
    S_par, L_par, S_ds, L_ds = splits
    _check(R.dtype == (torch.bfloat16 if lowp else torch.float32)
           and tuple(R.shape) == (B * V, lay["ldr"]) and R.is_contiguous(),
           f"R must be contiguous (B V, {lay['ldr']}) in the product type")
    _check(gX.shape == evecs.shape == gY.shape and gX.dtype == evecs.dtype
           == gY.dtype and all(t.is_contiguous() for t in (evecs, gX, gY)),
           "operators must be contiguous (B,V,K) of one dtype")
    _check(S_par * L_par >= B * V and S_ds * L_ds >= V,
           f"splits {splits} do not cover the rows")
    from .. import _build
    lib = _build.load()
    part_par = torch.empty((S_par, lay["P_par"]), dtype=torch.float32,
                           device=dev)
    part_ds = torch.empty((B, S_ds, K * C), dtype=torch.float32, device=dev)
    prods = [v for a, b, M, N, o in lay["prods"] for v in (a, b, M, N, o, 0, 0)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mb_bwd_grads_launch(
            R.data_ptr(), lay["ldr"], evecs.data_ptr(), gX.data_ptr(),
            gY.data_ptr(), lay["off_ds"],
            (ctypes.c_longlong * len(prods))(*prods), len(lay["prods"]),
            part_par.data_ptr(), lay["P_par"], S_par, L_par,
            part_ds.data_ptr(), S_ds, L_ds, B, V, K, C,
            int(evecs.dtype == torch.bfloat16), int(lowp), stream)
    _raise_on(lib, code, "megablock_bwd_grads launch")
    LAUNCHES["megablock_bwd_grads"] += 1
    count("launch.megablock_bwd_grads", seconds=since(t0))
    return part_par, part_ds


def _megablock_bwd_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                        x_hat_in, dout, dx_hat_next, lowp, seed, tile_v):
    """B2's rows kernel, grads kernel and partial sums on inputs that
    `pad_block` padded."""
    dx, R, dbp = _bwd_rows_cuda(x, evecs, gX, gY, mass, coefs, A_re, A_im,
                                Ws, bs, x_hat_in, dout, dx_hat_next, lowp,
                                seed, tile_v)
    B, V, C = x.shape
    K = evecs.shape[-1]
    widths = [W.shape[0] for W in Ws] + [Ws[-1].shape[1]]
    splits = grads_splits(B, V, K, C, widths, _sm_count(x.device.index or 0))
    part_par, part_ds = megablock_bwd_grads(R, evecs, gX, gY, C, widths,
                                            splits, lowp)
    del R
    return (dx, *bwd_grads_finish(part_par, part_ds, dbp, K, C, widths))


# ---------------------------------------------------------------------------
# Dispatch and the autograd Function
# ---------------------------------------------------------------------------

def megablock_chained_fwd(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                          x_hat_in, emit_next=True, lowp=False, seed=None,
                          tile_v=DEFAULT_TILE_V):
    """B1 alone (no autograd): C padded by `pad_block`, then the kernels for
    CUDA tensors (checked first at the model's own shapes), the plain
    version for CPU tensors, and the result cut back to C."""
    Ws, bs = tuple(Ws), tuple(bs)
    dev = _device_of([x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat_in,
                      *Ws, *bs])
    if dev.type == "cpu":
        fn = megablock_chained_reference
    else:
        layout = _check_block(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws,
                              bs, x_hat_in, seed, tile_v, lowp, fwd=True)[-1]
        fn = functools.partial(_megablock_fwd_cuda, layout=layout)
    C = x.shape[-1]
    x, coefs, A_re, A_im, Ws, bs, x_hat_in = pad_block(
        x, coefs, A_re, A_im, Ws, bs, x_hat_in)
    out, xn = fn(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat_in,
                 emit_next, lowp, seed, tile_v)
    if x.shape[-1] == C:
        return out, xn
    return (out[..., :C].contiguous(),
            None if xn is None else xn[..., :C].contiguous())


def megablock_chained_bwd(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                          x_hat_in, dout, dx_hat_next=None, lowp=False,
                          seed=None, tile_v=DEFAULT_TILE_V):
    """B2 alone: (dx_direct, ds, dA_re, dA_im, dWs, dbs). C padded by
    `pad_block`, then the kernels and their partial-sum launches for CUDA
    tensors (checked first at the model's own shapes), the plain version
    for CPU ones, and the results cut back to C (`unpad_grads`)."""
    Ws, bs = tuple(Ws), tuple(bs)
    extra = [dout] + ([] if dx_hat_next is None else [dx_hat_next])
    dev = _device_of([x, evecs, gX, gY, mass, coefs, A_re, A_im, x_hat_in,
                      *Ws, *bs, *extra])
    if dev.type == "cpu":
        fn = megablock_chained_bwd_reference
    else:
        _check_bwd(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                   x_hat_in, dout, dx_hat_next, seed, tile_v)
        fn = _megablock_bwd_cuda
    C = x.shape[-1]
    x, coefs, A_re, A_im, Ws, bs, x_hat_in, dout, dx_hat_next = pad_block(
        x, coefs, A_re, A_im, Ws, bs, x_hat_in, dout.contiguous(),
        dx_hat_next)
    dx, *grads = fn(x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs,
                    x_hat_in, dout, dx_hat_next, lowp, seed, tile_v)
    if x.shape[-1] != C:
        dx = dx[..., :C].contiguous()
    return (dx, *unpad_grads(C, *grads))


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
    then be a multiple of tile_v, and tile_v one of the kernels' 64-row
    tile). The CUDA kernels keep their own 64-row tiles either way.
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
        from .fused import project_vjp
        dx = project_vjp(ds * coefs, evecs, mass, x.dtype, dx_direct)
        return (dx, None, None, None, None, (ds * x_hat).to(coefs.dtype),
                dA_re, dA_im, None, None, None, None, *dWs, *dbs)


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
