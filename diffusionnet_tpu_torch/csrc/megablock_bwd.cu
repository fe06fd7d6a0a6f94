// Whole-DiffusionNet-block backward for Hopper (sm_90a), chained form.
//
// Replaces the TPU kernel `_make_bwd_kernel`
// (diffusionnet_tpu/ops/pallas_megablock.py:379, launched at :574). Per row
// tile of 32 vertices of batch element b it recomputes the block's forward
// (with the same dropout masks as B1), then backpropagates:
//
//   g        = dout (+ m (.) Phi dx_hat_next, with emit_next)
//   MLP      dpre_l, dW_l += in_l^T dpre_l, db_l += sum dpre_l, d = dpre_l W_l^T
//   dcat     = [dx_direct - g | dxd | dfeat];  dx_direct is written out
//   ddots    = dfeat (.) (1 - feat^2)
//   dvb      = ddots (.) [gx | gy];  [dgx | dgy] = ddots (.) vb + dvb cmap^T
//   dA_re   += gx^T dvb_re + gy^T dvb_im;  dA_im += gx^T dvb_im - gy^T dvb_re
//   ds      += Phi^T dxd + GX^T dgx + GY^T dgy
//
// with s = coefs (.) x_hat_in (the wrapper passes s, 16-padded) and cmap =
// [[A_re, A_im], [-A_im, A_re]]. A second kernel in this file
// (`grad_reduce_kernel`) sums the per-CTA partials in a fixed order.
//
// What bounds it on this card. At K = C = 128 with hidden [128, 128] a
// vertex costs about 2.2x B1's multiply-adds (the forward recompute without
// the last layer and the x_hat product, then the MLP's two backward
// products per layer, the complex map's transpose, the dA and ds products),
// against ~3.9 KB of device memory traffic in f32 (x, dout, dx_direct and
// the three operator rows, of which GX and GY are read twice): arithmetic
// bounds it, as it does B1, and every product runs on the tensor cores
// (megablock_common.cuh). The rest is what the TPU kernel keeps in VMEM and
// a CTA cannot:
//  * Shared memory. The TPU kernel holds a tile's whole forward state. Here
//    the 227 KB of a CTA hold, for 32 rows: Phi's tile (resident), one more
//    operator tile (GX, then GY; restaged for ds), [x | xd | feat], [gx | gy],
//    [vb_re | vb_im], the input of every dense layer after the first, g and
//    the warps' output patches: 217.6 KB at K = C = 128, hidden [128, 128].
//    s and dx_hat_next are not resident: like the weights, they are read
//    by each warp as fragments from L2. Pre-activations and dropout masks are
//    not kept either: d in_{l+1} (.) [in_{l+1} > 0] * scale equals the TPU
//    kernel's [pre_l > 0] (.) mask (.) d * scale exactly, since in_{l+1} =
//    mask (.) relu(pre_l) * scale. The backward then overwrites each buffer
//    in place once it is read for the last time: in_{l+1} becomes dpre_l,
//    [x | xd | feat] becomes [dgx | dxd | dgy], [vb_re | vb_im] becomes
//    [dvb_re | dvb_im].
//  * Transposed products. dpre W^T and dvb cmap^T read W through col-major
//    fragments (weight_gemm<.., true>); in^T dpre, [gx|gy]^T dvb and
//    Phi^T dxd read the resident tile through col-major A fragments. No
//    transposed copy of anything is staged.
//  * Reductions across CTAs. ds is per batch element; dA, dW and db sum over
//    the batch and V. Each CTA owns a strided set of tiles of one batch
//    element and a private slot in device memory (L2-resident, 0.5 MB at the
//    shapes above) holding all of its partials; each warp loads its 16x16
//    accumulator blocks from the slot, adds a tile's contribution and stores
//    them back, so no other CTA ever writes them. grad_reduce_kernel then sums
//    the slots in a fixed order: ds per batch element, the parameters over
//    every CTA. Deterministic: no floating-point atomics.
//
// bf16 ("lowp"): as in the TPU kernel's `_dot` / `_dot_t`, both operands of
// every product are rounded to bf16 where they enter it; elementwise work
// sees f32; dx_direct is stored in x's dtype.
//
// Padding: rows at or past V are masked (loads give 0, stores are skipped),
// and every partial gets exactly 0 from them: their operator rows are zero
// (ds, dA) and so is their g, hence every dpre (dW, db). Padded rows inside
// V carry mass 0 and zero operator rows.

#include "megablock_common.cuh"

namespace {

using namespace mb;

struct Args {
  const void* x;      // (B,V,C) f32 or bf16
  const void* evecs;  // (B,V,K) f32 or bf16 (gx, gy the same dtype)
  const void* gx;
  const void* gy;
  const float* mass;  // (B,V)
  const float* s;     // (B,K16,ld_s): coefs (.) x_hat_in, zero-padded
  int ld_s;
  const float* cmap;  // [[A_re, A_im], [-A_im, A_re]], row stride ld_cmap
  int ld_cmap;
  const float* w[MAX_DENSE];  // (width[l], width[l+1]), row stride ldw[l]
  int ldw[MAX_DENSE];
  const float* b[MAX_DENSE];  // (width[l+1],)
  int width[MAX_DENSE + 1];
  int n_dense;
  const void* dout;   // (B,V,C) in x's dtype
  const float* dxn;   // (B,K16,ld_s) dx_hat_next, zero-padded, or null
  void* dx;           // (B,V,C) dx_direct in x's dtype
  float* partial;     // (B,nsplit,P) slots
  long long P;
  int off_are, off_aim;
  int off_dw[MAX_DENSE], off_db[MAX_DENSE];
  int B, V, K, C;
  int n_tiles, nsplit;
  int x_bf16, ops_bf16;
  Dropout drop;
  // shared-memory row strides
  int ldk, ld1, ld2, ld3, ldh[MAX_DENSE];
  int smem_n;  // floats of shared memory
};

// Row stride of a shared buffer of `cols` columns: rounded up to 16 (the
// 16x16 blocks of the gradient products read that far), plus PAD, which
// keeps it at 4 mod 32 floats so the rows of a fragment fall in other banks.
inline int smem_ld(int cols) { return round_up(cols, 16) + PAD; }

// slot[bi][bj] += sum over the tile's TV rows of A0^T B0 (+ sign1 A1^T B1),
// for the 16x16 blocks of an (M, N) region of this CTA's slot (row stride
// lds); on the CTA's first tile the blocks start from 0. A and B are
// resident (row-major, TV rows); A^T is read through col-major fragments.
// Warps take blocks in turn. Columns read past M and N (up to a multiple
// of 16) must be finite; what they give lands outside the region's (M, N)
// corner.
template <bool LOWP>
__device__ void acc_tn(float* slot, int lds, int M, int N, bool first,
                       const float* A0, int lda0, const float* B0, int ldb0,
                       const float* A1 = nullptr, int lda1 = 0,
                       const float* B1 = nullptr, int ldb1 = 0,
                       float sign1 = 1.f) {
  __syncthreads();  // the operands' writers are done
  const int warp = threadIdx.x / 32, nw = NT / 32;
  const int mblocks = (M + 15) / 16, nb = (N + 15) / 16;
  for (int blk = warp; blk < mblocks * nb; blk += nw) {
    const int bi = blk / nb, bj = blk % nb;
    float* out = slot + (size_t)bi * 16 * lds + bj * 16;
    FragC acc;
    if (first)
      wmma::fill_fragment(acc, 0.f);
    else
      wmma::load_matrix_sync(acc, out, lds, wmma::mem_row_major);
    for (int t = 0; t < (A1 ? 2 : 1); ++t) {
      const float* A = t ? A1 : A0;
      const float* Bm = t ? B1 : B0;
      const int lda = t ? lda1 : lda0, ldb = t ? ldb1 : ldb0;
#pragma unroll
      for (int kk = 0; kk < TV; kk += 8) {
        FragAT a_hi, a_lo;
        wmma::load_matrix_sync(a_hi, A + kk * lda + bi * 16, lda);
        operands<LOWP>(a_hi, a_lo);
        FragB b_hi, b_lo;
        wmma::load_matrix_sync(b_hi, Bm + kk * ldb + bj * 16, ldb);
        operands<LOWP>(b_hi, b_lo);
        if (t && sign1 < 0.f) {
#pragma unroll
          for (int i = 0; i < b_hi.num_elements; ++i) {
            b_hi.x[i] = -b_hi.x[i];
            if constexpr (!LOWP) b_lo.x[i] = -b_lo.x[i];
          }
        }
        mma3<LOWP>(acc, a_hi, a_lo, b_hi, b_lo);
      }
    }
    wmma::store_matrix_sync(out, acc, lds, wmma::mem_row_major);
  }
}

// slot[n] += sum over the tile's rows of D[m][n], n < N (one thread a
// column, rows in order).
__device__ void acc_colsum(float* slot, int N, const float* D, int ldd,
                           bool first) {
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += NT) {
    float s = 0.f;
    for (int m = 0; m < TV; ++m) s += D[m * ldd + n];
    slot[n] = first ? s : slot[n] + s;
  }
}

// Stages rows row0.. of a (V, cols) operator of batch element b into a
// shared buffer of row stride ld: zero past V and past cols.
__device__ void stage(float* dst, int ld, const void* src, int bf16,
                      size_t vbase, int row0, int V, int cols) {
  __syncthreads();  // the buffer's last readers are done
  for (int i = threadIdx.x; i < TV * ld; i += NT) {
    const int m = i / ld, k = i % ld, row = row0 + m;
    dst[i] = (row < V && k < cols) ? load_elem(src, (vbase + row) * cols + k,
                                               bf16)
                                   : 0.f;
  }
}

template <bool LOWP>
__global__ void __launch_bounds__(NT, 1) megablock_bwd_kernel(const Args p) {
  extern __shared__ __align__(128) float smem[];
  const int C = p.C, K = p.K, V = p.V, n = p.n_dense;
  const int ldk = p.ldk, ld1 = p.ld1, ld2 = p.ld2, ld3 = p.ld3;
  float* sP = smem;              // TV x ldk: Phi's tile
  float* sQ = sP + TV * ldk;     // TV x ldk: GX's or GY's tile
  float* cat = sQ + TV * ldk;    // TV x ld3: [x | xd | feat]
  float* g0 = cat + TV * ld3;    // TV x ld2: [gx | gy]
  float* vb = g0 + TV * ld2;     // TV x ld2: [vb_re | vb_im]
  float* g = vb + TV * ld2;      // TV x ld1: g
  float* sC = g + TV * ld1;      // TV x LDC: output patches
  float* h[MAX_DENSE];           // TV x ldh[l]: input of dense layer l >= 1
  h[0] = cat;
  {
    float* q = sC + TV * LDC;
    for (int l = 1; l < n; ++l) {
      h[l] = q;
      q += TV * p.ldh[l];
    }
  }

  const int b = blockIdx.y, split_id = blockIdx.x, tid = threadIdx.x;
  const size_t vbase = (size_t)b * V;
  const float* s = p.s + (size_t)b * round_up(K, 16) * p.ld_s;
  const float* dxn =
      p.dxn ? p.dxn + (size_t)b * round_up(K, 16) * p.ld_s : nullptr;
  float* slot = p.partial + ((size_t)b * p.nsplit + split_id) * p.P;
  const float scale = p.drop.on ? 2.f : 1.f;

  // pads past every buffer's width stay zero: the products read them
  for (int i = tid; i < p.smem_n; i += NT) smem[i] = 0.f;

  for (int tile = split_id; tile < p.n_tiles; tile += p.nsplit) {
    const int row0 = tile * TV;
    const bool first = tile == split_id;

    // ---- recompute the forward
    stage(sP, ldk, p.evecs, p.ops_bf16, vbase, row0, V, K);
    stage(sQ, ldk, p.gx, p.ops_bf16, vbase, row0, V, K);
    for (int i = tid; i < TV * C; i += NT) {
      const int m = i / C, c = i % C, row = row0 + m;
      cat[m * ld3 + c] =
          row < V ? load_elem(p.x, (vbase + row) * C + c, p.x_bf16) : 0.f;
    }
    for (int i = tid; i < TV * C; i += NT) {
      const int m = i / C, c = i % C, row = row0 + m;
      g[m * ld1 + c] =
          row < V ? load_elem(p.dout, (vbase + row) * C + c, p.x_bf16) : 0.f;
    }
    weight_gemm<LOWP, false>(K, C, sP, ldk, s, p.ld_s,
                             [&](int m, int c, float v) { cat[m * ld3 + C + c] = v; },
                             sC);
    weight_gemm<LOWP, false>(K, C, sQ, ldk, s, p.ld_s,
                             [&](int m, int c, float v) { g0[m * ld2 + c] = v; },
                             sC);
    if (dxn != nullptr) {
      // the output also fed the next block's x_hat = Phi^T (m out)
      weight_gemm<LOWP, false>(
          K, C, sP, ldk, dxn, p.ld_s,
          [&](int m, int c, float v) {
            const int row = row0 + m;
            g[m * ld1 + c] += (row < V ? p.mass[vbase + row] : 0.f) * v;
          },
          sC);
    }
    stage(sQ, ldk, p.gy, p.ops_bf16, vbase, row0, V, K);
    weight_gemm<LOWP, false>(K, C, sQ, ldk, s, p.ld_s,
                             [&](int m, int c, float v) { g0[m * ld2 + C + c] = v; },
                             sC);
    // [vb_re | vb_im] = [gx | gy] cmap
    weight_gemm<LOWP, false>(2 * C, 2 * C, g0, ld2, p.cmap, p.ld_cmap,
                             [&](int m, int c, float v) { vb[m * ld2 + c] = v; },
                             sC);
    __syncthreads();
    for (int i = tid; i < TV * C; i += NT) {
      const int m = i / C, c = i % C;
      cat[m * ld3 + 2 * C + c] =
          tanhf(g0[m * ld2 + c] * vb[m * ld2 + c] +
                g0[m * ld2 + C + c] * vb[m * ld2 + C + c]);
    }
    // the MLP up to the last layer's input (the output itself is not needed)
    for (int l = 0; l + 1 < n; ++l) {
      const float* bias = p.b[l];
      float* dst = h[l + 1];
      const int ldd = p.ldh[l + 1], width = p.width[l + 1];
      weight_gemm<LOWP, false>(
          p.width[l], width, h[l], l ? p.ldh[l] : ld3, p.w[l], p.ldw[l],
          [&](int m, int c, float v) {
            dst[m * ldd + c] =
                p.drop.apply(fmaxf(v + bias[c], 0.f), b, row0 + m, c, width, l);
          },
          sC);
    }

    // ---- backward through the MLP; dpre_{n-1} = g
    for (int l = n - 1; l >= 0; --l) {
      const float* dpre = l == n - 1 ? g : h[l + 1];
      const int ldd = l == n - 1 ? ld1 : p.ldh[l + 1];
      const int lda = l ? p.ldh[l] : ld3;
      acc_tn<LOWP>(slot + p.off_dw[l], round_up(p.width[l + 1], 16),
                   p.width[l], p.width[l + 1], first, h[l], lda, dpre, ldd);
      acc_colsum(slot + p.off_db[l], p.width[l + 1], dpre, ldd, first);
      if (l > 0) {
        // d = dpre W^T, then dpre_{l-1} = d (.) [in_l > 0] * scale, in place
        float* in = h[l];
        weight_gemm<LOWP, true>(
            p.width[l + 1], p.width[l], dpre, ldd, p.w[l], p.ldw[l],
            [&](int m, int c, float v) {
              float* e = in + m * lda + c;
              *e = *e > 0.f ? scale * v : 0.f;
            },
            sC);
      } else {
        // dcat = dpre_0 W_0^T: dx_direct goes out; cat becomes
        // [dgx | dxd | dgy] and vb becomes [dvb_re | dvb_im]
        weight_gemm<LOWP, true>(
            p.width[1], 3 * C, dpre, ldd, p.w[0], p.ldw[0],
            [&](int m, int c, float v) {
              const int row = row0 + m;
              if (c < C) {
                if (row < V) {
                  const float d = v + g[m * ld1 + c];
                  const size_t o = (vbase + row) * C + c;
                  if (p.x_bf16)
                    reinterpret_cast<__nv_bfloat16*>(p.dx)[o] =
                        __float2bfloat16_rn(d);
                  else
                    reinterpret_cast<float*>(p.dx)[o] = d;
                }
              } else if (c < 2 * C) {
                cat[m * ld3 + c] = v;
              } else {
                const int j = c - 2 * C;
                const float f = cat[m * ld3 + c];
                const float dd = v * (1.f - f * f);
                cat[m * ld3 + j] = dd * vb[m * ld2 + j];
                cat[m * ld3 + c] = dd * vb[m * ld2 + C + j];
                vb[m * ld2 + j] = dd * g0[m * ld2 + j];
                vb[m * ld2 + C + j] = dd * g0[m * ld2 + C + j];
              }
            },
            sC);
      }
    }

    // ---- the complex map: [dgx | dgy] += dvb cmap^T; dA_re, dA_im
    weight_gemm<LOWP, true>(
        2 * C, 2 * C, vb, ld2, p.cmap, p.ld_cmap,
        [&](int m, int c, float v) {
          cat[m * ld3 + (c < C ? c : C + c)] += v;
        },
        sC);
    const int c16 = round_up(C, 16);
    acc_tn<LOWP>(slot + p.off_are, c16, C, C, first, g0, ld2, vb, ld2,
                 g0 + C, ld2, vb + C, ld2, 1.f);
    acc_tn<LOWP>(slot + p.off_aim, c16, C, C, first, g0, ld2, vb + C, ld2,
                 g0 + C, ld2, vb, ld2, -1.f);

    // ---- ds += Phi^T dxd + GY^T dgy (both resident), then + GX^T dgx
    acc_tn<LOWP>(slot, c16, K, C, first, sP, ldk, cat + C, ld3, sQ, ldk,
                 cat + 2 * C, ld3, 1.f);
    stage(sQ, ldk, p.gx, p.ops_bf16, vbase, row0, V, K);
    acc_tn<LOWP>(slot, c16, K, C, false, sQ, ldk, cat, ld3);
  }
}

// out[g][e] = sum over s of partial[g][s][off + e] in the order s = 0, 1, ...
__global__ void grad_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int G, int S,
                                   long long P, long long off, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)G * n) return;
  const long long gi = i / n, e = i % n;
  const float* src = partial + gi * S * P + off + e;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += src[(long long)s * P];
  out[i] = acc;
}

size_t smem_floats(const Args& p) {
  size_t f = (size_t)TV * (2 * p.ldk + p.ld3 + 2 * p.ld2 + p.ld1 + LDC);
  for (int l = 1; l < p.n_dense; ++l) f += (size_t)TV * p.ldh[l];
  return f;
}

}  // namespace

extern "C" {

// Launches the backward kernel on `stream`. s and dxn (null: emit_next off)
// are (B, round_up(K, 16), ld_s) and zero-padded; cmap and each ws[l] are
// laid out with rows and columns zero-padded to multiples of 16 (they are
// read as W and as W^T). partial is (B, nsplit, P), its slot layout given by
// off_are, off_aim, off_dw and off_db (ds at 0).
int mb_bwd_launch(const void* x, const void* evecs, const void* gx,
                  const void* gy, const void* mass, const void* s, int ld_s,
                  const void* cmap, int ld_cmap, const void* const* ws,
                  const int* ldw, const void* const* bs, const int* widths,
                  int n_dense, const void* dout, const void* dxn, void* dx,
                  void* partial, long long P, int off_are, int off_aim,
                  const int* off_dw, const int* off_db, int B, int V, int K,
                  int C, int nsplit, int x_bf16, int ops_bf16, int lowp,
                  int dropout, int seed, int tile_v, void* stream) {
  if (n_dense < 1 || n_dense > MAX_DENSE || K < 1 || K > MAX_KC || C < 1 ||
      C > MAX_KC || C % 8 != 0 || B < 1 || V < 1 || nsplit < 1)
    return MB_BAD_SHAPE;
  if (dropout && (tile_v < TV || tile_v % TV != 0 || V % tile_v != 0 ||
                  seed < 0 || B > 2048 || V / tile_v > 65536 ||
                  n_dense - 1 > 16))
    return MB_BAD_SHAPE;
  if (widths[0] != 3 * C || widths[n_dense] != C) return MB_BAD_SHAPE;
  if (!weight_layout_ok(cmap, ld_cmap, 2 * C) || ld_s % 16 != 0 ||
      ld_s < round_up(C, 16) || reinterpret_cast<uintptr_t>(s) % 32 != 0 ||
      reinterpret_cast<uintptr_t>(dxn) % 32 != 0 ||
      reinterpret_cast<uintptr_t>(partial) % 32 != 0 || P % 8 != 0)
    return MB_BAD_LAYOUT;
  Args p = {};
  p.x = x; p.evecs = evecs; p.gx = gx; p.gy = gy;
  p.mass = static_cast<const float*>(mass);
  p.s = static_cast<const float*>(s);
  p.ld_s = ld_s;
  p.cmap = static_cast<const float*>(cmap);
  p.ld_cmap = ld_cmap;
  for (int l = 0; l < n_dense; ++l) {
    if (widths[l + 1] < 1 || widths[l + 1] > MAX_WIDTH) return MB_BAD_SHAPE;
    // read as W (columns to a multiple of 16) and as W^T (rows too)
    if (!weight_layout_ok(ws[l], ldw[l], widths[l + 1]) ||
        (off_dw[l] % 16) != 0 || (off_db[l] % 8) != 0)
      return MB_BAD_LAYOUT;
    p.w[l] = static_cast<const float*>(ws[l]);
    p.ldw[l] = ldw[l];
    p.b[l] = static_cast<const float*>(bs[l]);
    p.off_dw[l] = off_dw[l];
    p.off_db[l] = off_db[l];
    p.ldh[l] = smem_ld(widths[l]);
  }
  for (int l = 0; l <= n_dense; ++l) p.width[l] = widths[l];
  p.n_dense = n_dense;
  p.dout = dout;
  p.dxn = static_cast<const float*>(dxn);
  p.dx = dx;
  p.partial = static_cast<float*>(partial);
  p.P = P;
  p.off_are = off_are; p.off_aim = off_aim;
  if (off_are % 16 != 0 || off_aim % 16 != 0) return MB_BAD_LAYOUT;
  p.B = B; p.V = V; p.K = K; p.C = C;
  p.n_tiles = (V + TV - 1) / TV;
  p.nsplit = nsplit < p.n_tiles ? nsplit : p.n_tiles;
  if (p.nsplit != nsplit) return MB_BAD_SHAPE;  // partial is sized by nsplit
  p.x_bf16 = x_bf16; p.ops_bf16 = ops_bf16;
  p.drop = {dropout, seed, tile_v};
  p.ldk = smem_ld(K);
  p.ld1 = smem_ld(C);
  p.ld2 = smem_ld(2 * C);
  p.ld3 = smem_ld(3 * C);

  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  p.smem_n = (int)smem_floats(p);
  const size_t smem = sizeof(float) * p.smem_n;
  if (smem > (size_t)max_smem) return MB_SMEM;
  auto kernel = lowp ? megablock_bwd_kernel<true> : megablock_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nsplit, B), NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// partial: (G, S, P) slots; out: (G, n) = sums of elements [off, off + n).
int mb_grad_reduce_launch(const void* partial, void* out, int G, int S,
                          long long P, long long off, int n, void* stream) {
  if (G < 1 || S < 1 || n < 1 || off < 0 || off + n > P) return MB_BAD_SHAPE;
  const int threads = 256;
  const long long blocks = ((long long)G * n + threads - 1) / threads;
  grad_reduce_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), G, S, P,
      off, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
