// Whole-DiffusionNet-block forward for Hopper (sm_90a), chained form: the
// wide route. B1's main kernel is the 64-row wgmma row kernel of
// megablock_fwd.cu; the wrapper (ops/megablock.py::fwd_route) sends here,
// before launch, the shapes that kernel does not take: C % 8 != 0, or MLP
// widths whose 64-row shared buffers exceed the card's shared memory
// (hidden widths up to 1024 and 8 layers at C = 256).
//
// Replaces, for those shapes, the TPU kernel `_make_fwd_kernel_chained`
// (diffusionnet_tpu/ops/pallas_megablock.py:259, launched at :366). Given this
// block's x_hat (B,K,C) it computes, per batch element b and row tile of V:
//
//   s     = coefs (.) x_hat
//   xd    = Phi s;   gx = GX s;   gy = GY s
//   vb_re = gx A_re - gy A_im;   vb_im = gy A_re + gx A_im
//   feat  = tanh(gx (.) vb_re + gy (.) vb_im)
//   out   = MLP([x, xd, feat]) + x   (Dense, [Dropout]-ReLU-Dense, ...)
//
// and, with emit_next, the next block's x_hat = Phi^T (m (.) out). Only `out`
// and the x_hat partials reach device memory; every intermediate of a tile
// stays in shared memory.
//
// What bounds it on this card. Arithmetic bounds the function (see
// megablock_fwd.cu). This version runs on WMMA (TF32 16x16x8, f32
// accumulation; f32 operands split into TF32 hi + lo parts and multiplied in
// three passes, bf16-rounded operands in one) and is latency-bound: a tile
// is only 32 rows (16 where 32 rows' buffers exceed shared memory), so each
// warp owns one 16x16 output block and its products are short dependent
// chains. On an H100 80GB HBM3 at a 700 W power limit it ran at about 9% of
// its bound at K = C = 128. It takes any K, C and widths whose buffers fit:
//
//  * The row tile TV is 32 rows, or 16 where 32 rows' buffers exceed the
//    card's shared memory (a template parameter; the wrapper picks it from
//    the same byte count as `smem_bytes` here). At TV = 16 a warp's 16x16
//    block sits in one row block, so a product pass covers 256 columns.
//  * Shared memory per CTA, in floats: TV (36 + 132 + NP + 4) for the
//    staged operator chunk, the Phi tile of the x_hat product and the
//    warps' output patches, TV (round8(3C) + 4) for [x | xd | feat],
//    2 TV (round8(max(2C, widths)) + 4) for the MLP's ping-pong buffers,
//    and 128 x 132 for a resident s. At K = C = 128, hidden [128, 128] and
//    TV = 32 that is 217 KB (s resident, as before the lift); at
//    K = C = 256, hidden [256, 256] 263 KB at TV = 32 and 140 KB at
//    TV = 16; at C = 256 and hidden 1024, 204 KB at TV = 16.
//
// What the design does about the two things that do not carry over from the
// TPU kernel:
//  * The weights do not fit in shared memory (7 C^2 values = 448 KiB in f32
//    at C = 128; a CTA addresses 227 KB). They stay in global memory, where
//    they are L2-resident for every CTA, and each warp streams its own
//    fragments of them straight into registers, a few k-steps ahead, with
//    no barrier inside the contraction. The activations (the A operands of
//    the complex map and the MLP) are resident in shared memory. Only the
//    operator rows (Phi, GX, GY: the A operands of the spectral products) are
//    staged through shared memory, in 32-column chunks, against s = coefs
//    (.) x_hat (K x C per batch element). Where K, C <= 128 s is resident
//    in shared memory (66 KB); wider, it is read like the weights, as
//    fragments from L2 (256 KB at K = C = 256), each chunk's four fetched
//    before the chunk's barrier.
//  * The x_hat_next sum crosses tiles, and tiles run in parallel. Each CTA
//    owns a fixed, strided set of tiles of one batch element and, for each
//    128 x 128 piece of (K, C), a private f32 slot in device memory
//    (L2-resident, the slot layout of spectral_project), which it updates
//    tile after tile with no other writer. `xhat_reduce_kernel`
//    (megablock_fwd.cu) sums the nsplit slots of each piece in a fixed
//    order. Deterministic: no floating-point atomics.
//
// bf16 ("lowp"): as in the TPU kernel's `_dot`, both operands of every
// product are rounded to bf16 (round to nearest even) and accumulated in
// f32: s, Phi/GX/GY, gx and gy before the complex map, the MLP activations,
// the weights, and m (.) out for the x_hat sum. Operands are rounded where
// they enter a product, so elementwise work (tanh, bias, ReLU, residual)
// sees f32; `out` is stored in x's dtype while x_hat_next accumulates from
// the f32 `out`.
//
// Dropout (training): the mask of a hidden activation comes from the JAX
// kernel's interpret-mode hash over (seed, batch, tile of tile_v rows,
// layer) (`Dropout` in megablock_common.cuh), so it is bit-identical to
// `interpret_dropout_mask` and to the plain version's. The kernel's own
// TV-row tile lies inside one tile_v tile (the wrapper checks tile_v % TV
// == 0), and the mask is applied to the f32 activation before it is rounded
// for the next product, as `_mlp_fwd` does.
//
// Padding: rows at or past V are masked inside the kernel (any V works);
// padded rows inside V carry mass 0 and zero operator rows.

#include "megablock_common.cuh"

namespace {

using namespace mb;

constexpr int KC = 32;           // operator columns staged per chunk
constexpr int LDA = KC + PAD;    // staged operator chunk: TV x KC
constexpr int LDB = SLOT + PAD;  // staged Phi piece for the x_hat product
constexpr int LDS = SLOT + PAD;  // resident s (K, C <= SLOT): SLOT x LDS

struct Args {
  const void* x;      // (B,V,C) f32 or bf16
  const void* evecs;  // (B,V,K) f32 or bf16 (gx, gy the same dtype)
  const void* gx;
  const void* gy;
  const float* mass;  // (B,V)
  const float* s;     // (B,K32,ld_s): coefs (.) x_hat_in, zero-padded
  int ld_s;
  const float* cmap;  // [[A_re, A_im], [-A_im, A_re]], row stride ld_cmap
  int ld_cmap;
  const float* w[MAX_DENSE];  // (width[l], width[l+1]), row stride ldw[l]
  int ldw[MAX_DENSE];
  const float* b[MAX_DENSE];  // (width[l+1],)
  int width[MAX_DENSE + 1];
  int n_dense;
  void* out;       // (B,V,C) in x's dtype
  float* partial;  // (B,nkt,nct,nsplit,SLOT,SLOT) slots, or null
  int B, V, K, C;
  int n_tiles, nsplit, nkt, nct;
  int x_bf16, ops_bf16;
  int ldc, ldp;  // row strides of [x | xd | feat] and the activation buffers
  Dropout drop;
};

// A spectral product of one tile: epi(m, n, sum_k Op[m][k] s[k][n]) for
// m < TV, n < C. fetchA(m, k) loads a raw operator element (0 outside the
// mesh). The operator rows are staged through sA in KC-column chunks; the
// next chunk's loads are in flight while the tensor cores work on this one.
// RES (K, C <= SLOT): s is resident in shared memory (sS, row stride LDS,
// rounded for LOWP, zero past K and C). Else s stays in global memory (row
// stride ld_s, zero past K up to a multiple of KC and past C up to one of
// 16); each warp fetches its chunk's KC / 8 fragments of it before the
// chunk's barrier. C is covered in passes of NP columns; warp w owns the
// 16x16 output block (w % RB, w / RB).
template <bool LOWP, int TV, bool RES, class FA, class EPI>
__device__ __forceinline__ void spectral_gemm(int K, int C, FA fetchA,
                                              int ops_bf16, const float* s,
                                              int ld_s, const float* sS,
                                              EPI epi, float* sA, float* sC) {
  constexpr int PA = TV * KC / NT;  // staged elements per thread
  constexpr int RB = Tile<TV>::RB, NP = Tile<TV>::NP;
  const int tid = threadIdx.x, warp = tid / 32;
  const int rb = warp % RB, cb = warp / RB;
  float ra[PA];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < PA; ++r) {
      const int i = tid + r * NT;
      ra[r] = fetchA(i / KC, k0 + i % KC);
    }
  };
  if constexpr (RES) {  // one pass: C <= SLOT = NP
    const int c0 = cb * 16;
    const bool live = c0 < C;  // warp-uniform
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();  // the previous chunk's readers of sA are done
#pragma unroll
      for (int r = 0; r < PA; ++r) {
        const int i = tid + r * NT;
        sA[(i / KC) * LDA + i % KC] = rnd<LOWP>(from_raw(ra[r], ops_bf16));
      }
      __syncthreads();
      if (k0 + KC < K) fetch(k0 + KC);
      if (!live) continue;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        FragA a_hi, a_lo;
        wmma::load_matrix_sync(a_hi, sA + rb * 16 * LDA + kk, LDA);
        split<LOWP>(a_hi, a_lo);
        FragB b_hi, b_lo;
        wmma::load_matrix_sync(b_hi, sS + (k0 + kk) * LDS + c0, LDS);
        split<LOWP>(b_hi, b_lo);
        mma3<LOWP>(acc, a_hi, a_lo, b_hi, b_lo);
      }
    }
    if (live) warp_epilogue<TV>(acc, rb, cb, c0, C, epi, sC);
    return;
  }
  for (int n0 = 0; n0 < C; n0 += NP) {
    const int c0 = n0 + cb * 16;
    const bool live = c0 < C;  // warp-uniform
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += KC) {
      FragB bf[KC / 8];
      if (live) {
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
          wmma::load_matrix_sync(bf[j], s + (size_t)(k0 + 8 * j) * ld_s + c0,
                                 ld_s);
      }
      __syncthreads();  // the previous chunk's readers of sA are done
#pragma unroll
      for (int r = 0; r < PA; ++r) {
        const int i = tid + r * NT;
        sA[(i / KC) * LDA + i % KC] = rnd<LOWP>(from_raw(ra[r], ops_bf16));
      }
      __syncthreads();
      if (k0 + KC < K) fetch(k0 + KC);
      if (!live) continue;
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        FragA a_hi, a_lo;
        wmma::load_matrix_sync(a_hi, sA + rb * 16 * LDA + 8 * j, LDA);
        split<LOWP>(a_hi, a_lo);
        FragB b_lo;
        operands<LOWP>(bf[j], b_lo);
        mma3<LOWP>(acc, a_hi, a_lo, bf[j], b_lo);
      }
    }
    if (live) warp_epilogue<TV>(acc, rb, cb, c0, C, epi, sC);
  }
}

template <bool LOWP, int TV, bool RES>
__global__ void __launch_bounds__(NT, 1) megablock_fwd_kernel(const Args p) {
  extern __shared__ __align__(128) float smem[];
  constexpr int LDC = Tile<TV>::LDC;
  const int C = p.C, K = p.K, V = p.V;
  const int ldc = p.ldc, ldp = p.ldp;
  float* sA = smem;                 // TV x LDA: staged operator chunk
  float* sB = sA + TV * LDA;        // TV x LDB: Phi piece for the x_hat product
  float* sC = sB + TV * LDB;        // TV x LDC: output patches
  float* sS = sC + TV * LDC;        // RES: SLOT x LDS, s resident
  float* cat = sS + (RES ? SLOT * LDS : 0);  // TV x ldc: [x | xd | feat]
  float* p0 = cat + TV * ldc;       // TV x ldp: [gx | gy], then MLP ping
  float* p1 = p0 + TV * ldp;        // TV x ldp: [vb_re | vb_im], MLP pong

  const int b = blockIdx.y, split_id = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32;
  const int ops_bf16 = p.ops_bf16, x_bf16 = p.x_bf16;
  const size_t vbase = (size_t)b * V;
  const float* s = p.s + (size_t)b * round_up(K, KC) * p.ld_s;

  if (RES) {  // s of this CTA's batch element, resident for all its tiles
    constexpr int R = 16;
    for (int base = 0; base < SLOT * LDS; base += R * NT) {
      float rs[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = base + tid + r * NT, k = i / LDS, n = i % LDS;
        rs[r] = (i < SLOT * LDS && k < K && n < C) ? s[k * p.ld_s + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = base + tid + r * NT;
        if (i < SLOT * LDS) sS[i] = rnd<LOWP>(rs[r]);
      }
    }
  }
  // the weight products read their A operands up to a multiple of 8
  // columns: what lies past a width must be finite
  for (int i = tid; i < TV * (ldc + 2 * ldp); i += NT) cat[i] = 0.f;

  for (int tile = split_id; tile < p.n_tiles; tile += p.nsplit) {
    const int row0 = tile * TV;
    auto op_rows = [&](const void* op) {
      return [=](int m, int k) {
        const int row = row0 + m;
        return (row < V && k < K) ? raw_load(op, (vbase + row) * K + k, ops_bf16)
                                  : 0.f;
      };
    };

    __syncthreads();  // the previous tile is done with cat/p0/p1, sB, sC
    if constexpr (RES) {  // C <= SLOT: TV * SLOT / NT loads a thread
      constexpr int R = TV * SLOT / NT;
      float rx[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * NT, row = row0 + i / C;
        rx[r] = (i < TV * C && row < V)
                    ? raw_load(p.x, (vbase + row) * C + i % C, x_bf16)
                    : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * NT;
        if (i < TV * C) cat[(i / C) * ldc + i % C] = from_raw(rx[r], x_bf16);
      }
    } else for (int base = 0; base < TV * C; base += 4 * NT) {
      float rx[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = base + tid + r * NT, row = row0 + i / C;
        rx[r] = (i < TV * C && row < V)
                    ? raw_load(p.x, (vbase + row) * C + i % C, x_bf16)
                    : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = base + tid + r * NT;
        if (i < TV * C) cat[(i / C) * ldc + i % C] = from_raw(rx[r], x_bf16);
      }
    }

    // spectral products Phi s, GX s, GY s
    spectral_gemm<LOWP, TV, RES>(
        K, C, op_rows(p.evecs), ops_bf16, s, p.ld_s, sS,
        [&](int m, int n, float v) { cat[m * ldc + C + n] = v; }, sA, sC);
    spectral_gemm<LOWP, TV, RES>(
        K, C, op_rows(p.gx), ops_bf16, s, p.ld_s, sS,
        [&](int m, int n, float v) { p0[m * ldp + n] = v; }, sA, sC);
    spectral_gemm<LOWP, TV, RES>(
        K, C, op_rows(p.gy), ops_bf16, s, p.ld_s, sS,
        [&](int m, int n, float v) { p0[m * ldp + C + n] = v; }, sA, sC);

    // [vb_re | vb_im] = [gx | gy] [[A_re, A_im], [-A_im, A_re]]
    weight_gemm<LOWP, TV>(2 * C, 2 * C, p0, ldp, p.cmap, p.ld_cmap,
                          [&](int m, int n, float v) { p1[m * ldp + n] = v; },
                          sC);

    __syncthreads();
    for (int i = tid; i < TV * C; i += NT) {
      const int m = i / C, c = i % C;
      const float gxv = p0[m * ldp + c], gyv = p0[m * ldp + C + c];
      cat[m * ldc + 2 * C + c] =
          tanhf(gxv * p1[m * ldp + c] + gyv * p1[m * ldp + C + c]);
    }

    // MLP: cat -> p0 -> p1 -> p0 ...; the last layer adds the residual x
    const float* src = cat;
    int lds = ldc;
    for (int l = 0; l < p.n_dense; ++l) {
      float* dst = (l % 2 == 0) ? p0 : p1;
      const float* bias = p.b[l];
      const bool last = l == p.n_dense - 1;
      const int width = p.width[l + 1];
      weight_gemm<LOWP, TV>(
          p.width[l], width, src, lds, p.w[l], p.ldw[l],
          [&](int m, int n, float v) {
            v += bias[n];
            dst[m * ldp + n] =
                last ? v + cat[m * ldc + n]
                     : p.drop.apply(fmaxf(v, 0.f), b, row0 + m, n, width, l);
          },
          sC);
      src = dst;
      lds = ldp;
    }

    __syncthreads();
    for (int i = tid; i < TV * C; i += NT) {
      const int m = i / C, c = i % C, row = row0 + m;
      if (row >= V) continue;
      const float v = src[m * ldp + c];
      const size_t o = (vbase + row) * C + c;
      if (x_bf16)
        reinterpret_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
      else
        reinterpret_cast<float*>(p.out)[o] = v;
    }

    if (p.partial == nullptr) continue;
    // x_hat_next partial += Phi_tile^T (m (.) out_tile), one SLOT x SLOT
    // piece of (K, C) at a time: a (SLOT x TV) (TV x SLOT) product; the
    // piece's Phi columns go to sB, read as Phi^T (col-major A), and its
    // m (.) out columns to sC. Unused rows and columns are zero. Warp w
    // owns the 16x16 blocks (w % 8, 4 (w / 8) + {0..3}) of the piece.
    constexpr int R = TV * SLOT / NT;
    const int nkt = RES ? 1 : p.nkt, nct = RES ? 1 : p.nct;
    for (int kt = 0; kt < nkt; ++kt) {
      for (int ct = 0; ct < nct; ++ct) {
        const int k0 = kt * SLOT, c0 = ct * SLOT;
        float rp[R], rm[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = tid + r * NT, kk = i / SLOT, n = i % SLOT;
          const int row = row0 + kk;
          rp[r] = (row < V && k0 + n < K)
                      ? raw_load(p.evecs, (vbase + row) * K + k0 + n, ops_bf16)
                      : 0.f;
          rm[r] = (row < V && c0 + n < C) ? p.mass[vbase + row] : 0.f;
        }
        if (kt | ct) __syncthreads();  // the last piece's readers are done
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = tid + r * NT, kk = i / SLOT, n = i % SLOT;
          sB[kk * LDB + n] = rnd<LOWP>(from_raw(rp[r], ops_bf16));
          sC[kk * LDC + n] =
              rnd<LOWP>(c0 + n < C ? rm[r] * src[kk * ldp + c0 + n] : 0.f);
        }
        __syncthreads();
        const int kb = warp % 8, cb0 = (warp / 8) * 4;
        if (k0 + kb * 16 >= K) continue;  // warp-uniform
        const bool first = tile == split_id;
        float* slot = p.partial +
                      ((((size_t)b * nkt + kt) * nct + ct) * p.nsplit +
                       split_id) * SLOT * SLOT +
                      kb * 16 * SLOT;
        FragC xacc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c0 + (cb0 + j) * 16 >= C) continue;
          if (first)
            wmma::fill_fragment(xacc[j], 0.f);
          else
            wmma::load_matrix_sync(xacc[j], slot + (cb0 + j) * 16, SLOT,
                                   wmma::mem_row_major);
        }
#pragma unroll
        for (int kk = 0; kk < TV; kk += 8) {
          FragAT a_hi, a_lo;
          wmma::load_matrix_sync(a_hi, sB + kk * LDB + kb * 16, LDB);
          split<LOWP>(a_hi, a_lo);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c0 + (cb0 + j) * 16 >= C) continue;
            FragB b_hi, b_lo;
            wmma::load_matrix_sync(b_hi, sC + kk * LDC + (cb0 + j) * 16, LDC);
            split<LOWP>(b_hi, b_lo);
            mma3<LOWP>(xacc[j], a_hi, a_lo, b_hi, b_lo);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + (cb0 + j) * 16 < C)
            wmma::store_matrix_sync(slot + (cb0 + j) * 16, xacc[j], SLOT,
                                    wmma::mem_row_major);
      }
    }
  }
}

// Shared memory of B1's CTA, in bytes (ops/megablock.py::fwd_smem_bytes
// computes the same from the shapes).
size_t smem_bytes(int tv, int res, int ldc, int ldp) {
  const int np = tv == 16 ? Tile<16>::NP : Tile<32>::NP;
  return sizeof(float) *
         ((size_t)tv * ((size_t)LDA + LDB + (np + PAD) + ldc + 2 * (size_t)ldp) +
          (res ? (size_t)SLOT * LDS : 0));
}

template <bool LOWP>
void* fwd_kernel(int tv, int res) {
  if (tv == 16) return (void*)megablock_fwd_kernel<LOWP, 16, false>;
  return res ? (void*)megablock_fwd_kernel<LOWP, 32, true>
             : (void*)megablock_fwd_kernel<LOWP, 32, false>;
}

}  // namespace

extern "C" {

// Launches the wide route's block kernel on `stream`. `partial` null: emit_next off;
// else (B, nkt, nct, nsplit, SLOT, SLOT) with nkt = ceil(K / SLOT) and
// nct = ceil(C / SLOT). s is (B, round_up(K, 32), ld_s), zero-padded; cmap
// is [[A_re, A_im], [-A_im, A_re]] and each ws[l] the l-th MLP kernel, laid
// out as weight_gemm reads them (zero rows up to a multiple of 8). tv: the
// row tile, 32 or 16; res (tv 32, K, C <= SLOT): s resident in shared
// memory, else read from L2. dropout 0: off; else masks from (seed, b,
// row / tile_v, layer).
int mb_fwd_wide_launch(const void* x, const void* evecs, const void* gx,
                  const void* gy, const void* mass, const void* s, int ld_s,
                  const void* cmap, int ld_cmap, const void* const* ws,
                  const int* ldw, const void* const* bs, const int* widths,
                  int n_dense, void* out, void* partial, int B, int V, int K,
                  int C, int nsplit, int tv, int res, int x_bf16,
                  int ops_bf16, int lowp, int dropout, int seed, int tile_v,
                  void* stream) {
  if ((tv != 16 && tv != 32) || (res && (tv != 32 || K > SLOT || C > SLOT)))
    return MB_BAD_SHAPE;
  if (dropout && (tile_v < tv || tile_v % tv != 0 || V % tile_v != 0 ||
                  seed < 0 || B > 2048 || V / tile_v > 65536 ||
                  n_dense - 1 > 16))
    return MB_BAD_SHAPE;
  if (n_dense < 1 || n_dense > MAX_DENSE || K < 1 || C < 1 || B < 1 ||
      V < 1 || nsplit < 1)
    return MB_BAD_SHAPE;
  if (widths[0] != 3 * C || widths[n_dense] != C) return MB_BAD_SHAPE;
  if (!weight_layout_ok(cmap, ld_cmap, 2 * C) || !weight_layout_ok(s, ld_s, C))
    return MB_BAD_LAYOUT;
  Args p = {};
  p.x = x; p.evecs = evecs; p.gx = gx; p.gy = gy;
  p.mass = static_cast<const float*>(mass);
  p.s = static_cast<const float*>(s);
  p.ld_s = ld_s;
  p.cmap = static_cast<const float*>(cmap);
  p.ld_cmap = ld_cmap;
  int widest = 2 * C;
  for (int l = 0; l < n_dense; ++l) {
    if (widths[l + 1] < 1) return MB_BAD_SHAPE;
    if (!weight_layout_ok(ws[l], ldw[l], widths[l + 1])) return MB_BAD_LAYOUT;
    p.w[l] = static_cast<const float*>(ws[l]);
    p.ldw[l] = ldw[l];
    p.b[l] = static_cast<const float*>(bs[l]);
    if (widths[l + 1] > widest) widest = widths[l + 1];
  }
  for (int l = 0; l <= n_dense; ++l) p.width[l] = widths[l];
  p.n_dense = n_dense;
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.B = B; p.V = V; p.K = K; p.C = C;
  p.n_tiles = (V + tv - 1) / tv;
  p.nsplit = nsplit < p.n_tiles ? nsplit : p.n_tiles;
  if (p.nsplit != nsplit) return MB_BAD_SHAPE;  // partial is sized by nsplit
  p.nkt = (K + SLOT - 1) / SLOT;
  p.nct = (C + SLOT - 1) / SLOT;
  p.x_bf16 = x_bf16; p.ops_bf16 = ops_bf16;
  p.drop = {dropout, seed, tile_v};
  // padded to 4 mod 32 floats: the rows of a fragment fall in other banks
  p.ldc = round_up(3 * C, 8) + PAD;
  p.ldp = round_up(widest, 8) + PAD;

  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t smem = smem_bytes(tv, res, p.ldc, p.ldp);
  if (smem > (size_t)max_smem) return MB_SMEM;
  void* kernel = lowp ? fwd_kernel<true>(tv, res) : fwd_kernel<false>(tv, res);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3(nsplit, B), dim3(NT), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
