// Whole-DiffusionNet-block forward for Hopper (sm_90a), chained form.
//
// Replaces the TPU kernel `_make_fwd_kernel_chained`
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
// What bounds it on this card. At K = C = 128 with hidden [128, 128] a vertex
// costs 212,992 multiply-adds (Phi/GX/GY products 3KC, the complex map 4C^2,
// the MLP 5C^2, the x_hat product KC), 426 kflop, against ~2.6 KB of device
// memory traffic in f32 (operator rows, x, out) or ~1.3 KB with bf16
// operands: 165 to 330 flop per byte. Arithmetic bounds it, so every product
// runs on the tensor cores (WMMA, TF32 16x16x8, f32 accumulation). f32
// operands are split into TF32 hi + lo parts and multiplied in three passes
// (near-f32 accuracy); bf16-rounded operands (lowp) are exact in TF32 and
// take one pass. In this version the tensor cores are not the limit: latency
// is. A tile is only 32 rows (shared memory holds one CTA of 16 warps per SM),
// so each warp owns one 16x16 output block and its products are short
// dependent chains. On an H100 80GB HBM3 at a 700 W power limit, one block
// at B = 1, V = 32768 ran at 14 TFLOP/s in f32 (about 9% of what three TF32
// passes allow) and 21 TFLOP/s with bf16 operands.
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
//    staged through shared memory, against s = coefs (.) x_hat (K x C, one
//    per batch element), which is resident.
//  * The x_hat_next sum crosses tiles, and tiles run in parallel. Each CTA
//    owns a fixed, strided set of tiles of one batch element and a private
//    (MAX_KC, MAX_KC) f32 slot in device memory (L2-resident), which it
//    updates tile after tile with no other writer. A second launch in this
//    file (`xhat_reduce_kernel`) sums the nsplit slots in a fixed order.
//    Deterministic: no floating-point atomics.
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
// 32-row tile lies inside one tile_v tile (the wrapper checks tile_v % 32
// == 0), and the mask is applied to the f32 activation before it is rounded
// for the next product, as `_mlp_fwd` does.
//
// Padding: rows at or past V are masked inside the kernel (any V works);
// padded rows inside V carry mass 0 and zero operator rows.

#include "megablock_common.cuh"

namespace {

using namespace mb;

constexpr int KC = 32;         // operator columns staged per chunk
constexpr int LDA = KC + PAD;  // staged operator chunk: TV x KC
constexpr int LDB = NP + PAD;  // staged Phi tile for the x_hat product
constexpr int LDS = NP + PAD;  // resident s: MAX_KC x NP
static_assert(KC == TV && NP == MAX_KC,
              "the x_hat product stages Phi^T in sB and m (.) out in sC");
static_assert((MAX_KC / 16) * (MAX_KC / 16) == 4 * (NT / 32),
              "four 16x16 blocks of the x_hat partial per warp");

struct Args {
  const void* x;      // (B,V,C) f32 or bf16
  const void* evecs;  // (B,V,K) f32 or bf16 (gx, gy the same dtype)
  const void* gx;
  const void* gy;
  const float* mass;   // (B,V)
  const float* coefs;  // (B,K,C)
  const float* cmap;   // [[A_re, A_im], [-A_im, A_re]], row stride ld_cmap
  int ld_cmap;
  const float* w[MAX_DENSE];  // (width[l], width[l+1]), row stride ldw[l]
  int ldw[MAX_DENSE];
  const float* b[MAX_DENSE];  // (width[l+1],)
  int width[MAX_DENSE + 1];
  int n_dense;
  const float* xhat_in;  // (B,K,C)
  void* out;             // (B,V,C) in x's dtype
  float* partial;        // (B,nsplit,MAX_KC,MAX_KC) slots, or null
  int B, V, K, C;
  int n_tiles, nsplit;
  int x_bf16, ops_bf16;
  int ldc, ldp;  // row strides of [x | xd | feat] and the activation buffers
  Dropout drop;
};

// A spectral product of one tile: epi(m, n, sum_k Op[m][k] s[k][n]) for
// m < TV, n < C. fetchA(m, k) loads a raw operator element (0 outside the
// mesh). The operator rows are staged through sA in KC-column chunks; the
// next chunk's loads are in flight while the tensor cores work on this one.
// s is resident (row stride LDS, zero past K and C). Warp w owns the 16x16
// output block (w % 2, w / 2).
template <bool LOWP, class FA, class EPI>
__device__ __forceinline__ void spectral_gemm(int K, int C, FA fetchA,
                                              int ops_bf16, const float* sS,
                                              EPI epi, float* sA, float* sC) {
  constexpr int PA = TV * KC / NT;  // staged elements per thread
  const int tid = threadIdx.x, warp = tid / 32;
  const int rb = warp % 2, cb = warp / 2;
  const bool live = cb * 16 < C;  // warp-uniform
  float ra[PA];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < PA; ++r) {
      const int i = tid + r * NT;
      ra[r] = fetchA(i / KC, k0 + i % KC);
    }
  };
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
      wmma::load_matrix_sync(b_hi, sS + (k0 + kk) * LDS + cb * 16, LDS);
      split<LOWP>(b_hi, b_lo);
      mma3<LOWP>(acc, a_hi, a_lo, b_hi, b_lo);
    }
  }
  if (live) warp_epilogue(acc, rb, cb, cb * 16, C, epi, sC);
}

template <bool LOWP>
__global__ void __launch_bounds__(NT, 1) megablock_fwd_kernel(const Args p) {
  extern __shared__ __align__(128) float smem[];
  const int C = p.C, K = p.K, V = p.V;
  const int ldc = p.ldc, ldp = p.ldp;
  float* sA = smem;                 // TV x LDA: staged operator chunk
  float* sB = sA + TV * LDA;        // TV x LDB: Phi tile for the x_hat product
  float* sC = sB + TV * LDB;        // TV x LDC: output patches
  float* sS = sC + TV * LDC;        // MAX_KC x LDS: s = coefs (.) x_hat
  float* cat = sS + MAX_KC * LDS;   // TV x ldc: [x | xd | feat]
  float* p0 = cat + TV * ldc;       // TV x ldp: [gx | gy], then MLP ping
  float* p1 = p0 + TV * ldp;        // TV x ldp: [vb_re | vb_im], MLP pong

  const int b = blockIdx.y, split_id = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32;
  const int ops_bf16 = p.ops_bf16, x_bf16 = p.x_bf16;
  const size_t vbase = (size_t)b * V;

  {  // s for this CTA's batch element, resident for all its tiles
    const float* coefs = p.coefs + (size_t)b * K * C;
    const float* xhat = p.xhat_in + (size_t)b * K * C;
    constexpr int R = 16;
    for (int base = 0; base < MAX_KC * LDS; base += R * NT) {
      float rc[R], rx[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = base + tid + r * NT, k = i / LDS, n = i % LDS;
        const bool in = i < MAX_KC * LDS && k < K && n < C;
        rc[r] = in ? coefs[k * C + n] : 0.f;
        rx[r] = in ? xhat[k * C + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = base + tid + r * NT;
        if (i < MAX_KC * LDS) sS[i] = rnd<LOWP>(rc[r] * rx[r]);
      }
    }
  }
  // the weight products read their A operands up to a multiple of 8
  // columns: what lies past a width must be finite
  for (int i = tid; i < TV * (ldc + 2 * ldp); i += NT) cat[i] = 0.f;

  // this CTA's (MAX_KC, MAX_KC) slot of the x_hat partials; warp w owns the
  // 16x16 blocks (w % 8, 4 (w / 8) + {0..3}). The slot stays in L2 between
  // tiles.
  float* xpart =
      p.partial + ((size_t)b * p.nsplit + split_id) * MAX_KC * MAX_KC;

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
    {
      constexpr int R = TV * MAX_KC / NT;
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
    }

    // spectral products Phi s, GX s, GY s; s resident
    spectral_gemm<LOWP>(K, C, op_rows(p.evecs), ops_bf16, sS,
                        [&](int m, int n, float v) { cat[m * ldc + C + n] = v; },
                        sA, sC);
    spectral_gemm<LOWP>(K, C, op_rows(p.gx), ops_bf16, sS,
                        [&](int m, int n, float v) { p0[m * ldp + n] = v; }, sA,
                        sC);
    spectral_gemm<LOWP>(K, C, op_rows(p.gy), ops_bf16, sS,
                        [&](int m, int n, float v) { p0[m * ldp + C + n] = v; },
                        sA, sC);

    // [vb_re | vb_im] = [gx | gy] [[A_re, A_im], [-A_im, A_re]]
    weight_gemm<LOWP, false>(2 * C, 2 * C, p0, ldp, p.cmap, p.ld_cmap,
                      [&](int m, int n, float v) { p1[m * ldp + n] = v; }, sC);

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
      weight_gemm<LOWP, false>(
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

    if (p.partial != nullptr) {
      // x_hat_next partial += Phi_tile^T (m (.) out_tile): a (K x TV) (TV x C)
      // product; Phi_tile (TV x K) goes to sB, read as Phi^T (col-major A),
      // and m (.) out to sC. Unused rows and columns are zero.
      constexpr int R = TV * MAX_KC / NT;
      float rp[R], rm[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * NT, kk = i / MAX_KC, n = i % MAX_KC;
        const int row = row0 + kk;
        rp[r] = (row < V && n < K)
                    ? raw_load(p.evecs, (vbase + row) * K + n, ops_bf16)
                    : 0.f;
        rm[r] = (row < V && n < C) ? p.mass[vbase + row] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * NT, kk = i / MAX_KC, n = i % MAX_KC;
        sB[kk * LDB + n] = rnd<LOWP>(from_raw(rp[r], ops_bf16));
        sC[kk * LDC + n] = rnd<LOWP>(n < C ? rm[r] * src[kk * ldp + n] : 0.f);
      }
      __syncthreads();
      const int kb = warp % 8, cb0 = (warp / 8) * 4;
      if (kb * 16 < K) {  // warp-uniform
        const bool first = tile == split_id;
        float* slot = xpart + kb * 16 * MAX_KC;
        FragC xacc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((cb0 + j) * 16 >= C) continue;
          if (first)
            wmma::fill_fragment(xacc[j], 0.f);
          else
            wmma::load_matrix_sync(xacc[j], slot + (cb0 + j) * 16, MAX_KC,
                                   wmma::mem_row_major);
        }
#pragma unroll
        for (int kk = 0; kk < TV; kk += 8) {
          FragAT a_hi, a_lo;
          wmma::load_matrix_sync(a_hi, sB + kk * LDB + kb * 16, LDB);
          split<LOWP>(a_hi, a_lo);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((cb0 + j) * 16 >= C) continue;
            FragB b_hi, b_lo;
            wmma::load_matrix_sync(b_hi, sC + kk * LDC + (cb0 + j) * 16, LDC);
            split<LOWP>(b_hi, b_lo);
            mma3<LOWP>(xacc[j], a_hi, a_lo, b_hi, b_lo);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if ((cb0 + j) * 16 < C)
            wmma::store_matrix_sync(slot + (cb0 + j) * 16, xacc[j], MAX_KC,
                                    wmma::mem_row_major);
      }
    }
  }
}

// x_hat_next[b][k][c] = sum over s of partial[b, s, k, c], partial slots
// (MAX_KC, MAX_KC) of which the (K, C) corner is used. Replaces the TPU
// kernel's in-VMEM carry of x_hat across its sequential grid
// (pallas_megablock.py:305); torch.sum of the slots is the library yardstick.
//
// The order, fixed and the same in ops/megablock.py::xhat_reduce_reference:
// the S slots are cut into XR_CHUNKS chunks of L = ceil(S / XR_CHUNKS)
// consecutive slots (the last ones may be short or empty); each chunk is
// summed from +0 in ascending s, and the chunk sums are added from +0 in
// ascending chunk order. No atomics: the result is the same bit for bit on
// every run, and equal to the plain version's.
//
// What bounds it: the S (K, C) slots, read once (8.7 MB at S = 132,
// K = C = 128, from L2 when the kernel that wrote them has just run). One
// CTA per (batch element, row k, 64 columns): 256 CTAs at B = 1, K = C =
// 128, over 132 SMs. Its 256 threads are 16 chunks x 16 float4 columns, so
// each thread issues L independent 16-byte loads, a warp reading two whole
// 256-byte slot rows per load; the 16 chunk sums of each column meet in
// shared memory, and 64 threads add them in order and store 64 floats.
constexpr int XR_CHUNKS = 16;
constexpr int XR_COLS = 64;  // columns per CTA

__global__ void __launch_bounds__(XR_CHUNKS * XR_COLS / 4)
    xhat_reduce_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int nsplit, int K, int C) {
  __shared__ float4 part[XR_CHUNKS][XR_COLS / 4];
  const int f = threadIdx.x % (XR_COLS / 4);  // float4 column in the tile
  const int g = threadIdx.x / (XR_COLS / 4);  // chunk
  const int k = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x * XR_COLS;
  const int len = (nsplit + XR_CHUNKS - 1) / XR_CHUNKS;
  const int s0 = g * len;
  const int s1 = min(nsplit, s0 + len);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 + 4 * f < C) {  // c0 + 4 f + 3 < MAX_KC: the slot row holds it
    const float4* src = reinterpret_cast<const float4*>(
        partial + ((size_t)b * nsplit * MAX_KC + k) * MAX_KC + c0) + f;
    constexpr size_t stride = (size_t)MAX_KC * MAX_KC / 4;
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const float4 v = __ldg(src + (size_t)s * stride);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  part[g][f] = acc;
  __syncthreads();
  const int q = threadIdx.x;
  if (q < XR_COLS && c0 + q < C) {
    const float* p = reinterpret_cast<const float*>(&part[0][0]) + q;
    float tot = 0.f;
#pragma unroll
    for (int h = 0; h < XR_CHUNKS; ++h) tot += p[h * XR_COLS];
    out[((size_t)b * K + k) * C + c0 + q] = tot;
  }
}

size_t smem_bytes(int ldc, int ldp) {
  return sizeof(float) * ((size_t)TV * LDA + (size_t)TV * LDB +
                          (size_t)TV * LDC + (size_t)MAX_KC * LDS +
                          (size_t)TV * ldc + 2 * (size_t)TV * ldp);
}

}  // namespace

extern "C" {

// Launches the block kernel on `stream`. `partial` null: emit_next off.
// cmap is [[A_re, A_im], [-A_im, A_re]] and each ws[l] the l-th MLP kernel,
// laid out as weight_gemm reads them (zero rows up to a multiple of 8).
// dropout 0: off; else masks from (seed, b, row / tile_v, layer).
int mb_fwd_launch(const void* x, const void* evecs, const void* gx,
                  const void* gy, const void* mass, const void* coefs,
                  const void* cmap, int ld_cmap, const void* const* ws,
                  const int* ldw, const void* const* bs, const int* widths,
                  int n_dense, const void* xhat_in, void* out, void* partial,
                  int B, int V, int K, int C, int nsplit, int x_bf16,
                  int ops_bf16, int lowp, int dropout, int seed, int tile_v,
                  void* stream) {
  if (dropout && (tile_v < TV || tile_v % TV != 0 || V % tile_v != 0 ||
                  seed < 0 || B > 2048 || V / tile_v > 65536 ||
                  n_dense - 1 > 16))
    return MB_BAD_SHAPE;
  if (n_dense < 1 || n_dense > MAX_DENSE || K < 1 || K > MAX_KC || C < 1 ||
      C > MAX_KC || B < 1 || V < 1 || nsplit < 1)
    return MB_BAD_SHAPE;
  if (widths[0] != 3 * C || widths[n_dense] != C) return MB_BAD_SHAPE;
  if (!weight_layout_ok(cmap, ld_cmap, 2 * C)) return MB_BAD_LAYOUT;
  Args p = {};
  p.x = x; p.evecs = evecs; p.gx = gx; p.gy = gy;
  p.mass = static_cast<const float*>(mass);
  p.coefs = static_cast<const float*>(coefs);
  p.cmap = static_cast<const float*>(cmap);
  p.ld_cmap = ld_cmap;
  int widest = 2 * C;
  for (int l = 0; l < n_dense; ++l) {
    if (widths[l + 1] < 1 || widths[l + 1] > MAX_WIDTH) return MB_BAD_SHAPE;
    if (!weight_layout_ok(ws[l], ldw[l], widths[l + 1])) return MB_BAD_LAYOUT;
    p.w[l] = static_cast<const float*>(ws[l]);
    p.ldw[l] = ldw[l];
    p.b[l] = static_cast<const float*>(bs[l]);
    if (widths[l + 1] > widest) widest = widths[l + 1];
  }
  for (int l = 0; l <= n_dense; ++l) p.width[l] = widths[l];
  p.n_dense = n_dense;
  p.xhat_in = static_cast<const float*>(xhat_in);
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.B = B; p.V = V; p.K = K; p.C = C;
  p.n_tiles = (V + TV - 1) / TV;
  p.nsplit = nsplit < p.n_tiles ? nsplit : p.n_tiles;
  if (p.nsplit != nsplit) return MB_BAD_SHAPE;  // partial is sized by nsplit
  p.x_bf16 = x_bf16; p.ops_bf16 = ops_bf16;
  p.drop = {dropout, seed, tile_v};
  // padded to 4 mod 32 floats: the rows of a fragment fall in other banks
  p.ldc = round_up(3 * C, 8) + PAD;
  p.ldp = round_up(widest, 8) + PAD;

  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t smem = smem_bytes(p.ldc, p.ldp);
  if (smem > (size_t)max_smem) return MB_SMEM;
  auto kernel = lowp ? megablock_fwd_kernel<true> : megablock_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nsplit, B), NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// partial: (B, nsplit, MAX_KC, MAX_KC) slots, 16-byte aligned; out:
// (B, K, C).
int mb_xhat_reduce_launch(const void* partial, void* out, int B, int nsplit,
                          int K, int C, void* stream) {
  if (B < 1 || B > 65535 || nsplit < 1 || K < 1 || K > MAX_KC || C < 1 ||
      C > MAX_KC)
    return MB_BAD_SHAPE;
  const dim3 grid((C + XR_COLS - 1) / XR_COLS, K, B);
  xhat_reduce_kernel<<<grid, XR_CHUNKS * XR_COLS / 4, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), nsplit, K,
      C);
  return (int)cudaGetLastError();
}

const char* mb_error_string(int code) {
  if (code == MB_BAD_SHAPE) return "unsupported shape";
  if (code == MB_SMEM) return "shared memory request exceeds the device limit";
  if (code == MB_BAD_LAYOUT) return "weights not laid out as the kernel reads them";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
