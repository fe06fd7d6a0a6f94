// Whole-DiffusionNet-block backward for Hopper (sm_90a), chained form: two
// kernels on wgmma, and a fixed-order partial sum.
//
// Replaces the TPU kernel `_make_bwd_kernel`
// (diffusionnet_tpu/ops/pallas_megablock.py:379, launched from `_bwd_impl`
// at :498 / :574). It computes what that kernel computes: per row v of
// batch element b, the block's forward recomputed (with the same dropout
// masks as B1), then
//
//   g        = dout (+ m (.) Phi dx_hat_next, with emit_next)
//   MLP      dpre_{n-1} = g;  dpre_{l-1} = (dpre_l W_l^T) (.) [in_l > 0] * scale
//   dcat     = dpre_0 W_0^T = [dx_direct - g | dxd | dfeat]
//   ddots    = dfeat (.) (1 - feat^2)
//   dvb      = ddots (.) [gx | gy];  [dgx | dgy] = ddots (.) vb + dvb cmap^T
//
// and over all rows the V-reductions
//
//   dW_l = sum_v in_l^T dpre_l,  db_l = sum_v dpre_l
//   P    = sum_v [gx | gy]^T [dvb_re | dvb_im]: dA_re = P00 + P11,
//          dA_im = P01 - P10 (the wrapper combines the quarters)
//   ds_b = sum_v Phi_b^T dxd + GX_b^T dgx + GY_b^T dgy   (per batch element)
//
// with s = coefs (.) x_hat_in, cmap = [[A_re, A_im], [-A_im, A_re]] and
// scale 2 with dropout (else 1). dcoefs and dx_hat_in stay outside, as in the
// JAX package (pallas_megablock.py:668-678). The TPU kernel runs both halves
// per tile and carries every V-reduction across its sequential grid in
// VMEM. Here they are split:
//
//  * megablock_bwd_rows_kernel: one CTA (one warpgroup, 128 threads) per
//    (64-row tile, batch element); 2,560 CTAs at B = 8, V = 20480. It runs
//    the forward recompute and the backward down to per-row quantities and
//    writes dx_direct, the per-CTA column sums of every dpre_l (db's
//    partials: one row per CTA, written once) and a row scratch R holding
//    the V-reductions' operands: in_l and dpre_l of every dense layer,
//    [gx | gy], [dvb_re | dvb_im] and [dxd | dgx | dgy].
//  * megablock_bwd_grads_kernel: the V-reductions as TN products over V,
//    on a split-V grid. Each CTA (two warpgroups, 256 threads) owns one
//    128 x 128 output block of one product and one fixed range of rows,
//    keeps its accumulator in registers across the whole range and writes
//    one partial, once. `grad_reduce_kernel` then sums the partials over
//    the ranges in a fixed order. This is spectral_project's structure (a
//    V-reduction into per-CTA slots, summed in a fixed order by a second
//    launch), with the V range fixed per CTA instead of strided.
//
// No slot is read, modified and written per tile, and nothing is summed
// with floating-point atomics: two launches give the same bits.
//
// Products. Every product of both kernels runs on wgmma m64n128 (wgmma.cuh).
// f32 runs three TF32 passes (a_lo b_hi + a_hi b_lo + a_hi b_hi), which the
// f32 tolerances need; lowp rounds both operands to bf16 and runs one.
//  * Rows kernel: A (Phi / GX / GY rows, or R's columns) goes from device
//    memory straight into each thread's wgmma fragments (wg::RowA: two
//    16-byte loads a row, the next chunk's in flight during this chunk's
//    products, split into hi / lo in registers); the chunk's contraction
//    order is permuted so that a thread's loads are its fragments. B (s,
//    dx_hat_next, cmap and the W_l, tiled once per call by the wrapper in
//    that order and already split: ops/megablock.py::b_tiles) streams
//    through a ring of 3 shared-memory stages by cp.async, two chunks of 32
//    ahead. A product's 64 x 128 output block then goes to shared memory,
//    and its epilogue works on it a quad of columns at a time, so that a
//    warp's loads and stores of R are whole 512-byte rows and a round of
//    loads is in flight before its stores: the epilogues, not the
//    products, bound this kernel. What a later product reads comes back
//    from L2 where it is still there (a 64-row tile's share of R is 480 KB
//    in f32 at C = 128).
//  * Grads kernel (splitv.cuh, shared with B1's x_hat kernel): each 32-row
//    chunk of the two operands' columns is copied as it lies into a ring of
//    3 raw stages by cp.async (zero-filled past the valid rows and
//    columns), two chunks ahead; the threads then transpose a stage into
//    the K-major tiles that wgmma's tf32 needs (it takes K-major operands
//    only), splitting hi / lo on the way, into the second of two tile
//    buffers while the products read the first.
//
// Scratch and shared memory (R's row, per vertex, in R's type: f32, or bf16
// under lowp, where every one of its values enters its product rounded to
// bf16 anyway; each group padded to a multiple of 32 values):
//   C = 128, hidden [128, 128]: in 384 + 128 + 128, dpre 3 x 128, [gx|gy]
//     256, dvb 256, [dxd|dgx|dgy] 384 = 1,920 values, 7.5 KB in f32: at
//     B = 8, V = 20480 1.26 GB, written once and read about once (0.75 ms
//     at 3.35 TB/s), where the kernel it replaces took 14.21 ms.
//   C = 256, hidden [256, 256]: 3,840 values, 15 KB in f32 (B = 2,
//     V = 32768: 1.0 GB).
//   Peak device memory of the bench-shape train step (B = 8, V = 20480,
//     K = C = 128, f32; chip_compare.py --block on an NVIDIA H100 80GB
//     HBM3 at 700 W): 0.87 GiB with the one-kernel backward this replaces,
//     2.07 GiB with R.
//   Under lowp an f32 side scratch E of 6C values a vertex keeps what the
//   elementwise work reads back unrounded (g, gx, gy, vb, feat), as the TPU
//   kernel's elementwise work sees f32. In f32 E is R itself.
//   Shared memory, the same at every K, C and width: rows kernel 96 KB in
//   f32 (3 B stages of 32 KB, hi and lo; the output block reuses them),
//   33 KB under lowp (the output block); grads kernel 224 KB in f32 (3
//   raw stages of 32 KB and two buffers of the A and B tiles, hi and lo,
//   so that the next chunk's transpose runs during this chunk's
//   products), 160 KB under lowp (and 408 bytes of splitv.cuh's BULK route
//   that this kernel leaves unused).
//
// What bounds it on this card. At K = C = 128, hidden [128, 128] a vertex
// costs about 2.2x B1's multiply-adds (the forward recompute without the
// last layer and the x_hat product, the MLP's two backward products per
// layer, the complex map's transpose, the dA and ds products), against
// ~3.9 KB of device memory traffic in f32 for the inputs and outputs,
// plus R's 7.5 KB written and read: arithmetic bounds the function, and
// R's traffic is the price of splitting it. Neither kernel reaches that
// bound: each CTA waits on its products chunk by chunk, and the rows
// kernel streams every weight from L2 once per 64-row tile.
//
// Summation order, fixed: a grads CTA sums its rows in ascending 32-row
// chunks (for ds: Phi's, then GX's, then GY's), in wgmma's order inside a
// chunk; grad_reduce adds the CTAs' partials in ascending range order; db
// sums each tile's 64 rows (rows g and g + 8 of a thread, then lane
// shuffles over g, then the 4 warps in order) and grad_reduce the tiles in
// order. The plain versions (ops/megablock.py) split V the same way.
//
// Padding: rows at or past V are masked (loads give 0, stores are skipped),
// and every partial gets exactly 0 from them. Padded rows inside V carry
// mass 0 and zero operator rows. A channel count C that is not a multiple
// of 8 the wrapper pads with zero channels (ops/megablock.py::pad_block),
// as for B1: every padded channel's value and gradient is exactly 0, and
// dropout, which acts on the hidden layers only, keeps the model's masks.

#include "megablock_common.cuh"
#include "splitv.cuh"
#include "wgmma.cuh"

namespace {

using namespace mb;
using wg::KCH;
using wg::NB;
using sv::GM;
using sv::GNT;
using sv::grads_block;
using sv::grads_smem;

constexpr int RT = 64;    // rows per CTA of the rows kernel
constexpr int RNT = 128;  // its threads: one warpgroup
constexpr int NS = 3;     // its ring of B stages
constexpr int MAX_PROD = MAX_DENSE + 1;  // dW per layer, then P

struct RowsArgs {
  const void* x;       // (B,V,C) f32 or bf16
  const void* ops[3];  // Phi, GX, GY: (B,V,K), one dtype
  const float* mass;   // (B,V)
  // the B operands' tiles (ops/megablock.py::b_tiles), in the product type
  // (f32 hi and lo, or bf16 under lowp)
  const void* sT;      // per batch element: s = coefs (.) x_hat_in
  const void* dxnT;    // per batch element: dx_hat_next, or null
  const void* cmapF;   // cmap, its columns interleaved re, im
  const void* cmapB;   // cmap^T
  const void* wf[MAX_DENSE];  // W_l (l < n - 1), forward
  const void* wb[MAX_DENSE];  // W_l^T, backward
  const float* bias[MAX_DENSE];
  int width[MAX_DENSE + 1];
  int n_dense;
  const void* dout;  // (B,V,C) in x's dtype
  void* dx;          // (B,V,C) dx_direct in x's dtype
  void* R;           // (B V, ldr) row scratch
  int ldr;
  int off_in[MAX_DENSE], off_dp[MAX_DENSE], off_gg, off_dvb, off_ds;
  float* E;  // lowp: (B V, 6C) f32 [g | gx gy | vb | feat]; else null
  float* dbp;  // (B n_tiles, ld_db) column sums of dpre_l at off_db[l]
  int ld_db;
  int off_db[MAX_DENSE];
  int B, V, K, C, n_tiles;
  int x_bf16, ops_vec;
  Dropout drop;
};

struct GradProd {
  int a_off, b_off;  // column offsets in R of A's and B's first columns
  int M, N;          // the product's extent
  int mblocks, nblocks;
  long long out_off;  // offset in a parameter slot (row-major M x N)
};

struct GradsArgs {
  const void* R;
  int ldr;
  const void* ops[3];  // ds: Phi, GX, GY against R's dxd, dgx, dgy
  int off_ds;
  GradProd prod[MAX_PROD];
  int n_prod, nb_par;  // parameter products and their blocks
  int ds_mblocks, ds_nblocks;
  float* part_par;  // (S_par, P_par)
  long long P_par, L_par;
  int S_par;
  float* part_ds;  // (B, S_ds, K C)
  long long L_ds;
  int S_ds;
  int B, V, K, C;
  int ops_vec;
};

template <bool LOWP>
__device__ __forceinline__ void put1(void* base, long long o, float v) {
  if constexpr (LOWP)
    reinterpret_cast<__nv_bfloat16*>(base)[o] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(base)[o] = v;
}

template <bool LOWP>
__device__ __forceinline__ float get1(const void* base, long long o) {
  if constexpr (LOWP)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[o]);
  else
    return reinterpret_cast<const float*>(base)[o];
}

// Four consecutive values at base + o (o a multiple of 4): f32 (16 bytes)
// or bf16 (8 bytes).
template <bool BF16>
__device__ __forceinline__ void put4(void* base, long long o, float4 v) {
  if constexpr (BF16) {
    uint2 u;
    u.x = wg::pack_bf16(v.x, v.y);
    u.y = wg::pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(base) + o) = u;
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(base) + o) = v;
  }
}

template <bool BF16>
__device__ __forceinline__ float4 get4(const void* base, long long o) {
  if constexpr (BF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(base) + o);
    return make_float4(wg::bf16_bits_to_float(u.x & 0xFFFFu),
                       wg::bf16_bits_to_float(u.x >> 16),
                       wg::bf16_bits_to_float(u.y & 0xFFFFu),
                       wg::bf16_bits_to_float(u.y >> 16));
  } else {
    return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(base) + o);
  }
}

// The first n < 4 values of a quad (the tail of a width that is not a
// multiple of 4).
template <bool BF16>
__device__ __forceinline__ void put_n(void* base, long long o, float4 v,
                                      int n) {
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) put1<BF16>(base, o + i, e[i]);
}

__device__ __forceinline__ float4 f4(const float (&p)[4]) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

// The rows kernel's epilogues run on its 64 x 128 output block in shared
// memory (row stride LDT), a quad of 4 columns at a time: thread t takes
// quad t % 32 of rows t / 32 + 4 k, so a warp reads and writes whole
// 128-column rows. In rounds of U quads a thread, load(m, q, pre) issues a
// quad's loads (NPRE values) for all U first, then store(m, q, v, pre)
// uses them with the block's values v; what it returns is written back to
// the block (for the column sums).
constexpr int LDT = NB + 4;
template <int NPRE, int U, class LOAD, class STORE>
__device__ __forceinline__ void for_quads(float* tile, LOAD load,
                                          STORE store) {
  const int q = threadIdx.x % 32, m0 = threadIdx.x / 32;
#pragma unroll 1
  for (int k0 = 0; k0 < RT / 4; k0 += U) {
    float pre[U][NPRE];
#pragma unroll
    for (int u = 0; u < U; ++u) load(m0 + 4 * (k0 + u), q, pre[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float4* p = reinterpret_cast<float4*>(tile + (m0 + 4 * (k0 + u)) * LDT +
                                            4 * q);
      *p = store(m0 + 4 * (k0 + u), q, *p, pre[u]);
    }
  }
}

// out[n] = sum over the block's 64 rows of tile[.][n], n < ncols, in order
// from row 0 (after the epilogue's write-back).
__device__ __forceinline__ void colsum(const float* tile, float* out,
                                       int ncols) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t < ncols) {
    float s = 0.f;
    for (int m = 0; m < RT; ++m) s += tile[m * LDT + t];
    out[t] = s;
  }
}

// One product of the rows kernel: for each 128-column pass n0 of N,
// epi(n0, tile) with tile the block A (64 x kd) B[.., n0..n0+127] in
// shared memory (row stride LDT). A: rows arow0.. of a row-major source
// (row stride lda; rows at or past rows_valid and columns at or past kd
// read 0; vec: 16-byte loads allowed), read by each thread straight into
// its fragments (wg::RowA). Bt: B's tiles as ops/megablock.py::b_tiles lays
// them out, one stage of wg::b_stage_bytes per (pass, 32-value chunk),
// copied by cp.async into a ring of NS stages, NS - 1 chunks ahead of the
// products. The block is written over the stages once the products are
// done.
template <bool LOWP, bool A_BF16, class EPI>
__device__ __forceinline__ void row_product(char* smem, const void* A,
                                            long long lda, long long arow0,
                                            int rows_valid, int kd, bool vec,
                                            const char* Bt, int N, EPI epi) {
  constexpr int SB = wg::b_stage_bytes<LOWP>();
  const int nk = (kd + KCH - 1) / KCH, tid = threadIdx.x;
  float* tile = reinterpret_cast<float*>(smem);
  wg::RowA<LOWP, A_BF16> a;
  wg::AFrags<LOWP> f;
  for (int n0 = 0; n0 < N; n0 += NB) {
    const char* stages = Bt + (size_t)(n0 / NB) * nk * SB;
    auto issue = [&](int kc) {  // one commit group per chunk, empty past nk
      if (kc < nk) {
        const char* src = stages + (size_t)kc * SB;
        char* dst = smem + (kc % NS) * SB;
#pragma unroll 4
        for (int i = tid; i < SB / 16; i += RNT)
          wg::cp_async16(dst + 16 * i, src + 16 * i);
      }
      wg::cp_async_commit();
    };
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    __syncthreads();  // the CTA's earlier writes of A are visible, and the
                      // last readers of the stages and the block are done
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) issue(st);
    a.load(A, lda, arow0, rows_valid, 0, kd, vec);
    for (int kc = 0; kc < nk; ++kc) {
      wg::cp_async_wait<NS - 2>();  // this chunk's stage has landed
      wg::fence_smem_for_wgmma();
      __syncthreads();  // ... for every thread; and the stage that chunk
                        // kc + NS - 1 reuses was read by chunk kc - 1,
                        // whose products every warp has waited for
      issue(kc + NS - 1);
      f.build(a);
      if (kc + 1 < nk)
        a.load(A, lda, arow0, rows_valid, (kc + 1) * KCH, kd, vec);
      wg::fence_operands();
      wg::pin(d);
      wg::mma_chunk_rs<LOWP>(d, f, smem + (kc % NS) * SB);
      wg::commit();
      wg::wait_all();
      wg::pin(d);
    }
    __syncthreads();  // every warp's products are done with the stages
    wg::for_pairs(d, [&](int m, int nn, float& v0, float& v1) {
      *reinterpret_cast<float2*>(tile + m * LDT + nn) = make_float2(v0, v1);
    });
    __syncthreads();
    epi(n0, tile);
  }
}

template <bool LOWP, bool OPS_BF16>
__global__ void __launch_bounds__(RNT, 2)
    megablock_bwd_rows_kernel(const RowsArgs p) {
  extern __shared__ __align__(128) char smem[];
  const int C = p.C, K = p.K, V = p.V, n = p.n_dense, tid = threadIdx.x;
  const int tile = blockIdx.x, b = blockIdx.y, row0 = tile * RT;
  const int nv = min(RT, V - row0);      // rows inside V
  const long long vr0 = (long long)b * V + row0;  // the tile's first row
  const long long ldr = p.ldr;
  void* R = p.R;
  const float scale = p.drop.on ? 2.f : 1.f;
  float* dbp = p.dbp + ((long long)b * p.n_tiles + tile) * p.ld_db;

  // f32 views of what the elementwise work reads back: E under lowp, else
  // R itself
  float* Rf = reinterpret_cast<float*>(R);
  float* E = p.E;
  const long long lde = LOWP ? 6LL * C : ldr;
  float* g32 = LOWP ? E : Rf + p.off_dp[n - 1];
  float* gg32 = LOWP ? E + C : Rf + p.off_gg;
  float* vb32 = LOWP ? E + 3 * C : Rf + p.off_dvb;
  float* ft32 = LOWP ? E + 5 * C : Rf + p.off_in[0] + 2 * C;
  float* dg32 = LOWP ? E + 3 * C : Rf + p.off_ds + C;  // vb's place, reused
  const size_t rsz = LOWP ? 2 : 4;
  auto rcol = [&](int off) {
    return reinterpret_cast<char*>(R) + off * rsz;
  };
  auto row = [&](int m) { return vr0 + m; };

  // ---- x into [x | xd | feat], a quad of columns at a time
  for (int i0 = tid; i0 < nv * (C / 4); i0 += 8 * RNT) {
    float4 xv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * RNT;
      xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nv * (C / 4))
        xv[u] = p.x_bf16 ? get4<true>(p.x, vr0 * C + 4LL * i)
                         : get4<false>(p.x, vr0 * C + 4LL * i);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * RNT;
      if (i < nv * (C / 4)) {
        const int m = 4 * i / C, c = 4 * i % C;
        put4<LOWP>(R, row(m) * ldr + p.off_in[0] + c, xv[u]);
      }
    }
  }

  // ---- the spectral products: xd = Phi s, gx = GX s, gy = GY s
  // a B operand's tiles: (passes of N) x (chunks of its contraction) stages
  auto tiles = [&](const void* t, int nn, int k, int batch) {
    return reinterpret_cast<const char*>(t) +
           (size_t)batch * ((nn + NB - 1) / NB) * ((k + KCH - 1) / KCH) *
               wg::b_stage_bytes<LOWP>();
  };
  const char* sT = tiles(p.sT, C, K, b);
  for (int q3 = 0; q3 < 3; ++q3) {
    row_product<LOWP, OPS_BF16>(
        smem, p.ops[q3], K, vr0, nv, K, p.ops_vec, sT, C,
        [&](int n0, float* tl) {
          for_quads<1, 8>(
              tl, [&](int, int, float(&)[1]) {},
              [&](int m, int q, float4 v, const float(&)[1]) {
                const int c = n0 + 4 * q;
                if (m < nv && c < C) {
                  if (q3 == 0) {
                    put4<LOWP>(R, row(m) * ldr + p.off_in[0] + C + c, v);
                  } else {
                    const int o = (q3 - 1) * C + c;
                    put4<LOWP>(R, row(m) * ldr + p.off_gg + o, v);
                    if (LOWP) put4<false>(gg32, row(m) * lde + o, v);
                  }
                }
                return v;
              });
        });
  }

  // ---- g = dout (+ m (.) Phi dx_hat_next); dpre_{n-1} = g; db's partial
  auto g_epi = [&](int n0, float* tl) {
    for_quads<5, 8>(
        tl,
        [&](int m, int q, float(&pre)[5]) {
          const int c = n0 + 4 * q;
          const bool in = m < nv && c < C;
          const float4 o = !in ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : p.x_bf16 ? get4<true>(p.dout, row(m) * C + c)
                                      : get4<false>(p.dout, row(m) * C + c);
          pre[0] = o.x; pre[1] = o.y; pre[2] = o.z; pre[3] = o.w;
          pre[4] = in ? p.mass[row(m)] : 0.f;
        },
        [&](int m, int q, float4 v, const float(&pre)[5]) {
          const int c = n0 + 4 * q;
          v = make_float4(pre[0] + pre[4] * v.x, pre[1] + pre[4] * v.y,
                          pre[2] + pre[4] * v.z, pre[3] + pre[4] * v.w);
          if (m < nv && c < C) {
            put4<false>(g32, row(m) * lde + c, v);
            if (LOWP) put4<LOWP>(R, row(m) * ldr + p.off_dp[n - 1] + c, v);
          }
          return v;
        });
    colsum(tl, dbp + p.off_db[n - 1] + n0, min(NB, C - n0));
  };
  if (p.dxnT != nullptr) {
    row_product<LOWP, OPS_BF16>(smem, p.ops[0], K, vr0, nv, K, p.ops_vec,
                                tiles(p.dxnT, C, K, b), C, g_epi);
  } else {
    float* tl = reinterpret_cast<float*>(smem);
    for (int n0 = 0; n0 < C; n0 += NB) {
      __syncthreads();  // the block's last readers are done
      for (int i = tid; i < RT * LDT; i += RNT) tl[i] = 0.f;
      __syncthreads();
      g_epi(n0, tl);
    }
  }

  // ---- [vb_re | vb_im] = [gx | gy] cmap (B's rows interleaved: the pair
  // (2c, 2c + 1) of the block is (vb_re, vb_im) of column c); feat =
  // tanh(gx vb_re + gy vb_im)
  row_product<LOWP, LOWP>(
      smem, rcol(p.off_gg), ldr, vr0, nv, 2 * C, true, tiles(p.cmapF, 0, 0, 0),
      2 * C, [&](int n0, float* tl) {
        for_quads<4, 8>(
            tl,
            [&](int m, int q, float(&pre)[4]) {  // gx, gy of 2 columns
              const int c = (n0 + 4 * q) / 2;
              const bool in = m < nv && c < C;
              const long long o = row(m) * lde + c;
              const float2 gx = in ? *reinterpret_cast<const float2*>(gg32 + o)
                                   : make_float2(0.f, 0.f);
              const float2 gy = in ? *reinterpret_cast<const float2*>(gg32 + o + C)
                                   : make_float2(0.f, 0.f);
              pre[0] = gx.x; pre[1] = gx.y; pre[2] = gy.x; pre[3] = gy.y;
            },
            [&](int m, int q, float4 v, const float(&pre)[4]) {
              const int c = (n0 + 4 * q) / 2;
              if (m < nv && c < C) {
                const long long o = row(m) * lde + c;
                *reinterpret_cast<float2*>(vb32 + o) = make_float2(v.x, v.z);
                *reinterpret_cast<float2*>(vb32 + o + C) = make_float2(v.y, v.w);
                const float f0 = tanhf(pre[0] * v.x + pre[2] * v.y);
                const float f1 = tanhf(pre[1] * v.z + pre[3] * v.w);
                *reinterpret_cast<float2*>(ft32 + o) = make_float2(f0, f1);
                if (LOWP) {
                  put1<LOWP>(R, row(m) * ldr + p.off_in[0] + 2 * C + c, f0);
                  put1<LOWP>(R, row(m) * ldr + p.off_in[0] + 2 * C + c + 1,
                             f1);
                }
              }
              return v;
            });
      });

  // ---- the MLP up to the last layer's input
  for (int l = 0; l + 1 < n; ++l) {
    const int width = p.width[l + 1];
    const float* bias = p.bias[l];
    row_product<LOWP, LOWP>(
        smem, rcol(p.off_in[l]), ldr, vr0, nv, p.width[l], true,
        tiles(p.wf[l], 0, 0, 0), width, [&](int n0, float* tl) {
          for_quads<4, 8>(
              tl,
              [&](int, int q, float(&pre)[4]) {
                const int c = n0 + 4 * q;
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  pre[e] = c + e < width ? bias[c + e] : 0.f;
              },
              [&](int m, int q, float4 v, const float(&pre)[4]) {
                const int c = n0 + 4 * q;
                if (m >= nv || c >= width) return v;
                const int r = row0 + m;
                float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  e[i] = p.drop.apply(fmaxf(e[i] + pre[i], 0.f), b, r, c + i,
                                      width, l);
                const long long o = row(m) * ldr + p.off_in[l + 1] + c;
                if (c + 4 <= width)
                  put4<LOWP>(R, o, f4(e));
                else
                  put_n<LOWP>(R, o, f4(e), width - c);
                return v;
              });
        });
  }

  // ---- backward through the MLP: dpre_{l-1} = (dpre_l W_l^T) (.)
  // [in_l > 0] * scale (in_l = mask (.) relu(pre_{l-1}) * scale, so this is
  // the TPU kernel's [pre > 0] (.) mask (.) d * scale); db's partials
  for (int l = n - 1; l >= 1; --l) {
    const int width = p.width[l];
    row_product<LOWP, LOWP>(
        smem, rcol(p.off_dp[l]), ldr, vr0, nv, p.width[l + 1], true,
        tiles(p.wb[l], 0, 0, 0), width, [&](int n0, float* tl) {
          for_quads<4, 8>(
              tl,
              [&](int m, int q, float(&pre)[4]) {  // in_l, 0 outside
                const int c = n0 + 4 * q;
                const long long o = row(m) * ldr + p.off_in[l] + c;
                if (m < nv && c + 4 <= width) {
                  const float4 x = get4<LOWP>(R, o);
                  pre[0] = x.x; pre[1] = x.y; pre[2] = x.z; pre[3] = x.w;
                } else {
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    pre[e] = m < nv && c + e < width ? get1<LOWP>(R, o + e)
                                                     : 0.f;
                }
              },
              [&](int m, int q, float4 v, const float(&pre)[4]) {
                const int c = n0 + 4 * q;
                v = make_float4(pre[0] > 0.f ? scale * v.x : 0.f,
                                pre[1] > 0.f ? scale * v.y : 0.f,
                                pre[2] > 0.f ? scale * v.z : 0.f,
                                pre[3] > 0.f ? scale * v.w : 0.f);
                if (m < nv && c < width) {
                  const long long o = row(m) * ldr + p.off_dp[l - 1] + c;
                  if (c + 4 <= width)
                    put4<LOWP>(R, o, v);
                  else
                    put_n<LOWP>(R, o, v, width - c);
                }
                return v;
              });
          colsum(tl, dbp + p.off_db[l - 1] + n0, min(NB, width - n0));
        });
  }

  // ---- dcat = dpre_0 W_0^T: dx_direct goes out; [dxd | dgx | dgy] and
  // [dvb_re | dvb_im] into R (dgx, dgy still without dvb cmap^T)
  row_product<LOWP, LOWP>(
      smem, rcol(p.off_dp[0]), ldr, vr0, nv, p.width[1], true,
      tiles(p.wb[0], 0, 0, 0), 3 * C, [&](int n0, float* tl) {
        // pre: g (dx_direct's columns), or feat, vb_re, vb_im, gx, gy
        // (dfeat's), a quad each
        for_quads<20, 4>(
            tl,
            [&](int m, int q, float(&pre)[20]) {
              const int c = n0 + 4 * q;
              const long long o = row(m) * lde;
              auto at = [&](int k, const float* src) {
                const float4 x = *reinterpret_cast<const float4*>(src);
                pre[4 * k] = x.x; pre[4 * k + 1] = x.y;
                pre[4 * k + 2] = x.z; pre[4 * k + 3] = x.w;
              };
              if (m < nv && c < C) {
                at(0, g32 + o + c);
              } else if (m < nv && c >= 2 * C && c < 3 * C) {
                const int j = c - 2 * C;
                at(0, ft32 + o + j);
                at(1, vb32 + o + j);
                at(2, vb32 + o + C + j);
                at(3, gg32 + o + j);
                at(4, gg32 + o + C + j);
              }
            },
            [&](int m, int q, float4 v, const float(&pre)[20]) {
              const int c = n0 + 4 * q;
              if (m >= nv || c >= 3 * C) return v;
              const float e[4] = {v.x, v.y, v.z, v.w};
              if (c < C) {
                const float4 dx = make_float4(e[0] + pre[0], e[1] + pre[1],
                                              e[2] + pre[2], e[3] + pre[3]);
                if (p.x_bf16)
                  put4<true>(p.dx, row(m) * C + c, dx);
                else
                  put4<false>(p.dx, row(m) * C + c, dx);
              } else if (c < 2 * C) {
                put4<LOWP>(R, row(m) * ldr + p.off_ds + c - C, v);
              } else {
                const int j = c - 2 * C;
                float dvr[4], dvi[4], dgx[4], dgy[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const float f = pre[i];
                  const float dd = e[i] * (1.f - f * f);
                  dvr[i] = dd * pre[12 + i];
                  dvi[i] = dd * pre[16 + i];
                  dgx[i] = dd * pre[4 + i];
                  dgy[i] = dd * pre[8 + i];
                }
                const long long o = row(m) * lde + j;
                *reinterpret_cast<float4*>(dg32 + o) = f4(dgx);
                *reinterpret_cast<float4*>(dg32 + o + C) = f4(dgy);
                put4<LOWP>(R, row(m) * ldr + p.off_dvb + j, f4(dvr));
                put4<LOWP>(R, row(m) * ldr + p.off_dvb + C + j, f4(dvi));
              }
              return v;
            });
      });

  // ---- [dgx | dgy] += [dvb_re | dvb_im] cmap^T
  row_product<LOWP, LOWP>(
      smem, rcol(p.off_dvb), ldr, vr0, nv, 2 * C, true,
      tiles(p.cmapB, 0, 0, 0), 2 * C, [&](int n0, float* tl) {
        for_quads<4, 8>(
            tl,
            [&](int m, int q, float(&pre)[4]) {
              const int c = n0 + 4 * q;
              const bool in = m < nv && c < 2 * C;
              const float4 x = in ? *reinterpret_cast<const float4*>(
                                        dg32 + row(m) * lde + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
              pre[0] = x.x; pre[1] = x.y; pre[2] = x.z; pre[3] = x.w;
            },
            [&](int m, int q, float4 v, const float(&pre)[4]) {
              const int c = n0 + 4 * q;
              if (m < nv && c < 2 * C)
                put4<LOWP>(R, row(m) * ldr + p.off_ds + C + c,
                           make_float4(pre[0] + v.x, pre[1] + v.y,
                                       pre[2] + v.z, pre[3] + v.w));
              return v;
            });
      });
}

template <bool LOWP, bool OPS_BF16>
__global__ void __launch_bounds__(GNT, 1)
    megablock_bwd_grads_kernel(const GradsArgs p) {
  extern __shared__ __align__(128) char smem[];
  const long long BV = (long long)p.B * p.V;
  long long id = blockIdx.x;
  const long long n_par = (long long)p.nb_par * p.S_par;
  if (id < n_par) {
    // parameter products over all B V rows: block, then split
    int blk = (int)(id / p.S_par);
    const int split = (int)(id % p.S_par);
    int q = 0;
    while (blk >= p.prod[q].mblocks * p.prod[q].nblocks) {
      blk -= p.prod[q].mblocks * p.prod[q].nblocks;
      ++q;
    }
    const GradProd& g = p.prod[q];
    const int m0 = (blk / g.nblocks) * GM, n0 = (blk % g.nblocks) * NB;
    const long long r_lo = split * p.L_par;
    const long long r_hi = min(r_lo + p.L_par, BV);
    const size_t rsz = LOWP ? 2 : 4;
    const char* Rc = reinterpret_cast<const char*>(p.R);
    const void* A[1] = {Rc + g.a_off * rsz};
    const void* Bm[1] = {Rc + g.b_off * rsz};
    grads_block<LOWP, LOWP>(
        smem, A, p.ldr, true, Bm, p.ldr, 1, 0, r_lo, r_hi, m0, g.M, n0, g.N,
        p.part_par + split * p.P_par + g.out_off + (long long)m0 * g.N + n0,
        g.N, g.M - m0, g.N - n0);
    return;
  }
  // ds_b = Phi_b^T dxd + GX_b^T dgx + GY_b^T dgy over batch element b's rows
  id -= n_par;
  const int per_b = p.ds_mblocks * p.ds_nblocks * p.S_ds;
  const int b = (int)(id / per_b);
  int rest = (int)(id % per_b);
  const int blk = rest / p.S_ds, split = rest % p.S_ds;
  const int m0 = (blk / p.ds_nblocks) * GM, n0 = (blk % p.ds_nblocks) * NB;
  const long long r_lo = split * p.L_ds;
  const long long r_hi = min(r_lo + p.L_ds, (long long)p.V);
  const size_t rsz = LOWP ? 2 : 4;
  const char* Rc = reinterpret_cast<const char*>(p.R);
  const void* A[3] = {p.ops[0], p.ops[1], p.ops[2]};
  const void* Bm[3] = {Rc + p.off_ds * rsz, Rc + (p.off_ds + p.C) * rsz,
                       Rc + (p.off_ds + 2 * p.C) * rsz};
  grads_block<LOWP, OPS_BF16>(
      smem, A, p.K, p.ops_vec, Bm, p.ldr, 3, (long long)b * p.V, r_lo, r_hi,
      m0, p.K, n0, p.C,
      p.part_ds + ((long long)b * p.S_ds + split) * p.K * p.C +
          (long long)m0 * p.C + n0,
      p.C, p.K - m0, p.C - n0);
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

template <bool LOWP>
constexpr int rows_smem() {
  return NS * wg::b_stage_bytes<LOWP>() > RT * LDT * (int)sizeof(float)
             ? NS * wg::b_stage_bytes<LOWP>()
             : RT * LDT * (int)sizeof(float);
}

template <class T>
int launch(void* kernel, dim3 grid, int threads, int smem, const T& args,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* a[] = {const_cast<T*>(&args)};
  err = cudaLaunchKernel(kernel, grid, dim3(threads), a, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// The rows kernel on `stream`. The B operands (sT and dxnT per batch
// element; dxnT null: emit_next off; cmapF, cmapB; wf[l] for
// l < n_dense - 1; wb[l]) are tiled as ops/megablock.py::b_tiles lays them
// out, in the product type (f32 hi and lo, or bf16 with lowp), 16-byte
// aligned; C % 8 == 0 (the wrapper pads C); R (B V, ldr) is in the product
// type with the groups at the given offsets (multiples of 32); E (B V, 6C)
// f32 with lowp, else null; dbp (B n_tiles, ld_db) f32.
int mb_bwd_rows_launch(
    const void* x, const void* evecs, const void* gx, const void* gy,
    const void* mass, const void* sT, const void* dxnT, const void* cmapF,
    const void* cmapB, const void* const* wf, const void* const* wb,
    const void* const* bs, const int* widths, int n_dense, const void* dout,
    void* dx, void* R, int ldr, const int* off_in, const int* off_dp,
    int off_gg, int off_dvb, int off_ds, void* E, void* dbp, int ld_db,
    const int* off_db, int B, int V, int K, int C, int x_bf16, int ops_bf16,
    int lowp, int dropout, int seed, int tile_v, void* stream) {
  if (n_dense < 1 || n_dense > MAX_DENSE || K < 1 || C < 1 || C % 8 != 0 ||
      B < 1 || V < 1 || (B > 65535))
    return MB_BAD_SHAPE;
  if (dropout && (seed < 0 || B > 2048 || (tile_v > 0 && V / tile_v > 65536) ||
                  tile_v < 1 || n_dense - 1 > 16))
    return MB_BAD_SHAPE;
  if (widths[0] != 3 * C || widths[n_dense] != C) return MB_BAD_SHAPE;
  if (ldr % 32 || !aligned16(R) || !aligned16(sT) || !aligned16(dxnT) ||
      !aligned16(cmapF) || !aligned16(cmapB) || (lowp && E == nullptr))
    return MB_BAD_LAYOUT;
  RowsArgs p = {};
  p.x = x;
  p.ops[0] = evecs; p.ops[1] = gx; p.ops[2] = gy;
  p.mass = static_cast<const float*>(mass);
  p.sT = sT; p.dxnT = dxnT;
  p.cmapF = cmapF; p.cmapB = cmapB;
  for (int l = 0; l < n_dense; ++l) {
    if (widths[l + 1] < 1) return MB_BAD_SHAPE;
    if (!aligned16(wb[l]) || (l + 1 < n_dense && !aligned16(wf[l])))
      return MB_BAD_LAYOUT;
    if (off_in[l] % 32 || off_dp[l] % 32) return MB_BAD_LAYOUT;
    p.wf[l] = l + 1 < n_dense ? wf[l] : nullptr;
    p.wb[l] = wb[l];
    p.bias[l] = static_cast<const float*>(bs[l]);
    p.off_in[l] = off_in[l];
    p.off_dp[l] = off_dp[l];
    p.off_db[l] = off_db[l];
  }
  for (int l = 0; l <= n_dense; ++l) p.width[l] = widths[l];
  if (off_gg % 32 || off_dvb % 32 || off_ds % 32) return MB_BAD_LAYOUT;
  p.n_dense = n_dense;
  p.dout = dout; p.dx = dx;
  p.R = R; p.ldr = ldr;
  p.off_gg = off_gg; p.off_dvb = off_dvb; p.off_ds = off_ds;
  p.E = static_cast<float*>(E);
  p.dbp = static_cast<float*>(dbp); p.ld_db = ld_db;
  p.B = B; p.V = V; p.K = K; p.C = C;
  p.n_tiles = (V + RT - 1) / RT;
  p.x_bf16 = x_bf16;
  p.ops_vec = aligned16(evecs) && aligned16(gx) && aligned16(gy) &&
              K % 8 == 0;
  p.drop = {dropout, seed, tile_v};
  void* kernel =
      lowp ? (ops_bf16 ? (void*)megablock_bwd_rows_kernel<true, true>
                       : (void*)megablock_bwd_rows_kernel<true, false>)
           : (ops_bf16 ? (void*)megablock_bwd_rows_kernel<false, true>
                       : (void*)megablock_bwd_rows_kernel<false, false>);
  const int smem = lowp ? rows_smem<true>() : rows_smem<false>();
  return launch(kernel, dim3(p.n_tiles, B), RNT, smem, p, stream);
}

// The grads kernel on `stream`. prods: n_prod parameter products, 7 ints
// each (a_off, b_off, M, N, out_off, 0, 0) over R's columns, written to
// part_par (S_par, P_par) at out_off; the ds product over (K, C) from
// evecs, gx, gy and R's columns off_ds.., written to part_ds (B, S_ds, K C).
// Split s of a product covers rows [s L, (s + 1) L) of its rows (B V for
// the parameters, V of one batch element for ds).
int mb_bwd_grads_launch(const void* R, int ldr, const void* evecs,
                        const void* gx, const void* gy, int off_ds,
                        const long long* prods, int n_prod, void* part_par,
                        long long P_par, int S_par, long long L_par,
                        void* part_ds, int S_ds, long long L_ds, int B, int V,
                        int K, int C, int ops_bf16, int lowp, void* stream) {
  if (n_prod < 1 || n_prod > MAX_PROD || B < 1 || V < 1 || K < 1 || C < 1 ||
      S_par < 1 || S_ds < 1 || L_par < 1 || L_ds < 1 ||
      L_par * S_par < (long long)B * V || L_ds * S_ds < V)
    return MB_BAD_SHAPE;
  GradsArgs p = {};
  p.R = R; p.ldr = ldr;
  p.ops[0] = evecs; p.ops[1] = gx; p.ops[2] = gy;
  p.off_ds = off_ds;
  p.nb_par = 0;
  for (int q = 0; q < n_prod; ++q) {
    GradProd& g = p.prod[q];
    g.a_off = (int)prods[7 * q];
    g.b_off = (int)prods[7 * q + 1];
    g.M = (int)prods[7 * q + 2];
    g.N = (int)prods[7 * q + 3];
    g.out_off = prods[7 * q + 4];
    if (g.M < 1 || g.N < 1) return MB_BAD_SHAPE;
    g.mblocks = (g.M + GM - 1) / GM;
    g.nblocks = (g.N + NB - 1) / NB;
    p.nb_par += g.mblocks * g.nblocks;
  }
  p.n_prod = n_prod;
  p.ds_mblocks = (K + GM - 1) / GM;
  p.ds_nblocks = (C + NB - 1) / NB;
  p.part_par = static_cast<float*>(part_par);
  p.P_par = P_par; p.S_par = S_par; p.L_par = L_par;
  p.part_ds = static_cast<float*>(part_ds);
  p.S_ds = S_ds; p.L_ds = L_ds;
  p.B = B; p.V = V; p.K = K; p.C = C;
  p.ops_vec = aligned16(evecs) && aligned16(gx) && aligned16(gy) &&
              K % 8 == 0;
  const long long ctas = (long long)p.nb_par * S_par +
                         (long long)B * p.ds_mblocks * p.ds_nblocks * S_ds;
  if (ctas > 0x7fffffffLL) return MB_BAD_SHAPE;
  void* kernel =
      lowp ? (ops_bf16 ? (void*)megablock_bwd_grads_kernel<true, true>
                       : (void*)megablock_bwd_grads_kernel<true, false>)
           : (ops_bf16 ? (void*)megablock_bwd_grads_kernel<false, true>
                       : (void*)megablock_bwd_grads_kernel<false, false>);
  const int smem = lowp ? grads_smem<true>() : grads_smem<false>();
  return launch(kernel, dim3((unsigned)ctas), GNT, smem, p, stream);
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
