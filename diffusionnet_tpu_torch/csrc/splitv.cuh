// Split-V TN products on wgmma: sum over a range of rows v of A[v]^T B[v],
// with A and B columns of row-major sources in device memory. The
// V-reductions of B2's grads kernel (megablock_bwd.cu: dW, dA, ds), B1's
// x_hat_next = Phi^T (m (.) out) (megablock_fwd.cu) and B4's projection and
// backward ds (spectral_fused.cu) run on it: each CTA owns
// one output block and one fixed range of rows, keeps its accumulator in
// registers across the range and writes one partial, once; a second launch
// sums the partials in a fixed order. Nothing is atomic, and nothing is read,
// modified and written per tile.
//
// Operands are staged in two steps. First each 32-row chunk of a source's
// 128 columns is copied as it lies (row-major, the source's type) into a
// ring of NSR raw stages by cp.async, 16 bytes at a time, zero-filled past
// the valid rows and columns, or, where a source's rows are not 16-byte
// aligned, by plain loads; on the BULK route (below) a chunk of whole rows
// comes by bulk copies instead. Then the threads transpose a stage into
// the K-major wgmma tiles (wgmma's tf32 takes K-major operands only), hi
// and lo for tf32 or bf16 under LOWP: a warp reads 32 consecutive columns
// of a raw row and writes whole 128-byte rows of core matrices. The next
// chunk's transpose runs while this chunk's products do.
//
// Shared memory, the same at every width (grads_smem): 224 KB in f32 (3 raw
// stages of 32 KB and two buffers of the A and B tiles, hi and lo), 160 KB
// under LOWP, plus 408 bytes for the BULK route's scale ring and mbarriers.

#pragma once

#include "wgmma.cuh"

namespace sv {

using wg::KCH;
using wg::NB;

constexpr int GM = 128;   // output rows per CTA
constexpr int GNT = 256;  // its threads: two warpgroups of 64 output rows
constexpr int NSR = 3;    // raw stages
constexpr int RAW_OP = KCH * NB * 4;  // bytes of one operand's raw chunk

template <bool BF16>
__device__ __forceinline__ void raw_issue(char* dst, const void* src,
                                          long long ld, long long v0,
                                          int rows_valid, int col0,
                                          int cols_valid, bool aligned) {
  constexpr int ES = BF16 ? 2 : 4, PER = 16 / ES, CH = NB / PER;
  const char* s = reinterpret_cast<const char*>(src);
  for (int i = threadIdx.x; i < KCH * CH; i += GNT) {
    const int r = i / CH, c = col0 + (i % CH) * PER;
    const int nval = r < rows_valid ? min(PER, max(0, cols_valid - c)) : 0;
    char* d = dst + (r * NB + (i % CH) * PER) * ES;
    const char* sp = s + ((v0 + r) * ld + c) * ES;
    if (aligned) {
      const uint32_t da = (uint32_t)__cvta_generic_to_shared(d);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(da),
                   "l"(nval ? sp : s), "r"(nval * ES)
                   : "memory");
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        if constexpr (BF16)
          reinterpret_cast<unsigned short*>(d)[e] =
              e < nval ? reinterpret_cast<const unsigned short*>(sp)[e] : 0;
        else
          reinterpret_cast<float*>(d)[e] =
              e < nval ? reinterpret_cast<const float*>(sp)[e] : 0.f;
      }
    }
  }
}

// A raw chunk (32 rows x 128 columns) as the K-major tile of 128 rows
// (the columns) x 32 (the rows): unit (m, k group) of thread t is
// m = t % 32 + 32 ((t / 32) % 4), k groups t / 128 + 2 u. scale: null, or
// the chunk's per-row factors (rows below `valid`), applied in f32 before
// the split or the rounding.
template <bool LOWP, bool SRC_BF16>
__device__ __forceinline__ void raw_to_tile(const char* raw, char* hi,
                                            char* lo,
                                            const float* scale = nullptr,
                                            int valid = 0) {
  constexpr int UK = LOWP ? 8 : 4, UPR = KCH / UK;
  const int t = threadIdx.x;
  const int m = t % 32 + 32 * ((t / 32) % 4);
  auto at = [&](int v) {
    const float x =
        SRC_BF16 ? wg::bf16_bits_to_float(
                       reinterpret_cast<const unsigned short*>(raw)[v * NB + m])
                 : reinterpret_cast<const float*>(raw)[v * NB + m];
    if (scale == nullptr) return x;
    return v < valid ? x * scale[v] : 0.f;
  };
#pragma unroll
  for (int u = 0; u < UPR / 2; ++u) {
    const int kg = t / 128 + 2 * u;
    const int i = ((m / 8) * UPR + kg) * 8 + m % 8;  // 16-byte unit
    if constexpr (LOWP) {
      uint4 v;
      v.x = wg::pack_bf16(at(kg * 8), at(kg * 8 + 1));
      v.y = wg::pack_bf16(at(kg * 8 + 2), at(kg * 8 + 3));
      v.z = wg::pack_bf16(at(kg * 8 + 4), at(kg * 8 + 5));
      v.w = wg::pack_bf16(at(kg * 8 + 6), at(kg * 8 + 7));
      reinterpret_cast<uint4*>(hi)[i] = v;
    } else {
      float h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = at(kg * 4 + e);
        h[e] = wg::tf32r(x);
        l[e] = wg::tf32r(x - h[e]);
      }
      reinterpret_cast<float4*>(hi)[i] = make_float4(h[0], h[1], h[2], h[3]);
      reinterpret_cast<float4*>(lo)[i] = make_float4(l[0], l[1], l[2], l[3]);
    }
  }
}

// One output block of a V-reduction: the CTA's two warpgroups hold rows
// m0 + 64 w.. of sum over its rows of A_t^T B_t, t < nterms. A_t and B_t
// are columns of row-major sources (row stride lda, ldb) from row rbase:
// tile row i of A is column a_col0 + i (valid below a_cols), of B column
// b_col0 + i (valid below b_cols); the contraction runs over the rows
// [r_lo, r_hi) (relative to rbase), in chunks of 32, NSR - 1 ahead in the
// raw ring. B's rows are scaled by b_scale[rbase + row] where b_scale is
// not null. Writes the block, once, to out[m * ld_out + n] for m < M,
// n < N (relative to the block's corner). B is in the product type
// (B_BF16 = LOWP) unless the caller says otherwise; b_aligned: B's rows are
// 16-byte aligned (else plain loads fill its raw stages).
//
// BULK, the route of the callers whose sources can be whole 128-value rows
// (B1's x_hat kernel, B4's projection and ds): each chunk's 32 factors of
// b_scale travel with its raw stage (cp.async, 4 bytes each, into a ring
// after the tiles), so the transpose reads them from shared memory; and a
// chunk of 32 whole rows (row strides of 128 values, column 0, 16-byte
// aligned) comes by one bulk copy per operand, issued by one thread and
// completing on the stage's mbarrier, in place of 16-byte cp.async copies
// from every thread. Cycle counters in development builds (not committed,
// so no numbers) found the factors read from device memory, which queue
// behind the stage copies in flight, and the copies' issue the largest
// parts of a chunk's time. B2's grads kernel, whose sources never are
// whole rows and which has no scale, keeps the plain route: on the BULK
// route it ran 2-3% slower, while B1's x_hat kernel ran 30% faster at
// B = 8 (chip_compare.py --block, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
template <bool LOWP, bool A_BF16, bool B_BF16 = LOWP, bool BULK = false>
__device__ __forceinline__ void grads_block(
    char* smem, const void* const* As, long long lda, bool a_aligned,
    const void* const* Bs, long long ldb, int nterms, long long rbase,
    long long r_lo, long long r_hi, int a_col0, int a_cols, int b_col0,
    int b_cols, float* out, long long ld_out, int M, int N,
    const float* b_scale = nullptr, bool b_aligned = true) {
  constexpr int TA = wg::tile_bytes<LOWP>(GM), TB = wg::tile_bytes<LOWP>(NB);
  static_assert(GM == NB, "A's and B's tiles of one size");
  constexpr int TILES = TA;
  // A's tiles: hi of buffers 0 and 1, then lo of buffers 0 and 1 (tf32);
  // then B's the same
  char* raw = smem;  // NSR stages of A's and B's raw chunks
  char* ah = smem + NSR * 2 * RAW_OP;
  char* bh = ah + 4 * TA;
  const int w = threadIdx.x / wg::NTH;
  const int a_half = w * wg::tile_bytes<LOWP>(64);
  const long long rows = r_hi > r_lo ? r_hi - r_lo : 0;
  const int nkc = (int)((rows + KCH - 1) / KCH);
  const int total = nterms * nkc;
  // BULK: the ring of scale chunks, then an mbarrier per raw stage
  float* sscale = reinterpret_cast<float*>(bh + 4 * TB);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sscale + NSR * KCH);
  uint32_t phases = 0;  // BULK: bit s, the parity stage s completes next
  const bool rows_whole = BULK && lda == NB && a_col0 == 0 && a_aligned &&
                          ldb == NB && b_col0 == 0 && b_aligned;
  auto chunk_v0 = [&](int it) { return r_lo + (long long)(it % nkc) * KCH; };
  auto whole = [&](int it) {  // chunk it comes by bulk copies
    return rows_whole && r_hi - chunk_v0(it) >= KCH;
  };
  if constexpr (BULK) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < NSR; ++st)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         (uint32_t)__cvta_generic_to_shared(bars + st))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  auto issue = [&](int it) {  // one commit group per chunk, empty past total
    if (it < total) {
      const int t = it / nkc;
      const long long v0 = chunk_v0(it);
      const int valid = (int)min((long long)KCH, r_hi - v0);
      char* st = raw + (it % NSR) * 2 * RAW_OP;
      if (whole(it)) {
        if (threadIdx.x == 0) {
          constexpr uint32_t AB = KCH * NB * (A_BF16 ? 2 : 4);
          constexpr uint32_t BB = KCH * NB * (B_BF16 ? 2 : 4);
          const uint32_t bar =
              (uint32_t)__cvta_generic_to_shared(bars + it % NSR);
          const char* a = reinterpret_cast<const char*>(As[t]) +
                          (rbase + v0) * (long long)AB / KCH;
          const char* b = reinterpret_cast<const char*>(Bs[t]) +
                          (rbase + v0) * (long long)BB / KCH;
          // the stage's last readers passed the caller's barrier
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                  bar),
              "r"(AB + BB)
              : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];\n" ::"r"(
                  (uint32_t)__cvta_generic_to_shared(st)),
              "l"(a), "r"(AB), "r"(bar)
              : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];\n" ::"r"(
                  (uint32_t)__cvta_generic_to_shared(st + RAW_OP)),
              "l"(b), "r"(BB), "r"(bar)
              : "memory");
        }
      } else {
        raw_issue<A_BF16>(st, As[t], lda, rbase + v0, valid, a_col0, a_cols,
                          a_aligned);
        raw_issue<B_BF16>(st + RAW_OP, Bs[t], ldb, rbase + v0, valid,
                          b_col0, b_cols, b_aligned);
      }
      if constexpr (BULK) {
        const int r = threadIdx.x;
        if (b_scale != nullptr && r < KCH) {
          const uint32_t da = (uint32_t)__cvta_generic_to_shared(
              sscale + (it % NSR) * KCH + r);
          const float* sp = b_scale + (r < valid ? rbase + v0 + r : 0);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                           da),
                       "l"(sp), "r"(r < valid ? 4 : 0)
                       : "memory");
        }
      }
    }
    wg::cp_async_commit();
  };
  // chunk it's tiles: buffer it % 2 of each (the next chunk's transpose
  // runs while this chunk's products do)
  auto tiles = [&](int it, int which) {
    return (which ? bh : ah) + (it % 2) * TILES;
  };
  auto transpose = [&](int it) {
    wg::cp_async_wait<NSR - 2>();  // chunk it's raw stage has landed
    if (whole(it)) {  // ... by its bulk copies
      const int st = it % NSR;
      const uint32_t bar = (uint32_t)__cvta_generic_to_shared(bars + st);
      uint32_t done = 0;
      do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"((phases >> st) & 1u)
            : "memory");
      } while (!done);
      phases ^= 1u << st;
    }
    __syncthreads();  // ... for every thread; and the products of chunk
                      // it - 2, which read the tiles it refills, are done
    issue(it + NSR - 1);
    const char* st = raw + (it % NSR) * 2 * RAW_OP;
    const long long v0 = chunk_v0(it);
    raw_to_tile<LOWP, A_BF16>(st, tiles(it, 0), tiles(it, 0) + 2 * TA);
    raw_to_tile<LOWP, B_BF16>(
        st + RAW_OP, tiles(it, 1), tiles(it, 1) + 2 * TB,
        b_scale == nullptr ? nullptr
                           : (BULK ? sscale + (it % NSR) * KCH
                                   : b_scale + rbase + v0),
        (int)min((long long)KCH, r_hi - v0));
    wg::fence_smem_for_wgmma();
  };
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
#pragma unroll
  for (int st = 0; st < NSR - 1; ++st) issue(st);
  if (total) transpose(0);
  for (int it = 0; it < total; ++it) {
    __syncthreads();  // chunk it's tiles are written
    wg::fence_operands();
    wg::pin(d);
    char* a_t = tiles(it, 0) + a_half;
    char* b_t = tiles(it, 1);
    wg::mma_chunk<LOWP>(d, a_t, a_t + 2 * TA, b_t, b_t + 2 * TB);
    wg::commit();
    if (it + 1 < total) transpose(it + 1);
    wg::wait_all();
    wg::pin(d);
  }
  wg::for_pairs(d, [&](int m, int nn, float& v0, float& v1) {
    const int mm = 64 * w + m;
    if (mm >= M) return;
    float* o = out + mm * ld_out + nn;
    if (nn < N) o[0] = v0;
    if (nn + 1 < N) o[1] = v1;
  });
}

// grads_block's shared memory: the raw ring, two buffers of tiles, the
// BULK route's ring of scale chunks and the stages' mbarriers
template <bool LOWP>
constexpr int grads_smem() {
  return NSR * 2 * RAW_OP + 8 * wg::tile_bytes<LOWP>(GM) + NSR * KCH * 4 +
         NSR * 8;
}

}  // namespace sv
