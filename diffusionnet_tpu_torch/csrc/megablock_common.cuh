// Pieces shared by the block kernels B1 (megablock_fwd.cu, and its wide
// route megablock_fwd_wide.cu) and B2 (megablock_bwd.cu), and by
// spectral_fused.cu: element loads, bf16 rounding, the wide route's TF32
// tensor-core operand handling and weight product, and the dropout hash.
//
// The wide route's products run on the tensor cores (WMMA, TF32 16x16x8,
// f32 accumulation). f32 operands are split into TF32 hi + lo parts and
// multiplied in three passes (near-f32 accuracy); bf16-rounded operands
// (LOWP) are exact in TF32 and take one pass. B1's row kernel and B2 run on
// wgmma (wgmma.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>


namespace mb {

using namespace nvcuda;

constexpr int NT = 512;        // the wide route's threads per CTA: 16 warps
constexpr int PAD = 4;         // row padding of shared buffers (floats)
constexpr int DEPTH = 4;       // k-steps of weight fragments in flight
constexpr int MAX_DENSE = 16;  // MLP layers a launch's arguments hold
constexpr int SLOT = 128;      // side of an x_hat partial slot: (K, C) are
                               // covered in SLOT x SLOT pieces

// The wide route's row tile of TV rows (32, or 16 where 32 rows' buffers
// do not fit in shared memory): RB 16-row blocks, and the 16 warps' 16x16
// output blocks cover NP = 16 * (16 / RB) columns per pass of a product.
template <int TV>
struct Tile {
  static_assert(TV == 16 || TV == 32, "row tile of 16 or 32");
  static constexpr int RB = TV / 16;
  static constexpr int NP = 16 * (NT / 32 / RB);
  static constexpr int LDC = NP + PAD;  // the warps' output patches
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                              wmma::precision::tf32, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

// Error codes beyond cudaError_t's: the wrapper turns them into messages.
enum { MB_BAD_SHAPE = -1, MB_SMEM = -2, MB_BAD_LAYOUT = -3 };

// A load kept apart from its use: staging loops first put their loads in
// flight, then convert and round. A bf16 element travels as its 16 bits in
// the low half of a float register.
__device__ __forceinline__ float raw_load(const void* p, size_t i, int bf16) {
  return bf16 ? __uint_as_float(
                    (uint32_t)reinterpret_cast<const unsigned short*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float from_raw(float raw, int bf16) {
  return bf16 ? __uint_as_float(__float_as_uint(raw) << 16) : raw;
}

__device__ __forceinline__ float load_elem(const void* p, size_t i, int bf16) {
  return from_raw(raw_load(p, i, bf16), bf16);
}

// With LOWP every product operand is rounded to bf16 (round to nearest even).
template <bool LOWP>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (LOWP) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Operands for near-f32 products on TF32 tensor cores: hi = tf32(v),
// lo = tf32(v - hi). bf16-rounded operands (LOWP) are exact in TF32 and are
// used as they are.
template <bool LOWP, class Frag>
__device__ __forceinline__ void split(Frag& hi, Frag& lo) {
  if constexpr (!LOWP) {
#pragma unroll
    for (int i = 0; i < hi.num_elements; ++i) {
      const float v = hi.x[i];
      const float h = wmma::__float_to_tf32(v);
      hi.x[i] = h;
      lo.x[i] = wmma::__float_to_tf32(v - h);
    }
  }
}

// A fragment loaded as stored (f32) made into product operands: rounded to
// bf16 with LOWP, else split into TF32 hi + lo.
template <bool LOWP, class Frag>
__device__ __forceinline__ void operands(Frag& hi, Frag& lo) {
  if constexpr (LOWP) {
#pragma unroll
    for (int i = 0; i < hi.num_elements; ++i) hi.x[i] = rnd<true>(hi.x[i]);
  } else {
    split<false>(hi, lo);
  }
}

// acc += a b: three TF32 products (a_lo b_hi + a_hi b_lo + a_hi b_hi; the
// dropped a_lo b_lo is ~2^-22 relative), or one when the operands are exact.
template <bool LOWP, class FA, class FB>
__device__ __forceinline__ void mma3(FragC& acc, const FA& a_hi, const FA& a_lo,
                                     const FB& b_hi, const FB& b_lo) {
  if constexpr (!LOWP) {
    wmma::mma_sync(acc, a_lo, b_hi, acc);
    wmma::mma_sync(acc, a_hi, b_lo, acc);
  }
  wmma::mma_sync(acc, a_hi, b_hi, acc);
}

// Hands warp (rb, cb)'s 16x16 output block, whose first column is c0, to
// epi(m, n, v) for columns n < N, through the warp's own patch of sC.
template <int TV, class EPI>
__device__ __forceinline__ void warp_epilogue(const FragC& acc, int rb, int cb,
                                              int c0, int N, EPI epi,
                                              float* sC) {
  constexpr int LDC = Tile<TV>::LDC;
  const int lane = threadIdx.x % 32;
  float* patch = sC + rb * 16 * LDC + cb * 16;
  wmma::store_matrix_sync(patch, acc, LDC, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * 16; i += 32) {
    const int m = i / 16, n = i % 16;
    if (c0 + n < N) epi(rb * 16 + m, c0 + n, patch[m * LDC + n]);
  }
  __syncwarp();
}

// A weight product of one tile: epi(m, n, sum_k A[m][k] W[k][n]) for
// m < TV, n < N. A is resident in shared memory (row stride lda, finite
// values past Kd up to a multiple of 8). W stays in global memory
// (L2-resident), row stride ldw, zero past Kd up to a multiple of 8 along
// the contraction, readable up to a multiple of 16 along N. N is covered in
// passes of NP columns; in a pass warp w owns the 16x16 output block
// (w % RB, w / RB) and streams its own fragments of W, DEPTH k-steps ahead,
// so the contraction has no barrier. Two accumulators make two independent
// chains of products.
template <bool LOWP, int TV, class EPI>
__device__ __forceinline__ void weight_gemm(int Kd, int N, const float* A,
                                            int lda, const float* W, int ldw,
                                            EPI epi, float* sC) {
  constexpr int RB = Tile<TV>::RB, NP = Tile<TV>::NP;
  const int warp = threadIdx.x / 32, rb = warp % RB, cb = warp / RB;
  const int steps = (Kd + 7) / 8;
  __syncthreads();  // A's writers are done, and so are the last readers of
                    // what epi overwrites
  for (int n0 = 0; n0 < N; n0 += NP) {
    const int c0 = n0 + cb * 16;
    if (c0 >= N) continue;  // warp-uniform
    const float* a = A + rb * 16 * lda;
    auto wfrag = [&](int s) { return W + (size_t)s * 8 * ldw + c0; };
    FragB ring[DEPTH];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j)
      if (j < steps) wmma::load_matrix_sync(ring[j], wfrag(j), ldw);
    FragC acc, acc2;
    wmma::fill_fragment(acc, 0.f);
    wmma::fill_fragment(acc2, 0.f);
    for (int s0 = 0; s0 < steps; s0 += DEPTH) {
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        const int s = s0 + j;
        if (s >= steps) break;
        FragB b_hi = ring[j], b_lo;
        if (s + DEPTH < steps)
          wmma::load_matrix_sync(ring[j], wfrag(s + DEPTH), ldw);
        FragA a_hi, a_lo;
        wmma::load_matrix_sync(a_hi, a + s * 8, lda);
        operands<LOWP>(a_hi, a_lo);
        operands<LOWP>(b_hi, b_lo);
        if constexpr (LOWP) {
          FragC& c = j % 2 ? acc2 : acc;
          wmma::mma_sync(c, a_hi, b_hi, c);
        } else {
          wmma::mma_sync(acc2, a_lo, b_hi, acc2);
          wmma::mma_sync(acc2, a_hi, b_lo, acc2);
          wmma::mma_sync(acc, a_hi, b_hi, acc);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += acc2.x[i];
    warp_epilogue<TV>(acc, rb, cb, c0, N, epi, sC);
  }
}

// Dropout, as the JAX kernel draws it in interpret mode
// (pallas_megablock.py:72-110): the counter idx = row_in_tile * width + col
// of a (tile_v, width) tile, the seed and the key (b * 65536 + i) * 16 +
// layer folded in, then the splitmix finaliser; uint32 arithmetic wraps as
// jnp.uint32 does.
__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t seed,
                                              uint32_t key) {
  uint32_t h = idx;
  h ^= seed + 0x9E3779B9u + (h << 6) + (h >> 2);
  h ^= key + 0x9E3779B9u + (h << 6) + (h >> 2);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

struct Dropout {
  int on, seed, tile_v;
  // v (the f32 activation of row `row` of batch element b, column col of a
  // width-wide layer output, feeding dense layer layer + 1) after dropout:
  // kept where the bits are >= 2^31 (rate 0.5), scaled by 2.
  __device__ __forceinline__ float apply(float v, int b, int row, int col,
                                         int width, int layer) const {
    if (!on) return v;
    const int i = row / tile_v, r = row % tile_v;
    const uint32_t key = (uint32_t)((b * 65536 + i) * 16 + layer);
    const uint32_t bits =
        hash_bits((uint32_t)(r * width + col), (uint32_t)seed, key);
    return bits >= 0x80000000u ? v * 2.f : 0.f;
  }
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// A matrix read as weight_gemm reads its W: 32-byte aligned rows, a row
// stride that covers the columns rounded up to 16.
inline bool weight_layout_ok(const void* w, int ld, int cols) {
  return reinterpret_cast<uintptr_t>(w) % 32 == 0 && ld % 8 == 0 &&
         ld >= round_up(cols, 16);
}

}  // namespace mb
