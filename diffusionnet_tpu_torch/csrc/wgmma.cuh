// Hopper warpgroup products (wgmma, sm_90a) for the block kernels
// (megablock_fwd.cu, megablock_bwd.cu): operand tiles in shared memory, the
// product instructions, register-sourced A fragments read from device or
// shared memory, and cp.async.
//
// A tile holds one k-chunk (KCH = 32 values along the contraction) of ROWS
// rows (M rows of A, or N rows of B^T), K-major, without swizzle: core
// matrices of 8 rows x 16 bytes (4 f32/tf32 values, or 8 bf16), stored in
// (row group, k group) order, so the 16-byte unit i of a tile is row
// 8 (i / (8 UPR)) + i % 8, k group (i / 8) % UPR, with UPR = 8 (tf32) or 4
// (bf16) k groups per chunk. The descriptors give the k-direction stride
// between core matrices (leading byte offset) as 128 bytes and the
// row-direction stride (stride byte offset) as UPR * 128 bytes; one
// instruction (k8 for tf32, k16 for bf16) reads two k groups, so step s of
// a chunk starts 256 s bytes into the tile.
//
// f32 operands are multiplied near f32 accuracy in three TF32 passes
// (a_lo b_hi + a_hi b_lo + a_hi b_hi; hi = tf32(v), lo = tf32(v - hi)), so
// an f32 operand has two tiles, hi and lo. With LOWP both operands are
// rounded to bf16 (round to nearest even) and multiplied once.
//
// The accumulator of an m64nN product: thread t of the warpgroup holds, for
// each 8-column block j, d[4j + q] = D[16 w + g + 8 (q / 2)][8 j + 2 c + q % 2]
// with w = t / 32 (its warp), g = (t % 32) / 4, c = t % 4.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wg {

constexpr int NTH = 128;  // threads of a warpgroup
constexpr int KCH = 32;   // contraction values per staged chunk
constexpr int NB = 128;   // N of one product instruction (m64n128)

__device__ __forceinline__ float tf32r(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// Shared-memory matrix descriptor, no swizzle.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t sbo_bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32);
}

__device__ __forceinline__ void fence_operands() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy that wgmma reads through (then a barrier).
__device__ __forceinline__ void fence_smem_for_wgmma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence, commit or wait.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_REGS                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d += A (64 x 8) B (8 x 128), tf32 operands from shared memory.
__device__ __forceinline__ void mma_tf32(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS
      ", %64, %65, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 16) B (16 x 128), bf16 operands from shared memory.
__device__ __forceinline__ void mma_bf16(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 8) B (8 x 128): A tf32 from registers (the thread's
// fragment: rows g and g + 8 of its warp's 16, columns c and c + 4), B from
// shared memory.
__device__ __forceinline__ void mma_tf32_rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 16) B (16 x 128): A bf16 from registers (pairs of columns
// 2c, 2c + 1 and 2c + 8, 2c + 9 of rows g and g + 8), B from shared memory.
__device__ __forceinline__ void mma_bf16_rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D8
#undef WG_REGS

// Bytes of one staged tile of `rows` rows (one of hi / lo for tf32).
template <bool LOWP>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * KCH * (LOWP ? 2 : 4);
}

// d += A_chunk B_chunk^T over one staged k-chunk: A rows a0.. (64 of them)
// of the A tiles, B rows from the start of the B tiles (NB of them).
template <bool LOWP>
__device__ __forceinline__ void mma_chunk(float (&d)[64], const char* a_hi,
                                          const char* a_lo, const char* b_hi,
                                          const char* b_lo) {
  constexpr uint32_t SBO = (LOWP ? 4 : 8) * 128;
#pragma unroll
  for (int s = 0; s < (LOWP ? KCH / 16 : KCH / 8); ++s) {
    const uint64_t ah = desc(a_hi + 256 * s, SBO);
    const uint64_t bh = desc(b_hi + 256 * s, SBO);
    if constexpr (LOWP) {
      mma_bf16(d, ah, bh);
    } else {
      mma_tf32(d, desc(a_lo + 256 * s, SBO), bh);
      mma_tf32(d, ah, desc(b_lo + 256 * s, SBO));
      mma_tf32(d, ah, bh);
    }
  }
}

}  // namespace wg

namespace wg {

// 16-byte asynchronous copies from device to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The A operand of a register-sourced product, one k-chunk of 32 columns:
// the thread (warp w, g = lane / 4, c = lane % 4) holds rows 16 w + g and
// 16 w + g + 8 at the physical columns 8 c .. 8 c + 7 of the chunk, read
// with 16-byte loads. The chunk's contraction order is permuted so that
// these are exactly the thread's fragments: for tf32 step s (4 of them)
// the logical columns c and c + 4 are the physical 8 c + 2 s and
// 8 c + 2 s + 1; for bf16 step s (2 of them) the logical pairs 2c, 2c + 1
// and 2c + 8, 2c + 9 are the physical 8 c + 4 s + {0, 1} and
// 8 c + 4 s + {2, 3}. The B tiles are laid out in the same order
// (ops/megablock.py::b_tiles).
template <bool LOWP, bool SRC_BF16>
struct RowA {
  static constexpr int W = SRC_BF16 ? 4 : 8;  // raw words per row
  uint32_t raw[2][W];

  // Rows arow0 + r (r < 64; at or past rows_valid: 0) and the chunk's
  // columns k0.. of a row-major source (row stride ld; columns at or past
  // kvalid: 0); vec: 16-byte loads allowed.
  __device__ __forceinline__ void load(const void* src, long long ld,
                                       long long arow0, int rows_valid,
                                       int k0, int kvalid, bool vec) {
    const int t = threadIdx.x % NTH, w = t / 32, g = (t % 32) / 4;
    const int k = k0 + 8 * (t % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + g + 8 * h;
      const long long o = (arow0 + r) * ld + k;
      if (r < rows_valid && vec && k + 8 <= kvalid) {
        const uint4* p = reinterpret_cast<const uint4*>(
            reinterpret_cast<const char*>(src) + o * (SRC_BF16 ? 2 : 4));
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const uint4 v = p[q];
          raw[h][4 * q] = v.x; raw[h][4 * q + 1] = v.y;
          raw[h][4 * q + 2] = v.z; raw[h][4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          uint32_t v = 0u;
          if (r < rows_valid && k + e < kvalid)
            v = SRC_BF16
                    ? (uint32_t) reinterpret_cast<const unsigned short*>(src)[o + e]
                    : __float_as_uint(reinterpret_cast<const float*>(src)[o + e]);
          if constexpr (SRC_BF16)
            raw[h][e / 2] = (e % 2) ? (raw[h][e / 2] | (v << 16)) : v;
          else
            raw[h][e] = v;
        }
      }
    }
  }

  __device__ __forceinline__ float value(int h, int e) const {
    if constexpr (SRC_BF16)
      return bf16_bits_to_float((raw[h][e / 2] >> (16 * (e % 2))) & 0xFFFFu);
    else
      return __uint_as_float(raw[h][e]);
  }
};

// The same rows and columns as RowA, held as f32 values, from any
// row-major source given by a generic address: f32 or bf16 (`bf16`, a
// runtime flag) in device memory, or an f32 tile in shared memory (the
// row kernel of B1 keeps its activations there; a row stride of 4 mod 32
// floats puts a quarter-warp's 16-byte loads in distinct banks).
struct RowF {
  float v[2][8];

  __device__ __forceinline__ void load(const void* src, long long ld,
                                       long long arow0, int rows_valid,
                                       int k0, int kvalid, bool vec,
                                       bool bf16) {
    const int t = threadIdx.x % NTH, w = t / 32, g = (t % 32) / 4;
    const int k = k0 + 8 * (t % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + g + 8 * h;
      const long long o = (arow0 + r) * ld + k;
      if (r < rows_valid && vec && k + 8 <= kvalid) {
        if (bf16) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned short*>(src) + o);
          const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[h][2 * q] = bf16_bits_to_float(w4[q] & 0xFFFFu);
            v[h][2 * q + 1] = bf16_bits_to_float(w4[q] >> 16);
          }
        } else {
          const float4* p =
              reinterpret_cast<const float4*>(reinterpret_cast<const float*>(src) + o);
          const float4 a = p[0], b = p[1];
          v[h][0] = a.x; v[h][1] = a.y; v[h][2] = a.z; v[h][3] = a.w;
          v[h][4] = b.x; v[h][5] = b.y; v[h][6] = b.z; v[h][7] = b.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float x = 0.f;
          if (r < rows_valid && k + e < kvalid)
            x = bf16 ? bf16_bits_to_float(
                           reinterpret_cast<const unsigned short*>(src)[o + e])
                     : reinterpret_cast<const float*>(src)[o + e];
          v[h][e] = x;
        }
      }
    }
  }

  __device__ __forceinline__ float value(int h, int e) const {
    return v[h][e];
  }
};

// Bytes of one B stage: a 128 x 32 tile, hi and lo for tf32.
template <bool LOWP>
__host__ __device__ constexpr int b_stage_bytes() {
  return LOWP ? NB * KCH * 2 : 2 * NB * KCH * 4;
}

// The A fragments of one k-chunk, every step's, from a loaded chunk (RowA
// or RowF): tf32 hi and lo (f32), or bf16 pairs rounded to nearest even
// (LOWP).
template <bool LOWP>
struct AFrags {
  static constexpr int STEPS = LOWP ? KCH / 16 : KCH / 8;
  uint32_t hi[STEPS][4], lo[STEPS][4];
  template <class A>
  __device__ __forceinline__ void build(const A& a) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if constexpr (LOWP) {
        hi[s][0] = pack_bf16(a.value(0, 4 * s), a.value(0, 4 * s + 1));
        hi[s][1] = pack_bf16(a.value(1, 4 * s), a.value(1, 4 * s + 1));
        hi[s][2] = pack_bf16(a.value(0, 4 * s + 2), a.value(0, 4 * s + 3));
        hi[s][3] = pack_bf16(a.value(1, 4 * s + 2), a.value(1, 4 * s + 3));
      } else {
        const float v[4] = {a.value(0, 2 * s), a.value(1, 2 * s),
                            a.value(0, 2 * s + 1), a.value(1, 2 * s + 1)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float h = tf32r(v[q]);
          hi[s][q] = __float_as_uint(h);
          lo[s][q] = __float_as_uint(tf32r(v[q] - h));
        }
      }
    }
  }
};

// f(m, n, v0, v1) for the thread's accumulator pairs of a 64 x 128 block:
// row m, columns n and n + 1 from the block's first column.
template <class F>
__device__ __forceinline__ void for_pairs(float (&d)[64], F f) {
  const int t = threadIdx.x % NTH, w = t / 32, g = (t % 32) / 4;
  const int c = t % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(16 * w + g + 8 * h, 8 * j + 2 * c, d[4 * j + 2 * h],
        d[4 * j + 2 * h + 1]);
}

// d += A_chunk B_chunk: A from the fragments in registers, B from a stage
// of shared memory (hi, then lo for tf32). The products read the fragments
// asynchronously: they stay untouched until the caller's wait. A_EXACT: A's
// values are exact in TF32 (bf16 operators beside an f32 B), so a_lo is 0
// and its pass is left out: a b_lo + a b_hi.
template <bool LOWP, bool A_EXACT = false>
__device__ __forceinline__ void mma_chunk_rs(float (&d)[64],
                                             const AFrags<LOWP>& f,
                                             const char* b) {
  constexpr uint32_t SBO = (LOWP ? 4 : 8) * 128;
#pragma unroll
  for (int s = 0; s < AFrags<LOWP>::STEPS; ++s) {
    const uint64_t bh = desc(b + 256 * s, SBO);
    if constexpr (LOWP) {
      mma_bf16_rs(d, f.hi[s], bh);
    } else {
      const uint64_t bl = desc(b + NB * KCH * 4 + 256 * s, SBO);
      if constexpr (!A_EXACT) mma_tf32_rs(d, f.lo[s], bh);
      mma_tf32_rs(d, f.hi[s], bl);
      mma_tf32_rs(d, f.hi[s], bh);
    }
  }
}

}  // namespace wg
