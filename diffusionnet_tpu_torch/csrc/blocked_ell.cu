// Kernel B5: the blocked-ELL SpMM y = (P A P^T) x of the device eigensolver
// (geometry/eigen.py: every Chebyshev step and every rotate/apply stage).
//
// Replaces diffusionnet_tpu/ops/blocked_ell.py::_blocked_kernel (the Pallas
// body `kernel` at blocked_ell.py:278, launched by pl.pallas_call at :331).
//
// The format (ops/blocked_ell.py): rows, in the RCM order, are cut into
// groups of G (32 or 64) rows; group i stores up to NB dense (G x 128)
// panels, and panel b multiplies the 128 x rows that start at
// starts[t] + offs[i, b] (t = the group's row tile). The planner opens a
// group's panels in order, so its used panels are the first nused[i]; the
// rest are zero and skipped here.
//
// What the TPU kernel does: one core walks the row tiles in order, DMAs the
// tile's whole x window (W x 128 lanes, ~3 MB at 1M vertices) into VMEM,
// double-buffered by hand, and runs one MXU product per (group, panel)
// against that window. What this kernel does instead: one CTA per (row
// group, 32-column tile of x). CTAs run in no order on 132 SMs and each
// owns its output rows, so there is no cross-CTA sum, no atomic, and the
// result is deterministic. A CTA loops over its group's used panels; for
// each it stages the panel (G x 128 f32) and the matching x slab (128 x 32)
// into shared memory with cp.async, double-buffered over the panels, and
// accumulates in registers with f32 FFMA (f32-accurate: the eigensolver's
// wanted band has relative gaps ~1e-5, geometry/eigen.py). No whole window
// is staged: each panel's x rows are read straight from device memory (the
// iterate, at most a few tens of MB, stays in the 50 MB L2 across groups).
// x rows at or past n_x read as zero, so x needs no padding to n_pad_x.
// The CTAs of one group are adjacent in launch order, so a panel read from
// device memory by the first column tile is found in L2 by the others.
//
// What bounds it on this card: the format stores NB * 128 = 1,024 slots per
// row against ~7 nonzeros of a triangle-mesh Laplacian, so it streams the
// panels' bytes (G x 128 x 4 B per used panel) and does their FLOPs
// (2 x G x 128 x 32 per panel and column tile), some 50-140x what the
// nonzeros need. Against the panels alone it is bound by shared-memory
// loads: per k step a thread issues one 16-byte x load and G/16 panel
// loads for 4 G/16 FMAs. The row scaling and masking of the Chebyshev step
// (r x before, r y + eps r^2 x after, bound x on padded rows) stay outside,
// as plain torch elementwise ops; the COO overflow is added outside too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace bell {

constexpr int NT = 128;      // threads per CTA
constexpr int PW = 128;      // panel width: columns of A = rows of the x slab
constexpr int CT = 32;       // output columns per CTA
constexpr int LDA = PW + 4;  // row stride of a staged panel (floats):
                             // the panel loads of a warp's four rows fall
                             // in distinct banks

enum { BE_BAD_SHAPE = -1 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// one float, zero when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VEC: C a multiple of 4 and x, y 16-byte aligned, so x slabs move in
// 16-byte chunks and y is stored as float4; else element by element.
template <int G, bool VEC>
__global__ void __launch_bounds__(NT)
    blocked_ell_kernel(const float* __restrict__ blocks,
                       const int* __restrict__ offs,
                       const int* __restrict__ starts,
                       const int* __restrict__ nused,
                       const float* __restrict__ x, float* __restrict__ y,
                       int n_ct, int groups_per_tile, int nb, int n_x, int C) {
  constexpr int EPC = 4;  // floats per 16-byte chunk
  extern __shared__ float4 smem4[];
  float* const sa0 = reinterpret_cast<float*>(smem4);
  float* const sx0 = sa0 + 2 * G * LDA;
  constexpr int RPT = G / 16;  // output rows per thread

  const int tid = threadIdx.x;
  const int gi = blockIdx.x / n_ct;        // row group
  const int c0 = (blockIdx.x % n_ct) * CT;  // first output column
  const int n_used = nused[gi];
  const float* const gblocks = blocks + (size_t)gi * nb * G * PW;
  const int* const goffs = offs + (size_t)gi * nb;
  const int start = starts[gi / groups_per_tile];
  const int cq = tid & 7;   // columns c0 + 4 cq .. + 3
  const int rq = tid >> 3;  // rows rq + 16 i, i < RPT

  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto stage = [&](int b, int buf) {
    const float* src = gblocks + (size_t)b * G * PW;
    float* dA = sa0 + buf * G * LDA;
    for (int ch = tid; ch < G * (PW / EPC); ch += NT) {
      const int r = ch / (PW / EPC), k = ch % (PW / EPC) * EPC;
      cp_async16(dA + r * LDA + k, src + r * PW + k, true);
    }
    const int row0 = start + goffs[b];
    float* dX = sx0 + buf * PW * CT;
    if constexpr (VEC) {
      for (int ch = tid; ch < PW * (CT / EPC); ch += NT) {
        const int k = ch / (CT / EPC), j = ch % (CT / EPC) * EPC;
        const int row = row0 + k, col = c0 + j;
        const bool ok = row < n_x && col < C;  // C % EPC == 0: whole chunks
        cp_async16(dX + k * CT + j, ok ? x + (size_t)row * C + col : x, ok);
      }
    } else {
      for (int e = tid; e < PW * CT; e += NT) {
        const int k = e / CT, j = e % CT;
        const int row = row0 + k, col = c0 + j;
        const bool ok = row < n_x && col < C;
        cp_async4(dX + k * CT + j, ok ? x + (size_t)row * C + col : x, ok);
      }
    }
    cp_commit();
  };

  if (n_used > 0) stage(0, 0);
  for (int b = 0; b < n_used; ++b) {
    const int buf = b & 1;
    if (b + 1 < n_used) {
      stage(b + 1, buf ^ 1);  // buf ^ 1 was last read before the barrier
      cp_wait<1>();           // closing iteration b - 1
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* A = sa0 + buf * G * LDA + rq * LDA;
    const float* X = sx0 + buf * PW * CT + 4 * cq;
#pragma unroll 8
    for (int k = 0; k < PW; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(X + k * CT);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = A[16 * i * LDA + k];
        acc[i][0] = fmaf(a, xv.x, acc[i][0]);
        acc[i][1] = fmaf(a, xv.y, acc[i][1]);
        acc[i][2] = fmaf(a, xv.z, acc[i][2]);
        acc[i][3] = fmaf(a, xv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  // every row of the group and every column is written, zero where the
  // group has no panel
  const int col = c0 + 4 * cq;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const size_t row = (size_t)gi * G + rq + 16 * i;
    float* dst = y + row * C + col;
    if constexpr (VEC) {  // C % 4 == 0: col < C means col + 3 < C
      if (col < C)
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < C) dst[j] = acc[i][j];
    }
  }
}

template <int G, bool VEC>
int launch(const float* blocks, const int* offs, const int* starts,
           const int* nused, const float* x, float* y, int n_groups,
           int groups_per_tile, int nb, int n_x, int C, cudaStream_t stream) {
  const size_t smem = (size_t)2 * (G * LDA + PW * CT) * sizeof(float);
  auto kernel = blocked_ell_kernel<G, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ct = (C + CT - 1) / CT;
  kernel<<<dim3((unsigned)n_groups * n_ct), NT, smem, stream>>>(
      blocks, offs, starts, nused, x, y, n_ct, groups_per_tile, nb, n_x, C);
  return (int)cudaGetLastError();
}

}  // namespace bell

extern "C" {

// y (n_groups * G, C) = the panels times x (n_x, C), all row-major f32.
// blocks (n_groups, nb, G, 128); offs (n_groups, nb) and nused (n_groups,)
// int32; starts (n_groups / groups_per_tile,) int32. vec: the caller found
// C a multiple of 4 and x, y 16-byte aligned.
int bell_matvec_launch(const float* blocks, const int* offs,
                       const int* starts, const int* nused, const float* x,
                       float* y, int n_groups, int groups_per_tile, int G,
                       int nb, int n_x, int C, int vec, void* stream) {
  using namespace bell;
  if (n_groups < 1 || groups_per_tile < 1 || nb < 1 || n_x < 1 || C < 1 ||
      n_groups % groups_per_tile != 0 || (long long)n_groups * G > INT32_MAX)
    return BE_BAD_SHAPE;
  if ((long long)n_groups * ((C + CT - 1) / CT) > INT32_MAX)
    return BE_BAD_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 32)
    return vec ? launch<32, true>(blocks, offs, starts, nused, x, y, n_groups,
                                  groups_per_tile, nb, n_x, C, s)
               : launch<32, false>(blocks, offs, starts, nused, x, y,
                                   n_groups, groups_per_tile, nb, n_x, C, s);
  if (G == 64)
    return vec ? launch<64, true>(blocks, offs, starts, nused, x, y, n_groups,
                                  groups_per_tile, nb, n_x, C, s)
               : launch<64, false>(blocks, offs, starts, nused, x, y,
                                   n_groups, groups_per_tile, nb, n_x, C, s);
  return BE_BAD_SHAPE;
}

const char* bell_error_string(int code) {
  if (code == bell::BE_BAD_SHAPE) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
