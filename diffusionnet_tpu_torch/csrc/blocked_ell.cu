// Kernel B5: the sparse product y = (P A P^T) x of the device eigensolver
// (geometry/eigen.py: every Chebyshev step and every rotate/apply stage), on
// the sliced-ELL format of ops/blocked_ell.py.
//
// Replaces diffusionnet_tpu/ops/blocked_ell.py::_blocked_kernel (the planner
// at blocked_ell.py:128, the Pallas body `kernel` at :278, launched by
// pl.pallas_call at :331) and the COO overflow its wrapper adds at :365-367.
//
// The format: rows, in the RCM order, are cut into slices of 32; slice s
// stores its w_s slots (w_s = its longest row) slot-major, so slot j of the
// slice's 32 rows is cols[offsets[s] + 32 j + r] and vals[...] for r < 32.
// A short row's padding slots hold its own index and 0.
//
// What the TPU kernel does: one core walks the row tiles in order, DMAs a
// whole x window into VMEM and runs one MXU product per (row group, dense
// 128-column panel), because the TPU has a 128 x 128 matrix unit and no
// fast gather. On this card the same panels cost 60-70x the arithmetic and
// bytes the ~7 nonzeros a row need. So this kernel gathers x rows instead:
// y[row] = sum over the row's slots j of vals * x[cols], per row, in
// ascending j, with f32 FFMA, stored once. No atomics, no second pass, no
// overflow: every output is summed by one thread in a fixed order, so the
// result is the same bit for bit on every run.
//
// The mapping: one CTA per slice (32 rows) and per 40 column chunks of x
// (a chunk is a float4, or one float on the scalar path). Each row gets 8
// threads and each thread 5 chunks, lane + 8 i, so C = 160 (40 chunks, the
// eigensolver's width at k = 128) keeps every lane busy, and the 8 lanes of
// a row read one 128-byte line of an x row per load: a warp's load is four
// whole lines. The CTA stages JB slots of its slice's columns and values in
// shared memory with coalesced loads, then each thread walks them.
//
// What bounds it on this card: not device memory but the gather from L2 to
// the SMs. The matrix (8 bytes a slot), x and y cross device memory once,
// about 26 MB on torus(144, 140) and 130 MB on delaunay_sphere(100000) at
// C = 160. But every row reads its ~7 neighbours' x rows, 7 V C 4 bytes
// (450 MB on the Delaunay sphere), and these come from L2 (or L1). The RCM
// order keeps a row's neighbours within a few hundred rows, and CTAs start
// in slice order, so the slices in flight share their x rows in L2, and a
// row's 8 lanes read whole lines. Two slices a CTA (64 rows, so that more
// of a row's neighbours hit the SM's L1) measured 8% slower on the Delaunay
// sphere and 10% on the torus (chip_compare.py, H100 80GB HBM3, 700 W), so
// a CTA takes one slice.
// The row scaling, eps term and mask of the Chebyshev step
// (geometry/eigen.py::_scaled_matvec) stay outside, as plain torch
// elementwise ops, as the JAX package has them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace bell {

constexpr int SR = 32;             // rows per slice
constexpr int TPR = 8;             // threads per row
constexpr int IPT = 5;             // column chunks per thread
constexpr int CHUNKS = TPR * IPT;  // column chunks per CTA
constexpr int JB = 16;             // slots staged per round
constexpr int NT = SR * TPR;       // threads per CTA

enum { BE_BAD_SHAPE = -1 };

// VEC: C a multiple of 4 and x, y 16-byte aligned, so a chunk is a float4;
// else a chunk is one float.
template <bool VEC>
__global__ void __launch_bounds__(NT)
    sell_spmm_kernel(const int* __restrict__ cols,
                     const float* __restrict__ vals,
                     const int* __restrict__ offsets,
                     const float* __restrict__ x, float* __restrict__ y,
                     int C) {
  constexpr int EPC = VEC ? 4 : 1;  // floats per chunk
  __shared__ int s_col[JB * SR];
  __shared__ float s_val[JB * SR];

  const int t = threadIdx.x;
  const int r = t / TPR, lane = t % TPR;
  const int slice = blockIdx.x;
  const int n_chunks = (C + EPC - 1) / EPC;
  const int c0 = blockIdx.y * CHUNKS + lane;  // this thread's first chunk
  const int off = offsets[slice];
  const int width = (offsets[slice + 1] - off) / SR;

  float acc[IPT][EPC];
#pragma unroll
  for (int i = 0; i < IPT; ++i)
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[i][e] = 0.f;

  // the slice's slots in rounds of JB, staged by coalesced loads
  for (int j0 = 0; j0 < width; j0 += JB) {
    const int jn = min(JB, width - j0);
    __syncthreads();  // the previous round's reads are done
    for (int e = t; e < jn * SR; e += NT) {
      const size_t src = (size_t)off + (size_t)j0 * SR + e;
      s_col[e] = __ldg(cols + src);
      s_val[e] = __ldg(vals + src);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < jn; ++j) {
      const int col = s_col[j * SR + r];
      const float a = s_val[j * SR + r];
      const float* xr = x + (size_t)col * C;
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
        const int ch = c0 + TPR * i;
        if (ch < n_chunks) {
          if constexpr (VEC) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(xr) + ch);
            acc[i][0] = fmaf(a, v.x, acc[i][0]);
            acc[i][1] = fmaf(a, v.y, acc[i][1]);
            acc[i][2] = fmaf(a, v.z, acc[i][2]);
            acc[i][3] = fmaf(a, v.w, acc[i][3]);
          } else {
            acc[i][0] = fmaf(a, __ldg(xr + ch), acc[i][0]);
          }
        }
      }
    }
  }
  float* yr = y + ((size_t)slice * SR + r) * C;
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int ch = c0 + TPR * i;
    if (ch < n_chunks) {
      if constexpr (VEC)
        reinterpret_cast<float4*>(yr)[ch] =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      else
        yr[ch] = acc[i][0];
    }
  }
}

template <bool VEC>
int launch(const int* cols, const float* vals, const int* offsets,
           const float* x, float* y, int n_slices, int C,
           cudaStream_t stream) {
  const int n_chunks = VEC ? C / 4 : C;
  const dim3 grid((unsigned)n_slices,
                  (unsigned)((n_chunks + CHUNKS - 1) / CHUNKS));
  sell_spmm_kernel<VEC><<<grid, NT, 0, stream>>>(cols, vals, offsets, x, y,
                                                  C);
  return (int)cudaGetLastError();
}

}  // namespace bell

extern "C" {

// y (n_slices * 32, C) = the sliced-ELL matrix times x (n_slices * 32, C),
// both row-major f32. cols, vals: the slots; offsets (n_slices + 1,) int32.
// vec: the caller found C a multiple of 4 and x, y 16-byte aligned.
int bell_matvec_launch(const int* cols, const float* vals, const int* offsets,
                       const float* x, float* y, int n_slices, int C, int vec,
                       void* stream) {
  using namespace bell;
  if (n_slices < 1 || C < 1 || (long long)n_slices * SR > INT32_MAX ||
      (vec && C % 4 != 0))
    return BE_BAD_SHAPE;
  if (((vec ? C / 4 : C) + CHUNKS - 1) / CHUNKS > 65535) return BE_BAD_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(cols, vals, offsets, x, y, n_slices, C, s)
             : launch<false>(cols, vals, offsets, x, y, n_slices, C, s);
}

const char* bell_error_string(int code) {
  if (code == bell::BE_BAD_SHAPE) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
