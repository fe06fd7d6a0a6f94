// The fused spectral block for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels `_kernel` / `_kernel_batched`
// (diffusionnet_tpu/ops/pallas_fused.py:37 and :154, launched at :91 and
// :200; B4a is B4b at B = 1) and phase 0 of `_make_fwd_kernel`
// (diffusionnet_tpu/ops/pallas_megablock.py:149, launched at :244: B3's
// projection, whose phase 1 is B1's tile body). Per batch element b:
//
//   spectral_project:  x_hat = Phi^T (m (.) x)                   (K, C) f32
//   spectral_apply:    s = coefs (.) x_hat
//                      y = Phi s;  ygx = GX s;  ygy = GY s       (V, C) each
//
// What bounds it on this card. At the segmentation training shape (B = 4,
// V = 32768, K = C = 128, f32) the function must read x, Phi, GX and GY and
// write three outputs: 7 x 16.8 MB per mesh, about 470 MB, 0.14 ms at
// 3.35 TB/s. It does 4 x 2VKC = 17.2 GFLOP, 0.10 ms at the TF32 rate of
// three passes: memory bounds it. This version multiplies in plain f32 FFMA
// (the f32 inputs must hold 1e-4 against the plain version; one TF32 pass
// does not), so its own floor is 17.2 GFLOP at 67 TFLOP/s, about 0.26 ms.
// On an H100 80GB HBM3 at a 700 W power limit it took 0.16 ms
// (spectral_project) and 0.70 ms (spectral_apply, 250 registers a thread:
// one CTA per SM) at that shape.
//
// What the design does about what does not carry over from the TPU kernel:
//  * The TPU kernel carries the x_hat sum across a sequential grid in VMEM.
//    Here the row tiles of a mesh run in parallel: each CTA of
//    spectral_project sums a fixed, strided set of 32-row tiles into its own
//    (128, 128) f32 slot, in the slot layout of B1's x_hat partials, and
//    `xhat_reduce_kernel` (megablock_fwd.cu) adds the slots in a fixed
//    order. No floating-point atomics: x_hat is deterministic. K and C of
//    any size are covered in 128 x 128 pieces, one slot per piece.
//  * s = coefs (.) x_hat lives in shared memory (128 x 128 f32, 66 KB with
//    padding: dynamic shared memory above 48 KB), one CTA per (b, 128-row
//    tile, 128-column tile) of the outputs. The coefficient multiply is fused
//    into its staging. The operator rows are staged in 32-column chunks, the
//    next chunk's loads in flight in registers during this chunk's products;
//    only the three outputs go to device memory.
//  * Each thread owns an 8 x 8 block of the output (FFMA outer products, f32
//    accumulation). Rows past V and columns past K or C are masked here: the
//    wrapper needs no padded copy.
//
// Types: x and the operators each f32 or bf16; everything is computed in
// f32. With LOWP (B3 on bf16 operators) both operands of the projection,
// Phi and m (.) x, are rounded to bf16 first, as the TPU kernel's `_dot_t`
// does; the products are exact in f32. The outputs are stored in x's dtype.

#include "megablock_common.cuh"

namespace {

using namespace mb;

constexpr int ST = 256;        // threads per CTA (16 x 16)
constexpr int PIECE = SLOT;    // side of a (K, C) piece: the x_hat slot side
constexpr int LDP = PIECE + 4; // padded row of a staged 128-wide tile
constexpr int PR = 32;         // rows per tile of spectral_project
constexpr int AR = 128;        // rows per CTA of spectral_apply
constexpr int AK = 32;         // operator columns per staged chunk (apply)
constexpr int LDK = AK + 4;
static_assert(ST == 256 && PIECE == 128, "8 x 8 outputs per thread");

// Each thread owns the 8 columns {4 t + j, 64 + 4 t + j : j < 4} of a
// 128-wide piece: a quarter warp reads 8 consecutive float4 of a staged row
// (no bank conflicts) and a half warp writes 256 contiguous bytes.
__device__ __forceinline__ int col8(int t, int i) {
  return (i < 4 ? 4 * t : 64 + 4 * t) + (i & 3);
}

__device__ __forceinline__ void load8(const float* row, int t, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 b = *reinterpret_cast<const float4*>(row + 64 + 4 * t);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

struct ProjectArgs {
  const void* x;      // (B,V,C) f32 or bf16
  const void* evecs;  // (B,V,K) f32 or bf16
  const float* mass;  // (B,V)
  float* partial;     // (B * nkt * nct, nsplit, PIECE, PIECE)
  int B, V, K, C, nkt, nct, nsplit, n_tiles;
  int x_bf16, ops_bf16;
};

// Grid (nsplit, nkt * nct, B). CTA (split, piece, b) sums the tiles split,
// split + nsplit, ... of batch element b into its slot: rows k0.. of the
// piece are x_hat rows, columns c0.. x_hat columns.
template <bool LOWP>
__global__ void __launch_bounds__(ST) spectral_project_kernel(
    const ProjectArgs p) {
  __shared__ __align__(16) float sP[PR * LDP];  // Phi tile, k in a row
  __shared__ __align__(16) float sX[PR * LDP];  // m (.) x tile, c in a row
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kt = blockIdx.y / p.nct, ct = blockIdx.y % p.nct;
  const int k0 = kt * PIECE, c0 = ct * PIECE;
  const int V = p.V, K = p.K, C = p.C;
  const size_t vbase = (size_t)b * V;

  // staging: element i = tid + r * ST of a PR x PIECE tile is (row i / PIECE,
  // column i % PIECE); consecutive threads read consecutive columns
  constexpr int R = PR * PIECE / ST;
  float rp[R], rx[R], rm[R];
  auto fetch = [&](int tile) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * ST, row = tile * PR + i / PIECE;
      const int col = i % PIECE;
      const bool in = row < V;
      rp[r] = (in && k0 + col < K)
                  ? raw_load(p.evecs, (vbase + row) * K + k0 + col, p.ops_bf16)
                  : 0.f;
      rx[r] = (in && c0 + col < C)
                  ? raw_load(p.x, (vbase + row) * C + c0 + col, p.x_bf16)
                  : 0.f;
      rm[r] = in ? p.mass[vbase + row] : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int tile = split;
  if (tile < p.n_tiles) fetch(tile);
  for (; tile < p.n_tiles; tile += p.nsplit) {
    __syncthreads();  // the previous tile's readers of sP / sX are done
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * ST, o = (i / PIECE) * LDP + i % PIECE;
      sP[o] = rnd<LOWP>(from_raw(rp[r], p.ops_bf16));
      sX[o] = rnd<LOWP>(from_raw(rx[r], p.x_bf16) * rm[r]);
    }
    __syncthreads();
    if (tile + p.nsplit < p.n_tiles) fetch(tile + p.nsplit);
#pragma unroll 4
    for (int m = 0; m < PR; ++m) {
      float a[8], v[8];
      load8(sP + m * LDP, ty, a);
      load8(sX + m * LDP, tx, v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
  }

  // the slot is written whole (zeros past K and C): xhat_reduce reads its
  // (K, C) corner, and a split piece's corners are the full slot
  const int piece = (b * p.nkt + kt) * p.nct + ct;
  float* slot =
      p.partial + ((size_t)piece * p.nsplit + split) * PIECE * PIECE;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = slot + (size_t)col8(ty, i) * PIECE;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

struct ApplyArgs {
  const float* xhat;   // (B,K,C)
  const float* coefs;  // (B,K,C)
  const void* op[3];   // Phi, GX, GY: (B,V,K) f32 or bf16
  void* out[3];        // y, ygx, ygy: (B,V,C) f32 or bf16
  int B, V, K, C;
  int ops_bf16, out_bf16;
};

// One of three pointers by a runtime index, without indexing the kernel's
// parameter array at run time (which would copy it to local memory).
template <class T>
__device__ __forceinline__ T pick(T a, T b, T c, int o) {
  return o == 0 ? a : (o == 1 ? b : c);
}

// Loads of operator chunk `chunk` (operator chunk / n_kc, columns
// (chunk % n_kc) * AK ..) into registers: element i = tid + r * ST of the
// chunk is (row i / AK, column i % AK); 0 past V and K.
template <int R>
__device__ __forceinline__ void fetch_chunk(const ApplyArgs& p, int chunk,
                                            int n_kc, int row0, size_t vbase,
                                            int tid, float (&ra)[R]) {
  const int o = chunk / n_kc, k0 = (chunk % n_kc) * AK;
  const void* op = pick(p.op[0], p.op[1], p.op[2], o);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * ST, row = row0 + i / AK, k = k0 + i % AK;
    ra[r] = (row < p.V && k < p.K)
                ? raw_load(op, (vbase + row) * p.K + k, p.ops_bf16)
                : 0.f;
  }
}

// The three outputs' values of one thread (rows ty + 16 i, columns
// col8(tx, j)) stored in the output's dtype: 4 consecutive columns as one
// 16-byte (f32) or 8-byte (bf16) store when C % 4 == 0, else one by one.
__device__ __forceinline__ void store_tile(const ApplyArgs& p, int o,
                                           const float (&acc)[8][8], int row0,
                                           int c0, size_t vbase, int tx,
                                           int ty) {
  const int V = p.V, C = p.C;
  const bool vec = C % 4 == 0;
  void* out = pick(p.out[0], p.out[1], p.out[2], o);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= V) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + col8(tx, 4 * h);
      if (c >= C) continue;
      const size_t e = (vbase + row) * C + c;
      const float v0 = acc[i][4 * h], v1 = acc[i][4 * h + 1];
      const float v2 = acc[i][4 * h + 2], v3 = acc[i][4 * h + 3];
      if (vec && p.out_bf16) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v2, v3);
        uint2 w;
        w.x = *reinterpret_cast<uint32_t*>(&lo);
        w.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + e) =
            w;
      } else if (vec) {
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + e) =
            make_float4(v0, v1, v2, v3);
      } else {
        const float v[4] = {v0, v1, v2, v3};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j >= C) continue;
          if (p.out_bf16)
            reinterpret_cast<__nv_bfloat16*>(out)[e + j] =
                __float2bfloat16_rn(v[j]);
          else
            reinterpret_cast<float*>(out)[e + j] = v[j];
        }
      }
    }
  }
}

// Grid (ceil(V / AR), nct, B). CTA (tile, ct, b) writes rows tile * AR ..
// and columns ct * PIECE .. of all three outputs. Thread (tx, ty) owns rows
// ty + 16 i (i < 8) and columns col8(tx, j). The CTA walks the operators'
// AK-column chunks in one sequence (Phi's, then GX's, then GY's); the next
// chunk's loads are in flight in registers while this one is multiplied.
__global__ void __launch_bounds__(ST) spectral_apply_kernel(const ApplyArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                 // PIECE x LDP: s rows k, columns c
  float* sA = sS + PIECE * LDP;     // AR x LDK: operator chunk
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * AR, c0 = blockIdx.y * PIECE, b = blockIdx.z;
  const int V = p.V, K = p.K, C = p.C;
  const size_t vbase = (size_t)b * V;
  const float* coefs = p.coefs + (size_t)b * K * C;
  const float* xhat = p.xhat + (size_t)b * K * C;
  const int n_ks = (K + PIECE - 1) / PIECE;
  const int n_kc = (K + AK - 1) / AK;  // chunks per operator; PIECE % AK == 0
  static_assert(PIECE % AK == 0, "a chunk lies inside one piece of s");

  constexpr int R = AR * AK / ST;
  float ra[R];
  float acc[8][8];
  fetch_chunk(p, 0, n_kc, row0, vbase, tid, ra);
#pragma unroll 1
  for (int chunk = 0; chunk < 3 * n_kc; ++chunk) {
    const int o = chunk / n_kc, k0 = (chunk % n_kc) * AK;
    const int ks = k0 - k0 % PIECE;
    if (k0 == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (k0 == ks && (o == 0 || n_ks > 1)) {
      // s of rows ks..: staged once when K <= 128, with coefs fused
      __syncthreads();
      for (int i = tid; i < PIECE * PIECE; i += ST) {
        const int k = ks + i / PIECE, c = c0 + i % PIECE;
        float v = 0.f;
        if (k < K && c < C)
          v = coefs[(size_t)k * C + c] * xhat[(size_t)k * C + c];
        sS[(i / PIECE) * LDP + i % PIECE] = v;
      }
    }
    __syncthreads();  // sS is staged; the last chunk's readers of sA are done
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * ST;
      sA[(i / AK) * LDK + i % AK] = from_raw(ra[r], p.ops_bf16);
    }
    __syncthreads();
    if (chunk + 1 < 3 * n_kc)
      fetch_chunk(p, chunk + 1, n_kc, row0, vbase, tid, ra);
    const float* srow = sS + (k0 - ks) * LDP;
#pragma unroll 1
    for (int kk = 0; kk < AK; kk += 4) {
      float v[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q) load8(srow + (kk + q) * LDP, tx, v[q]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(sA + (ty + 16 * i) * LDK + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s = acc[i][j];
          s = fmaf(a.x, v[0][j], s);
          s = fmaf(a.y, v[1][j], s);
          s = fmaf(a.z, v[2][j], s);
          s = fmaf(a.w, v[3][j], s);
          acc[i][j] = s;
        }
      }
    }
    if (k0 + AK >= K) store_tile(p, o, acc, row0, c0, vbase, tx, ty);
  }
}

constexpr size_t APPLY_SMEM = sizeof(float) * ((size_t)PIECE * LDP + AR * LDK);

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// partial: (B * nkt * nct, nsplit, 128, 128) f32 with nkt = ceil(K / 128),
// nct = ceil(C / 128); nsplit <= ceil(V / 32). lowp: round both operands of
// the products to bf16.
int sf_project_launch(const void* x, const void* evecs, const void* mass,
                      void* partial, int B, int V, int K, int C, int nsplit,
                      int x_bf16, int ops_bf16, int lowp, void* stream) {
  ProjectArgs p = {};
  p.x = x; p.evecs = evecs;
  p.mass = static_cast<const float*>(mass);
  p.partial = static_cast<float*>(partial);
  p.B = B; p.V = V; p.K = K; p.C = C;
  p.nkt = (K + PIECE - 1) / PIECE;
  p.nct = (C + PIECE - 1) / PIECE;
  p.n_tiles = (V + PR - 1) / PR;
  p.nsplit = nsplit;
  p.x_bf16 = x_bf16; p.ops_bf16 = ops_bf16;
  if (B < 1 || B > 65535 || V < 1 || K < 1 || C < 1 || nsplit < 1 ||
      nsplit > p.n_tiles || p.nkt * p.nct > 65535 || !aligned16(partial))
    return MB_BAD_SHAPE;
  dim3 grid(nsplit, p.nkt * p.nct, B);
  auto s = static_cast<cudaStream_t>(stream);
  if (lowp)
    spectral_project_kernel<true><<<grid, ST, 0, s>>>(p);
  else
    spectral_project_kernel<false><<<grid, ST, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// xhat, coefs: (B,K,C) f32; evecs/gx/gy: (B,V,K); y/ygx/ygy: (B,V,C) in the
// dtype out_bf16 names.
int sf_apply_launch(const void* xhat, const void* coefs, const void* evecs,
                    const void* gx, const void* gy, void* y, void* ygx,
                    void* ygy, int B, int V, int K, int C, int ops_bf16,
                    int out_bf16, void* stream) {
  ApplyArgs p = {};
  p.xhat = static_cast<const float*>(xhat);
  p.coefs = static_cast<const float*>(coefs);
  p.op[0] = evecs; p.op[1] = gx; p.op[2] = gy;
  p.out[0] = y; p.out[1] = ygx; p.out[2] = ygy;
  p.B = B; p.V = V; p.K = K; p.C = C;
  p.ops_bf16 = ops_bf16; p.out_bf16 = out_bf16;
  const int nct = (C + PIECE - 1) / PIECE;
  if (B < 1 || B > 65535 || V < 1 || K < 1 || C < 1 || nct > 65535)
    return MB_BAD_SHAPE;
  for (int o = 0; o < 3; ++o)
    if (!aligned16(p.out[o])) return MB_BAD_LAYOUT;
  cudaError_t err = cudaFuncSetAttribute(
      spectral_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)APPLY_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((V + AR - 1) / AR, nct, B);
  spectral_apply_kernel<<<grid, ST, APPLY_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
