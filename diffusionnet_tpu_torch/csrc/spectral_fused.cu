// The fused spectral block for Hopper (sm_90a): two kernels on wgmma.
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
// The TPU kernel carries x_hat across its sequential grid in VMEM and then
// streams the operators again. Here the two halves are two kernels:
//
//  * spectral_project_kernel: x_hat as TN products over V on a split-V grid
//    (splitv.cuh::grads_block, shared with B1's x_hat kernel and B2's grads
//    kernel). Each CTA owns one 128 x 128 piece of (K, C) of one batch
//    element and one fixed range of rows (ops/megablock.py::xhat_splits),
//    keeps its accumulator in registers across the range and writes one
//    partial slot, whole (zeros past K and C), once; m scales x's rows in
//    f32 before the TF32 split (or the bf16 rounding of lowp), its factors
//    staged with each chunk, and chunks of whole 128-value rows come by
//    bulk copies (grads_block's BULK route). Then `xhat_reduce_kernel`
//    (megablock_fwd.cu) adds the slots in a fixed order. With three
//    (operator, cotangent) pairs and no scale the same kernel computes
//    B4's backward ds = Phi^T dy + GX^T dgx + GY^T dgy.
//  * spectral_apply_kernel: a 64-row wgmma row kernel. Each CTA is
//    persistent: it walks a contiguous range of (batch element, 128-column
//    piece of C, pair of 64-row tiles) items, two warpgroups a CTA, each on
//    its own 64-row tile of the pair. s = coefs (.) x_hat of the item's
//    batch element and column piece is staged in shared memory once, where
//    the range reaches a new (b, piece), as the B operand: K-major TF32 hi /
//    lo tiles (128 KB for 128 rows of K), each 32-value chunk of the
//    contraction in the permuted order of a thread's A fragments
//    (wgmma.cuh::RowF; ops/megablock.py::b_tiles lays B1's B tiles out the
//    same way). Restaging s per tile would read 268 MB from L2 at B = 4,
//    V = 32768. A is the operator rows, read from device memory straight
//    into the thread's fragments (two 16-byte loads a row and chunk), two
//    chunks ahead of the products. The three products (Phi, GX, GY) run
//    one after another through one product loop and one 64-float
//    accumulator; a finished product goes to the warpgroup's
//    shared-memory tile, and its rows are stored to device memory (a warp
//    a 512-byte row, coalesced) a slice per chunk while the next product's
//    chunks run on the tensor cores.
//
// No slot is read, modified and written per tile, and nothing is summed
// with floating-point atomics: two launches give the same bits.
//
// Precision. f32 products take three TF32 passes (a_lo b_hi + a_hi b_lo +
// a_hi b_hi; hi = tf32(v), lo = tf32(v - hi)): the f32 outputs must hold
// 1e-4 against the plain version, which one pass does not. bf16 operators
// are exact in TF32 (8 significant bits), so spectral_apply takes two
// passes there (a s_lo + a s_hi). With LOWP (B3 on bf16 operators) both
// operands of the projection, Phi and m (.) x, are rounded to bf16 first,
// as the TPU kernel's `_dot_t` does, and multiplied once. Outputs are
// stored in x's dtype.
//
// What bounds it on this card. At the segmentation training shape (B = 4,
// V = 32768, K = C = 128, f32) spectral_apply must read Phi, GX and GY and
// write three outputs (403 MB, 0.120 ms at 3.35 TB/s) and does 3 x 2VKC =
// 12.9 GFLOP (0.078 ms at the TF32 rate of three passes): memory bounds it,
// and the products must overlap the traffic to come near it. The
// projection reads x, Phi and m (135 MB, 0.040 ms). The FFMA kernels these
// replace took 0.70 ms (spectral_apply: 250 registers a thread, one CTA an
// SM) and 0.16 ms (spectral_project) on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit (chip_smoke.py).
//
// Shapes. Rows past V, contraction values past K and columns past C are
// masked (loads give 0, stores are skipped); K and C of any size are
// covered in 128-wide pieces. Where K > 128 spectral_apply restages s for
// every 128-row piece of K of every product (that is slower, and no model
// of the repo has it); the wrapper makes no padded copy.

#include "megablock_common.cuh"
#include "splitv.cuh"
#include "wgmma.cuh"

namespace {

using namespace mb;
using wg::KCH;
using wg::NB;

// ---------------------------------------------------------------------------
// spectral_project (and B4's backward ds): split-V TN products
// ---------------------------------------------------------------------------

struct ProjectArgs {
  const void* A[3];    // operators, (B V, K) row-major, one dtype
  const void* Bm[3];   // (B V, C) row-major, one dtype
  const float* scale;  // (B V) factors of B's rows, or null
  float* part;         // (B, nkt, nct, S, SLOT, SLOT)
  int nterms, V, K, C, S, L, nkt, nct, a_vec, b_vec;
};

// CTA (b, kt, ct, split) writes slot part[b][kt][ct][split] = sum over t of
// A_t[b][v, 128 kt..]^T (scale (.) B_t)[b][v, 128 ct..] over the rows v of
// [split L, (split + 1) L) of V: the whole slot, zeros past K and C.
template <bool LOWP, bool A_BF16, bool B_BF16>
__global__ void __launch_bounds__(sv::GNT, 1)
    spectral_project_kernel(const ProjectArgs p) {
  extern __shared__ __align__(128) char smem[];
  long long id = blockIdx.x;
  const int split = (int)(id % p.S);
  id /= p.S;
  const int ct = (int)(id % p.nct);
  id /= p.nct;
  const int kt = (int)(id % p.nkt);
  const long long b = id / p.nkt;
  const long long r_lo = (long long)split * p.L;
  const long long r_hi = min(r_lo + p.L, (long long)p.V);
  const void* A[3] = {p.A[0], p.A[1], p.A[2]};
  const void* Bm[3] = {p.Bm[0], p.Bm[1], p.Bm[2]};
  float* out =
      p.part + (((b * p.nkt + kt) * p.nct + ct) * p.S + split) * SLOT * SLOT;
  sv::grads_block<LOWP, A_BF16, B_BF16, true>(
      smem, A, p.K, p.a_vec, Bm, p.C, p.nterms, b * p.V, r_lo, r_hi,
      kt * SLOT, p.K, ct * SLOT, p.C, out, SLOT, SLOT, SLOT, p.scale,
      p.b_vec);
}

// ---------------------------------------------------------------------------
// spectral_apply: the 64-row wgmma row kernel
// ---------------------------------------------------------------------------

constexpr int AW = 2;              // warpgroups a CTA, each on its own tile
constexpr int AT = 64;             // rows of a warpgroup's tile
constexpr int ANT = AW * wg::NTH;  // threads a CTA
constexpr int SP = 128;            // rows of K of s resident at once
constexpr int SCH = SP / KCH;      // their 32-value chunks
constexpr int SSTAGE = wg::b_stage_bytes<false>();  // a chunk of s: hi, lo
// Row stride of a warpgroup's output tile, in floats: 8 mod 32, so the
// 8-byte accumulator pairs a half warp stores (rows g, columns 8 j + 2 c)
// fall in distinct banks; rows stay 16-byte aligned for the row reads.
constexpr int LDE = NB + 8;
constexpr int APPLY_SMEM = SCH * SSTAGE + AW * AT * LDE * 4;  // 200,704

struct ApplyArgs {
  const float* xhat;   // (B,K,C)
  const float* coefs;  // (B,K,C)
  const void* op[3];   // Phi, GX, GY: (B,V,K), one dtype
  void* out[3];        // y, ygx, ygy: (B,V,C), f32 or bf16
  int n_items;         // B * nct * npair
  int V, K, C, nct, npair, nkc, slice;
  int ops_vec, out_bf16, out_vec;
};

// s = coefs (.) x_hat, rows k0.. and columns c0.. of one batch element, as
// the B operand of SCH chunks: chunk i holds rows k0 + 32 i.. as a K-major
// tile of 128 rows (the columns n of s) x 32 values, TF32 hi then lo.
// Physical row pp = 8 q + 2 st + r of a chunk is value j = 8 st + q + 4 r of
// the contraction (wg::RowF's order: a thread's two 16-byte loads are its
// fragments), so it lands in k group u = j / 4 = 2 st + r, place q of the
// 16-byte unit ((n / 8) 8 + u) 8 + n % 8. Zero past K and C.
__device__ __forceinline__ void stage_s(char* sS, const float* xh,
                                        const float* cf, int K, int C,
                                        int k0, int c0) {
#pragma unroll 1
  for (int i = threadIdx.x; i < SP * NB; i += ANT) {
    const int n = i % NB, kk = i / NB;
    const int k = k0 + kk, c = c0 + n;
    float v = 0.f;
    if (k < K && c < C) {
      const long long e = (long long)k * C + c;
      v = __ldg(cf + e) * __ldg(xh + e);
    }
    const float h = wg::tf32r(v), l = wg::tf32r(v - h);
    const int pp = kk % KCH, q = pp / 8, u = 2 * ((pp % 8) / 2) + pp % 2;
    const int unit = ((n / 8) * (KCH / 4) + u) * 8 + n % 8;
    float* st = reinterpret_cast<float*>(sS + (kk / KCH) * SSTAGE);
    st[4 * unit + q] = h;
    st[NB * KCH + 4 * unit + q] = l;
  }
}

// The warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wgi), "n"(wg::NTH) : "memory");
}

// Where a chunk of the CTA's work lies: item (b, ct, pair), product o (Phi,
// GX, GY) and its 32-value chunk kc of K; next() steps through the CTA's
// range in order.
struct Cursor {
  int item, o, kc, b, ct, pair;
  __device__ __forceinline__ void set(const ApplyArgs& p, int it) {
    item = it;
    o = kc = 0;
    pair = it % p.npair;
    ct = (it / p.npair) % p.nct;
    b = it / (p.npair * p.nct);
  }
  __device__ __forceinline__ void next(const ApplyArgs& p) {
    if (++kc < p.nkc) return;
    kc = 0;
    if (++o < 3) return;
    set(p, item + 1);
  }
};

// Grid: one CTA per SM (or fewer, one per item). CTA c takes the items
// [c n / G, (c + 1) n / G) in order; warpgroup w takes the rows
// 128 pair + 64 w.. of each.
template <bool OPS_BF16>
__global__ void __launch_bounds__(ANT, 1)
    spectral_apply_kernel(const ApplyArgs p) {
  extern __shared__ __align__(128) char smem[];
  char* sS = smem;
  const int wgi = threadIdx.x / wg::NTH;
  float* E = reinterpret_cast<float*>(smem + SCH * SSTAGE) + wgi * AT * LDE;
  const int t = threadIdx.x % wg::NTH, warp = t / 32, lane = t % 32;
  const int i0 = (int)((long long)p.n_items * blockIdx.x / gridDim.x);
  const int i1 = (int)((long long)p.n_items * (blockIdx.x + 1) / gridDim.x);
  const long long total = (long long)(i1 - i0) * 3 * p.nkc;
  const int V = p.V, K = p.K, C = p.C;
  const int nkp = (K + SP - 1) / SP;

  auto row0_of = [&](const Cursor& c) { return c.pair * AW * AT + wgi * AT; };
  auto op_of = [&](int o) {
    return o == 0 ? p.op[0] : (o == 1 ? p.op[1] : p.op[2]);
  };
  // the next chunk's operator rows into a (nothing past the range)
  Cursor ahead;
  ahead.set(p, i0);
  long long n_loaded = 0;
  auto load = [&](wg::RowF& a) {
    if (n_loaded++ >= total) return;
    const int row0 = row0_of(ahead);
    a.load(op_of(ahead.o), K, (long long)ahead.b * V + row0, V - row0,
           ahead.kc * KCH, K, p.ops_vec, OPS_BF16);
    ahead.next(p);
  };

  // The output tile in E that the warpgroup is storing: rows e_done.. are
  // still to go, a slice of them per chunk of the next product.
  void* e_out = nullptr;
  long long e_row = 0;
  int e_nv = 0, e_c0 = 0, e_done = AT;
  auto store_rows = [&](int upto) {
#pragma unroll 1
    for (int r = e_done + warp; r < upto && r < e_nv; r += 4) {
      const int c = e_c0 + 4 * lane;
      if (c >= C) continue;
      const float4 v =
          *reinterpret_cast<const float4*>(E + r * LDE + 4 * lane);
      const long long o = (e_row + r) * C + c;
      if (p.out_vec) {  // c + 3 < C: C % 4 == 0
        if (p.out_bf16) {
          uint2 w;
          w.x = wg::pack_bf16(v.x, v.y);
          w.y = wg::pack_bf16(v.z, v.w);
          *reinterpret_cast<uint2*>(reinterpret_cast<unsigned short*>(e_out) +
                                    o) = w;
        } else {
          *reinterpret_cast<float4*>(reinterpret_cast<float*>(e_out) + o) = v;
        }
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j >= C) break;
          if (p.out_bf16)
            reinterpret_cast<__nv_bfloat16*>(e_out)[o + j] =
                __float2bfloat16_rn(vs[j]);
          else
            reinterpret_cast<float*>(e_out)[o + j] = vs[j];
        }
      }
    }
    e_done = upto;
  };

  float d[64];
  long long staged = -1;  // the (b, ct, piece of K) of s in shared memory
  Cursor cur;
  cur.set(p, i0);
  // One chunk: its A fragments from a (then a takes the chunk two ahead),
  // its products on the tensor cores while a slice of the last product's
  // rows is stored, and the product's output to E after its last chunk.
  auto chunk = [&](wg::RowF& a) {
    const int kp = cur.kc / SCH;
    if (cur.kc % SCH == 0) {
      const long long key = ((long long)cur.b * p.nct + cur.ct) * nkp + kp;
      if (key != staged) {  // the same decision in every thread of the CTA
        __syncthreads();    // every warpgroup's products on the old s are done
        const long long off = (long long)cur.b * K * C;
        stage_s(sS, p.xhat + off, p.coefs + off, K, C, kp * SP,
                cur.ct * NB);
        wg::fence_smem_for_wgmma();
        __syncthreads();
        staged = key;
      }
    }
    wg::AFrags<false> f;
    f.build(a);
    load(a);
    if (cur.kc == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
    }
    wg::fence_operands();
    wg::pin(d);
    wg::mma_chunk_rs<false, OPS_BF16>(d, f, sS + (cur.kc % SCH) * SSTAGE);
    wg::commit();
    if (e_done < AT) store_rows(min(AT, e_done + p.slice));
    wg::wait_all();
    wg::pin(d);
    if (cur.kc == p.nkc - 1) {  // the product is done: its output to E
      if (e_done < AT) store_rows(AT);
      wg_sync(wgi);  // every thread's reads of E are done
      wg::for_pairs(d, [&](int m, int n, float v0, float v1) {
        *reinterpret_cast<float2*>(E + m * LDE + n) = make_float2(v0, v1);
      });
      wg_sync(wgi);
      const int row0 = row0_of(cur);
      e_out = cur.o == 0 ? p.out[0] : (cur.o == 1 ? p.out[1] : p.out[2]);
      e_row = (long long)cur.b * V + row0;
      e_nv = V - row0;
      e_c0 = cur.ct * NB;
      e_done = 0;
    }
    cur.next(p);
  };

  // two operator chunks in flight while one is multiplied: the loop runs
  // two chunks a pass so that each buffer is a fixed set of registers
  wg::RowF a0, a1;
  load(a0);
  load(a1);
#pragma unroll 1
  for (long long q = 0; q < total; q += 2) {
    chunk(a0);
    if (q + 1 < total) chunk(a1);
  }
  if (e_done < AT) store_rows(AT);
}

template <class T>
int launch(void* kernel, unsigned grid, int threads, int smem, const T& args,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* a[] = {const_cast<T*>(&args)};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(threads), a, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

template <bool LOWP, bool A_BF16>
void* project_kernel(int b_bf16) {
  return b_bf16 ? (void*)spectral_project_kernel<LOWP, A_BF16, true>
                : (void*)spectral_project_kernel<LOWP, A_BF16, false>;
}

}  // namespace

extern "C" {

// The split-V products on `stream`: part (B, nkt, nct, S, SLOT, SLOT) f32
// with nkt = ceil(K / SLOT), nct = ceil(C / SLOT); slot (b, kt, ct, s) =
// sum over the nterms (1 to 3) pairs of a_t^T (scale (.) b_t) over the rows
// [s L, (s + 1) L) of batch element b's V. a_t (B,V,K), one dtype; b_t
// (B,V,C), one dtype; scale (B,V) f32 or null. lowp: both operands rounded
// to bf16.
int sf_project_launch(const void* a0, const void* a1, const void* a2,
                      const void* b0, const void* b1, const void* b2,
                      int nterms, const void* scale, void* part, int B, int V,
                      int K, int C, int S, int L, int a_bf16, int b_bf16,
                      int lowp, void* stream) {
  if (B < 1 || V < 1 || K < 1 || C < 1 || S < 1 || L < 1 ||
      (long long)S * L < V || nterms < 1 || nterms > 3)
    return MB_BAD_SHAPE;
  ProjectArgs p = {};
  const void* as[3] = {a0, a1, a2};
  const void* bs[3] = {b0, b1, b2};
  p.a_vec = K % (a_bf16 ? 8 : 4) == 0;
  p.b_vec = C % (b_bf16 ? 8 : 4) == 0;
  for (int t = 0; t < 3; ++t) {
    p.A[t] = t < nterms ? as[t] : as[0];
    p.Bm[t] = t < nterms ? bs[t] : bs[0];
    p.a_vec = p.a_vec && aligned16(p.A[t]);
    p.b_vec = p.b_vec && aligned16(p.Bm[t]);
  }
  p.scale = static_cast<const float*>(scale);
  p.part = static_cast<float*>(part);
  p.nterms = nterms;
  p.V = V; p.K = K; p.C = C; p.S = S; p.L = L;
  p.nkt = (K + SLOT - 1) / SLOT;
  p.nct = (C + SLOT - 1) / SLOT;
  const long long ctas = (long long)B * p.nkt * p.nct * S;
  if (ctas > 0x7fffffffLL) return MB_BAD_SHAPE;
  void* kernel =
      lowp ? (a_bf16 ? project_kernel<true, true>(b_bf16)
                     : project_kernel<true, false>(b_bf16))
           : (a_bf16 ? project_kernel<false, true>(b_bf16)
                     : project_kernel<false, false>(b_bf16));
  const int smem = lowp ? sv::grads_smem<true>() : sv::grads_smem<false>();
  return launch(kernel, (unsigned)ctas, sv::GNT, smem, p, stream);
}

// xhat, coefs: (B,K,C) f32; evecs/gx/gy: (B,V,K), one dtype; y/ygx/ygy:
// (B,V,C) in the dtype out_bf16 names; n_sm: the card's SMs (the grid).
int sf_apply_launch(const void* xhat, const void* coefs, const void* evecs,
                    const void* gx, const void* gy, void* y, void* ygx,
                    void* ygy, int B, int V, int K, int C, int ops_bf16,
                    int out_bf16, int n_sm, void* stream) {
  if (B < 1 || B > 65535 || V < 1 || K < 1 || C < 1 || n_sm < 1)
    return MB_BAD_SHAPE;
  ApplyArgs p = {};
  p.xhat = static_cast<const float*>(xhat);
  p.coefs = static_cast<const float*>(coefs);
  p.op[0] = evecs; p.op[1] = gx; p.op[2] = gy;
  p.out[0] = y; p.out[1] = ygx; p.out[2] = ygy;
  p.V = V; p.K = K; p.C = C;
  p.nct = (C + NB - 1) / NB;
  p.npair = (V + AW * AT - 1) / (AW * AT);
  const long long items = (long long)B * p.nct * p.npair;
  if (items > 0x7fffffffLL) return MB_BAD_SHAPE;
  p.n_items = (int)items;
  p.nkc = (K + KCH - 1) / KCH;
  p.slice = (AT + p.nkc - 1) / p.nkc;
  p.ops_vec = aligned16(evecs) && aligned16(gx) && aligned16(gy) &&
              K % 8 == 0;
  p.out_bf16 = out_bf16;
  p.out_vec = C % 4 == 0 && aligned16(y) && aligned16(ygx) && aligned16(ygy);
  if (APPLY_SMEM > max_smem()) return MB_SMEM;
  const unsigned grid = (unsigned)(items < n_sm ? items : n_sm);
  void* kernel = ops_bf16 ? (void*)spectral_apply_kernel<true>
                          : (void*)spectral_apply_kernel<false>;
  return launch(kernel, grid, ANT, APPLY_SMEM, p, stream);
}

}  // extern "C"
