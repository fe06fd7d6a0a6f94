// Whole-DiffusionNet-block forward for Hopper (sm_90a), chained form: a
// 64-row wgmma row kernel, a split-V kernel for the next block's x_hat, and
// a fixed-order partial sum.
//
// Replaces the TPU kernel `_make_fwd_kernel_chained`
// (diffusionnet_tpu/ops/pallas_megablock.py:259, launched at :366). Given this
// block's x_hat (B,K,C) it computes, per batch element b and row v:
//
//   s     = coefs (.) x_hat
//   xd    = Phi s;   gx = GX s;   gy = GY s
//   vb_re = gx A_re - gy A_im;   vb_im = gy A_re + gx A_im
//   feat  = tanh(gx (.) vb_re + gy (.) vb_im)
//   out   = MLP([x, xd, feat]) + x   (Dense, [Dropout]-ReLU-Dense, ...)
//
// and, with emit_next, the next block's x_hat = Phi^T (m (.) out). The TPU
// kernel does both per tile and carries the x_hat sum across its sequential
// grid in VMEM. Here they are split:
//
//  * megablock_fwd_rows_kernel: one CTA per W (1 or 2) 64-row tiles of one
//    batch element, one warpgroup (128 threads) a tile; 1,280 CTAs at
//    B = 8, V = 20480, K = C = 128. Every product runs on wgmma m64n128
//    (wgmma.cuh): A from registers, read by each thread straight into its
//    fragments (wg::RowF), B from a ring of NS shared-memory stages filled
//    by cp.async, NS - 1 chunks of 32 ahead of the products and shared by
//    the W warpgroups, which run the same products in step. B is s per
//    batch element, the complex map and the MLP's W_l, tiled once per call
//    by the wrapper in the order of a thread's A fragments
//    (ops/megablock.py::b_tiles: wgmma's tf32 takes K-major operands only).
//    A of the spectral products is the operator rows, read once from device
//    memory; A of the complex map and the MLP is the tile's activations
//    ([gx | gy], then [x | xd | feat], then the hidden layers; x itself is
//    read from device memory), in shared memory where they fit, so that
//    at the models' usual widths no product's output makes a round trip
//    through device memory (the layouts are below). The epilogues work on
//    the accumulators in registers: gx, gy, xd and the hidden layers go to
//    shared memory; the complex map's B columns are interleaved (re_c,
//    im_c), so a thread's accumulator pair is (vb_re, vb_im) of one column
//    and feat is computed where it lands; the last layer writes `out` (and,
//    for a bf16 x with emit_next, y = m (.) out in f32, the x_hat kernel's
//    operand).
//  * megablock_fwd_xhat_kernel: x_hat_next = Phi^T (m (.) out) as TN
//    products over V on a split-V grid (splitv.cuh, shared with B2's grads
//    kernel): each CTA owns one 128 x 128 piece of (K, C) of one batch
//    element and one fixed range of rows and writes one partial slot, once;
//    m scales out's rows in f32 before the split (or the rounding). Then
//    `xhat_reduce_kernel` sums the slots in a fixed order.
//
// No slot is read, modified and written per tile, and nothing is summed with
// floating-point atomics: two launches give the same bits.
//
// Shared memory of the row kernel: the B ring (NS stages of 32 KB in f32,
// hi and lo, or 8 KB under lowp) and, per warpgroup, up to three activation
// buffers of 64 rows (a row stride of 4 mod 32 floats keeps a
// quarter-warp's fragment loads in distinct banks). The tile's activations
// sit in three slots, gx then xd, gy, and feat, and its hidden layers, by
// turns, over the slots of gy and gx. A slot whose buffer does not fit goes
// to a device-memory scratch of (B V, C) f32, and the hidden layers to two
// scratches of (B V, widest hidden) f32: each is written once per tile and
// read back once, from L2, as the next product's A operand, which the
// kernel reads from device memory the way it reads the operator rows.
// The wrapper chooses the layout from these byte counts, before launch
// (ops/megablock.py::fwd_route): the hidden layers in shared buffers
// (round32(max(C, hidden widths)) + 4 floats wide) before the scratch,
// two warpgroups before one, and more slots in shared memory before fewer.
// At K = C = 128, hidden [128, 128]: two warpgroups with feat spilled in
// f32 (2 x 66 KB + 64 KB, NS = 2), all three buffers under lowp (2 x 99 KB
// + 16 KB); at C = 256, hidden [256, 256]: one warpgroup with feat spilled
// in f32 (130 KB + 96 KB, NS = 3), all three under lowp; at C = 256,
// hidden [1024, 1024]: two warpgroups with the hidden layers, gy and feat
// spilled (2 x 65 KB + 64 KB in f32, 2 x 65 KB + 16 KB under lowp). One
// CTA per SM. At C = 256 with hidden [1024, 1024], B = 1, V = 32768 the
// scratch traffic is about 0.6 GB (the hidden layers' 512 MB), against
// 160 GFLOP of products.
//
// A channel count C that is not a multiple of 8 the wrapper pads with zero
// channels (ops/megablock.py::pad_block): every padded channel computes
// exactly 0, and dropout, which acts on the hidden layers only (any width),
// keeps the model's masks.
//
// What bounds it on this card. At K = C = 128 with hidden [128, 128] a
// vertex costs 212,992 multiply-adds (Phi/GX/GY products 3KC, the complex
// map 4C^2, the MLP 5C^2, the x_hat product KC), 426 kflop, against ~2.6 KB
// of device memory traffic in f32 (operator rows, x, out) or ~1.3 KB with
// bf16 operands: arithmetic bounds it. f32 products take three TF32 passes
// (a_lo b_hi + a_hi b_lo + a_hi b_hi; hi = tf32(v), lo = tf32(v - hi)), the
// f32 tolerances need them; lowp rounds both operands to bf16 and takes one
// pass. The row kernel waits on each chunk's products before the next
// chunk's (its A fragments are registers that the next chunk rebuilds), so
// a chunk's fixed latency (barrier, fragment build, the products' own
// latency) is paid once per chunk; two warpgroups a CTA halve it per tile.
// Three things that cost more than the products did, found with cycle
// counters in the kernel (NVIDIA H100 80GB HBM3, 700 W): a copy of the
// product loop per product (the code several times larger, the kernel
// slower; so the products run through one loop, below); epilogues that
// read device memory between their stores (so the MLP's products start from
// the bias, and the last from bias + x, read while the first stage lands);
// and the dropout test inside the per-element loop, which let the compiler
// compute every mask's hash and select (so it is tested once per pass).
//
// bf16 ("lowp"): as in the TPU kernel's `_dot`, both operands of every
// product are rounded to bf16 (round to nearest even) and accumulated in
// f32: s, Phi/GX/GY, gx and gy before the complex map, the MLP activations,
// the weights, and m (.) out for the x_hat sum. Operands are rounded where
// they enter a product (the activations stay f32 in shared memory), so
// elementwise work (tanh, bias, ReLU, residual) sees f32; `out` is stored in
// x's dtype while x_hat_next accumulates from the f32 `out`.
//
// Dropout (training): the mask of a hidden activation comes from the JAX
// kernel's interpret-mode hash over (seed, batch, tile of tile_v rows,
// layer) (`Dropout` in megablock_common.cuh), so it is bit-identical to
// `interpret_dropout_mask` and to the plain version's; it is applied to the
// f32 activation before it is rounded for the next product, as `_mlp_fwd`
// does.
//
// Contraction layout. The complex map contracts over [gx | gy] and the
// first MLP layer over [x | xd | feat]; each C-wide segment is padded to a
// multiple of 32 (c32), so a 32-value chunk lies in one segment, and the
// wrapper tiles cmap's and W_0's rows to match (zero rows in the gaps).
//
// Padding: rows at or past V are masked (loads give 0, stores are skipped),
// and every x_hat partial gets exactly 0 from them. Padded rows inside V
// carry mass 0 and zero operator rows.

#include <type_traits>

#include "megablock_common.cuh"
#include "splitv.cuh"
#include "wgmma.cuh"

namespace {

using namespace mb;
using wg::KCH;
using wg::NB;

constexpr int RT = 64;    // rows of a warpgroup's tile in the row kernel
constexpr int RNT = 128;  // threads of a warpgroup

// The row kernel's ring of B stages with W warpgroups a CTA: 3 for one (the
// next two chunks' B in flight), 2 for two, whose shared memory holds two
// tiles' buffers (and whose chunks carry twice the products).
template <int W>
__host__ __device__ constexpr int stages() {
  return W == 1 ? 3 : 2;
}

struct FwdArgs {
  const void* x;       // (B,V,C) f32 or bf16
  const void* ops[3];  // Phi, GX, GY: (B,V,K), one dtype
  const float* mass;   // (B,V)
  // the B operands' tiles (ops/megablock.py::b_tiles), in the product type
  const void* sT;      // per batch element: s^T
  const void* cmapF;   // cmap^T, rows interleaved re, im; contraction c32-padded
  const void* wf[MAX_DENSE];  // W_l^T; W_0's contraction c32-padded
  const float* bias[MAX_DENSE];
  int width[MAX_DENSE + 1];
  int n_dense;
  void* out;        // (B,V,C) in x's dtype
  float* spill[3];  // gx then xd, gy, feat: (B V, C) f32 scratch, or null:
                    // in a shared buffer
  float* hid[2];    // the hidden layers by turns: (B V, ldh) f32 scratch,
                    // or null: in the shared buffers of gy and gx
  long long ldh;
  float* y;  // (B V, C) f32 m (.) out, or null
  int V, K, C, c32;
  int ldb;   // row stride of the shared activation buffers, floats
  int nres;  // shared activation buffers per warpgroup: the slots of
             // spill that are null
  int x_bf16, ops_bf16, x_vec, ops_vec;
  Dropout drop;
};

// One product of the row kernel: for each 128-column pass n0 of N,
// epi(n0, d) with d the thread's accumulators of the block A (64 x 32 nk)
// B[.., n0..n0+127]. loada(a, kc) loads the A rows' chunk kc into a. Bt: B's
// tiles as ops/megablock.py::b_tiles lays them out, one stage of
// wg::b_stage_bytes per (pass, 32-value chunk), copied by cp.async into the
// ring, NS - 1 chunks ahead of the products. init(n0, d) sets the
// accumulators' first value, its loads in flight while the first stage
// lands. A pass begins at a barrier, so what the last epilogue wrote is
// visible and the last products' reads of the ring are done.
template <bool LOWP, int W, class LOADA, class INIT, class EPI>
__device__ __forceinline__ void fwd_product(char* ring, int nk,
                                            const void* Bt, int N,
                                            LOADA loada, INIT init, EPI epi) {
  constexpr int SB = wg::b_stage_bytes<LOWP>(), NS = stages<W>();
  const int tid = threadIdx.x;
  wg::RowF a;
  wg::AFrags<LOWP> f;
  for (int n0 = 0; n0 < N; n0 += NB) {
    const char* stages =
        reinterpret_cast<const char*>(Bt) + (size_t)(n0 / NB) * nk * SB;
    auto issue = [&](int kc) {  // one commit group per chunk, empty past nk
      if (kc < nk) {
        const char* src = stages + (size_t)kc * SB;
        char* dst = ring + (kc % NS) * SB;
#pragma unroll 4
        for (int i = tid; i < SB / 16; i += W * RNT)
          wg::cp_async16(dst + 16 * i, src + 16 * i);
      }
      wg::cp_async_commit();
    };
    float d[64];
    __syncthreads();
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) issue(st);
    loada(a, 0);
    init(n0, d);
    for (int kc = 0; kc < nk; ++kc) {
      wg::cp_async_wait<NS - 2>();  // this chunk's stage has landed
      wg::fence_smem_for_wgmma();
      __syncthreads();  // ... for every thread; and the stage that chunk
                        // kc + NS - 1 reuses was read by chunk kc - 1,
                        // whose products every warp has waited for
      issue(kc + NS - 1);
      f.build(a);
      if (kc + 1 < nk) loada(a, kc + 1);
      wg::fence_operands();
      wg::pin(d);
      wg::mma_chunk_rs<LOWP>(d, f, ring + (kc % NS) * SB);
      wg::commit();
      wg::wait_all();
      wg::pin(d);
    }
    epi(n0, d);
  }
}

// W warpgroups a CTA, each on its own 64-row tile of one batch element:
// they share the B stages and run the same products in step.
template <bool LOWP, int W>
__global__ void __launch_bounds__(W * RNT, 1)
    megablock_fwd_rows_kernel(const FwdArgs p) {
  extern __shared__ __align__(128) char smem[];
  constexpr int SB = wg::b_stage_bytes<LOWP>(), NS = stages<W>();
  const int C = p.C, K = p.K, V = p.V, n = p.n_dense, ldb = p.ldb;
  const int b = blockIdx.y, wgi = threadIdx.x / RNT;
  const int row0 = (blockIdx.x * W + wgi) * RT;
  const int nv = min(RT, V - row0);                // rows inside V (<= 0:
                                                   // a tile past V)
  const long long vr0 = (long long)b * V + row0;   // the tile's first row
  char* ring = smem;
  // The activation slots: 0 holds gx, then xd; 1 gy; 2 feat. Each is a
  // 64-row shared buffer (row stride ldb) or the tile's rows of a device
  // scratch (row stride C; only the rows inside V are read or written).
  float* const res = reinterpret_cast<float*>(smem + NS * SB) +
                     wgi * p.nres * RT * ldb;
  float* act[3];
  long long lda[3];
  int rows[3];
#pragma unroll
  for (int i = 0, r = 0; i < 3; ++i) {
    const bool dev = p.spill[i] != nullptr;
    act[i] = dev ? p.spill[i] + vr0 * C : res + (r++) * RT * ldb;
    lda[i] = dev ? C : ldb;
    rows[i] = dev ? nv : RT;
  }
  const int nseg = p.c32 / KCH;  // chunks of one C-wide segment
  const int nk_s = (K + KCH - 1) / KCH;
  const char* sT = reinterpret_cast<const char*>(p.sT) +
                   (size_t)b * ((C + NB - 1) / NB) * nk_s * SB;

  // The block is a sequence of products, run through one product loop:
  // step 0 gx = GX s, 1 gy = GY s, 2 the complex map and feat, 3 xd = Phi s,
  // 4 + l the MLP's layer l. Each step sets its A source (up to three
  // segments of `seg` chunks: the operator rows in device memory, or the
  // tile's activations in shared memory), its B tiles and its epilogue; the
  // loop and each epilogue exist once in the kernel's code (inlined per
  // step, the code was several times larger and the kernel slower).
  struct Seg {
    const void* ptr;
    long long ld, row0;
    int rows, vec, bf16;
  };
  enum { TO_BUF, FEAT, HIDDEN, OUT };
  // layer l's output: hb[l % 2], in the device scratch, or over gy and gx
  const bool hdev = p.hid[0] != nullptr;
  float* const hb[2] = {hdev ? p.hid[0] + vr0 * p.ldh : act[1],
                        hdev && p.hid[1] != nullptr ? p.hid[1] + vr0 * p.ldh
                                                    : act[0]};
  const long long ldh = hdev ? p.ldh : ldb;
  const int hrows = hdev ? nv : RT;
  Seg s0{}, s1{}, s2{};
  int seg = 1, kvalid = 0, nk = 0, N = 0, kind = TO_BUF, l = 0;
  const void* Bt = nullptr;
  float* dst = act[0];  // where TO_BUF and HIDDEN write: row stride ldd,
  long long ldd = ldb;  // rows below drows
  int drows = RT;
  const float* bias = nullptr;
  auto act_seg = [&](int i) { return Seg{act[i], lda[i], 0, rows[i], 1, 0}; };
  const int frows = min(rows[0], min(rows[1], rows[2]));

  auto load = [&](wg::RowF& a, int kc) {
    const int g = min(kc / seg, 2);
    auto sel = [&](auto v0, auto v1, auto v2) {
      return g == 0 ? v0 : (g == 1 ? v1 : v2);
    };
    a.load(sel(s0.ptr, s1.ptr, s2.ptr), sel(s0.ld, s1.ld, s2.ld),
           sel(s0.row0, s1.row0, s2.row0), sel(s0.rows, s1.rows, s2.rows),
           (kc - g * seg) * KCH, kvalid, sel(s0.vec, s1.vec, s2.vec),
           sel(s0.bf16, s1.bf16, s2.bf16));
  };
  // A thread's accumulators hold rows mt and mt + 8 at columns 8 j + ct,
  // + 1 of each 8-column block j (wg::for_pairs). The MLP's products start
  // from the bias (and the last one from the bias and the residual x), read
  // at the start of the pass, so that their epilogues only store: an
  // epilogue runs while the tensor cores wait, and one that reads device
  // memory waits out those loads' latency with little else to hide it.
  const int lane = threadIdx.x % 32;
  const int mt = 16 * ((threadIdx.x % RNT) / 32) + lane / 4;
  const int ct = 2 * (lane % 4);
  auto init = [&](int n0, float(&d)[64]) {
    if (kind != HIDDEN && kind != OUT) {
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      return;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + ct;
      const float b0 = c < N ? __ldg(bias + c) : 0.f;
      const float b1 = c + 1 < N ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 xv = make_float2(0.f, 0.f);
        const int m = mt + 8 * h;
        if (kind == OUT && c < C && m < nv) {
          const long long o = (vr0 + m) * C + c;
          if (p.x_bf16) {
            const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(
                reinterpret_cast<const unsigned short*>(p.x) + o));
            xv = make_float2(wg::bf16_bits_to_float(u & 0xFFFFu),
                             wg::bf16_bits_to_float(u >> 16));
          } else {
            xv = __ldg(reinterpret_cast<const float2*>(
                reinterpret_cast<const float*>(p.x) + o));
          }
        }
        d[4 * j + 2 * h] = b0 + xv.x;
        d[4 * j + 2 * h + 1] = b1 + xv.y;
      }
    }
  };
  auto epi = [&](int n0, float(&d)[64]) {
    if (kind == TO_BUF) {  // gx, gy, xd into their slot
      wg::for_pairs(d, [&](int m, int nn, float v0, float v1) {
        const int c = n0 + nn;
        if (c < N && m < drows)
          *reinterpret_cast<float2*>(dst + m * ldd + c) = make_float2(v0, v1);
      });
    } else if (kind == FEAT) {  // B's columns interleaved: the pair
                                // (2c, 2c + 1) of a block is (vb_re, vb_im)
                                // of column c
      wg::for_pairs(d, [&](int m, int nn, float vr, float vi) {
        const int c = (n0 + nn) / 2;
        if (c < C && m < frows)
          act[2][m * lda[2] + c] = tanhf(act[0][m * lda[0] + c] * vr +
                                         act[1][m * lda[1] + c] * vi);
      });
    } else if (kind == HIDDEN) {  // ReLU, dropout (tested once: the
                                  // compiler would compute every mask's
                                  // hash, and select)
      auto hidden = [&](auto drop) {
        wg::for_pairs(d, [&](int m, int nn, float v0, float v1) {
          const int c = n0 + nn;
          if (c >= N || m >= drows) return;
          v0 = fmaxf(v0, 0.f);
          v1 = c + 1 < N ? fmaxf(v1, 0.f) : 0.f;
          if (decltype(drop)::value) {
            const int r = row0 + m;
            v0 = p.drop.apply(v0, b, r, c, N, l);
            v1 = c + 1 < N ? p.drop.apply(v1, b, r, c + 1, N, l) : 0.f;
          }
          *reinterpret_cast<float2*>(dst + m * ldd + c) = make_float2(v0, v1);
        });
      };
      if (p.drop.on)
        hidden(std::true_type());
      else
        hidden(std::false_type());
    } else {  // OUT: out (and y = m out)
      const float mass2[2] = {
          p.y != nullptr && mt < nv ? __ldg(p.mass + vr0 + mt) : 0.f,
          p.y != nullptr && mt + 8 < nv ? __ldg(p.mass + vr0 + mt + 8) : 0.f};
      wg::for_pairs(d, [&](int m, int nn, float v0, float v1) {
        const int c = n0 + nn;
        if (c >= C || m >= nv) return;
        const long long o = (vr0 + m) * C + c;
        if (p.x_bf16)
          *reinterpret_cast<uint32_t*>(
              reinterpret_cast<unsigned short*>(p.out) + o) =
              wg::pack_bf16(v0, v1);
        else
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + o) =
              make_float2(v0, v1);
        if (p.y != nullptr) {
          const float mm = m == mt ? mass2[0] : mass2[1];
          *reinterpret_cast<float2*>(p.y + o) = make_float2(mm * v0, mm * v1);
        }
      });
    }
  };

#pragma unroll 1
  for (int st = 0; st < 4 + n; ++st) {
    if (st != 2 && st < 4) {  // the spectral products, A the operator rows
      const int q = st == 0 ? 1 : (st == 1 ? 2 : 0);
      s0 = Seg{q == 0 ? p.ops[0] : (q == 1 ? p.ops[1] : p.ops[2]), K, vr0,
               nv, p.ops_vec, p.ops_bf16};
      seg = nk = nk_s;
      kvalid = K;
      Bt = sT;
      N = C;
      kind = TO_BUF;
      const bool gy = st == 1;  // xd over gx: the complex map is done
      dst = gy ? act[1] : act[0];
      ldd = gy ? lda[1] : lda[0];
      drows = gy ? rows[1] : rows[0];
    } else if (st == 2) {  // [vb_re | vb_im] = [gx | gy] cmap; feat
      s0 = act_seg(0);
      s1 = act_seg(1);
      seg = nseg;
      nk = 2 * nseg;
      kvalid = C;
      Bt = p.cmapF;
      N = 2 * C;
      kind = FEAT;
    } else {  // MLP layer l: [x | xd | feat], then the last layer's output
      l = st - 4;
      if (l == 0) {
        s0 = Seg{p.x, C, vr0, nv, p.x_vec, p.x_bf16};
        s1 = act_seg(0);
        s2 = act_seg(2);
        seg = nseg;
        nk = 3 * nseg;
        kvalid = C;
      } else {
        s0 = Seg{hb[(l - 1) % 2], ldh, 0, hrows, 1, 0};
        kvalid = p.width[l];
        seg = nk = (kvalid + KCH - 1) / KCH;
      }
      Bt = p.wf[l];
      N = p.width[l + 1];
      bias = p.bias[l];
      kind = l + 1 < n ? HIDDEN : OUT;
      dst = hb[l % 2];
      ldd = ldh;
      drows = hrows;
    }
    fwd_product<LOWP, W>(ring, nk, Bt, N, load, init, epi);
  }
}

struct XhatArgs {
  const void* evecs;   // (B,V,K)
  const float* src;    // (B,V,C) f32: out (scale = mass) or m (.) out
  const float* scale;  // (B,V) or null
  float* part;         // (B, nkt, nct, S, SLOT, SLOT)
  int V, K, C, S, L, nkt, nct, ops_vec;
};

// x_hat_next partials: CTA (b, kt, ct, split) writes slot
// part[b][kt][ct][split] = sum over rows [split L, (split + 1) L) of V of
// Phi_b[v, 128 kt..]^T (scale (.) src)_b[v, 128 ct..] (the (K, C) corner of
// the piece; the rest of the slot is not written).
template <bool LOWP, bool OPS_BF16>
__global__ void __launch_bounds__(sv::GNT, 1)
    megablock_fwd_xhat_kernel(const XhatArgs p) {
  extern __shared__ __align__(128) char smem[];
  int id = blockIdx.x;
  const int split = id % p.S;
  id /= p.S;
  const int ct = id % p.nct;
  id /= p.nct;
  const int kt = id % p.nkt, b = id / p.nkt;
  const long long r_lo = (long long)split * p.L;
  const long long r_hi = min(r_lo + p.L, (long long)p.V);
  const void* A[1] = {p.evecs};
  const void* Bm[1] = {p.src};
  float* out = p.part + ((((long long)b * p.nkt + kt) * p.nct + ct) * p.S +
                         split) * SLOT * SLOT;
  sv::grads_block<LOWP, OPS_BF16, false, true>(
      smem, A, p.K, p.ops_vec, Bm, p.C, 1, (long long)b * p.V, r_lo, r_hi,
      kt * SLOT, p.K, ct * SLOT, p.C, out, SLOT, min(SLOT, p.K - kt * SLOT),
      min(SLOT, p.C - ct * SLOT), p.scale);
}

// x_hat[b][k][c] = sum over s of partial[b, s, k, c], partial slots
// (SLOT, SLOT) of which the (K, C) corner is used. Replaces the TPU
// kernel's in-VMEM carry of x_hat across its sequential grid
// (pallas_megablock.py:305); torch.sum of the slots is the library yardstick.
//
// The order, fixed and the same in ops/megablock.py::xhat_reduce_reference:
// the S slots are cut into G = min(16, ceil(S / 8)) chunks of L = ceil(S / G)
// consecutive slots (the last ones may be short or empty); each chunk is
// summed from +0 in ascending s, and the chunk sums are added from +0 in
// ascending chunk order. No atomics: the result is the same bit for bit on
// every run, and equal to the plain version's.
//
// What bounds it: the S (K, C) slots, read once (8.7 MB at S = 132,
// K = C = 128, from L2 when the kernel that wrote them has just run). One
// CTA per (batch element, row k, 64 columns): 256 CTAs at B = 1, K = C =
// 128, over 132 SMs. Its threads are G chunks x 16 float4 columns, so each
// thread issues L independent 16-byte loads, a warp reading two whole
// 256-byte slot rows per load; the G chunk sums of each column meet in
// shared memory, and the threads add them in order and store 64 floats.
// G follows S: 16 chunks of one slot each (S = 16, B1's split count at
// B = 8) spent more in the second step than they saved in the first.
constexpr int XR_MAX_CHUNKS = 16;
constexpr int XR_PER_CHUNK = 8;  // slots a chunk takes before G grows
constexpr int XR_COLS = 64;      // columns per CTA

int xr_chunks(int S) {
  const int g = (S + XR_PER_CHUNK - 1) / XR_PER_CHUNK;
  return g < XR_MAX_CHUNKS ? g : XR_MAX_CHUNKS;
}

__global__ void __launch_bounds__(XR_MAX_CHUNKS * XR_COLS / 4)
    xhat_reduce_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int nsplit, int K, int C) {
  __shared__ float4 part[XR_MAX_CHUNKS][XR_COLS / 4];
  const int chunks = blockDim.x / (XR_COLS / 4);
  const int f = threadIdx.x % (XR_COLS / 4);  // float4 column in the tile
  const int g = threadIdx.x / (XR_COLS / 4);  // chunk
  const int k = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x * XR_COLS;
  const int len = (nsplit + chunks - 1) / chunks;
  const int s0 = g * len;
  const int s1 = min(nsplit, s0 + len);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 + 4 * f < C) {  // c0 + 4 f + 3 < SLOT: the slot row holds it
    const float4* src = reinterpret_cast<const float4*>(
        partial + ((size_t)b * nsplit * SLOT + k) * SLOT + c0) + f;
    constexpr size_t stride = (size_t)SLOT * SLOT / 4;
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const float4 v = __ldg(src + (size_t)s * stride);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  part[g][f] = acc;
  __syncthreads();
  for (int q = threadIdx.x; q < XR_COLS; q += blockDim.x) {
    if (c0 + q >= C) break;
    const float* pp = reinterpret_cast<const float*>(&part[0][0]) + q;
    float tot = 0.f;
    for (int h = 0; h < chunks; ++h) tot += pp[h * XR_COLS];
    out[((size_t)b * K + k) * C + c0 + q] = tot;
  }
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

int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

}  // namespace

extern "C" {

// The row kernel on `stream`. sT (per batch element), cmapF and wf[l] are
// B tiles as ops/megablock.py::b_tiles lays them out, in the product type,
// 16-byte aligned; C % 8 == 0 (the wrapper pads C). spill[i]:
// null (slot i of gx then xd, gy, feat in a shared buffer) or a (B V, C)
// f32 scratch; hid[0], hid[1]: null (the hidden layers in the buffers of
// gx and gy, which must then be shared) or (B V, ldh) f32 scratch, hid[1]
// only with two hidden layers or more; y: null or (B V, C) f32 for
// m (.) out; ldb: the shared buffers' row stride in floats (4 mod 32, at
// least round32(C) + 4, and round32(widest hidden) + 4 where they hold the
// hidden layers); wgs: warpgroups a CTA, 1 or 2. dropout 0: off; else
// masks from (seed, b, row / tile_v, layer).
int mb_fwd_launch(const void* x, const void* evecs, const void* gx,
                  const void* gy, const void* mass, const void* sT,
                  const void* cmapF, const void* const* wf,
                  const void* const* bs, const int* widths, int n_dense,
                  void* out,
                  void* const* spill, void* const* hid, long long ldh,
                  void* y, int B, int V, int K, int C, int ldb, int wgs,
                  int x_bf16, int ops_bf16, int lowp, int dropout, int seed,
                  int tile_v, void* stream) {
  if (n_dense < 1 || n_dense > MAX_DENSE || K < 1 || C < 1 || C % 8 != 0 ||
      B < 1 || B > 65535 || V < 1 || (wgs != 1 && wgs != 2))
    return MB_BAD_SHAPE;
  if (dropout && (seed < 0 || B > 2048 || tile_v < 1 ||
                  V / tile_v > 65536 || n_dense - 1 > 16))
    return MB_BAD_SHAPE;
  if (widths[0] != 3 * C || widths[n_dense] != C) return MB_BAD_SHAPE;
  int hmax = 0;  // the widest hidden layer
  for (int l = 1; l < n_dense; ++l) {
    if (widths[l] < 1) return MB_BAD_SHAPE;
    if (widths[l] > hmax) hmax = widths[l];
  }
  const bool hdev = hid[0] != nullptr;
  int nres = 0;
  for (int i = 0; i < 3; ++i) {
    if (spill[i] == nullptr) ++nres;
    else if (!aligned16(spill[i])) return MB_BAD_LAYOUT;
  }
  if (!hdev && n_dense > 1 && (spill[0] != nullptr || spill[1] != nullptr))
    return MB_BAD_LAYOUT;  // the hidden layers go over gx's and gy's buffers
  if (hdev && (ldh % 4 != 0 || ldh < hmax || !aligned16(hid[0]) ||
               (n_dense > 2 && (hid[1] == nullptr || !aligned16(hid[1])))))
    return MB_BAD_LAYOUT;
  const int buf_cols = hdev || C > hmax ? C : hmax;  // a buffer's widest
  if (nres > 0 && (ldb % 32 != 4 || ldb < round_up(buf_cols, 32) + 4))
    return MB_BAD_LAYOUT;
  if (!aligned16(sT) || !aligned16(cmapF) || !aligned16(out) ||
      (y != nullptr && !aligned16(y)))
    return MB_BAD_LAYOUT;
  FwdArgs p = {};
  p.x = x;
  p.ops[0] = evecs; p.ops[1] = gx; p.ops[2] = gy;
  p.mass = static_cast<const float*>(mass);
  p.sT = sT; p.cmapF = cmapF;
  for (int l = 0; l < n_dense; ++l) {
    if (!aligned16(wf[l])) return MB_BAD_LAYOUT;
    p.wf[l] = wf[l];
    p.bias[l] = static_cast<const float*>(bs[l]);
  }
  for (int l = 0; l <= n_dense; ++l) p.width[l] = widths[l];
  p.n_dense = n_dense;
  p.out = out;
  for (int i = 0; i < 3; ++i) p.spill[i] = static_cast<float*>(spill[i]);
  p.hid[0] = static_cast<float*>(hid[0]);
  p.hid[1] = static_cast<float*>(hid[1]);
  p.ldh = ldh;
  p.y = static_cast<float*>(y);
  p.V = V; p.K = K; p.C = C;
  p.c32 = round_up(C, KCH);
  p.ldb = ldb;
  p.nres = nres;
  p.x_bf16 = x_bf16; p.ops_bf16 = ops_bf16;
  p.x_vec = aligned16(x);  // C % 8 == 0: every row is 16-byte aligned too
  p.ops_vec = aligned16(evecs) && aligned16(gx) && aligned16(gy) &&
              K % 8 == 0;
  p.drop = {dropout, seed, tile_v};
  const int stage = lowp ? wg::b_stage_bytes<true>() : wg::b_stage_bytes<false>();
  const int ns = wgs == 2 ? stages<2>() : stages<1>();
  const long long smem =
      (long long)ns * stage + (long long)wgs * nres * RT * ldb * 4;
  if (smem > max_smem()) return MB_SMEM;
  void* kernel =
      lowp ? (wgs == 2 ? (void*)megablock_fwd_rows_kernel<true, 2>
                       : (void*)megablock_fwd_rows_kernel<true, 1>)
           : (wgs == 2 ? (void*)megablock_fwd_rows_kernel<false, 2>
                       : (void*)megablock_fwd_rows_kernel<false, 1>);
  const int tiles = (V + RT - 1) / RT;
  return launch(kernel, dim3((tiles + wgs - 1) / wgs, B), wgs * RNT,
                (int)smem, p, stream);
}

// The x_hat_next kernel on `stream`: part (B, nkt, nct, S, SLOT, SLOT) f32
// with nkt = ceil(K / SLOT), nct = ceil(C / SLOT); split s covers rows
// [s L, (s + 1) L) of each batch element's V; src (B,V,C) f32, its rows
// scaled by scale (B,V) where scale is not null.
int mb_fwd_xhat_launch(const void* evecs, const void* src, const void* scale,
                       void* part, int B, int V, int K, int C, int S, int L,
                       int ops_bf16, int lowp, void* stream) {
  if (B < 1 || V < 1 || K < 1 || C < 1 || C % 4 != 0 || S < 1 || L < 1 ||
      (long long)S * L < V)
    return MB_BAD_SHAPE;
  if (!aligned16(src)) return MB_BAD_LAYOUT;
  XhatArgs p = {};
  p.evecs = evecs;
  p.src = static_cast<const float*>(src);
  p.scale = static_cast<const float*>(scale);
  p.part = static_cast<float*>(part);
  p.V = V; p.K = K; p.C = C; p.S = S; p.L = L;
  p.nkt = (K + SLOT - 1) / SLOT;
  p.nct = (C + SLOT - 1) / SLOT;
  p.ops_vec = aligned16(evecs) && K % 8 == 0;
  const long long ctas = (long long)B * p.nkt * p.nct * S;
  if (ctas > 0x7fffffffLL) return MB_BAD_SHAPE;
  void* kernel =
      lowp ? (ops_bf16 ? (void*)megablock_fwd_xhat_kernel<true, true>
                       : (void*)megablock_fwd_xhat_kernel<true, false>)
           : (ops_bf16 ? (void*)megablock_fwd_xhat_kernel<false, true>
                       : (void*)megablock_fwd_xhat_kernel<false, false>);
  const int smem = lowp ? sv::grads_smem<true>() : sv::grads_smem<false>();
  return launch(kernel, dim3((unsigned)ctas), sv::GNT, smem, p, stream);
}

// partial: (G, nsplit, SLOT, SLOT) slots, 16-byte aligned; out: (G, K, C)
// with K, C <= SLOT (one piece).
int mb_xhat_reduce_launch(const void* partial, void* out, int B, int nsplit,
                          int K, int C, void* stream) {
  if (B < 1 || B > 65535 || nsplit < 1 || K < 1 || K > SLOT || C < 1 ||
      C > SLOT)
    return MB_BAD_SHAPE;
  const dim3 grid((C + XR_COLS - 1) / XR_COLS, K, B);
  xhat_reduce_kernel<<<grid, xr_chunks(nsplit) * XR_COLS / 4, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), nsplit, K,
      C);
  return (int)cudaGetLastError();
}

// The card's opt-in shared memory per block, in bytes (the wrapper's route
// choice and refusals read it).
int mb_smem_optin() { return max_smem(); }

const char* mb_error_string(int code) {
  if (code == MB_BAD_SHAPE) return "unsupported shape";
  if (code == MB_SMEM) return "shared memory request exceeds the device limit";
  if (code == MB_BAD_LAYOUT) return "operands not laid out as the kernel reads them";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
