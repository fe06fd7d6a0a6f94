// Pieces shared by the block kernels B1 (megablock_fwd.cu) and B2
// (megablock_bwd.cu), and by spectral_fused.cu: their limits and error
// codes, and the dropout hash. The products themselves are in wgmma.cuh
// and splitv.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mb {

constexpr int MAX_DENSE = 16;  // MLP layers a launch's arguments hold
constexpr int SLOT = 128;      // side of an x_hat partial slot: (K, C) are
                               // covered in SLOT x SLOT pieces

// Error codes beyond cudaError_t's: the wrapper turns them into messages.
enum { MB_BAD_SHAPE = -1, MB_SMEM = -2, MB_BAD_LAYOUT = -3 };

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

}  // namespace mb
