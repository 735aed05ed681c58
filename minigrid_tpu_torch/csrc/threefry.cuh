// The Threefry-2x32 hash on the device, shared by the kernels that draw
// (threefry.cu, distractors.cu, descs.cu, fused_step.cu):
// minigrid_tpu_torch/core/rng.py::threefry2x32 of the counter pair (0, c)
// under one key, 20 rounds in registers; and core/rng.py::randint from its
// two words (distractors.cu, descs.cu).

#pragma once

#include <stdint.h>

namespace threefry_hash {

constexpr uint32_t kParity = 0x1BD11BDA;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2,
                                     int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// Threefry-2x32, 20 rounds, of the counter pair (0, c) under (k0, k1).
__device__ __forceinline__ void hash(uint32_t k0, uint32_t k1, uint32_t c, uint32_t& y0,
                                     uint32_t& y1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = k0;
  uint32_t x1 = c + k1;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  y0 = x0;
  y1 = x1;
}

// core/rng.py::randint from its two words: unsigned span and multiplier
// arithmetic with uint32 wraparound, span 1 where hi <= lo.
__device__ __forceinline__ int randint(uint32_t higher, uint32_t lower, int lo, int hi) {
  const uint32_t span = hi <= lo ? 1u : static_cast<uint32_t>(hi) - static_cast<uint32_t>(lo);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t off = ((higher % span) * mult + lower % span) % span;
  return static_cast<int>(static_cast<uint32_t>(lo) + off);
}

}  // namespace threefry_hash
