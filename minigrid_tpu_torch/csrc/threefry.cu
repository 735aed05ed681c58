// The Threefry-2x32 hash over counters: core/rng.py's split, bits and
// fold_in in one launch each.
//
// Replaces no TPU kernel.  The JAX package draws every random number through
// jax.random, which XLA fuses into the program around it; the port's plain
// version (minigrid_tpu_torch/core/rng.py::threefry2x32) issues each of the
// hash's 20 rounds as eager int64 ops, about 173 launches a call, and the
// level generators make hundreds of calls a step.  This kernel computes the
// same words, bit for bit, in one launch.
//
// Element (i, j), for i < n and j < m, hashes the counter pair (0, c) under
// its key (k0, k1):
//
//     k0 = keys[i * ks_i + j * ks_j],  k1 = keys[i * ks_i + j * ks_j + kw]
//     c  = data[i * ds_i + j * ds_j]   (fold_in by a tensor)
//     c  = base + j                    (split and bits: the iota counters)
//
// and writes the words (y0, y1) as out[e, 0], out[e, 1] (split, fold_in) or
// y0 ^ y1 as out[e] (bits), e = i * m + j: the caller's layout, int64 holding
// uint32 values.  Keys and data are read through their strides, so a key
// tensor cut from a wider split needs no copy first.
//
// Bound on an H100: one hash is 20 rounds of (add, funnel-shift, xor) and
// five key injections of two adds, about 80 integer operations, and writes 16
// bytes (8 for bits).  At 33.5 T int32 ops/s and 3.35 TB/s a hash costs 2.4 ps
// of operations against 4.8 ps of stores for a pair (2.4 ps for bits): a
// 4096 x 484 uniform, 1.98 M hashes, needs 4.7 us either way.  The
// generators' calls hash tens to hundreds of counters, where the launch
// itself is the cost.
//
// Design: one thread per element in a grid-stride loop, the key words read
// once per element (neighbouring threads of one key read the same two words,
// which L1 serves), the 20 rounds unrolled in registers (threefry.cuh, which
// distractors.cu shares), 32-bit index arithmetic (the wrapper refuses what
// overflows it).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA events over CUDA-graph
// replays): 1.48-1.57 us for a 16 x 5 split and 1.73-1.77 us for 16 x 30 bits,
// where the launch is the cost, and 10.5-10.7 us for 4096 x 484 bits, 0.45 of
// the bound; the plain formula takes 213-220, 235-239 and 1,840-1,853 us.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks an SM; the loop strides past them

struct Args {
  const int64_t* keys;
  const int64_t* data;  // null: the iota counters base + j
  int64_t* out;
  int n, m;
  int ks_i, ks_j, kw;
  int ds_i, ds_j;
  uint32_t base;
};

template <bool kData, bool kXor>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const __grid_constant__ Args a) {
  const int total = a.n * a.m;
  const int stride = gridDim.x * kThreads;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < total; e += stride) {
    const int i = e / a.m;
    const int j = e - i * a.m;
    const int64_t* k = a.keys + (i * a.ks_i + j * a.ks_j);
    const uint32_t c = kData ? static_cast<uint32_t>(a.data[i * a.ds_i + j * a.ds_j])
                             : a.base + static_cast<uint32_t>(j);
    uint32_t y0, y1;
    threefry_hash::hash(static_cast<uint32_t>(k[0]), static_cast<uint32_t>(k[a.kw]), c, y0, y1);
    if (kXor) {
      a.out[e] = static_cast<int64_t>(y0 ^ y1);
    } else {
      reinterpret_cast<longlong2*>(a.out)[e] =
          make_longlong2(static_cast<long long>(y0), static_cast<long long>(y1));
    }
  }
}

template <bool kData, bool kXor>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int total = a.n * a.m;
  const int blocks = min((total + kThreads - 1) / kThreads, kMaxBlocks);
  threefry_kernel<kData, kXor><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// keys int64 [.., 2] read at the strides above, data int64 (or null), out
// int64 [n * m * (xor_words ? 1 : 2)], contiguous and 16-byte aligned, all on
// the current device; launched on `stream`.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue, without launching, for an empty or
// negative extent.
extern "C" int threefry(const void* keys, const void* data, void* out, int n, int m,
                        int ks_i, int ks_j, int kw, int ds_i, int ds_j, unsigned base,
                        int xor_words, void* stream) {
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int64_t*>(keys), static_cast<const int64_t*>(data),
               static_cast<int64_t*>(out), n, m, ks_i, ks_j, kw, ds_i, ds_j, base};
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (data != nullptr) {
    err = xor_words ? launch<true, true>(a, s) : launch<true, false>(a, s);
  } else {
    err = xor_words ? launch<false, true>(a, s) : launch<false, false>(a, s);
  }
  return static_cast<int>(err);
}
