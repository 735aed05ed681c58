// LevelGen's descriptor redraws: the fueled loop of
// minigrid_tpu_torch/babyai/levelgen.py::LevelGen._rand_objs in one launch.
//
// Replaces no TPU kernel.  The JAX package runs the loop as a fueled
// lax.while_loop (minigrid_tpu/babyai/levelgen.py::LevelGen._rand_objs) whose
// body XLA fuses itself; the port's plain version runs each pass as eager ops
// over the (env, lane) pairs still redrawing, about 145 launches a pass, and
// reads on the host whether a pair is left, up to 25 passes a call.  This
// kernel draws every lane to its end, bit for bit the loop's descriptors and
// redraw counts.
//
// Lane s of an env (0-3 from key_d1, 4-7 from key_d2, clause q = s % 4), as
// the loop draws it (every draw the threefry twin's):
//
//     c = fold_in(key, q)
//     up to 1 + kFuel times:
//         c, sub = split(c)                 (the first pass's sub: `first`)
//         ci, u, r2, r3 = randint(split(sub, 4)[i], 0, (11, 12, 2, 4)[i])
//         color = ci ? sorted_colors[ci - 1] : 0
//         type  = open ? door : (goto or fixed putnext ? 1 + u % 4 : 1 + u % 3)
//         loc   = locations and r2 == 0 ? 1 + r3 : 0
//         stop if the desc matches an object of the env's grid
//
// and keeps its last draw.  A desc matches a cell of its type (any of box,
// ball, key, door for type 0) and color (any for 0) that, for a location,
// lies in the agent's starting room (walls included) on that side of the
// agent's starting pose; without implicit unlocking, never a cell of the
// locked room where the env has one (babyai/verifier.py::desc_match_mask and
// LevelGen._descs_match).
//
// Bound on an H100: a level reads its grid once (484 words at 22 x 22, and
// its 484-byte locked-room mask without implicit unlocking) and writes 128
// bytes; a lane hashes 1 + 22 a pass, about 80 integer operations a hash.
// BossLevel's 16 levels a step are about 34 KB and 0.74 M operations (288
// redraws), 0.022 us at 33.5 T int32 ops/s; a reset of 4096 levels about
// 8.7 MB and 188 M operations, 5.6 us.  A pass is four dependent hashes and a
// scan of the grid, so the lane that redraws most, up to 24 times, sets the
// time, not either roof.
//
// Design: one block per env, one warp per lane.  The block stages the env's
// grid in shared memory once, each cell as its type and color with the four
// locations it satisfies (bits 16-19) and the locked room's exclusion (bit
// 20), so that a pass's match is a warp-wide scan of words with __any_sync
// and no coordinates.  A pass's hashes run across the warp's lanes: the split
// of the chain on lanes 0-1, the four keys of split(sub, 4) on lanes 0-3, the
// eight randint words on lanes 0-7, then shuffled to every lane.  Warps never
// wait on each other after the staging: a lane's loop ends when it matches or
// its fuel runs out, and the block ends with its slowest lane.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA events over CUDA-graph
// replays, BossLevel's call): 41.7 us at 16 levels (16 redraws at most, 2.5
// us a pass) and 178.6 us at 4096 (24 at most; 0.031 of the bound), against
// 39.4 and 61.5 ms for the plain loop on the card, whose host reads wait on
// every pass; a call takes 40-65 us of host time, the loop 39-59 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kLanes = 8;  // descriptor lanes an env, a warp each
constexpr int kThreads = 32 * kLanes;
constexpr int kClauses = 4;
constexpr int kFuel = 24;  // babyai/levelgen.py DESC_FUEL
constexpr int kGoTo = 1;   // babyai/verifier.py K_GOTO, K_OPEN, K_PUTNEXT
constexpr int kOpen = 3;
constexpr int kPutNext = 4;
constexpr int kLocations = 1;  // flags
constexpr int kImplicitUnlock = 2;
constexpr int kLocShift = 15;  // location l (1-4) holds at bit kLocShift + l
constexpr int kExcluded = 1 << 20;
constexpr unsigned kFull = 0xFFFFFFFFu;

// core/sampling.py SORTED_COLOR_IDS and babyai/verifier.py DESC_TYPE_IDS
__constant__ int kSortedColors[10] = {3, 9, 8, 2, 6, 10, 4, 1, 7, 5};
__constant__ int kDescTypes[5] = {0, 23, 22, 21, 4};

struct Args {
  const int64_t* key_d1;      // [n, 2] at d1_stride, word 1 d1_word further
  const int64_t* key_d2;      // [n, 2] at d2_stride, word 1 d2_word further
  const int32_t* grid;        // [n, W, H], row-major grids grid_stride apart
  const int32_t* agent_pos;   // [n, 2]
  const int32_t* agent_dir;   // [n]
  const int32_t* kinds;       // [n, 4] clause kinds
  const uint8_t* locked_rect; // [n, W, H] bool
  const uint8_t* has_locked;  // [n] bool
  int32_t* descs;             // [n, 8, 3] (type, color, location)
  int32_t* redraws;           // [n, 8]
  int n, width, height, room_size;
  int d1_stride, d1_word, d2_stride, d2_word, grid_stride, flags;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t shfl(uint32_t v, int lane) {
  return __shfl_sync(kFull, v, lane);
}

// Whether a desc (type, color, loc) matches a staged cell of the warp's env.
__device__ __forceinline__ bool any_match(const int32_t* cells, int n_cells, int type,
                                          int color, int loc, int lane) {
  const int want = kDescTypes[min(max(type, 0), 4)];
  for (int base = 0; base < n_cells; base += 32) {
    const int c = base + lane;
    bool m = false;
    if (c < n_cells) {
      const int w = cells[c];
      const int t = w & 0xFF;
      const bool type_ok = type == 0 ? (t == kDescTypes[1] || t == kDescTypes[2]
                                        || t == kDescTypes[3] || t == kDescTypes[4])
                                     : t == want;
      m = type_ok && (color == 0 || ((w >> 8) & 0xFF) == color)
          && (loc == 0 || ((w >> (kLocShift + loc)) & 1)) && !(w & kExcluded);
    }
    if (__any_sync(kFull, m)) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads) descs_kernel(const __grid_constant__ Args a) {
  extern __shared__ int32_t cells[];
  const int b = blockIdx.x;
  const int W = a.width, H = a.height, n_cells = W * H;

  // the env's cells: type and color, the locations each satisfies inside the
  // agent's starting room, and the locked room where it is excluded
  const int ax = a.agent_pos[2 * b], ay = a.agent_pos[2 * b + 1];
  const int dir = a.agent_dir[b];
  const int f0 = dir == 0 ? 1 : (dir == 2 ? -1 : 0);
  const int f1 = dir == 1 ? 1 : (dir == 3 ? -1 : 0);
  const int s1 = a.room_size - 1;
  const int rx0 = max(floor_div(ax, s1) * s1, 0), ry0 = max(floor_div(ay, s1) * s1, 0);
  const int rx1 = min(rx0 + a.room_size, W), ry1 = min(ry0 + a.room_size, H);
  const bool exclude = !(a.flags & kImplicitUnlock) && a.has_locked[b];
  const int32_t* g = a.grid + static_cast<long long>(b) * a.grid_stride;
  const uint8_t* locked = a.locked_rect + static_cast<long long>(b) * n_cells;
  for (int c = threadIdx.x; c < n_cells; c += kThreads) {
    const int x = c / H, y = c % H;
    const int vx = x - ax, vy = y - ay;
    const int front = vx * f0 + vy * f1, side = vx * (-f1) + vy * f0;
    int w = g[c] & 0xFFFF;
    if (x >= rx0 && x < rx1 && y >= ry0 && y < ry1) {
      w |= (static_cast<int>(side < 0) << (kLocShift + 1))
           | (static_cast<int>(side > 0) << (kLocShift + 2))
           | (static_cast<int>(front > 0) << (kLocShift + 3))
           | (static_cast<int>(front < 0) << (kLocShift + 4));
    }
    if (exclude && locked[c]) w |= kExcluded;
    cells[c] = w;
  }
  __syncthreads();

  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31, q = s % kClauses;
  const int64_t* key = s < kClauses ? a.key_d1 + static_cast<long long>(b) * a.d1_stride
                                    : a.key_d2 + static_cast<long long>(b) * a.d2_stride;
  const int word = s < kClauses ? a.d1_word : a.d2_word;
  const int kind = a.kinds[b * kClauses + q];
  const bool any_type = kind == kGoTo || (kind == kPutNext && s >= kClauses);
  uint32_t c0, c1;
  threefry_hash::hash(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[word]), q,
                      c0, c1);
  int type = 0, color = 0, loc = 0, redraws = 0;
  for (int pass = 0;; ++pass) {
    // c, sub = split(c): lane 0 the chain, lane 1 the draw's key
    uint32_t h0, h1;
    threefry_hash::hash(c0, c1, lane & 1, h0, h1);
    c0 = shfl(h0, 0);
    c1 = shfl(h1, 0);
    // split(sub, 4) on lanes 0-3; lane l then takes key l >> 1 and hashes
    // bits(split(key)[l & 1]), randint l >> 1's high (even l) or low word
    uint32_t k0, k1;
    threefry_hash::hash(shfl(h0, 1), shfl(h1, 1), lane & 3, k0, k1);
    const int from = (lane >> 1) & 3;
    threefry_hash::hash(shfl(k0, from), shfl(k1, from), lane & 1, h0, h1);
    threefry_hash::hash(h0, h1, 0, k0, k1);
    const uint32_t bits = k0 ^ k1;
    const int ci = threefry_hash::randint(shfl(bits, 0), shfl(bits, 1), 0, 11);
    const int u = threefry_hash::randint(shfl(bits, 2), shfl(bits, 3), 0, 12);
    const int r2 = threefry_hash::randint(shfl(bits, 4), shfl(bits, 5), 0, 2);
    const int r3 = threefry_hash::randint(shfl(bits, 6), shfl(bits, 7), 0, 4);
    color = ci == 0 ? 0 : kSortedColors[ci - 1];
    type = kind == kOpen ? 4 : (any_type ? 1 + u % 4 : 1 + u % 3);
    loc = (a.flags & kLocations) && r2 == 0 ? 1 + r3 : 0;
    if (pass == kFuel || any_match(cells, n_cells, type, color, loc, lane)) break;
    ++redraws;
  }
  if (lane == 0) {
    int32_t* d = a.descs + (static_cast<long long>(b) * kLanes + s) * 3;
    d[0] = type;
    d[1] = color;
    d[2] = loc;
    a.redraws[b * kLanes + s] = redraws;
  }
}

// Shared memory a block takes: its env's grid of WH words.
constexpr int tile_bytes(int WH) { return WH * 4; }

}  // namespace

// One launch for the n envs on `stream`: every pointer on the current device,
// the outputs contiguous.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue, without launching, for an empty batch or grid.
extern "C" int descs(const int64_t* key_d1, const int64_t* key_d2, const int32_t* grid,
                     const int32_t* agent_pos, const int32_t* agent_dir, const int32_t* kinds,
                     const uint8_t* locked_rect, const uint8_t* has_locked,
                     int32_t* out_descs, int32_t* out_redraws, int n, int width, int height, int room_size,
                     int d1_stride, int d1_word, int d2_stride, int d2_word, int grid_stride,
                     int flags, void* stream) {
  if (n < 1 || width < 1 || height < 1 || room_size < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{key_d1, key_d2, grid, agent_pos, agent_dir, kinds, locked_rect, has_locked,
               out_descs, out_redraws, n, width, height, room_size,
               d1_stride, d1_word, d2_stride, d2_word, grid_stride, flags};
  const int smem = tile_bytes(width * height);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        descs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  descs_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
