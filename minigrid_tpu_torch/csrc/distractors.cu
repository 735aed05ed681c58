// RoomGrid's sequential distractor placement: the whole loop of
// minigrid_tpu_torch/core/roomgrid.py::RoomGridEnv.add_distractors (a room
// drawn per object) in one launch.
//
// Replaces no TPU kernel.  The JAX package runs the loop as a lax.scan whose
// body XLA fuses itself; the port's plain version runs each object's draws
// and grid updates as eager ops, about 160 launches an object, and the
// multi-room BabyAI levels place 18 objects a level.  This kernel places them
// all, bit for bit the loop's grid, combo mask, (type, color) pairs and
// positions.
//
// Per object, as the loop does (every draw the threefry twin's):
//
//     keys, k_tc, k_i, k_j, k_pos = split(keys, 5)
//     combo = all_unique ? categorical(k_tc, the combos not yet present)
//                        : randint(k_tc, 0, 30)
//     room (ri, rj)      = randint(k_i, 0, num_cols), randint(k_j, 0, num_rows),
//                          or the caller's fixed column or row
//     free               = empty cells of the room's rectangle at manhattan
//                          distance >= 2 from the agent
//     r                  = randint(split(k_pos, 3)[2], 0, max(|free|, 1))
//     pos                = the free cell whose running count in x * H + y
//                          order exceeds r; (0, 0) and not ok where none is
//
// and where ok and enabled, writes kind | write_color << 8 at pos and sets
// the combo kind * 10 + rank(write_color).  The categorical over logits of 0
// and -inf is the argmax of bits >> 9 over the combos still free, the lower
// index on ties and 0 where none is: the Gumbel noise is strictly increasing
// in the uniform draw (tests/test_torch_roomgrid.py holds that for every
// float32 the draw can give).
//
// Bound on an H100: a level reads and writes its grid once (484 words at
// 22 x 22: 3.9 KB) and needs 22 hashes an object (48 with all_unique), 80
// integer operations a hash.  GoTo's 16 levels a step are 0.5 M operations
// and 68 KB, 0.02 us at 3.35 TB/s: the launch and the placements' dependent
// chain are the cost, and the eager loop it replaces cost 48 ms of host a
// call.  A reset of 4096 levels is 17 MB, 5.2 us, against 3.9 us of hashing
// at 33.5 T int32 ops/s.  A warp hashes an object's counters in four or five
// rounds of 32 lanes, most of them idle, so the chain of 18 placements, not
// either roof, sets the time.
//
// Design: one warp per env, four envs a block.  The env's grid lives in
// shared memory; the 30-combo mask in a register (a ballot); the hashes in
// registers, each round on up to 32 lanes: the 5-way split, then the three
// randints' and the cell draw's chains (lanes 0-7), then the 30 combo words
// (lanes 0-29).  The room's free cells are counted 32 at a time by ballot
// and popc, in x * H + y order, and the r-th one found by a second pass.  A
// placement is one lane's store into shared memory, published by
// __syncwarp(); the grid is written back once, coalesced, to a fresh output.
// The input grids are read through their batch stride (0 for init_rooms'
// expanded lattice, W * H + 1 for connect_all's rows of a wider scatter).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA events over CUDA-graph
// replays, GoTo's call of 18 objects): 41.4 us at 16 levels and 106.7 us at
// 4096 (0.049 of the bound), against 4,136 and 5,908 us of device time for
// the plain loop; a call takes 55-88 us of host time, the loop 44-51 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kWarps = 4;  // envs a block
constexpr int kThreads = 32 * kWarps;
constexpr int kCombos = 30;  // (kind, color) pairs
constexpr int kColors = 10;
constexpr int kKinds = 3;
constexpr int kEmpty = 1;  // minigrid_tpu_torch/core/constants.py OBJECT_TO_IDX["empty"]
constexpr unsigned kFull = 0xFFFFFFFFu;
using threefry_hash::randint;

constexpr int kAllUnique = 1;
constexpr int kDrawI = 2;
constexpr int kDrawJ = 4;
constexpr int kOverride = 8;

// ops/distractors.py::Args mirrors this layout field for field.
struct Args {
  const int64_t* keys;       // [n, 2] at key_stride, word 1 key_word further
  const int32_t* grid;       // [n, W, H], row-major grids grid_stride apart
  const uint8_t* obj_mask;   // [n, 30] bool
  const int32_t* agent_pos;  // [n, 2]
  const int32_t* room_i;     // the fixed column per env (at room_i_stride), or null
  const int32_t* room_j;
  const uint8_t* enabled;    // per env (at enabled_stride), or null: enabled_value
  const int32_t* color;      // color_override per env (at color_stride), or null
  int32_t* out_grid;         // [n, W, H]
  uint8_t* out_mask;         // [n, 30]
  int32_t* added;            // [n, num, 2] (type id, drawn color id)
  int32_t* positions;        // [n, num, 2]
  int32_t n, width, height, room_size, num_rows, num_cols, num;
  int32_t key_stride, key_word, grid_stride;
  int32_t room_i_stride, room_i_value, room_j_stride, room_j_value;
  int32_t enabled_stride, enabled_value, color_stride, color_value;
  int32_t flags;
  int32_t sorted_colors[kColors];  // core/sampling.py SORTED_COLOR_IDS
  int32_t kind_ids[kKinds];        // key, ball, box
};

// The rank of a color id among the sorted names, 0 where none matches.
__device__ __forceinline__ int color_rank(const Args& a, int color) {
  for (int r = 0; r < kColors; ++r) {
    if (a.sorted_colors[r] == color) return r;
  }
  return 0;
}

__device__ __forceinline__ uint32_t shfl(uint32_t v, int lane) {
  return __shfl_sync(kFull, v, lane);
}

// Cell `idx` of a room rectangle (x0, y0) with rh rows, in x * H + y order,
// and whether it is free: inside, empty, not next to the agent.
__device__ __forceinline__ bool free_cell(const int32_t* g, int idx, int cells, int x0,
                                          int y0, int rh, int height, int ax, int ay,
                                          int& x, int& y) {
  x = x0 + idx / rh;
  y = y0 + idx % rh;
  if (idx >= cells) return false;
  const int d = abs(x - ax) + abs(y - ay);
  return (g[x * height + y] & 0xFF) == kEmpty && d >= 2;
}

__global__ void __launch_bounds__(kThreads) distractors_kernel(const __grid_constant__ Args a) {
  extern __shared__ int32_t tiles[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= a.n) return;  // the whole warp: no lane of it takes part below
  const int W = a.width, H = a.height, cells = W * H, s = a.room_size;
  int32_t* g = tiles + warp * cells;

  const int32_t* src = a.grid + static_cast<long long>(b) * a.grid_stride;
  for (int c = lane; c < cells; c += 32) g[c] = src[c];
  uint32_t taken = __ballot_sync(kFull, lane < kCombos && a.obj_mask[b * kCombos + lane]);
  const int64_t* key = a.keys + static_cast<long long>(b) * a.key_stride;
  uint32_t k0 = static_cast<uint32_t>(key[0]), k1 = static_cast<uint32_t>(key[a.key_word]);
  const int ax = a.agent_pos[2 * b], ay = a.agent_pos[2 * b + 1];
  const bool enabled = a.enabled ? a.enabled[b * a.enabled_stride] != 0 : a.enabled_value != 0;
  const int fixed_i = a.room_i ? a.room_i[b * a.room_i_stride] : a.room_i_value;
  const int fixed_j = a.room_j ? a.room_j[b * a.room_j_stride] : a.room_j_value;
  const int override_color = a.color ? a.color[b * a.color_stride] : a.color_value;
  __syncwarp();

  for (int p = 0; p < a.num; ++p) {
    // keys, k_tc, k_i, k_j, k_pos = split(keys, 5): lane l hashes counter l
    uint32_t s0, s1;
    threefry_hash::hash(k0, k1, lane, s0, s1);
    // the randints' words: lanes 0-5 bits(split(k)[lane & 1]) of k = k_tc,
    // k_i, k_j; lanes 6-7 the same of the cell key split(k_pos, 3)[2]
    const int from = lane < 6 ? 1 + (lane >> 1) : 4;
    const uint32_t c0 = shfl(s0, from), c1 = shfl(s1, from);
    const uint32_t tc0 = shfl(s0, 1), tc1 = shfl(s1, 1);
    k0 = shfl(s0, 0);
    k1 = shfl(s1, 0);
    uint32_t h0, h1, t0, t1;
    threefry_hash::hash(c0, c1, lane < 6 ? (lane & 1) : 2, h0, h1);
    threefry_hash::hash(h0, h1, lane < 6 ? 0 : (lane & 1), t0, t1);
    uint32_t word = t0 ^ t1;
    if (lane == 6 || lane == 7) {
      uint32_t w0, w1;
      threefry_hash::hash(t0, t1, 0, w0, w1);
      word = w0 ^ w1;
    }
    const uint32_t w[8] = {shfl(word, 0), shfl(word, 1), shfl(word, 2), shfl(word, 3),
                           shfl(word, 4), shfl(word, 5), shfl(word, 6), shfl(word, 7)};

    int combo;
    if (a.flags & kAllUnique) {
      uint32_t y0, y1;
      threefry_hash::hash(tc0, tc1, lane, y0, y1);
      const bool avail = lane < kCombos && !((taken >> lane) & 1u);
      // the draw's 23 bits above the lane, so the larger wins and the
      // lower lane on ties; 0 (index 0) where no combo is free
      const uint32_t score = avail ? ((((y0 ^ y1) >> 9) + 1u) << 5) | (31u - lane) : 0u;
      const uint32_t best = __reduce_max_sync(kFull, score);
      combo = best ? 31 - static_cast<int>(best & 31u) : 0;
    } else {
      combo = randint(w[0], w[1], 0, kCombos);
    }
    const int ri = (a.flags & kDrawI) ? randint(w[2], w[3], 0, a.num_cols) : fixed_i;
    const int rj = (a.flags & kDrawJ) ? randint(w[4], w[5], 0, a.num_rows) : fixed_j;

    // the room's rectangle, its top clamped at 0 and its extent at the grid
    const long long x0 = max(static_cast<long long>(ri) * (s - 1), 0LL);
    const long long y0 = max(static_cast<long long>(rj) * (s - 1), 0LL);
    const int rw = static_cast<int>(max(min(x0 + s, static_cast<long long>(W)) - x0, 0LL));
    const int rh = static_cast<int>(max(min(y0 + s, static_cast<long long>(H)) - y0, 0LL));
    const int rect = rw * rh;
    const int tx = static_cast<int>(min(x0, static_cast<long long>(W)));
    const int ty = static_cast<int>(min(y0, static_cast<long long>(H)));

    int total = 0, x, y;
    for (int base = 0; base < rect; base += 32) {
      const bool f = free_cell(g, base + lane, rect, tx, ty, rh, H, ax, ay, x, y);
      total += __popc(__ballot_sync(kFull, f));
    }
    const int r = randint(w[6], w[7], 0, max(total, 1));
    int px = 0, py = 0;
    for (int base = 0, before = 0; total > 0 && base < rect; base += 32) {
      const bool f = free_cell(g, base + lane, rect, tx, ty, rh, H, ax, ay, x, y);
      const uint32_t m = __ballot_sync(kFull, f);
      if (r < before + __popc(m)) {
        const bool pick = f && __popc(m & ((1u << lane) - 1u)) == r - before;
        const int idx = base + __ffs(__ballot_sync(kFull, pick)) - 1;
        px = tx + idx / rh;
        py = ty + idx % rh;
        break;
      }
      before += __popc(m);
    }

    const int kind = a.kind_ids[combo / kColors];
    const int color = a.sorted_colors[combo % kColors];
    const int write_color = (a.flags & kOverride) ? override_color : color;
    if (total > 0 && enabled) {
      if (lane == 0) g[px * H + py] = kind | ((write_color & 0xFF) << 8);
      taken |= 1u << ((combo / kColors) * kColors + color_rank(a, write_color));
    }
    if (lane == 0) {
      const long long o = (static_cast<long long>(b) * a.num + p) * 2;
      a.added[o] = kind;
      a.added[o + 1] = color;
      a.positions[o] = px;
      a.positions[o + 1] = py;
    }
    __syncwarp();
  }

  int32_t* dst = a.out_grid + static_cast<long long>(b) * cells;
  for (int c = lane; c < cells; c += 32) dst[c] = g[c];
  if (lane < kCombos) a.out_mask[b * kCombos + lane] = (taken >> lane) & 1u;
}

// Shared memory a block takes: its envs' grids of WH words.
constexpr int tile_bytes(int WH) { return kWarps * WH * 4; }

}  // namespace

// The size of Args, which the wrapper holds against its own.
extern "C" int distractors_args_size() { return static_cast<int>(sizeof(Args)); }

// One launch for the envs of `args` (an Args, taken as void* so that the
// entry keeps external linkage) on `stream`: every pointer on the current
// device, the outputs contiguous.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue, without launching, for an empty batch.
extern "C" int distractors(const void* args, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  if (a.n < 1 || a.num < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = tile_bytes(a.width * a.height);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        distractors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (a.n + kWarps - 1) / kWarps;
  distractors_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
