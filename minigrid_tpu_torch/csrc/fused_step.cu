// The fused env step: one launch per step of every env, auto-reset and
// observation included.
//
// Replaces minigrid_tpu/ops/fused_step.py::_kernel (driven by that module's
// FusedVectorEnv).  Output is bitwise what the JAX kernel gives under the
// Pallas interpreter, with the draws that FusedVectorEnv._step_impl makes
// there: per env, in order,
//
//   1. the front cell (pre-action direction), the action tree, the door FSM,
//      pickup / drop / toggle, reward fma(c, -K, 1) and truncation at the
//      static max_steps;
//   2. the new grid, written out of place: a copy of the env's W*H words
//      with the front cell changed, or, for a finished env, the closed-form
//      level of its generator (DoorKey, Empty with a fixed or random start);
//   3. the rotated V x V view of the new grid (out-of-bounds cells the grey
//      wall), the carried object at the agent's view cell, occlusion, and
//      unseen cells zeroed, written as the uint8 [V, V, 3] image.
//
// Random numbers: the step key k splits into (k_next, sub) = (h(k, 0, 0),
// h(k, 0, 1)), h the threefry2x32 hash of a counter pair (threefry.cuh,
// shared with threefry.cu and distractors.cu); the draw
// randint(sub, (N, 8), 0, 2^24) has a zero multiplier at that span, so draw
// j of env n is (h0 ^ h1) & 0xFFFFFF of h(h(sub, 0, 1), 0, n*8 + j).  The
// thread of a finished env computes the draws it reads (columns 0-4), and
// one thread of block 0 writes k_next and t + 1.  The key is read from
// device memory, so a step needs no copy to the host.
//
// Bound on an H100 at DoorKey-8x8, B=4096, V=7: per env it must read the
// grid (256 B, only the front cell for a finished env), the agent row and
// the action (36 B), and write the grid, the agent row, the image (147 B),
// the reward and the two flags (445 B in all): about 3.0 MB, 0.9 us at
// 3.35 TB/s.  Its integer work is a few thousand operations per env, about
// 0.2 us at 33.5 TOP/s: bytes bind.  There is no matrix product, only
// selects and bit logic, so the tensor cores have no part in it.
//
// Design.  A block of kThreads threads owns a tile of kTile consecutive
// envs and runs in phases separated by barriers, each phase a device
// function (view_tile.cuh has the copies and the view's coordinates):
//
//   stage_in     the tile's grid rows (one contiguous span), agent rows and
//                actions are copied into shared memory with cp.async, all
//                issued before any is awaited, so their latencies overlap
//                and no register holds the data;
//   step_env     one thread per env runs the action tree against the shared
//                copy and writes the front cell there; for a finished env
//                it computes its five draws and its level's parameters; it
//                leaves the new agent row and the view's frame (the world
//                cell of view cell (0, 0), the facing vector) in shared
//                memory;
//   regenerate   only in a block with a finished env: one thread per cell
//                writes the finished envs' levels;
//   write_rows   the tile's grid and agent rows go out with 16-byte stores;
//   see_words    one thread per (env, view column) walks its column of the
//                new grid in shared memory (rotation folded into the frame,
//                grey wall out of bounds, carried object at (V/2, V-1))
//                and builds the column's transparency word in a register;
//   occlude      one thread per env runs the reference's two in-row sweeps
//                per row, bottom-up, on its column words (bit i of word j is
//                view cell (i, j)), each sweep as one carry-propagating add;
//   image_bytes  one thread per (env, view column) walks the column again,
//                zeroes the unseen cells and stages the bytes in shared
//                memory;
//   store_bytes  the tile's image span goes out with 16-byte stores.
//
// So device memory is read once and written once, in coalesced 16-byte
// accesses, no phase waits on a chain of device-memory loads, and the
// view's 49 cells an env are spread over 7 threads with no atomics.  At
// B=4096 256 blocks of four warps run in one wave.  The shared rows keep
// the device stride of W*H words: only the front cell's read and write
// meet bank conflicts, while an odd padded stride would cost a divide per
// staged word and break the 16-byte copies.  The tile takes
// 64 * (W*H + V + 19) + 48 * V*V bytes of shared memory, 8,112 for
// DoorKey-8x8 at V=7; the wrapper refuses what exceeds 227 KB.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA events over CUDA-graph
// replays): 4.2-4.4 us at DoorKey-8x8, B=4096, V=7 (4.7x the bound; an empty
// launch of this kernel takes 1.5 us), 9.9 us at B=32768 (bound 7.2 us),
// 6.7 us when 2,804 of 4,096 envs regenerate.  One thread per env, the
// design this replaces, took 21-23 us at B=4096 and 131-137 us at
// B=32768.

// The Pallas kernel's [BLK, LANES] lane layout, pad lanes, masked-reduce
// reads and the TPU PRNG mode are TPU workarounds and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "view_tile.cuh"

namespace {

using namespace view_tile;

// minigrid_tpu_torch/core/constants.py (tests/test_torch_kernels.py holds
// these against the table; kWall, kDoor, kGrey and kOpen are in view_tile.cuh)
constexpr int kEmpty = 1;
constexpr int kKey = 21;
constexpr int kBall = 22;
constexpr int kGoal = 31;
constexpr int kLava = 32;
constexpr int kLocked = 2;
constexpr int kGreen = 2;
constexpr int kYellow = 5;

constexpr int kGenDoorKey = 0;
constexpr int kGenEmptyRandom = 2;
constexpr int kMaxView = 31;
constexpr int kAgentWidth = 8;
constexpr int kTile = 16;  // envs a block owns
constexpr int kThreads = 128;
static_assert(kTile % 16 == 0 && kTile <= 32,
              "16-byte aligned image spans; one bit a tile env in the done mask");

__device__ __forceinline__ int pack(int t, int c, int s) {
  return t | (c << 8) | (s << 16);
}

struct Level {  // a finished env's new layout and start
  int split, door_y, kx, ky;
  int x, y, dir;
};

__device__ __forceinline__ int level_cell(const Level& lv, int gen, int lx, int ly,
                                          int W, int H) {
  const bool border = lx == 0 || lx == W - 1 || ly == 0 || ly == H - 1;
  const bool goal = lx == W - 2 && ly == H - 2;
  if (gen != kGenDoorKey) {
    return border ? pack(kWall, kGrey, 0) : (goal ? pack(kGoal, kGreen, 0) : kEmpty);
  }
  const bool walls = border || lx == lv.split;
  const bool door = lx == lv.split && ly == lv.door_y;
  const bool key = lx == lv.kx && ly == lv.ky;
  int typ = walls ? kWall : kEmpty;
  int col = walls ? kGrey : 0;
  if (goal) { typ = kGoal; col = kGreen; }
  if (door) { typ = kDoor; col = kYellow; }
  if (key) { typ = kKey; col = kYellow; }
  return pack(typ, col, door ? kLocked : 0);
}

// What the C entry passes to every block.
struct Args {
  const int* grid;
  const int* agent;
  const int* action;
  const long long* key;
  const int* t_in;
  int* ngrid;
  int* nagent;
  uint8_t* image;
  float* reward;
  bool* term;
  bool* trunc;
  long long* key_out;
  int* t_out;
  int N, W, H, V, max_steps;
  float neg_k;
  int see_through, gen, sx, sy, sdir;
  int vec;  // every tensor 16-byte aligned: the tile copies move 16 bytes
};

// A block's tile in shared memory.  Each segment holds kTile rows, so each
// starts 16-byte aligned.
struct Tile {
  int* grid;        // [kTile, W*H] the grid, stepped, then regenerated
  int* agent;       // [kTile, 8] the agent rows, stepped in place
  int* action;      // [kTile]
  int* level;       // [kTile, 4] split, door_y, kx, ky of a finished env
  unsigned* done;   // [kTile] word 0: the finished envs' bit mask
  int4* frame;      // [kTile] the view's frame of the new pose
  int* carried;     // [kTile] the carried object's packed word
  unsigned* cols;   // [kTile, V] transparency, then visibility, words
  uint8_t* image;   // [kTile, V*V*3]
};

__host__ __device__ inline int tile_bytes(int WH, int V) {
  return 4 * kTile * (WH + kAgentWidth + 1 + 4 + 1 + 4 + 1 + V) + 3 * kTile * V * V;
}

__device__ __forceinline__ Tile carve(void* base, int WH, int V) {
  int* p = static_cast<int*>(base);
  Tile s;
  s.grid = p;
  p += kTile * WH;
  s.agent = p;
  p += kTile * kAgentWidth;
  s.action = p;
  p += kTile;
  s.level = p;
  p += kTile * 4;
  s.done = reinterpret_cast<unsigned*>(p);
  p += kTile;
  s.frame = reinterpret_cast<int4*>(p);
  p += kTile * 4;
  s.carried = p;
  p += kTile;
  s.cols = reinterpret_cast<unsigned*>(p);
  p += kTile * V;
  s.image = reinterpret_cast<uint8_t*>(p);
  return s;
}

__device__ __forceinline__ void write_key(const Args& a) {
  uint32_t k0, k1;
  threefry_hash::hash(static_cast<uint32_t>(a.key[0]), static_cast<uint32_t>(a.key[1]), 0u,
                      k0, k1);
  a.key_out[0] = k0;
  a.key_out[1] = k1;
  a.t_out[0] = a.t_in[0] + 1;
}

// ---- the phases; `nt` is the tile's env count (kTile but for the last) ------

__device__ __forceinline__ void stage_in(const Args& a, const Tile& s, int n0, int nt,
                                         int tid, int nthreads) {
  const int WH = a.W * a.H;
  stage_words(s.grid, a.grid + n0 * WH, nt * WH, a.vec, tid, nthreads);
  stage_words(s.agent, a.agent + n0 * kAgentWidth, nt * kAgentWidth, a.vec, tid,
              nthreads);
  stage_words(s.action, a.action + n0, nt, a.vec, tid, nthreads);
  if (tid == 0) s.done[0] = 0u;
}

// Env e of the tile (global n0 + e): front cell, action tree, the front
// cell written back, or the finished env's draws and level parameters; the
// new agent row in place, its view frame, reward and flags to device memory.
__device__ __forceinline__ void step_env(const Args& a, const Tile& s, int n0, int e) {
  const int n = n0 + e;
  const int W = a.W, H = a.H;
  int* ag = s.agent + e * kAgentWidth;
  const int x = ag[0], y = ag[1], d = ag[2], cnt = ag[3], ctyp = ag[4], ccol = ag[5];
  const int act = s.action[e];
  int* g = s.grid + e * W * H;

  const int fx = x + (d == 0 ? 1 : (d == 2 ? -1 : 0));
  const int fy = y + (d == 1 ? 1 : (d == 3 ? -1 : 0));
  const bool inb = fx >= 0 && fx < W && fy >= 0 && fy < H;
  const int fidx = min(max(fx, 0), W - 1) * H + min(max(fy, 0), H - 1);
  const int fcell = g[fidx];
  const int ftyp = inb ? (fcell & 0xFF) : kWall;
  const int fcol = inb ? ((fcell >> 8) & 0xFF) : 0;
  const int fsta = inb ? ((fcell >> 16) & 0xFF) : 0;

  const bool is_fwd = act == 2, is_pick = act == 3, is_drop = act == 4, is_tog = act == 5;
  int nd = act == 0 ? (d + 3) % 4 : (act == 1 ? (d + 1) % 4 : d);
  const bool can_overlap = ftyp == kEmpty || ftyp == kGoal || ftyp == kLava ||
                           (ftyp == kDoor && fsta == kOpen);
  const bool moved = is_fwd && can_overlap && inb;
  int nx = moved ? fx : x;
  int ny = moved ? fy : y;
  const int cnt2 = cnt + 1;
  const bool hit_goal = is_fwd && ftyp == kGoal;
  const bool terminated = hit_goal || (is_fwd && ftyp == kLava);
  // one rounding, whatever nvcc's contraction settings
  const float rew = hit_goal ? __fmaf_rn(static_cast<float>(cnt2), a.neg_k, 1.0f) : 0.0f;
  const bool truncated = cnt2 >= a.max_steps;

  const bool hands_free = ctyp == kEmpty;
  const bool picked = is_pick && (ftyp == kKey || ftyp == kBall) && hands_free && inb;
  const bool dropped = is_drop && ftyp == kEmpty && !hands_free && inb;
  const bool has_key = ctyp == kKey && ccol == fcol;
  const int new_door_sta = fsta == kLocked ? (has_key ? kOpen : kLocked) : 1 - fsta;
  const bool toggling = is_tog && ftyp == kDoor && inb;
  const int new_ftyp = picked ? kEmpty : (dropped ? ctyp : ftyp);
  const int new_fcol = picked ? 0 : (dropped ? ccol : fcol);
  const int new_fsta = (picked || dropped) ? 0 : (toggling ? new_door_sta : fsta);
  int nct = picked ? ftyp : (dropped ? kEmpty : ctyp);
  int ncc = picked ? fcol : (dropped ? 0 : ccol);
  int ncnt = cnt2;

  const bool done = terminated || truncated;
  if (!done) {
    if (inb) g[fidx] = pack(new_ftyp, new_fcol, new_fsta);
  } else {
    Level lv{-1, -1, -1, -1, a.sx, a.sy, a.sdir};
    if (a.gen == kGenDoorKey || a.gen == kGenEmptyRandom) {
      uint32_t s0, s1, l0, l1;
      threefry_hash::hash(static_cast<uint32_t>(a.key[0]), static_cast<uint32_t>(a.key[1]),
                          1u, s0, s1);  // sub = split(key)[1]
      threefry_hash::hash(s0, s1, 1u, l0, l1);  // split(sub)[1]: randint's low word
      int r[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        uint32_t h0, h1;
        threefry_hash::hash(l0, l1, static_cast<uint32_t>(n) * 8u + j, h0, h1);
        r[j] = static_cast<int>((h0 ^ h1) & 0xFFFFFFu);
      }
      if (a.gen == kGenDoorKey) {
        lv.split = 2 + r[0] % (W - 4);
        lv.door_y = 1 + r[1] % (W - 3);  // W, as the JAX kernel has it
        const int rows = H - 2;
        const int nfree = (lv.split - 1) * rows;
        const int r1 = r[2] % nfree;
        int r2 = r[3] % max(nfree - 1, 1);
        r2 += r2 >= r1;
        lv.x = 1 + r1 / rows;
        lv.y = 1 + r1 % rows;
        lv.kx = 1 + r2 / rows;
        lv.ky = 1 + r2 % rows;
      } else {
        const int nfree = (W - 2) * (H - 2);
        const int goal_idx = (W - 3) * (H - 2) + (H - 3);
        int r1 = r[2] % (nfree - 1);
        r1 += r1 >= goal_idx;
        lv.x = 1 + r1 / (H - 2);
        lv.y = 1 + r1 % (H - 2);
      }
      lv.dir = r[4] % 4;
    }
    int* lp = s.level + 4 * e;
    lp[0] = lv.split;
    lp[1] = lv.door_y;
    lp[2] = lv.kx;
    lp[3] = lv.ky;
    nx = lv.x;
    ny = lv.y;
    nd = lv.dir;
    ncnt = 0;
    nct = kEmpty;
    ncc = 0;
    atomicOr(&s.done[0], 1u << e);
  }
  ag[0] = nx;
  ag[1] = ny;
  ag[2] = nd;
  ag[3] = ncnt;
  ag[4] = nct;
  ag[5] = ncc;
  ag[6] = 0;
  ag[7] = 0;
  const ViewFrame f = view_frame(nx, ny, nd, a.V);
  s.frame[e] = int4{f.ox, f.oy, f.f0, f.f1};
  s.carried[e] = pack(nct, ncc, 0);
  a.reward[n] = rew;
  a.term[n] = terminated;
  a.trunc[n] = truncated;
}

// The finished envs' rows, one thread per cell.
__device__ __forceinline__ void regenerate(const Args& a, const Tile& s, int tid,
                                           int nthreads) {
  const int W = a.W, H = a.H, WH = W * H;
  const unsigned finished = s.done[0];
  for (int c = tid; c < WH; c += nthreads) {
    const int lx = c / H;
    const int ly = c - lx * H;
    for (unsigned m = finished; m; m &= m - 1) {
      const int e = __ffs(m) - 1;
      const int* lp = s.level + 4 * e;
      const Level lv{lp[0], lp[1], lp[2], lp[3], 0, 0, 0};
      s.grid[e * WH + c] = level_cell(lv, a.gen, lx, ly, W, H);
    }
  }
}

__device__ __forceinline__ void write_rows(const Args& a, const Tile& s, int n0, int nt,
                                           int tid, int nthreads) {
  const int WH = a.W * a.H;
  store_words(a.ngrid + n0 * WH, s.grid, nt * WH, a.vec, tid, nthreads);
  store_words(a.nagent + n0 * kAgentWidth, s.agent, nt * kAgentWidth, a.vec, tid,
              nthreads);
}

// View cell (vi, vj) of tile env e, the carried object at the agent's cell
// (before occlusion, as the JAX kernel has it).
__device__ __forceinline__ int view_cell(const Args& a, const int* g, const ViewFrame& f,
                                         int carried, int V, int vi, int vj) {
  if (vi == V / 2 && vj == V - 1) return carried;
  return view_word(g, a.W, a.H, f, vi, vj);
}

__device__ __forceinline__ ViewFrame frame_of(const Tile& s, int e) {
  const int4 f = s.frame[e];
  return ViewFrame{f.x, f.y, f.z, f.w};
}

// One thread per (env, view column j): the column's transparency word, bit
// i for view cell (i, j).
template <int kV>
__device__ __forceinline__ void see_words(const Args& a, const Tile& s, int nt, int tid,
                                          int nthreads) {
  const int V = kV ? kV : a.V;
  const int WH = a.W * a.H;
  for (int col = tid; col < nt * V; col += nthreads) {
    const int e = col / V;
    const int j = col - e * V;
    const ViewFrame f = frame_of(s, e);
    const int carried = s.carried[e];
    const int* g = s.grid + e * WH;
    uint32_t see = 0;
    for (int i = 0; i < V; ++i)
      see |= static_cast<uint32_t>(transparent(view_cell(a, g, f, carried, V, i, j))) << i;
    s.cols[col] = see;
  }
}

// Env e's visibility words from its transparency words, in place
// (view_tile.cuh occlude_columns).
template <int kV>
__device__ __forceinline__ void occlude(const Args& a, const Tile& s, int e) {
  const int V = kV ? kV : a.V;
  occlude_columns(s.cols + e * V, V);
}

// One thread per (env, view column j): the column's cells again, unseen
// ones zeroed, as bytes into the tile's image.
template <int kV>
__device__ __forceinline__ void image_bytes(const Args& a, const Tile& s, int nt, int tid,
                                           int nthreads) {
  const int V = kV ? kV : a.V;
  const int WH = a.W * a.H;
  for (int col = tid; col < nt * V; col += nthreads) {
    const int e = col / V;
    const int j = col - e * V;
    const ViewFrame f = frame_of(s, e);
    const int carried = s.carried[e];
    const int* g = s.grid + e * WH;
    const uint32_t vis = a.see_through ? ~0u : s.cols[col];
    uint8_t* px = s.image + 3 * (e * V * V + j);
    for (int i = 0; i < V; ++i) {
      const int cell = (vis >> i) & 1u ? view_cell(a, g, f, carried, V, i, j) : 0;
      px[3 * V * i] = static_cast<uint8_t>(cell & 0xFF);
      px[3 * V * i + 1] = static_cast<uint8_t>((cell >> 8) & 0xFF);
      px[3 * V * i + 2] = static_cast<uint8_t>((cell >> 16) & 0xFF);
    }
  }
}

// ---- the kernel: the phases between barriers ----------------------------------

template <int kV>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const __grid_constant__ Args a) {
  extern __shared__ int4 smem[];
  const int V = kV ? kV : a.V;
  const Tile s = carve(smem, a.W * a.H, V);
  const int n0 = blockIdx.x * kTile;
  const int nt = min(kTile, a.N - n0);
  const int tid = threadIdx.x;
  stage_in(a, s, n0, nt, tid, kThreads);
  async_wait_all();
  __syncthreads();
  if (tid < nt) step_env(a, s, n0, tid);
  if (blockIdx.x == 0 && tid == kThreads - 1) write_key(a);  // in an idle warp
  __syncthreads();
  if (s.done[0]) {  // the same word for the whole block
    regenerate(a, s, tid, kThreads);
    __syncthreads();
  }
  write_rows(a, s, n0, nt, tid, kThreads);
  if (!a.see_through) {  // the same flag for the whole block
    see_words<kV>(a, s, nt, tid, kThreads);
    __syncthreads();
    if (tid < nt) occlude<kV>(a, s, tid);
    __syncthreads();
  }
  image_bytes<kV>(a, s, nt, tid, kThreads);
  __syncthreads();
  store_bytes(a.image + n0 * V * V * 3, s.image, nt * V * V * 3, a.vec, tid, kThreads);
}

template <int kV>
cudaError_t launch(const Args& a, int bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_step_kernel<kV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((a.N + kTile - 1) / kTile);
  fused_step_kernel<kV><<<blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// grid int32[N, W, H], agent int32[N, 8], action int32[N], key int64[2],
// t int32[] -> ngrid int32[N, W, H], nagent int32[N, 8], image
// uint8[N, V, V, 3], reward float32[N], term bool[N], trunc bool[N],
// key_out int64[2], t_out int32[]; all contiguous on the current device,
// launched on `stream`.  neg_k is -K of the reward; gen is 0 DoorKey,
// 1 Empty with the start (sx, sy, sdir), 2 Empty with a random start.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue,
// without launching, for a view or a tile that the kernel does not take.
extern "C" int fused_step(const void* grid, const void* agent, const void* action,
                          const void* key, const void* t, void* ngrid, void* nagent,
                          void* image, void* reward, void* term, void* trunc,
                          void* key_out, void* t_out, int N, int W, int H, int V,
                          int max_steps, float neg_k, int see_through, int gen,
                          int sx, int sy, int sdir, void* stream) {
  if (V < 3 || V > kMaxView || V % 2 == 0 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = tile_bytes(W * H, V);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(grid) && aligned16(agent) && aligned16(action) &&
                   aligned16(ngrid) && aligned16(nagent) && aligned16(image);
  const Args a{static_cast<const int*>(grid), static_cast<const int*>(agent),
               static_cast<const int*>(action), static_cast<const long long*>(key),
               static_cast<const int*>(t), static_cast<int*>(ngrid),
               static_cast<int*>(nagent), static_cast<uint8_t*>(image),
               static_cast<float*>(reward), static_cast<bool*>(term),
               static_cast<bool*>(trunc), static_cast<long long*>(key_out),
               static_cast<int*>(t_out), N, W, H, V, max_steps, neg_k, see_through,
               gen, sx, sy, sdir, vec};
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(V == 7 ? launch<7>(a, bytes, s) : launch<0>(a, bytes, s));
}
