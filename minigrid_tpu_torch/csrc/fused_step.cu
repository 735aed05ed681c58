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
// h(k, 0, 1)), h the threefry2x32 hash of a counter pair; the draw
// randint(sub, (N, 8), 0, 2^24) has a zero multiplier at that span, so draw
// j of env n is (h0 ^ h1) & 0xFFFFFF of h(h(sub, 0, 1), 0, n*8 + j).  Each
// thread computes the draws it reads (columns 0-4) only when its env is
// done, and thread 0 writes k_next and t + 1.  The key is read from device
// memory, so a step needs no copy to the host.
//
// One thread per env.  Occlusion runs on the thread's own column words
// (bit i of word j = view cell (i, j)): the reference's two in-row sweeps
// per row, bottom-up, as the JAX kernel unrolls them.  The view is gathered
// twice, once for the transparency words and once for the image, so no
// thread holds V*V cells.
//
// Bound on an H100 at DoorKey-8x8, B=4096, V=7: per env it must read the
// grid (256 B, only the front cell for a finished env), the agent row and
// the action (36 B), and write the grid, the agent row, the image (147 B),
// the reward and the two flags (445 B in all): about 3.0 MB, 0.9 us at
// 3.35 TB/s.  Its integer work is a few thousand operations per env (the
// view and the occlusion sweeps, plus five threefry hashes of 20 rounds
// for a finished env), about 0.2-0.4 us at 33.5 TOP/s: bytes bind.  This
// version is simple and right first: each thread walks its own 256-byte grid
// row, so a warp's loads do not coalesce, and they are served from L1/L2.
// With 32 threads a block, B=4096 spreads over 128 SMs.
//
// The Pallas kernel's [BLK, LANES] lane layout, pad lanes, masked-reduce
// reads and the TPU PRNG mode are TPU workarounds and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// minigrid_tpu_torch/core/constants.py (tests/test_torch_kernels.py holds
// these against the table)
constexpr int kEmpty = 1;
constexpr int kWall = 2;
constexpr int kDoor = 4;
constexpr int kKey = 21;
constexpr int kBall = 22;
constexpr int kGoal = 31;
constexpr int kLava = 32;
constexpr int kOpen = 0;
constexpr int kLocked = 2;
constexpr int kGreen = 2;
constexpr int kYellow = 5;
constexpr int kGrey = 6;

constexpr int kGenDoorKey = 0;
constexpr int kGenEmptyRandom = 2;
constexpr int kMaxView = 31;
constexpr int kThreads = 32;
constexpr uint32_t kParity = 0x1BD11BDA;

__device__ __forceinline__ int pack(int t, int c, int s) {
  return t | (c << 8) | (s << 16);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Threefry-2x32, 20 rounds, of the counter pair (c0, c1) under (k0, k1):
// minigrid_tpu_torch/core/rng.py::threefry2x32.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t c0,
                                         uint32_t c1, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  o0 = x0;
  o1 = x1;
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

// View cell (vi, vj) of the new grid row `g`, the carried object at the
// agent's cell.
__device__ __forceinline__ int view_cell(const int* g, int W, int H, int V, int x,
                                         int y, int f0, int f1, int vi, int vj,
                                         int carried) {
  if (vi == V / 2 && vj == V - 1) return carried;
  const int ahead = V - 1 - vj;
  const int lateral = vi - V / 2;
  const int wx = x + f0 * ahead - f1 * lateral;
  const int wy = y + f1 * ahead + f0 * lateral;
  if (wx < 0 || wx >= W || wy < 0 || wy >= H) return pack(kWall, kGrey, 0);
  return g[wx * H + wy];
}

template <int kV>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const int* __restrict__ grid, const int* __restrict__ agent,
                  const int* __restrict__ action, const long long* __restrict__ key,
                  const int* __restrict__ t_in, int* __restrict__ ngrid,
                  int* __restrict__ nagent, uint8_t* __restrict__ image,
                  float* __restrict__ reward, bool* __restrict__ term,
                  bool* __restrict__ trunc, long long* __restrict__ key_out,
                  int* __restrict__ t_out, int N, int W, int H, int v_arg,
                  int max_steps, float neg_k, int see_through, int gen, int sx,
                  int sy, int sdir) {
  const int V = kV ? kV : v_arg;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  if (n == 0) {
    uint32_t a0, a1;
    threefry(k0, k1, 0u, 0u, a0, a1);
    key_out[0] = a0;
    key_out[1] = a1;
    t_out[0] = t_in[0] + 1;
  }

  const int* ag = agent + 8ll * n;
  const int x = ag[0], y = ag[1], d = ag[2], cnt = ag[3], ctyp = ag[4], ccol = ag[5];
  const int a = action[n];
  const int WH = W * H;
  const int* g = grid + static_cast<long long>(n) * WH;
  int* ng = ngrid + static_cast<long long>(n) * WH;

  // ---- front cell and action tree -------------------------------------------
  const int fx = x + (d == 0 ? 1 : (d == 2 ? -1 : 0));
  const int fy = y + (d == 1 ? 1 : (d == 3 ? -1 : 0));
  const bool inb = fx >= 0 && fx < W && fy >= 0 && fy < H;
  const int fidx = min(max(fx, 0), W - 1) * H + min(max(fy, 0), H - 1);
  const int fcell = g[fidx];
  const int ftyp = inb ? (fcell & 0xFF) : kWall;
  const int fcol = inb ? ((fcell >> 8) & 0xFF) : 0;
  const int fsta = inb ? ((fcell >> 16) & 0xFF) : 0;

  const bool is_fwd = a == 2, is_pick = a == 3, is_drop = a == 4, is_tog = a == 5;
  int nd = a == 0 ? (d + 3) % 4 : (a == 1 ? (d + 1) % 4 : d);
  const bool can_overlap = ftyp == kEmpty || ftyp == kGoal || ftyp == kLava ||
                           (ftyp == kDoor && fsta == kOpen);
  const bool moved = is_fwd && can_overlap && inb;
  int nx = moved ? fx : x;
  int ny = moved ? fy : y;
  const int cnt2 = cnt + 1;
  const bool hit_goal = is_fwd && ftyp == kGoal;
  const bool terminated = hit_goal || (is_fwd && ftyp == kLava);
  // one rounding, whatever nvcc's contraction settings
  const float rew = hit_goal ? __fmaf_rn(static_cast<float>(cnt2), neg_k, 1.0f) : 0.0f;
  const bool truncated = cnt2 >= max_steps;

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

  // ---- new grid: stepped copy, or the regenerated level ----------------------
  const bool done = terminated || truncated;
  if (!done) {
    for (int i = 0; i < WH; ++i) ng[i] = g[i];
    if (inb) ng[fidx] = pack(new_ftyp, new_fcol, new_fsta);
  } else {
    Level lv{-1, -1, -1, -1, sx, sy, sdir};
    if (gen == kGenDoorKey || gen == kGenEmptyRandom) {
      uint32_t s0, s1, l0, l1;
      threefry(k0, k1, 0u, 1u, s0, s1);  // sub = split(key)[1]
      threefry(s0, s1, 0u, 1u, l0, l1);  // split(sub)[1]: randint's low word
      int r[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        uint32_t h0, h1;
        threefry(l0, l1, 0u, static_cast<uint32_t>(n) * 8u + j, h0, h1);
        r[j] = static_cast<int>((h0 ^ h1) & 0xFFFFFFu);
      }
      if (gen == kGenDoorKey) {
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
    for (int lx = 0; lx < W; ++lx)
      for (int ly = 0; ly < H; ++ly) ng[lx * H + ly] = level_cell(lv, gen, lx, ly, W, H);
    nx = lv.x;
    ny = lv.y;
    nd = lv.dir;
    ncnt = 0;
    nct = kEmpty;
    ncc = 0;
  }

  int* out_ag = nagent + 8ll * n;
  out_ag[0] = nx;
  out_ag[1] = ny;
  out_ag[2] = nd;
  out_ag[3] = ncnt;
  out_ag[4] = nct;
  out_ag[5] = ncc;
  out_ag[6] = 0;
  out_ag[7] = 0;
  reward[n] = rew;
  term[n] = terminated;
  trunc[n] = truncated;

  // ---- view: transparency words, occlusion sweeps, image ---------------------
  const int f0 = nd == 0 ? 1 : (nd == 2 ? -1 : 0);
  const int f1 = nd == 1 ? 1 : (nd == 3 ? -1 : 0);
  const int carried = pack(nct, ncc, 0);
  uint32_t vis[kV ? kV : kMaxView];
  if (!see_through) {
    uint32_t see[kV ? kV : kMaxView];
    for (int j = 0; j < V; ++j) {
      uint32_t word = 0;
      for (int i = 0; i < V; ++i) {
        const int c = view_cell(ng, W, H, V, nx, ny, f0, f1, i, j, carried);
        const int t = c & 0xFF;
        const bool s = t != kWall && (t != kDoor || ((c >> 16) & 0xFF) == kOpen);
        word |= static_cast<uint32_t>(s) << i;
      }
      see[j] = word;
      vis[j] = 0;
    }
    vis[V - 1] = 1u << (V / 2);
    for (int j = V - 1; j >= 0; --j) {
      uint32_t m = vis[j];
      uint32_t prev = 0;
      for (int i = 0; i < V - 1; ++i) {  // left to right
        if ((m & see[j]) >> i & 1u) {
          m |= 1u << (i + 1);
          prev |= 3u << i;  // cells i and i+1 of the row ahead
        }
      }
      for (int i = V - 1; i > 0; --i) {  // right to left
        if ((m & see[j]) >> i & 1u) {
          m |= 1u << (i - 1);
          prev |= 3u << (i - 1);  // cells i-1 and i of the row ahead
        }
      }
      vis[j] = m;
      if (j > 0) vis[j - 1] |= prev;
    }
  }
  uint8_t* img = image + static_cast<long long>(n) * V * V * 3;
  for (int i = 0; i < V; ++i) {
    for (int j = 0; j < V; ++j) {
      int c = view_cell(ng, W, H, V, nx, ny, f0, f1, i, j, carried);
      if (!see_through && !((vis[j] >> i) & 1u)) c = 0;
      uint8_t* px = img + (i * V + j) * 3;
      px[0] = static_cast<uint8_t>(c & 0xFF);
      px[1] = static_cast<uint8_t>((c >> 8) & 0xFF);
      px[2] = static_cast<uint8_t>((c >> 16) & 0xFF);
    }
  }
}

template <int kV>
void launch(unsigned blocks, cudaStream_t stream, const void* grid, const void* agent,
            const void* action, const void* key, const void* t, void* ngrid,
            void* nagent, void* image, void* reward, void* term, void* trunc,
            void* key_out, void* t_out, int N, int W, int H, int V, int max_steps,
            float neg_k, int see_through, int gen, int sx, int sy, int sdir) {
  fused_step_kernel<kV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(grid), static_cast<const int*>(agent),
      static_cast<const int*>(action), static_cast<const long long*>(key),
      static_cast<const int*>(t), static_cast<int*>(ngrid), static_cast<int*>(nagent),
      static_cast<uint8_t*>(image), static_cast<float*>(reward),
      static_cast<bool*>(term), static_cast<bool*>(trunc),
      static_cast<long long*>(key_out), static_cast<int*>(t_out), N, W, H, V,
      max_steps, neg_k, see_through, gen, sx, sy, sdir);
}

}  // namespace

// grid int32[N, W, H], agent int32[N, 8], action int32[N], key int64[2],
// t int32[] -> ngrid int32[N, W, H], nagent int32[N, 8], image
// uint8[N, V, V, 3], reward float32[N], term bool[N], trunc bool[N],
// key_out int64[2], t_out int32[]; all contiguous on the current device,
// launched on `stream`.  neg_k is -K of the reward; gen is 0 DoorKey,
// 1 Empty with the start (sx, sy, sdir), 2 Empty with a random start.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_step(const void* grid, const void* agent, const void* action,
                          const void* key, const void* t, void* ngrid, void* nagent,
                          void* image, void* reward, void* term, void* trunc,
                          void* key_out, void* t_out, int N, int W, int H, int V,
                          int max_steps, float neg_k, int see_through, int gen,
                          int sx, int sy, int sdir, void* stream) {
  if (V < 3 || V > kMaxView || V % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  auto* s = static_cast<cudaStream_t>(stream);
  if (V == 7) {
    launch<7>(blocks, s, grid, agent, action, key, t, ngrid, nagent, image, reward,
              term, trunc, key_out, t_out, N, W, H, V, max_steps, neg_k, see_through,
              gen, sx, sy, sdir);
  } else {
    launch<0>(blocks, s, grid, agent, action, key, t, ngrid, nagent, image, reward,
              term, trunc, key_out, t_out, N, W, H, V, max_steps, neg_k, see_through,
              gen, sx, sy, sdir);
  }
  return static_cast<int>(cudaGetLastError());
}
