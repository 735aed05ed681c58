// The egocentric observation of every env in one launch: the rotated V x V
// window, and on request its occlusion, the carried object and the encoding.
//
// Replaces minigrid_tpu/ops/obs_pallas.py::_make_kernel (driven by
// gather_view_pallas_packed) together with the rotation epilogue that
// function runs after the Pallas call, and the occlusion, overlay and encode
// that minigrid_tpu/core/obs.py runs around it (gen_obs_grid, gen_obs).  For
// view cell (vi, vj) of env b the world cell is
//
//     wx = px + f0 * (V-1-vj) + r0 * (vi - V/2)
//     wy = py + f1 * (V-1-vj) + r1 * (vi - V/2)
//
// with f = DIR_TO_VEC[dir] and r = (-f1, f0) (core/obs.py
// view_world_coords); an out-of-bounds cell reads as the packed grey wall
// 0x602.  Three modes, each bitwise the port's plain path (core/obs.py):
//
//   kWindow  out int32[B, V, V]: the packed window (gather_view);
//   kImage   out uint8[B, V, V, 3]: the image (gen_obs_batch): the window's
//            occlusion (process_vis), then the carried object at the
//            agent's cell (V/2, V-1), unseen cells (0, 0, 0);
//   kGrid    out int32[B, V, V] the window with the carried object and vis
//            bool[B, V, V] its occlusion mask (gen_obs_grid_batch).
//
// As in the reference, the occlusion reads the window before the carried
// object is written into it.  see_through (see_through_walls) skips the
// occlusion: every cell is seen.
//
// Bound on an H100 at the main path's shapes (B=4096, 8x8 grid, V=7), image
// mode: per env 15 bytes of pose, direction and carried triple read, the
// in-bounds window words read (at most 49, about 24 in a walked DoorKey-8x8
// batch) and 147 bytes written, about 1.06 MB, 0.32 us at 3.35 TB/s: bytes
// bind (about 17 integer operations a view cell for the window, 6 for its
// transparency and the output, and 20 a column for the occlusion: 1,400 an
// env, 0.17 us at 33.5 TOP/s).  Window mode: 12 bytes of pose read and 196
// written an env, about 1.25 MB, 0.37 us.
//
// Design, the tile structure of fused_step.cu (view_tile.cuh): a block of
// kThreads threads owns kTile consecutive envs.  It copies the tile's grid
// rows (one contiguous span), poses, directions and carried triples into
// shared memory with cp.async, all issued before any is awaited.  In window
// mode one thread per (env, view row) then computes the view's frame once
// (the world cell of view cell (0, 0) and the facing vector, the rotation
// folded in), reads the row's V cells from the shared copy and writes them
// as V consecutive words.  Otherwise the phases of fused_step.cu's
// observation follow, each between two barriers: one thread per (env, view
// column) builds the column's transparency word; one thread per env runs the
// occlusion over its V words (view_tile.cuh occlude_columns); one thread per
// (env, view column) writes the column's cells, the carried object and the
// mask into the tile's output in shared memory, which leaves in 16-byte
// stores.  So no thread waits on a chain of loads from device memory, and
// device memory is read once and written once.  The tile takes
// 128 * (W*H + 3) bytes of shared memory in window mode, 8,576 at 8x8, and
// 32 * (4 V + 3 V*V + 3) more for the image (5,696 at V=7) or
// 32 * (4 V + 5 V*V + 3) more for the window and its mask; the wrapper
// refuses what exceeds 227 KB.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA events over CUDA-graph
// replays) at B=4096, 8x8, V=7, window mode: 2.4 us, against 2.6 us for one
// thread per (env, view cell), the design the tile replaced, 5.2 us for
// torch.gather over precomputed indices, and 1.4 us for an empty launch of
// this kernel: what is left above the launch is one round trip to memory
// and the stores.

// The Pallas kernel's lane blocking, barrel shift, VMEM budget and
// 128-multiple batch constraint are TPU layout workarounds and are not
// carried over; this kernel takes any B.

#include <cuda_runtime.h>
#include <stdint.h>

#include "view_tile.cuh"

namespace {

using namespace view_tile;

constexpr int kTile = 32;  // envs a block owns
constexpr int kThreads = 256;
constexpr int kMaxView = 31;  // a view column is one 32-bit word
constexpr int kWindow = 0;
constexpr int kImage = 1;
constexpr int kGrid = 2;
static_assert(kTile % 16 == 0, "16-byte aligned spans");

struct Args {
  const int* grid;
  const int* pos;
  const int* dir;
  const uint8_t* carrying;  // uint8[B, 3]; not read in window mode
  void* out;                // int32[B, V, V], or uint8[B, V, V, 3] in image mode
  bool* vis;                // bool[B, V, V] in grid mode
  int B, W, H, V, mode, see_through;
  int vec;  // every tensor 16-byte aligned: the tile copies move 16 bytes
};

__host__ __device__ inline int tile_bytes(int WH, int V, int mode) {
  return 4 * kTile * (WH + 3) + (mode > 0) * kTile * (4 * V + (1 + 2 * mode) * V * V + 3);
}

// A block's tile in shared memory.  Each segment holds kTile rows, so each
// starts 16-byte aligned.
struct Tile {
  int* grid;          // [kTile, W*H]
  int* pos;           // [kTile, 2]
  int* dir;           // [kTile]
  uint32_t* cols;     // [kTile, V] transparency, then visibility, words
  uint8_t* image;     // [kTile, V*V*3] (image mode)
  int* cells;         // [kTile, V*V] (grid mode), the same bytes as `image`
  uint8_t* vis;       // [kTile, V*V] (grid mode)
  uint8_t* carrying;  // [kTile, 3]
};

__device__ __forceinline__ Tile carve(void* base, int WH, int V, int mode) {
  Tile s;
  s.grid = static_cast<int*>(base);
  s.pos = s.grid + kTile * WH;
  s.dir = s.pos + 2 * kTile;
  s.cols = reinterpret_cast<uint32_t*>(s.dir + kTile);
  s.cells = reinterpret_cast<int*>(s.cols + kTile * V);
  s.image = reinterpret_cast<uint8_t*>(s.cells);
  s.vis = reinterpret_cast<uint8_t*>(s.cells + kTile * V * V);
  s.carrying = s.image + (1 + 2 * mode) * kTile * V * V;
  return s;
}

__device__ __forceinline__ ViewFrame frame_of(const Tile& s, int e, int V) {
  return view_frame(s.pos[2 * e], s.pos[2 * e + 1], s.dir[e], V);
}

// ---- the phases; `nt` is the tile's env count (kTile but for the last) ------

// Window mode, one thread per (env, view row i) of the staged tile: the
// row's V cells, written to `out` ([nt, V, V] in device memory) as V
// consecutive words.
template <int kV>
__device__ __forceinline__ void gather_rows(const Args& a, const Tile& s, int* out, int nt,
                                            int tid, int nthreads) {
  const int V = kV ? kV : a.V;
  const int WH = a.W * a.H;
  for (int row = tid; row < nt * V; row += nthreads) {
    const int e = row / V;
    const int i = row - e * V;
    const ViewFrame f = frame_of(s, e, V);
    const int* ge = s.grid + e * WH;
    int* o = out + row * V;
    for (int j = 0; j < V; ++j) o[j] = view_word(ge, a.W, a.H, f, i, j);
  }
}

// One thread per (env, view column j): the column's transparency word, bit
// i for view cell (i, j) of the window.
template <int kV>
__device__ __forceinline__ void see_words(const Args& a, const Tile& s, int nt, int tid,
                                          int nthreads) {
  const int V = kV ? kV : a.V;
  const int WH = a.W * a.H;
  for (int col = tid; col < nt * V; col += nthreads) {
    const int e = col / V;
    const int j = col - e * V;
    const ViewFrame f = frame_of(s, e, V);
    const int* g = s.grid + e * WH;
    uint32_t see = 0;
    for (int i = 0; i < V; ++i)
      see |= static_cast<uint32_t>(transparent(view_word(g, a.W, a.H, f, i, j))) << i;
    s.cols[col] = see;
  }
}

// One thread per (env, view column j): the column's cells, the carried
// object at the agent's cell, into the tile's output: in image mode each
// cell's three bytes, an unseen one zero; in grid mode each cell's word and
// whether it is seen.
template <int kV>
__device__ __forceinline__ void view_cells(const Args& a, const Tile& s, int nt, int tid,
                                           int nthreads) {
  const int V = kV ? kV : a.V;
  const int WH = a.W * a.H;
  for (int col = tid; col < nt * V; col += nthreads) {
    const int e = col / V;
    const int j = col - e * V;
    const ViewFrame f = frame_of(s, e, V);
    const int* g = s.grid + e * WH;
    const uint8_t* c = s.carrying + 3 * e;
    const int carried = c[0] | (c[1] << 8) | (c[2] << 16);
    const uint32_t seen = a.see_through ? ~0u : s.cols[col];
    for (int i = 0; i < V; ++i) {
      const int cell = (i == V / 2 && j == V - 1) ? carried : view_word(g, a.W, a.H, f, i, j);
      const bool vis = (seen >> i) & 1u;
      const int k = (e * V + i) * V + j;
      if (a.mode == kImage) {
        const int w = vis ? cell : 0;
        s.image[3 * k] = static_cast<uint8_t>(w & 0xFF);
        s.image[3 * k + 1] = static_cast<uint8_t>((w >> 8) & 0xFF);
        s.image[3 * k + 2] = static_cast<uint8_t>((w >> 16) & 0xFF);
      } else {
        s.cells[k] = cell;
        s.vis[k] = vis;
      }
    }
  }
}

// The tile's output to device memory in 16-byte stores.
__device__ __forceinline__ void store_view(const Args& a, const Tile& s, int n0, int nt,
                                           int V, int tid, int nthreads) {
  const int VV = V * V;
  if (a.mode == kImage) {
    store_bytes(static_cast<uint8_t*>(a.out) + n0 * VV * 3, s.image, nt * VV * 3, a.vec, tid,
                nthreads);
  } else {
    store_words(static_cast<int*>(a.out) + n0 * VV, s.cells, nt * VV, a.vec, tid, nthreads);
    store_bytes(reinterpret_cast<uint8_t*>(a.vis) + n0 * VV, s.vis, nt * VV, a.vec, tid,
                nthreads);
  }
}

// ---- the kernel: the phases between barriers ----------------------------------

template <int kV>
__global__ void __launch_bounds__(kThreads) obs_gather_kernel(const __grid_constant__ Args a) {
  extern __shared__ int4 smem[];
  const int V = kV ? kV : a.V;
  const int WH = a.W * a.H;
  const Tile s = carve(smem, WH, V, a.mode);
  const int n0 = blockIdx.x * kTile;
  const int nt = min(kTile, a.B - n0);
  const int tid = threadIdx.x;
  stage_words(s.grid, a.grid + n0 * WH, nt * WH, a.vec, tid, kThreads);
  stage_words(s.pos, a.pos + 2 * n0, 2 * nt, a.vec, tid, kThreads);
  stage_words(s.dir, a.dir + n0, nt, a.vec, tid, kThreads);
  if (a.mode != kWindow)
    stage_bytes(s.carrying, a.carrying + 3 * n0, 3 * nt, a.vec, tid, kThreads);
  async_wait_all();
  __syncthreads();
  if (a.mode == kWindow) {  // the same mode for the whole grid
    gather_rows<kV>(a, s, static_cast<int*>(a.out) + n0 * V * V, nt, tid, kThreads);
    return;
  }
  if (!a.see_through) {  // the same flag for the whole grid
    see_words<kV>(a, s, nt, tid, kThreads);
    __syncthreads();
    if (tid < nt) occlude_columns(s.cols + tid * V, V);
    __syncthreads();
  }
  view_cells<kV>(a, s, nt, tid, kThreads);
  __syncthreads();
  store_view(a, s, n0, nt, V, tid, kThreads);
}

template <int kV>
cudaError_t launch(const Args& a, int bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        obs_gather_kernel<kV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((a.B + kTile - 1) / kTile);
  obs_gather_kernel<kV><<<blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// grid int32[B, W, H], pos int32[B, 2], dir int32[B], carrying uint8[B, 3]
// (image and grid modes) -> out, and vis in grid mode, as the modes above
// say; all contiguous on the current device, launched on `stream`.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue, without
// launching, for a mode, a view or a tile that the kernel does not take.
extern "C" int obs_gather(const void* grid, const void* pos, const void* dir,
                          const void* carrying, void* out, void* vis, int B, int W, int H,
                          int V, int mode, int see_through, void* stream) {
  const int bytes = tile_bytes(W * H, V, mode);
  if (B < 1 || V < 1 || mode < kWindow || mode > kGrid || (mode != kWindow && V > kMaxView) ||
      bytes > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(grid) && aligned16(pos) && aligned16(dir) && aligned16(out) &&
                   (mode == kWindow || aligned16(carrying)) && (mode != kGrid || aligned16(vis));
  const Args a{static_cast<const int*>(grid), static_cast<const int*>(pos),
               static_cast<const int*>(dir), static_cast<const uint8_t*>(carrying), out,
               static_cast<bool*>(vis), B, W, H, V, mode, see_through, vec};
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(V == 7 ? launch<7>(a, bytes, s) : launch<0>(a, bytes, s));
}
