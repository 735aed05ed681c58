// Egocentric-window gather: the rotated V x V view of every env, packed.
//
// Replaces minigrid_tpu/ops/obs_pallas.py::_make_kernel (driven by
// gather_view_pallas_packed) together with the rotation epilogue that
// function runs after the Pallas call.  Output is bitwise what
// gather_view_pallas_packed returns, as int32: for view cell (vi, vj) of env
// b the world cell is
//
//     wx = px + f0 * (V-1-vj) + r0 * (vi - V/2)
//     wy = py + f1 * (V-1-vj) + r1 * (vi - V/2)
//
// with f = DIR_TO_VEC[dir] and r = (-f1, f0) (core/obs.py
// view_world_coords); an out-of-bounds cell reads as the packed grey wall
// 0x602.
//
// Bound on an H100 at the main path's shapes (B=4096, 8x8 grid, V=7): per
// env 12 bytes of pose read, the in-bounds window words read (at most 49)
// and 49 words written, about 1.25 MB, 0.374 us at 3.35 TB/s: bytes bind
// (about 17 integer operations a view cell, 0.1 us at 33.5 TOP/s).
//
// Design, the tile structure of fused_step.cu (view_tile.cuh): a block of
// kThreads threads owns kTile consecutive envs.  It copies the tile's grid
// rows (one contiguous span), poses and directions into shared memory with
// cp.async, all issued before any is awaited; then one thread per (env,
// view row) computes the view's frame once (the world cell of view cell
// (0, 0) and the facing vector, the rotation folded in), reads the row's V
// cells from the shared copy and writes them as V consecutive words, with
// 32-bit index arithmetic.  So no thread waits on a chain of loads from
// device memory (the pose, then the grid word, as one thread per view cell
// did), and a warp's stores cover a contiguous span of the output.  The
// tile takes 128 * (W*H + 3) bytes of shared memory, 8,576 at 8x8; the
// wrapper refuses what exceeds 227 KB.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA events over CUDA-graph
// replays) at B=4096, 8x8, V=7: 2.4 us, against 2.6 us for one thread per
// (env, view cell), the design this replaces, 5.2 us for torch.gather over
// precomputed indices, and 1.4 us for an empty launch of this kernel: what
// is left above the launch is one round trip to memory and the stores.

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
static_assert(kTile % 16 == 0, "16-byte aligned spans");

struct Args {
  const int* grid;
  const int* pos;
  const int* dir;
  int* out;
  int B, W, H, V;
  int vec;  // every tensor 16-byte aligned: the tile copies move 16 bytes
};

__host__ __device__ inline int tile_bytes(int WH) {
  return 4 * kTile * (WH + 3);
}

// One thread per (env, view row i) of the staged tile (grid [kTile, W*H],
// pos [kTile, 2], dir [kTile]): the row's V cells, written to `out`
// ([nt, V, V] in device memory) as V consecutive words.
template <int kV>
__device__ __forceinline__ void gather_rows(const Args& a, const int* g, const int* pos,
                                            const int* dir, int* out, int nt, int tid,
                                            int nthreads) {
  const int V = kV ? kV : a.V;
  const int WH = a.W * a.H;
  for (int row = tid; row < nt * V; row += nthreads) {
    const int e = row / V;
    const int i = row - e * V;
    const ViewFrame f = view_frame(pos[2 * e], pos[2 * e + 1], dir[e], V);
    const int* ge = g + e * WH;
    int* o = out + row * V;
    for (int j = 0; j < V; ++j) o[j] = view_word(ge, a.W, a.H, f, i, j);
  }
}

template <int kV>
__global__ void __launch_bounds__(kThreads) obs_gather_kernel(const __grid_constant__ Args a) {
  extern __shared__ int4 smem[];
  const int V = kV ? kV : a.V;
  const int WH = a.W * a.H;
  int* g = reinterpret_cast<int*>(smem);
  int* pos = g + kTile * WH;
  int* dir = pos + 2 * kTile;
  const int n0 = blockIdx.x * kTile;
  const int nt = min(kTile, a.B - n0);
  const int tid = threadIdx.x;
  stage_words(g, a.grid + n0 * WH, nt * WH, a.vec, tid, kThreads);
  stage_words(pos, a.pos + 2 * n0, 2 * nt, a.vec, tid, kThreads);
  stage_words(dir, a.dir + n0, nt, a.vec, tid, kThreads);
  async_wait_all();
  __syncthreads();
  gather_rows<kV>(a, g, pos, dir, a.out + n0 * V * V, nt, tid, kThreads);
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

// grid int32[B, W, H], pos int32[B, 2], dir int32[B] -> out int32[B, V, V],
// all contiguous on the current device; launched on `stream`.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue, without
// launching, for a tile that does not fit in shared memory.
extern "C" int obs_gather(const void* grid, const void* pos, const void* dir,
                          void* out, int B, int W, int H, int V, void* stream) {
  const int bytes = tile_bytes(W * H);
  if (B < 1 || V < 1 || bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(grid), static_cast<const int*>(pos),
               static_cast<const int*>(dir), static_cast<int*>(out), B, W, H, V,
               aligned16(grid) && aligned16(pos) && aligned16(dir) && aligned16(out)};
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(V == 7 ? launch<7>(a, bytes, s) : launch<0>(a, bytes, s));
}
