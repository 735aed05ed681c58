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
// 0x602.  The rotation is folded into the coordinates: one thread per
// (env, view cell) gets it for free.
//
// Bound on an H100 at the main path's shapes (B=4096, 8x8 grid, V=7): per
// env 12 bytes of pose read, at most 49 grid words read and 49 words
// written, about 1.6 MB in all, i.e. about 0.5 us at 3.35 TB/s.  The
// kernel is therefore bound by launch latency, not by memory.  This is the
// simple correct version: neighbouring threads write neighbouring output
// words, and the grid reads hit the same few cache lines per env.  Staging
// each env's grid in shared memory is later work if the card asks for it.
//
// The Pallas kernel's lane blocking, barrel shift, VMEM budget and
// 128-multiple batch constraint are TPU layout workarounds and are not
// carried over; this kernel takes any B.

#include <cuda_runtime.h>

namespace {

constexpr int kWallPacked = 2 | (6 << 8);  // wall, grey, state 0
constexpr int kThreads = 256;

__global__ void obs_gather_kernel(const int* __restrict__ grid,
                                  const int* __restrict__ pos,
                                  const int* __restrict__ dir,
                                  int* __restrict__ out,
                                  int B, int W, int H, int V) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int vv = V * V;
  if (t >= static_cast<long long>(B) * vv) return;
  const int b = static_cast<int>(t / vv);
  const int c = static_cast<int>(t - static_cast<long long>(b) * vv);
  const int vi = c / V;
  const int vj = c - vi * V;

  const int d = dir[b];
  const int f0 = d == 0 ? 1 : (d == 2 ? -1 : 0);
  const int f1 = d == 1 ? 1 : (d == 3 ? -1 : 0);
  const int r0 = -f1;
  const int r1 = f0;
  const int ahead = V - 1 - vj;
  const int lateral = vi - V / 2;
  const int wx = pos[2 * b] + f0 * ahead + r0 * lateral;
  const int wy = pos[2 * b + 1] + f1 * ahead + r1 * lateral;

  int word = kWallPacked;
  if (wx >= 0 && wx < W && wy >= 0 && wy < H) {
    word = grid[static_cast<long long>(b) * W * H + wx * H + wy];
  }
  out[t] = word;
}

}  // namespace

// grid int32[B, W, H], pos int32[B, 2], dir int32[B] -> out int32[B, V, V],
// all contiguous on the current device; launched on `stream`.  Returns
// cudaGetLastError() after the launch.
extern "C" int obs_gather(const void* grid, const void* pos, const void* dir,
                          void* out, int B, int W, int H, int V, void* stream) {
  const long long total = static_cast<long long>(B) * V * V;
  const long long blocks = (total + kThreads - 1) / kThreads;
  obs_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(grid), static_cast<const int*>(pos),
      static_cast<const int*>(dir), static_cast<int*>(out), B, W, H, V);
  return static_cast<int>(cudaGetLastError());
}
