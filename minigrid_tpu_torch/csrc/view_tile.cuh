// Device code shared by the window kernels (obs_gather.cu, fused_step.cu):
// the tile of envs that a block owns, the copies of a tile's contiguous
// spans between device memory and shared memory, the rotated view's
// coordinates and the view's occlusion.
//
// A block owns a tile of consecutive envs; each kernel sets the tile's size
// (kTile), a multiple of 16, so that every per-env span of a tile (grid rows
// of W*H words, agent rows, poses, views of V*V words, images of V*V*3
// bytes) starts 16-byte aligned whenever the tensor does, odd W*H and V
// included.  The copies move 16 bytes a thread when the caller says every
// base pointer is 16-byte aligned (`vec`); a ragged tail, or a misaligned
// tensor, goes word by word.  No copy reads or writes past the tile's last
// env.

#pragma once

#include <stdint.h>

namespace view_tile {

// minigrid_tpu_torch/core/constants.py (tests/test_torch_kernels.py holds
// these against the table)
constexpr int kWall = 2;
constexpr int kDoor = 4;
constexpr int kGrey = 6;
constexpr int kOpen = 0;
constexpr int kWallPacked = kWall | (kGrey << 8);  // the grey wall, state 0

// Start an asynchronous copy of 16 (or 4) bytes from device memory into
// shared memory (cp.async: no register holds the data on the way).  The
// copies land at async_wait_all(); a __syncthreads() after it publishes
// them to the block.
__device__ __forceinline__ void copy16_async(void* smem_dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
#else
  *static_cast<int4*>(smem_dst) = *static_cast<const int4*>(src);
#endif
}

__device__ __forceinline__ void copy4_async(void* smem_dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
#else
  *static_cast<int*>(smem_dst) = *static_cast<const int*>(src);
#endif
}

__device__ __forceinline__ void async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Thread `tid` of `nthreads` starts its share of copying `count` words from
// device memory at `src` into shared memory at `dst`.
__device__ __forceinline__ void stage_words(int* dst, const int* src, int count, bool vec,
                                            int tid, int nthreads) {
  int head = 0;
  if (vec) {
    head = count & ~3;
    for (int i = 4 * tid; i < head; i += 4 * nthreads) copy16_async(dst + i, src + i);
  }
  for (int i = head + tid; i < count; i += nthreads) copy4_async(dst + i, src + i);
}

// The same for `count` bytes; a tail that is not a whole 16 bytes is copied
// byte by byte, at once.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src, int count,
                                            bool vec, int tid, int nthreads) {
  int head = 0;
  if (vec) {
    head = count & ~15;
    for (int i = 16 * tid; i < head; i += 16 * nthreads) copy16_async(dst + i, src + i);
  }
  for (int i = head + tid; i < count; i += nthreads) dst[i] = src[i];
}

// Thread `tid`'s share of writing `count` words from shared memory at `src`
// to device memory at `dst`.
__device__ __forceinline__ void store_words(int* dst, const int* src, int count, bool vec,
                                            int tid, int nthreads) {
  int head = 0;
  if (vec) {
    head = count & ~3;
    for (int i = 4 * tid; i < head; i += 4 * nthreads)
      *reinterpret_cast<int4*>(dst + i) = *reinterpret_cast<const int4*>(src + i);
  }
  for (int i = head + tid; i < count; i += nthreads) dst[i] = src[i];
}

// The same for `count` bytes.
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint8_t* src, int count,
                                            bool vec, int tid, int nthreads) {
  int head = 0;
  if (vec) {
    head = count & ~15;
    for (int i = 16 * tid; i < head; i += 16 * nthreads)
      *reinterpret_cast<int4*>(dst + i) = *reinterpret_cast<const int4*>(src + i);
  }
  for (int i = head + tid; i < count; i += nthreads) dst[i] = src[i];
}

// The view's frame for an agent at (x, y) facing d: the world cell of view
// cell (0, 0) and f = DIR_TO_VEC[d].  View cell (vi, vj) lies at
//
//     wx = x + f0 * (V-1-vj) - f1 * (vi - V/2) = ox - f1 * vi - f0 * vj
//     wy = y + f1 * (V-1-vj) + f0 * (vi - V/2) = oy + f0 * vi - f1 * vj
//
// with the right vector (-f1, f0) and the agent at view cell (V/2, V-1)
// (core/obs.py view_world_coords).
struct ViewFrame {
  int ox, oy, f0, f1;
};

__device__ __forceinline__ ViewFrame view_frame(int x, int y, int d, int V) {
  const int f0 = d == 0 ? 1 : (d == 2 ? -1 : 0);
  const int f1 = d == 1 ? 1 : (d == 3 ? -1 : 0);
  return ViewFrame{x + f0 * (V - 1) + f1 * (V / 2), y + f1 * (V - 1) - f0 * (V / 2), f0,
                   f1};
}

// The packed word at view cell (vi, vj) of the grid row `g` (x-major,
// W x H), or the grey wall outside the grid.
__device__ __forceinline__ int view_word(const int* g, int W, int H, const ViewFrame& f,
                                         int vi, int vj) {
  const int wx = f.ox - f.f1 * vi - f.f0 * vj;
  const int wy = f.oy + f.f0 * vi - f.f1 * vj;
  return (wx < 0 || wx >= W || wy < 0 || wy >= H) ? kWallPacked : g[wx * H + wy];
}

// ---- occlusion (core/obs.py process_vis) --------------------------------------
//
// A view column is one word: bit i of word j is view cell (i, j), so V is at
// most 31.

// Whether a packed cell lets the view through: every type of the table
// core/constants.py SEE_BEHIND but the wall, and a door only when open.
__device__ __forceinline__ bool transparent(int cell) {
  const int t = cell & 0xFF;
  return t != kWall && (t != kDoor || ((cell >> 16) & 0xFF) == kOpen);
}

// The reference's left-to-right sweep of one row (core/obs.py
// process_vis): for i = 0 .. V-2, a reached transparent cell i reaches
// cell i+1 and marks cells i and i+1 of the row ahead.  Without the loop:
// the carry of (m & see) + see runs through each run of transparent cells
// above a reached one and stops on the first opaque cell, which it reaches
// too.  Returns the cells reached; `ahead` gains the cells marked.
__device__ __forceinline__ uint32_t sweep_up(uint32_t m, uint32_t see, int V,
                                             uint32_t& ahead) {
  const uint32_t row = (1u << V) - 1u;
  m = (m | (((m & see) + see) ^ see)) & row;
  const uint32_t fired = m & see & (row >> 1);  // cells 0 .. V-2 that passed it on
  ahead |= fired | (fired << 1);
  return m;
}

// The row's V bits in reverse order: the right-to-left sweep is the
// left-to-right one on the reversed row.
__device__ __forceinline__ uint32_t reverse_row(uint32_t x, int V) {
  return __brev(x) >> (32 - V);
}

// One env's visibility words from its transparency words `col[0 .. V-1]`,
// in place: the agent's cell (V/2, V-1) seen, then the reference's two
// sweeps per row, bottom-up, as the JAX kernel unrolls them.
__device__ __forceinline__ void occlude_columns(uint32_t* col, int V) {
  uint32_t m = 1u << (V / 2);  // the agent's cell
  for (int j = V - 1; j >= 0; --j) {
    const uint32_t see = col[j];
    uint32_t ahead = 0, back = 0;
    m = sweep_up(m, see, V, ahead);
    m = reverse_row(sweep_up(reverse_row(m, V), reverse_row(see, V), V, back), V);
    col[j] = m;
    m = j > 0 ? ahead | reverse_row(back, V) : 0u;  // reached in the row ahead
  }
}

}  // namespace view_tile
