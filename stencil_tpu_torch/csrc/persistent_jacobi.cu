// One k-step Jacobi chunk of a single, all-self-wrap fp32 block in one
// launch: the deep (radius k) halo hand-offs of every direction, then k
// sweeps over shrinking grown regions, ping-ponging between the two buffers.
//
// Replaces: stencil_tpu/ops/persistent_stencil.py
// make_persistent_jacobi_kernel in its all-self-wrap (one device) form.
// Python wrapper and plain PyTorch version:
// stencil_tpu_torch/ops/persistent_stencil.py (persistent_jacobi,
// persistent_jacobi_plain).
//
// Semantics: a holds curr, b holds nxt. The hand-offs copy a's compute cells
// into a's halos (26 exact-extent boxes at the block's radius, which is at
// least k). Substep s = 0..k-1 reads buffer (s even ? a : b) over the region
// grown g + 1 = k - s cells past the compute region, and writes the other
// buffer over the region grown g = k - 1 - s cells: 6-neighbour average, then
// sel == 1 -> 1.0, sel == 2 -> 0.0 (sel must arrive halo-filled). The result
// of the chunk is in b when k is odd and in a when k is even. Cells outside
// the grown regions are not written.
//
// What bounds it on an H100: bytes. The least a chunk must move is one read
// of curr and sel and one write of the result over the halo-grown block,
// 12 * (n + 2k)^3 bytes for an n^3 block. This simple design moves more: each
// substep reads its source, reads sel and writes its destination over its
// grown region (about k times the floor), through L2 and device memory.
//
// Design: a cooperative launch (cudaLaunchCooperativeKernel), no more blocks
// than can be resident at once on the tensors' device (occupancy x SMs),
// each block walking tiles; cooperative_groups::this_grid().sync() after the
// hand-offs and after each substep but the last, since substep s + 1 reads
// cells that other blocks wrote in substep s. A tile is 32x8 columns of one
// z range of the grown region, marched in z by the sweep's column march
// (jacobi_column.cuh) with no wrapping: the grown region reads the filled
// halos. The two buffers are read and written in the same launch, so they
// are plain (not __restrict__) parameters and their loads stay coherent;
// sel is read-only and takes the read-only path.
//
// Offsets are 64-bit (a 512^3 block at radius 4 pads to 520 x 528 x 640).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "direction_boxes.cuh"
#include "jacobi_column.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace jacobi;

// tiles wanted per resident block and substep, so the walk balances
constexpr int TILES_PER_BLOCK = 4;

__global__ void __launch_bounds__(THREADS)
persistent_jacobi_kernel(float* a, float* b, const int32_t* __restrict__ sel, long long sz,
                         long long sy, int zo, int yo, int xo, int nz, int ny, int nx, int k,
                         DirBoxes boxes) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.y * BX + threadIdx.x;

  const long long total = boxes.start[boxes.n];
  for (long long i = (long long)blockIdx.x * THREADS + tid; i < total;
       i += (long long)gridDim.x * THREADS)
    copy_box_cell(a, boxes, i, sz, sy);
  grid.sync();

  for (int s = 0; s < k; ++s) {
    const int g = k - 1 - s;
    const float* src = (s & 1) ? b : a;
    float* dst = (s & 1) ? a : b;
    const int ex = nx + 2 * g, ey = ny + 2 * g, ez = nz + 2 * g;
    const int gx = (ex + BX - 1) / BX;
    const int gy = (ey + BY - 1) / BY;
    const long long cols = (long long)gx * gy;
    const int zchunk = zchunk_for((long long)TILES_PER_BLOCK * gridDim.x, cols, ez);
    const long long tiles = cols * ((ez + zchunk - 1) / zchunk);

    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int tx = (int)(t % gx) * BX + threadIdx.x;
      const int ty = (int)((t / gx) % gy) * BY + threadIdx.y;
      const int z0 = (int)(t / cols) * zchunk;
      if (tx >= ex || ty >= ey) continue;
      march_column(src, dst, sel, sz, zo - g, z0, min(ez, z0 + zchunk), ez, false,
                   column_at(tx, ty, xo - g, yo - g, ex, ey, false, false, sy));
    }
    if (s + 1 < k) grid.sync();
  }
}

// Blocks of the cooperative grid on device dev, which must be the current
// device (the occupancy query reads that one): the most that can be
// resident at once.
cudaError_t cooperative_blocks(int dev, int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_jacobi_kernel,
                                                      THREADS, 0);
  *blocks = per_sm * sms;
  return e;
}

}  // namespace

// a / b: curr / nxt blocks; boxes: nboxes rows of 9 ints (src z y x, dst
// z y x, extent z y x), the deep hand-offs at the block's radius; dev: the
// device the tensors are on.
extern "C" int persistent_jacobi_launch(void* a, void* b, const void* sel, long long sz,
                                        long long sy, int zo, int yo, int xo, int nz, int ny,
                                        int nx, int k, const int* boxes, int nboxes, int dev,
                                        void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || k < 1) return (int)cudaErrorInvalidValue;
  DirBoxes bx;
  if (!make_dir_boxes(boxes, nboxes, &bx)) return (int)cudaErrorInvalidValue;
  DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  int blocks = 0;
  const cudaError_t e = cooperative_blocks(dev, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&a, &b, &sel, &sz, &sy, &zo, &yo, &xo, &nz, &ny, &nx, &k, &bx};
  const cudaError_t r = cudaLaunchCooperativeKernel(
      (const void*)persistent_jacobi_kernel, dim3(blocks), dim3(BX, BY), args, 0,
      (cudaStream_t)stream);
  if (r != cudaSuccess) return (int)r;
  return (int)cudaGetLastError();
}
