// One fused Jacobi step of a single, all-self-wrap fp32 block: the halo
// hand-offs of every direction into curr, and the sweep of the compute
// region into out, in one launch.
//
// Replaces: stencil_tpu/ops/fused_stencil.py make_fused_jacobi_kernel in its
// all-self-wrap (one device) form: per step it copies the 26 exact-extent
// direction messages of the plan into curr's halos in place, then sweeps the
// compute region into nxt. Python wrapper and plain PyTorch version:
// stencil_tpu_torch/ops/fused_stencil.py (fused_jacobi, fused_jacobi_plain).
//
// What bounds it on an H100: bytes. The sweep reads curr and sel once and
// writes out once (12 bytes per cell); the hand-offs add two accesses per
// halo cell (1.6 M cells at 512^3 radius 1, about 1% more). The floor is
// 12 * nz*ny*nx bytes over the memory rate.
//
// Design: blocks of one grid take one of two roles. Sweep blocks (the first
// ones) run the sweep of jacobi_sweep.cu (jacobi_column.cuh) with every axis
// wrapping. Fill blocks walk the direction boxes (direction_boxes.cuh), one
// thread per halo cell. There is no barrier between blocks of one launch,
// so a sweep block must never read a halo cell that a fill block of the
// same launch writes: the sweep takes each periodic neighbour from its
// wrap-mapped compute cell by index arithmetic instead (the value the
// hand-off puts in that halo cell), and the hand-offs read only compute
// cells, which nothing in this launch writes. The result is the TPU
// kernel's: halos filled, out's compute region swept, nothing else of out
// written. Both roles are sized from the device's SM count.

#include <cuda_runtime.h>
#include <stdint.h>

#include "direction_boxes.cuh"
#include "jacobi_column.cuh"

namespace {

using namespace jacobi;

__global__ void __launch_bounds__(THREADS)
fused_jacobi_kernel(float* curr, float* __restrict__ out, const int32_t* __restrict__ sel,
                    long long sz, long long sy, int zo, int yo, int xo, int nz, int ny,
                    int nx, int gx, int gy, int zchunk, int sweep_blocks, DirBoxes boxes) {
  if ((int)blockIdx.x >= sweep_blocks) {
    const long long total = boxes.start[boxes.n];
    const long long step = (long long)(gridDim.x - sweep_blocks) * THREADS;
    for (long long i = (long long)(blockIdx.x - sweep_blocks) * THREADS +
                       threadIdx.y * BX + threadIdx.x;
         i < total; i += step)
      copy_box_cell(curr, boxes, i, sz, sy);
    return;
  }
  const int tx = (blockIdx.x % gx) * BX + threadIdx.x;
  const int ty = ((blockIdx.x / gx) % gy) * BY + threadIdx.y;
  const int z0 = (blockIdx.x / (gx * gy)) * zchunk;
  const int z1 = min(nz, z0 + zchunk);
  if (tx >= nx || ty >= ny || z0 >= z1) return;
  march_column(curr, out, sel, sz, zo, z0, z1, nz, true,
               column_at(tx, ty, xo, yo, nx, ny, true, true, sy));
}

}  // namespace

// boxes: nboxes rows of 9 ints (src z y x, dst z y x, extent z y x), the
// plan's fused phases on this block; dev: the device the tensors are on.
extern "C" int fused_jacobi_launch(void* curr, void* out, const void* sel, long long sz,
                                   long long sy, int zo, int yo, int xo, int nz, int ny,
                                   int nx, const int* boxes, int nboxes, int dev,
                                   void* stream) {
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  DirBoxes bx;
  if (!make_dir_boxes(boxes, nboxes, &bx)) return (int)cudaErrorInvalidValue;
  DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  SweepGrid g;
  const cudaError_t e = sweep_grid(dev, nx, ny, nz, &g);
  if (e != cudaSuccess) return (int)e;
  const long long sweep_blocks = (long long)g.gx * g.gy * g.gz;
  // one wave of fill blocks at most: they walk the boxes
  const long long fill_wave = (long long)g.sms * BLOCKS_PER_SM;
  long long fill_blocks = (bx.start[bx.n] + THREADS - 1) / THREADS;
  if (fill_blocks > fill_wave) fill_blocks = fill_wave;
  if (sweep_blocks + fill_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_jacobi_kernel<<<(unsigned)(sweep_blocks + fill_blocks), dim3(BX, BY), 0,
                        (cudaStream_t)stream>>>(
      (float*)curr, (float*)out, (const int32_t*)sel, sz, sy, zo, yo, xo, nz, ny, nx, g.gx,
      g.gy, g.zchunk, (int)sweep_blocks, bx);
  return (int)cudaGetLastError();
}
