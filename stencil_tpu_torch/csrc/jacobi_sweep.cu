// One 7-point Jacobi step over the compute region of a padded fp32 block.
//
// Replaces: stencil_tpu/ops/pallas_stencil.py make_pallas_jacobi_sweep
// (the TPU kernel that tiles (tz, ty) slabs through VMEM with double-buffered
// DMA). Python wrapper and plain PyTorch version:
// stencil_tpu_torch/ops/stencil_kernels.py (sweep, sweep_plain).
//
// What bounds it on an H100: bytes. Per cell it reads curr and sel once and
// writes out once (12 bytes) for 6 adds and a multiply, far below the card's
// balance point, so the floor is 3 * 4 * nz*ny*nx bytes over the memory rate.
//
// Design (2.5D blocking): one thread per output (x, y) column; a 32x8 block
// marches a z range and keeps the z-1 / z / z+1 values of its column in
// registers (jacobi_column.cuh), so each curr plane is loaded from device
// memory once per column. The x and y neighbours come through L1/L2
// (adjacent threads read adjacent addresses, so loads along x coalesce);
// curr is a const __restrict__ parameter, so its loads take the read-only
// path. Self-wrap axes take the periodic neighbour by index arithmetic: on a
// single block no halo cell is read at all, which also makes the tight-x
// layout (Radius::without_x, no x halo columns) work unchanged. Non-wrapping
// axes read the halo cells.
//
// Residents and tenants: one launch sweeps every block of a stack (block r
// at r * bstride): the resident blocks of a partition, or the B independent
// tenants of a campaign slot (stencil_tpu/ops/pallas_stencil.py
// make_pallas_jacobi_sweep's batch= form, every axis wrapping onto the
// tenant itself). A stack launches as a one-dimensional grid of x tiles, y
// tiles, z ranges and blocks, in that order (fastest first), since grid.x
// takes up to 2^31 - 1 blocks where grid.y and grid.z stop at 65,535: any
// stack that fits in memory launches, and each block's tiles run together
// as on a single block. A single block takes the STACK = false
// instantiation, which computes no block offset and launches a (gx, gy, gz)
// grid (one instantiation for both ran 1.09 ms against 0.94 at 512^3 on an
// H100 80GB HBM3 at 700 W, apps/bench_kernels.py's jacobi_sweep). The same kernel
// sweeps any rect of the blocks (the overlap shells of a multi-block
// partition) when given the rect's origin and extent with the wrap flags
// off.
//
// Only the compute region of `out` is written. (The TPU kernel also copies
// the input's halo values into the rows it stores, a store-granularity
// artefact of its tiles; nothing reads them, and this kernel does not.)
//
// Arithmetic: (x_lo + x_hi + y_lo + y_hi + z_lo + z_hi) summed left to right,
// then multiplied by 1/6 rounded to float32 -- exactly what the JAX package
// computes (XLA folds its `sum / 6` into that multiply). Built without fast
// math and with -fmad=false, so every operation rounds as written.
// Offsets are 64-bit: a padded 1024^3 block has more than 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi_column.cuh"

namespace {

using namespace jacobi;

template <bool STACK>
__global__ void __launch_bounds__(THREADS)
jacobi_sweep_kernel(const float* __restrict__ curr, float* __restrict__ out,
                    const int32_t* __restrict__ sel, long long sz, long long sy,
                    long long bstride, int zo, int yo, int xo, int nz, int ny, int nx,
                    int wz, int wy, int wx, int zchunk, int gx, int gy, int gz) {
  unsigned int i = blockIdx.x;
  const int bx = STACK ? i % gx : blockIdx.x;
  const int by = STACK ? (i /= gx) % gy : blockIdx.y;
  const int bz = STACK ? (i /= gy) % gz : blockIdx.z;
  const int res = STACK ? i / gz : 0;
  const int tx = bx * BX + threadIdx.x;
  const int ty = by * BY + threadIdx.y;
  const int z0 = bz * zchunk;
  const int z1 = min(nz, z0 + zchunk);
  if (tx >= nx || ty >= ny || z0 >= z1) return;
  const long long b = STACK ? res * bstride : 0;
  march_column(curr + b, out + b, sel + b, sz, zo, z0, z1, nz, wz,
               column_at(tx, ty, xo, yo, nx, ny, wx, wy, sy));
}

}  // namespace

// nres blocks of bstride elements each; (zo, yo, xo) / (nz, ny, nx): the
// swept rect of every block. dev: the device the tensors are on.
extern "C" int jacobi_sweep_launch(const void* curr, void* out, const void* sel,
                                   long long sz, long long sy, long long bstride,
                                   int nres, int zo, int yo, int xo, int nz, int ny,
                                   int nx, int wz, int wy, int wx, int dev,
                                   void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || nres < 1) return (int)cudaErrorInvalidValue;
  DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  SweepGrid g;
  const cudaError_t e = sweep_grid(dev, nx, ny, nz, &g, nres);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)g.gx * g.gy * g.gz * nres;
  if (nres > 1 ? blocks > 2147483647LL : g.gy > 65535 || g.gz > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = nres > 1 ? dim3((unsigned)blocks) : dim3(g.gx, g.gy, g.gz);
  const dim3 block(BX, BY);
  cudaStream_t st = (cudaStream_t)stream;
  if (nres > 1)
    jacobi_sweep_kernel<true><<<grid, block, 0, st>>>(
        (const float*)curr, (float*)out, (const int32_t*)sel, sz, sy, bstride, zo, yo, xo,
        nz, ny, nx, wz, wy, wx, g.zchunk, g.gx, g.gy, g.gz);
  else
    jacobi_sweep_kernel<false><<<grid, block, 0, st>>>(
        (const float*)curr, (float*)out, (const int32_t*)sel, sz, sy, bstride, zo, yo, xo,
        nz, ny, nx, wz, wy, wx, g.zchunk, g.gx, g.gy, g.gz);
  return (int)cudaGetLastError();
}
