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
// registers, so each curr plane is loaded from device memory once per
// column. The x and y neighbours come through L1/L2 (adjacent threads read
// adjacent addresses, so loads along x coalesce). Self-wrap axes take the
// periodic neighbour by index arithmetic: on a single block no halo cell is
// read at all, which also makes the tight-x layout (Radius::without_x, no x
// halo columns) work unchanged. Non-wrapping axes read the halo cells.
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

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr float SIXTH = 1.0f / 6.0f;
constexpr float HOT = 1.0f;
constexpr float COLD = 0.0f;
// blocks wanted in flight: 132 SMs x 8 resident 256-thread blocks x 4 waves
constexpr int TARGET_BLOCKS = 132 * 8 * 4;

__global__ void __launch_bounds__(BX * BY)
jacobi_sweep_kernel(const float* __restrict__ curr, float* __restrict__ out,
                    const int32_t* __restrict__ sel, long long sz, long long sy,
                    int zo, int yo, int xo, int nz, int ny, int nx,
                    int wz, int wy, int wx, int zchunk) {
  const int tx = blockIdx.x * BX + threadIdx.x;
  const int ty = blockIdx.y * BY + threadIdx.y;
  const int z0 = blockIdx.z * zchunk;
  const int z1 = min(nz, z0 + zchunk);
  if (tx >= nx || ty >= ny || z0 >= z1) return;

  const int x = xo + tx;
  const int y = yo + ty;
  const int xm = (wx && tx == 0) ? xo + nx - 1 : x - 1;
  const int xp = (wx && tx == nx - 1) ? xo : x + 1;
  const int ym = (wy && ty == 0) ? yo + ny - 1 : y - 1;
  const int yp = (wy && ty == ny - 1) ? yo : y + 1;
  const long long c = (long long)y * sy + x;
  const long long oxm = (long long)y * sy + xm;
  const long long oxp = (long long)y * sy + xp;
  const long long oym = (long long)ym * sy + x;
  const long long oyp = (long long)yp * sy + x;

  // local z index -1 / nz address the halo planes of a non-wrapping z axis
  const int zb = (wz && z0 == 0) ? nz - 1 : z0 - 1;
  float below = curr[(long long)(zo + zb) * sz + c];
  float mid = curr[(long long)(zo + z0) * sz + c];
  // unrolled so several planes' loads are in flight per thread
#pragma unroll 4
  for (int lz = z0; lz < z1; ++lz) {
    const int za = (wz && lz == nz - 1) ? 0 : lz + 1;
    const float above = curr[(long long)(zo + za) * sz + c];
    const long long p = (long long)(zo + lz) * sz;
    float s = curr[p + oxm] + curr[p + oxp];
    s = s + curr[p + oym];
    s = s + curr[p + oyp];
    s = s + below;
    s = s + above;
    const float avg = s * SIXTH;
    const int32_t k = sel[p + c];
    out[p + c] = k == 1 ? HOT : (k == 2 ? COLD : avg);
    below = mid;
    mid = above;
  }
}

}  // namespace

extern "C" int jacobi_sweep_launch(const void* curr, void* out, const void* sel,
                                   long long sz, long long sy, int zo, int yo,
                                   int xo, int nz, int ny, int nx, int wz,
                                   int wy, int wx, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const int gx = (nx + BX - 1) / BX;
  const int gy = (ny + BY - 1) / BY;
  long long want = (TARGET_BLOCKS + (long long)gx * gy - 1) / ((long long)gx * gy);
  const int nzc = (int)(want < 1 ? 1 : (want > nz ? nz : want));
  const int zchunk = (nz + nzc - 1) / nzc;
  const dim3 grid(gx, gy, (nz + zchunk - 1) / zchunk);
  const dim3 block(BX, BY);
  jacobi_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)curr, (float*)out, (const int32_t*)sel, sz, sy, zo, yo, xo,
      nz, ny, nx, wz, wy, wx, zchunk);
  return (int)cudaGetLastError();
}
