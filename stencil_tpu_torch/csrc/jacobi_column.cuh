// The 7-point Jacobi column march and the grid sizing shared by
// jacobi_sweep.cu, fused_jacobi.cu and mesh_chunk.cuh.
//
// A thread owns one (x, y) column of the region it sweeps and marches a z
// range of it, keeping the z-1 / z / z+1 values in registers; the x and y
// neighbours come through L1/L2. The sum is (x_lo + x_hi + y_lo + y_hi +
// z_lo + z_hi), left to right, times 1/6 rounded to float32, then
// sel == 1 -> 1.0, sel == 2 -> 0.0: one operand order for every Jacobi
// kernel of the package, so each is bit-exact to its plain version.
//
// The march's pointers carry no __restrict__: once it is inlined, what the
// compiler may assume about aliasing and read-only loads comes from the
// calling kernel's own parameters. A kernel whose source is a
// `const __restrict__` parameter (jacobi_sweep.cu) gets read-only loads; one
// that writes its source in the same launch (mesh_chunk.cuh) reads it
// through plain pointers and keeps coherent loads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jacobi {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int THREADS = BX * BY;
constexpr float SIXTH = 1.0f / 6.0f;
constexpr float HOT = 1.0f;
constexpr float COLD = 0.0f;
// a sweep wants this many waves of 256-thread blocks, this many resident
// per SM, in flight
constexpr int BLOCKS_PER_SM = 8;
constexpr int WAVES = 4;

// One column: its offset within a plane and its four in-plane neighbours'.
struct Column {
  long long c, xm, xp, ym, yp;
};

// Column (tx, ty) of a region whose first cell is (xo, yo), nx x ny cells
// wide. A wrapping axis (wx, wy) takes the periodic neighbour of its first
// and last cells from the other end of the region; otherwise the neighbour
// is the cell just outside it (a halo cell).
__device__ __forceinline__ Column column_at(int tx, int ty, int xo, int yo, int nx, int ny,
                                            bool wx, bool wy, long long sy) {
  const int x = xo + tx;
  const int y = yo + ty;
  const int xm = (wx && tx == 0) ? xo + nx - 1 : x - 1;
  const int xp = (wx && tx == nx - 1) ? xo : x + 1;
  const int ym = (wy && ty == 0) ? yo + ny - 1 : y - 1;
  const int yp = (wy && ty == ny - 1) ? yo : y + 1;
  return {(long long)y * sy + x, (long long)y * sy + xm, (long long)y * sy + xp,
          (long long)ym * sy + x, (long long)yp * sy + x};
}

// dst <- the Jacobi update of src, for column `col` and region planes
// z0 <= z < z1 (plane z at index zo + z, nz planes). With wz, planes -1 and
// nz are planes nz - 1 and 0; otherwise they are the halo planes.
__device__ __forceinline__ void march_column(const float* src, float* dst,
                                             const int32_t* sel, long long sz, int zo,
                                             int z0, int z1, int nz, bool wz,
                                             const Column& col) {
  const int zb = (wz && z0 == 0) ? nz - 1 : z0 - 1;
  float below = src[(long long)(zo + zb) * sz + col.c];
  float mid = src[(long long)(zo + z0) * sz + col.c];
  // unrolled so several planes' loads are in flight per thread
#pragma unroll 4
  for (int lz = z0; lz < z1; ++lz) {
    const int za = (wz && lz == nz - 1) ? 0 : lz + 1;
    const float above = src[(long long)(zo + za) * sz + col.c];
    const long long p = (long long)(zo + lz) * sz;
    float s = src[p + col.xm] + src[p + col.xp];
    s = s + src[p + col.ym];
    s = s + src[p + col.yp];
    s = s + below;
    s = s + above;
    const float avg = s * SIXTH;
    const int32_t q = sel[p + col.c];
    dst[p + col.c] = q == 1 ? HOT : (q == 2 ? COLD : avg);
    below = mid;
    mid = above;
  }
}

// Planes per z range when `want` blocks (or tiles) should cover `cols`
// columns of nz planes: at least one range per column, at most nz.
__host__ __device__ inline int zchunk_for(long long want, long long cols, int nz) {
  long long nzc = (want + cols - 1) / cols;
  if (nzc < 1) nzc = 1;
  if (nzc > nz) nzc = nz;
  return (int)((nz + nzc - 1) / nzc);
}

// The tiling of an nz x ny x nx sweep of nres blocks on device dev (sms
// SMs): gx x gy columns of BX x BY threads per block, each thread block
// marching zchunk planes (gz ranges per block), WAVES waves of BLOCKS_PER_SM
// blocks per SM.
struct SweepGrid {
  int sms, gx, gy, gz, zchunk;
};

inline cudaError_t sweep_grid(int dev, int nx, int ny, int nz, SweepGrid* g, int nres = 1) {
  const cudaError_t e = cudaDeviceGetAttribute(&g->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  g->gx = (nx + BX - 1) / BX;
  g->gy = (ny + BY - 1) / BY;
  g->zchunk = zchunk_for((long long)g->sms * BLOCKS_PER_SM * WAVES,
                         (long long)g->gx * g->gy * nres, nz);
  g->gz = (nz + g->zchunk - 1) / g->zchunk;
  return cudaSuccess;
}

// Makes dev, the tensors' device, the calling thread's current device for
// the scope (occupancy queries and launches act on the current device).
class DeviceScope {
 public:
  explicit DeviceScope(int dev) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != dev) err_ = cudaSetDevice(dev);
    else prev_ = -1;
  }
  ~DeviceScope() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace jacobi
