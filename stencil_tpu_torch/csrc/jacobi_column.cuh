// What the Jacobi kernels over a mesh of block positions share
// (mesh_chunk.cuh, and through it persistent_jacobi.cu and fused_jacobi.cu):
// the operand order's constants, the z-range rule and the device scope.
//
// Every Jacobi kernel of the package sums (x_lo + x_hi + y_lo + y_hi +
// z_lo + z_hi), left to right, times 1/6 rounded to float32, then
// sel == 1 -> 1.0, sel == 2 -> 0.0, so each is bit-exact to its plain
// version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jacobi {

constexpr float SIXTH = 1.0f / 6.0f;
constexpr float HOT = 1.0f;
constexpr float COLD = 0.0f;

// Planes per z range when `want` blocks (or tiles) should cover `cols`
// columns of nz planes: at least one range per column, at most nz.
__host__ __device__ inline int zchunk_for(long long want, long long cols, int nz) {
  long long nzc = (want + cols - 1) / cols;
  if (nzc < 1) nzc = 1;
  if (nzc > nz) nzc = nz;
  return (int)((nz + nzc - 1) / nzc);
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
