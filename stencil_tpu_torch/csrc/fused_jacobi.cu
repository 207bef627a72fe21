// One fused Jacobi step of a single, all-self-wrap fp32 block: the halo
// hand-offs of every direction into curr, and the sweep of the compute
// region into out, in one launch. The wire-crossing form over a mesh of
// block positions (fused_jacobi_mesh_launch) follows below.
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
#include "mesh_chunk.cuh"

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

// ---------------------------------------------------------------------------
// B8's wire-crossing form: one fused step of every fp32 block position of one
// device, in one cooperative launch.
//
// Replaces: make_fused_jacobi_kernel on a mesh (barrier with the neighbours,
// start a remote copy per crossing direction, sweep on pre-exchange data,
// wait, unpack, re-sweep the boundary planes). Python wrapper and plain
// PyTorch version: stencil_tpu_torch/ops/fused_stencil.py (fused_jacobi_mesh,
// fused_jacobi_mesh_plain).
//
// What it computes: every active direction's exact-extent message of the
// fused plan, from each position's compute cells into the halo box of the
// position + d (crossing and self-wrap alike), then every position's compute
// region swept into its nxt with no wrap, reading those halos. Nothing else
// of nxt is written.
//
// What bounds it on an H100: bytes. The sweep reads curr and sel and writes
// nxt once per compute cell (12 bytes), and each message cell is read and
// written once (8 bytes): at 512^3 over 8 positions of 256^3 at radius 1,
// 12 * 512^3 + 8 * 8 * (258^3 - 256^3) bytes over the memory rate.
//
// Design: mesh_chunk.cuh's mesh_step (the one-substep chunk, which the
// reference calls the fused substep). Phase A stores every message straight
// through the destination position's pointer, then this_grid().sync(), then
// phase B marches every position's compute tiles.
// The TPU kernel sweeps before its copies land and re-sweeps the boundary;
// here the barrier is cheap and the copies are small, so the sweep waits for
// them and runs once. Unlike fused_jacobi_kernel above, which never waits and
// reads a single block's periodic images by index arithmetic, this form must
// read halo cells that other blocks store, hence the barrier and the
// cooperative launch: one launch per (device, step) covers every position,
// so no kernel ever waits for another launch.

namespace {

__global__ void __launch_bounds__(THREADS)
fused_jacobi_mesh_kernel(const __grid_constant__ MeshChunk c) {
  mesh_step(c);
}

}  // namespace

// pos: device table of npos rows (curr, nxt, sel pointers); msg: device table
// of nboxes * m rows (source position, destination position, box index), m
// rows per box in box order; boxes: nboxes rows of 9 ints (src z y x, dst
// z y x, extent z y x), the fused plan's messages; geometry as
// persistent_jacobi_launch's; dev: the device of every block.
extern "C" int fused_jacobi_mesh_launch(const void* pos, int npos, const void* msg, int m,
                                        const int* boxes, int nboxes, long long sz,
                                        long long sy, int zo, int yo, int xo, int nz, int ny,
                                        int nx, int dev, void* stream) {
  MeshChunk c;
  if (!make_mesh_chunk(pos, npos, msg, m, boxes, nboxes, sz, sy, zo, yo, xo, nz, ny, nx, 1,
                       &c))
    return (int)cudaErrorInvalidValue;
  return (int)mesh_chunk_launch(fused_jacobi_mesh_kernel, c, dev, stream, dim3(BX, BY), 0);
}
