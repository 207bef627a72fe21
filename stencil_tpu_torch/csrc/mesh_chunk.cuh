// The Jacobi chunk over a mesh of block positions on one device, in one
// cooperative launch: every position's exact-extent halo messages, then k
// sweeps over shrinking grown regions of every position. Shared by
// fused_jacobi.cu (k = 1: B8's wire-crossing form) and persistent_jacobi.cu
// (B9, any k >= 1; a single block is the one-position case).
//
// Tables (int64, in device memory, made by the Python wrappers):
// - positions: npos rows of (a, b, sel) pointers; a holds curr, b nxt;
// - messages: m rows per direction box, in box order, of (source position,
//   destination position, box index). A message copies the source's a cells
//   of the box's src start into the destination's a halo at its dst start
//   (direction_boxes.cuh), straight through the destination's pointer: no
//   landing buffer. On an axis with one position the destination is the
//   source itself (a self-wrap hand-off).
//
// Semantics: messages, then for s = 0..k-1 every position's substep s reads
// (s even ? a : b) over the region grown k - s cells past the compute region
// and writes the other buffer over the region grown g = k - 1 - s cells:
// 6-neighbour average in jacobi_column.cuh's operand order, then sel == 1 ->
// 1.0, sel == 2 -> 0.0 (sel must arrive halo-filled when k >= 2). The result
// is in b when k is odd and in a when k is even. Nothing else is written.
//
// Ordering: messages read only compute cells and write only halo cells, each
// halo cell by one message, so phase A needs no order among its threads.
// Substep 0 reads halo cells other blocks stored, and substep s + 1 reads
// cells other blocks wrote in substep s: a grid-wide barrier
// (cooperative_groups::this_grid().sync()) separates them. Every block must
// therefore be resident at once: the launch is cooperative, sized from the
// occupancy query (mesh_chunk_launch). The a and b pointers are read from a
// table, so no load of them takes the read-only (non-coherent) path.
//
// Offsets are 64-bit (a 256^3 block at radius 4 pads to 264 x 264 x 288).
//
// Positions on distinct GPUs would need peer pointers in the position table
// and a barrier across devices: the kernel assumes nothing about where a
// pointer lives beyond what the table gives.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "direction_boxes.cuh"
#include "jacobi_column.cuh"

namespace jacobi {

struct MeshPosition {
  float* a;
  float* b;
  const int32_t* sel;
};

struct MeshMessage {
  long long src, dst, box;
};

// Everything a chunk launch needs; passed as one __grid_constant__ parameter.
struct MeshChunk {
  const MeshPosition* pos;
  const MeshMessage* msg;
  int npos, m, k;
  long long sz, sy;
  int zo, yo, xo, nz, ny, nx;
  DirBoxes boxes;
};

// tiles wanted per resident block and substep, so the walk balances
constexpr int TILES_PER_BLOCK = 4;

__device__ __forceinline__ void mesh_chunk(const MeshChunk& c) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.y * BX + threadIdx.x;
  const DirBoxes& bx = c.boxes;

  // phase A: every message, cell by cell, x fastest
  const long long m = c.m;
  const long long total = bx.start[bx.n] * m;
  for (long long i = (long long)blockIdx.x * THREADS + tid; i < total;
       i += (long long)gridDim.x * THREADS) {
    int b = 0;
    while (i >= bx.start[b + 1] * m) ++b;
    const long long cells = bx.start[b + 1] - bx.start[b];
    const long long j = i - bx.start[b] * m;
    const MeshMessage msg = c.msg[(long long)b * m + j / cells];
    const int* q = bx.box[msg.box];
    unsigned u = (unsigned)(j % cells);
    const int x = (int)(u % (unsigned)q[8]);
    u /= (unsigned)q[8];
    const int y = (int)(u % (unsigned)q[7]);
    const int z = (int)(u / (unsigned)q[7]);
    const float* src = c.pos[msg.src].a;
    float* dst = c.pos[msg.dst].a;
    dst[(long long)(q[3] + z) * c.sz + (long long)(q[4] + y) * c.sy + q[5] + x] =
        src[(long long)(q[0] + z) * c.sz + (long long)(q[1] + y) * c.sy + q[2] + x];
  }
  grid.sync();

  // phase B: k substeps over every position's grown region
  for (int s = 0; s < c.k; ++s) {
    const int g = c.k - 1 - s;
    const int ex = c.nx + 2 * g, ey = c.ny + 2 * g, ez = c.nz + 2 * g;
    const int gx = (ex + BX - 1) / BX;
    const int gy = (ey + BY - 1) / BY;
    const long long cols = (long long)gx * gy;
    const int zchunk = zchunk_for((long long)TILES_PER_BLOCK * gridDim.x, cols * c.npos, ez);
    const long long per_pos = cols * ((ez + zchunk - 1) / zchunk);
    const long long tiles = per_pos * c.npos;

    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const MeshPosition p = c.pos[t / per_pos];
      const long long u = t % per_pos;
      const int tx = (int)(u % gx) * BX + threadIdx.x;
      const int ty = (int)((u / gx) % gy) * BY + threadIdx.y;
      const int z0 = (int)(u / cols) * zchunk;
      if (tx >= ex || ty >= ey) continue;
      const float* src = (s & 1) ? p.b : p.a;
      float* dst = (s & 1) ? p.a : p.b;
      march_column(src, dst, p.sel, c.sz, c.zo - g, z0, min(ez, z0 + zchunk), ez, false,
                   column_at(tx, ty, c.xo - g, c.yo - g, ex, ey, false, false, c.sy));
    }
    if (s + 1 < c.k) grid.sync();
  }
}

// Fill a MeshChunk from the wrappers' arguments; false if the boxes do not fit.
inline bool make_mesh_chunk(const void* pos, int npos, const void* msg, int m, const int* boxes,
                            int nboxes, long long sz, long long sy, int zo, int yo, int xo,
                            int nz, int ny, int nx, int k, MeshChunk* c) {
  if (npos < 1 || m < 0 || nz < 1 || ny < 1 || nx < 1 || k < 1) return false;
  if (!make_dir_boxes(boxes, nboxes, &c->boxes)) return false;
  c->pos = (const MeshPosition*)pos;
  c->msg = (const MeshMessage*)msg;
  c->npos = npos;
  c->m = m;
  c->k = k;
  c->sz = sz;
  c->sy = sy;
  c->zo = zo;
  c->yo = yo;
  c->xo = xo;
  c->nz = nz;
  c->ny = ny;
  c->nx = nx;
  return true;
}

// One cooperative launch of `kernel` (a __global__ taking one MeshChunk) on
// device dev: as many blocks as can be resident at once (occupancy x SMs).
// A launch the device refuses returns its error; there is no fallback.
template <typename Kernel>
cudaError_t mesh_chunk_launch(Kernel kernel, const MeshChunk& c, int dev, void* stream) {
  DeviceScope on(dev);
  if (on.error() != cudaSuccess) return on.error();
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < 1) return cudaErrorInvalidConfiguration;
  MeshChunk arg = c;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms), dim3(BX, BY), args,
                                  0, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace jacobi
