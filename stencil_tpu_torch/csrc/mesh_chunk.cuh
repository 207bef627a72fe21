// The Jacobi chunk over a mesh of block positions on one device, in one
// cooperative launch: every position's exact-extent halo messages (phase A),
// one grid-wide barrier, then the substeps of every position (phase B):
// persistent_jacobi.cu's mesh_onchip_chunk, any k >= 2 with every substep of a
// tile on chip (B9; a single block is the one-position case). The position
// and message tables, and the occupancy query that sizes a cooperative grid,
// are shared with fused_jacobi.cu (B8), which moves its messages by rows.
//
// Tables (int64, in device memory, made by the Python wrappers):
// - positions: npos rows of (a, b, sel) pointers; a holds curr, b nxt;
// - extents (the uneven form only; null on a uniform partition): npos rows of
//   (nz, ny, nx), each position's own compute extent. The uneven form runs
//   no messages (B6 fills the deep halos before the launch) and each
//   position's passes sweep its own grown regions;
// - messages: m rows per direction box, in box order, of (source position,
//   destination position, box index). A message copies the source's a cells
//   of the box's src start into the destination's a halo at its dst start
//   (direction_boxes.cuh), straight through the destination's pointer: no
//   landing buffer. On an axis with one position the destination is the
//   source itself (a self-wrap hand-off).
//
// Semantics. Phase A: the messages. Phase B: k substeps in on-chip passes of
// at most ONCHIP_KMAX substeps (chunk_passes / pass_depth: balanced, deeper
// first). Pass p reads (p even ? a : b) over the region grown by the depth
// still to run, computes its d substeps on chip, and writes only the other
// buffer, over the region grown by the depth left after it (the compute
// region for the last pass). The result is in b when the number of passes is
// odd (every chunk of k <= ONCHIP_KMAX), else in a; a's halos hold the
// messages; nothing else is written. A substep is the 6-neighbour average in
// jacobi_column.cuh's operand order, then sel == 1 -> 1.0, sel == 2 -> 0.0
// (sel arrives halo-filled), so a chunk equals k plain steps bit for bit
// (stencil_tpu_torch/ops/persistent_stencil.py, result_in_nxt).
//
// Ordering: messages read only compute cells and write only halo cells, each
// halo cell by one message, so phase A needs no order among its threads.
// Phase B reads halo cells other blocks stored, and a pass reads cells other
// blocks wrote in the pass before: a grid-wide barrier
// (cooperative_groups::this_grid().sync()) after phase A and between passes
// separates them. Every block must therefore be resident at once: the launch
// is cooperative, sized from the occupancy query with the kernel's dynamic
// shared memory (mesh_chunk_launch). a and b are read from a table and loaded
// through ld.global.cg (L2, coherent), never the read-only path: other blocks
// of the same launch wrote them. sel is never written and takes the read-only
// path.
//
// Offsets are 64-bit (a 256^3 block at radius 4 pads to 264 x 264 x 288); the
// in-plane offset of a cell is 32-bit (the launch refuses a plane of 2^31
// cells or more).
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
  const long long* ext;  // per-position (nz, ny, nx), or null: every position nz x ny x nx
  int npos, m, k;
  long long sz, sy;
  int zo, yo, xo, nz, ny, nx;
  DirBoxes boxes;
};

// tiles wanted per resident block and pass (or sweep), so the walk balances
constexpr int TILES_PER_BLOCK = 4;

// Phase A: every message, cell by cell, x fastest, over all threads of the
// grid.
__device__ __forceinline__ void mesh_messages(const MeshChunk& c) {
  const DirBoxes& bx = c.boxes;
  const long long nthreads = (long long)blockDim.x * blockDim.y;
  const long long tid = (long long)threadIdx.y * blockDim.x + threadIdx.x;
  const long long m = c.m;
  const long long total = bx.start[bx.n] * m;
  for (long long i = (long long)blockIdx.x * nthreads + tid; i < total;
       i += (long long)gridDim.x * nthreads) {
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
}

// ---------------------------------------------------------------------------
// B9: the k-step chunk with every substep of a tile on chip.
//
// A pass of depth D is ghost-zone temporal blocking with a register z-march,
// the design of jacobi_multistep.cu: a block owns an output tile of
// ONCHIP_TILE^2 columns, grown by D cells on each side (a plane of WG x WG
// cells, WG = ONCHIP_TILE + 2D), and marches a z range of it with D + 1
// stages. Stage 0 loads the source plane (the input grown by D cells, all of
// it inside the halos phase A filled or the pass before wrote); stage s =
// 1..D computes substep s - 1 of the pass at plane v - s over the cells at
// least s from the grown plane's edge. Every thread owns the same cells in
// every stage, so a cell's z neighbours are the thread's own earlier results
// (a three-plane register window per stage); the x and y neighbours come
// from two shared-memory planes per stage (plane v is read while v + 1 is
// written, one barrier a step). Only stage D stores, into the other buffer:
// no intermediate substep reaches device memory.
//
// The depth-K kernel's block has onchip_threads(K) threads, two cells of the
// grown plane each, so no warp idles on empty cells at the per-plane barrier.
// (A block of 1024 threads leaves 22% of its cells empty at K = 4 and its
// last 14 warps one cell short, and its 64-register cap makes every depth
// spill.)
//
// sel: stage s needs sel at its own plane and cell, which only the owning
// thread reads, so each thread keeps its cells' codes of the last planes in a
// 32-bit shift register, two bits a plane (1 hot, 2 cold, 0 anything else:
// any int32 sel stays exact), loaded with the source plane.
//
// The next plane's source and sel values are loaded into registers while the
// stages of this plane run. Cells of a ragged edge tile past the region the
// pass writes stop at stage D - 1 (they feed no output) and read clamped into
// the source region. Offsets of the stage-0 cells are in-plane, 32-bit. The
// depth is a template parameter: a chunk's passes differ in depth by at most
// one, so a kernel instantiates its deepest pass K and K - 1.

constexpr int ONCHIP_TILE = 32;  // output tile edge, x and y
constexpr int ONCHIP_KMAX = 6;   // deepest pass instantiated (register windows grow with it)

// threads of a block of the depth-K kernel: two cells of its grown plane each
// (648 at K = 2 .. 968 at K = 6)
__host__ __device__ constexpr int onchip_threads(int K) {
  return ((ONCHIP_TILE + 2 * K) * (ONCHIP_TILE + 2 * K) + 1) / 2;
}

// on-chip passes of a depth-k chunk, and the depth of pass p (balanced,
// deeper first): persistent_stencil.py chunk_passes mirrors these
__host__ __device__ inline int chunk_passes(int k) {
  return (k + ONCHIP_KMAX - 1) / ONCHIP_KMAX;
}
__host__ __device__ inline int pass_depth(int k, int p) {
  const int n = chunk_passes(k);
  return k / n + (p < k % n ? 1 : 0);
}

// shared memory of a depth-D pass: two planes for each of stages 0..D-1
inline long long onchip_smem_bytes(int D) {
  return 2LL * D * (ONCHIP_TILE + 2 * D) * (ONCHIP_TILE + 2 * D) * (long long)sizeof(float);
}

// One output tile of a depth-D pass by a block of NT threads: the ONCHIP_TILE^2
// columns from (X0, Y0) and planes [Z0, Z1) of position p's written region
// (ex x ey in-plane, first cell (x0, y0, z0) of the padded block), read from
// `from_b ? b : a` over the tile grown by D and written to the other buffer.
template <int D, int NT>
__device__ __forceinline__ void onchip_tile(const MeshChunk& c, const MeshPosition p, int X0,
                                            int Y0, int Z0, int Z1, int ex, int ey, int x0,
                                            int y0, int z0, bool from_b, float* smem) {
  constexpr int WG = ONCHIP_TILE + 2 * D;
  constexpr int G = WG * WG;
  constexpr int M = (G + NT - 1) / NT;  // cells per thread
  const int t = threadIdx.x;
  const float* src = from_b ? p.b : p.a;
  float* dst = from_b ? p.a : p.b;

  // this thread's cells q = t + i * NT of the grown plane: its ring (the
  // distance from the plane's edge: stage s computes the cell iff
  // ring >= s) and the in-plane offset of its source cell (-1: none)
  int ring[M], off[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int q = t + i * NT;
    const int qy = q / WG, qx = q - qy * WG;
    const int oy = Y0 + qy - D, ox = X0 + qx - D;  // in the written region
    ring[i] = q < G ? min(min(qy, WG - 1 - qy), min(qx, WG - 1 - qx)) : -1;
    if (ring[i] >= D && (ox >= ex || oy >= ey)) ring[i] = D - 1;
    off[i] = q < G ? (y0 + min(oy, ey + D - 1)) * (int)c.sy + x0 + min(ox, ex + D - 1) : -1;
  }
  float win[D][M][3];  // stage s at this cell for its last three planes, oldest first
  unsigned code[M];    // sel codes of the last planes, newest in bits 0-1
  float pf[M];         // the next source plane
  int ps[M];           // and its sel
  auto load = [&](int j) {
    const long long pz = (long long)(z0 + Z0 - D + j) * c.sz;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (off[i] >= 0) {
        pf[i] = __ldcg(src + pz + off[i]);
        ps[i] = ring[i] >= 1 ? __ldg(p.sel + pz + off[i]) : 0;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < M; ++i) code[i] = 0;
  load(0);

  const int nsteps = (Z1 - Z0) + 2 * D;
  for (int j = 0; j < nsteps; ++j) {
    // stage 0: the source plane Z0 - D + j
    {
      float* s0 = smem + ((Z0 - D + j) & 1) * G;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (off[i] >= 0) {
          win[0][i][0] = win[0][i][1];
          win[0][i][1] = win[0][i][2];
          win[0][i][2] = pf[i];
          s0[t + i * NT] = pf[i];
          code[i] = (code[i] << 2) | (ps[i] == 1 ? 1u : (ps[i] == 2 ? 2u : 0u));
        }
      }
      if (j + 1 < nsteps) load(j + 1);
    }
#pragma unroll
    for (int s = 1; s <= D; ++s) {
      if (j >= 2 * s) {
        const int v = Z0 - D + j - s;  // the plane stage s computes
        const float* in = smem + (2 * (s - 1) + (v & 1)) * G;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (ring[i] >= s) {
            const int q = t + i * NT;
            float sum = in[q - 1] + in[q + 1];
            sum = sum + in[q - WG];
            sum = sum + in[q + WG];
            sum = sum + win[s - 1][i][0];
            sum = sum + win[s - 1][i][2];
            const unsigned h = (code[i] >> (2 * s)) & 3u;
            const float val = h == 1u ? HOT : (h == 2u ? COLD : sum * SIXTH);
            if (s < D) {
              win[s][i][0] = win[s][i][1];
              win[s][i][1] = win[s][i][2];
              win[s][i][2] = val;
              smem[(2 * s + (v & 1)) * G + q] = val;
            } else {
              // a stage-D cell lies in the written region: off is unclamped
              dst[(long long)(z0 + v) * c.sz + off[i]] = val;
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// One pass of depth D by blocks of NT threads: reads `from_b ? b : a` over
// the compute region grown by g + D and writes the other buffer over the
// region grown by g. Uniform: every position nz x ny x nx, the tiles of one
// position after another. UNEVEN: each position at its extent from c.ext,
// its tiles after those of the positions before it; the z chunk is chosen
// once from every position's columns and the largest extent.
template <int D, int NT, bool UNEVEN>
__device__ __forceinline__ void onchip_pass(const MeshChunk& c, int g, bool from_b,
                                            float* smem) {
  // the written region's first cell in the padded block; the source region
  // starts D cells before it on each axis
  const int x0 = c.xo - g, y0 = c.yo - g, z0 = c.zo - g;
  const int ez0 = c.nz + 2 * g;
  if constexpr (!UNEVEN) {
    const int ex = c.nx + 2 * g, ey = c.ny + 2 * g;
    const int gx = (ex + ONCHIP_TILE - 1) / ONCHIP_TILE,
              gy = (ey + ONCHIP_TILE - 1) / ONCHIP_TILE;
    const int cols = gx * gy;
    const int zchunk = zchunk_for((long long)TILES_PER_BLOCK * gridDim.x,
                                  (long long)cols * c.npos, ez0);
    const int per_pos = cols * ((ez0 + zchunk - 1) / zchunk);
    const int tiles = per_pos * c.npos;
    for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
      const int u = w % per_pos;
      const int Z0 = (u / cols) * zchunk;
      onchip_tile<D, NT>(c, c.pos[w / per_pos], (u % gx) * ONCHIP_TILE,
                         ((u / gx) % gy) * ONCHIP_TILE, Z0, min(ez0, Z0 + zchunk), ex, ey, x0,
                         y0, z0, from_b, smem);
    }
  } else {
    auto tiles_of = [&](int i, int zchunk, int* ex, int* ey, int* ez, int* gx, int* gy) {
      *ex = (int)c.ext[3 * i + 2] + 2 * g;
      *ey = (int)c.ext[3 * i + 1] + 2 * g;
      *ez = (int)c.ext[3 * i] + 2 * g;
      *gx = (*ex + ONCHIP_TILE - 1) / ONCHIP_TILE;
      *gy = (*ey + ONCHIP_TILE - 1) / ONCHIP_TILE;
      return *gx * *gy * ((*ez + zchunk - 1) / zchunk);
    };
    int ex, ey, ez, gx, gy;
    long long all_cols = 0;
    for (int i = 0; i < c.npos; ++i) {
      tiles_of(i, 1, &ex, &ey, &ez, &gx, &gy);
      all_cols += (long long)gx * gy;
    }
    const int zchunk = zchunk_for((long long)TILES_PER_BLOCK * gridDim.x, all_cols, ez0);
    int tiles = 0;
    for (int i = 0; i < c.npos; ++i) tiles += tiles_of(i, zchunk, &ex, &ey, &ez, &gx, &gy);
    for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
      int pi = 0, u = w;
      for (int n; u >= (n = tiles_of(pi, zchunk, &ex, &ey, &ez, &gx, &gy)); ++pi) u -= n;
      const int Z0 = (u / (gx * gy)) * zchunk;
      onchip_tile<D, NT>(c, c.pos[pi], (u % gx) * ONCHIP_TILE, ((u / gx) % gy) * ONCHIP_TILE,
                         Z0, min(ez, Z0 + zchunk), ex, ey, x0, y0, z0, from_b, smem);
    }
  }
}

// B9's chunk: the messages, then the passes, a grid-wide barrier before each.
// Pass depths are K or K - 1 (pass_depth); MULTI instantiates the K - 1 body,
// which a chunk of one pass (k <= ONCHIP_KMAX) never runs, so that its
// registers go to the one body it does run.
template <int K, bool MULTI, bool UNEVEN>
__device__ __forceinline__ void mesh_onchip_chunk(const MeshChunk& c) {
  constexpr int NT = onchip_threads(K);
  extern __shared__ float onchip_smem[];  // [stage 0..D-1][plane & 1][WG * WG]
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  if constexpr (!UNEVEN) mesh_messages(c);
  const int n = chunk_passes(c.k);
  int left = c.k;
  for (int p = 0; p < n; ++p) {
    grid.sync();
    const int d = pass_depth(c.k, p);
    left -= d;
    if (d == K) {
      onchip_pass<K, NT, UNEVEN>(c, left, p & 1, onchip_smem);
    } else if constexpr (MULTI && K > 2) {
      onchip_pass<K - 1, NT, UNEVEN>(c, left, p & 1, onchip_smem);
    }
  }
}

// Fill a MeshChunk from the wrappers' arguments; false if the boxes do not fit.
inline bool make_mesh_chunk(const void* pos, int npos, const void* msg, int m, const int* boxes,
                            int nboxes, long long sz, long long sy, int zo, int yo, int xo,
                            int nz, int ny, int nx, int k, MeshChunk* c,
                            const void* ext = nullptr) {
  if (npos < 1 || m < 0 || nz < 1 || ny < 1 || nx < 1 || k < 1) return false;
  if (!make_dir_boxes(boxes, nboxes, &c->boxes)) return false;
  c->pos = (const MeshPosition*)pos;
  c->msg = (const MeshMessage*)msg;
  c->ext = (const long long*)ext;
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

// Resident blocks per SM of `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory on the current device (the attribute set first).
template <typename Kernel>
cudaError_t mesh_chunk_occupancy(Kernel kernel, int threads, size_t smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

// One cooperative launch of `kernel` (a __global__ taking one MeshChunk) on
// device dev, blocks of `block` threads with `smem` bytes of dynamic shared
// memory: as many blocks as can be resident at once (occupancy x SMs). A
// launch the device refuses returns its error; there is no fallback.
template <typename Kernel>
cudaError_t mesh_chunk_launch(Kernel kernel, const MeshChunk& c, int dev, void* stream,
                              dim3 block, size_t smem) {
  DeviceScope on(dev);
  if (on.error() != cudaSuccess) return on.error();
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = mesh_chunk_occupancy(kernel, (int)(block.x * block.y * block.z), smem, &per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < 1) return cudaErrorInvalidConfiguration;
  MeshChunk arg = c;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms), block, args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace jacobi
