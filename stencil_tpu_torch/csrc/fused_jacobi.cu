// One fused Jacobi step of every fp32 block position of one device in one
// cooperative launch: the halo hand-offs of every direction into curr, then
// one sweep of every position's compute region into nxt. A single,
// all-self-wrap block is the one-position case: its messages all wrap onto
// the block.
//
// Replaces: stencil_tpu/ops/fused_stencil.py make_fused_jacobi_kernel, in its
// all-self-wrap (one device) form and its wire-crossing form (a mesh of block
// positions: barrier with the neighbours, start a remote copy per crossing
// direction, sweep on pre-exchange data, wait, unpack, re-sweep the boundary
// planes). Python wrappers and plain PyTorch versions:
// stencil_tpu_torch/ops/fused_stencil.py (fused_jacobi / fused_jacobi_plain on
// one block, fused_jacobi_mesh / fused_jacobi_mesh_plain over a mesh).
//
// What it computes: every direction's exact-extent message of the fused plan,
// from each position's compute cells into the halo box of the position + d
// (crossing and self-wrap alike), in place; then every position's compute
// region of nxt <- one sweep of its curr, reading those halos
// (sweep_runs.cuh). Nothing else of nxt is written. The TPU kernel sweeps
// before its copies land and re-sweeps the boundary; here the copies are
// small and the barrier cheap, so the sweep waits for them and runs once.
//
// What bounds it on an H100: bytes. The sweep reads curr and sel and writes
// nxt once per compute cell (12 bytes), and each message cell is read and
// written once (8 bytes): 0.481 ms at 512^3 radius 1 on one block, 0.488 over
// 8 positions of 256^3 (H100 80GB HBM3 at 700 W, 3.35 TB/s). What sets its
// pace: phase B's three streams run below the rate of an elementwise pass
// over the same three arrays, and phase A is almost all the x faces' row
// ends, one scattered 32-byte sector read and one written per row end, at
// the rate self_fill.cu's x fill meets (apps/bench_kernels.py times both
// yardsticks beside the kernel; PERF.md).
//
// Design. Phase A, the hand-offs, moves rows, not cells: its work list
// (fused_stencil.message_rows, computed in Python, read from a device table
// of SEG_COLS int64 a row) splits each message box into segments of whole
// rows, each row of a segment the same units of one width: the rows of the
// y and z faces and of the yz edges (compute-extent x) move as 16-byte
// vectors where source and destination agree in phase, with a 4-byte head
// and tail; every other row, and every row of a layout off the 16-byte grid,
// moves 4 bytes at a time, the words of consecutive rows on adjacent lanes
// (the x faces' row ends: the layout of self_fill.cu). A task is up to TASK
// units of one segment and one message, a block's threads each loading
// UNROLL units before storing them; a block finds its task's segment once
// (a binary search over the table), and each unit costs two 32-bit divides.
// Sources are read through L2 (ld.global.cg), so no line of curr enters L1
// before the barrier. Then cooperative_groups::this_grid().sync(), and phase
// B: the blocks walk tiles x z chunks x positions in turn, each tile swept by
// sweep_runs.cuh, reading the filled halos at fixed offsets with whole-vector
// copies. The grid is every block that can be resident at once (occupancy x
// SMs, with the ring's dynamic shared memory), and the z chunks are chosen for
// that walk (zchunks_for).
//
// The narrowed wire (the TPU kernel's wire_dtype form, fused_stencil.py:292):
// a launch takes one wire code W (wire_round.cuh; fp32 fields narrow to
// bf16, fp16, e4m3, e5m2, or any other format as W = SOFT by the format in
// the launch's parameters), and a segment flagged narrow (its box crosses between
// positions) rounds each word of a unit between phase A's load and its store:
// the TPU kernel's narrow staging and widening unpack, in registers, in the
// same launch. W = NONE is the unnarrowed kernel, unchanged: the rounding is
// compiled only into the W != NONE instantiations. One block has no
// crossing box, so its form launches W = NONE.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mesh_chunk.cuh"
#include "sweep_runs.cuh"
#include "wire_round.cuh"

namespace {

using jacobi::MeshMessage;
using jacobi::MeshPosition;

constexpr int SEG_COLS = 10;            // int64 columns of a work-list row
constexpr int MAX_SEGS = 26 * 3;        // a box splits into at most a head, a body and a tail
constexpr int UNROLL = 4;               // units a thread loads before it stores
constexpr int TASK = runs::NT * UNROLL;  // units of one task

// One segment of the work list: `rows` rows of one message box (ey a plane),
// each `units` units of `width` words, the first unit of the first row at
// offset src (source) and dst (destination) of a position's block; `chunks`
// tasks per message, the segments before it `start` tasks over all messages;
// `narrow` set where the box's words round through the launch's wire.
struct RowSeg {
  long long box, src, dst, units, width, ey, rows, chunks, start, narrow;
};
static_assert(sizeof(RowSeg) == SEG_COLS * sizeof(long long), "a work-list row");

struct Step {
  const MeshPosition* pos;
  const MeshMessage* msg;
  const RowSeg* segs;
  int npos, m, nseg;
  long long tasks;
  runs::Geometry g;
  wire::Format fmt;  // the format W = SOFT rounds into
};

// Units i0 + u * NT (u < UNROLL, below n) of a segment, V a unit, WIRE the
// wire of format f.
template <typename V, int WIRE>
__device__ __forceinline__ void move_units(const float* src, float* dst, const RowSeg& s,
                                           unsigned n, unsigned i0, long long sz, int sy,
                                           const wire::Format& f) {
  constexpr int WORDS = sizeof(V) / sizeof(float);
  const unsigned units = (unsigned)s.units, ey = (unsigned)s.ey;
  long long off[UNROLL];
  V v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = i0 + u * runs::NT;
    if (i < n) {
      const unsigned r = i / units, x = i - r * units;
      const unsigned rz = r / ey, ry = r - rz * ey;
      off[u] = (long long)rz * sz + (long long)ry * sy + x * WORDS;
      v[u] = __ldcg(reinterpret_cast<const V*>(src + off[u]));
      if constexpr (WIRE != wire::NONE) {
        if (s.narrow) v[u] = wire::narrow<WIRE>(v[u], f);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (i0 + u * runs::NT < n) *reinterpret_cast<V*>(dst + off[u]) = v[u];
}

// Phase A: every task of the work list, the blocks taking tasks in turn.
template <int WIRE>
__device__ __forceinline__ void move_rows(const Step& s) {
  for (long long t = blockIdx.x; t < s.tasks; t += gridDim.x) {
    int lo = 0, hi = s.nseg - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s.segs[mid].start <= t) lo = mid;
      else hi = mid - 1;
    }
    const RowSeg seg = s.segs[lo];
    const long long k = t - seg.start;
    const long long j = k / seg.chunks;  // the message: its source position
    const MeshMessage msg = s.msg[seg.box * s.m + j];
    const float* src = s.pos[msg.src].a + seg.src;
    float* dst = s.pos[msg.dst].a + seg.dst;
    const unsigned n = (unsigned)(seg.rows * seg.units);
    const unsigned i0 = (unsigned)((k - j * seg.chunks) * TASK) + threadIdx.x;
    if (seg.width == 4) move_units<float4, WIRE>(src, dst, seg, n, i0, s.g.sz, s.g.sy, s.fmt);
    else move_units<float, WIRE>(src, dst, seg, n, i0, s.g.sz, s.g.sy, s.fmt);
  }
}

template <int WIRE>
__global__ void __launch_bounds__(runs::NT, runs::MIN_BLOCKS)
fused_step_kernel(const __grid_constant__ Step s) {
  extern __shared__ __align__(16) float smem[];
  move_rows<WIRE>(s);
  cooperative_groups::this_grid().sync();
  const int per_pos = s.g.gx * s.g.gy * s.g.nzc;
  const int tiles = per_pos * s.npos;
  for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
    const MeshPosition p = s.pos[w / per_pos];
    runs::sweep_tile(s.g, p.a, p.b, p.sel, smem, w % per_pos);
  }
}

// z chunks per tile column when `blocks` resident blocks walk `cols` tile
// columns (every position's) of nz planes in turn: the count whose walk ends
// soonest. A block takes ceil(tiles / blocks) tiles of its chunk's planes
// plus a 2-step warm-up each, the last, partial round of tiles included;
// the fewest chunks on a tie, no chunk under 4 planes.
// fused_stencil.fused_zchunks mirrors it.
int zchunks_for(long long cols, int nz, long long blocks) {
  int best = 1;
  long long best_steps = LLONG_MAX;
  const int most = nz / 4 > 1 ? nz / 4 : 1;
  for (int n = 1; n <= most; ++n) {
    const int c = (nz + n - 1) / n;
    const long long tiles = cols * ((nz + c - 1) / c);
    const long long steps = (tiles + blocks - 1) / blocks * (c + 2);
    if (steps < best_steps) best_steps = steps, best = n;
  }
  return best;
}

// The kernel of a wire code, or null for one fp32 fields do not take.
const void* kernel_for(int w) {
  switch (w) {
    case wire::NONE: return (const void*)fused_step_kernel<wire::NONE>;
    case wire::BF16: return (const void*)fused_step_kernel<wire::BF16>;
    case wire::F16: return (const void*)fused_step_kernel<wire::F16>;
    case wire::E4M3: return (const void*)fused_step_kernel<wire::E4M3>;
    case wire::E5M2: return (const void*)fused_step_kernel<wire::E5M2>;
    case wire::SOFT: return (const void*)fused_step_kernel<wire::SOFT>;
    default: return nullptr;
  }
}

cudaError_t occupancy(const void* kernel, int* per_sm) {
  return jacobi::mesh_chunk_occupancy(kernel, runs::NT, (size_t)runs::SMEM, per_sm);
}

}  // namespace

// pos: device table of npos rows (curr, nxt, sel pointers); msg: device table
// of nboxes * m rows (source position, destination position, box index), m
// rows per box in box order; segs: device table of nseg rows of seg_cols
// int64 (the work list, fused_stencil.message_rows), `tasks` tasks in all;
// every block a contiguous padded fp32 array with plane stride sz and row
// stride sy, compute region at (zo, yo, xo) of nz x ny x nx cells, halos of
// at least one cell; vec: every pointer on the 16-byte grid and sz, sy
// multiples of 4; w: the wire code (wire_round.cuh; 0 copies bits) of the
// segments flagged narrow, fmt its format's parameters
// (halo_fill.wire_params; read for wire::SOFT); dev: the device of every
// block. A launch the
// device refuses returns its error; there is no fallback.
extern "C" int fused_jacobi_launch(const void* pos, int npos, const void* msg, int m,
                                   const void* segs, int nseg, int seg_cols, long long tasks,
                                   long long sz, long long sy, int zo, int yo, int xo, int nz,
                                   int ny, int nx, int vec, int w, const double* fmt, int dev,
                                   void* stream) {
  const void* kernel = kernel_for(w);
  if (npos < 1 || m < 1 || nseg < 1 || nseg > MAX_SEGS || seg_cols != SEG_COLS || tasks < 1 ||
      tasks > INT_MAX || nz < 1 || ny < 1 || nx < 1 || zo < 1 || yo < 1 || xo < 1 ||
      sz >= (1LL << 31) || sy < xo + nx + 1 || sz < sy * (yo + ny + 1) || (vec != 0 && vec != 1) ||
      !kernel || (w == wire::SOFT && !fmt))
    return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = occupancy(kernel, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm * sms < 1) return (int)cudaErrorInvalidConfiguration;
  Step s;
  s.pos = (const MeshPosition*)pos;
  s.msg = (const MeshMessage*)msg;
  s.segs = (const RowSeg*)segs;
  s.npos = npos;
  s.m = m;
  s.nseg = nseg;
  s.tasks = tasks;
  s.fmt = wire::Format::from(fmt);
  runs::Geometry& g = s.g;
  g.sz = sz;
  g.sy = (int)sy;
  g.py = (int)(sz / sy);
  g.zo = zo;
  g.yo = yo;
  g.xo = xo;
  g.nz = nz;
  g.ny = ny;
  g.nx = nx;
  g.gx = runs::tiles_x(nx, xo);
  g.gy = (ny + runs::TY - 1) / runs::TY;
  const long long cols = (long long)g.gx * g.gy * npos;
  const int nzc = zchunks_for(cols, nz, (long long)per_sm * sms);
  g.zchunk = (nz + nzc - 1) / nzc;
  g.nzc = (nz + g.zchunk - 1) / g.zchunk;
  g.vec = vec;
  if (cols * g.nzc > INT_MAX) return (int)cudaErrorInvalidValue;
  void* args[] = {&s};
  e = cudaLaunchCooperativeKernel(kernel, dim3(per_sm * sms),
                                  dim3(runs::NT), args, (size_t)runs::SMEM,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The kernel of wire code w on device dev: r[0..4] = resident blocks per SM,
// registers per thread, local (spill) bytes per thread, threads per block,
// dynamic shared memory bytes.
extern "C" int fused_jacobi_info(int dev, int w, int* r) {
  const void* kernel = kernel_for(w);
  if (!kernel) return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  cudaError_t e = occupancy(kernel, &r[0]);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  r[1] = a.numRegs;
  r[2] = (int)a.localSizeBytes;
  r[3] = runs::NT;
  r[4] = (int)runs::SMEM;
  return 0;
}

// z chunks per tile column of a launch over npos positions of nz x ny x nx
// cells at padded x offset xo, walked by `blocks` resident blocks.
extern "C" int fused_jacobi_zchunks(int nz, int ny, int nx, int xo, int npos, int blocks) {
  if (nz < 1 || ny < 1 || nx < 1 || npos < 1 || blocks < 1) return -1;
  const long long cols =
      (long long)runs::tiles_x(nx, xo) * ((ny + runs::TY - 1) / runs::TY) * npos;
  return zchunks_for(cols, nz, blocks);
}
