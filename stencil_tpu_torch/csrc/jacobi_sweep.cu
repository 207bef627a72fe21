// One 7-point Jacobi step over rects of padded fp32 or fp64 blocks, one
// launch for a table of sweep tasks.
//
// Replaces: stencil_tpu/ops/pallas_stencil.py make_pallas_jacobi_sweep
// (the TPU kernel that tiles (tz, ty) slabs through VMEM with double-buffered
// DMA), in every form the port drives: one block or a resident stack (wrap
// flags on the single-block axes), the batch= tenant form (every axis
// wrapping onto the tenant), the overlap shells of a partition, every
// position of a mesh, every shell of a step. Python wrappers, the table's
// layout and plain PyTorch versions: stencil_tpu_torch/ops/stencil_kernels.py
// (sweep, sweep_tenants, sweep_region, sweep_positions, sweep_regions;
// sweep_table; sweep_plain).
//
// What it computes: for every task of the table and every block of the task,
// out's cells of the task's rect <- the 6-neighbour average of curr,
// (x_lo + x_hi + y_lo + y_hi + z_lo + z_hi) left to right times 1/6 rounded
// to the field's type, then sel == 1 -> 1.0, sel == 2 -> 0.0 on the task's sel planes
// only (the TPU kernel's sel_z_range: tiles outside the spheres' planes skip
// the sel DMA and the select). On a wrapping axis the neighbour outside the
// rect is the periodic one inside it, by index; otherwise it is read in
// place (a halo cell, or a cell of curr outside a shell). Nothing else of
// out is written. Tasks write disjoint cells and read only curr, so the
// launch runs them in any order. (The TPU kernel also copies the input's
// halo values into the rows it stores, a store-granularity artefact of its
// tiles; nothing reads them, and this kernel does not.)
//
// What bounds it on an H100: bytes. Per cell it reads curr once and writes
// out once, and reads sel on the sel planes (8 to 12 bytes in fp32, 16 to 20
// in fp64) for 6 adds and a multiply, far below the card's balance point in
// either type (fp64's, at half fp32's issue rate, too).
//
// Design: sweep_runs.cuh's body (B8's phase B), its B1 instantiations
// (flex_tile, fp32 and fp64): 16-byte x runs (4 fp32 or 2 fp64 cells) fed by
// a 6-plane cp.async ring of the same bytes in either type, each task with
// its own tile shape, wrap flags and sel range; in fp32 8-byte units where a
// row is on the 8-byte grid only. The table's tile shapes are in cells of
// the launch's type (stencil_kernels.sweep_tile). A task row of the table (int64 columns, laid out
// by stencil_kernels.sweep_table) stands for `count` blocks `stride`
// elements apart (the tenants of a slot) and holds its tiles' shape and z
// chunks, so a launch is a flat walk over every tile of every task: x tile
// fastest, then y tile, z chunk, block and task. The grid is the blocks that
// can be resident at once (or fewer when there are fewer tiles), each taking
// tiles in turn; a block's thread 0 finds its tile's task by a binary search
// over the rows' first tiles and stages the task's geometry in shared memory
// (sweep_runs.cuh's Flex), where the other threads read it as they use it
// (B8's geometry is a kernel parameter, B1's varies by task; every thread
// searching and holding it in registers timed 2-4% slower at the uneven
// positions and the 32^3 tenants on an H100, PERF.md). No grid barrier: an
// ordinary launch.
//
// Arithmetic: built without fast math and with -fmad=false, so every
// operation rounds as written: bit-exact to the plain versions and to the
// JAX package (XLA folds its `sum / 6` into the multiply by 1/6 rounded to
// the type, in float32 and float64 alike).

#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi_column.cuh"
#include "sweep_runs.cuh"

namespace {

constexpr int TASK_COLS = 21;  // int64 columns of a task row

// One row of the task table.
struct SweepTask {
  long long curr, out, sel, stride, count, start, zo, yo, xo, nz, ny, nx, wrap, slo, shi, tx, ty,
      gx, gy, zchunk, nzc;
};
static_assert(sizeof(SweepTask) == TASK_COLS * sizeof(long long), "a task row");

// Everything a launch needs; passed as one __grid_constant__ parameter.
struct Launch {
  const SweepTask* task;
  int ntask;
  long long tiles;  // over every task
  long long sz;     // plane stride of every block (elements)
  int sy, py;       // row stride, padded rows
  int align;        // cells (C, ..., 1) every pointer, stride and sz are a multiple of
};

// What the block's thread 0 reads of a tile's task for all its threads.
template <typename T>
struct TileOf {
  const T* curr;
  T* out;
  const int32_t* sel;
  int tx, ty, tz;
};

// Two blocks per SM, where B8 holds three: B1's geometry varies by task, and
// at three blocks (56 registers a thread) the body spills; at two it takes
// 72 and spills nothing (PERF.md). The fp64 instantiation keeps two.
constexpr int MIN_BLOCKS = 2;

template <typename T>
__global__ void __launch_bounds__(runs::NT, MIN_BLOCKS)
jacobi_sweep_kernel(const __grid_constant__ Launch L) {
  using E = runs::Elem<T>;
  // declared as words in both instantiations (one type for the one array)
  extern __shared__ __align__(16) float smem_words[];
  T* smem = reinterpret_cast<T*>(smem_words);
  __shared__ runs::Flex f;
  __shared__ TileOf<T> at;
  for (long long w = blockIdx.x; w < L.tiles; w += gridDim.x) {
    // the previous tile ended with a barrier: f and at are free
    if (threadIdx.x == 0) {
      int lo = 0, hi = L.ntask - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (L.task[mid].start <= w) lo = mid;
        else hi = mid - 1;
      }
      const SweepTask& k = L.task[lo];
      f.sz = L.sz;
      f.sy = L.sy;
      f.py = L.py;
      f.zo = (int)k.zo;
      f.yo = (int)k.yo;
      f.xo = (int)k.xo;
      f.nz = (int)k.nz;
      f.ny = (int)k.ny;
      f.nx = (int)k.nx;
      f.gx = (int)k.gx;
      f.gy = (int)k.gy;
      f.zchunk = (int)k.zchunk;
      f.tx = (int)k.tx;
      f.ty = (int)k.ty;
      f.pitch = E::C * (((int)k.tx + 3 * E::C - 1) >> E::SHIFT);
      f.wrap = (int)k.wrap;
      f.slo = (int)k.slo;
      f.shi = (int)k.shi;
      f.align = L.align;
      const long long per_block = k.gx * k.gy * k.nzc;
      const long long t = w - k.start;
      const long long r = t / per_block;
      const int u = (int)(t - r * per_block);
      const long long off = r * k.stride;
      at.curr = reinterpret_cast<const T*>(k.curr) + off;
      at.out = reinterpret_cast<T*>(k.out) + off;
      at.sel = reinterpret_cast<const int32_t*>(k.sel) + off;
      at.tx = u % f.gx;
      at.ty = u / f.gx % f.gy;
      at.tz = u / (f.gx * f.gy);
    }
    __syncthreads();
    runs::flex_tile(f, at.curr, at.out, at.sel, smem, at.tx, at.ty, at.tz);
  }
}

static_assert(runs::B1_SMEM <= 48 * 1024, "within the shared memory a block gets unasked");

template <typename T>
int launch(const Launch& L, int grid, cudaStream_t st) {
  jacobi_sweep_kernel<T><<<grid, runs::NT, (size_t)runs::B1_SMEM, st>>>(L);
  return (int)cudaGetLastError();
}

template <typename T>
int info(int* r) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r[0], jacobi_sweep_kernel<T>,
                                                                runs::NT, (size_t)runs::B1_SMEM);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, jacobi_sweep_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  r[1] = a.numRegs;
  r[2] = (int)a.localSizeBytes;
  r[3] = runs::NT;
  r[4] = (int)runs::B1_SMEM;
  return 0;
}

}  // namespace

// tasks: device table of ntask rows of task_cols int64 (stencil_kernels.
// sweep_table), `tiles` tiles in all; every block a padded array of item-
// byte cells (4: fp32, 8: fp64; sel int32) with plane stride sz, row stride
// sy and py rows; align: the cells (16 / item, ..., 1) every pointer, block
// stride and sz are a multiple of; grid: the blocks to launch (at most the
// tiles); dev: the device of every block. A launch the device refuses
// returns its error; there is no fallback.
extern "C" int jacobi_sweep_launch(const void* tasks, int ntask, int task_cols, long long tiles,
                                   long long sz, long long sy, long long py, int align, int item,
                                   int grid, int dev, void* stream) {
  if (ntask < 1 || task_cols != TASK_COLS || tiles < 1 || grid < 1 || grid > tiles || sy < 1 ||
      py < 1 || sz < sy * py || sz >= (1LL << 31) || (item != 4 && item != 8) ||
      (align != 1 && align != 2 && align != 4) || align > 16 / item)
    return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  Launch L;
  L.task = (const SweepTask*)tasks;
  L.ntask = ntask;
  L.tiles = tiles;
  L.sz = sz;
  L.sy = (int)sy;
  L.py = (int)py;
  L.align = align;
  return item == 8 ? launch<double>(L, grid, (cudaStream_t)stream)
                   : launch<float>(L, grid, (cudaStream_t)stream);
}

// The instantiation for item-byte cells (4: fp32, 8: fp64) on device dev:
// r[0..4] = resident blocks per SM, registers per thread, local (spill)
// bytes per thread, threads per block, dynamic shared memory bytes.
extern "C" int jacobi_sweep_info(int dev, int item, int* r) {
  if (item != 4 && item != 8) return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  return item == 8 ? info<double>(r) : info<float>(r);
}
