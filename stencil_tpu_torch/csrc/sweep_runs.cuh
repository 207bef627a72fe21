// One Jacobi sweep of a tile of a block by 16-byte x runs (4 fp32 cells or
// 2 fp64 cells): the body of B8's fused step (fused_jacobi.cu, fp32) and of
// B1's sweep (jacobi_sweep.cu, fp32 and fp64).
//
// What a tile computes: out's cells of one output tile (TX wide, TY high,
// one z chunk) <- the 6-neighbour average of curr, (x_lo + x_hi + y_lo +
// y_hi + z_lo + z_hi) left to right times 1/6 rounded to the field's type,
// then sel == 1 -> 1.0, sel == 2 -> 0.0: the operand order of every Jacobi
// kernel of the package, so a tile is bit-exact to the plain sweep (built
// with -fmad=false). Nothing else of out is written.
//
// The body is a template on the element type T. A thread's run is 16 bytes
// in either type (Elem<T>::C cells), and the ring's plane the same bytes
// (PLANE floats, Elem<T>::PLANE_T elements), so an fp64 tile is half as wide
// in cells as the fp32 tile of the same shared memory, with the same threads
// and about the same registers. fp64 runs have no 8-byte mode and no patched
// row ends (an fp64 cell is itself an 8-byte unit).
//
// Instantiations of one body (the template flag B1 and T):
// - B8's (B1 = false, sweep_tile, fp32): the compute region of a block whose
//   halos are already filled, 128 x 8 tiles; neighbours outside the region
//   are read from curr's halos, with no wrap.
// - B1's (B1 = true, flex_tile, fp32 and fp64): any rect of a block (the
//   compute region, a shell), with what a task of jacobi_sweep.cu's table
//   gives it:
//   - a tile of its own shape (Flex::tx x Flex::ty, the ring's plane holding
//     at most PLANE floats' bytes), so that a 171-wide block, a 1-cell x
//     shell or a 32^3 tenant does not idle most of a 128-wide tile's threads;
//   - wrap flags: on a wrapping axis a neighbour outside the rect is the
//     periodic one inside it, by index (as jacobi_multistep.cu maps its
//     sources), so a single block or a tenant reads no halo at all and the
//     tight-x layout (Radius::without_x, no x halo columns) works; a run is
//     copied as one vector when its mapped cells are contiguous and aligned,
//     and, in a row of several tiles, a row's end run whose x = -1 or x = nx
//     wraps (x offset 1 to 3) as one vector of its own padded cells plus
//     that one cell, patched in as the step takes the plane (copied 4 bytes
//     a cell, such runs made a wrapped 512^3 sweep on an H100 slower than
//     an unwrapped one; PERF.md);
//   - a sel plane range [slo, shi): planes outside it load no sel and
//     impose no sphere (the TPU kernel's sel_z_range);
//   - fp32: 8-byte units where a row is on the 8-byte grid but not the
//     16-byte one (an even row pitch that is not a multiple of 4 floats: the
//     campaign's unaligned tenants, pitch 34 or 130), chosen per run.
//   Its loads may take any path: B1 writes nothing it reads.
//
// Design: the multistep kernel's (jacobi_multistep.cu) at depth 1.
// - A thread owns a C-cell x run of one row of the tile grown by one cell
//   (ty + 2 rows of (tx + 3C - 1) / C runs). Runs sit on the padded block's
//   16-byte grid: the first tile of a row starts at the region's first
//   column and is up to C - 1 columns wider, every later tile starts its
//   output on the grid, so a run's plane arrives as one 16-byte cp.async and
//   its output leaves as one 16-byte store. Where the layout does not allow
//   it (B8: `vec` 0, a row pitch or plane stride that is not a multiple of 4
//   floats, or a pointer off the 16-byte grid; B1: per run, by its mapped
//   address) and for runs clamped at a padded row's ends, cells move 8 or 4
//   bytes at a time (fp64: a cell at a time).
// - curr's planes are copied LOOK planes ahead of use into a ring of
//   RING = LOOK + 2 planes in shared memory by cp.async.cg (L2, coherent:
//   other blocks of B8's launch wrote the halos; never the read-only path).
//   The step loop is unrolled over the ring's slots (a multiple of 6), so
//   every ring slot, window slot and sel buffer is a constant.
// - z neighbours: a three-plane register window of the thread's own run;
//   x neighbours: the run's own cells and, at its ends, warp shuffles
//   (shared memory for lanes 0 and 31); y neighbours: 16-byte reads of rows
//   y - 1 and y + 1 of the ring's plane.
// - sel arrives by one load a run on the read-only path (it is never
//   written; 16 bytes for 4 fp32 cells, 8 for 2 fp64 cells), loaded one
//   plane ahead of use into one of two register sets; out leaves by 16-byte
//   stores.
// - One barrier a plane: plane j's copy has landed for every thread, and
//   the slot plane j + LOOK goes to (plane j - 2's) is no longer read.
// Offsets within a plane are 32-bit (the launches refuse a plane of 2^31
// elements or more), plane offsets 64-bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace runs {

// The tile and ring: probe builds at 512^3 on an H100 (80GB HBM3, 700 W) ran
// 64 x 16, 64 x 8, 128 x 4, 128 x 6, 128 x 12, 192 x 4 and 256 x 4 tiles, two
// to six blocks per SM and rings of 12 and 18 planes; none beat 128 x 8 at
// three blocks per SM with a 6-plane ring (PERF.md).
constexpr int TX = 128;         // output tile width, x (the first tile of a row is up to 3 wider)
constexpr int TY = 8;           // output tile height, y
constexpr int LOOK = 4;         // planes in flight ahead of use
constexpr int MIN_BLOCKS = 3;   // B8's resident blocks per SM (B1's: jacobi_sweep.cu)
constexpr int RING = LOOK + 2;  // ring planes
constexpr int ROWS = TY + 2;    // rows of the grown tile
// runs of a row: enough for the widest tile grown by one cell on each side
// at any 16-byte phase of its first cell
constexpr int RUNS = (3 + TX + 3 + 2 + 3) / 4;
constexpr int PITCH = 4 * RUNS;  // floats per shared-memory row
constexpr int PLANE = ROWS * PITCH;
constexpr int NT = (ROWS * RUNS + 31) / 32 * 32;  // threads of a block
// a guard row, the ring, a guard row
constexpr long long SMEM = 4LL * (RING * PLANE + 2 * PITCH);
// B1's: then two patch cells per row (a tile has at most PLANE / 12 rows: a
// run of 3) and ring slot, for the x-wrapped cells of a row's two end runs
constexpr int PATCH_ROWS = PLANE / 12;
constexpr long long B1_SMEM = SMEM + 4LL * RING * 2 * PATCH_ROWS;
constexpr unsigned FULL = 0xffffffffu;
constexpr float SIXTH = 1.0f / 6.0f;
constexpr float HOT = 1.0f;
constexpr float COLD = 0.0f;
static_assert(RING % 6 == 0, "ring slots, window slots and sel sets repeat every RING steps");
static_assert(PLANE / 4 <= NT, "a B1 tile of (ty + 2) x runs <= PLANE / 4 runs has a thread each");

// Per element type: the cells of a 16-byte run (C, a power of two; SHIFT its
// log2), the ring's plane and a guard row in elements at the bytes of the
// fp32 ones, and 1/6 rounded to T.
template <typename T>
struct Elem {
  static constexpr int C = 16 / (int)sizeof(T);
  static constexpr int SHIFT = C == 4 ? 2 : 1;
  static constexpr int PLANE_T = PLANE * 4 / (int)sizeof(T);
  static constexpr int GUARD = PITCH * 4 / (int)sizeof(T);
  static constexpr T SIXTH_T = T(1) / T(6);
  static_assert(C == 4 || C == 2, "fp32 or fp64 cells");
};

// The geometry of a sweep: the same for every block position and tile.
struct Geometry {
  long long sz;     // plane stride (elements)
  int sy, py;       // row stride (x is unit); padded rows
  int zo, yo, xo;   // compute-region origin in the padded block
  int nz, ny, nx;   // compute-region extent
  int gx, gy;       // tiles along x and y
  int zchunk, nzc;  // output planes per z chunk, z chunks per tile column
  int vec;          // pointers and strides allow 16-byte runs
};

// B1's geometry of one task (jacobi_sweep.cu's table gives it): the rect
// (Geometry's region), its own tile shape, wrap flags, sel range and
// alignment; jacobi_sweep.cu stages it in shared memory, where B8's
// Geometry is a kernel parameter.
struct Flex : Geometry {
  int tx, ty;    // tile width (multiple of C) and height
  int pitch;     // elements per ring row: C * (tx + 3C - 1) / C runs
  int wrap;      // bit 0 x, bit 1 y, bit 2 z: periodic by index within the rect
  int slo, shi;  // output planes (rect-relative) whose sel is read: [slo, shi)
  int align;     // cells (C, ..., 1) that every pointer and plane stride are a multiple of
};

// Tiles along x of an nx-wide region starting at padded x = xo, tx wide:
// the first is [0, tx + a), tile t >= 1 is [t tx + a, (t + 1) tx + a),
// a = -xo mod c (c cells a 16-byte run), so every tile after the first
// starts its output on the 16-byte grid.
__host__ __device__ inline int tiles_x(int nx, int xo, int tx = TX, int c = 4) {
  const int t = (nx - (-xo & (c - 1)) + tx - 1) / tx;
  return t < 1 ? 1 : t;
}

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

__device__ __forceinline__ int wrapi(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 8 and 4 bytes can only go through L1 (cp.async.ca); no line of curr is in
// L1 before the barrier that precedes B8's sweep (the hand-offs read through
// L2), and L1 starts empty at each launch, so no stale halo is read; B1's
// launch writes nothing it reads
__device__ __forceinline__ void cp8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// one cell
__device__ __forceinline__ void cp_cell(float* dst, const float* src) { cp4(dst, src); }
__device__ __forceinline__ void cp_cell(double* dst, const double* src) { cp8(dst, src); }

// A run as two 8-byte halves (fp32's 8-byte units; an fp64 run's halves are
// its cells).
__device__ __forceinline__ void cp_halves(float* dst, const float* src, const int (&xq)[4]) {
  cp8(dst, src + xq[0]);
  cp8(dst + 2, src + xq[2]);
}
__device__ __forceinline__ void cp_halves(double* dst, const double* src, const int (&xq)[2]) {
  cp8(dst, src + xq[0]);
  cp8(dst + 1, src + xq[1]);
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// (x_lo + x_hi + y_lo + y_hi + z_lo + z_hi) * 1/6, left to right
template <typename T>
__device__ __forceinline__ T avg6(T xl, T xh, T yl, T yh, T zl, T zh) {
  T s = xl + xh;
  s = s + yl;
  s = s + yh;
  s = s + zl;
  s = s + zh;
  return s * Elem<T>::SIXTH_T;
}

// A run's cells by one 16-byte access (shared or global memory).
__device__ __forceinline__ void ld_run(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
}
__device__ __forceinline__ void ld_run(const double* p, double (&o)[2]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  o[0] = a.x, o[1] = a.y;
}
__device__ __forceinline__ void st_run(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void st_run(double* p, const double (&o)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
}
// ... and by two 8-byte ones (fp32's 8-byte units)
__device__ __forceinline__ void st_halves(float* p, const float (&o)[4]) {
  *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  *reinterpret_cast<float2*>(p + 2) = make_float2(o[2], o[3]);
}
__device__ __forceinline__ void st_halves(double* p, const double (&o)[2]) {
  p[0] = o[0];
  p[1] = o[1];
}

// A run's sel codes (int32, on the read-only path): one load of its C
// codes, or two 8-byte halves.
__device__ __forceinline__ void ld_sel(const int32_t* p, int (&s)[4]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
}
__device__ __forceinline__ void ld_sel(const int32_t* p, int (&s)[2]) {
  const int2 a = __ldg(reinterpret_cast<const int2*>(p));
  s[0] = a.x, s[1] = a.y;
}
__device__ __forceinline__ void ld_sel_halves(const int32_t* p, int (&s)[4]) {
  const int2 a = __ldg(reinterpret_cast<const int2*>(p));
  const int2 d = __ldg(reinterpret_cast<const int2*>(p + 2));
  s[0] = a.x, s[1] = a.y, s[2] = d.x, s[3] = d.y;
}
__device__ __forceinline__ void ld_sel_halves(const int32_t* p, int (&s)[2]) { ld_sel(p, s); }

// What a block knows of its tile, the same for all its threads.
template <typename T>
struct Tile {
  const T* curr;
  T* out;
  const int32_t* sel;
  T* ring;      // after the leading guard row
  int Z0;       // first output plane
  int nsteps;   // plane steps: the chunk's planes and a 2-step warm-up
};

// What a thread owns: one C-cell run of a row of the grown tile, at offset
// me in a ring plane; whether it holds a cell of the grown tile (ld); its
// source row's offset in a plane and its cells' source x (clamped into the
// padded block, or wrapped); whether it copies as one 16-byte vector (vcp)
// or as two 8-byte ones (v8, B1 fp32); its output cells (st: bits 0 to C - 1,
// bit 8 when they store as one aligned 16-byte vector, bit 9 as two 8-byte
// ones, B1 fp32)
// and their row offset (ooff, of the run's first cell); per plane slot its
// cells' values (w[slot][cell], slot = step mod 3) and two sets of sel
// values (step parity). B1 keeps one set of sel values, packed into two
// bits a cell (sk: 1 hot, 2 cold, 0 the average) as the step that uses
// them starts (two sets ran 4-7% slower where sel is read on every plane,
// on an H100; PERF.md); folds the row offsets into its own pointers (src:
// curr + yoff; dst, sp: out and sel + ooff); and, for a run whose x = -1
// or x = nx wraps, copies the run from its own padded cells and that one
// cell from the row's other end into the patch area (patch: its padded x
// << 10 | (2 row + side) << 2 | cell, side 1 for x = nx; or -1; fp32 only).
template <typename T>
struct Run {
  static constexpr int C = Elem<T>::C;
  T w[3][C];
  int sl[2][C];
  int me, lane, yoff, ooff, st;
  int xq[C];
  bool ld, vcp, v8;
  unsigned sk;
  int patch;
  const T* src;
  T* dst;
  const int32_t* sp;
};

// B1's patch cell r = 2 row + side in ring slot Q (after the trailing guard
// row; fp32).
__device__ __forceinline__ float* patch_cell(const Tile<float>& b, int q, int r) {
  return b.ring + RING * PLANE + PITCH + q * 2 * PATCH_ROWS + r;
}

// Copy the run's cells of step jj's plane (Z0 - 1 + jj) into ring slot Q
// (one commit group per step, empty past the chunk).
template <bool B1, int Q, typename T>
__device__ __forceinline__ void copy_plane(const Geometry& g, const Tile<T>& b, const Run<T>& c,
                                           int jj) {
  constexpr int C = Elem<T>::C;
  if (c.ld && jj < b.nsteps) {
    int z = b.Z0 - 1 + jj;
    if constexpr (B1) {
      if (static_cast<const Flex&>(g).wrap & 4) z = z < 0 ? z + g.nz : (z >= g.nz ? z - g.nz : z);
    }
    const T* src;
    if constexpr (B1) src = c.src + (long long)(g.zo + z) * g.sz;
    else src = b.curr + (long long)(g.zo + z) * g.sz + c.yoff;
    T* dst = b.ring + Q * Elem<T>::PLANE_T + c.me;
    if (c.vcp) {
      cp16(dst, src + c.xq[0]);
    } else if (B1 && C == 4 && c.v8) {
      cp_halves(dst, src, c.xq);
    } else {
#pragma unroll
      for (int q = 0; q < C; ++q) cp_cell(dst + q, src + c.xq[q]);
    }
    if constexpr (B1 && C == 4) {
      if (c.patch >= 0) cp4(patch_cell(b, Q, c.patch >> 2 & 255), src + (c.patch >> 10));
    }
  }
  cp_commit();
}

// The run's sel values at output plane v (B1: 0 outside the sel range).
template <bool B1, typename T>
__device__ __forceinline__ void load_sel(const Geometry& g, const Tile<T>& b, const Run<T>& c,
                                         int v, int (&s)[Elem<T>::C]) {
  constexpr int C = Elem<T>::C;
  if constexpr (B1) {
    const Flex& f = static_cast<const Flex&>(g);
    if (v < f.slo || v >= f.shi) {
#pragma unroll
      for (int q = 0; q < C; ++q) s[q] = 0;
      return;
    }
  }
  const int32_t* p;
  if constexpr (B1) p = c.sp + (long long)(g.zo + v) * g.sz;
  else p = b.sel + (long long)(g.zo + v) * g.sz + c.ooff;
  if (c.st & 256) {
    ld_sel(p, s);
  } else if (B1 && C == 4 && (c.st & 512)) {
    ld_sel_halves(p, s);
  } else {
#pragma unroll
    for (int q = 0; q < C; ++q) s[q] = c.st >> q & 1 ? __ldg(p + q) : 0;
  }
}

// The first LOOK planes' copies.
template <bool B1, int Q, typename T>
__device__ __forceinline__ void prologue(const Geometry& g, const Tile<T>& b, const Run<T>& c) {
  copy_plane<B1, Q>(g, b, c, Q);
  if constexpr (Q + 1 < LOOK) prologue<B1, Q + 1>(g, b, c);
}

// Step j (P = j mod RING): wait for plane j, barrier, copy plane j + LOOK,
// load sel for step j + 1's output plane, take plane j into the window, then
// compute output plane v = Z0 + j - 2 from planes j - 2, j - 1 and j.
template <bool B1, int P, typename T>
__device__ __forceinline__ void step(const Geometry& g, const Tile<T>& b, Run<T>& c, int j) {
  constexpr int C = Elem<T>::C, PL = Elem<T>::PLANE_T;
  cp_wait<LOOK - 1>();
  __syncthreads();
  copy_plane<B1, (P + LOOK) % RING>(g, b, c, j + LOOK);
  if constexpr (B1) {
    // this step's output plane's sel values, loaded a step ago: packed
    // before the set takes the next plane's
    c.sk = 0;
#pragma unroll
    for (int q = 0; q < C; ++q)
      c.sk |= (c.sl[0][q] == 1 ? 1u : (c.sl[0][q] == 2 ? 2u : 0u)) << 2 * q;
    if (c.st && j >= 1 && j + 1 < b.nsteps) load_sel<B1>(g, b, c, b.Z0 + j - 1, c.sl[0]);
  } else {
    if (c.st && j >= 1 && j + 1 < b.nsteps)
      load_sel<B1>(g, b, c, b.Z0 + j - 1, c.sl[(P + 1) & 1]);
  }
  if (c.ld) {
    T(&w)[C] = c.w[P % 3];
    ld_run(b.ring + P * PL + c.me, w);
    if constexpr (B1 && C == 4) {
      // the wrapped cell, into the window and into the ring, where the
      // next step's neighbours read plane j (after its barrier)
      if (c.patch >= 0) {
        const float v = *patch_cell(b, P, c.patch >> 2 & 255);
        float* r = b.ring + P * PLANE + c.me;
        const int q = c.patch & 3;
        if (q == 0) w[0] = v, r[0] = v;
        else if (q == 1) w[1] = v, r[1] = v;
        else if (q == 2) w[2] = v, r[2] = v;
        else w[3] = v, r[3] = v;
      }
    }
  }
  if (j < 2) return;
  const T(&m)[C] = c.w[(P + 2) % 3];   // plane j - 1: the output plane
  const T(&lo)[C] = c.w[(P + 1) % 3];  // plane j - 2
  const T(&hi)[C] = c.w[P % 3];        // plane j
  // x edges from the neighbouring runs' lanes; lanes 0 and 31 read theirs
  T xl = __shfl_up_sync(FULL, m[C - 1], 1);
  T xr = __shfl_down_sync(FULL, m[0], 1);
  if (!c.st) return;
  int pitch = PITCH;
  if constexpr (B1) pitch = static_cast<const Flex&>(g).pitch;
  const T* in = b.ring + ((P + RING - 1) % RING) * PL + c.me;
  if (c.lane == 0) xl = in[-1];
  if (c.lane == 31) xr = in[C];
  T yl[C], yh[C];
  ld_run(in - pitch, yl);
  ld_run(in + pitch, yh);
  T o[C];
  o[0] = avg6(xl, m[1], yl[0], yh[0], lo[0], hi[0]);
#pragma unroll
  for (int q = 1; q < C - 1; ++q) o[q] = avg6(m[q - 1], m[q + 1], yl[q], yh[q], lo[q], hi[q]);
  o[C - 1] = avg6(m[C - 2], xr, yl[C - 1], yh[C - 1], lo[C - 1], hi[C - 1]);
  if constexpr (B1) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const unsigned k = c.sk >> 2 * q & 3u;
      o[q] = k == 1u ? T(HOT) : (k == 2u ? T(COLD) : o[q]);
    }
  } else {
    const int(&s)[C] = c.sl[P & 1];
#pragma unroll
    for (int q = 0; q < C; ++q) o[q] = s[q] == 1 ? T(HOT) : (s[q] == 2 ? T(COLD) : o[q]);
  }
  T* d;
  if constexpr (B1) d = c.dst + (long long)(g.zo + b.Z0 + j - 2) * g.sz;
  else d = b.out + (long long)(g.zo + b.Z0 + j - 2) * g.sz + c.ooff;
  if (c.st & 256) {
    st_run(d, o);
  } else if (B1 && C == 4 && (c.st & 512)) {
    st_halves(d, o);
  } else {
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (c.st >> q & 1) d[q] = o[q];
  }
}

// Steps j + P .. j + RING - 1 that lie in the chunk, unrolled.
template <bool B1, int P, typename T>
__device__ __forceinline__ void steps(const Geometry& g, const Tile<T>& b, Run<T>& c, int j) {
  if (j + P < b.nsteps) step<B1, P>(g, b, c, j + P);
  if constexpr (P + 1 < RING) steps<B1, P + 1>(g, b, c, j);
}

// The tile's plane steps, then a barrier, so the block may start its next
// tile in the same shared memory.
template <bool B1, typename T>
__device__ __forceinline__ void march(const Geometry& g, const Tile<T>& b, Run<T>& c) {
  prologue<B1, 0>(g, b, c);
  for (int j = 0; j < b.nsteps; j += RING) steps<B1, 0>(g, b, c, j);
  cp_wait<0>();
  __syncthreads();
}

// B8: tile t of one block position (x fastest, then y, then z chunk): nxt
// <- one sweep of curr over the tile, by a block of NT threads with SMEM
// bytes of dynamic shared memory. Ends with a barrier.
__device__ __forceinline__ void sweep_tile(const Geometry& g, const float* curr,
                                           float* __restrict__ out,
                                           const int32_t* __restrict__ sel, float* smem,
                                           int t) {
  const int tx = t % g.gx, ty = (t / g.gx) % g.gy, tz = t / (g.gx * g.gy);
  const int a = -g.xo & 3;
  const int X0 = tx == 0 ? 0 : tx * TX + a;
  const int W = min(g.nx, (tx + 1) * TX + a) - X0;
  const int Y0 = ty * TY;
  Tile<float> b;
  b.curr = curr;
  b.out = out;
  b.sel = sel;
  b.ring = smem + PITCH;
  b.Z0 = tz * g.zchunk;
  b.nsteps = min(g.nz, b.Z0 + g.zchunk) - b.Z0 + 2;
  // column 0 of the grown tile is block-local x X0 - 1 - e: on the grid
  const int e = (g.xo + X0 - 1) & 3;

  Run<float> c;
  const int th = threadIdx.x;
  c.lane = th & 31;
  const int row = th / RUNS, rn = th - row * RUNS;
  c.me = row * PITCH + 4 * rn;
  // the grown tile's columns are [e, e + W + 2)
  c.ld = th < ROWS * RUNS && 4 * rn + 3 >= e && 4 * rn <= e + W + 1;
  const int lx0 = X0 - 1 - e + 4 * rn;  // block-local x of the run's first cell
  const int ly = Y0 - 1 + row;          // block-local y of its row
  // source cells clamped into the padded block: cells past the grown tile
  // (the ragged edge, the run alignment) feed no output
  c.yoff = clampi(g.yo + ly, 0, g.py - 1) * g.sy;
#pragma unroll
  for (int q = 0; q < 4; ++q) c.xq[q] = clampi(g.xo + lx0 + q, 0, g.sy - 1);
  c.vcp = g.vec && c.xq[3] == c.xq[0] + 3 && (c.xq[0] & 3) == 0;
  // output cells: columns [e + 1, e + 1 + W), rows [1, TY], inside the block
  c.st = 0;
  if (c.ld && row >= 1 && row <= TY && ly < g.ny) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = lx0 + q - X0;
      if (col >= 0 && col < W) c.st |= 1 << q;
    }
    if (c.st == 15 && g.vec) c.st |= 256;
  }
  c.ooff = (g.yo + ly) * g.sy + g.xo + lx0;
  march<false>(g, b, c);
}

// B1: tile (tx, ty, tz) of the rect f describes (origin (zo, yo, xo) in the
// padded block, nz x ny x nx cells; f in shared memory), of f's shape: out
// <- one sweep of curr over the tile, wrapping by index where f says,
// imposing sel on f's planes. A block of NT threads with B1_SMEM bytes of
// dynamic shared memory. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void flex_tile(const Flex& f, const T* curr, T* out,
                                          const int32_t* sel, T* smem, int tx, int ty, int tz) {
  constexpr int C = Elem<T>::C;
  const Geometry& g = f;
  const int runs = f.pitch >> Elem<T>::SHIFT;  // runs of a row, as RUNS for TX
  const int rows = f.ty + 2;
  const int a = -g.xo & (C - 1);
  const int X0 = tx == 0 ? 0 : tx * f.tx + a;
  const int W = min(g.nx, (tx + 1) * f.tx + a) - X0;
  const int Y0 = ty * f.ty;
  Tile<T> b;
  b.curr = curr;
  b.out = out;
  b.sel = sel;
  b.ring = smem + Elem<T>::GUARD;
  b.Z0 = tz * g.zchunk;
  b.nsteps = min(g.nz, b.Z0 + g.zchunk) - b.Z0 + 2;
  const bool wx = f.wrap & 1, wy = f.wrap & 2;
  const int e = (g.xo + X0 - 1) & (C - 1);

  Run<T> c;
  const int th = threadIdx.x;
  c.lane = th & 31;
  const int row = th / runs, rn = th - row * runs;
  c.me = row * f.pitch + C * rn;
  c.ld = th < rows * runs && C * rn + C - 1 >= e && C * rn <= e + W + 1;
  const int lx0 = X0 - 1 - e + C * rn;  // rect-local x of the run's first cell
  const int ly = Y0 - 1 + row;          // rect-local y of its row
  // source cells: by index wrap on a wrapping axis, otherwise clamped into
  // the padded block (cells past the grown tile feed no output)
  c.yoff = (wy ? g.yo + wrapi(ly, g.ny) : clampi(g.yo + ly, 0, g.py - 1)) * g.sy;
#pragma unroll
  for (int q = 0; q < C; ++q)
    c.xq[q] = wx ? g.xo + wrapi(lx0 + q, g.nx) : clampi(g.xo + lx0 + q, 0, g.sy - 1);
  // the vector width of the mapped cells' address
  bool run4 = true;
#pragma unroll
  for (int q = 1; q < C; ++q) run4 = run4 && c.xq[q] == c.xq[0] + q;
  const int ph = (c.yoff + c.xq[0]) & (C - 1);
  c.vcp = run4 && f.align == C && ph == 0;
  c.v8 = C == 4 && run4 && !c.vcp && f.align >= 2 && (ph & 1) == 0;
  c.patch = -1;
  if constexpr (C == 4) {
    if (wx && f.gx > 1 && !c.vcp && !c.v8) {
      // a row's end run whose x = -1 or x = nx wraps to the other end: of
      // its cells only that one is read from there (as a neighbour of x = 0
      // or x = nx - 1); copy the run from its own padded cells, which lie on
      // the grid, and the one cell apart (patched in as the step takes the
      // plane). Only where a row spans several tiles: with one tile a row (a
      // 128^3 tenant) the 4-byte copies timed faster (PERF.md)
      const int u0 = g.xo + lx0, uph = (c.yoff + u0) & 3;
      int pq = 0, ps = 0, side = 0, n = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (lx0 + q == -1) pq = q, ps = g.xo + g.nx - 1, ++n;
        else if (lx0 + q == g.nx) pq = q, ps = g.xo, side = 1, ++n;
      }
      if (n == 1 && u0 >= 0 && u0 + 3 < g.sy && f.align >= 2 && (uph & 1) == 0) {
        c.patch = ps << 10 | (2 * row + side) << 2 | pq;
        c.xq[0] = u0;
        c.xq[2] = u0 + 2;
        c.vcp = f.align == 4 && uph == 0;
        c.v8 = !c.vcp;
      }
    }
  }
  // output cells: columns [e + 1, e + 1 + W), rows [1, ty], inside the rect
  c.st = 0;
  c.ooff = (g.yo + ly) * g.sy + g.xo + lx0;
  if (c.ld && row >= 1 && row <= f.ty && ly < g.ny) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int col = lx0 + q - X0;
      if (col >= 0 && col < W) c.st |= 1 << q;
    }
    const int po = c.ooff & (C - 1);
    constexpr int ALL = (1 << C) - 1;
    if (c.st == ALL && f.align == C && po == 0) c.st |= 256;
    else if (C == 4 && c.st == ALL && f.align >= 2 && (po & 1) == 0) c.st |= 512;
  }
  c.src = curr + c.yoff;
  c.dst = out + c.ooff;
  c.sp = sel + c.ooff;
  march<true>(g, b, c);
}

}  // namespace runs
