// One Jacobi sweep of an fp32 block whose halos are already filled, by
// 4-cell x runs: the body of B8's fused step (fused_jacobi.cu), kept in a
// header of its own so that B1's sweep can adopt it.
//
// What a tile computes: nxt's compute-region cells of one output tile (TX
// wide, TY high, one z chunk) <- the 6-neighbour average of curr,
// (x_lo + x_hi + y_lo + y_hi + z_lo + z_hi) left to right times 1/6 rounded
// to float32, then sel == 1 -> 1.0, sel == 2 -> 0.0: the operand order of
// every Jacobi kernel of the package, so a tile is bit-exact to the plain
// sweep (built with -fmad=false). Neighbours outside the compute region are
// read from curr's halos, with no wrap: the caller has filled them. Nothing
// else of nxt is written.
//
// Design: the multistep kernel's (jacobi_multistep.cu) at depth 1.
// - A thread owns a 4-cell x run of one row of the tile grown by one cell
//   (ROWS = TY + 2 rows of RUNS runs). Runs sit on the padded block's
//   16-byte grid: the first tile of a row starts at the compute region's
//   first column and is up to 3 columns wider, every later tile starts its
//   output on the grid, so a run's plane arrives as one 16-byte cp.async and
//   its output leaves as one float4 store. Where the layout does not allow
//   it (`vec` 0: a row pitch or plane stride that is not a multiple of 4
//   floats, or a pointer off the 16-byte grid) and for runs clamped at a
//   padded row's ends, cells move 4 bytes at a time.
// - curr's planes are copied LOOK planes ahead of use into a ring of
//   RING = LOOK + 2 planes in shared memory by cp.async.cg (L2, coherent:
//   other blocks of the launch wrote the halos; never the read-only path).
//   The step loop is unrolled over the ring's slots (a multiple of 6), so
//   every ring slot, window slot and sel buffer is a constant.
// - z neighbours: a three-plane register window of the thread's own run;
//   x neighbours: the run's own cells and, at its ends, warp shuffles
//   (shared memory for lanes 0 and 31); y neighbours: 16-byte reads of rows
//   y - 1 and y + 1 of the ring's plane.
// - sel arrives by 16-byte loads on the read-only path (it is never
//   written), loaded one plane ahead of use into one of two register sets;
//   nxt leaves by float4 stores.
// - One barrier a plane: plane j's copy has landed for every thread, and
//   the slot plane j + LOOK goes to (plane j - 2's) is no longer read.
// Offsets within a plane are 32-bit (the launch refuses a plane of 2^31
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
constexpr int MIN_BLOCKS = 3;   // resident blocks per SM the registers are bounded for
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
constexpr unsigned FULL = 0xffffffffu;
constexpr float SIXTH = 1.0f / 6.0f;
constexpr float HOT = 1.0f;
constexpr float COLD = 0.0f;
static_assert(RING % 6 == 0, "ring slots, window slots and sel sets repeat every RING steps");

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

// Tiles along x of an nx-wide region starting at padded x = xo: the first is
// [0, TX + a), tile t >= 1 is [t TX + a, (t + 1) TX + a), a = -xo mod 4, so
// every tile after the first starts its output on the 16-byte grid.
__host__ __device__ inline int tiles_x(int nx, int xo) {
  const int t = (nx - (-xo & 3) + TX - 1) / TX;
  return t < 1 ? 1 : t;
}

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes can only go through L1 (cp.async.ca); no line of curr is in L1
// before the barrier that precedes the sweep (the hand-offs read through L2),
// and L1 starts empty at each launch, so no stale halo is read
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// (x_lo + x_hi + y_lo + y_hi + z_lo + z_hi) * 1/6, left to right
__device__ __forceinline__ float avg6(float xl, float xh, float yl, float yh, float zl,
                                      float zh) {
  float s = xl + xh;
  s = s + yl;
  s = s + yh;
  s = s + zl;
  s = s + zh;
  return s * SIXTH;
}

// What a block knows of its tile, the same for all its threads.
struct Tile {
  const float* curr;
  float* out;
  const int32_t* sel;
  float* ring;  // after the leading guard row
  int Z0;       // first output plane
  int nsteps;   // plane steps: the chunk's planes and a 2-step warm-up
};

// What a thread owns: one 4-cell run of a row of the grown tile, at offset
// me in a ring plane; whether it holds a cell of the grown tile (ld); its
// source row's offset in a plane and its cells' source x (clamped into the
// padded block); whether it copies as one vector (vcp); its output cells (st:
// bits 0-3, and bit 8 when they store as one aligned vector) and their row
// offset (ooff, of the run's first cell); per plane slot its cells' values
// (w[slot][cell], slot = step mod 3) and two sets of sel values (step parity).
struct Run {
  float w[3][4];
  int sl[2][4];
  int me, lane, yoff, ooff, st;
  int xq[4];
  bool ld, vcp;
};

// Copy the run's cells of step jj's plane (Z0 - 1 + jj) into ring slot Q
// (one commit group per step, empty past the chunk).
template <int Q>
__device__ __forceinline__ void copy_plane(const Geometry& g, const Tile& b, const Run& c,
                                           int jj) {
  if (c.ld && jj < b.nsteps) {
    const float* src = b.curr + (long long)(g.zo + b.Z0 - 1 + jj) * g.sz + c.yoff;
    float* dst = b.ring + Q * PLANE + c.me;
    if (c.vcp) {
      cp16(dst, src + c.xq[0]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) cp4(dst + q, src + c.xq[q]);
    }
  }
  cp_commit();
}

// The run's sel values at output plane v.
__device__ __forceinline__ void load_sel(const Geometry& g, const Tile& b, const Run& c, int v,
                                         int (&s)[4]) {
  const int32_t* p = b.sel + (long long)(g.zo + v) * g.sz + c.ooff;
  if (c.st & 256) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] = c.st >> q & 1 ? __ldg(p + q) : 0;
  }
}

// The first LOOK planes' copies.
template <int Q>
__device__ __forceinline__ void prologue(const Geometry& g, const Tile& b, const Run& c) {
  copy_plane<Q>(g, b, c, Q);
  if constexpr (Q + 1 < LOOK) prologue<Q + 1>(g, b, c);
}

// Step j (P = j mod RING): wait for plane j, barrier, copy plane j + LOOK,
// load sel for step j + 1's output plane, take plane j into the window, then
// compute output plane v = Z0 + j - 2 from planes j - 2, j - 1 and j.
template <int P>
__device__ __forceinline__ void step(const Geometry& g, const Tile& b, Run& c, int j) {
  cp_wait<LOOK - 1>();
  __syncthreads();
  copy_plane<(P + LOOK) % RING>(g, b, c, j + LOOK);
  if (c.st && j >= 1 && j + 1 < b.nsteps) load_sel(g, b, c, b.Z0 + j - 1, c.sl[(P + 1) & 1]);
  if (c.ld) {
    const float4 a = *reinterpret_cast<const float4*>(b.ring + P * PLANE + c.me);
    float(&w)[4] = c.w[P % 3];
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  }
  if (j < 2) return;
  const float(&m)[4] = c.w[(P + 2) % 3];   // plane j - 1: the output plane
  const float(&lo)[4] = c.w[(P + 1) % 3];  // plane j - 2
  const float(&hi)[4] = c.w[P % 3];        // plane j
  // x edges from the neighbouring runs' lanes; lanes 0 and 31 read theirs
  float xl = __shfl_up_sync(FULL, m[3], 1);
  float xr = __shfl_down_sync(FULL, m[0], 1);
  if (!c.st) return;
  const float* in = b.ring + ((P + RING - 1) % RING) * PLANE + c.me;
  if (c.lane == 0) xl = in[-1];
  if (c.lane == 31) xr = in[4];
  const float4 yl = *reinterpret_cast<const float4*>(in - PITCH);
  const float4 yh = *reinterpret_cast<const float4*>(in + PITCH);
  const int(&s)[4] = c.sl[P & 1];
  float o[4];
  o[0] = avg6(xl, m[1], yl.x, yh.x, lo[0], hi[0]);
  o[1] = avg6(m[0], m[2], yl.y, yh.y, lo[1], hi[1]);
  o[2] = avg6(m[1], m[3], yl.z, yh.z, lo[2], hi[2]);
  o[3] = avg6(m[2], xr, yl.w, yh.w, lo[3], hi[3]);
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = s[q] == 1 ? HOT : (s[q] == 2 ? COLD : o[q]);
  float* d = b.out + (long long)(g.zo + b.Z0 + j - 2) * g.sz + c.ooff;
  if (c.st & 256) {
    *reinterpret_cast<float4*>(d) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c.st >> q & 1) d[q] = o[q];
  }
}

// Steps j + P .. j + RING - 1 that lie in the chunk, unrolled.
template <int P>
__device__ __forceinline__ void steps(const Geometry& g, const Tile& b, Run& c, int j) {
  if (j + P < b.nsteps) step<P>(g, b, c, j + P);
  if constexpr (P + 1 < RING) steps<P + 1>(g, b, c, j);
}

// Tile t of one block position (x fastest, then y, then z chunk): nxt <- one
// sweep of curr over the tile, by a block of NT threads with SMEM bytes of
// dynamic shared memory. Ends with a barrier, so the block may start its
// next tile in the same shared memory.
__device__ __forceinline__ void sweep_tile(const Geometry& g, const float* curr,
                                           float* __restrict__ out,
                                           const int32_t* __restrict__ sel, float* smem,
                                           int t) {
  const int tx = t % g.gx, ty = (t / g.gx) % g.gy, tz = t / (g.gx * g.gy);
  const int a = -g.xo & 3;
  const int X0 = tx == 0 ? 0 : tx * TX + a;
  const int W = min(g.nx, (tx + 1) * TX + a) - X0;
  const int Y0 = ty * TY;
  Tile b;
  b.curr = curr;
  b.out = out;
  b.sel = sel;
  b.ring = smem + PITCH;
  b.Z0 = tz * g.zchunk;
  b.nsteps = min(g.nz, b.Z0 + g.zchunk) - b.Z0 + 2;
  // column 0 of the grown tile is block-local x X0 - 1 - e: on the grid
  const int e = (g.xo + X0 - 1) & 3;

  Run c;
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

  prologue<0>(g, b, c);
  for (int j = 0; j < b.nsteps; j += RING) steps<0>(g, b, c, j);
  cp_wait<0>();
  __syncthreads();
}

}  // namespace runs
