// k Jacobi steps in one launch over the padded fp32 or fp64 blocks of a
// uniform partition, every block resident on one device.
//
// Replaces: stencil_tpu/ops/pallas_stencil.py make_pallas_jacobi_multistep
// (full-plane z wavefront) and _make_multistep_row_tiled (the same wavefront
// over y strips), in their single-block forms and in their deep-halo forms
// (the `use_org` pallas_call sites). Python wrapper and plain PyTorch
// version: stencil_tpu_torch/ops/stencil_kernels.py (multistep,
// multistep_plain).
//
// What bounds it on an H100. The floor is bytes: ONE read of curr plus ONE
// write of out per k steps (0.32 ms at 512^3 in fp32, 0.64 in fp64), since
// the intermediate stages
// never go to device memory. Keeping them on chip costs work that bytes do
// not count: a tile recomputes its neighbours' ghost zones (1.1x the cell
// updates at k = 3), and every stage of every plane passes through shared
// memory and a block-wide barrier. At k = 3 the kernel runs at about twice
// the bytes floor (PERF.md): what sets the pace is the instructions the
// on-chip stages issue, one block of 23 warps per SM at its 80-register cap,
// with the stage-0 stream and the output stores overlapping them only in
// part. fp64 halves the card's issue rate (64 lanes an SM), so its floor in
// issue is twice fp32's. Scalar global accesses held this kernel's first
// design back: blocks
// whose runs straddle a wrapped or unaligned edge ran slower than the
// others, and the slowest block sets the launch's time.
//
// Design (ghost-zone temporal blocking with a register z-march). A block
// owns a TX-wide output tile of one resident block (TX: 256 bytes of cells,
// 64 in fp32, 32 in fp64; TY rows at k <= KLO,
// TYHI deeper, where the register windows grow) and marches a z chunk with
// k + 1 stages. Stage 0 is the input plane grown by k cells on each side;
// stage s computes the plane grown by k - s from stage s - 1, and stage k is
// the output. At step j stage s works on plane Z0 - k + j - s, so a cell's z
// neighbours at stage s - 1 were made by the same thread one step before
// and in this step (a three-plane register window per stage); its y
// neighbours come from shared memory, where each stage keeps two planes
// (one read while the other is written), so a step ends with a single
// barrier. What the design does about the limits:
// - Each thread owns a 16-byte x run of one row of the grown plane (C = 4
//   fp32 cells or 2 fp64 cells), the same in every stage: its own cells give
//   most of its x neighbours, warp shuffles the two at the run's ends
//   (shared memory for lanes 0 and 31), and 16-byte row reads the y
//   neighbours. No warp idles on a second cell. The fp64 form keeps the
//   bytes of the fp32 one (a tile half as wide in cells), so its shared
//   memory and threads are those of the fp32 tile.
// - Runs start on the padded block's 16-byte grid, and every tile after the
//   first of a row starts its output there too, so stage 0 arrives as one
//   16-byte cp.async per run and the output leaves as one 16-byte store per
//   run; only runs that straddle a wrapped edge copy a cell at a time, and
//   only the block's own first and last columns store fewer than C.
// - Stage 0 is copied LOOK planes ahead of use into a ring of LOOK + 2 = 6
//   planes, with no registers held for it. The step loop is unrolled over
//   the ring's 6 slots, so every ring slot, buffer parity and window slot is
//   a constant.
// - A run computes a stage only if one of its cells is needed there (the
//   grown extent shrinks by one per stage); the cells it computes in excess
//   feed no output. The spheres cost a few integer operations per run and
//   plane, and a per-cell test only where a run can touch one.
// - z is split into chunks, each with its own 2k-step warm-up, so that
//   blocks of uneven speed (edge and sphere tiles) balance over several
//   waves (stencil_kernels.multistep_zchunks).
//
// Axes. An axis with one block of the partition is periodic onto itself:
// stage 0 takes the grown cells by index wrap within the compute region. An
// axis with several blocks is the deep-halo form: the caller has exchanged
// halos of radius >= k, and stage 0 reads the grown cells straight from them
// (planes zo - k .. zo + nz + k - 1 on z). Grown cells farther out than k
// (the ragged edge of the last tile, the run alignment) are clamped into the
// padded block; they only feed cells that no output depends on. Both modes
// mix freely, e.g. (1,1,2).
//
// Residents. grid.z covers every resident block times its z chunks; a block
// finds its resident's data at resident * bstride and its global origin at
// (block index) x (block size), the origin the TPU kernel gets by scalar
// prefetch. The kernel is instantiated twice per depth: MB = false for a
// single-block domain, MB = true for a partition.
//
// Positions. The blocks of a mesh of positions are separate allocations,
// each at its own global origin (the TPU kernel's deep-halo form inside
// shard_map, whose origin comes from lax.axis_index). Their launch runs the
// same MB = true body over a table of entries (curr pointer, out pointer and
// the block's global origin x, y, z; TAB_COLS int64 an entry) in device
// memory: grid.z covers entries times z chunks, and a block reads its entry
// where the stack form computes its resident's pointers and origin.
//
// The hot and cold spheres come from integer coordinates, exactly as in the
// TPU kernel: hot centre (gx/3, gy/2, gz/2), cold centre (2*gx/3, gy/2,
// gz/2), d2 < (gx/10 + 1)^2, hot wins over cold, at the cell's WRAPPED global
// coordinate ((origin + local) mod global size), so a grown cell in a halo is
// clamped exactly as on the block that owns it. On the standard spheres that
// equals the JAX package's sqrt-truncating sel array, so one launch equals k
// one-step sweeps bit for bit: every stage sums (x_lo + x_hi + y_lo + y_hi +
// z_lo + z_hi) left to right and multiplies by 1/6 rounded to the type, as the
// sweep does; only where each value comes from (registers, shuffles or
// shared memory) differs. Plane offsets are 64-bit, in-plane offsets 32-bit
// (the launch refuses a plane of 2^31 elements or more).
//
// Shared memory (Shape<K, T>::SMEM): a guard row, the stage-0 ring, two
// planes for each of stages 1..k-1, a guard row; a plane is the grown tile's
// rows at a pitch of RUNS runs of C cells. The Python side
// (stencil_kernels.py multistep_shape) mirrors these formulas.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "jacobi_column.cuh"

namespace {

// output tile width in bytes, TX cells (the first tile of a row is up to
// C - 1 cells wider)
constexpr int TX_BYTES = 256;
constexpr int TY = 32;    // output tile height, y, at k <= KLO
constexpr int TYHI = 16;  // output tile height at k > KLO (fp64: half; see Shape)
constexpr int KLO = 3;    // deepest k with the TY-high tile
constexpr int KMAX = 6;   // deepest k instantiated (register windows grow with k)
constexpr int LOOK = 4;   // stage-0 planes in flight ahead of use
constexpr int TAB_COLS = 5;  // a positions entry: curr, out, origin x, y, z
constexpr unsigned FULL = 0xffffffffu;
constexpr float HOT = 1.0f;
constexpr float COLD = 0.0f;

// The launch shape at depth K for cells of type T. A thread owns one
// 16-byte run (C cells) of a row of the grown plane; a row has RUNS runs,
// enough for the widest tile grown by K on both sides at any 16-byte phase
// of its first cell. Beyond KLO an fp64 tile is TYHI / 2 rows high: its
// register windows take twice the registers a cell, and at 16 rows k = 6
// spilled 112 bytes at the 80-register cap of its 672 threads (an H100,
// PERF.md); at 8 rows every depth's block is at most 512 threads.
template <int K, typename T>
struct Shape {
  static constexpr int C = 16 / (int)sizeof(T);
  static constexpr int TX = TX_BYTES / (int)sizeof(T);
  static constexpr int TYK = K <= KLO ? TY : TYHI * 4 / (int)sizeof(T);
  static constexpr int ROWS = TYK + 2 * K;
  static constexpr int RUNS = (C - 1 + TX + C - 1 + 2 * K + C - 1) / C;
  static constexpr int PITCH = C * RUNS;  // cells per shared-memory row
  static constexpr int PLANE = ROWS * PITCH;
  static constexpr int RING = LOOK + 2;
  static constexpr int PLANES = RING + 2 * (K - 1);
  static constexpr int NT = (ROWS * RUNS + 31) / 32 * 32;
  static constexpr long long SMEM = (long long)sizeof(T) * (PLANES * PLANE + 2 * PITCH);
  static constexpr T SIXTH = T(1) / T(6);
  static_assert(RING == 6 && LOOK == 4, "the step loop is unrolled over 6 ring slots");
  static_assert(C == 4 || C == 2, "fp32 or fp64 cells");
};

template <typename T>
struct Params {
  const T* curr;
  T* out;
  long long sz, bstride;       // strides (elements) of z and of a resident block
  int sy, py;                  // stride of y (x is unit); padded rows
  int zo, yo, xo;              // compute-region origin in the padded block
  int nz, ny, nx;              // compute-region extent of one block
  int bz, by, bx;              // blocks of the partition along z, y, x
  int gz, gy, gx;              // global size (the periodic box of the spheres)
  int zchunk, nzc;             // output planes per z chunk, chunks per block
  int hx, hy, hz, dhc;         // hot centre; the cold one is dhc further in x
  int band;                    // only |z - hz| <= band holds sphere cells
  int thresh;                  // (gx/10 + 1)^2
  int vec;                     // pointers and strides allow 16-byte runs
  const long long* tab;        // positions form: TAB_COLS int64 an entry; null: the stack
};

__device__ __forceinline__ int wrapi(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// one cell
__device__ __forceinline__ void cp_cell(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_cell(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
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
  return s * Shape<1, T>::SIXTH;
}

// What a block knows of its tile, the same for all its threads. The tile's
// output columns are block-local x in [X0, X1): tiles after the first start
// where the padded row is 16-byte aligned, so that their output runs are
// whole aligned vectors.
template <typename T>
struct Tile {
  const T* curr;      // the resident's block
  T* out;
  T* ring;            // stage-0 ring, after the leading guard row
  T* bufs;            // stages 1..K-1, two planes each
  int X0, X1, Y0, Z0, nsteps, e;
  int oz;             // the resident's global z origin
  bool zm;            // z has several blocks (deep halo)
};

// What a thread owns: one C-cell run of a row of the grown plane, at offset
// me in a plane; the largest stage a cell of it is needed at (-1: none); its
// lane; its cells' block-local x (from lx0); its source row's offset and its
// cells' source x (xq; the first is also the output x when the run lies in
// the block), and whether the run copies as one 16-byte vector (vcp); its
// output cells (st: bits 0 to C - 1, and bit 8 when they store as one
// aligned vector); for the spheres, its row's squared y distance from their centre,
// its first cell's wrapped global x and the least squared x distance of its
// cells from either centre; and per stage s < K its planes' values,
// w[s][slot][cell], slot = (step - s) mod 3.
template <int K, typename T>
struct Run {
  static constexpr int C = Shape<K, T>::C;
  T w[K][3][C];
  int me, smax, lane, lx0, yoff, st, dy2, gx0, dxm2;
  int xq[C];
  bool vcp;
};

// Copy the run's cells of relative plane jj into its ring slot, jj mod RING
// = Q (one commit group per step, empty past the chunk).
template <int K, int Q, typename T>
__device__ __forceinline__ void issue(const Params<T>& p, const Tile<T>& b, const Run<K, T>& c,
                                      int jj) {
  using S = Shape<K, T>;
  if (c.smax >= 0 && jj < b.nsteps) {
    const int u = b.Z0 - K + jj;
    const int zu = b.zm ? u : (u < 0 ? u + p.nz : (u >= p.nz ? u - p.nz : u));
    const T* src = b.curr + (long long)(p.zo + zu) * p.sz + c.yoff;
    T* dst = b.ring + Q * S::PLANE + c.me;
    if (c.vcp) {
      cp16(dst, src + c.xq[0]);
    } else {
#pragma unroll
      for (int q = 0; q < S::C; ++q) cp_cell(dst + q, src + c.xq[q]);
    }
  }
  cp_commit();
}

// The spheres on plane v (dz from the hot centre): hot wins over cold.
template <int K, typename T>
__device__ __forceinline__ void spheres(const Params<T>& p, const Run<K, T>& c, int dz,
                                        T (&o)[Shape<K, T>::C]) {
  const int yz = c.dy2 + dz * dz;
  if (c.dxm2 + yz < p.thresh) {
#pragma unroll
    for (int q = 0; q < Shape<K, T>::C; ++q) {
      int gx = c.gx0 + q;
      while (gx >= p.gx) gx -= p.gx;
      const int dx = gx - p.hx;
      const int dc = dx - p.dhc;
      o[q] = dx * dx + yz < p.thresh ? T(HOT) : (dc * dc + yz < p.thresh ? T(COLD) : o[q]);
    }
  }
}

// Step j (P = j mod RING; RING is a multiple of 2 and 3, so every ring slot,
// buffer parity and window slot below is a constant): wait for stage 0's
// plane j, barrier, copy plane j + LOOK, load plane j into the window, then
// stages 1..K.
template <int K, int P, typename T>
__device__ __forceinline__ void step(const Params<T>& p, const Tile<T>& b, Run<K, T>& c, int j) {
  using S = Shape<K, T>;
  constexpr int PITCH = S::PITCH, RING = S::RING, C = S::C;
  cp_wait<LOOK - 1>();
  __syncthreads();
  issue<K, (P + LOOK) % RING>(p, b, c, j + LOOK);
  if (c.smax >= 0) ld_run(b.ring + P * S::PLANE + c.me, c.w[0][P % 3]);
  // which stages' planes hold sphere cells: stage s works on plane
  // Z0 - K + j - s, whose wrapped global z lies within k planes of the block
  // (k <= nz, so one correction wraps it)
  int band = 0;
  {
    const int z0 = b.oz + b.Z0 - K + j;
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const int zg = z0 - s;
      const int dz = (zg < 0 ? zg + p.gz : (zg >= p.gz ? zg - p.gz : zg)) - p.hz;
      if (dz <= p.band && -dz <= p.band) band |= 1 << s;
    }
  }
#pragma unroll
  for (int s = 1; s <= K; ++s) {
    if (j < 2 * s) continue;
    const T(&m)[C] = c.w[s - 1][(P - s + 12) % 3];   // plane v of stage s - 1
    const T(&lo)[C] = c.w[s - 1][(P - s + 11) % 3];  // plane v - 1
    const T(&hi)[C] = c.w[s - 1][(P - s + 13) % 3];  // plane v + 1
    // x edges from the neighbouring runs' lanes; lanes 0 and 31 read theirs
    T xl = __shfl_up_sync(FULL, m[C - 1], 1);
    T xr = __shfl_down_sync(FULL, m[0], 1);
    if (c.smax < s) continue;
    const int v = b.Z0 - K + j - s;  // the plane stage s computes
    // stage s - 1 at plane v: the ring slot of plane j - 1, or the buffer
    // stage s - 1 wrote one step ago
    const T* in = (s == 1 ? b.ring + ((P + RING - 1) % RING) * S::PLANE
                          : b.bufs + (2 * (s - 2) + ((P - s + RING) & 1)) * S::PLANE) +
                  c.me;
    if (c.lane == 0) xl = in[-1];
    if (c.lane == 31) xr = in[C];
    T up[C], dn[C];
    ld_run(in - PITCH, up);
    ld_run(in + PITCH, dn);
    T o[C];
    o[0] = avg6(xl, m[1], up[0], dn[0], lo[0], hi[0]);
#pragma unroll
    for (int q = 1; q < C - 1; ++q) o[q] = avg6(m[q - 1], m[q + 1], up[q], dn[q], lo[q], hi[q]);
    o[C - 1] = avg6(m[C - 2], xr, up[C - 1], dn[C - 1], lo[C - 1], hi[C - 1]);
    if (band >> s & 1) {
      const int zg = b.oz + v;
      spheres<K>(p, c, (zg < 0 ? zg + p.gz : (zg >= p.gz ? zg - p.gz : zg)) - p.hz, o);
    }
    if (s < K) {
      T(&nw)[C] = c.w[s][(P - s + 12) % 3];
#pragma unroll
      for (int q = 0; q < C; ++q) nw[q] = o[q];
      st_run(b.bufs + (2 * (s - 1) + ((P - s + RING) & 1)) * S::PLANE + c.me, o);
    } else if (c.st) {
      // the output, inside the block, where offsets are unwrapped
      T* d = b.out + (long long)(p.zo + v) * p.sz + c.yoff;
      if (c.st & 256) {
        st_run(d + c.xq[0], o);
      } else {
        d += p.xo + c.lx0;
#pragma unroll
        for (int q = 0; q < C; ++q)
          if (c.st >> q & 1) d[q] = o[q];
      }
    }
  }
}

template <int K, bool MB, typename T>
__global__ void __launch_bounds__(Shape<K, T>::NT, 1)
    jacobi_multistep_kernel(const __grid_constant__ Params<T> p) {
  using S = Shape<K, T>;
  constexpr int C = S::C, TX = S::TX;
  // declared as words in every instantiation (one type for the one array)
  extern __shared__ __align__(16) float smem_words[];
  T* smem = reinterpret_cast<T*>(smem_words);
  Tile<T> b;
  const int res = MB ? blockIdx.z / p.nzc : 0;
  int ox, oy;
  if (MB && p.tab) {
    // the positions form: the entry's own block and global origin
    const long long* e = p.tab + (long long)res * TAB_COLS;
    b.curr = reinterpret_cast<const T*>(e[0]);
    b.out = reinterpret_cast<T*>(e[1]);
    ox = (int)e[2], oy = (int)e[3], b.oz = (int)e[4];
  } else {
    const int rx = res % p.bx, ry = (res / p.bx) % p.by, rz = res / (p.bx * p.by);
    ox = MB ? rx * p.nx : 0, oy = MB ? ry * p.ny : 0;
    b.oz = MB ? rz * p.nz : 0;
    b.curr = p.curr + (MB ? res * p.bstride : 0);
    b.out = p.out + (MB ? res * p.bstride : 0);
  }
  b.ring = smem + S::PITCH;
  b.bufs = b.ring + S::RING * S::PLANE;
  const bool xm = MB && p.bx > 1, ym = MB && p.by > 1;
  b.zm = MB && p.bz > 1;
  const int tx = blockIdx.x;
  b.X0 = tx == 0 ? 0 : tx * TX + (-p.xo & (C - 1));
  b.X1 = min(p.nx, (tx + 1) * TX + (-p.xo & (C - 1)));
  if (b.X0 >= b.X1) return;  // the whole block: a last tile with no columns
  b.Y0 = blockIdx.y * S::TYK;
  b.Z0 = (blockIdx.z - res * p.nzc) * p.zchunk;
  b.nsteps = min(p.nz, b.Z0 + p.zchunk) - b.Z0 + 2 * K;
  // column col of the grown plane is block-local x = X0 - K - e + col: runs
  // of C start on the padded block's 16-byte grid
  b.e = (p.xo + b.X0 - K) & (C - 1);
  const int W = b.X1 - b.X0;

  Run<K, T> c;
  const int t = threadIdx.x;
  c.lane = t & 31;
  const int row = t / S::RUNS, rn = t - row * S::RUNS;
  c.me = row * S::PITCH + C * rn;
  c.smax = -1;
  if (t < S::ROWS * S::RUNS) {
    // stage s needs rows [s, ROWS - s) and columns [e + s, e + W + 2K - s)
    const int sr = min(row, S::ROWS - 1 - row);
    const int sc = min(C * rn + C - 1 - b.e, b.e + W + 2 * K - 1 - C * rn);
    c.smax = min(min(sr, sc), K);
  }
  c.lx0 = b.X0 - K - b.e + C * rn;
  const int ly = b.Y0 - K + row;
  // source cells: by index wrap on a single-block axis, clamped into the
  // padded block on a deep-halo axis (cells farther out than k feed no
  // output)
  c.yoff = (ym ? clampi(p.yo + ly, 0, p.py - 1) : p.yo + wrapi(ly, p.ny)) * p.sy;
#pragma unroll
  for (int q = 0; q < C; ++q)
    c.xq[q] = xm ? clampi(p.xo + c.lx0 + q, 0, p.sy - 1) : p.xo + wrapi(c.lx0 + q, p.nx);
  c.vcp = p.vec && c.xq[C - 1] == c.xq[0] + C - 1 && (c.xq[0] & (C - 1)) == 0;
  // output cells: columns [e + K, e + K + W), rows [K, K + TYK), in the block
  c.st = 0;
  if (c.smax >= K && row < K + S::TYK && ly < p.ny) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int col = C * rn + q - b.e - K;
      if (col >= 0 && col < W) c.st |= 1 << q;
    }
    if (c.st == (1 << C) - 1 && p.vec && ((p.xo + c.lx0) & (C - 1)) == 0) c.st |= 256;
  }
  // the spheres: at the wrapped global coordinate
  const int gy = wrapi(oy + ly, p.gy) - p.hy;
  c.dy2 = gy * gy;
  c.gx0 = wrapi(ox + c.lx0, p.gx);
  c.dxm2 = INT_MAX;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int dx = wrapi(c.gx0 + q, p.gx) - p.hx, dc = dx - p.dhc;
    c.dxm2 = min(c.dxm2, min(dx * dx, dc * dc));
  }

  issue<K, 0>(p, b, c, 0);
  issue<K, 1>(p, b, c, 1);
  issue<K, 2>(p, b, c, 2);
  issue<K, 3>(p, b, c, 3);
  for (int j = 0; j < b.nsteps; j += S::RING) {
    step<K, 0>(p, b, c, j);
    if (j + 1 < b.nsteps) step<K, 1>(p, b, c, j + 1);
    if (j + 2 < b.nsteps) step<K, 2>(p, b, c, j + 2);
    if (j + 3 < b.nsteps) step<K, 3>(p, b, c, j + 3);
    if (j + 4 < b.nsteps) step<K, 4>(p, b, c, j + 4);
    if (j + 5 < b.nsteps) step<K, 5>(p, b, c, j + 5);
  }
  cp_wait<0>();
}

template <int K, bool MB, typename T>
int launch_mb(const Params<T>& p, dim3 grid, cudaStream_t st) {
  using S = Shape<K, T>;
  grid.y = (p.ny + S::TYK - 1) / S::TYK;
  cudaError_t err = cudaFuncSetAttribute(jacobi_multistep_kernel<K, MB, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::SMEM);
  if (err != cudaSuccess) return (int)err;
  jacobi_multistep_kernel<K, MB, T><<<grid, S::NT, S::SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

template <int K, typename T>
int launch(const Params<T>& p, dim3 grid, cudaStream_t st) {
  return p.bz * p.by * p.bx > 1 ? launch_mb<K, true>(p, grid, st)
                                : launch_mb<K, false>(p, grid, st);
}

// r[0..4]: resident blocks per SM, registers per thread, local (spill)
// bytes per thread, threads per block, dynamic shared memory bytes.
template <int K, bool MB, typename T>
int info(int* r) {
  using S = Shape<K, T>;
  cudaError_t err = cudaFuncSetAttribute(jacobi_multistep_kernel<K, MB, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::SMEM);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, jacobi_multistep_kernel<K, MB, T>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r[0], jacobi_multistep_kernel<K, MB, T>,
                                                        S::NT, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  r[1] = a.numRegs;
  r[2] = (int)a.localSizeBytes;
  r[3] = S::NT;
  r[4] = (int)S::SMEM;
  return 0;
}

template <bool MB, typename T>
int info_k(int k, int* r) {
  switch (k) {
    case 1: return info<1, MB, T>(r);
    case 2: return info<2, MB, T>(r);
    case 3: return info<3, MB, T>(r);
    case 4: return info<4, MB, T>(r);
    case 5: return info<5, MB, T>(r);
    case 6: return info<6, MB, T>(r);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
long long smem_bytes(int k) {
  switch (k) {
    case 1: return Shape<1, T>::SMEM;
    case 2: return Shape<2, T>::SMEM;
    case 3: return Shape<3, T>::SMEM;
    case 4: return Shape<4, T>::SMEM;
    case 5: return Shape<5, T>::SMEM;
    case 6: return Shape<6, T>::SMEM;
    default: return -1;
  }
}

// The launch's parameters, all but the operands (curr, out, bstride, tab
// and vec, which the two entries set).
template <typename T>
Params<T> make_params(long long sz, long long sy, int zo, int yo, int xo, int nz, int ny,
                      int nx, int bz, int by, int bx, int gx, int gy, int gz, int zchunks) {
  Params<T> p;
  p.sz = sz;
  p.sy = (int)sy;
  p.py = (int)(sz / sy);
  p.zo = zo;
  p.yo = yo;
  p.xo = xo;
  p.nz = nz;
  p.ny = ny;
  p.nx = nx;
  p.bz = bz;
  p.by = by;
  p.bx = bx;
  p.gz = gz;
  p.gy = gy;
  p.gx = gx;
  p.zchunk = (nz + zchunks - 1) / zchunks;
  p.nzc = (nz + p.zchunk - 1) / p.zchunk;
  p.hx = gx / 3;
  p.hy = gy / 2;
  p.hz = gz / 2;
  p.dhc = gx * 2 / 3 - gx / 3;
  p.band = gx / 10;
  p.thresh = (gx / 10 + 1) * (gx / 10 + 1);
  p.tab = nullptr;
  return p;
}

// grid: x the tiles of a row, z the blocks (or entries) times their z
// chunks; grid.y is set by launch_mb. mb forces the MB = true body (the
// positions form).
template <typename T>
int launch_k(const Params<T>& p, int k, int blocks, bool mb, cudaStream_t st) {
  constexpr int TX = TX_BYTES / (int)sizeof(T);
  const dim3 grid((p.nx + TX - 1) / TX, 1, blocks * p.nzc);
  if (mb) {
    switch (k) {
      case 1: return launch_mb<1, true>(p, grid, st);
      case 2: return launch_mb<2, true>(p, grid, st);
      case 3: return launch_mb<3, true>(p, grid, st);
      case 4: return launch_mb<4, true>(p, grid, st);
      case 5: return launch_mb<5, true>(p, grid, st);
      default: return launch_mb<6, true>(p, grid, st);
    }
  }
  switch (k) {
    case 1: return launch<1>(p, grid, st);
    case 2: return launch<2>(p, grid, st);
    case 3: return launch<3>(p, grid, st);
    case 4: return launch<4>(p, grid, st);
    case 5: return launch<5>(p, grid, st);
    default: return launch<6>(p, grid, st);
  }
}

template <typename T>
int launch_item(const void* curr, void* out, long long sz, long long sy, long long bstride,
                int zo, int yo, int xo, int nz, int ny, int nx, int bz, int by, int bx, int k,
                int gx, int gy, int gz, int zchunks, cudaStream_t st) {
  constexpr int C = 16 / (int)sizeof(T);
  Params<T> p = make_params<T>(sz, sy, zo, yo, xo, nz, ny, nx, bz, by, bx, gx, gy, gz, zchunks);
  p.curr = (const T*)curr;
  p.out = (T*)out;
  p.bstride = bstride;
  p.vec = ((uintptr_t)curr % 16 == 0) && ((uintptr_t)out % 16 == 0) && sz % C == 0 &&
          sy % C == 0 && bstride % C == 0;
  return launch_k<T>(p, k, bz * by * bx, false, st);
}

// The positions form: the kernel's table at dev_tab; aligned says every
// entry's pointers are 16-byte aligned (the caller's test).
template <typename T>
int launch_positions(const void* dev_tab, int entries, int aligned, long long sz, long long sy,
                     int zo, int yo, int xo, int nz, int ny, int nx, int bz, int by, int bx,
                     int k, int gx, int gy, int gz, int zchunks, cudaStream_t st) {
  constexpr int C = 16 / (int)sizeof(T);
  Params<T> p = make_params<T>(sz, sy, zo, yo, xo, nz, ny, nx, bz, by, bx, gx, gy, gz, zchunks);
  p.curr = nullptr;
  p.out = nullptr;
  p.bstride = 0;
  p.tab = (const long long*)dev_tab;
  p.vec = aligned && sz % C == 0 && sy % C == 0;
  return launch_k<T>(p, k, entries, true, st);
}

}  // namespace

// Shared memory of one block at depth k for item-byte cells (4: fp32, 8:
// fp64).
extern "C" long long jacobi_multistep_smem_bytes(int k, int item) {
  return item == 8 ? smem_bytes<double>(k) : (item == 4 ? smem_bytes<float>(k) : -1);
}

// curr / out: distinct stacks of bz * by * bx padded blocks of item-byte
// cells (4: fp32, 8: fp64; resident r = (iz * by + iy) * bx + ix at r *
// bstride), strides (sz, sy, 1). Each block's compute region is [zo, zo+nz)
// x [yo, yo+ny) x [xo, xo+nx); an axis with several blocks needs halos of
// radius >= k on both sides, already exchanged. (gx, gy, gz) is the global
// size the spheres are placed in; zchunks is the number of z chunks per
// block; dev the tensors' device.
extern "C" int jacobi_multistep_launch(const void* curr, void* out, long long sz,
                                       long long sy, long long bstride, int zo, int yo,
                                       int xo, int nz, int ny, int nx, int bz, int by,
                                       int bx, int k, int gx, int gy, int gz,
                                       int zchunks, int item, int dev, void* stream) {
  if (k < 1 || k > KMAX || k > nz || nz < 1 || ny < 1 || nx < 1 || zchunks < 1 ||
      bz < 1 || by < 1 || bx < 1 || sz > INT_MAX || sy > sz || (item != 4 && item != 8) ||
      (long long)bz * by * bx * zchunks > 65535)
    return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  cudaStream_t st = (cudaStream_t)stream;
  return item == 8 ? launch_item<double>(curr, out, sz, sy, bstride, zo, yo, xo, nz, ny, nx, bz,
                                         by, bx, k, gx, gy, gz, zchunks, st)
                   : launch_item<float>(curr, out, sz, sy, bstride, zo, yo, xo, nz, ny, nx, bz,
                                        by, bx, k, gx, gy, gz, zchunks, st);
}

// The positions form: k steps of each of `entries` separate padded blocks
// of a partition of bz x by x bx blocks (several: the deep-halo form), each
// at its own global origin, in one launch. dev_tab holds the entries in
// device memory, TAB_COLS int64 each (curr, out, origin x, y, z); aligned
// is nonzero when every entry's pointers are 16-byte aligned. Every block
// has the strides (sz, sy, 1), the compute region and halos of radius >= k
// on its multi-block axes as for jacobi_multistep_launch; zchunks is the
// number of z chunks per entry.
extern "C" int jacobi_multistep_positions_launch(const void* dev_tab, int entries, int aligned,
                                                 long long sz, long long sy, int zo, int yo,
                                                 int xo, int nz, int ny, int nx, int bz, int by,
                                                 int bx, int k, int gx, int gy, int gz,
                                                 int zchunks, int item, int dev, void* stream) {
  if (k < 1 || k > KMAX || k > nz || nz < 1 || ny < 1 || nx < 1 || zchunks < 1 ||
      bz < 1 || by < 1 || bx < 1 || (long long)bz * by * bx < 2 || entries < 1 ||
      dev_tab == nullptr || sz > INT_MAX || sy > sz || (item != 4 && item != 8) ||
      (long long)entries * zchunks > 65535)
    return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  cudaStream_t st = (cudaStream_t)stream;
  return item == 8 ? launch_positions<double>(dev_tab, entries, aligned, sz, sy, zo, yo, xo, nz,
                                              ny, nx, bz, by, bx, k, gx, gy, gz, zchunks, st)
                   : launch_positions<float>(dev_tab, entries, aligned, sz, sy, zo, yo, xo, nz,
                                             ny, nx, bz, by, bx, k, gx, gy, gz, zchunks, st);
}

// The instantiation of depth k (mb: the multi-block one) for item-byte cells
// on device dev: r[0..4] = resident blocks per SM, registers per thread,
// local (spill) bytes per thread, threads per block, dynamic shared memory
// bytes.
extern "C" int jacobi_multistep_info(int k, int mb, int item, int dev, int* r) {
  if (item != 4 && item != 8) return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  if (item == 8) return mb ? info_k<true, double>(k, r) : info_k<false, double>(k, r);
  return mb ? info_k<true, float>(k, r) : info_k<false, float>(k, r);
}
