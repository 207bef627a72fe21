// One Williamson RK3 stage of the 8-field Astaroth MHD system, fp64 or fp32.
//
// Replaces: stencil_tpu/ops/pallas_astaroth.py make_pallas_substep (the TPU
// kernel that slides a VMEM window of field planes down each y strip, with
// DMA semaphores and shift/ring window disciplines; fp32 only). Its two
// variants compute one function; this kernel serves both, in fp64 (the
// reference workload's type) and fp32, in every form the port drives: one
// block (the JAX package's single-block path), every resident block of a
// partition stacked on the card (its per-resident loop,
// stencil_tpu/astaroth/integrate.py:340-360, at each block's own extent on an
// uneven partition) and every resident's exterior shells after the exchange
// (its overlap iteration's re-integration, :392-401), one launch each; and
// every position of a mesh of block positions, each position's stacks their
// own allocations (the JAX package runs the substep inside shard_map on
// every device of its mesh, :312-330, 489-496), one launch for up to
// MAX_POSITIONS positions.
// Python wrappers, the task table's layout and plain PyTorch versions:
// stencil_tpu_torch/ops/astaroth_substep.py (substep, substep_tasks,
// substep_positions; substep_table, position_table; substep_plain,
// substep_tasks_plain, substep_positions_plain), whose math is
// stencil_tpu_torch/astaroth/{fd,equations}.py.
//
// What it computes, per compute cell: the 6th-order value / gradient /
// Hessian pencils of each field (fd.field_data; reach +-3 along each axis
// plus the diagonal pencils of the cross derivatives), the continuity,
// momentum, induction and entropy right-hand sides, and the RK3 update
//   stage 0:  out = curr + (beta * rate) * dt                 (out not read)
//   else:     out = curr + beta * (alpha/beta_prev * (curr - out) + rate * dt)
// written into `out` in place. Only compute cells are written; halos of
// `out` keep their contents.
//
// The property kept from the TPU kernel: no derivative, pencil or rate ever
// touches device memory. One pass over the fields per stage.
//
// What bounds it on an H100: at 256^3, bytes and operations are of the
// same order. Bytes, counted once per compute cell: stage 0 reads 8 fields
// and writes 8 (16 values), stages 1-2 also read out (24 values).
// Operations, counted from the code below (adds, subtracts, multiplies,
// negations and divides; each of the 5 exp counted as one): 669 for the 21
// first, 24 second and 12 cross derivatives (9, 12 and 16 each), 256 for
// the right-hand sides, 24 for the stage-0 update and 48 for the others, so
// 949 per cell at stage 0 and 973 at stages 1-2 (ops/astaroth_substep.py
// FLOPS_PER_CELL). With -fmad=false every operation is one instruction, and
// the card issues 64 fp64 or 128 fp32 of them per SM and clock: about 0.97
// ms of fp64 issue per 256^3 stage (utils/roofline.issue_ms), above its
// 0.85 ms of bytes. What sets the pace is on chip: each cell reads about
// 300 neighbour values, and a warp's read of 32 consecutive values costs
// 128-byte wavefronts of the SM's L1 / shared memory, 3 in fp64 (2 in
// fp32) from L1 at the rows' arbitrary alignment but 2 (1) from shared
// memory at any alignment; and each block copies its tile's footprint,
// about 3x the tile, out of L2 for every plane.
//
// Design. The TPU kernel's sliding window, as a ring in shared memory: a
// block owns a 32x4-cell tile and marches a z chunk; each field's planes
// z-3 .. z+3 of the tile's 38x10 footprint sit in an 8-slot ring, and the
// plane z+4 is copied in while plane z computes, so each value leaves L2
// once per block and every neighbour read is a shared-memory read. In fp64
// one thread issues the copy as one tensor copy per field (the TMA unit,
// a tensor map per field, completion on an mbarrier); where the layout
// does not allow that (fp32, whose 38-value rows are not a multiple of 16
// bytes, or rows and box starts not 16-byte aligned) each thread copies
// one footprint cell of every field with cp.async, the slower way in fp64
// (PERF.md).
// Each cell's work is split over three warp groups of the block, so that
// no thread carries the whole live set (one thread per cell held 255
// registers in fp64, one 256-thread block per SM):
//   MAG: ax, ay, az -> B = curl a, lap a, j; the induction rates;
//   MOM: uux, uuy, uuz -> the strain, advection, lap u and grad(div u)
//        terms; the momentum rates;
//   SCA: lnrho, entropy -> pressure, inv_rho and the entropy terms; the
//        continuity and entropy rates.
// 3 x 128 threads, each thread of each group owning one cell. Per z plane
// the groups hand 16 values of each cell over through shared memory under
// named barriers: TOP (every thread: the ring's next plane has landed and
// plane z-1 is done everywhere, so its slot and the hand-over may be
// reused) and FULL (MAG arrives with bar.arrive, it reads nothing back;
// MOM and SCA sync on it, they read each other's values too). At stages
// 1-2 each thread's out values are loaded at the top of its plane, ahead
// of the derivatives. Out-of-range threads of a ragged tile are masked,
// never returned: they fill the ring and take part in every barrier.
//
// A launch walks a table of tasks (int32 rows laid out in Python by
// ops/astaroth_substep.substep_table, the model of B1's sweep table): a
// task is one block of the stacks and a rect in it, with its tile columns
// and rows and the z planes a block of it marches, so the grid is every
// tile of every task, x tile fastest, then y tile, z chunk and task; one
// block of the grid is one tile's z chunk, as in the one-block launch, and
// finds its task by a binary search over the rows' first tiles. The table
// is a launch parameter (at most MAX_TASKS rows; a longer one is cut into
// several launches), so its values stay block-uniform. The one-block launch
// is the one-task case. A task's planes are its block's planes block * pz
// further down the stacks, so one tensor map per field spans every
// resident; whether tensor copies fill a task's ring is the table's choice
// per task (a shell's box starts at an odd x in fp64). The positions form is
// its own instantiation of the same tile body (substep_tile): a row also
// names its position, which picks that position's 8 + 8 pointers and 8
// tensor maps (each made on the position's own base address) at a
// block-uniform index, and the one-stack instantiation keeps its registers
// and its time (PERF.md).
// The z chunks are sized from the occupancy of the instantiation launched
// (ops/astaroth_substep.py substep_table).
//
// Floating point: every expression follows fd.py's and equations.py's
// operand order term by term, each evaluated by one thread (values only
// move through shared memory), so the kernel equals the plain version run
// by PyTorch on the card. Two rewrites mirror PyTorch's CUDA arithmetic: a
// divide by a Python scalar (x / mu0, x / cp_sound, x / 3.0) is a multiply
// by that scalar's reciprocal rounded to T; and `1.0 / t` is reciprocal(t).
// Python-side constant products (eta * mu0, gamma * (1 / cp), gamma - 1,
// alpha / beta_prev) are formed in double on the host, then rounded to T,
// as Python does. One rewrite is ours: fd.py starts every pencil sum from
// the literal 0.0, which changes at most the sign of an exact zero; the
// kernel starts from the first term. Built with -fmad=false, no fast math.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "jacobi_column.cuh"  // jacobi::DeviceScope

namespace {

constexpr int NF = 8;
constexpr int BX = 32;  // tile cells along x: one warp per row
constexpr int BY = 4;   // tile rows
constexpr int CELLS = BX * BY;
constexpr int GROUPS = 3;
constexpr int THREADS = GROUPS * CELLS;
constexpr int H = 3;                // stencil reach
constexpr int RW = BX + 2 * H;      // footprint row
constexpr int RH = BY + 2 * H;      // footprint rows
constexpr int PLANE = RW * RH;
// a ring slot: the footprint padded to 384 values, a multiple of 128 bytes
// in fp32 and fp64, as the tensor copies below want
constexpr int PSTRIDE = 384;
static_assert(PSTRIDE >= PLANE && PSTRIDE * 4 % 128 == 0, "ring slot");
constexpr int SLOTS = 8;            // planes z-3 .. z+3, and z+4 arriving
static_assert(PLANE <= THREADS, "one footprint cell per thread");

enum Group { MAG = 0, MOM, SCA };
enum Field { LNRHO = 0, UUX, UUY, UUZ, AX, AY, AZ, SS };
// values of a cell handed between the groups in one plane
enum Hand {
  H_B0 = 0, H_B1, H_B2, H_J0, H_J1, H_J2, H_JTERM,  // MAG
  H_LX, H_LY, H_LZ, H_P0, H_P1, H_P2, H_INV_RHO,   // SCA
  H_DIVU, H_CONTR,                                 // MOM
  NH
};
// named barrier ids (0 is __syncthreads')
constexpr int TOP = 1;
constexpr int FULL = 2;

// resident blocks per SM asked of ptxas: two in fp32 (the ring leaves room
// for two), one in fp64
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 4 ? 2 : 1; }

// shared memory: every field's ring, the hand-over, and the ring's
// mbarrier (16 bytes)
template <typename T>
constexpr long long smem_bytes() {
  return ((long long)NF * SLOTS * PSTRIDE + NH * CELLS) * (long long)sizeof(T) + 16;
}

template <typename T>
struct In {
  const T* p[NF];
};

template <typename T>
struct Out {
  T* p[NF];
};

// each field's tensor map (see make_maps for when there are any)
struct Maps {
  CUtensorMap m[NF];
};

// Every constant the stage reads, rounded to T once on the host.
template <typename T>
struct Coefs {
  T idx, idy, idz;                // AC_inv_ds{x,y,z}
  T cs2_sound, gamma, gamma_m1;   // gamma_m1 = (gamma - 1.0)
  T lnrho0, lnT0, eta, nu_visc, zeta, chi, cp_sound;
  T rcp_cp, rcp_mu0, rcp_3;       // PyTorch's x / s on CUDA: x * (T(1) / T(s))
  T inv_cp, gamma_inv_cp;         // Python: 1.0 / cp, gamma * (1.0 / cp)
  T eta_mu0;                      // Python: eta * mu0
  T beta, a_pb, dt;               // RK3: beta, alpha / beta_prev, dt
};

// A field's ring seen from the thread's cell: f(dz, dy, dx) is the value
// dz planes, dy rows and dx columns away. slot[j] is the ring offset of
// plane z - 3 + j.
template <typename T>
struct Win {
  const T* p;
  const int* slot;
  __device__ __forceinline__ T operator()(int dz, int dy, int dx) const {
    return p[slot[dz + H] + dy * RW + dx];
  }
};

// unit offsets (z, y, x) of the axes and of the diagonals shift_a(1) /
// shift_b(1) of fd._cross: derxy (0,i,i) / (0,-i,i), derxz (i,0,i) /
// (-i,0,i), deryz (i,i,0) / (-i,i,0)
template <int Z, int Y, int X>
struct Dir {
  static constexpr int z = Z, y = Y, x = X;
};
using AxX = Dir<0, 0, 1>;
using AxY = Dir<0, 1, 0>;
using AxZ = Dir<1, 0, 0>;
using XYa = Dir<0, 1, 1>;
using XYb = Dir<0, -1, 1>;
using XZa = Dir<1, 0, 1>;
using XZb = Dir<-1, 0, 1>;
using YZa = Dir<1, 1, 0>;
using YZb = Dir<-1, 1, 0>;

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
               "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Tensor copies by the TMA unit, completing on an mbarrier: one
// instruction moves a field's footprint plane (a 38 x 10 x 1 box of its
// tensor map) into a ring slot.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the one arrival of a phase, which also announces its bytes
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int x, int y, int z,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
        "r"(smem_addr(bar))
      : "memory");
}

// fd._first: sum_i c_i * (f[+i] - f[-i]), then * inv_ds
template <typename A, typename T>
__device__ __forceinline__ T der1(const Win<T>& f, T inv) {
  T r = T(3.0 / 4.0) * (f(A::z, A::y, A::x) - f(-A::z, -A::y, -A::x));
  r = r + T(-3.0 / 20.0) * (f(2 * A::z, 2 * A::y, 2 * A::x) - f(-2 * A::z, -2 * A::y, -2 * A::x));
  r = r + T(1.0 / 60.0) * (f(3 * A::z, 3 * A::y, 3 * A::x) - f(-3 * A::z, -3 * A::y, -3 * A::x));
  return r * inv;
}

// fd._second: c_0 * f + sum_i c_i * (f[+i] + f[-i]), then * inv_ds * inv_ds
template <typename A, typename T>
__device__ __forceinline__ T der2(const Win<T>& f, T inv) {
  T r = T(-49.0 / 18.0) * f(0, 0, 0);
  r = r + T(3.0 / 2.0) * (f(A::z, A::y, A::x) + f(-A::z, -A::y, -A::x));
  r = r + T(-3.0 / 20.0) * (f(2 * A::z, 2 * A::y, 2 * A::x) + f(-2 * A::z, -2 * A::y, -2 * A::x));
  r = r + T(1.0 / 90.0) * (f(3 * A::z, 3 * A::y, 3 * A::x) + f(-3 * A::z, -3 * A::y, -3 * A::x));
  return r * inv * inv;
}

// fd._cross: sum_i c_i * (f[a*i] + f[-a*i] - f[b*i] - f[-b*i]), then
// * inv_a * inv_b
template <typename A, typename B, typename T>
__device__ __forceinline__ T cross(const Win<T>& f, T ia, T ib) {
  T r = T(270.0 / 720.0) * (f(A::z, A::y, A::x) + f(-A::z, -A::y, -A::x)
                            - f(B::z, B::y, B::x) - f(-B::z, -B::y, -B::x));
  r = r + T(-27.0 / 720.0) * (f(2 * A::z, 2 * A::y, 2 * A::x) + f(-2 * A::z, -2 * A::y, -2 * A::x)
                              - f(2 * B::z, 2 * B::y, 2 * B::x) - f(-2 * B::z, -2 * B::y, -2 * B::x));
  r = r + T(2.0 / 720.0) * (f(3 * A::z, 3 * A::y, 3 * A::x) + f(-3 * A::z, -3 * A::y, -3 * A::x)
                            - f(3 * B::z, 3 * B::y, 3 * B::x) - f(-3 * B::z, -3 * B::y, -3 * B::x));
  return r * ia * ib;
}

// integrate.rk3_integrate; ov is out's value (not read at stage 0)
template <typename T, bool FIRST>
__device__ __forceinline__ void rk3(T* o, T cv, T ov, T rate, const Coefs<T>& k) {
  if (FIRST)
    *o = cv + k.beta * rate * k.dt;
  else
    *o = cv + k.beta * (k.a_pb * (cv - ov) + rate * k.dt);
}

// What a group's plane needs: the rings (ring + f * SLOTS * PSTRIDE + the
// thread's footprint offset), this plane's slot offsets, out's pointers at
// the cell, out's values, the cell's hand-over slots and whether the
// thread owns a compute cell.
template <typename T>
struct Plane {
  const T* ring;
  const int* slot;
  long long c;
  const T* ov;
  T* h;
  bool live;
  __device__ __forceinline__ Win<T> win(int f) const { return {ring + f * SLOTS * PSTRIDE, slot}; }
};

// -- MAG: B = curl(a), lap(a), j = (grad(div a) - lap a) / mu0; hands B, j
// and eta*mu0*|j|^2 over, then writes the induction rates u x B + eta lap a
template <typename T, bool FIRST>
__device__ __forceinline__ void mag_plane(const Out<T>& out, const Coefs<T>& k,
                                          const Plane<T>& q) {
  const Win<T> ax = q.win(AX), ay = q.win(AY), az = q.win(AZ);
  const T idx = k.idx, idy = k.idy, idz = k.idz;
  T* const h = q.h;
  // every ring value used is read before the first store to shared memory
  // or barrier: the compiler merges repeated reads only up to there
  T cx = T(0), cy = T(0), cz = T(0), u0 = T(0), u1 = T(0), u2 = T(0);
  T B0 = T(0), B1 = T(0), B2 = T(0), lap_a0 = T(0), lap_a1 = T(0), lap_a2 = T(0);
  if (q.live) {
    cx = ax(0, 0, 0);
    cy = ay(0, 0, 0);
    cz = az(0, 0, 0);
    u0 = q.win(UUX)(0, 0, 0);
    u1 = q.win(UUY)(0, 0, 0);
    u2 = q.win(UUZ)(0, 0, 0);
    B0 = der1<AxY>(az, idy) - der1<AxZ>(ay, idz);
    B1 = der1<AxZ>(ax, idz) - der1<AxX>(az, idx);
    B2 = der1<AxX>(ay, idx) - der1<AxY>(ax, idy);
    const T ax_xx = der2<AxX>(ax, idx), ay_yy = der2<AxY>(ay, idy), az_zz = der2<AxZ>(az, idz);
    lap_a0 = ax_xx + der2<AxY>(ax, idy) + der2<AxZ>(ax, idz);
    lap_a1 = der2<AxX>(ay, idx) + ay_yy + der2<AxZ>(ay, idz);
    lap_a2 = der2<AxX>(az, idx) + der2<AxY>(az, idy) + az_zz;
    const T j0 = (ax_xx + cross<XYa, XYb>(ay, idx, idy) + cross<XZa, XZb>(az, idx, idz)
                  - lap_a0) * k.rcp_mu0;
    const T j1 = (cross<XYa, XYb>(ax, idx, idy) + ay_yy + cross<YZa, YZb>(az, idy, idz)
                  - lap_a1) * k.rcp_mu0;
    const T j2 = (cross<XZa, XZb>(ax, idx, idz) + cross<YZa, YZb>(ay, idy, idz) + az_zz
                  - lap_a2) * k.rcp_mu0;
    h[H_B0 * CELLS] = B0;
    h[H_B1 * CELLS] = B1;
    h[H_B2 * CELLS] = B2;
    h[H_J0 * CELLS] = j0;
    h[H_J1 * CELLS] = j1;
    h[H_J2 * CELLS] = j2;
    h[H_JTERM * CELLS] = k.eta_mu0 * (j0 * j0 + j1 * j1 + j2 * j2);
  }
  // barriers are executed by every thread of the block, live or not
  bar_arrive(FULL);
  if (!q.live) return;
  rk3<T, FIRST>(out.p[AX] + q.c, cx, q.ov[0], (u1 * B2 - u2 * B1) + k.eta * lap_a0, k);
  rk3<T, FIRST>(out.p[AY] + q.c, cy, q.ov[1], (u2 * B0 - u0 * B2) + k.eta * lap_a1, k);
  rk3<T, FIRST>(out.p[AZ] + q.c, cz, q.ov[2], (u0 * B1 - u1 * B0) + k.eta * lap_a2, k);
}

// -- MOM: velocity gradients, div u and the strain's contraction (handed
// over), advection, lap u and grad(div u); then, with SCA's and MAG's
// values, the momentum rates -adv - pressure + inv_rho (j x B) + visc +
// zeta grad(div u)
template <typename T, bool FIRST>
__device__ __forceinline__ void mom_plane(const Out<T>& out, const Coefs<T>& k,
                                          const Plane<T>& q) {
  const Win<T> ux = q.win(UUX), uy = q.win(UUY), uz = q.win(UUZ);
  const T idx = k.idx, idy = k.idy, idz = k.idz;
  T* const h = q.h;
  T sxx = T(0), sxy = T(0), sxz = T(0), syy = T(0), syz = T(0), szz = T(0);
  T adv0 = T(0), adv1 = T(0), adv2 = T(0), god_u0 = T(0), god_u1 = T(0), god_u2 = T(0);
  T lap_u0 = T(0), lap_u1 = T(0), lap_u2 = T(0), u0 = T(0), u1 = T(0), u2 = T(0);
  T div_u = T(0), contr = T(0);
  if (q.live) {
    u0 = ux(0, 0, 0);
    u1 = uy(0, 0, 0);
    u2 = uz(0, 0, 0);
    const T ux_x = der1<AxX>(ux, idx), ux_y = der1<AxY>(ux, idy), ux_z = der1<AxZ>(ux, idz);
    const T uy_x = der1<AxX>(uy, idx), uy_y = der1<AxY>(uy, idy), uy_z = der1<AxZ>(uy, idz);
    const T uz_x = der1<AxX>(uz, idx), uz_y = der1<AxY>(uz, idy), uz_z = der1<AxZ>(uz, idz);
    div_u = ux_x + uy_y + uz_z;
    sxx = T(2.0 / 3.0) * ux_x - T(1.0 / 3.0) * (uy_y + uz_z);
    sxy = T(0.5) * (ux_y + uy_x);
    sxz = T(0.5) * (ux_z + uz_x);
    syy = T(2.0 / 3.0) * uy_y - T(1.0 / 3.0) * (ux_x + uz_z);
    syz = T(0.5) * (uy_z + uz_y);
    szz = T(2.0 / 3.0) * uz_z - T(1.0 / 3.0) * (ux_x + uy_y);
    contr = sxx * sxx + syy * syy + szz * szz + T(2.0) * (sxy * sxy + sxz * sxz + syz * syz);
    adv0 = ux_x * u0 + ux_y * u1 + ux_z * u2;
    adv1 = uy_x * u0 + uy_y * u1 + uy_z * u2;
    adv2 = uz_x * u0 + uz_y * u1 + uz_z * u2;
    const T ux_xx = der2<AxX>(ux, idx), uy_yy = der2<AxY>(uy, idy), uz_zz = der2<AxZ>(uz, idz);
    lap_u0 = ux_xx + der2<AxY>(ux, idy) + der2<AxZ>(ux, idz);
    lap_u1 = der2<AxX>(uy, idx) + uy_yy + der2<AxZ>(uy, idz);
    lap_u2 = der2<AxX>(uz, idx) + der2<AxY>(uz, idy) + uz_zz;
    god_u0 = ux_xx + cross<XYa, XYb>(uy, idx, idy) + cross<XZa, XZb>(uz, idx, idz);
    god_u1 = cross<XYa, XYb>(ux, idx, idy) + uy_yy + cross<YZa, YZb>(uz, idy, idz);
    god_u2 = cross<XZa, XZb>(ux, idx, idz) + cross<YZa, YZb>(uy, idy, idz) + uz_zz;
    h[H_DIVU * CELLS] = div_u;
    h[H_CONTR * CELLS] = contr;
  }
  bar_sync(FULL);
  if (!q.live) return;
  const T l_x = h[H_LX * CELLS], l_y = h[H_LY * CELLS], l_z = h[H_LZ * CELLS];
  const T sg0 = sxx * l_x + sxy * l_y + sxz * l_z;
  const T sg1 = sxy * l_x + syy * l_y + syz * l_z;
  const T sg2 = sxz * l_x + syz * l_y + szz * l_z;
  const T v0 = k.nu_visc * (lap_u0 + god_u0 * k.rcp_3 + T(2.0) * sg0);
  const T v1 = k.nu_visc * (lap_u1 + god_u1 * k.rcp_3 + T(2.0) * sg1);
  const T v2 = k.nu_visc * (lap_u2 + god_u2 * k.rcp_3 + T(2.0) * sg2);
  const T inv_rho = h[H_INV_RHO * CELLS];
  const T B0 = h[H_B0 * CELLS], B1 = h[H_B1 * CELLS], B2 = h[H_B2 * CELLS];
  const T j0 = h[H_J0 * CELLS], j1 = h[H_J1 * CELLS], j2 = h[H_J2 * CELLS];
  rk3<T, FIRST>(out.p[UUX] + q.c, u0, q.ov[0],
                -adv0 - h[H_P0 * CELLS] + inv_rho * (j1 * B2 - j2 * B1) + v0 + k.zeta * god_u0, k);
  rk3<T, FIRST>(out.p[UUY] + q.c, u1, q.ov[1],
                -adv1 - h[H_P1 * CELLS] + inv_rho * (j2 * B0 - j0 * B2) + v1 + k.zeta * god_u1, k);
  rk3<T, FIRST>(out.p[UUZ] + q.c, u2, q.ov[2],
                -adv2 - h[H_P2 * CELLS] + inv_rho * (j0 * B1 - j1 * B0) + v2 + k.zeta * god_u2, k);
}

// -- SCA: lnrho and entropy gradients, the pressure terms and inv_rho
// (handed over) and the entropy terms; then, with MOM's div u and strain
// contraction and MAG's |j|^2 term, the continuity and entropy rates
template <typename T, bool FIRST>
__device__ __forceinline__ void sca_plane(const Out<T>& out, const Coefs<T>& k,
                                          const Plane<T>& q) {
  const Win<T> lr = q.win(LNRHO), ss = q.win(SS);
  const T idx = k.idx, idy = k.idy, idz = k.idz;
  T* const h = q.h;
  T l = T(0), s = T(0), adv_l = T(0), adv_s = T(0), rho = T(0), inv_pT = T(0), heat = T(0);
  if (q.live) {
    l = lr(0, 0, 0);
    s = ss(0, 0, 0);
    const T u0 = q.win(UUX)(0, 0, 0), u1 = q.win(UUY)(0, 0, 0), u2 = q.win(UUZ)(0, 0, 0);
    const T l_x = der1<AxX>(lr, idx), l_y = der1<AxY>(lr, idy), l_z = der1<AxZ>(lr, idz);
    const T s_x = der1<AxX>(ss, idx), s_y = der1<AxY>(ss, idy), s_z = der1<AxZ>(ss, idz);
    const T s_lap = der2<AxX>(ss, idx) + der2<AxY>(ss, idy) + der2<AxZ>(ss, idz);
    const T l_lap = der2<AxX>(lr, idx) + der2<AxY>(lr, idy) + der2<AxZ>(lr, idz);
    const T cs2 = k.cs2_sound * ex(k.gamma * s * k.rcp_cp + k.gamma_m1 * (l - k.lnrho0));
    h[H_LX * CELLS] = l_x;
    h[H_LY * CELLS] = l_y;
    h[H_LZ * CELLS] = l_z;
    h[H_P0 * CELLS] = cs2 * (s_x * k.rcp_cp + l_x);
    h[H_P1 * CELLS] = cs2 * (s_y * k.rcp_cp + l_y);
    h[H_P2 * CELLS] = cs2 * (s_z * k.rcp_cp + l_z);
    h[H_INV_RHO * CELLS] = ex(-l);
    adv_l = -(u0 * l_x + u1 * l_y + u2 * l_z);
    adv_s = -(u0 * s_x + u1 * s_y + u2 * s_z);
    rho = ex(l);
    const T lnT = k.lnT0 + k.gamma * s * k.rcp_cp + k.gamma_m1 * (l - k.lnrho0);
    inv_pT = T(1.0) / (rho * ex(lnT));
    const T first = k.gamma_inv_cp * s_lap + k.gamma_m1 * l_lap;
    const T sec0 = k.gamma_inv_cp * s_x + k.gamma_m1 * l_x;
    const T sec1 = k.gamma_inv_cp * s_y + k.gamma_m1 * l_y;
    const T sec2 = k.gamma_inv_cp * s_z + k.gamma_m1 * l_z;
    const T thi0 = k.gamma * (k.inv_cp * s_x + l_x) + (-l_x);
    const T thi1 = k.gamma * (k.inv_cp * s_y + l_y) + (-l_y);
    const T thi2 = k.gamma * (k.inv_cp * s_z + l_z) + (-l_z);
    const T chi = k.chi * ex(-l) * k.rcp_cp;
    heat = k.cp_sound * chi * (first + (sec0 * thi0 + sec1 * thi1 + sec2 * thi2));
  }
  bar_sync(FULL);
  if (!q.live) return;
  const T div_u = h[H_DIVU * CELLS];
  const T rhs = h[H_JTERM * CELLS] + T(2.0) * rho * k.nu_visc * h[H_CONTR * CELLS]
                + k.zeta * rho * div_u * div_u;
  rk3<T, FIRST>(out.p[LNRHO] + q.c, l, q.ov[0], adv_l - div_u, k);
  rk3<T, FIRST>(out.p[SS] + q.c, s, q.ov[1], adv_s + inv_pT * rhs + heat, k);
}

// fn(i, f) for the i-th field f that group g owns, both constants once
// inlined (a parameter array indexed at run time would be copied to local
// memory)
template <typename Fn>
__device__ __forceinline__ void each_field(int g, Fn&& fn) {
  if (g == MAG) {
    fn(0, AX);
    fn(1, AY);
    fn(2, AZ);
  } else if (g == MOM) {
    fn(0, UUX);
    fn(1, UUY);
    fn(2, UUZ);
  } else {
    fn(0, LNRHO);
    fn(1, SS);
  }
}

constexpr int TASK_COLS = 12;   // int32 columns of a task row
constexpr int MAX_TASKS = 256;  // rows a launch's table holds

// One row of the task table (ops/astaroth_substep.substep_table): the
// task's first tile in the launch's walk; the resident block it updates, an
// index into the stacks of padded blocks; its rect's origin (z, y, x) in
// that block and its extent; its tile columns and rows; the z planes a block
// of it marches; whether tensor copies fill its ring.
struct SubstepTask {
  int start, block, zo, yo, xo, nz, ny, nx, gx, gy, zchunk, tma;
};
static_assert(sizeof(SubstepTask) == TASK_COLS * sizeof(int), "a task row");

// The table travels in the launch's parameters (12 KB of the 32 KB a launch
// may pass): every thread reads its block's row at a block-uniform index, so
// the row's values stay uniform, as the one-block launch's parameters were,
// and the plane loop keeps its uniform control and addressing (a table in
// device memory, found by thread 0 and handed over through shared memory,
// ran the one-block launch 4-8% slower in fp64 on an H100, PERF.md).
struct Table {
  int ntask;
  SubstepTask row[MAX_TASKS];
};

// The positions form (a mesh of block positions, each position's stacks
// their own allocations): a task row also names its position, an index
// into the launch's MAX_POSITIONS sets of field pointers and tensor maps.
// The table and those sets travel in the parameters together: 13 KB of
// rows and 9 KB of pointers and maps (8 positions x 8 fields x 128 B), of
// the 32 KB a launch may pass; a mesh of more positions goes out in
// several launches (ops/astaroth_substep.position_launches).
constexpr int POSITION_COLS = 13;  // int32 columns of a positions row
constexpr int MAX_POSITIONS = 8;   // positions one launch takes

struct PositionTask {
  SubstepTask task;
  int pos;
};
static_assert(sizeof(PositionTask) == POSITION_COLS * sizeof(int), "a positions row");

struct PositionTable {
  int ntask;
  PositionTask row[MAX_TASKS];
};

template <typename T>
struct Positions {
  In<T> in[MAX_POSITIONS];
  Out<T> out[MAX_POSITIONS];
  Maps maps[MAX_POSITIONS];
};

__device__ __forceinline__ int row_start(const SubstepTask& r) { return r.start; }
__device__ __forceinline__ int row_start(const PositionTask& r) { return r.task.start; }

// the block's task: the last row whose first tile is at most block w's
template <typename Tab>
__device__ __forceinline__ int find_task(const Tab& tab, int w) {
  int lo = 0, hi = tab.ntask - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (row_start(tab.row[mid]) <= w) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// One block of the grid: tile w - t.start of task t, over the stacks whose
// pointers are `in` / `out` and tensor maps `maps` (valid when maps_ok).
template <typename T, bool FIRST>
__device__ __forceinline__ void substep_tile(const In<T>& in, const Out<T>& out,
                                             const Maps& maps, bool maps_ok, const Coefs<T>& k,
                                             const SubstepTask& t, int w, int sz, int sy,
                                             int pz) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // [NF][SLOTS][PSTRIDE]
  T* const hand = ring + NF * SLOTS * PSTRIDE;      // [NH][CELLS]
  unsigned long long* const fill_bar = reinterpret_cast<unsigned long long*>(hand + NH * CELLS);
  const int tid = threadIdx.x + BX * (threadIdx.y + BY * threadIdx.z);
  const int grp = threadIdx.z;
  const int gxy = t.gx * t.gy, u = w - t.start, tz = u / gxy, r = u - tz * gxy;
  const int x0 = r % t.gx * BX, y0 = r / t.gx * BY;
  const int nz = t.nz, ny = t.ny, nx = t.nx, yo = t.yo, xo = t.xo;
  const int zo = t.block * pz + t.zo;  // the rect's first plane in the stacks
  const int tx = x0 + threadIdx.x, ty = y0 + threadIdx.y;
  const bool live = tx < nx && ty < ny;
  const int z0 = tz * t.zchunk;
  const int z1 = min(nz, z0 + t.zchunk);
  const bool tma = maps_ok && t.tma;

  // With tensor maps (fp64 whose rows, planes and box starts are 16-byte
  // aligned), one thread copies each field's footprint plane with one
  // tensor copy; the unit fills what lies outside the padded block with
  // zeros, which no compute cell reads. Otherwise each thread copies one
  // footprint cell of every field with cp.async, if it lies in the rect
  // grown by H.
  if (tma && tid == 0) mbar_init(fill_bar);
  bar_sync(TOP);
  unsigned phase = 0;
  const int frow = tid / RW, fcol = tid % RW;
  const bool fills = tid < PLANE && x0 - H + fcol < nx + H && y0 - H + frow < ny + H;
  // in-plane offsets fit 32 bits (3 sz < 2^30): each saves a register the
  // fp64 stages 1-2 need, at the 168 a 384-thread block may hold
  const int fsrc = (yo + y0 - H + frow) * sy + (xo + x0 - H + fcol);
  // planes zp0 .. zp0 + np - 1 of every field, plane zp into its slot
  // (zp - z0 + H) mod SLOTS
  auto fill = [&](int zp0, int np) {
    if (tma) {
      if (tid == 0) {
        mbar_expect(fill_bar, np * NF * PLANE * (unsigned)sizeof(T));
        for (int zp = zp0; zp < zp0 + np; ++zp)
#pragma unroll
          for (int f = 0; f < NF; ++f)
            tensor_copy(ring + (f * SLOTS + ((zp - z0 + H) & (SLOTS - 1))) * PSTRIDE, &maps.m[f],
                        xo + x0 - H, yo + y0 - H, zo + zp, fill_bar);
      }
      return;
    }
    for (int zp = zp0; zp < zp0 + np; ++zp) {
      if (fills) {
        const long long src = (long long)(zo + zp) * sz + fsrc;
        T* const dst = ring + ((zp - z0 + H) & (SLOTS - 1)) * PSTRIDE + tid;
#pragma unroll
        for (int f = 0; f < NF; ++f) cp_async(dst + f * SLOTS * PSTRIDE, in.p[f] + src);
      }
      cp_commit();
    }
  };
  auto wait_fill = [&]() {
    if (tma)
      mbar_wait(fill_bar, phase++ & 1);
    else
      cp_wait_all();
  };
  fill(z0 - H, 2 * H + 1);

  Plane<T> q;
  q.ring = ring + (threadIdx.y + H) * RW + threadIdx.x + H;
  q.h = hand + threadIdx.y * BX + threadIdx.x;
  q.live = live;
  int slot[2 * H + 1];
  q.slot = slot;
  T ov[3] = {T(0), T(0), T(0)};
  q.ov = ov;
  const int col = (yo + ty) * sy + (xo + tx);
  for (int z = z0; z < z1; ++z) {
    q.c = (long long)(zo + z) * sz + col;
    // out's values first: they are the only reads from device memory
    if (!FIRST && live) each_field(grp, [&](int i, int f) { ov[i] = out.p[f][q.c]; });
    // plane z + 3 has landed everywhere, and plane z - 1 is done: its
    // slot (plane z - 4's) and the hand-over may be written again
    wait_fill();
    bar_sync(TOP);
    if (z + 1 < z1) fill(z + H + 1, 1);
#pragma unroll
    for (int j = 0; j <= 2 * H; ++j) slot[j] = ((z - z0 + j) & (SLOTS - 1)) * PSTRIDE;
    if (grp == MAG)
      mag_plane<T, FIRST>(out, k, q);
    else if (grp == MOM)
      mom_plane<T, FIRST>(out, k, q);
    else
      sca_plane<T, FIRST>(out, k, q);
  }
  // the mbarrier's shared memory is the next block's plain memory
  if (tma) {
    bar_sync(TOP);
    if (tid == 0) mbar_inval(fill_bar);
  }
}

template <typename T, bool FIRST>
__global__ void __launch_bounds__(THREADS, min_blocks<T>())
astaroth_substep_kernel(const __grid_constant__ In<T> in, Out<T> out,
                        const __grid_constant__ Maps maps, int maps_ok, Coefs<T> k,
                        const __grid_constant__ Table tab, int sz, int sy, int pz) {
  const int w = blockIdx.x;
  substep_tile<T, FIRST>(in, out, maps, maps_ok != 0, k, tab.row[find_task(tab, w)], w, sz, sy,
                         pz);
}

// The positions form: the task's position picks its pointers and maps
// (maps_ok: bit p for position p), at a block-uniform index.
template <typename T, bool FIRST>
__global__ void __launch_bounds__(THREADS, min_blocks<T>())
astaroth_substep_positions_kernel(const __grid_constant__ Positions<T> f, int maps_ok, Coefs<T> k,
                                  const __grid_constant__ PositionTable tab, int sz, int sy,
                                  int pz) {
  const int w = blockIdx.x;
  const PositionTask& r = tab.row[find_task(tab, w)];
  const int pos = r.pos;
  substep_tile<T, FIRST>(f.in[pos], f.out[pos], f.maps[pos], (maps_ok >> pos) & 1, k, r.task, w,
                         sz, sy, pz);
}

template <typename T>
Coefs<T> make_coefs(const double* p) {
  // p: inv_dsx, inv_dsy, inv_dsz, cs2_sound, gamma, cp_sound, lnrho0, lnT0,
  //    mu0, eta, nu_visc, zeta, chi, dt, beta, alpha_over_beta_prev
  Coefs<T> k;
  k.idx = (T)p[0];
  k.idy = (T)p[1];
  k.idz = (T)p[2];
  k.cs2_sound = (T)p[3];
  k.gamma = (T)p[4];
  k.gamma_m1 = (T)(p[4] - 1.0);
  k.cp_sound = (T)p[5];
  k.lnrho0 = (T)p[6];
  k.lnT0 = (T)p[7];
  k.eta = (T)p[9];
  k.nu_visc = (T)p[10];
  k.zeta = (T)p[11];
  k.chi = (T)p[12];
  k.rcp_cp = T(1) / (T)p[5];
  k.rcp_mu0 = T(1) / (T)p[8];
  k.rcp_3 = T(1) / T(3);
  k.inv_cp = (T)(1.0 / p[5]);
  k.gamma_inv_cp = (T)(p[4] * (1.0 / p[5]));
  k.eta_mu0 = (T)(p[9] * p[8]);
  k.dt = (T)p[13];
  k.beta = (T)p[14];
  k.a_pb = (T)p[15];
  return k;
}

// cuTensorMapEncodeTiled, looked up through the runtime (the library links
// no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Each field's tensor map over its stack of nblocks padded blocks, (x, y,
// z) = (sy, sz / sy, nblocks * pz) values with a RW x RH x 1 box (a task's
// planes are its block's, block * pz further); false where the layout does
// not allow them: fp32 (a footprint row of 152 bytes is no multiple of 16),
// or rows, planes or a field's first value not 16-byte aligned. Each task's
// box starts (xo - H + a multiple of 32) are the table's tma column.
template <typename T>
bool make_maps(const In<T>& in, long long sz, long long sy, long long planes, Maps* maps) {
  if (sizeof(T) != 8 || sy * sizeof(T) % 16 || sz * sizeof(T) % 16 || sz % sy) return false;
  for (int f = 0; f < NF; ++f)
    if (reinterpret_cast<uintptr_t>(in.p[f]) % 16) return false;
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)sy, (cuuint64_t)(sz / sy), (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)(sy * sizeof(T)), (cuuint64_t)(sz * sizeof(T))};
  const cuuint32_t box[3] = {RW, RH, 1}, step[3] = {1, 1, 1};
  for (int f = 0; f < NF; ++f)
    if (enc(&maps->m[f], CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3, const_cast<T*>(in.p[f]), dims,
            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  return true;
}

// dynamic shared memory above 48 KB has to be asked for, per kernel
template <typename T, typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<T>());
}

template <typename T, bool FIRST>
int launch(void* const* curr, void* const* out, const double* prm, const Table& tab, int tiles,
           long long sz, long long sy, int pz, int nblocks, cudaStream_t st) {
  In<T> in;
  Out<T> o;
  for (int f = 0; f < NF; ++f) {
    in.p[f] = (const T*)curr[f];
    o.p[f] = (T*)out[f];
  }
  const cudaError_t err = allow_smem<T>(astaroth_substep_kernel<T, FIRST>);
  if (err != cudaSuccess) return (int)err;
  int tma = 0;
  for (int i = 0; i < tab.ntask; ++i) tma |= tab.row[i].tma;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const int maps_ok = tma && make_maps<T>(in, sz, sy, (long long)nblocks * pz, &maps) ? 1 : 0;
  astaroth_substep_kernel<T, FIRST><<<tiles, dim3(BX, BY, GROUPS), smem_bytes<T>(), st>>>(
      in, o, maps, maps_ok, make_coefs<T>(prm), tab, (int)sz, (int)sy, pz);
  return (int)cudaGetLastError();
}

// curr / out: npos x NF pointers, position-major; each position's maps are
// made when one of its tasks asks for tensor copies, each on its own base
// address (make_maps checks its 16-byte alignment)
template <typename T, bool FIRST>
int launch_positions(void* const* curr, void* const* out, int npos, const double* prm,
                     const PositionTable& tab, int tiles, long long sz, long long sy, int pz,
                     int nblocks, cudaStream_t st) {
  Positions<T> f;
  memset(&f, 0, sizeof(f));
  for (int p = 0; p < npos; ++p)
    for (int q = 0; q < NF; ++q) {
      f.in[p].p[q] = (const T*)curr[p * NF + q];
      f.out[p].p[q] = (T*)out[p * NF + q];
    }
  const cudaError_t err = allow_smem<T>(astaroth_substep_positions_kernel<T, FIRST>);
  if (err != cudaSuccess) return (int)err;
  int tma[MAX_POSITIONS] = {0};
  for (int i = 0; i < tab.ntask; ++i) tma[tab.row[i].pos] |= tab.row[i].task.tma;
  int maps_ok = 0;
  for (int p = 0; p < npos; ++p)
    if (tma[p] && make_maps<T>(f.in[p], sz, sy, (long long)nblocks * pz, &f.maps[p]))
      maps_ok |= 1 << p;
  astaroth_substep_positions_kernel<T, FIRST>
      <<<tiles, dim3(BX, BY, GROUPS), smem_bytes<T>(), st>>>(f, maps_ok, make_coefs<T>(prm), tab,
                                                             (int)sz, (int)sy, pz);
  return (int)cudaGetLastError();
}

// what an instantiation reports: blocks per SM, registers, local (spill)
// bytes, threads per block, dynamic shared memory bytes
template <typename T, typename K>
int info(K kernel, int* r) {
  cudaError_t err = allow_smem<T>(kernel);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r[0], kernel, THREADS, smem_bytes<T>());
  if (err != cudaSuccess) return (int)err;
  r[1] = a.numRegs;
  r[2] = (int)a.localSizeBytes;
  r[3] = THREADS;
  r[4] = (int)smem_bytes<T>();
  return 0;
}

bool bad_shape(int nprm, int ntask, long long tiles, const int* rows, long long sz, long long sy,
               int pz, int nblocks) {
  return nprm != 16 || ntask < 1 || ntask > MAX_TASKS || tiles < 1 || tiles >= (1LL << 31) ||
         rows[0] != 0 || sy < 1 || sz < sy || pz < 2 * H + 1 || nblocks < 1 ||
         (long long)nblocks * pz >= (1LL << 31) || 3 * sz > (1LL << 30);
}

}  // namespace

// curr / out: host arrays of 8 device pointers (FIELDS order: lnrho, uux,
// uuy, uuz, ax, ay, az, entropy), each to a contiguous stack of nblocks
// padded (pz, py, px) blocks. prm: the 16 doubles listed in make_coefs.
// first: 1 for RK3 stage 0 (out not read). rows: a host array of ntask
// (at most MAX_TASKS) rows of task_cols int32 (ops/astaroth_substep.
// substep_table), the first starting at tile 0, `tiles` blocks to launch in
// all; each task's rect lies in its block with at least 3 halo cells on every
// side. sz / sy: plane and row strides. dev: the device the fields are on. A
// launch the device refuses returns its error; there is no fallback.
extern "C" int astaroth_substep_launch(void* const* curr, void* const* out, int elem_size,
                                       const double* prm, int nprm, int first, const int* rows,
                                       int ntask, int task_cols, long long tiles, long long sz,
                                       long long sy, int pz, int nblocks, int dev, void* stream) {
  if (task_cols != TASK_COLS || bad_shape(nprm, ntask, tiles, rows, sz, sy, pz, nblocks))
    return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  Table tab;
  tab.ntask = ntask;
  memcpy(tab.row, rows, (size_t)ntask * sizeof(SubstepTask));
  cudaStream_t st = (cudaStream_t)stream;
  const int fi = first ? 1 : 0, n = (int)tiles;
  if (elem_size == 8)
    return fi ? launch<double, true>(curr, out, prm, tab, n, sz, sy, pz, nblocks, st)
              : launch<double, false>(curr, out, prm, tab, n, sz, sy, pz, nblocks, st);
  if (elem_size == 4)
    return fi ? launch<float, true>(curr, out, prm, tab, n, sz, sy, pz, nblocks, st)
              : launch<float, false>(curr, out, prm, tab, n, sz, sy, pz, nblocks, st);
  return (int)cudaErrorInvalidValue;
}

// The positions form over npos (at most MAX_POSITIONS) positions: curr /
// out hold npos x 8 device pointers, position-major (position p's field f
// at p * 8 + f), each to that position's contiguous stack of nblocks padded
// blocks (every position's stacks the same shape, each its own
// allocation); rows are position_cols int32 each (ops/astaroth_substep.
// position_table: a substep row, then the task's position in 0 .. npos-1).
// The rest as astaroth_substep_launch.
extern "C" int astaroth_substep_positions_launch(void* const* curr, void* const* out, int npos,
                                                 int elem_size, const double* prm, int nprm,
                                                 int first, const int* rows, int ntask,
                                                 int position_cols, long long tiles, long long sz,
                                                 long long sy, int pz, int nblocks, int dev,
                                                 void* stream) {
  if (position_cols != POSITION_COLS || npos < 1 || npos > MAX_POSITIONS ||
      bad_shape(nprm, ntask, tiles, rows, sz, sy, pz, nblocks))
    return (int)cudaErrorInvalidValue;
  PositionTable tab;
  tab.ntask = ntask;
  memcpy(tab.row, rows, (size_t)ntask * sizeof(PositionTask));
  for (int i = 0; i < ntask; ++i)
    if (tab.row[i].pos < 0 || tab.row[i].pos >= npos || tab.row[i].task.block < 0 ||
        tab.row[i].task.block >= nblocks)
      return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  cudaStream_t st = (cudaStream_t)stream;
  const int fi = first ? 1 : 0, n = (int)tiles;
  if (elem_size == 8)
    return fi ? launch_positions<double, true>(curr, out, npos, prm, tab, n, sz, sy, pz, nblocks, st)
              : launch_positions<double, false>(curr, out, npos, prm, tab, n, sz, sy, pz, nblocks,
                                                st);
  if (elem_size == 4)
    return fi ? launch_positions<float, true>(curr, out, npos, prm, tab, n, sz, sy, pz, nblocks, st)
              : launch_positions<float, false>(curr, out, npos, prm, tab, n, sz, sy, pz, nblocks,
                                               st);
  return (int)cudaErrorInvalidValue;
}

// The instantiation a launch of elem_size / first runs, on dev: r[0..4] =
// resident blocks per SM, registers per thread, local (spill) bytes per
// thread, threads per block, dynamic shared memory bytes.
extern "C" int astaroth_substep_info(int elem_size, int first, int dev, int* r) {
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  if (elem_size == 8)
    return first ? info<double>(astaroth_substep_kernel<double, true>, r)
                 : info<double>(astaroth_substep_kernel<double, false>, r);
  if (elem_size == 4)
    return first ? info<float>(astaroth_substep_kernel<float, true>, r)
                 : info<float>(astaroth_substep_kernel<float, false>, r);
  return (int)cudaErrorInvalidValue;
}

// The same for the positions form's instantiation.
extern "C" int astaroth_substep_positions_info(int elem_size, int first, int dev, int* r) {
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  if (elem_size == 8)
    return first ? info<double>(astaroth_substep_positions_kernel<double, true>, r)
                 : info<double>(astaroth_substep_positions_kernel<double, false>, r);
  if (elem_size == 4)
    return first ? info<float>(astaroth_substep_positions_kernel<float, true>, r)
                 : info<float>(astaroth_substep_positions_kernel<float, false>, r);
  return (int)cudaErrorInvalidValue;
}
