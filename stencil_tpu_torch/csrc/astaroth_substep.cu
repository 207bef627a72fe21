// One Williamson RK3 stage of the 8-field Astaroth MHD system, fp64 or fp32.
//
// Replaces: stencil_tpu/ops/pallas_astaroth.py make_pallas_substep (the TPU
// kernel that slides a VMEM window of field planes down each y strip, with
// DMA semaphores and shift/ring window disciplines; fp32 only). Its two
// variants compute one function; this kernel serves both, in fp64 (the
// reference workload's type) and fp32. Python wrapper and plain PyTorch
// version: stencil_tpu_torch/ops/astaroth_substep.py (substep,
// substep_plain), whose math is stencil_tpu_torch/astaroth/{fd,equations}.py.
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
// touches device memory. One pass over the fields per stage; each thread
// owns one cell and carries everything in registers.
//
// What bounds it on an H100: at 256^3, bytes and operations are of the
// same order. Bytes, counted once per compute cell: stage 0 reads 8 fields
// and writes 8 (16 values), stages 1-2 also read out (24 values).
// Operations, counted from the code below (adds, subtracts, multiplies,
// negations and divides; each of the 5 exp counted as one): 669 for the 21
// first, 24 second and 12 cross derivatives (9, 12 and 16 each), 256 for
// the right-hand sides, 24 for the stage-0 update and 48 for the others, so
// 949 per cell at stage 0 and 973 at stages 1-2 (ops/astaroth_substep.py
// FLOPS_PER_CELL). fp64 peak outside the tensor cores is 34 TFLOP/s, fp32
// 67 (H100 SXM data sheet).
//
// Design (a simple one first): one thread per output cell, x on
// neighbouring threads; 32x8-cell blocks march over a z chunk.
// Occupancy is set by registers: one block per SM in fp64, two in fp32. Neighbour
// reads go through the read-only path (__ldg) and L1/L2; no shared memory
// (a 7-plane window of a 38x14 tile for all 8 fields is 238 KB in fp64,
// above the 227 KB a block may use). The evaluation order keeps few values
// live: the magnetic terms first (B, lap a, j), then the induction rates
// are written and lap a dies; then continuity, momentum and entropy.
//
// Floating point: every expression follows fd.py's and equations.py's
// operand order term by term, so the kernel equals the plain version run by
// PyTorch on the card. Two rewrites mirror PyTorch's CUDA arithmetic: a
// divide by a Python scalar (x / mu0, x / cp_sound, x / 3.0) is a multiply
// by that scalar's reciprocal rounded to T; and `1.0 / t` is reciprocal(t).
// Python-side constant products (eta * mu0, gamma * (1 / cp), gamma - 1,
// alpha / beta_prev) are formed in double on the host, then rounded to T,
// as Python does. One rewrite is ours: fd.py starts every pencil sum from
// the literal 0.0, which changes at most the sign of an exact zero; the
// kernel starts from the first term. Built with -fmad=false, no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 8;
constexpr int BX = 32;
constexpr int BY = 8;
// Resident 256-thread blocks per SM asked of ptxas: 2 in fp32 (128
// registers, a few bytes spilled; twice the warps of one block hide more
// of the neighbour loads' latency), 1 in fp64 (255 registers; held to 128
// it spills heavily).
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 4 ? 2 : 1; }
// blocks wanted in flight: the device's SMs x the 256-thread blocks an SM
// holds x WAVES waves
constexpr int WAVES = 4;

enum Field { LNRHO = 0, UUX, UUY, UUZ, AX, AY, AZ, SS };

template <typename T>
struct In {
  const T* p[NF];
};

template <typename T>
struct Out {
  T* p[NF];
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

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T ld(const T* __restrict__ f, int o) {
  return __ldg(f + o);
}

// fd._first: sum_i c_i * (f[+i] - f[-i]), then * inv_ds
template <typename T>
__device__ __forceinline__ T der1(const T* __restrict__ f, int s, T inv) {
  T r = T(3.0 / 4.0) * (ld(f, s) - ld(f, -s));
  r = r + T(-3.0 / 20.0) * (ld(f, 2 * s) - ld(f, -2 * s));
  r = r + T(1.0 / 60.0) * (ld(f, 3 * s) - ld(f, -3 * s));
  return r * inv;
}

// fd._second: c_0 * f + sum_i c_i * (f[+i] + f[-i]), then * inv_ds * inv_ds
template <typename T>
__device__ __forceinline__ T der2(const T* __restrict__ f, int s, T inv) {
  T r = T(-49.0 / 18.0) * ld(f, 0);
  r = r + T(3.0 / 2.0) * (ld(f, s) + ld(f, -s));
  r = r + T(-3.0 / 20.0) * (ld(f, 2 * s) + ld(f, -2 * s));
  r = r + T(1.0 / 90.0) * (ld(f, 3 * s) + ld(f, -3 * s));
  return r * inv * inv;
}

// fd._cross: sum_i c_i * (f[a*i] + f[-a*i] - f[b*i] - f[-b*i]), then
// * inv_a * inv_b; a and b are the offsets of shift_a(1) and shift_b(1)
template <typename T>
__device__ __forceinline__ T cross(const T* __restrict__ f, int a, int b, T ia, T ib) {
  T r = T(270.0 / 720.0) * (ld(f, a) + ld(f, -a) - ld(f, b) - ld(f, -b));
  r = r + T(-27.0 / 720.0) * (ld(f, 2 * a) + ld(f, -2 * a) - ld(f, 2 * b) - ld(f, -2 * b));
  r = r + T(2.0 / 720.0) * (ld(f, 3 * a) + ld(f, -3 * a) - ld(f, 3 * b) - ld(f, -3 * b));
  return r * ia * ib;
}

// integrate.rk3_integrate
template <typename T, bool FIRST>
__device__ __forceinline__ void rk3(T* o, const T* __restrict__ cur, T rate,
                                    const Coefs<T>& k) {
  const T cv = ld(cur, 0);
  if (FIRST)
    *o = cv + k.beta * rate * k.dt;
  else
    *o = cv + k.beta * (k.a_pb * (cv - *o) + rate * k.dt);
}

template <typename T, bool FIRST>
__global__ void __launch_bounds__(BX * BY, min_blocks<T>())
astaroth_substep_kernel(In<T> in, Out<T> out, Coefs<T> k, int sz, int sy, int zo,
                        int yo, int xo, int nz, int ny, int nx, int zchunk) {
  const int tx = blockIdx.x * BX + threadIdx.x;
  const int ty = blockIdx.y * BY + threadIdx.y;
  const int z0 = blockIdx.z * zchunk;
  const int z1 = min(nz, z0 + zchunk);
  if (tx >= nx || ty >= ny) return;
  // diagonal pencil offsets: derxy (0,i,i) / (0,-i,i), derxz (i,0,i) /
  // (-i,0,i), deryz (i,i,0) / (-i,i,0)
  const int xy_a = sy + 1, xy_b = 1 - sy;
  const int xz_a = sz + 1, xz_b = 1 - sz;
  const int yz_a = sz + sy, yz_b = sy - sz;
  const T idx = k.idx, idy = k.idy, idz = k.idz;

  for (int z = z0; z < z1; ++z) {
    const long long c =
        (long long)(zo + z) * sz + (long long)(yo + ty) * sy + (xo + tx);
    const T* __restrict__ lr = in.p[LNRHO] + c;
    const T* __restrict__ ux = in.p[UUX] + c;
    const T* __restrict__ uy = in.p[UUY] + c;
    const T* __restrict__ uz = in.p[UUZ] + c;
    const T* __restrict__ ax = in.p[AX] + c;
    const T* __restrict__ ay = in.p[AY] + c;
    const T* __restrict__ az = in.p[AZ] + c;
    const T* __restrict__ ss = in.p[SS] + c;

    // -- magnetic terms: B = curl(a), lap(a), j = (grad(div a) - lap a) / mu0
    const T B0 = der1(az, sy, idy) - der1(ay, sz, idz);
    const T B1 = der1(ax, sz, idz) - der1(az, 1, idx);
    const T B2 = der1(ay, 1, idx) - der1(ax, sy, idy);
    const T ax_xx = der2(ax, 1, idx), ay_yy = der2(ay, sy, idy), az_zz = der2(az, sz, idz);
    const T lap_a0 = ax_xx + der2(ax, sy, idy) + der2(ax, sz, idz);
    const T lap_a1 = der2(ay, 1, idx) + ay_yy + der2(ay, sz, idz);
    const T lap_a2 = der2(az, 1, idx) + der2(az, sy, idy) + az_zz;
    const T j0 = (ax_xx + cross(ay, xy_a, xy_b, idx, idy) + cross(az, xz_a, xz_b, idx, idz)
                  - lap_a0) * k.rcp_mu0;
    const T j1 = (cross(ax, xy_a, xy_b, idx, idy) + ay_yy + cross(az, yz_a, yz_b, idy, idz)
                  - lap_a1) * k.rcp_mu0;
    const T j2 = (cross(ax, xz_a, xz_b, idx, idz) + cross(ay, yz_a, yz_b, idy, idz) + az_zz
                  - lap_a2) * k.rcp_mu0;

    // -- induction: u x B + eta * lap(a)
    const T u0 = ld(ux, 0), u1 = ld(uy, 0), u2 = ld(uz, 0);
    rk3<T, FIRST>(out.p[AX] + c, ax, (u1 * B2 - u2 * B1) + k.eta * lap_a0, k);
    rk3<T, FIRST>(out.p[AY] + c, ay, (u2 * B0 - u0 * B2) + k.eta * lap_a1, k);
    rk3<T, FIRST>(out.p[AZ] + c, az, (u0 * B1 - u1 * B0) + k.eta * lap_a2, k);

    // -- continuity: -u . grad(lnrho) - div u
    const T ux_x = der1(ux, 1, idx), ux_y = der1(ux, sy, idy), ux_z = der1(ux, sz, idz);
    const T uy_x = der1(uy, 1, idx), uy_y = der1(uy, sy, idy), uy_z = der1(uy, sz, idz);
    const T uz_x = der1(uz, 1, idx), uz_y = der1(uz, sy, idy), uz_z = der1(uz, sz, idz);
    const T l = ld(lr, 0);
    const T l_x = der1(lr, 1, idx), l_y = der1(lr, sy, idy), l_z = der1(lr, sz, idz);
    const T div_u = ux_x + uy_y + uz_z;
    rk3<T, FIRST>(out.p[LNRHO] + c, lr, -(u0 * l_x + u1 * l_y + u2 * l_z) - div_u, k);

    // -- momentum
    const T sxx = T(2.0 / 3.0) * ux_x - T(1.0 / 3.0) * (uy_y + uz_z);
    const T sxy = T(0.5) * (ux_y + uy_x);
    const T sxz = T(0.5) * (ux_z + uz_x);
    const T syy = T(2.0 / 3.0) * uy_y - T(1.0 / 3.0) * (ux_x + uz_z);
    const T syz = T(0.5) * (uy_z + uz_y);
    const T szz = T(2.0 / 3.0) * uz_z - T(1.0 / 3.0) * (ux_x + uy_y);
    const T s = ld(ss, 0);
    const T s_x = der1(ss, 1, idx), s_y = der1(ss, sy, idy), s_z = der1(ss, sz, idz);
    const T cs2 = k.cs2_sound * ex(k.gamma * s * k.rcp_cp + k.gamma_m1 * (l - k.lnrho0));
    const T inv_rho = ex(-l);
    {
      const T ux_xx = der2(ux, 1, idx), uy_yy = der2(uy, sy, idy), uz_zz = der2(uz, sz, idz);
      const T lap_u0 = ux_xx + der2(ux, sy, idy) + der2(ux, sz, idz);
      const T lap_u1 = der2(uy, 1, idx) + uy_yy + der2(uy, sz, idz);
      const T lap_u2 = der2(uz, 1, idx) + der2(uz, sy, idy) + uz_zz;
      const T god_u0 = ux_xx + cross(uy, xy_a, xy_b, idx, idy) + cross(uz, xz_a, xz_b, idx, idz);
      const T god_u1 = cross(ux, xy_a, xy_b, idx, idy) + uy_yy + cross(uz, yz_a, yz_b, idy, idz);
      const T god_u2 = cross(ux, xz_a, xz_b, idx, idz) + cross(uy, yz_a, yz_b, idy, idz) + uz_zz;
      // per component: -adv - pressure + inv_rho * (j x B) + visc + zeta * god_u
      const T adv0 = ux_x * u0 + ux_y * u1 + ux_z * u2;
      const T adv1 = uy_x * u0 + uy_y * u1 + uy_z * u2;
      const T adv2 = uz_x * u0 + uz_y * u1 + uz_z * u2;
      const T sg0 = sxx * l_x + sxy * l_y + sxz * l_z;
      const T sg1 = sxy * l_x + syy * l_y + syz * l_z;
      const T sg2 = sxz * l_x + syz * l_y + szz * l_z;
      const T p0 = cs2 * (s_x * k.rcp_cp + l_x);
      const T p1 = cs2 * (s_y * k.rcp_cp + l_y);
      const T p2 = cs2 * (s_z * k.rcp_cp + l_z);
      const T v0 = k.nu_visc * (lap_u0 + god_u0 * k.rcp_3 + T(2.0) * sg0);
      const T v1 = k.nu_visc * (lap_u1 + god_u1 * k.rcp_3 + T(2.0) * sg1);
      const T v2 = k.nu_visc * (lap_u2 + god_u2 * k.rcp_3 + T(2.0) * sg2);
      rk3<T, FIRST>(out.p[UUX] + c, ux,
                    -adv0 - p0 + inv_rho * (j1 * B2 - j2 * B1) + v0 + k.zeta * god_u0, k);
      rk3<T, FIRST>(out.p[UUY] + c, uy,
                    -adv1 - p1 + inv_rho * (j2 * B0 - j0 * B2) + v1 + k.zeta * god_u1, k);
      rk3<T, FIRST>(out.p[UUZ] + c, uz,
                    -adv2 - p2 + inv_rho * (j0 * B1 - j1 * B0) + v2 + k.zeta * god_u2, k);
    }

    // -- entropy: -u . grad(ss) + inv_pT * rhs + heat_conduction
    const T rho = ex(l);
    const T lnT = k.lnT0 + k.gamma * s * k.rcp_cp + k.gamma_m1 * (l - k.lnrho0);
    const T inv_pT = T(1.0) / (rho * ex(lnT));
    const T contr = sxx * sxx + syy * syy + szz * szz
                    + T(2.0) * (sxy * sxy + sxz * sxz + syz * syz);
    const T rhs = k.eta_mu0 * (j0 * j0 + j1 * j1 + j2 * j2)
                  + T(2.0) * rho * k.nu_visc * contr + k.zeta * rho * div_u * div_u;
    const T s_lap = der2(ss, 1, idx) + der2(ss, sy, idy) + der2(ss, sz, idz);
    const T l_lap = der2(lr, 1, idx) + der2(lr, sy, idy) + der2(lr, sz, idz);
    const T first = k.gamma_inv_cp * s_lap + k.gamma_m1 * l_lap;
    const T sec0 = k.gamma_inv_cp * s_x + k.gamma_m1 * l_x;
    const T sec1 = k.gamma_inv_cp * s_y + k.gamma_m1 * l_y;
    const T sec2 = k.gamma_inv_cp * s_z + k.gamma_m1 * l_z;
    const T thi0 = k.gamma * (k.inv_cp * s_x + l_x) + (-l_x);
    const T thi1 = k.gamma * (k.inv_cp * s_y + l_y) + (-l_y);
    const T thi2 = k.gamma * (k.inv_cp * s_z + l_z) + (-l_z);
    const T chi = k.chi * ex(-l) * k.rcp_cp;
    const T heat = k.cp_sound * chi * (first + (sec0 * thi0 + sec1 * thi1 + sec2 * thi2));
    rk3<T, FIRST>(out.p[SS] + c, ss,
                  -(u0 * s_x + u1 * s_y + u2 * s_z) + inv_pT * rhs + heat, k);
  }
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

template <typename T>
int launch(void* const* curr, void* const* out, const double* prm, int first,
           long long sz, long long sy, int zo, int yo, int xo, int nz, int ny,
           int nx, long long target_blocks, cudaStream_t st) {
  In<T> in;
  Out<T> o;
  for (int f = 0; f < NF; ++f) {
    in.p[f] = (const T*)curr[f];
    o.p[f] = (T*)out[f];
  }
  const Coefs<T> k = make_coefs<T>(prm);
  const int gx = (nx + BX - 1) / BX;
  const int gy = (ny + BY - 1) / BY;
  long long want = (target_blocks + (long long)gx * gy - 1) / ((long long)gx * gy);
  const int nzc = (int)(want < 1 ? 1 : (want > nz ? nz : want));
  const int zchunk = (nz + nzc - 1) / nzc;
  const dim3 grid(gx, gy, (nz + zchunk - 1) / zchunk);
  const dim3 block(BX, BY);
  if (first)
    astaroth_substep_kernel<T, true><<<grid, block, 0, st>>>(
        in, o, k, (int)sz, (int)sy, zo, yo, xo, nz, ny, nx, zchunk);
  else
    astaroth_substep_kernel<T, false><<<grid, block, 0, st>>>(
        in, o, k, (int)sz, (int)sy, zo, yo, xo, nz, ny, nx, zchunk);
  return (int)cudaGetLastError();
}

}  // namespace

// curr / out: host arrays of 8 device pointers (FIELDS order: lnrho, uux,
// uuy, uuz, ax, ay, az, entropy) to contiguous padded (pz, py, px) blocks.
// sz / sy: plane and row strides; (zo, yo, xo) / (nz, ny, nx): compute
// offset and extent, with at least 3 halo cells on every side. prm: the 16
// doubles listed in make_coefs. first: 1 for RK3 stage 0 (out not read).
// dev: the device the fields are on.
extern "C" int astaroth_substep_launch(void* const* curr, void* const* out,
                                       int elem_size, const double* prm,
                                       int nprm, int first, long long sz,
                                       long long sy, int zo, int yo, int xo,
                                       int nz, int ny, int nx, int dev, void* stream) {
  if (nprm != 16 || nz < 1 || ny < 1 || nx < 1 || zo < 3 || yo < 3 || xo < 3 ||
      3 * sz > (1LL << 30) || sz > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  int sms = 0, threads_per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (e != cudaSuccess) return (int)e;
  const long long target = (long long)sms * (threads_per_sm / (BX * BY)) * WAVES;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_size == 8)
    return launch<double>(curr, out, prm, first, sz, sy, zo, yo, xo, nz, ny, nx, target, st);
  if (elem_size == 4)
    return launch<float>(curr, out, prm, first, sz, sy, zo, yo, xo, nz, ny, nx, target, st);
  return (int)cudaErrorInvalidValue;
}
