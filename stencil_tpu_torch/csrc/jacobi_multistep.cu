// k Jacobi steps in one launch over the padded fp32 blocks of a uniform
// partition, every block resident on one device.
//
// Replaces: stencil_tpu/ops/pallas_stencil.py make_pallas_jacobi_multistep
// (full-plane z wavefront) and _make_multistep_row_tiled (the same wavefront
// over y strips), in their single-block forms and in their deep-halo forms
// (the `use_org` pallas_call sites). Python wrapper and plain PyTorch
// version: stencil_tpu_torch/ops/stencil_kernels.py (multistep,
// multistep_plain).
//
// What bounds it on an H100: bytes, as for the one-step sweep, but the point
// of the kernel is that the floor is ONE read of curr plus ONE write of out
// per k steps: the intermediate stages never go to device memory.
//
// Design (ghost-zone temporal blocking with a register z-march): each block
// of 1024 threads owns a 32 x 32 output tile of one resident block and
// marches z with k + 1 stages. Stage 0 loads the input plane grown by k cells
// on each side; stage s computes the plane grown by k - s cells from stage
// s - 1. Every thread owns the same cells of the grown plane in every stage
// and every step, so the z neighbours of a cell (planes v-1 and v+1 of stage
// s-1) are the thread's own earlier results, kept in a three-plane register
// window per stage; only the x and y neighbours come from shared memory,
// where each stage keeps two planes (plane v is read while plane v+1 is
// written). At step j stage s works on plane v = Z0 - k + j - s: stage s - 1
// finishes plane v + 1 earlier in the same step, on the same thread, and the
// x/y neighbours of plane v were written in the previous step, so a step ends
// with a single barrier. The next input plane is loaded into registers while
// the stages of this step run. Each block warms up 2k steps before its first
// output plane; z may be split into chunks, each with its own warm-up, to
// fill the card on small domains. Neighbouring tiles recompute their
// overlapping ghost zones instead of sharing them; that is the price of
// keeping every stage on chip. The register windows bound k (KMAX):
// 3 * k * (cells per thread) floats.
//
// Axes. An axis with one block of the partition is periodic onto itself:
// stage 0 takes the grown cells by index wrap within the compute region. An
// axis with several blocks is the deep-halo form: the caller has exchanged
// halos of radius >= k, and stage 0 reads the grown cells straight from them
// (planes zo - k .. zo + nz + k - 1 on z). Grown cells farther out than k
// (the ragged edge of the last tile) are clamped into the halo; they only
// feed cells that no output depends on. Both modes mix freely, e.g. (1,1,2).
//
// Residents. grid.z covers every resident block times its z chunks; a block
// finds its resident's data at resident * bstride and its global origin at
// (block index) x (block size), the origin the TPU kernel gets by scalar
// prefetch. The kernel is instantiated twice per depth: MB = false for a
// single-block domain, where none of that exists and a thread keeps the
// registers of the one-block march (at k = 3 the register windows fill the
// 64 registers a 1024-thread block allows), and MB = true for a partition.
//
// The hot and cold spheres come from integer coordinates, exactly as in the
// TPU kernel: hot centre (gx/3, gy/2, gz/2), cold centre (2*gx/3, gy/2,
// gz/2), d2 < (gx/10 + 1)^2, hot wins over cold, at the cell's WRAPPED global
// coordinate ((origin + local) mod global size), so a grown cell in a halo is
// clamped exactly as on the block that owns it. On the standard spheres that
// equals the JAX package's sqrt-truncating sel array, so one launch equals k
// one-step sweeps bit for bit: every stage sums (x_lo + x_hi + y_lo + y_hi +
// z_lo + z_hi) left to right and multiplies by 1/6 rounded to float32, as the
// sweep does. Offsets are 64-bit.
//
// Shared memory: 2 planes of (32 + 2k)^2 floats for each of stages 0..k-1.
// The Python depth planner (stencil_tpu_torch/ops/stencil_kernels.py,
// plan_multistep_depth) mirrors jacobi_multistep_smem_bytes below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi_column.cuh"

namespace {

constexpr int TILE = 32;  // output tile edge, x and y
constexpr int NT = 1024;  // threads per block
constexpr int KMAX = 6;   // deepest k instantiated (register windows grow with k)
constexpr float SIXTH = 1.0f / 6.0f;
constexpr float HOT = 1.0f;
constexpr float COLD = 0.0f;

struct Params {
  const float* curr;
  float* out;
  long long sz, sy;            // strides (elements) of z and y; x is unit
  long long bstride;           // elements per padded resident block
  int zo, yo, xo;              // compute-region origin in the padded block
  int nz, ny, nx;              // compute-region extent of one block
  int bz, by, bx;              // blocks of the partition along z, y, x
  int gz, gy, gx;              // global size (the periodic box of the spheres)
  int zchunk, nzc;             // output planes per z chunk, chunks per block
  int hx, hy, hz, dhc;         // hot centre; the cold one is dhc further in x
  int band;                    // only |z - hz| <= band holds sphere cells
  int thresh;                  // (gx/10 + 1)^2
};

__device__ __forceinline__ int wrapi(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

template <int K, bool MB>
__global__ void __launch_bounds__(NT) jacobi_multistep_kernel(Params p) {
  constexpr int WG = TILE + 2 * K;  // edge of the grown stage-0 plane
  constexpr int G = WG * WG;
  constexpr int M = (G + NT - 1) / NT;  // cells per thread
  const int res = MB ? blockIdx.z / p.nzc : 0;
  const int rx = res % p.bx, ry = (res / p.bx) % p.by, rz = res / (p.bx * p.by);
  const int oz = MB ? rz * p.nz : 0, oy = MB ? ry * p.ny : 0, ox = MB ? rx * p.nx : 0;
  // the resident's offset rides in off0, so curr and out stay kernel
  // parameters
  const long long base = MB ? res * p.bstride : 0;
  const int X0 = blockIdx.x * TILE;
  const int Y0 = blockIdx.y * TILE;
  const int Z0 = (blockIdx.z - res * p.nzc) * p.zchunk;
  const int Z1 = min(p.nz, Z0 + p.zchunk);
  const int nsteps = (Z1 - Z0) + 2 * K;
  const int t = threadIdx.x;
  extern __shared__ float smem[];  // [stage 0..K-1][plane & 1][G]

  // This thread's cells c = t + m*NT of the grown plane: its ring (the
  // distance in cells from the grown plane's edge: stage s computes the cell
  // iff ring >= s; a cell of the last tile outside the block stops at
  // stage k - 1, so stage k writes only the block's cells), its offset in
  // the stack (the stage-0 input, and the output for the tile's cells), and
  // its x offset / squared y distance from the hot centre. Few registers per
  // cell: at k = 3 the register windows fill most of the 64 a 1024-thread
  // block allows.
  int ring[M];
  long long off0[M];
  int dxh[M], dy2[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c = t + m * NT;
    const int cy = c / WG, cx = c - (c / WG) * WG;
    const int ly = Y0 + cy - K, lx = X0 + cx - K;  // block-local
    ring[m] = c < G ? min(min(cy, WG - 1 - cy), min(cx, WG - 1 - cx)) : -1;
    if (ring[m] >= K && (lx >= p.nx || ly >= p.ny)) ring[m] = K - 1;
    const int ay = MB && p.by > 1 ? clampi(ly, -K, p.ny + K - 1) : wrapi(ly, p.ny);
    const int ax = MB && p.bx > 1 ? clampi(lx, -K, p.nx + K - 1) : wrapi(lx, p.nx);
    off0[m] = c < G ? base + (long long)(p.yo + ay) * p.sy + p.xo + ax : -1;
    const int gy = wrapi(oy + ly, p.gy), gx = wrapi(ox + lx, p.gx);
    dxh[m] = gx - p.hx;
    dy2[m] = (gy - p.hy) * (gy - p.hy);
  }
  // win[s][m]: stage s at this cell for its last three planes, oldest first
  float win[K][M][3];
  float pf[M];
  auto prefetch = [&](int j) {
    const int u = Z0 - K + j;
    const int zu = MB && p.bz > 1 ? u : (u < 0 ? u + p.nz : (u >= p.nz ? u - p.nz : u));
    const long long pz = (long long)(p.zo + zu) * p.sz;
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (off0[m] >= 0) pf[m] = p.curr[pz + off0[m]];
  };
  prefetch(0);

  for (int j = 0; j < nsteps; ++j) {
    // stage 0: the input plane u = Z0 - K + j
    {
      float* dst = smem + ((Z0 - K + j) & 1) * G;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (off0[m] >= 0) {
          win[0][m][0] = win[0][m][1];
          win[0][m][1] = win[0][m][2];
          win[0][m][2] = pf[m];
          dst[t + m * NT] = pf[m];
        }
      }
      if (j + 1 < nsteps) prefetch(j + 1);
    }
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      if (j >= 2 * s) {
        const int v = Z0 - K + j - s;
        const float* src = smem + (2 * (s - 1) + (v & 1)) * G;  // stage s-1, plane v
        float* dst = smem + (2 * s + (v & 1)) * G;                // stage s, plane v
        // the plane's wrapped global z: v lies within k planes of the
        // block and k <= nz, so one correction wraps it
        const int zg = oz + v;
        const int dz = (zg < 0 ? zg + p.gz : (zg >= p.gz ? zg - p.gz : zg)) - p.hz;
        const bool in_band = dz <= p.band && -dz <= p.band;
        const long long pz = (long long)(p.zo + v) * p.sz;       // used when s == K
#pragma unroll
        for (int m = 0; m < M; ++m) {
          // stage s covers [s, WG - s) of the grown plane in y and x
          if (ring[m] >= s) {
            const int c = t + m * NT;
            float sum = src[c - 1] + src[c + 1];
            sum = sum + src[c - WG];
            sum = sum + src[c + WG];
            sum = sum + win[s - 1][m][0];
            sum = sum + win[s - 1][m][2];
            float val = sum * SIXTH;
            if (in_band) {
              const int yz = dy2[m] + dz * dz;
              const int dxc = dxh[m] - p.dhc;
              val = dxh[m] * dxh[m] + yz < p.thresh ? HOT
                                                     : (dxc * dxc + yz < p.thresh ? COLD : val);
            }
            if (s < K) {
              win[s][m][0] = win[s][m][1];
              win[s][m][1] = win[s][m][2];
              win[s][m][2] = val;
              dst[c] = val;
            } else {
              // an output cell lies inside the block, where off0 is unwrapped
              p.out[pz + off0[m]] = val;
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

long long smem_bytes(int k) {
  return 2LL * k * (TILE + 2 * k) * (TILE + 2 * k) * (long long)sizeof(float);
}

template <int K, bool MB>
int launch_mb(const Params& p, dim3 grid, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(jacobi_multistep_kernel<K, MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(K));
  if (err != cudaSuccess) return (int)err;
  jacobi_multistep_kernel<K, MB><<<grid, NT, smem_bytes(K), st>>>(p);
  return (int)cudaGetLastError();
}

template <int K>
int launch(const Params& p, dim3 grid, cudaStream_t st) {
  return p.bz * p.by * p.bx > 1 ? launch_mb<K, true>(p, grid, st)
                                : launch_mb<K, false>(p, grid, st);
}

// Occupancy of the multi-block instantiation (the single-block one holds
// as many blocks: the same shared memory, at most the same registers).
template <int K>
int occupancy(int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(jacobi_multistep_kernel<K, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(K));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, jacobi_multistep_kernel<K, true>, NT, smem_bytes(K));
}

}  // namespace

extern "C" long long jacobi_multistep_smem_bytes(int k) { return smem_bytes(k); }

// curr / out: distinct stacks of bz * by * bx padded fp32 blocks (resident
// r = (iz * by + iy) * bx + ix at r * bstride), strides (sz, sy, 1). Each
// block's compute region is [zo, zo+nz) x [yo, yo+ny) x [xo, xo+nx); an axis
// with several blocks needs halos of radius >= k on both sides, already
// exchanged. (gx, gy, gz) is the global size the spheres are placed in;
// zchunks is the number of z chunks per block; dev the tensors' device.
extern "C" int jacobi_multistep_launch(const void* curr, void* out, long long sz,
                                       long long sy, long long bstride, int zo, int yo,
                                       int xo, int nz, int ny, int nx, int bz, int by,
                                       int bx, int k, int gx, int gy, int gz,
                                       int zchunks, int dev, void* stream) {
  if (k < 1 || k > KMAX || k > nz || nz < 1 || ny < 1 || nx < 1 || zchunks < 1 ||
      bz < 1 || by < 1 || bx < 1 || (long long)bz * by * bx * zchunks > 65535)
    return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  Params p;
  p.curr = (const float*)curr;
  p.out = (float*)out;
  p.sz = sz;
  p.sy = sy;
  p.bstride = bstride;
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
  const dim3 grid((nx + TILE - 1) / TILE, (ny + TILE - 1) / TILE, bz * by * bx * p.nzc);
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch<1>(p, grid, st);
    case 2: return launch<2>(p, grid, st);
    case 3: return launch<3>(p, grid, st);
    case 4: return launch<4>(p, grid, st);
    case 5: return launch<5>(p, grid, st);
    default: return launch<6>(p, grid, st);
  }
}

// Resident blocks per SM at depth k on device dev.
extern "C" int jacobi_multistep_blocks_per_sm(int k, int dev, int* blocks) {
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  switch (k) {
    case 1: return occupancy<1>(blocks);
    case 2: return occupancy<2>(blocks);
    case 3: return occupancy<3>(blocks);
    case 4: return occupancy<4>(blocks);
    case 5: return occupancy<5>(blocks);
    case 6: return occupancy<6>(blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}
