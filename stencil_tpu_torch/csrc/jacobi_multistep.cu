// k Jacobi steps in one launch over a single-block periodic fp32 domain.
//
// Replaces: stencil_tpu/ops/pallas_stencil.py make_pallas_jacobi_multistep
// (full-plane z wavefront) and _make_multistep_row_tiled (the same wavefront
// over y strips), in their single-block forms. Python wrapper and plain
// PyTorch version: stencil_tpu_torch/ops/stencil_kernels.py
// (multistep, multistep_plain).
//
// What bounds it on an H100: bytes, as for the one-step sweep, but the point
// of the kernel is that the floor is ONE read of curr plus ONE write of out
// per k steps: the intermediate stages never go to device memory.
//
// Design (ghost-zone temporal blocking with a register z-march): each block
// of 1024 threads owns a 32 x 32 output tile and marches z with k + 1
// stages. Stage 0 loads the input plane grown by k cells on each side
// (periodic wrap in x and y by index arithmetic); stage s computes the plane
// grown by k - s cells from stage s - 1. Every thread owns the same cells of
// the grown plane in every stage and every step, so the z neighbours of a
// cell (planes v-1 and v+1 of stage s-1) are the thread's own earlier results,
// kept in a three-plane register window per stage; only the x and y
// neighbours come from shared memory, where each stage keeps two planes
// (plane v is read while plane v+1 is written). At step j stage s works on
// plane v = Z0 - k + j - s: stage s - 1 finishes plane v + 1 earlier in the
// same step, on the same thread, and the x/y neighbours of plane v were
// written in the previous step, so a step ends with a single barrier. The
// next input plane is loaded into registers while the stages of this step
// run. Each block warms up 2k steps before its first output plane; z may be
// split into chunks, each with its own warm-up, to fill the card on small
// domains. Neighbouring tiles recompute their overlapping ghost zones
// instead of sharing them; that is the price of keeping every stage on chip.
// The register windows bound k (KMAX): 3 * k * (cells per thread) floats.
//
// The hot and cold spheres come from integer coordinates, exactly as in the
// TPU kernel: hot centre (gx/3, gy/2, gz/2), cold centre (2*gx/3, gy/2, gz/2),
// d2 < (gx/10 + 1)^2, hot wins over cold, z wraps periodically. On the
// standard spheres that equals the JAX package's sqrt-truncating sel array,
// so one launch equals k one-step sweeps bit for bit: every stage
// sums (x_lo + x_hi + y_lo + y_hi + z_lo + z_hi) left to right and multiplies
// by 1/6 rounded to float32, as the sweep does. Offsets are 64-bit.
//
// Shared memory: 2 planes of (32 + 2k)^2 floats for each of stages 0..k-1.
// The Python depth planner (stencil_tpu_torch/ops/stencil_kernels.py,
// plan_multistep_depth) mirrors jacobi_multistep_smem_bytes below.

#include <cuda_runtime.h>
#include <stdint.h>

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
  int zo, yo, xo;              // compute-region origin in the padded block
  int nz, ny, nx;              // compute-region extent (= the periodic box)
  int zchunk;                  // output planes per block along z
  int hx, hy, hz, cx;          // sphere centres (cold shares hy, hz)
  int band;                    // only |z - hz| <= band holds sphere cells
  int thresh;                  // (gx/10 + 1)^2
};

__device__ __forceinline__ int wrapi(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

template <int K>
__global__ void __launch_bounds__(NT) jacobi_multistep_kernel(Params p) {
  constexpr int WG = TILE + 2 * K;  // edge of the grown stage-0 plane
  constexpr int G = WG * WG;
  constexpr int M = (G + NT - 1) / NT;  // cells per thread
  const int X0 = blockIdx.x * TILE;
  const int Y0 = blockIdx.y * TILE;
  const int Z0 = blockIdx.z * p.zchunk;
  const int Z1 = min(p.nz, Z0 + p.zchunk);
  const int nsteps = (Z1 - Z0) + 2 * K;
  const int t = threadIdx.x;
  extern __shared__ float smem[];  // [stage 0..K-1][plane & 1][G]

  // This thread's cells c = t + m*NT of the grown plane: position, input
  // offset in curr, and the squared x / y distances to the sphere centres.
  int cy[M], cx[M];
  long long off0[M];
  int dxh2[M], dxc2[M], dy2[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c = t + m * NT;
    cy[m] = c < G ? c / WG : -1;
    cx[m] = c < G ? c - (c / WG) * WG : -1;
    const int gy = wrapi(Y0 + cy[m] - K, p.ny), gx = wrapi(X0 + cx[m] - K, p.nx);
    off0[m] = c < G ? (long long)(p.yo + gy) * p.sy + p.xo + gx : -1;
    dxh2[m] = (gx - p.hx) * (gx - p.hx);
    dxc2[m] = (gx - p.cx) * (gx - p.cx);
    dy2[m] = (gy - p.hy) * (gy - p.hy);
  }
  // win[s][m]: stage s at this cell for its last three planes, oldest first
  float win[K][M][3];
  float pf[M];
  auto prefetch = [&](int j) {
    const int u = Z0 - K + j;
    const int zu = u < 0 ? u + p.nz : (u >= p.nz ? u - p.nz : u);
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
        const int zv = v < 0 ? v + p.nz : (v >= p.nz ? v - p.nz : v);
        const int dz = zv - p.hz;
        const bool in_band = dz <= p.band && -dz <= p.band;
        const long long pz = (long long)(p.zo + v) * p.sz;       // used when s == K
#pragma unroll
        for (int m = 0; m < M; ++m) {
          // stage s covers [s, WG - s) of the grown plane in y and x
          if (cy[m] >= s && cy[m] < WG - s && cx[m] >= s && cx[m] < WG - s) {
            const int c = t + m * NT;
            float sum = src[c - 1] + src[c + 1];
            sum = sum + src[c - WG];
            sum = sum + src[c + WG];
            sum = sum + win[s - 1][m][0];
            sum = sum + win[s - 1][m][2];
            float val = sum * SIXTH;
            if (in_band) {
              const int yz = dy2[m] + dz * dz;
              val = dxh2[m] + yz < p.thresh ? HOT : (dxc2[m] + yz < p.thresh ? COLD : val);
            }
            if (s < K) {
              win[s][m][0] = win[s][m][1];
              win[s][m][1] = win[s][m][2];
              win[s][m][2] = val;
              dst[c] = val;
            } else {
              const int gx = X0 + cx[m] - K, gy = Y0 + cy[m] - K;
              if (gx < p.nx && gy < p.ny)
                p.out[pz + (long long)(p.yo + gy) * p.sy + p.xo + gx] = val;
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

template <int K>
int launch(const Params& p, dim3 grid, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(jacobi_multistep_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(K));
  if (err != cudaSuccess) return (int)err;
  jacobi_multistep_kernel<K><<<grid, NT, smem_bytes(K), st>>>(p);
  return (int)cudaGetLastError();
}

template <int K>
int occupancy(int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(jacobi_multistep_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(K));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, jacobi_multistep_kernel<K>, NT, smem_bytes(K));
}

}  // namespace

extern "C" long long jacobi_multistep_smem_bytes(int k) { return smem_bytes(k); }

// curr / out: distinct padded fp32 blocks with strides (sz, sy, 1). The
// compute region [zo, zo+nz) x [yo, yo+ny) x [xo, xo+nx) is the periodic box;
// (gx, gy, gz) is the global size the spheres are placed in.
extern "C" int jacobi_multistep_launch(const void* curr, void* out, long long sz,
                                       long long sy, int zo, int yo, int xo,
                                       int nz, int ny, int nx, int k, int gx,
                                       int gy, int gz, int zchunks,
                                       void* stream) {
  if (k < 1 || k > KMAX || k > nz || nz < 1 || ny < 1 || nx < 1 || zchunks < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.curr = (const float*)curr;
  p.out = (float*)out;
  p.sz = sz;
  p.sy = sy;
  p.zo = zo;
  p.yo = yo;
  p.xo = xo;
  p.nz = nz;
  p.ny = ny;
  p.nx = nx;
  p.zchunk = (nz + zchunks - 1) / zchunks;
  p.hx = gx / 3;
  p.hy = gy / 2;
  p.hz = gz / 2;
  p.cx = gx * 2 / 3;
  p.band = gx / 10;
  p.thresh = (gx / 10 + 1) * (gx / 10 + 1);
  const dim3 grid((nx + TILE - 1) / TILE, (ny + TILE - 1) / TILE,
                  (nz + p.zchunk - 1) / p.zchunk);
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

// Resident blocks per SM at depth k.
extern "C" int jacobi_multistep_blocks_per_sm(int k, int* blocks) {
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
