// In-place periodic halo fill of one self-wrap axis, for up to 16 quantities.
//
// Replaces: stencil_tpu/ops/halo_fill.py make_self_fill (the TPU z, y and x
// fill kernels, which read-modify-write whole 8-row / 128-lane tiles because
// that is the TPU's store granularity; nothing here needs that). Python
// wrapper and plain PyTorch version: stencil_tpu_torch/ops/halo_fill.py
// (self_fill, self_fill_plain).
//
// What bounds it on an H100: bytes. It is a pure copy of (rm + rp) slabs per
// quantity, each element read once and written once; the floor is
// 2 * elem_size * (rm + rp) * (product of the other two padded extents) per
// quantity over the memory rate. At these sizes the launch itself is a large
// share of the time.
//
// Design: one launch fills both sides of one axis for every quantity of a
// same-element-size group (blockIdx.y picks the quantity; the pointers ride
// in the kernel's parameters). The copy spans the FULL padded extent of the
// other two axes, so calling it x, then y, then z composes edges and corners
// exactly as the JAX package's axis-composed exchange does: later axes copy
// the halos the earlier axes just filled. Lo and hi sides of one axis read
// and write disjoint cells whenever the block is at least as wide as the
// radius (the wrapper checks), so one launch may do both. The kernel copies
// bits (4- or 8-byte words), so fp32 and fp64 quantities both go through it.
// Offsets are 64-bit. The grid is capped at one wave of full-occupancy
// blocks on the tensors' device (its SM count times the 256-thread blocks an
// SM holds); each thread strides over the rest.
//
// Residents: the x and y fills act within each z plane, so a contiguous
// stack of c resident blocks (the TPU kernel's z_stack form, for a
// (cz, 1, 1) residency; the port's exchange stacks any residency) is filled
// by one launch over the stack viewed as one (c * pz, py, px) array. A z
// fill beside several residents takes each resident as one pointer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXQ = 16;
constexpr int THREADS = 256;

struct Ptrs {
  void* p[MAXQ];
};

// The copy box is (b0, b1, b2) over array dims (z, y, x), with the fill axis
// reduced to its rm + rp halo cells; AXIS names which box dim that is. The
// box is indexed with I (32-bit whenever it fits: a 64-bit divide costs
// several times a 32-bit one); array offsets are always 64-bit.
template <typename T, typename I, int AXIS>
__global__ void __launch_bounds__(THREADS)
self_fill_kernel(Ptrs ptrs, I b1, I b2, I total, long long s0, long long s1,
                 int o, int n, int rm) {
  T* a = (T*)ptrs.p[blockIdx.y];
  for (I i = (I)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (I)gridDim.x * THREADS) {
    const I t = i / b2;
    long long c[3] = {(long long)(t / b1), (long long)(t % b1), (long long)(i % b2)};
    const long long j = c[AXIS];
    const long long dst = j < rm ? o - rm + j : o + n + (j - rm);
    c[AXIS] = dst;
    const long long di = c[0] * s0 + c[1] * s1 + c[2];
    c[AXIS] = j < rm ? dst + n : dst - n;
    const long long si = c[0] * s0 + c[1] * s1 + c[2];
    a[di] = a[si];
  }
}

template <typename T, typename I>
void launch(const dim3& grid, cudaStream_t st, const Ptrs& p, const long long* b,
            long long s0, long long s1, int axis, int o, int n, int rm) {
  const I b1 = (I)b[1], b2 = (I)b[2], total = (I)(b[0] * b[1] * b[2]);
  if (axis == 0)
    self_fill_kernel<T, I, 0><<<grid, THREADS, 0, st>>>(p, b1, b2, total, s0, s1, o, n, rm);
  else if (axis == 1)
    self_fill_kernel<T, I, 1><<<grid, THREADS, 0, st>>>(p, b1, b2, total, s0, s1, o, n, rm);
  else
    self_fill_kernel<T, I, 2><<<grid, THREADS, 0, st>>>(p, b1, b2, total, s0, s1, o, n, rm);
}

template <typename T>
void launch_t(const dim3& grid, cudaStream_t st, const Ptrs& p, const long long* b,
              long long s0, long long s1, int axis, int o, int n, int rm) {
  if (b[0] * b[1] * b[2] + (long long)grid.x * THREADS < (1LL << 32))
    launch<T, uint32_t>(grid, st, p, b, s0, s1, axis, o, n, rm);
  else
    launch<T, unsigned long long>(grid, st, p, b, s0, s1, axis, o, n, rm);
}

}  // namespace

// ptrs: host array of nq device pointers to contiguous (pz, py, px) blocks.
// axis: 0 = z, 1 = y, 2 = x. o / n: compute offset and size along the axis;
// rm / rp: lo- and hi-side halo widths. dev: the device the blocks are on.
extern "C" int self_fill_launch(void* const* ptrs, int nq, int elem_size,
                                int pz, int py, int px, int axis, int o, int n,
                                int rm, int rp, int dev, void* stream) {
  if (nq < 1 || nq > MAXQ || axis < 0 || axis > 2 || rm < 0 || rp < 0 ||
      (elem_size != 4 && elem_size != 8))
    return (int)cudaErrorInvalidValue;
  if (rm + rp == 0) return 0;
  int sms = 0, threads_per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (e != cudaSuccess) return (int)e;
  const long long max_blocks = (long long)sms * (threads_per_sm / THREADS);
  Ptrs p;
  for (int q = 0; q < MAXQ; ++q) p.p[q] = q < nq ? ptrs[q] : nullptr;
  long long b[3] = {pz, py, px};
  b[axis] = rm + rp;
  const long long total = b[0] * b[1] * b[2];
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  const dim3 grid((unsigned)blocks, nq);
  const long long s0 = (long long)py * px;
  const long long s1 = px;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_size == 4)
    launch_t<uint32_t>(grid, st, p, b, s0, s1, axis, o, n, rm);
  else
    launch_t<uint64_t>(grid, st, p, b, s0, s1, axis, o, n, rm);
  return (int)cudaGetLastError();
}
