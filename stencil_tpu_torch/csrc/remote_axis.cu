// One axis phase of the remote-dma halo exchange over a mesh of block
// positions, for every position of one device and a same-dtype group of
// quantities, in one launch.
//
// Replaces: stencil_tpu/ops/remote_dma.py make_remote_axis_kernel (the TPU
// carrier kernel: neighbour barrier, stage both boundary slabs of a packed
// Q-quantity carrier into VMEM, remote-copy them into the ring neighbours'
// landing buffers, wait, unpack into the halos). Python wrapper and plain
// PyTorch version: stencil_tpu_torch/ops/remote_dma.py (remote_axis,
// remote_axis_plain).
//
// What it computes: along the phase axis, with compute offset o, block size
// n and halo widths rm / rp, each sender block's hi boundary slab
// [o + n - rm, o + n) is stored into its forward neighbour's lo halo
// [o - rm, o), and its lo slab [o, o + rp) into its backward neighbour's hi
// halo [o + n, o + n + rp). A slab spans the FULL padded extent of the other
// two axes, so running the phases x, then y, then z composes edges and
// corners as the axis-composed exchange does.
//
// What bounds it on an H100: bytes. Each slab cell is read once and written
// once: 2 * elem_size * (rm + rp) * (product of the other two padded
// extents) per block and quantity, over the memory rate.
//
// Design: the stores go straight into the destination block's halo through
// its pointer (the reference's zero-copy ColoQuantityKernel / same-GPU
// PeerAccessSender write): no landing buffer and no unpack. The TPU kernel
// needs VMEM staging only because a DMA cannot scatter. The wrapper passes a
// table in device memory of (source block, destination block) pointers, one
// row per (side, sender position, quantity): the first n_rm rows send the hi
// slab forward, the rest the lo slab backward. blockIdx.y picks the row;
// blockIdx.x and the threads stride over the slab's cells, x fastest, so a
// warp's loads and stores are consecutive words of a row. In the y and z
// phases a row is px words and a warp's accesses coalesce fully. In the x
// phase a slab row is only rm (or rp) words, one run per (z, y): a warp
// covers 32 / r rows and touches one 32-byte sector per row, the most the
// layout allows without staging. The kernel copies bits (4- or 8-byte
// words), so fp32 and fp64 share one body.
//
// Ordering: within one phase every read is of a compute-region row along
// the axis and every write is of a halo row along it; these are disjoint
// (the block is at least the radius wide), so rows may run in any order.
// Phase y reads the x halos that phase x wrote, so the phases must run in
// order: on one card they are launches on one stream. Positions on distinct
// GPUs will also need each phase to wait on its ring neighbours' previous
// phase (an event per neighbour), which is the TPU kernel's barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// ext: the padded block's extents over (z, y, x); a slab is ext with the
// phase axis narrowed to rm (the first n_rm rows, hi slabs) or rp (the
// rest, lo slabs); src_* / dst_*: the slab's start along the axis in the
// source and in the destination block.
struct Slab {
  int ext[3];
  int rm, rp;
  int src_rm, dst_rm, src_rp, dst_rp;
};

template <typename T, int AXIS>
__global__ void __launch_bounds__(THREADS)
remote_axis_kernel(const unsigned long long* __restrict__ table, int n_rm, Slab s,
                   long long sz, long long sy) {
  const int row = blockIdx.y;
  const bool hi_slab = row < n_rm;
  const long long src_start = hi_slab ? s.src_rm : s.src_rp;
  const long long dst_start = hi_slab ? s.dst_rm : s.dst_rp;
  const T* src = (const T*)table[2 * row];
  T* dst = (T*)table[2 * row + 1];
  const unsigned w = hi_slab ? s.rm : s.rp;
  const unsigned b0 = AXIS == 0 ? w : s.ext[0];
  const unsigned b1 = AXIS == 1 ? w : s.ext[1];
  const unsigned b2 = AXIS == 2 ? w : s.ext[2];
  const unsigned total = b0 * b1 * b2;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < total;
       i += gridDim.x * THREADS) {
    const unsigned t = i / b2;
    long long c[3] = {(long long)(t / b1), (long long)(t % b1), (long long)(i % b2)};
    const long long j = c[AXIS];
    c[AXIS] = src_start + j;
    const long long si = c[0] * sz + c[1] * sy + c[2];
    c[AXIS] = dst_start + j;
    const long long di = c[0] * sz + c[1] * sy + c[2];
    dst[di] = src[si];
  }
}

template <typename T>
void launch(const dim3& grid, cudaStream_t st, const unsigned long long* table, int n_rm,
            const Slab& s, long long sz, long long sy, int axis) {
  if (axis == 0)
    remote_axis_kernel<T, 0><<<grid, THREADS, 0, st>>>(table, n_rm, s, sz, sy);
  else if (axis == 1)
    remote_axis_kernel<T, 1><<<grid, THREADS, 0, st>>>(table, n_rm, s, sz, sy);
  else
    remote_axis_kernel<T, 2><<<grid, THREADS, 0, st>>>(table, n_rm, s, sz, sy);
}

}  // namespace

// table: device array of 2 * (n_rm + n_rp) pointers, (source block,
// destination block) per row, each block a contiguous (pz, py, px) array;
// the first n_rm rows send the hi slab, the next n_rp the lo slab.
// axis: 0 = z, 1 = y, 2 = x. o / n: compute offset and size along the axis;
// rm / rp: lo- and hi-side halo widths. dev: the device of every block.
extern "C" int remote_axis_launch(const void* table, int n_rm, int n_rp, int elem_size,
                                  int pz, int py, int px, int axis, int o, int n, int rm,
                                  int rp, int dev, void* stream) {
  if (n_rm < 0 || n_rp < 0 || n_rm + n_rp > 65535 || axis < 0 || axis > 2 || rm < 0 ||
      rp < 0 || (n_rm > 0 && rm == 0) || (n_rp > 0 && rp == 0) ||
      (elem_size != 4 && elem_size != 8))
    return (int)cudaErrorInvalidValue;
  if (n_rm + n_rp == 0) return 0;
  Slab s;
  const int ext[3] = {pz, py, px};
  for (int a = 0; a < 3; ++a) s.ext[a] = ext[a];
  s.rm = rm;
  s.rp = rp;
  s.src_rm = o + n - rm;
  s.dst_rm = o - rm;
  s.src_rp = o;
  s.dst_rp = o + n;
  const long long cells = (long long)pz * py * px / ext[axis] * (rm > rp ? rm : rp);
  if (cells >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int sms = 0, threads_per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (e != cudaSuccess) return (int)e;
  // about one wave of full-occupancy blocks over all rows; each thread
  // strides over the rest of its slab
  const int rows = n_rm + n_rp;
  long long per_row = (long long)sms * (threads_per_sm / THREADS) / rows;
  if (per_row < 1) per_row = 1;
  long long bx = (cells + THREADS - 1) / THREADS;
  if (bx > per_row) bx = per_row;
  const dim3 grid((unsigned)bx, (unsigned)rows);
  const long long sz = (long long)py * px, sy = px;
  const unsigned long long* t = (const unsigned long long*)table;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_size == 4)
    launch<uint32_t>(grid, st, t, n_rm, s, sz, sy, axis);
  else
    launch<uint64_t>(grid, st, t, n_rm, s, sz, sy, axis);
  return (int)cudaGetLastError();
}
