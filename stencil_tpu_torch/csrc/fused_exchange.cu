// Every direction's exact-extent halo message of the fused remote-dma
// exchange over a mesh of block positions, for every position of one device
// and a same-dtype group of quantities, in one launch.
//
// Replaces: stencil_tpu/ops/fused_stencil.py make_fused_exchange_kernel (the
// TPU's exchange-only fused carrier: stage and remote-copy every crossing
// direction's message into the neighbour's landing buffer, run the
// self-wrap hand-offs locally, wait, unpack). Python wrapper and plain
// PyTorch version: stencil_tpu_torch/ops/fused_stencil.py (fused_exchange,
// fused_exchange_plain).
//
// What it computes: for each active direction d of the plan (DIRECT26
// geometry, face -> edge -> corner), each sender block's compute cells on
// its d side, radius deep along d's nonzero axes and the block's extent on
// the others, are stored into the -d side halo box of the block at position
// + d (wrapped per axis; on an axis with one position that is the sender
// itself, a self-wrap hand-off). Together the messages fill every declared
// halo cell as the axis-composed exchange does.
//
// What bounds it on an H100: bytes. Each message cell is read once and
// written once: 2 * elem_size * (halo cells of the active directions) per
// block and quantity, over the memory rate.
//
// Design: the reference's ColoDomainKernel, "a single kernel for the whole
// domain using precomputed offset arrays". The direction boxes (source and
// destination starts and extents, direction_boxes.cuh) are the same for
// every block of a uniform partition and ride in the kernel's parameters;
// the wrapper passes a table in device memory of (source block, destination
// block) pointers, m rows per box in box order, one row per (sender
// position, quantity). The launch flattens every (box, row, cell) into one
// index space: a thread finds its box by the boxes' prefix sums (faces
// first, so most cells stop after a few compares), then its row and cell,
// x fastest, so a warp's accesses are consecutive words of a box row. Stores
// go straight into the destination's halo: no landing buffer, no unpack.
// The kernel copies bits (4- or 8-byte words), so fp32 and fp64 share one
// body.
//
// Ordering: every message reads only compute cells, which no message
// writes, and writes only halo cells, each by exactly one message; so one
// launch needs no order among its threads. Positions on distinct GPUs will
// need each device's launch to wait until its neighbours' previous reads of
// the halos it overwrites are done (an event per neighbour), which is the
// TPU kernel's barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#include "direction_boxes.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_exchange_kernel(const unsigned long long* __restrict__ table, long long m,
                      const __grid_constant__ DirBoxes bx, long long sz, long long sy) {
  const long long total = bx.start[bx.n] * m;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    int b = 0;
    while (i >= bx.start[b + 1] * m) ++b;
    const int* q = bx.box[b];
    const long long cells = bx.start[b + 1] - bx.start[b];
    const long long j = i - bx.start[b] * m;
    const long long row = (long long)b * m + j / cells;
    unsigned c = (unsigned)(j % cells);
    const int x = (int)(c % (unsigned)q[8]);
    c /= (unsigned)q[8];
    const int y = (int)(c % (unsigned)q[7]);
    const int z = (int)(c / (unsigned)q[7]);
    const T* src = (const T*)table[2 * row];
    T* dst = (T*)table[2 * row + 1];
    dst[(long long)(q[3] + z) * sz + (long long)(q[4] + y) * sy + q[5] + x] =
        src[(long long)(q[0] + z) * sz + (long long)(q[1] + y) * sy + q[2] + x];
  }
}

}  // namespace

// table: device array of 2 * nboxes * m pointers, (source block, destination
// block) per row, m rows per box in box order, each block a contiguous
// (pz, py, px) array with plane stride sz and row stride sy. boxes: nboxes
// rows of 9 ints (src z y x, dst z y x, extent z y x). dev: the device of
// every block.
extern "C" int fused_exchange_launch(const void* table, int m, const int* boxes, int nboxes,
                                     int elem_size, long long sz, long long sy, int dev,
                                     void* stream) {
  if (m < 0 || (elem_size != 4 && elem_size != 8)) return (int)cudaErrorInvalidValue;
  DirBoxes bx;
  if (!make_dir_boxes(boxes, nboxes, &bx)) return (int)cudaErrorInvalidValue;
  const long long total = bx.start[bx.n] * m;
  if (total == 0) return 0;
  int sms = 0, threads_per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (e != cudaSuccess) return (int)e;
  // one wave of full-occupancy blocks at most; each thread strides over the rest
  const long long wave = (long long)sms * (threads_per_sm / THREADS);
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > wave) blocks = wave;
  const unsigned long long* t = (const unsigned long long*)table;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_size == 4)
    fused_exchange_kernel<uint32_t><<<(unsigned)blocks, THREADS, 0, st>>>(t, m, bx, sz, sy);
  else
    fused_exchange_kernel<uint64_t><<<(unsigned)blocks, THREADS, 0, st>>>(t, m, bx, sz, sy);
  return (int)cudaGetLastError();
}
