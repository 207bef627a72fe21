// In-place periodic halo fill of one self-wrap axis, for up to 16 quantities.
//
// Replaces: stencil_tpu/ops/halo_fill.py make_self_fill (the TPU's z, y and x
// fill kernels, which read-modify-write whole 8-row / 128-lane tiles because
// that is the TPU's store granularity; nothing here does). Python wrapper,
// layout and plain PyTorch version: stencil_tpu_torch/ops/halo_fill.py
// (self_fill, fill_layout, self_fill_plain).
//
// The fill of one axis is two copies per instance (the lo halo from the hi
// source, the hi halo from the lo source), repeated over instances a fixed
// stride apart; fill_layout computes them in Python:
//   z: one instance; each side is one contiguous run of rm (or rp) whole
//      planes, source and destination alike;
//   y: one instance per z plane; each side is one contiguous run of rm (or
//      rp) whole rows;
//   x: one instance per (z, y) row; each side is rm (or rp) words at a row end.
//
// What bounds it on an H100:
//   y and z: bytes. Each halo word is read once and written once, in long
//      contiguous runs; the floor is those bytes over the memory rate. What
//      reaches it is enough bytes in flight (well over 2 MB at HBM3's
//      latency) and few instructions per byte.
//   x: 32-byte sectors, scattered. A row end is a few words inside one or two
//      sectors of a row thousands of bytes long, so every row costs a read
//      and a write of the sectors at each end however the words are grouped
//      (four sector accesses a row when each end lies in one sector), and
//      consecutive rows' sectors lie a row apart in memory. The card serves
//      such scattered sectors far below its streaming rate, writes slower
//      than reads (apps/bench_fill.py times both alone with
//      apps/sector_probe.cu), so what the design can do is issue one
//      request per row end and sector, and keep many in flight.
//
// Design:
//   runs (y, z): a flat copy of 16-, 8- or 4-byte vectors. The grid is
//      (instance x side x chunk, quantity), sized to the work; a block copies
//      one chunk of one run, each thread loading RUN_UNROLL independent
//      vectors before it stores any. The run is decoded from blockIdx once
//      per block; no element pays a divide.
//   rows (x): a block fills a tile of consecutive rows; a thread copies one
//      slot (a word or vector of a row end), the slots of a row on adjacent
//      lanes, so one warp instruction reads or writes each row end it
//      touches as one request. A thread's index work is one small 32-bit
//      divide and one 64-bit row base. Other bodies for the same fill are
//      timed beside it by apps/bench_fill.py (apps/sector_probe.cu), on an
//      H100 at the shapes it times: one thread per row, looping over its
//      slots, issues a request per slot and ran 1.6-2.5x slower; staging a
//      tile of rows' end sectors through shared memory or through registers
//      (warp shuffles) and storing them whole moves the same sectors, and
//      ran from 9% faster (fp32, registers) to 27% slower (fp64, shared
//      memory) than this body.
// The vector width comes from the caller (fill_layout: the widest of 16, 8
// and the element size in bytes that divides every run's start, length and
// stride and the pointers' alignment); a width that does not divide them is
// refused with cudaErrorInvalidValue. Within one launch no cell is both read
// and written (the sources are compute cells, the destinations halos, and
// the block is at least as wide as the radius: the wrapper checks), so the
// sources are read through the read-only path.
//
// One launch fills both sides of one axis for every quantity of a
// same-element-size group (blockIdx.y picks the quantity; the pointers ride in
// the kernel's parameters). Each copy spans the FULL padded extent of the
// other two axes, so calling it for x, then y, then z composes edges and
// corners exactly as the JAX package's axis-composed exchange does. The
// kernel copies bits (4- or 8-byte words), so fp32 and fp64 both go through
// it. A contiguous stack of resident blocks (the z_stack form) is filled in x
// and y by one launch over the stack viewed as one (c * pz, py, px) array.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXQ = 16;
constexpr int RUN_THREADS = 128;  // threads of a run-copy block
constexpr int RUN_UNROLL = 4;     // vectors a thread loads before it stores
constexpr long long RUN_CHUNK = RUN_THREADS * RUN_UNROLL;
constexpr int ROW_THREADS = 256;  // threads of a row-fill block

struct Ptrs {
  void* p[MAXQ];
};

// The two copies of an instance (the lo halo from the hi source and the hi
// halo from the lo source; either may be empty), in vectors from its base.
// Both tables are read in place from the kernel's parameters
// (__grid_constant__): an index by blockIdx would otherwise copy them to
// local memory in every thread.
struct Runs {
  long long dst[2], src[2], len[2];
};

template <typename V>
__global__ void __launch_bounds__(RUN_THREADS)
fill_runs(const __grid_constant__ Ptrs ptrs, const __grid_constant__ Runs runs,
          long long stride, unsigned chunks) {
  const unsigned inst = blockIdx.x / chunks;  // 2 * instance + side
  const unsigned chunk = blockIdx.x - inst * chunks;
  const int side = inst & 1;
  const long long len = runs.len[side];
  const long long i0 = (long long)chunk * RUN_CHUNK + threadIdx.x;
  if (i0 >= len) return;
  V* a = (V*)ptrs.p[blockIdx.y] + (long long)(inst >> 1) * stride;
  const V* s = a + runs.src[side];
  V* d = a + runs.dst[side];
  V v[RUN_UNROLL];
#pragma unroll
  for (int u = 0; u < RUN_UNROLL; ++u)
    if (i0 + u * RUN_THREADS < len) v[u] = __ldg(s + i0 + u * RUN_THREADS);
#pragma unroll
  for (int u = 0; u < RUN_UNROLL; ++u)
    if (i0 + u * RUN_THREADS < len) d[i0 + u * RUN_THREADS] = v[u];
}

template <typename V>
__global__ void __launch_bounds__(ROW_THREADS)
fill_rows(const __grid_constant__ Ptrs ptrs, const __grid_constant__ Runs runs, long long rows,
          long long stride, unsigned tile) {
  // a block fills `tile` consecutive rows; its threads enumerate (row, slot)
  // with the slots of a row (run 0's vectors, then run 1's) on adjacent lanes
  const unsigned slots = (unsigned)(runs.len[0] + runs.len[1]);
  V* const q = (V*)ptrs.p[blockIdx.y];
  for (unsigned i = threadIdx.x; i < tile * slots; i += ROW_THREADS) {
    const unsigned r = i / slots, k = i - r * slots;
    const long long row = (long long)blockIdx.x * tile + r;
    if (row >= rows) return;
    V* a = q + row * stride;
    const int side = k >= runs.len[0];
    const long long j = side ? k - runs.len[0] : k;
    a[runs.dst[side] + j] = __ldg(a + runs.src[side] + j);
  }
}

template <typename V>
int launch(const Ptrs& p, int nq, int body, const Runs& r, long long count,
           long long stride, cudaStream_t st) {
  if (body == 0) {
    const long long n = r.len[0] > r.len[1] ? r.len[0] : r.len[1];
    const long long chunks = (n + RUN_CHUNK - 1) / RUN_CHUNK;
    const long long blocks = 2 * count * chunks;
    if (blocks == 0) return 0;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    fill_runs<V><<<dim3((unsigned)blocks, nq), RUN_THREADS, 0, st>>>(p, r, stride,
                                                                      (unsigned)chunks);
  } else {
    const long long slots = r.len[0] + r.len[1];
    if (slots > INT_MAX) return (int)cudaErrorInvalidValue;
    const long long tile = slots < ROW_THREADS ? ROW_THREADS / slots : 1;
    const long long blocks = slots ? (count + tile - 1) / tile : 0;
    if (blocks == 0) return 0;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    fill_rows<V><<<dim3((unsigned)blocks, nq), ROW_THREADS, 0, st>>>(p, r, count, stride,
                                                                      (unsigned)tile);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: host array of nq device pointers to contiguous blocks. body: 0 = runs
// (y, z), 1 = rows (x). runs: (dst, src, len) of side 0 then side 1, in words
// from an instance's base; count instances, stride words apart. vec: words
// per access (vec * elem_size must be 4, 8 or 16 bytes and divide every
// offset, length, the stride and each pointer).
extern "C" int self_fill_launch(void* const* ptrs, int nq, int elem_size, int body,
                                const long long* runs, long long count, long long stride,
                                int vec, void* stream) {
  const int vbytes = vec * elem_size;
  if (nq < 1 || nq > MAXQ || (elem_size != 4 && elem_size != 8) || (body != 0 && body != 1) ||
      count < 0 || stride < 0 || vec < 1 || (vbytes != 4 && vbytes != 8 && vbytes != 16))
    return (int)cudaErrorInvalidValue;
  if (stride % vec) return (int)cudaErrorInvalidValue;
  Runs r;
  for (int s = 0; s < 2; ++s) {
    const long long d = runs[3 * s], src = runs[3 * s + 1], len = runs[3 * s + 2];
    if (d < 0 || src < 0 || len < 0 || d % vec || src % vec || len % vec)
      return (int)cudaErrorInvalidValue;
    r.dst[s] = d / vec;
    r.src[s] = src / vec;
    r.len[s] = len / vec;
  }
  Ptrs p;
  for (int q = 0; q < MAXQ; ++q) {
    p.p[q] = q < nq ? ptrs[q] : nullptr;
    if (q < nq && (uintptr_t)ptrs[q] % vbytes) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  stride /= vec;
  if (vbytes == 16) return launch<uint4>(p, nq, body, r, count, stride, st);
  if (vbytes == 8) return launch<uint2>(p, nq, body, r, count, stride, st);
  return launch<unsigned int>(p, nq, body, r, count, stride, st);
}
