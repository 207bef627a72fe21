// The shared device body of the exchange carriers (remote_axis.cu and
// fused_exchange.cu): copy halo messages between the blocks of a mesh of
// positions by rows, from a work list laid out in Python
// (stencil_tpu_torch/ops/row_moves.py, move_work).
//
// Every message copies a box of a sender block's compute cells into a box of
// a receiver block's halo. A box is moved by rows (its x extent), and the rows
// of one box share one layout; the work list holds segments of such rows. Two
// kinds of segment, one row format:
//   - a run segment: rows of one message, each `units` units of `width`
//     words, the words of a unit contiguous: 16-byte vectors where source and
//     destination agree in phase on the 16-byte grid (a one-word head and tail
//     around them in their own segments), one word at a time elsewhere;
//   - a paired segment: the row ends of two messages that touch the same
//     32-byte sectors, message (d, sender b) and message (-d, sender b + d).
//     A row holds `split` one-word units of the first (read from b, written
//     into b + d) and then `end - split` of the second (read from b + d,
//     written into b), on adjacent lanes; the row takes `units` lanes, `end`
//     rounded up to a divisor of the warp, so no row straddles two warp
//     instructions. For the x faces that puts b's hi row end and b + d's lo
//     row end in one warp instruction for the loads and one for the stores,
//     so every partially written sector is already whole in L2 when its
//     write lands (self_fill.cu's "rows" layout, with a second block for the
//     partner).
//
// A segment's table row (COLS int64): group, src, dst, split, src2, dst2,
// end, units, width, ey, rows, chunks, start, narrow. Row r of the segment lies
// (r / ey) * sz + (r % ey) * sy words past its first row and takes `units`
// units; unit k < split of a row copies words src + k * width.. of block P
// into dst + .. of block Q, unit split <= k < end words
// src2 + (k - split) * width.. of Q into dst2 + .. of P, and a unit past
// `end` is idle; a run segment has split = end = units. P and Q are the
// pointer table's row (group * m + j) for the j-th of the group's m
// instances (a sender position and quantity): P the sender, Q the block at
// the sender's position + the group's step.
//
// Work: a task is up to TASK units of one segment and one instance, and a
// block takes one task: it finds the task's segment (a binary search over
// the starts), its instance and its chunk of the segment's units, and each
// thread loads its UNROLL units before it stores any. A segment's tasks run
// chunk by chunk over the instances (chunk-major), so the blocks in flight
// move the same rows of every block at once. A unit costs two 32-bit
// divides (its row and its row's plane). The card's block scheduler hands
// out the tasks. Probe builds on an H100 chose the shape (PERF.md, section 6):
// one block a task balanced the many small tasks of edges and corners
// better than a wave of resident blocks taking tasks in turn, and small
// tasks of one unit a thread moved the x faces' row ends faster than 2 or 4
// units a thread loaded ahead of their stores.
//
// Ordering: every read is of a compute cell and every write of a halo cell,
// each written once, and the block is at least the radius wide, so nothing
// is read and written in one launch: units run in any order, and the sources
// go through the read-only path. The kernel copies bits: T is the word
// (unsigned int for fp32, unsigned long long for fp64).
//
// The narrowed wire (wire_round.cuh): a launch takes one wire code W (and,
// for W = SOFT, the format it rounds into), and a segment whose `narrow` is
// set (its messages cross between positions; both halves of a paired
// segment share one axis, so one flag) rounds every word of a unit through
// the wire between its load and its store, unless the instance's pointer
// row marks it local: bit 0 of its sender pointer (the words are at least 4
// bytes, so a block's address never sets it) says the instance's messages of
// that group stay on one position, as the shifts between the residents of
// an oversubscribed mesh do. W = NONE is the bit copy, the same code as
// before the wire existed: the rounding and the mark are compiled only into
// the W != NONE instantiations, and an integer group always launches
// W = NONE.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_round.cuh"

namespace row_moves {

constexpr int THREADS = 128;           // threads of a block
constexpr int UNROLL = 1;              // units a thread loads before it stores
constexpr int TASK = THREADS * UNROLL;  // units of one task
constexpr int COLS = 14;               // int64 columns of a work-list row

struct Seg {
  long long group, src, dst, split, src2, dst2, end, units, width, ey, rows, chunks, start, narrow;
};
static_assert(sizeof(Seg) == COLS * sizeof(long long), "a work-list row");

// Units i0 + u * THREADS (u < UNROLL, below n) of segment s between blocks p
// and q; T a word, V a unit (T itself or a 16-byte vector), WIRE the wire of
// format f, through which the words round where `narrow`.
template <typename T, typename V, int WIRE>
__device__ __forceinline__ void move_units(unsigned long long p, unsigned long long q,
                                           const Seg& s, unsigned n, unsigned i0, long long sz,
                                           long long sy, bool narrow, const wire::Format& f) {
  constexpr long long W = sizeof(V) / sizeof(T);
  const unsigned units = (unsigned)s.units, ey = (unsigned)s.ey, split = (unsigned)s.split;
  const unsigned end = (unsigned)s.end;
  V v[UNROLL];
  V* to[UNROLL];
  bool live[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = i0 + u * THREADS;
    const unsigned r = i / units, k = i - r * units;
    live[u] = i < n && k < end;
    if (live[u]) {
      const unsigned rz = r / ey, ry = r - rz * ey;
      const long long row = (long long)rz * sz + (long long)ry * sy;
      const bool second = k >= split;
      const long long x = second ? (long long)(k - split) * W : (long long)k * W;
      const T* from = reinterpret_cast<const T*>(second ? q : p) + row + x +
                      (second ? s.src2 : s.src);
      to[u] = reinterpret_cast<V*>(reinterpret_cast<T*>(second ? p : q) + row + x +
                                   (second ? s.dst2 : s.dst));
      v[u] = __ldg(reinterpret_cast<const V*>(from));
      if constexpr (WIRE != wire::NONE) {
        if (narrow) v[u] = wire::narrow_unit<T, WIRE>(v[u], f);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (live[u]) *to[u] = v[u];
}

template <typename T, int WIRE>
__global__ void __launch_bounds__(THREADS)
move_rows_kernel(const unsigned long long* __restrict__ ptrs, int m,
                 const Seg* __restrict__ segs, int nseg, long long sz, long long sy,
                 const __grid_constant__ wire::Format fmt) {
  const long long t = blockIdx.x;
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (segs[mid].start <= t) lo = mid;
    else hi = mid - 1;
  }
  const Seg s = segs[lo];
  const long long k = t - s.start;
  const long long c = k / m, j = k - c * m;  // the chunk, and the instance
  const long long row = 2 * (s.group * m + j);
  const unsigned n = (unsigned)(s.rows * s.units);
  const unsigned i0 = (unsigned)(c * TASK) + threadIdx.x;
  unsigned long long p = ptrs[row];
  bool narrow = false;
  if constexpr (WIRE != wire::NONE) {
    narrow = s.narrow && !(p & 1ull);
    p &= ~1ull;
  }
  if (s.width == 1) move_units<T, T, WIRE>(p, ptrs[row + 1], s, n, i0, sz, sy, narrow, fmt);
  else move_units<T, uint4, WIRE>(p, ptrs[row + 1], s, n, i0, sz, sy, narrow, fmt);
}

// The kernel of one word size and wire, or null for a pair it does not
// take: fp32 words narrow to bf16, fp16, e4m3, e5m2 or a SOFT format, fp64
// words also to fp32.
template <typename T>
inline const void* kernel_for(int w) {
  switch (w) {
    case wire::NONE: return (const void*)move_rows_kernel<T, wire::NONE>;
    case wire::BF16: return (const void*)move_rows_kernel<T, wire::BF16>;
    case wire::F16: return (const void*)move_rows_kernel<T, wire::F16>;
    case wire::E4M3: return (const void*)move_rows_kernel<T, wire::E4M3>;
    case wire::E5M2: return (const void*)move_rows_kernel<T, wire::E5M2>;
    case wire::SOFT: return (const void*)move_rows_kernel<T, wire::SOFT>;
    default: return nullptr;
  }
}

template <>
inline const void* kernel_for<unsigned long long>(int w) {
  using U = unsigned long long;
  switch (w) {
    case wire::NONE: return (const void*)move_rows_kernel<U, wire::NONE>;
    case wire::BF16: return (const void*)move_rows_kernel<U, wire::BF16>;
    case wire::F16: return (const void*)move_rows_kernel<U, wire::F16>;
    case wire::E4M3: return (const void*)move_rows_kernel<U, wire::E4M3>;
    case wire::F32: return (const void*)move_rows_kernel<U, wire::F32>;
    case wire::E5M2: return (const void*)move_rows_kernel<U, wire::E5M2>;
    case wire::SOFT: return (const void*)move_rows_kernel<U, wire::SOFT>;
    default: return nullptr;
  }
}

inline const void* kernel_for(int elem_size, int w) {
  if (elem_size == 4) return kernel_for<unsigned int>(w);
  if (elem_size == 8) return kernel_for<unsigned long long>(w);
  return nullptr;
}

// One launch over the work list, one block a task, on the current device:
// ptrs a device table of (P, Q) pointer rows, m per group; segs a device
// table of nseg work-list rows whose tasks end at `tasks`; elem_size the word
// in bytes (4 or 8); w the wire code (wire::NONE for the bit copy) and fmt
// its format's WIRE_PARAMS doubles (read for wire::SOFT; may be null
// otherwise); sz / sy the blocks' plane and row strides in words.
inline int launch(const void* ptrs, int m, const void* segs, int nseg, long long tasks,
                  int elem_size, int w, const double* fmt, long long sz, long long sy,
                  void* stream) {
  const void* kernel = kernel_for(elem_size, w);
  if (m < 0 || nseg < 1 || tasks < 0 || tasks > INT_MAX || sz < 0 || sy < 0 || !kernel)
    return (int)cudaErrorInvalidValue;
  if (w == wire::SOFT && !fmt) return (int)cudaErrorInvalidValue;
  if (tasks == 0 || m == 0) return 0;
  wire::Format f = wire::Format::from(fmt);
  void* args[] = {(void*)&ptrs, &m, (void*)&segs, &nseg, &sz, &sy, &f};
  cudaError_t e = cudaLaunchKernel(kernel, dim3((unsigned)tasks), dim3(THREADS), args, 0,
                                   (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The instantiation of one word size and wire on the current device: r[0..1]
// = registers and local (spill) bytes per thread.
inline int info(int elem_size, int w, int* r) {
  const void* kernel = kernel_for(elem_size, w);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  r[0] = a.numRegs;
  r[1] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace row_moves
