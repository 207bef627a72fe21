// Probes of the x halo fill (csrc/self_fill.cu's row body), for
// apps/bench_fill.py: what its scattered memory traffic costs alone, and what
// other bodies for the same fill cost. Not a port of a TPU kernel: nothing in
// the package launches it. Built on demand by bench_fill (ops/_native.build)
// with the kernels' nvcc flags.
//
// Everything is in 4-byte words, rows `stride` words apart. Each row has two
// spans, (a0, n0) and (a1, n1) in words from its start, and the fill's
// geometry (o, n, rm, rp) in words: the lo halo [o-rm, o) is copied from
// [o+n-rm, o+n), the hi halo [o+n, o+n+rp) from [o, o+rp). Modes:
//   0 read:    load every word of the spans and keep nothing (the fill's
//              loads, when the spans are its sources);
//   1 write:   store to every word of the spans (the fill's write-back, when
//              the spans are the 32-byte sectors that hold its halos);
//   2 row:     the fill, one thread per row: it loads the row's rm + rp
//              source words into registers, then stores its halo words;
//   3 smem:    the fill staged through shared memory: a block loads the spans
//              (the sectors that hold the halos and their sources) of a tile
//              of rows, then stores them back whole, halos replaced;
//   4 shuffle: the same staged through registers: a row's span words sit on
//              adjacent lanes of one warp, and each halo word takes its
//              source's by a warp shuffle.
// Modes 0, 1 and 3 walk rows as the fill's row body does (a block takes a
// tile of consecutive rows, the words of a row on adjacent lanes).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int MAXQ = 16;
constexpr int THREADS = 256;
constexpr int STAGE = 4;    // words a thread stages in mode 3
constexpr int MAXROW = 32;  // rm + rp words a thread holds in mode 2

struct Ptrs {
  void* p[MAXQ];
};

struct Geom {
  long long a0, n0, a1, n1, o, n, rm, rp;
};

// the word of slot k of a row (span 0's slots, then span 1's)
__device__ __forceinline__ long long slot_word(const Geom& g, long long k) {
  return k < g.n0 ? g.a0 + k : g.a1 + (k - g.n0);
}

// the slot whose word the fill copies into slot k (k itself outside the halos)
__device__ __forceinline__ long long source_slot(const Geom& g, long long k) {
  long long w = slot_word(g, k);
  if (w >= g.o - g.rm && w < g.o) w += g.n;
  else if (w >= g.o + g.n && w < g.o + g.n + g.rp) w -= g.n;
  return w >= g.a0 && w < g.a0 + g.n0 ? w - g.a0 : g.n0 + (w - g.a1);
}

__global__ void __launch_bounds__(THREADS)
walk(const __grid_constant__ Ptrs ptrs, const __grid_constant__ Geom g, long long rows,
     long long stride, unsigned tile, int store, unsigned* sink) {
  const unsigned slots = (unsigned)(g.n0 + g.n1);
  unsigned* const q = (unsigned*)ptrs.p[blockIdx.y];
  for (unsigned i = threadIdx.x; i < tile * slots; i += THREADS) {
    const unsigned r = i / slots, k = i - r * slots;
    const long long row = (long long)blockIdx.x * tile + r;
    if (row >= rows) return;
    unsigned* w = q + row * stride + slot_word(g, k);
    if (store) {
      *w = (unsigned)row * 2654435761u + k;  // varied data, not a constant
    } else {
      const unsigned v = __ldg(w);
      if (v == 0x7fc00001u) *sink = v;  // keeps the load live; the sink is scratch
    }
  }
}

__global__ void __launch_bounds__(THREADS)
by_row(const __grid_constant__ Ptrs ptrs, const __grid_constant__ Geom g, long long rows,
       long long stride) {
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (row >= rows) return;
  unsigned* const a = (unsigned*)ptrs.p[blockIdx.y] + row * stride;
  const int rm = (int)g.rm, len = (int)(g.rm + g.rp);
  unsigned v[MAXROW];
#pragma unroll
  for (int k = 0; k < MAXROW; ++k)
    if (k < len) v[k] = __ldg(a + (k < rm ? g.o + g.n - g.rm + k : g.o + (k - rm)));
#pragma unroll
  for (int k = 0; k < MAXROW; ++k)
    if (k < len) a[k < rm ? g.o - g.rm + k : g.o + g.n + (k - rm)] = v[k];
}

__global__ void __launch_bounds__(THREADS)
staged_smem(const __grid_constant__ Ptrs ptrs, const __grid_constant__ Geom g, long long rows,
            long long stride, unsigned tile) {
  extern __shared__ unsigned buf[];
  const unsigned slots = (unsigned)(g.n0 + g.n1);
  unsigned* const q = (unsigned*)ptrs.p[blockIdx.y];
  const long long row0 = (long long)blockIdx.x * tile;
  // plain loads: the words are stored again by this launch
  for (unsigned i = threadIdx.x; i < tile * slots; i += THREADS) {
    const unsigned r = i / slots, k = i - r * slots;
    if (row0 + r < rows) buf[i] = q[(row0 + r) * stride + slot_word(g, k)];
  }
  __syncthreads();
  for (unsigned i = threadIdx.x; i < tile * slots; i += THREADS) {
    const unsigned r = i / slots, k = i - r * slots;
    if (row0 + r < rows)
      q[(row0 + r) * stride + slot_word(g, k)] = buf[r * slots + source_slot(g, k)];
  }
}

__global__ void __launch_bounds__(THREADS)
staged_shuffle(const __grid_constant__ Ptrs ptrs, const __grid_constant__ Geom g, long long rows,
               long long stride) {
  const unsigned slots = (unsigned)(g.n0 + g.n1), per_warp = 32 / slots;
  const unsigned lane = threadIdx.x & 31, r = lane / slots, k = lane - r * slots;
  const long long row = (((long long)blockIdx.x * THREADS + threadIdx.x) >> 5) * per_warp + r;
  const bool live = r < per_warp && row < rows;
  unsigned* const w = (unsigned*)ptrs.p[blockIdx.y] + (live ? row * stride + slot_word(g, k) : 0);
  const unsigned v = live ? *w : 0u;
  const unsigned src = r * slots + (unsigned)source_slot(g, live ? k : 0);
  const unsigned nv = __shfl_sync(0xffffffffu, v, (int)(src & 31));
  if (live) *w = nv;
}

}  // namespace

// ptrs: nq device pointers; rows rows of stride words; geom: a0, n0, a1, n1
// (the spans), o, n, rm, rp (the fill), all in words; mode: 0-4 as above;
// sink: one device word (mode 0).
extern "C" int sector_probe(void* const* ptrs, int nq, long long rows, long long stride,
                            const long long* geom, int mode, void* sink, void* stream) {
  const Geom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[7]};
  const long long slots = g.n0 + g.n1;
  if (nq < 1 || nq > MAXQ || rows < 0 || stride < 0 || mode < 0 || mode > 4 || slots <= 0 ||
      slots > INT_MAX || (mode == 2 && g.rm + g.rp > MAXROW) ||
      (mode == 3 && slots > STAGE * THREADS) || (mode == 4 && slots > 32))
    return (int)cudaErrorInvalidValue;
  Ptrs p;
  for (int q = 0; q < MAXQ; ++q) p.p[q] = q < nq ? ptrs[q] : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  long long tile = 1, blocks;
  if (mode == 2) {
    blocks = (rows + THREADS - 1) / THREADS;
  } else if (mode == 4) {
    const long long warps = (rows + 32 / slots - 1) / (32 / slots);
    blocks = (warps * 32 + THREADS - 1) / THREADS;
  } else {
    const long long per = mode == 3 ? STAGE * THREADS : THREADS;
    tile = slots < per ? per / slots : 1;
    blocks = (rows + tile - 1) / tile;
  }
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, nq);
  if (mode <= 1)
    walk<<<grid, THREADS, 0, st>>>(p, g, rows, stride, (unsigned)tile, mode, (unsigned*)sink);
  else if (mode == 2)
    by_row<<<grid, THREADS, 0, st>>>(p, g, rows, stride);
  else if (mode == 3)
    staged_smem<<<grid, THREADS, tile * slots * sizeof(unsigned), st>>>(p, g, rows, stride,
                                                                        (unsigned)tile);
  else
    staged_shuffle<<<grid, THREADS, 0, st>>>(p, g, rows, stride);
  return (int)cudaGetLastError();
}
