// The numerical health check: for each output slot, whether every element of
// its tensors is finite, and max |x|, in one launch over a work list.
//
// Replaces: the fused XLA reduction of stencil_tpu/fault/health.py
// HealthGuard._build (isfinite(x).all() and max(abs(x)).astype(float32) per
// quantity; JAX runs it in XLA, not in a Pallas kernel), which the port ran as
// four torch passes (isfinite, all, abs, amax). Python wrapper, work list and
// plain PyTorch version: stencil_tpu_torch/ops/health_reduce.py
// (health_reduce, work_list, finite_and_max_plain).
//
// What it computes: a float's magnitude is its bit pattern with the sign bit
// cleared, and for non-negative patterns the unsigned integer order is the
// order of the magnitudes, with inf above every finite value and every NaN
// above inf. So one unsigned max over sign-cleared patterns gives, per slot,
// max |x| with NaN propagating as amax does (a slot with a NaN reads NaN, one
// with an inf and no NaN reads inf), and "all finite" is that max lying below
// inf's pattern. An integer max is exact and independent of order, so the
// result does not depend on how the work is split. fp32 maxima are widened to
// the fp64 pattern of the same value (exact and monotonic) before they meet
// other blocks', so every slot accumulates one 64-bit pattern; the last block
// casts each slot's maximum to float32 (the max taken in the input's type,
// then cast, as x.abs().amax().float() does).
//
// What bounds it on an H100: bytes. Each element is read once and nothing
// but 2 floats a slot is written, so the floor is the tensors' bytes over
// the memory rate (a 512^3 one-block fp32 state, 640x528x514 padded, 0.695
// GB: 0.207 ms at 3.35 TB/s).
//
// Design: the work list (built in Python, health_reduce.work_list) cuts
// every tensor, or every lane of a (B, ...) stack, into tasks of at most
// TASK_BYTES, each naming its address, element count, element size and slot;
// one block takes one task. A thread loads 16-byte vectors four at a time
// (scalar loads for the elements before the first 16-byte boundary and after
// the last), keeps its own maximum, and the block reduces by warp shuffles
// and shared memory. Thread 0 folds the block's maximum into the slot's
// 64-bit accumulator with atomicMax and counts the block done; the last
// block (a __threadfence counter) reads every slot's accumulator, writes
// (finite, max) as float32 into out[0][s] and out[1][s], and resets the
// accumulators and the counter to zero for the next launch. Entries of one
// slot combine however many tensors and tasks feed it: Q quantities of a
// state (Q slots), every position's block of one quantity on a mesh (that
// quantity's slot), and the lanes of a campaign slot (one slot a lane).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi_column.cuh"  // jacobi::DeviceScope

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long TASK_BYTES = 1LL << 17;  // ops/health_reduce.TASK_BYTES
constexpr unsigned long long INF64 = 0x7ff0000000000000ull;
constexpr unsigned long long SIGN64 = 0x7fffffffffffffffull;

// one row of the work list: a run of `count` elements of `elem` bytes at
// `addr`, folded into slot `slot`
struct Task {
  long long addr, count, elem, slot;
};

template <typename W>
__device__ __forceinline__ W wmax(W a, W b) {
  return a > b ? a : b;
}

template <typename W>
struct Mag;

template <>
struct Mag<unsigned int> {  // fp32
  static constexpr unsigned int MASK = 0x7fffffffu;
  __device__ static unsigned int vec(uint4 v) {
    return wmax(wmax(v.x & MASK, v.y & MASK), wmax(v.z & MASK, v.w & MASK));
  }
  // the fp64 pattern of the same magnitude (the sign of a converted NaN is
  // cleared again: only the pattern's order matters)
  __device__ static unsigned long long widen(unsigned int m) {
    return (unsigned long long)__double_as_longlong((double)__uint_as_float(m)) & SIGN64;
  }
};

template <>
struct Mag<unsigned long long> {  // fp64
  static constexpr unsigned long long MASK = SIGN64;
  __device__ static unsigned long long vec(uint4 v) {
    return wmax(((unsigned long long)v.y << 32 | v.x) & MASK,
                ((unsigned long long)v.w << 32 | v.z) & MASK);
  }
  __device__ static unsigned long long widen(unsigned long long m) { return m; }
};

// this thread's maximum sign-cleared pattern over its share of one task
template <typename W>
__device__ unsigned long long task_max(const Task& t) {
  constexpr long long PER = 16 / sizeof(W);  // elements a vector
  const W* s = reinterpret_cast<const W*>(t.addr);
  const long long n = t.count;
  long long head = ((16 - (t.addr & 15)) & 15) / (long long)sizeof(W);
  if (head > n) head = n;
  const long long nv = (n - head) / PER;
  W m = 0;
  for (long long i = threadIdx.x; i < head; i += THREADS) m = wmax(m, __ldg(s + i) & Mag<W>::MASK);
  const uint4* v = reinterpret_cast<const uint4*>(s + head);
  long long i = threadIdx.x;
  for (; i + 3 * THREADS < nv; i += 4 * THREADS) {
    const uint4 a = __ldg(v + i), b = __ldg(v + i + THREADS);
    const uint4 c = __ldg(v + i + 2 * THREADS), d = __ldg(v + i + 3 * THREADS);
    m = wmax(m, wmax(wmax(Mag<W>::vec(a), Mag<W>::vec(b)), wmax(Mag<W>::vec(c), Mag<W>::vec(d))));
  }
  for (; i < nv; i += THREADS) m = wmax(m, Mag<W>::vec(__ldg(v + i)));
  for (long long j = head + nv * PER + threadIdx.x; j < n; j += THREADS)
    m = wmax(m, __ldg(s + j) & Mag<W>::MASK);
  return Mag<W>::widen(m);
}

// the block's maximum, in thread 0
__device__ unsigned long long block_max(unsigned long long m) {
  __shared__ unsigned long long warp_max[WARPS];
  for (int o = 16; o > 0; o >>= 1) m = wmax(m, __shfl_down_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = threadIdx.x < WARPS ? warp_max[threadIdx.x] : 0ull;
  if (threadIdx.x < 32)
    for (int o = 16; o > 0; o >>= 1) m = wmax(m, __shfl_down_sync(0xffffffffu, m, o));
  return m;
}

__global__ void __launch_bounds__(THREADS)
health_kernel(const Task* __restrict__ tasks, unsigned long long* acc, unsigned int* done,
              int nslots, float* __restrict__ out) {
  const Task t = tasks[blockIdx.x];
  unsigned long long m = t.elem == 8 ? task_max<unsigned long long>(t) : task_max<unsigned int>(t);
  m = block_max(m);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (m) atomicMax(acc + t.slot, m);
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int s = threadIdx.x; s < nslots; s += THREADS) {
    const unsigned long long b = atomicExch(acc + s, 0ull);
    out[s] = b < INF64 ? 1.0f : 0.0f;
    out[nslots + s] = (float)__longlong_as_double((long long)b);
  }
  if (threadIdx.x == 0) atomicExch(done, 0u);
}

}  // namespace

// tasks: device table of ntasks work-list rows (Task, four int64 each);
// scratch: nslots zeroed uint64 accumulators then one zeroed uint32 counter,
// left zeroed again by the launch; out: (2, nslots) float32, written. Runs on
// device `dev`, on `stream`.
extern "C" int health_reduce_launch(const void* tasks, long long ntasks, void* scratch,
                                    int nslots, void* out, int dev, void* stream) {
  if (ntasks < 1 || ntasks > INT_MAX || nslots < 1) return (int)cudaErrorInvalidValue;
  jacobi::DeviceScope on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  unsigned long long* acc = (unsigned long long*)scratch;
  health_kernel<<<(unsigned)ntasks, THREADS, 0, (cudaStream_t)stream>>>(
      (const Task*)tasks, acc, (unsigned int*)(acc + nslots), nslots, (float*)out);
  return (int)cudaGetLastError();
}

// the work list's task size in bytes, for the wrapper's mirror
extern "C" long long health_reduce_task_bytes() { return TASK_BYTES; }
