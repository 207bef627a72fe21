// A halo word's trip over a narrowed wire, in registers: narrow to the wire
// dtype by one rounding conversion, widen back losslessly. Shared by the
// exchange carriers' body (row_moves.cuh) and the fused step's phase A
// (fused_jacobi.cu), which apply it to each word of a message that crosses
// between positions, between its load and its store.
//
// Replaces the TPU kernels' wire staging: stencil_tpu/ops/remote_dma.py
// make_remote_axis_kernel (:101-146) and stencil_tpu/ops/fused_stencil.py
// make_fused_exchange_kernel (:118) and make_fused_jacobi_kernel (:292) cast
// each crossing slab into a VMEM buffer of the wire dtype (a DMA cannot
// cast), remote-copy it and widen it on unpack. Here a store goes straight
// into the neighbour's halo through its pointer, so the narrowed-and-widened
// word is what it stores: the JAX package's widened word, bit for bit. The
// plain version is stencil_tpu_torch/ops/halo_fill.py wire_round.
//
// The rounding of each (data, wire) pair is the JAX package's `astype`:
//   - fp32 -> bf16 and fp32 -> fp16: round to nearest even (cvt.rn);
//   - fp32 and fp64 -> fp8 e4m3fn: round to nearest even once from the
//     value, and a value past 464 (448 + half its ulp) or not finite becomes
//     NaN (e4m3fn has no inf, and saturation is not the JAX rule). The card
//     converts fp32 by cvt.rn.satfinite.e4m3x2.f32, which rounds once and
//     clamps, and the NaN rule is applied beside it; fp64 first rounds to
//     fp32 by round-to-odd (toward zero, then the last bit set if inexact),
//     which keeps the later rounding to fp8's 4 bits a single rounding of
//     the fp64 value (fp32 carries more than 2 extra bits);
//   - fp64 -> fp32: cvt.rn; fp64 -> fp16: one rounding (cvt.rn.f16.f64);
//   - fp64 -> bf16: through fp32, two roundings, as XLA does it.
// IEEE subnormals are kept (the library builds with -ftz=false), where XLA
// on the CPU flushes an fp64 -> fp32 or -> bf16 result below fp32's least
// normal to zero (ROADMAP.md queue C, "Design divergences").
//
// Cost: a few instructions a word, against a word's load and store. (The
// first form took cuda_fp8.hpp's exact software conversion for fp8, tens of
// integer operations a word, which made the 16-byte phases of the exchange
// compute-bound.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace wire {

// The wire codes (stencil_tpu_torch/ops/halo_fill.py WIRE_CODES).
constexpr int NONE = 0;
constexpr int BF16 = 1;
constexpr int F16 = 2;
constexpr int E4M3 = 3;
constexpr int F32 = 4;  // fp64 data only

__device__ __forceinline__ float from_e4m3(__nv_fp8_storage_t v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v, __NV_E4M3)));
}

// fp32 x through e4m3fn: one rounding to nearest even, and NaN past 464 or
// for a value that is not finite (the clamp of satfinite never applies).
__device__ __forceinline__ float e4m3(float x) {
  const float r = from_e4m3(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
  return fabsf(x) <= 464.0f ? r : __int_as_float(0x7fc00000);
}

// fp64 x to fp32 by round-to-odd: exact, or the truncation with its last bit
// set, so a later rounding to at most 22 bits rounds x once.
__device__ __forceinline__ float to_odd(double x) {
  const float t = __double2float_rz(x);
  return (double)t == x ? t : __uint_as_float(__float_as_uint(t) | 1u);
}

// x narrowed to wire W and widened back.
template <int W>
__device__ __forceinline__ float narrow(float x) {
  static_assert(W == BF16 || W == F16 || W == E4M3, "a wire narrower than fp32");
  if constexpr (W == BF16) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (W == F16) return __half2float(__float2half_rn(x));
  else return e4m3(x);
}

template <int W>
__device__ __forceinline__ double narrow(double x) {
  static_assert(W == F32 || W == BF16 || W == F16 || W == E4M3, "a wire narrower than fp64");
  if constexpr (W == F32) return (double)__double2float_rn(x);
  else if constexpr (W == BF16)
    return (double)__bfloat162float(__float2bfloat16_rn(__double2float_rn(x)));
  else if constexpr (W == F16) return (double)__half2float(__double2half(x));
  else return fabs(x) <= 464.0 ? (double)e4m3(to_odd(x)) : (double)__int_as_float(0x7fc00000);
}

template <int W>
__device__ __forceinline__ float4 narrow(float4 v) {
  return make_float4(narrow<W>(v.x), narrow<W>(v.y), narrow<W>(v.z), narrow<W>(v.w));
}

// The same on a word's bits: unsigned int holds an fp32 word, unsigned long
// long an fp64 word.
template <int W>
__device__ __forceinline__ unsigned int narrow_bits(unsigned int b) {
  return __float_as_uint(narrow<W>(__uint_as_float(b)));
}

template <int W>
__device__ __forceinline__ unsigned long long narrow_bits(unsigned long long b) {
  return (unsigned long long)__double_as_longlong(narrow<W>(__longlong_as_double((long long)b)));
}

// Every word of a unit of words T: one word, or a 16-byte vector.
template <typename T, int W>
__device__ __forceinline__ T narrow_unit(T v) {
  return narrow_bits<W>(v);
}

template <typename T, int W>
__device__ __forceinline__ uint4 narrow_unit(uint4 v) {
  if constexpr (sizeof(T) == 4) {
    v.x = narrow_bits<W>(v.x);
    v.y = narrow_bits<W>(v.y);
    v.z = narrow_bits<W>(v.z);
    v.w = narrow_bits<W>(v.w);
  } else {
    const unsigned long long a = narrow_bits<W>(((unsigned long long)v.y << 32) | v.x);
    const unsigned long long b = narrow_bits<W>(((unsigned long long)v.w << 32) | v.z);
    v.x = (unsigned int)a;
    v.y = (unsigned int)(a >> 32);
    v.z = (unsigned int)b;
    v.w = (unsigned int)(b >> 32);
  }
  return v;
}

}  // namespace wire
