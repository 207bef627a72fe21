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
// The rounding of each (data, wire) pair is the JAX package's `astype` under
// jax.jit, and the wire is a format of halo_fill.WIRE_FORMATS:
//   - fp32 -> bf16 and fp32 -> fp16: round to nearest even (cvt.rn);
//   - fp32 and fp64 -> fp8 e4m3fn: round to nearest even once from the
//     value, and a value past 464 (448 + half its ulp) or not finite becomes
//     NaN (e4m3fn has no inf, and saturation is not the JAX rule). The card
//     converts fp32 by cvt.rn.satfinite.e4m3x2.f32, which rounds once and
//     clamps, and the NaN rule is applied beside it; fp64 first rounds to
//     fp32 by round-to-odd (toward zero, then the last bit set if inexact),
//     which keeps the later rounding to fp8's 4 bits a single rounding of
//     the fp64 value (fp32 carries more than 2 extra bits);
//   - fp32 and fp64 -> fp8 e5m2: the same by cvt.rn.satfinite.e5m2x2.f32,
//     and a value from 61440 (57344 + half its ulp, the tie that rounds up)
//     or infinite becomes +-inf, NaN stays NaN;
//   - fp64 -> fp32: cvt.rn; fp64 -> fp16: one rounding (cvt.rn.f16.f64);
//   - fp64 -> bf16: through fp32, two roundings, as XLA does it;
//   - every other format (the card has no conversion for it: fp8 e4m3fnuz,
//     e5m2fnuz, e4m3b11fnuz, e3m4, e4m3 and e8m0fnu, fp4 e2m1fn) is one
//     instantiation, SOFT, that rounds by the launch's Format, in the data's
//     own precision (exact scalings by powers of two and one rint), to
//     nearest even at the quantum of the value's binade or the subnormal
//     quantum below the least normal, then the format's rules for overflow
//     (inf, NaN or saturation),
//     zero, NaN and an exponent-only format; halo_fill._round_format is its
//     plain version, the same arithmetic on the same parameters.
// IEEE subnormals are kept (the library builds with -ftz=false), where XLA
// on the CPU flushes an fp64 -> fp32 or -> bf16 result below fp32's least
// normal to zero (ROADMAP.md queue C, "Design divergences").
//
// Cost: a few instructions a word for the card's conversions, against a
// word's load and store; SOFT's arithmetic is a dozen (PERF.md section 6
// times both). (The first form took cuda_fp8.hpp's exact software
// conversion for e4m3, tens of integer operations a word, which made the
// 16-byte phases of the exchange compute-bound.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace wire {

// The wire codes (stencil_tpu_torch/ops/halo_fill.py WIRE_FORMATS).
constexpr int NONE = 0;
constexpr int BF16 = 1;
constexpr int F16 = 2;
constexpr int E4M3 = 3;
constexpr int F32 = 4;  // fp64 data only
constexpr int E5M2 = 5;
constexpr int SOFT = 6;  // any other format, by the launch's Format

// A format SOFT rounds into (halo_fill.wire_params, halo_fill.WireFormat):
// stored mantissa bits, least normal exponent, largest finite value, what a
// value past it becomes (inf, NaN or the largest value), what a NaN becomes,
// and the least value of an exponent-only format (no sign, no zero).
// Each value is kept as a double and as a float (all are exact in fp32).
struct Format {
  double top, over, nan_out, least;
  float topf, overf, nanf, leastf;
  int mant, emin, signed_zero, exp_only;

  // From halo_fill.WIRE_PARAMS doubles (null: no format).
  static Format from(const double* p) {
    Format f{};
    if (p) {
      f.mant = (int)p[0];
      f.emin = (int)p[1];
      f.top = p[2];
      f.over = p[3];
      f.nan_out = p[4];
      f.least = p[5];
      f.signed_zero = p[6] != 0.0;
      f.exp_only = p[7] != 0.0;
      f.topf = (float)f.top;
      f.overf = (float)f.over;
      f.nanf = (float)f.nan_out;
      f.leastf = (float)f.least;
    }
    return f;
  }
};

__device__ __forceinline__ float from_e4m3(__nv_fp8_storage_t v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v, __NV_E4M3)));
}

__device__ __forceinline__ float from_e5m2(__nv_fp8_storage_t v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v, __NV_E5M2)));
}

// fp32 x through e4m3fn: one rounding to nearest even, and NaN past 464 or
// for a value that is not finite (the clamp of satfinite never applies).
__device__ __forceinline__ float e4m3(float x) {
  const float r = from_e4m3(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
  return fabsf(x) <= 464.0f ? r : __int_as_float(0x7fc00000);
}

// fp32 x through e5m2: one rounding to nearest even, and +-inf from 61440 or
// for +-inf (x times inf, which keeps a NaN a NaN).
__device__ __forceinline__ float e5m2(float x) {
  const float r = from_e5m2(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E5M2));
  return fabsf(x) < 61440.0f ? r : x * __int_as_float(0x7f800000);
}

// fp64 x to fp32 by round-to-odd: exact, or the truncation with its last bit
// set, so a later rounding to at most 22 bits rounds x once.
__device__ __forceinline__ float to_odd(double x) {
  const float t = __double2float_rz(x);
  return (double)t == x ? t : __uint_as_float(__float_as_uint(t) | 1u);
}

// fp32 x through format f, in one rounding, in fp32 registers: the quantum
// of x's binade (its exponent clamped at emin) is 2^(e - mant), and x is
// scaled by its inverse in two exact steps, 2^k1 then 2^(k - k1), so that
// neither factor leaves the normal range (e8m0's 2^-127 would).
__device__ __forceinline__ float soft(float x, const Format& f) {
  const float a = fabsf(x);
  const int e = max((int)(__float_as_uint(a) >> 23) - 127, f.emin);  // 128: inf or NaN
  const int k = f.mant - e, k1 = k >> 1;
  const float q = __int_as_float((e - f.mant + 127) << 23);  // inf for e8m0 at 128
  const float s = a * __int_as_float((k1 + 127) << 23) * __int_as_float((k - k1 + 127) << 23);
  float r = rintf(s) * q;  // half to even; inf stays inf, NaN NaN
  if (r > f.topf) r = f.overf;
  if (f.exp_only) {
    if (r == 0.0f) r = f.leastf;
    return x > 0.0f ? r : __int_as_float(0x7fc00000);
  }
  r = copysignf(r, x);
  if (!f.signed_zero && r == 0.0f) r = 0.0f;
  return x == x ? r : f.nanf;
}

// fp64 x through format f, in one rounding, in fp64 registers. The binade's
// exponent is clamped to [emin, 1000], so the quantum and its inverse are
// normal doubles: every value from 2^1000 on overflows every format. An
// exponent-only format has no zero: below its least value, fp64 data is
// NaN (fp32 data, whose subnormals round to zero there, the least value).
__device__ __forceinline__ double soft(double x, const Format& f) {
  const double a = fabs(x);
  const int b = (int)(__double_as_longlong(a) >> 52) - 1023;
  const int e = min(max(b, f.emin), 1000);
  const double q = __longlong_as_double((long long)(e - f.mant + 1023) << 52);
  const double iq = __longlong_as_double((long long)(1023 - e + f.mant) << 52);
  double r = rint(a * iq) * q;  // half to even; inf stays inf, NaN NaN
  if (r > f.top) r = f.over;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  if (f.exp_only) {
    if (r == 0.0) r = a < f.least ? nan : f.least;
    return x > 0.0 ? r : nan;
  }
  r = copysign(r, x);
  if (!f.signed_zero && r == 0.0) r = 0.0;
  return x == x ? r : f.nan_out;
}

// x narrowed to wire W and widened back.
template <int W>
__device__ __forceinline__ float narrow(float x, const Format& f) {
  static_assert(W == BF16 || W == F16 || W == E4M3 || W == E5M2 || W == SOFT,
                "a wire narrower than fp32");
  if constexpr (W == BF16) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (W == F16) return __half2float(__float2half_rn(x));
  else if constexpr (W == E4M3) return e4m3(x);
  else if constexpr (W == E5M2) return e5m2(x);
  else return soft(x, f);
}

template <int W>
__device__ __forceinline__ double narrow(double x, const Format& f) {
  static_assert(W == F32 || W == BF16 || W == F16 || W == E4M3 || W == E5M2 || W == SOFT,
                "a wire narrower than fp64");
  if constexpr (W == F32) return (double)__double2float_rn(x);
  else if constexpr (W == BF16)
    return (double)__bfloat162float(__float2bfloat16_rn(__double2float_rn(x)));
  else if constexpr (W == F16) return (double)__half2float(__double2half(x));
  else if constexpr (W == E4M3)
    return fabs(x) <= 464.0 ? (double)e4m3(to_odd(x)) : (double)__int_as_float(0x7fc00000);
  else if constexpr (W == E5M2)
    return fabs(x) < 61440.0 ? (double)e5m2(to_odd(x)) : x * __longlong_as_double(0x7ff0000000000000LL);
  else return soft(x, f);
}

template <int W>
__device__ __forceinline__ float4 narrow(float4 v, const Format& f) {
  return make_float4(narrow<W>(v.x, f), narrow<W>(v.y, f), narrow<W>(v.z, f),
                     narrow<W>(v.w, f));
}

// The same on a word's bits: unsigned int holds an fp32 word, unsigned long
// long an fp64 word.
template <int W>
__device__ __forceinline__ unsigned int narrow_bits(unsigned int b, const Format& f) {
  return __float_as_uint(narrow<W>(__uint_as_float(b), f));
}

template <int W>
__device__ __forceinline__ unsigned long long narrow_bits(unsigned long long b, const Format& f) {
  return (unsigned long long)__double_as_longlong(
      narrow<W>(__longlong_as_double((long long)b), f));
}

// Every word of a unit of words T: one word, or a 16-byte vector.
template <typename T, int W>
__device__ __forceinline__ T narrow_unit(T v, const Format& f) {
  return narrow_bits<W>(v, f);
}

template <typename T, int W>
__device__ __forceinline__ uint4 narrow_unit(uint4 v, const Format& f) {
  if constexpr (sizeof(T) == 4) {
    v.x = narrow_bits<W>(v.x, f);
    v.y = narrow_bits<W>(v.y, f);
    v.z = narrow_bits<W>(v.z, f);
    v.w = narrow_bits<W>(v.w, f);
  } else {
    const unsigned long long a = narrow_bits<W>(((unsigned long long)v.y << 32) | v.x, f);
    const unsigned long long b = narrow_bits<W>(((unsigned long long)v.w << 32) | v.z, f);
    v.x = (unsigned int)a;
    v.y = (unsigned int)(a >> 32);
    v.z = (unsigned int)b;
    v.w = (unsigned int)(b >> 32);
  }
  return v;
}

}  // namespace wire
