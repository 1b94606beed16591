// The threefry2x32 stream of jax.random (jax_threefry_partitionable=True)
// and its float32 / int32 samplers as device functions, shared by K5
// (csrc/rng.cu) and K3 (csrc/seeding.cu).
//
// Each function follows its plain twin in rng.py operation by operation,
// so a draw is bit-equal to the twin's on the same key and counter:
// - bits at counter i: the 20-round block on (i >> 32, i & 0xffffffff),
//   output y0 ^ y1 (uint32 arithmetic wraps as the twin's & MASK does);
// - uniform: the mantissa trick, then XLA-CPU's fused multiply-add as the
//   twin emulates it: a float64 product and a float64 add of the float32
//   value, rounded once to float32 (not one __fmaf_rn), then max with lo;
//   lo and span come from the host as the twin computes them (on [0, 1)
//   that is the mantissa trick alone, tf_uniform01);
// - normal: XLA's float32 erf_inv polynomial with CUDA's log1pf (as
//   torch's CUDA kernel calls it) and the same emulated Horner steps, times
//   float32(sqrt(2));
// - randint: two streams from host-split keys and the host's multiplier.
// Built with -fmad=false (kernels/build.py): no float32 operation here is
// contracted into a fused multiply-add, as none of the twin's separate
// torch kernels are.

#pragma once

#include <math.h>
#include <stdint.h>

struct TfKey {
  uint32_t k0, k1;
};

__device__ __forceinline__ void tf_mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = ((x1 << r) | (x1 >> (32 - r))) ^ x0;
}

// rng.threefry2x32: five groups of four rounds with the key injections
__device__ __forceinline__ void threefry2x32(const TfKey k, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks0 = k.k0, ks1 = k.k1, ks2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += ks0;
  x1 += ks1;
  tf_mix(x0, x1, 13); tf_mix(x0, x1, 15); tf_mix(x0, x1, 26); tf_mix(x0, x1, 6);
  x0 += ks1; x1 += ks2 + 1u;
  tf_mix(x0, x1, 17); tf_mix(x0, x1, 29); tf_mix(x0, x1, 16); tf_mix(x0, x1, 24);
  x0 += ks2; x1 += ks0 + 2u;
  tf_mix(x0, x1, 13); tf_mix(x0, x1, 15); tf_mix(x0, x1, 26); tf_mix(x0, x1, 6);
  x0 += ks0; x1 += ks1 + 3u;
  tf_mix(x0, x1, 17); tf_mix(x0, x1, 29); tf_mix(x0, x1, 16); tf_mix(x0, x1, 24);
  x0 += ks1; x1 += ks2 + 4u;
  tf_mix(x0, x1, 13); tf_mix(x0, x1, 15); tf_mix(x0, x1, 26); tf_mix(x0, x1, 6);
  x0 += ks2; x1 += ks0 + 5u;
}

// rng.bits: element i of a stream of any shape (row-major counter)
__device__ __forceinline__ uint32_t tf_bits(const TfKey k, uint64_t i) {
  uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
  threefry2x32(k, x0, x1);
  return x0 ^ x1;
}

// rng.uniform, with lo = float32(minval) and span = float32(hi - lo)
__device__ __forceinline__ float tf_uniform(const TfKey k, uint64_t i,
                                            double lo, double span) {
  const float f = __int_as_float((int)((tf_bits(k, i) >> 9) | 0x3F800000u))
                  - 1.0f;
  const float x = __double2float_rn(__dadd_rn(__dmul_rn((double)f, span),
                                              lo));
  return fmaxf(x, (float)lo);
}

// rng.uniform on [0, 1) (lo 0, span 1), the Fourier draw's: the mantissa
// trick alone.  tf_uniform's emulated multiply-add is then float(double(f)
// * 1.0 + 0.0) with f a float32 in [0, 1): the product and the sum are
// exact in float64 and round back to f, and max(f, 0) is f, so the two
// are equal bit for bit without the float64 work and the conversions
__device__ __forceinline__ float tf_uniform01(const TfKey k, uint64_t i) {
  return __int_as_float((int)((tf_bits(k, i) >> 9) | 0x3F800000u)) - 1.0f;
}

// rng.erf_inv_f32: the float32 rounding of rng.py's coefficients, written
// exactly (tests/test_torch_rng.py checks them against rng.py)
__device__ __forceinline__ float tf_erf_inv(float x) {
  const float c_lt[9] = {0x1.e2cb1p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
                         -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
                         -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
  const float c_ge[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                         -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f,
                         0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? c_lt[0] : c_ge[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) {
    const double c = (double)(lt ? c_lt[j] : c_ge[j]);
    p = __double2float_rn(__dadd_rn(__dmul_rn((double)p, (double)w), c));
  }
  const float out = p * x;
  return fabsf(x) == 1.0f ? x * INFINITY : out;
}

#define TF_SQRT2_F32 0x1.6a09e6p+0f

// rng.normal: lo and span of the uniform on [nextafter(-1, 0), 1)
__device__ __forceinline__ float tf_normal(const TfKey k, uint64_t i,
                                           double lo, double span) {
  return TF_SQRT2_F32 * tf_erf_inv(tf_uniform(k, i, lo, span));
}

// rng.randint on [minval, minval + span): k1, k2 = split(key), mult
// = (2**16 % span)**2 % span
__device__ __forceinline__ int32_t tf_randint(const TfKey k1, const TfKey k2,
                                              uint64_t i, uint32_t span,
                                              uint32_t mult, int64_t minval) {
  const uint32_t hi = tf_bits(k1, i), lo = tf_bits(k2, i);
  const uint32_t off = (hi % span) * mult + lo % span;
  return (int32_t)(minval + (int64_t)(off % span));
}
