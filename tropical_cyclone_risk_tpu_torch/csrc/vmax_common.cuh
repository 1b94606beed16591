// The vmax of one track sample, shared by K2's post-pass and last-sample
// entries (csrc/vmax.cu) and K1's in-scan diagnostic (csrc/integrator.cu),
// so that the three compute a sample with the same code.
//
// It is models/diagnostics.py _translation_tm and vmax_step on one sample
// as the twin's torch kernels compute them on the card, operation for
// operation (built with -fmad=false): the degenerate zonal and meridional
// haversines of the centred difference, the G-scaled translation plus the
// shear asymmetry, and the closed form v + min(|inc|, v / 2).  torch divides
// a tensor by a Python number as a product with the float32 reciprocal of
// that number, so the divisions by 10, 15 and the output interval are
// products with those reciprocals here too.
#pragma once

#include <math.h>

#include "sincos.cuh"

namespace vmaxc {

// the float32 reciprocals torch multiplies by for / 10.0 and / 15.0
constexpr float kInv10 = 1.0f / 10.0f;
constexpr float kInv15 = 1.0f / 15.0f;

// float32 roundings of the twin's constants: 1 / output interval (s), twice
// the earth radius in km, pi / 180
struct Consts {
  float inv_dt, km2, deg2rad;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
// torch.sign: 0 for a zero or NaN difference
__device__ __forceinline__ float sgn(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

// vmax at latitude lat, intensity v, with the neighbours b (before) and a
// (after) and the deep-layer shear (u_shr, v_shr) = 250 - 850 hPa winds
__device__ __forceinline__ float vmax_at(const Consts& c, float lat,
                                         float b_lon, float b_lat,
                                         float a_lon, float a_lat, float v,
                                         float u_shr, float v_shr) {
  const float s = sincos_rad(lat * c.deg2rad, 1) *
                  fabsf(sincos_rad((b_lon * c.deg2rad - a_lon * c.deg2rad) *
                                   0.5f, 0));
  const float s2 = s * s;
  const float hav_lon =
      c.km2 * (s * (1.0f + s2 * (0.16666666666666666f + s2 * 0.075f)));
  const float hav_lat =
      c.km2 * fabsf((b_lat * c.deg2rad - a_lat * c.deg2rad) * 0.5f);
  const float ut = ((0.5f * (sgn(a_lon - b_lon) * hav_lon)) * 1000.0f) *
                   c.inv_dt;
  const float vt = ((0.5f * (sgn(a_lat - b_lat) * hav_lat)) * 1000.0f) *
                   c.inv_dt;
  const float G =
      nan_min(0.8f + 0.35f * (1.0f + tanhf((lat - 35.0f) * kInv10)), 1.0f);
  const float U = G * ut + ((0.1f * u_shr) * v) * kInv15;
  const float V = G * vt + ((0.1f * v_shr) * v) * kInv15;
  const float mag = sqrtf(U * U + V * V);
  return v + nan_min(mag, 0.5f * v);
}

}  // namespace vmaxc
