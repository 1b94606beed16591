// K6: potential intensity (CAPE-PI) per column for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA-fused function of the JAX package (there is no Pallas
// kernel to translate; XLA fused these jnp functions over the whole grid):
//   ops/pi.py:92 cape_pi, in its default configuration (select_thermo=1,
//   select_interp=2: the pseudoadiabatic parcel and the 2-D entropy
//   table), with ops/thermo.py sat_thermo, s_unsat, s_sat, get_LCL,
//   lambertw_m1, calc_T_rho and ops/interp.py bilinear_scalar inlined.
// Its plain PyTorch twin is ops/pi.py cape_pi_plain.
//
// Work layout: one thread per column.  The thread walks the L levels once,
// surface first, and keeps only what the next level needs: the running
// CAPE sums of both parcels, the level index and partial sum at the last
// buoyant level seen so far, and the previous level's density
// temperatures, environment temperature and pressure, from which the
// sub-grid outflow correction of the pair (last buoyant level, next level)
// is formed when the walk reaches the next level.  So CAPE "up to the last
// buoyant level" needs no second pass: it is the partial sum recorded at
// that level.  The first condensing level (the dry/moist switch of the
// lifted parcel) is a flag that turns on at the first level above the LCL.
//
// What bounds it on this card: the bytes of the two [L, columns] profiles
// (each read once, neighbouring threads on neighbouring columns) against
// ~30 float32 operations, two table lookups and up to three exp/pow per
// level; see chip_smoke.py for the bound it is held to.  The 160 KB table
// is read through the read-only cache (__ldg); moving it to shared memory
// is a later change.
//
// Numerics: built without --use_fast_math and with -fmad=false, so every
// operation rounds as the separate torch kernels of the plain twin do; the
// transcendentals are CUDA's own expf/logf/powf/sqrtf, which torch's CUDA
// kernels also call.  Each expression keeps the twin's (and the JAX
// package's) operation order, each constant is the float32 rounding the
// twin uses (a parameter block filled on the host), and min/max/clamp
// propagate NaN as torch and XLA do (fminf/fmaxf drop NaN), so land
// columns (SST 0 K) and columns never buoyant end as the twin's do.
//
// The C entry returns cudaGetLastError() after the launch; the wrapper
// (kernels/cape_pi.py) raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  // ops/thermo.py sat_thermo (Bolton)
  float t0c, es0, a17, b243, x_max, rd_rv;
  // entropies and density temperature
  float eps, cp, Rd, Rv, L0, floor_tiny;
  // get_LCL: cpv, (cvl - cpv) / Rv, -(E0v - (cvv - cvl) T_trip)
  float lcl_cpv, lcl_a0, lcl_b0;
  // lambertw_m1: e, 11/72, the log floor, the series/asymptotic switch
  float e, c11_72, log_floor, w_switch;
  // cape_pi: the dry-adiabat exponent Rd/cp and Ck/Cd
  float rd_cp, cecd;
  // entropy table: s along the fast axis, p along the slow one
  float s0, ds, p0, dp;
  int ns, np_, L, n_col;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return nan_min(nan_max(x, lo), hi);
}
__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? 3.402823466e38f : -3.402823466e38f;
  return x;
}

// thermo.sat_thermo: (es, rs)
__device__ __forceinline__ float sat_es(const Params& P, float T) {
  const float T_c = T - P.t0c;
  return P.es0 * expf(nan_min((P.a17 * T_c) / (T_c + P.b243), P.x_max));
}
__device__ __forceinline__ float sat_rs(const Params& P, float es, float p) {
  return (P.rd_rv * es) / (p - es);
}

// thermo.s_unsat, select_thermo=1 (r_t unused)
__device__ float s_unsat(const Params& P, float T, float p, float r) {
  const float es = sat_es(P, T);
  const float rs = sat_rs(P, es, p);
  const float rh = nan_max(((r / rs) * (1.0f + rs / P.eps)) /
                               (1.0f + r / P.eps), 0.0f);
  return ((P.cp * logf(T) - P.Rd * logf(p - es * rh)) + (P.L0 * r) / T) -
         (r * P.Rv) * logf(rh);
}

// thermo.s_sat, select_thermo=1, Bolton saturation
__device__ float s_sat(const Params& P, float T, float p) {
  const float es = sat_es(P, T);
  const float rs = sat_rs(P, es, p);
  const float Tm = nan_max(T, P.floor_tiny);
  const float log_pd = logf(nan_max(p - es, P.floor_tiny));
  return (P.cp * logf(Tm) - P.Rd * log_pd) + (P.L0 * rs) / Tm;
}

// thermo.lambertw_m1
__device__ float lambertw_m1(const Params& P, float x) {
  const float p = sqrtf(nan_max(2.0f * (1.0f + P.e * x), 0.0f));
  const float w_series = ((-1.0f - p) - (p * p) / 3.0f) - P.c11_72 * (p * p * p);
  const float L1 = logf(-x);
  const float L2 = logf(nan_max(-L1, P.log_floor));
  const float w_asym = (L1 - L2) + L2 / L1;
  float w = (x > P.w_switch) ? w_asym : w_series;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const float ew = expf(w);
    const float f = w * ew - x;
    const float wp1 = w + 1.0f;
    const float denom = ew * wp1 - ((w + 2.0f) * f) / (2.0f * wp1);
    w = w - f / denom;
  }
  return w;
}

// thermo.get_LCL
__device__ float get_lcl(const Params& P, float p, float T, float r,
                         float rh) {
  const float q = r / (1.0f + r);
  const float Rm = (1.0f - q) * P.Rd + q * P.Rv;
  const float cpm = (1.0f - q) * P.cp + q * P.lcl_cpv;
  const float a = cpm / Rm + P.lcl_a0;
  const float b = P.lcl_b0 / (P.Rv * T);
  const float c = b / a;
  const float T_lcl = (c * T) / lambertw_m1(P, (powf(rh, 1.0f / a) * c) *
                                                   expf(c));
  return p * powf(T_lcl / T, cpm / Rm);
}

// thermo.calc_T_rho, select_thermo=1
__device__ __forceinline__ float t_rho(const Params& P, float T, float rv) {
  return (T * (1.0f + rv / P.eps)) / (1.0f + rv);
}

// interp._cell_and_weight: a NaN query reads cell 0 with a NaN weight
__device__ __forceinline__ int cell(float x, float x0, float dx, int n,
                                    float* w) {
  const float u = clampf((x - x0) / dx, 0.0f, (float)n - 1.0f);
  const float fi = clampf(floorf(u), 0.0f, (float)(n - 2));
  const int i = isnan(fi) ? 0 : (int)fi;
  *w = u - (float)i;
  return i;
}

// EntropyTable.lookup: interp.bilinear_scalar(T, grid, s, p)
__device__ float lookup(const Params& P, const float* __restrict__ table,
                        float p, float s) {
  float wx, wy;
  const int ix = cell(s, P.s0, P.ds, P.ns, &wx);
  const int iy = cell(p, P.p0, P.dp, P.np_, &wy);
  const int base = iy * P.ns + ix;
  const float c00 = __ldg(table + base), c01 = __ldg(table + base + 1);
  const float c10 = __ldg(table + base + P.ns);
  const float c11 = __ldg(table + base + P.ns + 1);
  return (1.0f - wy) * ((1.0f - wx) * c00 + wx * c01) +
         wy * ((1.0f - wx) * c10 + wx * c11);
}

// pi.cape_pi outflow(): the sub-grid level of neutral buoyancy between the
// last buoyant level (1) and the next (2)
struct Outflow { float T_out, area; };
__device__ __forceinline__ Outflow outflow(const Params& P, float p1,
                                           float p2, float dT1, float dT2,
                                           float Te1, float Te2) {
  const float p_out = (p1 * dT2 - p2 * dT1) / (dT2 - dT1);
  Outflow o;
  o.T_out = (Te1 * (p_out - p2) + Te2 * (p1 - p_out)) / (p1 - p2);
  o.area = ((P.Rd * dT1) * (p1 - p_out)) / (p1 + p_out);
  return o;
}

__global__ void __launch_bounds__(128)
cape_pi_kernel(const Params P, const float* __restrict__ sst,
               const float* __restrict__ p_surf,
               const float* __restrict__ p_env,
               const float* __restrict__ T_env,
               const float* __restrict__ r_env,
               const float* __restrict__ table, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P.n_col) return;
  const int64_t n = P.n_col;
  const int L = P.L;

  const float sst_c = sst[c], ps = p_surf[c];
  const float T_ns = T_env[c], r_ns = r_env[c], p_ns = __ldg(p_env);

  const float rs = sat_rs(P, sat_es(P, sst_c), ps);
  const float rh = ((r_ns / rs) * (1.0f + rs / P.eps)) / (1.0f + r_ns / P.eps);
  const float s_ns = s_unsat(P, T_ns, p_ns, r_ns);
  const float ss = s_sat(P, sst_c, ps);
  const float pLCL = get_lcl(P, p_ns, T_ns, r_ns, rh);

  // the walk: running sums, the partial sum at the last buoyant level,
  // and the outflow of the pair (last buoyant level, the level above)
  float sum_a = 0.0f, sum_s = 0.0f, cape_a = 0.0f, cape_s = 0.0f;
  int out_a = -1, out_s = -1;
  float area_a = 0.0f, area_s = 0.0f, T_out_s = 0.0f;
  bool condensed = false;
  float lnp = logf(__ldg(p_env));
  float prev_p = 0.0f, prev_Te = 0.0f, prev_dTa = 0.0f, prev_dTs = 0.0f;
  bool prev_buoy_a = false, prev_buoy_s = false;
  for (int l = 0; l < L; ++l) {
    const float pl = __ldg(p_env + l);
    const float Te = T_env[l * n + c];
    const float re = r_env[l * n + c];
    const float Trho_env = t_rho(P, Te, re);

    // ascent of the lifted parcel: dry adiabat below the first
    // condensing level (the top level when none condenses), moist above
    condensed = condensed || (pLCL > pl) || (l == L - 1);
    float Ta, ra;
    if (!condensed) {
      Ta = T_ns * powf(pl / p_ns, P.rd_cp);
      ra = r_ns;
    } else {
      Ta = lookup(P, table, pl, s_ns);
      ra = sat_rs(P, sat_es(P, Ta), pl);
    }
    // the surface-saturated parcel: a moist adiabat from the surface
    const float Ts = lookup(P, table, pl, ss);
    const float rsp = sat_rs(P, sat_es(P, Ts), pl);
    const float Trho_a = t_rho(P, Ta, ra), Trho_s = t_rho(P, Ts, rsp);
    const float dTa = Trho_a - Trho_env, dTs = Trho_s - Trho_env;

    // -dlnp of jnp.diff(lnp, append=2 lnp[-1] - lnp[-2])
    float dlnp;
    if (l + 1 < L) {
      const float lnp_next = logf(__ldg(p_env + l + 1));
      dlnp = lnp_next - lnp;
      lnp = lnp_next;
    } else {
      dlnp = (2.0f * lnp - logf(__ldg(p_env + L - 2))) - lnp;
    }
    sum_a = sum_a + (P.Rd * dTa) * -dlnp;
    sum_s = sum_s + (P.Rd * dTs) * -dlnp;

    // the previous level was the last buoyant one so far: its outflow
    if (prev_buoy_a)
      area_a = outflow(P, prev_p, pl, prev_dTa, dTa, prev_Te, Te).area;
    if (prev_buoy_s) {
      const Outflow o = outflow(P, prev_p, pl, prev_dTs, dTs, prev_Te, Te);
      T_out_s = o.T_out;
      area_s = o.area;
    }
    prev_buoy_a = Trho_a >= Trho_env;
    prev_buoy_s = Trho_s >= Trho_env;
    if (prev_buoy_a) { out_a = l; cape_a = sum_a; }
    if (prev_buoy_s) { out_s = l; cape_s = sum_s; }
    prev_p = pl;
    prev_Te = Te;
    prev_dTa = dTa;
    prev_dTs = dTs;
  }
  // never buoyant: the top level, with every level summed
  if (out_a < 0) { out_a = L - 1; cape_a = sum_a; }
  if (out_s < 0) { out_s = L - 1; cape_s = sum_s; }
  // buoyant up to the top: no outflow correction, T_out undefined
  if (out_a == L - 1) area_a = 0.0f;
  if (out_s == L - 1) { area_s = 0.0f; T_out_s = __int_as_float(0x7fc00000); }

  float cape = nan_to_num(nan_max(cape_a + area_a, 0.0f));
  const float cape_diff = (cape_s + area_s) - cape;
  const float pi = sqrtf(nan_max(((P.cecd * sst_c) / T_out_s) * cape_diff,
                                 0.0f));
  out[c] = nan_to_num(pi);
}

}  // namespace

extern "C" int tc_cape_pi(const float* fparams, const int* iparams,
                          const float* sst, const float* p_surf,
                          const float* p_env, const float* T_env,
                          const float* r_env, const float* table, float* out,
                          void* stream) {
  Params P;
  const float* fp = fparams;
  P.t0c = *fp++; P.es0 = *fp++; P.a17 = *fp++; P.b243 = *fp++;
  P.x_max = *fp++; P.rd_rv = *fp++;
  P.eps = *fp++; P.cp = *fp++; P.Rd = *fp++; P.Rv = *fp++; P.L0 = *fp++;
  P.floor_tiny = *fp++;
  P.lcl_cpv = *fp++; P.lcl_a0 = *fp++; P.lcl_b0 = *fp++;
  P.e = *fp++; P.c11_72 = *fp++; P.log_floor = *fp++; P.w_switch = *fp++;
  P.rd_cp = *fp++; P.cecd = *fp++;
  P.s0 = *fp++; P.ds = *fp++; P.p0 = *fp++; P.dp = *fp++;
  const int* ip = iparams;
  P.ns = *ip++; P.np_ = *ip++; P.L = *ip++; P.n_col = *ip++;

  const int threads = 128;
  const int blocks = (P.n_col + threads - 1) / threads;
  cape_pi_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      P, sst, p_surf, p_env, T_env, r_env, table, out);
  return (int)cudaGetLastError();
}
