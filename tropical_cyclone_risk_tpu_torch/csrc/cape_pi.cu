// K6: potential intensity (CAPE-PI) per column for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA-fused function of the JAX package (there is no Pallas
// kernel to translate; XLA fused these jnp functions over the whole grid):
//   ops/pi.py:92 cape_pi, with ops/thermo.py sat_thermo, s_unsat, s_sat,
//   s_sat_der, invert_entropy_newton, get_LCL, lambertw_m1, calc_T_rho,
//   ops/pi.py EntropyTable(3).lookup and ops/interp.py bilinear_scalar
//   inlined.
// Its plain PyTorch twin is ops/pi.py cape_pi_plain.
//
// Modes (template arguments, so the default instance is the code of the
// default mode alone and no mode flag is tested inside the level walk):
//   THERMO  1: the pseudoadiabatic parcel (constant L0); 2: the reversible
//           one (cp + r_t cl, L(T) = Lv - (cpv - cl)(273.15 - T), the
//           density temperature over 1 + r_t), as select_thermo;
//   INV     kTable2: the (p, s) -> T table, bilinear (select_interp=2
//           with an EntropyTable, the default with THERMO 1);
//           kTable3: the (p, s, r_t) -> T table, two bilinear lookups on
//           the r_t slabs k and k+1 and a lerp (an EntropyTable3);
//           kNewton: 25 damped Newton steps on s_sat(T) = s from 250 K
//           (select_interp=1; no table).
// The thermo driver reaches (1, kTable2), (1, kNewton), (2, kNewton) and
// (2, kTable3); the other two are reachable through ops/pi.py cape_pi.
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
// lifted parcel) is a flag that turns on at the first level above the LCL;
// below it the lifted parcel's inversion is not made (the twin computes it
// and discards it).
//
// What bounds it on this card: not the bytes of the two [L, columns]
// profiles (each read once, neighbouring threads on neighbouring columns)
// but the instructions it issues: built with -fmad=false and without fast
// math, each IEEE division, logf, expf and powf costs tens of them.  So
// the work that depends on the level alone or on the column alone leaves
// the walk: a block prologue computes once per level, into shared memory,
// the pressure, -dlnp, the dry-adiabat factor (pl / p_ns)^(Rd/cp) (p_ns is
// the first level's pressure, the same for every column) and the table's
// pressure cell and weights; each column computes once, per parcel (the
// lifted one from s_ns and r_ns, the saturated one from ss and rs), the
// entropy cell and weights, the 3-D table's r_t slab and weight,
// cp + r_t cl and 1 + r_t.  The walk keeps what truly changes per level:
// the environment's density temperature, the two inversions, the parcels'
// saturation formulas, the sums and the outflow pair.  A Newton inversion
// depends on the level and the column both and cannot be hoisted: 25
// steps of two logf, one expf and seven IEEE divisions; s_sat and
// s_sat_der share one saturation formula at the same (T, p), as the twin
// computes both from the same floats.
//
// Work layout on the card: 128 threads per block, one level per loop
// iteration, the 160 KB (2-D) or 2.56 MB (3-D) entropy table read through
// the read-only cache (__ldg).  256 threads per block, two levels per
// iteration and the 2-D table staged in shared memory were each timed
// against this in one call on the card, and none was faster (PERF.md).
//
// Numerics: built without --use_fast_math and with -fmad=false, so every
// operation rounds as the separate torch kernels of the plain twin do; the
// transcendentals are CUDA's own expf/logf/powf/sqrtf, which torch's CUDA
// kernels also call.  Each expression keeps the twin's (and the JAX
// package's) operation order, each constant is the float32 rounding the
// twin uses (a parameter block filled on the host), and min/max/clamp
// propagate NaN as torch and XLA do (fminf/fmaxf drop NaN), so land
// columns (SST 0 K) and columns never buoyant end as the twin's do.  The
// hoisted values are the same operations on the same operands as the ones
// they replace (1 - w included), so the result is bit-exact by
// construction; tests/test_torch_cape_pi_design.py emulates this order in
// torch for every mode and holds it against the twin bit for bit.
//
// The C entry returns cudaGetLastError() after the launch; the wrapper
// (kernels/cape_pi.py) raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the inversion of the moist adiabat (template argument INV)
constexpr int kTable2 = 0, kTable3 = 1, kNewton = 2;

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
  // the reversible branch: Lv, cpv - cl, 273.15, cl, cpv
  float Lv, cpv_cl, t_lat, cl, cpv;
  // invert_entropy_newton: L0^2, T0, the step's and T's clamps
  float L0sq, T0, step_lo, step_hi, T_lo, T_hi;
  // the 3-D table's r_t axis
  float rt0, drt;
  int ns, np_, L, n_col, nrt, iters;
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

// thermo._latent: the reversible branch's latent heat at T
__device__ __forceinline__ float latent(const Params& P, float T) {
  return P.Lv - P.cpv_cl * (P.t_lat - T);
}

// thermo.s_unsat; a_rt = cp + cl r_t (THERMO 2)
template <int THERMO>
__device__ float s_unsat(const Params& P, float T, float p, float r,
                         float a_rt) {
  const float es = sat_es(P, T);
  const float rs = sat_rs(P, es, p);
  const float rh = nan_max(((r / rs) * (1.0f + rs / P.eps)) /
                               (1.0f + r / P.eps), 0.0f);
  if constexpr (THERMO == 1)
    return ((P.cp * logf(T) - P.Rd * logf(p - es * rh)) + (P.L0 * r) / T) -
           (r * P.Rv) * logf(rh);
  else
    return ((a_rt * logf(T) - P.Rd * logf(p - es * rh)) +
            (latent(P, T) * r) / T) - (r * P.Rv) * logf(rh);
}

// thermo.s_sat, Bolton saturation; a_rt = cp + r_t cl (THERMO 2)
template <int THERMO>
__device__ float s_sat(const Params& P, float T, float p, float a_rt) {
  const float es = sat_es(P, T);
  const float rs = sat_rs(P, es, p);
  const float Tm = nan_max(T, P.floor_tiny);
  const float log_pd = logf(nan_max(p - es, P.floor_tiny));
  if constexpr (THERMO == 1)
    return (P.cp * logf(Tm) - P.Rd * log_pd) + (P.L0 * rs) / Tm;
  else
    return (a_rt * logf(Tm) - P.Rd * log_pd) + (latent(P, Tm) * rs) / Tm;
}

// thermo.invert_entropy_newton (use_pog=False): T with s_sat(T, p, r_t)
// = s_ref.  T stays in [T_lo, T_hi] = [40, 400] K (or NaN) from T0 = 250 K
// on, so s_sat's clamp of T at 1e-4 K is the identity and s_sat and
// s_sat_der read the same T, es and rs
template <int THERMO>
__device__ float newton(const Params& P, float p, float s_ref, float r_t,
                        float a_rt) {
  float T = P.T0;
  // one step per loop iteration (chip_smoke.py counts its SASS by pipe)
#pragma unroll 1
  for (int it = 0; it < P.iters; ++it) {
    const float es = sat_es(P, T);
    const float rs = sat_rs(P, es, p);
    const float log_pd = logf(nan_max(p - es, P.floor_tiny));
    const float moist = 1.0f - rs / P.eps;
    float s, der;
    if constexpr (THERMO == 1) {
      s = (P.cp * logf(T) - P.Rd * log_pd) + (P.L0 * rs) / T;
      der = (1.0f / T) *
            (P.cp + (((P.L0sq * rs) / P.Rv) / (T * T)) * moist);
    } else {
      const float lat = latent(P, T);
      s = (a_rt * logf(T) - P.Rd * log_pd) + (lat * rs) / T;
      der = (1.0f / T) *
            (((P.cp + P.cpv * rs) + P.cl * (r_t - rs)) +
             ((((lat * lat) * rs) / P.Rv) / (T * T)) * moist);
    }
    const float step = clampf((s - s_ref) / der, P.step_lo, P.step_hi);
    T = clampf(T - step, P.T_lo, P.T_hi);
  }
  return T;
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

// thermo.calc_T_rho of the environment (rt = rv in both branches)
__device__ __forceinline__ float t_rho(const Params& P, float T, float rv) {
  return (T * (1.0f + rv / P.eps)) / (1.0f + rv);
}

// thermo.calc_T_rho of a parcel: over 1 + rv (THERMO 1) or over the
// column's 1 + r_t (THERMO 2)
template <int THERMO>
__device__ __forceinline__ float parcel_t_rho(const Params& P, float T,
                                              float rv, float opr) {
  if constexpr (THERMO == 1)
    return t_rho(P, T, rv);
  else
    return (T * (1.0f + rv / P.eps)) / opr;
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

// what the walk needs of one level, the same for every column: the
// pressure, -dlnp, the dry-adiabat factor and the weight of the table's
// pressure cell (a), and 1 - that weight with the offset of the cell's
// first row (b)
struct Levels {
  const float4* a;   // pl, -dlnp, (pl / p_ns)^(Rd/cp), wy
  const float2* b;   // 1 - wy, iy * row (as int bits)
};

// the block prologue: one thread per level; the same operations, in the
// same order, as the walk made on every level of every column.  A table
// row holds ns values (2-D) or ns * nrt (3-D); Newton reads no table
template <int INV>
__device__ void level_prologue(const Params& P, const float* __restrict__ p_env,
                               float4* la, float2* lb) {
  const int L = P.L;
  const float p_ns = __ldg(p_env);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const float pl = __ldg(p_env + l);
    // -dlnp of jnp.diff(lnp, append=2 lnp[-1] - lnp[-2])
    const float lnp = logf(pl);
    float dlnp;
    if (l + 1 < L)
      dlnp = logf(__ldg(p_env + l + 1)) - lnp;
    else
      dlnp = (2.0f * lnp - logf(__ldg(p_env + L - 2))) - lnp;
    float wy = 0.0f;
    int iy = 0;
    if constexpr (INV != kNewton)
      iy = cell(pl, P.p0, P.dp, P.np_, &wy);
    const int row = INV == kTable3 ? P.ns * P.nrt : P.ns;
    la[l] = make_float4(pl, -dlnp, powf(pl / p_ns, P.rd_cp), wy);
    lb[l] = make_float2(1.0f - wy, __int_as_float(iy * row));
  }
}

// a parcel's column constants: its entropy and total water, and what its
// inversion needs of them
struct Parcel {
  float s, rt;       // entropy, total water
  float a_rt, opr;   // cp + r_t cl, 1 + r_t (THERMO 2)
  int ix;            // the tables' entropy cell and weights
  float wx, omwx;
  int off;           // the 3-D table: ix * nrt + the r_t slab k
  float wk;          // and the r_t weight
};

template <int THERMO, int INV>
__device__ __forceinline__ Parcel make_parcel(const Params& P, float s,
                                              float rt, float a_rt) {
  Parcel pc = {};
  pc.s = s;
  pc.rt = rt;
  if constexpr (THERMO == 2) {
    pc.a_rt = a_rt;
    pc.opr = 1.0f + rt;
  }
  if constexpr (INV != kNewton) {
    pc.ix = cell(s, P.s0, P.ds, P.ns, &pc.wx);
    pc.omwx = 1.0f - pc.wx;
  }
  if constexpr (INV == kTable3) {
    // EntropyTable3.lookup's r_t slab: cell() on the r_t axis
    const int k = cell(rt, P.rt0, P.drt, P.nrt, &pc.wk);
    pc.off = pc.ix * P.nrt + k;
  }
  return pc;
}

// interp.bilinear_scalar's blend of the four corners c[iy0 + d, ix0 + e]
// at offsets base, base + dx, base + dy, base + dy + dx
__device__ __forceinline__ float blend(const float* __restrict__ table,
                                       int base, int dx, int dy, float wy,
                                       float omwy, float wx, float omwx) {
  const float c00 = __ldg(table + base), c01 = __ldg(table + base + dx);
  const float c10 = __ldg(table + base + dy);
  const float c11 = __ldg(table + base + dy + dx);
  return omwy * (omwx * c00 + wx * c01) + wy * (omwx * c10 + wx * c11);
}

// the moist adiabat's temperature at a level (its pressure pl, the
// table's row offset iy_row and weights) for one parcel
template <int THERMO, int INV>
__device__ __forceinline__ float invert(const Params& P,
                                        const float* __restrict__ table,
                                        float pl, int iy_row, float wy,
                                        float omwy, const Parcel& pc) {
  if constexpr (INV == kTable2) {
    // EntropyTable.lookup: table [np, ns]
    return blend(table, iy_row + pc.ix, 1, P.ns, wy, omwy, pc.wx, pc.omwx);
  } else if constexpr (INV == kTable3) {
    // EntropyTable3.lookup: table [np, ns, nrt], slabs k and k + 1
    const int base = iy_row + pc.off, row = P.ns * P.nrt;
    const float lo = blend(table, base, P.nrt, row, wy, omwy, pc.wx,
                           pc.omwx);
    const float hi = blend(table, base + 1, P.nrt, row, wy, omwy, pc.wx,
                           pc.omwx);
    return lo + pc.wk * (hi - lo);
  } else {
    return newton<THERMO>(P, pl, pc.s, pc.rt, pc.a_rt);
  }
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

// one column's walk state and its per-column constants
struct Walk {
  // the column: the lifted parcel's start, its LCL and both parcels
  float T_ns, r_ns, pLCL;
  Parcel a, s;
  // the running sums, the partial sum at the last buoyant level and the
  // outflow of the pair (last buoyant level, the level above)
  float sum_a, sum_s, cape_a, cape_s, area_a, area_s, T_out_s;
  int out_a, out_s;
  bool condensed, prev_buoy_a, prev_buoy_s;
  float prev_p, prev_Te, prev_dTa, prev_dTs;
};

template <int THERMO, int INV>
__device__ __forceinline__ void walk_level(const Params& P, const Levels& lv,
                                           const float* __restrict__ table,
                                           const float* __restrict__ T_env,
                                           const float* __restrict__ r_env,
                                           int64_t n, int64_t c, int l,
                                           Walk& w) {
  const float4 la = lv.a[l];
  const float2 lb = lv.b[l];
  const float pl = la.x, neg_dlnp = la.y, dry = la.z, wy = la.w;
  const float omwy = lb.x;
  const int iy_row = __float_as_int(lb.y);
  const float Te = T_env[l * n + c];
  const float re = r_env[l * n + c];
  const float Trho_env = t_rho(P, Te, re);

  // ascent of the lifted parcel: dry adiabat below the first condensing
  // level (the top level when none condenses), moist above
  w.condensed = w.condensed || (w.pLCL > pl) || (l == P.L - 1);
  float Ta, ra;
  if (!w.condensed) {
    Ta = w.T_ns * dry;
    ra = w.r_ns;
  } else {
    Ta = invert<THERMO, INV>(P, table, pl, iy_row, wy, omwy, w.a);
    ra = sat_rs(P, sat_es(P, Ta), pl);
  }
  // the surface-saturated parcel: a moist adiabat from the surface
  const float Ts = invert<THERMO, INV>(P, table, pl, iy_row, wy, omwy, w.s);
  const float rsp = sat_rs(P, sat_es(P, Ts), pl);
  const float Trho_a = parcel_t_rho<THERMO>(P, Ta, ra, w.a.opr);
  const float Trho_s = parcel_t_rho<THERMO>(P, Ts, rsp, w.s.opr);
  const float dTa = Trho_a - Trho_env, dTs = Trho_s - Trho_env;

  w.sum_a = w.sum_a + (P.Rd * dTa) * neg_dlnp;
  w.sum_s = w.sum_s + (P.Rd * dTs) * neg_dlnp;

  // the previous level was the last buoyant one so far: its outflow
  if (w.prev_buoy_a)
    w.area_a = outflow(P, w.prev_p, pl, w.prev_dTa, dTa, w.prev_Te, Te).area;
  if (w.prev_buoy_s) {
    const Outflow o = outflow(P, w.prev_p, pl, w.prev_dTs, dTs, w.prev_Te,
                              Te);
    w.T_out_s = o.T_out;
    w.area_s = o.area;
  }
  w.prev_buoy_a = Trho_a >= Trho_env;
  w.prev_buoy_s = Trho_s >= Trho_env;
  if (w.prev_buoy_a) { w.out_a = l; w.cape_a = w.sum_a; }
  if (w.prev_buoy_s) { w.out_s = l; w.cape_s = w.sum_s; }
  w.prev_p = pl;
  w.prev_Te = Te;
  w.prev_dTa = dTa;
  w.prev_dTs = dTs;
}

constexpr int kThreads = 128;

template <int THERMO, int INV>
__global__ void __launch_bounds__(kThreads)
cape_pi_kernel(const Params P, const float* __restrict__ sst,
               const float* __restrict__ p_surf,
               const float* __restrict__ p_env,
               const float* __restrict__ T_env,
               const float* __restrict__ r_env,
               const float* __restrict__ table, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int L = P.L;
  float4* la = smem;
  float2* lb = reinterpret_cast<float2*>(la + L);
  level_prologue<INV>(P, p_env, la, lb);
  __syncthreads();
  const Levels lv = {la, lb};
  const int64_t n = P.n_col;
  const float p_ns = __ldg(p_env);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < n) {
    const float sst_c = sst[c], ps = p_surf[c];
    Walk w;
    w.T_ns = T_env[c];
    w.r_ns = r_env[c];
    const float rs = sat_rs(P, sat_es(P, sst_c), ps);
    const float rh = ((w.r_ns / rs) * (1.0f + rs / P.eps)) /
                     (1.0f + w.r_ns / P.eps);
    // cp + cl r_t of the two parcels (THERMO 2): r_ns and rs
    const float a_ns = P.cp + P.cl * w.r_ns, a_s = P.cp + rs * P.cl;
    const float s_ns = s_unsat<THERMO>(P, w.T_ns, p_ns, w.r_ns, a_ns);
    const float ss = s_sat<THERMO>(P, sst_c, ps, a_s);
    w.pLCL = get_lcl(P, p_ns, w.T_ns, w.r_ns, rh);
    w.a = make_parcel<THERMO, INV>(P, s_ns, w.r_ns, a_ns);
    w.s = make_parcel<THERMO, INV>(P, ss, rs, a_s);

    w.sum_a = w.sum_s = w.cape_a = w.cape_s = 0.0f;
    w.area_a = w.area_s = w.T_out_s = 0.0f;
    w.out_a = w.out_s = -1;
    w.condensed = w.prev_buoy_a = w.prev_buoy_s = false;
    w.prev_p = w.prev_Te = w.prev_dTa = w.prev_dTs = 0.0f;
    for (int l = 0; l < L; ++l)
      walk_level<THERMO, INV>(P, lv, table, T_env, r_env, n, c, l, w);

    // never buoyant: the top level, with every level summed
    if (w.out_a < 0) { w.out_a = L - 1; w.cape_a = w.sum_a; }
    if (w.out_s < 0) { w.out_s = L - 1; w.cape_s = w.sum_s; }
    // buoyant up to the top: no outflow correction, T_out undefined
    if (w.out_a == L - 1) w.area_a = 0.0f;
    if (w.out_s == L - 1) {
      w.area_s = 0.0f;
      w.T_out_s = __int_as_float(0x7fc00000);
    }

    const float cape = nan_to_num(nan_max(w.cape_a + w.area_a, 0.0f));
    const float cape_diff = (w.cape_s + w.area_s) - cape;
    const float pi = sqrtf(nan_max(((P.cecd * sst_c) / w.T_out_s) *
                                   cape_diff, 0.0f));
    out[c] = nan_to_num(pi);
  }
}

template <int THERMO, int INV>
int launch(const Params& P, const float* sst, const float* p_surf,
           const float* p_env, const float* T_env, const float* r_env,
           const float* table, float* out, cudaStream_t stream) {
  const int blocks = (P.n_col + kThreads - 1) / kThreads;
  const size_t shared = (size_t)P.L * (sizeof(float4) + sizeof(float2));
  cape_pi_kernel<THERMO, INV><<<blocks, kThreads, shared, stream>>>(
      P, sst, p_surf, p_env, T_env, r_env, table, out);
  return (int)cudaGetLastError();
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
  P.Lv = *fp++; P.cpv_cl = *fp++; P.t_lat = *fp++; P.cl = *fp++;
  P.cpv = *fp++;
  P.L0sq = *fp++; P.T0 = *fp++; P.step_lo = *fp++; P.step_hi = *fp++;
  P.T_lo = *fp++; P.T_hi = *fp++;
  P.rt0 = *fp++; P.drt = *fp++;
  const int* ip = iparams;
  P.ns = *ip++; P.np_ = *ip++; P.L = *ip++; P.n_col = *ip++;
  P.nrt = *ip++; P.iters = *ip++;
  const int thermo = *ip++, inv = *ip++;

  cudaStream_t s = (cudaStream_t)stream;
  const auto args = [&](auto kern) {
    return kern(P, sst, p_surf, p_env, T_env, r_env, table, out, s);
  };
  if (thermo == 1) {
    if (inv == kTable2) return args(launch<1, kTable2>);
    if (inv == kTable3) return args(launch<1, kTable3>);
    if (inv == kNewton) return args(launch<1, kNewton>);
  } else if (thermo == 2) {
    if (inv == kTable2) return args(launch<2, kTable2>);
    if (inv == kTable3) return args(launch<2, kTable3>);
    if (inv == kNewton) return args(launch<2, kNewton>);
  }
  return (int)cudaErrorInvalidValue;
}
