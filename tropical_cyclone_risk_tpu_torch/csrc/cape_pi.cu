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
// What bounds it on this card: not the bytes of the two [L, columns]
// profiles (each read once, neighbouring threads on neighbouring columns)
// but the instructions it issues: built with -fmad=false and without fast
// math, each IEEE division, logf, expf and powf costs tens of them.  So
// the work that depends on the level alone or on the column alone leaves
// the walk: a block prologue computes once per level, into shared memory,
// the pressure, -dlnp, the dry-adiabat factor (pl / p_ns)^(Rd/cp) (p_ns is
// the first level's pressure, the same for every column) and the table's
// pressure cell and weights; each column computes once the entropy cells
// and weights of its two parcels (s_ns for the lifted one, ss for the
// saturated one).  The walk keeps what truly changes per level: the
// environment's density temperature, the two four-corner blends, the
// parcels' saturation formulas, the sums and the outflow pair.
//
// Work layout on the card: 128 threads per block, one level per loop
// iteration, the 160 KB entropy table read through the read-only cache
// (__ldg).  256 threads per block, two levels per iteration and the table
// staged in shared memory were each timed against this in one call on the
// card, and none was faster (PERF.md).
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
// torch and holds it against the twin bit for bit.
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

// what the walk needs of one level, the same for every column: the
// pressure, -dlnp, the dry-adiabat factor and the weight of the table's
// pressure cell (a), and 1 - that weight with the cell's first row (b)
struct Levels {
  const float4* a;   // pl, -dlnp, (pl / p_ns)^(Rd/cp), wy
  const float2* b;   // 1 - wy, iy * ns (as int bits)
};

// the block prologue: one thread per level; the same operations, in the
// same order, as the walk made on every level of every column
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
    float wy;
    const int iy = cell(pl, P.p0, P.dp, P.np_, &wy);
    la[l] = make_float4(pl, -dlnp, powf(pl / p_ns, P.rd_cp), wy);
    lb[l] = make_float2(1.0f - wy, __int_as_float(iy * P.ns));
  }
}

// EntropyTable.lookup at a level's pressure cell (iyns, wy, 1 - wy) and a
// column's entropy cell (ix, wx, 1 - wx): interp.bilinear_scalar's blend
__device__ __forceinline__ float blend(const float* __restrict__ table,
                                       int ns, int iyns, float wy,
                                       float omwy, int ix, float wx,
                                       float omwx) {
  const int base = iyns + ix;
  const float c00 = __ldg(table + base), c01 = __ldg(table + base + 1);
  const float c10 = __ldg(table + base + ns);
  const float c11 = __ldg(table + base + ns + 1);
  return omwy * (omwx * c00 + wx * c01) + wy * (omwx * c10 + wx * c11);
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
  // the column: the lifted parcel's start, its LCL and both entropy cells
  float T_ns, r_ns, pLCL;
  int ix_a, ix_s;
  float wx_a, omwx_a, wx_s, omwx_s;
  // the running sums, the partial sum at the last buoyant level and the
  // outflow of the pair (last buoyant level, the level above)
  float sum_a, sum_s, cape_a, cape_s, area_a, area_s, T_out_s;
  int out_a, out_s;
  bool condensed, prev_buoy_a, prev_buoy_s;
  float prev_p, prev_Te, prev_dTa, prev_dTs;
};

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
  const int iyns = __float_as_int(lb.y);
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
    Ta = blend(table, P.ns, iyns, wy, omwy, w.ix_a, w.wx_a, w.omwx_a);
    ra = sat_rs(P, sat_es(P, Ta), pl);
  }
  // the surface-saturated parcel: a moist adiabat from the surface
  const float Ts = blend(table, P.ns, iyns, wy, omwy, w.ix_s, w.wx_s,
                         w.omwx_s);
  const float rsp = sat_rs(P, sat_es(P, Ts), pl);
  const float Trho_a = t_rho(P, Ta, ra), Trho_s = t_rho(P, Ts, rsp);
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
  level_prologue(P, p_env, la, lb);
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
    const float s_ns = s_unsat(P, w.T_ns, p_ns, w.r_ns);
    const float ss = s_sat(P, sst_c, ps);
    w.pLCL = get_lcl(P, p_ns, w.T_ns, w.r_ns, rh);
    w.ix_a = cell(s_ns, P.s0, P.ds, P.ns, &w.wx_a);
    w.ix_s = cell(ss, P.s0, P.ds, P.ns, &w.wx_s);
    w.omwx_a = 1.0f - w.wx_a;
    w.omwx_s = 1.0f - w.wx_s;

    w.sum_a = w.sum_s = w.cape_a = w.cape_s = 0.0f;
    w.area_a = w.area_s = w.T_out_s = 0.0f;
    w.out_a = w.out_s = -1;
    w.condensed = w.prev_buoy_a = w.prev_buoy_s = false;
    w.prev_p = w.prev_Te = w.prev_dTa = w.prev_dTs = 0.0f;
    for (int l = 0; l < L; ++l)
      walk_level(P, lv, table, T_env, r_env, n, c, l, w);

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

  const int blocks = (P.n_col + kThreads - 1) / kThreads;
  const size_t shared = (size_t)P.L * (sizeof(float4) + sizeof(float2));
  cape_pi_kernel<<<blocks, kThreads, shared, (cudaStream_t)stream>>>(
      P, sst, p_surf, p_env, T_env, r_env, table, out);
  return (int)cudaGetLastError();
}
