// K3: genesis seeding for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA-fused function of the JAX package (there is no Pallas
// kernel to translate): models/seeding.py:95 propose_seeds, with
// _position_rounds (:54) and retry_unresolved_curve (:205).  Its plain
// PyTorch twins are models/seeding.py propose_seeds_plain and
// retry_unresolved_curve_plain; the threefry device functions are those
// of csrc/threefry.cuh, which K5 shares.
//
// Work layout: one thread per slot, with the slot's whole function in
// registers.  Proposal rounds are drawn lazily: round r of slot s is
// counter r * n + s of the k_lon / k_latr streams (round 0's latitude is
// asinf of the k_lat0 draw at counter s, in degrees), and a slot draws only
// the rounds it tests, stopping at its first pass (run mask >= 1e-2).  So
// the [16, n] proposal tensors of both packages never exist.  Bilinear
// lookups read the four corners of the unpacked fields (run mask, basin
// masks, the env stack's vpot and rh channels) at the row interp's
// _cell_and_weight gives; these are the values the twin's corner-packed
// copy holds (ix <= nlon - 2 and iy <= nlat - 2, so pack_corners' edge
// clamp is never read), so no corner-packed copy is made.
//
// seed_retry_caps: the JAX package's retry compaction is not only a
// speed-up.  A slot still unresolved after round r - 1 whose rank (in slot
// order) among the still-active unresolved slots is >= the round's width
// w_r leaves the active set and is dropped.  The kernel gives the twin's
// result in three launches: (A) every slot's first passing round f at
// full width and a histogram of f; (B) one block that reads the histogram
// and, only if some round overflows (#{f >= r} > w_r for the first such
// r), applies the successive stable ranks from that round on, marking the
// slots beyond each width dropped; (C) the per-slot rest of the function
// from the slot's final round.  Without caps, (A) finishes each slot
// itself.  retry_unresolved_curve is (A)'s histogram: the slots still
// unresolved after round r are those with f > r (never passing: f = R).
//
// What bounds it on this card: per slot ~8 threefry draws of ~110 integer
// operations each (two per tested round, ~1.2 rounds on average; month,
// rejection and v_init; with retry caps the final position again) and
// ~10 interpolated values, against 43 bytes of outputs and the mask and
// env cells it reads: about as many bytes as operations at the card's
// rates, bytes by a small margin (chip_smoke.py k3_bound).  No shared
// memory and no staging: each thread reads its corners through the
// read-only cache (__ldg), where neighbouring slots' rows meet in L2.
//
// Numerics: built without --use_fast_math and with -fmad=false, so every
// operation rounds as the separate torch kernels of the twin do; asinf,
// powf, expf are CUDA's own, which torch's CUDA kernels call.  Each
// expression keeps the twin's operation order (the division by dlon/dlat
// and by 12 is a true division, as interp.true_div makes the twin's), each
// constant is the float32 rounding the twin uses (a parameter block filled
// on the host), the basin argmax takes the first maximum (a NaN counts as
// the largest) as torch.max does, and min/max/clamp propagate NaN.
//
// The C entry returns cudaGetLastError() after its launches; the wrapper
// (kernels/seeding.py) raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int MAX_ROUNDS = 32;
constexpr int MAX_BASINS = 16;

struct Params {
  TfKey k_lon, k_lat0, k_latr, k_month1, k_month2, k_reject, k_vinit;
  // uniform (lo, span) of each stream
  double lon_lo, lon_span, lat0_lo, lat0_span, latr_lo, latr_span;
  double rej_lo, rej_span, nrm_lo, nrm_span;
  // float32 constants
  float rad2deg, mask_thr, basin_thr, vpot_thr;
  float m_lon0, m_dlon, m_lat0, m_dlat;   // mask grid
  float e_lon0, e_dlon, e_lat0, e_dlat;   // env grid
  float lat_vort_fac, lat_scale, v_init_base;
  float m_mid, m_slope, m_amp, m_base;
  float powers[MAX_BASINS], h_bl[MAX_BASINS];
  // integers
  int64_t n;
  int R, m_nlon, m_nlat, e_nlon, e_nlat, n_basins, n_env, vpot_ch, rh_ch;
  int64_t n_planes, plane_base;           // plane_base: offset - start_month
  uint32_t month_span, month_mult;
  int64_t month_min;
  int64_t widths[MAX_ROUNDS];             // width of retry round r (r >= 1)
};

struct Out {
  float *lon, *lat;
  int32_t* month;
  int64_t* basin_idx;
  bool *counted, *integrate, *dropped;
  float *v_init, *m_init, *h_bl;
  int64_t* plane;
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

// interp._cell_and_weight: a NaN query reads cell 0 with a NaN weight
__device__ __forceinline__ int cell(float x, float x0, float dx, int n,
                                    float* w) {
  const float u = clampf((x - x0) / dx, 0.0f, (float)n - 1.0f);
  const float fi = clampf(floorf(u), 0.0f, (float)(n - 2));
  const int i = isnan(fi) ? 0 : (int)fi;
  *w = u - (float)i;
  return i;
}

// the row (plane * nlat + iy) * nlon + ix of a lookup and its weights
struct Corner {
  int64_t row;
  float wx, wy;
};
__device__ __forceinline__ Corner locate(float lon, float lat, float lon0,
                                         float dlon, int nlon, float lat0,
                                         float dlat, int nlat, int64_t plane) {
  Corner q;
  const int ix = cell(lon, lon0, dlon, nlon, &q.wx);
  const int iy = cell(lat, lat0, dlat, nlat, &q.wy);
  q.row = (plane * nlat + iy) * nlon + ix;
  return q;
}

// interp._blend of channel c of a [rows, C] field at the four corners
__device__ __forceinline__ float lookup(const float* __restrict__ f, int C,
                                        int c, const Corner& q, int nlon) {
  const float c00 = __ldg(f + q.row * C + c);
  const float c01 = __ldg(f + (q.row + 1) * C + c);
  const float c10 = __ldg(f + (q.row + nlon) * C + c);
  const float c11 = __ldg(f + (q.row + nlon + 1) * C + c);
  return (1.0f - q.wy) * ((1.0f - q.wx) * c00 + q.wx * c01) +
         q.wy * ((1.0f - q.wx) * c10 + q.wx * c11);
}

// seeding._position_rounds, round r of slot s
__device__ __forceinline__ void position(const Params& P, int64_t s, int r,
                                         float* lon, float* lat) {
  const uint64_t i = (uint64_t)r * (uint64_t)P.n + (uint64_t)s;
  *lon = tf_uniform(P.k_lon, i, P.lon_lo, P.lon_span);
  if (r == 0) {
    const float y = tf_uniform(P.k_lat0, (uint64_t)s, P.lat0_lo, P.lat0_span);
    *lat = asinf(y) * P.rad2deg;
  } else {
    *lat = tf_uniform(P.k_latr, i, P.latr_lo, P.latr_span);
  }
}

// the first round whose proposal lands on the run mask (R: none), and its
// position (round 0's when none passes)
__device__ int first_round(const Params& P, const float* __restrict__ run_mask,
                           int64_t s, float* lon, float* lat) {
  float lon0 = 0.0f, lat0 = 0.0f;
  for (int r = 0; r < P.R; ++r) {
    float lo, la;
    position(P, s, r, &lo, &la);
    if (r == 0) {
      lon0 = lo;
      lat0 = la;
    }
    const Corner q = locate(lo, la, P.m_lon0, P.m_dlon, P.m_nlon, P.m_lat0,
                            P.m_dlat, P.m_nlat, 0);
    if (lookup(run_mask, 1, 0, q, P.m_nlon) >= P.mask_thr) {
      *lon = lo;
      *lat = la;
      return r;
    }
  }
  *lon = lon0;
  *lat = lat0;
  return P.R;
}

// propose_seeds_plain after the proposal rounds: month and plane, basin
// argmax, equatorward rejection, PI gate, initial state
__device__ void finalize(const Params& P, const float* __restrict__ basins,
                         const float* __restrict__ env, const Out& o,
                         int64_t s, int first, float lon, float lat) {
  const bool any_pass = first < P.R;
  const int32_t month = tf_randint(P.k_month1, P.k_month2, (uint64_t)s,
                                   P.month_span, P.month_mult, P.month_min);
  const int64_t plane_raw = P.plane_base + (int64_t)month;
  const bool plane_ok = plane_raw >= 0 && plane_raw < P.n_planes;
  const int64_t plane =
      plane_raw < 0 ? 0 : (plane_raw >= P.n_planes ? P.n_planes - 1
                                                   : plane_raw);

  const Corner qm = locate(lon, lat, P.m_lon0, P.m_dlon, P.m_nlon, P.m_lat0,
                           P.m_dlat, P.m_nlat, 0);
  int bi = 0;
  float best = lookup(basins, P.n_basins, 0, qm, P.m_nlon);
  for (int b = 1; b < P.n_basins; ++b) {
    const float v = lookup(basins, P.n_basins, b, qm, P.m_nlon);
    if (!isnan(best) && (isnan(v) || v > best)) {
      best = v;
      bi = b;
    }
  }
  const bool basin_ok = best > P.basin_thr;

  const float p_lat = powf(
      clampf((fabsf(lat) - P.lat_vort_fac) / P.lat_scale, 0.0f, 1.0f),
      P.powers[bi]);
  const float u = tf_uniform(P.k_reject, (uint64_t)s, P.rej_lo, P.rej_span);
  const bool counted = any_pass && basin_ok && (u < p_lat);

  const Corner qe = locate(lon, lat, P.e_lon0, P.e_dlon, P.e_nlon, P.e_lat0,
                           P.e_dlat, P.e_nlat, plane);
  const float vpot = lookup(env, P.n_env, P.vpot_ch, qe, P.e_nlon);
  const float rh = lookup(env, P.n_env, P.rh_ch, qe, P.e_nlon);

  const float den = expf(-(rh - P.m_mid) * P.m_slope) + 1.0f;
  o.lon[s] = lon;
  o.lat[s] = lat;
  o.month[s] = month;
  o.basin_idx[s] = bi;
  o.counted[s] = counted;
  o.integrate[s] = counted && plane_ok && (vpot > P.vpot_thr);
  o.dropped[s] = !any_pass;
  o.v_init[s] =
      tf_normal(P.k_vinit, (uint64_t)s, P.nrm_lo, P.nrm_span) + P.v_init_base;
  o.m_init[s] = nan_max(P.m_amp / den + P.m_base, 0.0f);
  o.h_bl[s] = P.h_bl[bi];
  o.plane[s] = plane;
}

// (A) first passing round at full width [+ histogram] [+ the rest]
__global__ void __launch_bounds__(256)
seed_first(const Params P, const float* __restrict__ run_mask,
           const float* __restrict__ basins, const float* __restrict__ env,
           int32_t* __restrict__ first, int32_t* __restrict__ hist,
           const Out o) {
  __shared__ int sh[MAX_ROUNDS + 1];
  if (hist) {
    for (int t = threadIdx.x; t <= P.R; t += blockDim.x) sh[t] = 0;
    __syncthreads();
  }
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < P.n) {
    float lon, lat;
    const int f = first_round(P, run_mask, s, &lon, &lat);
    if (first) first[s] = f;
    if (hist) atomicAdd(&sh[f], 1);
    if (o.lon) finalize(P, basins, env, o, s, f, lon, lat);
  }
  if (hist) {
    __syncthreads();
    for (int t = threadIdx.x; t <= P.R; t += blockDim.x)
      if (sh[t]) atomicAdd(hist + t, sh[t]);
  }
}

// exclusive prefix sum of v over the block (blockDim.x a multiple of 32)
__device__ int block_exclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < (int)(blockDim.x >> 5) ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += y;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  const int excl = x - v + (wid > 0 ? warp_tot[wid - 1] : 0);
  __syncthreads();
  return excl;
}

// (B) seed_retry_caps: one block; each thread owns a contiguous chunk of
// slots, so a block-wide prefix sum of the chunks' counts is the stable
// rank.  first[s] = R + 1 marks a dropped slot until the end.
__global__ void __launch_bounds__(1024)
seed_caps(const Params P, int32_t* __restrict__ first,
          const int32_t* __restrict__ hist) {
  __shared__ int warp_tot[32];
  __shared__ int r0_sh;
  const int R = P.R;
  if (threadIdx.x == 0) {
    // the first round r whose unresolved slots #{f >= r} exceed w_r
    int64_t ge[MAX_ROUNDS + 2];
    ge[R + 1] = 0;
    for (int f = R; f >= 0; --f) ge[f] = ge[f + 1] + hist[f];
    int r0 = R;
    for (int r = 1; r < R; ++r) {
      if (ge[r] > P.widths[r]) {
        r0 = r;
        break;
      }
    }
    r0_sh = r0;
  }
  __syncthreads();
  const int r0 = r0_sh;
  if (r0 >= R) return;          // every unresolved slot fits every round
  const int64_t chunk = (P.n + blockDim.x - 1) / blockDim.x;
  const int64_t lo_c = (int64_t)threadIdx.x * chunk;
  const int64_t lo = lo_c < P.n ? lo_c : P.n;
  const int64_t hi = lo + chunk < P.n ? lo + chunk : P.n;
  for (int r = r0; r < R; ++r) {
    // still active and unresolved entering round r: f >= r, not dropped
    int cnt = 0;
    for (int64_t s = lo; s < hi; ++s) {
      const int v = first[s];
      cnt += (v >= r && v <= R);
    }
    int64_t rank = block_exclusive_scan(cnt, warp_tot);
    for (int64_t s = lo; s < hi; ++s) {
      const int v = first[s];
      if (v >= r && v <= R) {
        if (rank >= P.widths[r]) first[s] = R + 1;
        ++rank;
      }
    }
  }
  for (int64_t s = lo; s < hi; ++s)
    if (first[s] > R) first[s] = R;
}

// (C) the rest of the function from each slot's final round
__global__ void __launch_bounds__(256)
seed_finalize(const Params P, const float* __restrict__ basins,
              const float* __restrict__ env,
              const int32_t* __restrict__ first, const Out o) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= P.n) return;
  const int f = first[s];
  float lon, lat;
  position(P, s, f < P.R ? f : 0, &lon, &lat);
  finalize(P, basins, env, o, s, f, lon, lat);
}

enum Mode { PROPOSE = 0, PROPOSE_CAPS = 1, CURVE = 2 };

}  // namespace

extern "C" int tc_propose_seeds(
    int mode, const uint32_t* keys, const double* dparams,
    const float* fparams, const int64_t* iparams, const float* run_mask,
    const float* basins, const float* env, int32_t* first, int32_t* hist,
    float* lon, float* lat, int32_t* month, int64_t* basin_idx,
    bool* counted, bool* integrate, bool* dropped, float* v_init,
    float* m_init, float* h_bl, int64_t* plane, void* stream) {
  Params P;
  TfKey* ks[7] = {&P.k_lon, &P.k_lat0, &P.k_latr, &P.k_month1, &P.k_month2,
                  &P.k_reject, &P.k_vinit};
  for (int j = 0; j < 7; ++j) *ks[j] = TfKey{keys[2 * j], keys[2 * j + 1]};
  const double* dp = dparams;
  P.lon_lo = *dp++; P.lon_span = *dp++;
  P.lat0_lo = *dp++; P.lat0_span = *dp++;
  P.latr_lo = *dp++; P.latr_span = *dp++;
  P.rej_lo = *dp++; P.rej_span = *dp++;
  P.nrm_lo = *dp++; P.nrm_span = *dp++;
  const float* fp = fparams;
  P.rad2deg = *fp++; P.mask_thr = *fp++; P.basin_thr = *fp++;
  P.vpot_thr = *fp++;
  P.m_lon0 = *fp++; P.m_dlon = *fp++; P.m_lat0 = *fp++; P.m_dlat = *fp++;
  P.e_lon0 = *fp++; P.e_dlon = *fp++; P.e_lat0 = *fp++; P.e_dlat = *fp++;
  P.lat_vort_fac = *fp++; P.lat_scale = *fp++; P.v_init_base = *fp++;
  P.m_mid = *fp++; P.m_slope = *fp++; P.m_amp = *fp++; P.m_base = *fp++;
  for (int b = 0; b < MAX_BASINS; ++b) P.powers[b] = *fp++;
  for (int b = 0; b < MAX_BASINS; ++b) P.h_bl[b] = *fp++;
  const int64_t* ip = iparams;
  P.n = *ip++; P.R = (int)*ip++;
  P.m_nlon = (int)*ip++; P.m_nlat = (int)*ip++;
  P.e_nlon = (int)*ip++; P.e_nlat = (int)*ip++;
  P.n_basins = (int)*ip++; P.n_env = (int)*ip++;
  P.vpot_ch = (int)*ip++; P.rh_ch = (int)*ip++;
  P.n_planes = *ip++; P.plane_base = *ip++;
  P.month_span = (uint32_t)*ip++; P.month_mult = (uint32_t)*ip++;
  P.month_min = *ip++;
  for (int r = 0; r < MAX_ROUNDS; ++r) P.widths[r] = *ip++;

  const Out none = {};
  const Out o = {lon, lat, month, basin_idx, counted, integrate, dropped,
                 v_init, m_init, h_bl, plane};
  const int threads = 256;
  const int blocks = (int)((P.n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == PROPOSE) {
    seed_first<<<blocks, threads, 0, s>>>(P, run_mask, basins, env, nullptr,
                                          nullptr, o);
  } else if (mode == PROPOSE_CAPS) {
    seed_first<<<blocks, threads, 0, s>>>(P, run_mask, basins, env, first,
                                          hist, none);
    seed_caps<<<1, 1024, 0, s>>>(P, first, hist);
    seed_finalize<<<blocks, threads, 0, s>>>(P, basins, env, first, o);
  } else if (mode == CURVE) {
    seed_first<<<blocks, threads, 0, s>>>(P, run_mask, basins, env, nullptr,
                                          hist, none);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
