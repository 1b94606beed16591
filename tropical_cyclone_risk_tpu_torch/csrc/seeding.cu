// K3: genesis seeding for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA-fused function of the JAX package (there is no Pallas
// kernel to translate): models/seeding.py:95 propose_seeds, with
// _position_rounds (:54) and retry_unresolved_curve (:205).  Its plain
// PyTorch twins are models/seeding.py propose_seeds_plain and
// retry_unresolved_curve_plain; the threefry device functions are those
// of csrc/threefry.cuh, which K5 shares.
//
// One launch per call, whatever the mode.  Each block first derives the
// seven stream keys from the parent key (rng.split(key, 6) and the month
// key's split, the counters the host used to draw) into shared memory, so
// the host does no threefry per call.  Proposal rounds are drawn lazily:
// round r of slot s is counter r * n + s of the k_lon / k_latr streams
// (round 0's latitude is asinf of the k_lat0 draw at counter s, in
// degrees), so the [16, n] proposal tensors of both packages never exist.
// Bilinear lookups read the four corners of the unpacked fields (run mask,
// basin masks, the env stack's vpot and rh channels) at the row interp's
// _cell_and_weight gives; these are the values the twin's corner-packed
// copy holds (ix <= nlon - 2 and iy <= nlat - 2, so pack_corners' edge
// clamp is never read), so no corner-packed copy is made.
//
// Warp-cooperative retry rounds.  A slot takes its first round whose
// proposal lands on the run mask (mask >= 1e-2).  About 11% of slots miss
// round 0, and a warp waits for its slowest lane, so one thread per slot
// walking its own rounds ran ~3.3 times the mean number of rounds.  Here
// each lane tests round 0 of its own slot; then the warp spreads the
// unresolved slots' later rounds over its lanes as (slot, round) pairs,
// k = 32 / u consecutive rounds for each of the u unresolved slots, and
// each slot takes its lowest passing round from a ballot, its position
// shuffled over from the lane that drew it.  A slot's first round and
// position are exactly those of the sequential walk.
//
// seed_retry_caps: the JAX package's retry compaction is not only a
// speed-up.  A slot still unresolved after round r - 1 whose rank (in slot
// order) among the still-active unresolved slots is >= the round's width
// w_r leaves the active set and is dropped.  Every block finishes each of
// its slots from its full-width first round (the speculative finish), adds
// its histogram of first rounds to a global one and lists its slots that
// missed round 0 (the only ones a cap can drop) with their first rounds.
// The last block to finish (a fence and a counter, as csrc/vmax.cu's
// cross-chunk peak) reads the histogram and, only if some round overflows
// (#{f >= r} > w_r for the first such r), applies the successive stable
// ranks from that round on over the lists and rewrites the slots that drop
// as the twin leaves them (round 0's position, no passing round).  It then
// zeroes the histogram and the counter, so no memset runs per call.
// retry_unresolved_curve is the same histogram: the slots still unresolved
// after round r are those with f > r (never passing: f = R).
//
// What bounds it on this card: per slot ~6 threefry draws of ~110 integer
// operations each (two per round the sequential walk needs, ~1.2 on
// average; month, rejection and v_init) and ~10 interpolated values (the
// warp tests up to k rounds of a slot at once, ~1.9 per slot, to cut the
// rounds a warp waits for from ~3.9 to ~2.0), against 43 bytes of
// outputs and the mask and env cells it reads: about as many bytes as
// operations at the card's rates, bytes by a small margin (chip_smoke.py
// k3_bound).  No staging: each thread reads its corners through the
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
// The C entry returns cudaGetLastError() after its launch; the wrapper
// (kernels/seeding.py) raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int MAX_ROUNDS = 32;
constexpr int MAX_BASINS = 16;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// the stream keys, in the order the kernel derives them
enum { K_LON, K_LAT0, K_LATR, K_MONTH1, K_MONTH2, K_REJECT, K_VINIT, N_KEYS };

struct Params {
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

// the outputs (all null for the curve alone)
struct Out {
  float *lon, *lat;
  int32_t* month;
  int64_t* basin_idx;
  bool *counted, *integrate, *dropped;
  float *v_init, *m_init, *h_bl;
  int64_t* plane;
};

// the launcher's scratch, zero between launches (hist, count); hist null:
// no caps and no curve, so no block waits for the others
struct Scratch {
  int32_t* hist;        // [R + 1] first rounds
  uint32_t* count;      // blocks done
  int2* cand;           // [blocks * THREADS] (slot, f) of slots with f >= 1
  int32_t* n_cand;      // [blocks]
  int32_t* ge;          // [(MAX_ROUNDS + 1) * THREADS] the last block's
  int32_t* curve;       // [R] unresolved after each round, or null
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

// the block's stream keys: rng.split(key, 6) is the block at counter
// (0, j) for stream j, and randint's two keys split(k_month, 2) the blocks
// at (0, 0) and (0, 1) of the month key; one thread per key
__device__ void derive_keys(const TfKey parent, TfKey* keys) {
  const int t = threadIdx.x;
  if (t < N_KEYS) {
    const uint32_t j = t < K_MONTH1 ? t : (t <= K_MONTH2 ? 3u : t - 1u);
    uint32_t x0 = 0u, x1 = j;
    threefry2x32(parent, x0, x1);
    if (t == K_MONTH1 || t == K_MONTH2) {
      const TfKey k_month{x0, x1};
      x0 = 0u;
      x1 = (uint32_t)(t - K_MONTH1);
      threefry2x32(k_month, x0, x1);
    }
    keys[t] = TfKey{x0, x1};
  }
  __syncthreads();
}

// seeding._position_rounds, round r of slot s
__device__ __forceinline__ void position(const Params& P, const TfKey* keys,
                                         int64_t s, int r, float* lon,
                                         float* lat) {
  const uint64_t i = (uint64_t)r * (uint64_t)P.n + (uint64_t)s;
  *lon = tf_uniform(keys[K_LON], i, P.lon_lo, P.lon_span);
  if (r == 0) {
    const float y = tf_uniform(keys[K_LAT0], (uint64_t)s, P.lat0_lo,
                               P.lat0_span);
    *lat = asinf(y) * P.rad2deg;
  } else {
    *lat = tf_uniform(keys[K_LATR], i, P.latr_lo, P.latr_span);
  }
}

__device__ __forceinline__ float mask_at(const Params& P,
                                         const float* __restrict__ run_mask,
                                         float lon, float lat) {
  const Corner q = locate(lon, lat, P.m_lon0, P.m_dlon, P.m_nlon, P.m_lat0,
                          P.m_dlat, P.m_nlat, 0);
  return lookup(run_mask, 1, 0, q, P.m_nlon);
}

// the draws of a slot that do not depend on its position: its month and
// field plane, v_init and the equatorward rejection's uniform
struct SlotDraws {
  int64_t plane;
  int32_t month;
  bool plane_ok;
  float v_init, u;
};
__device__ __forceinline__ SlotDraws slot_draws(const Params& P,
                                                const TfKey* keys,
                                                int64_t s) {
  SlotDraws d;
  d.month = tf_randint(keys[K_MONTH1], keys[K_MONTH2], (uint64_t)s,
                       P.month_span, P.month_mult, P.month_min);
  const int64_t plane_raw = P.plane_base + (int64_t)d.month;
  d.plane_ok = plane_raw >= 0 && plane_raw < P.n_planes;
  d.plane = plane_raw < 0 ? 0 : (plane_raw >= P.n_planes ? P.n_planes - 1
                                                         : plane_raw);
  d.v_init = tf_normal(keys[K_VINIT], (uint64_t)s, P.nrm_lo, P.nrm_span) +
             P.v_init_base;
  d.u = tf_uniform(keys[K_REJECT], (uint64_t)s, P.rej_lo, P.rej_span);
  return d;
}

// the first round whose proposal lands on the run mask (R: none) of the
// lane's slot s, and its position (round 0's when none passes), given
// round 0's verdict and position: the warp's lanes share the rounds of its
// unresolved slots; every lane of the warp calls it (valid: s < n)
__device__ int first_round(const Params& P, const TfKey* keys,
                           const float* __restrict__ run_mask, int64_t s,
                           bool valid, bool pass, float lo, float la,
                           float* lon, float* lat) {
  const int lane = threadIdx.x & 31;
  int f = pass ? 0 : P.R;
  unsigned unres = __ballot_sync(FULL, valid && !pass);
  const int64_t s_lane0 = s - lane;
  for (int base = 1; unres != 0u && base < P.R;) {
    // k rounds base .. base + k - 1 of each of the u unresolved slots:
    // lane i tests round base + i % k of unresolved slot i / k
    const int u = __popc(unres);
    const int k = min(32 / u, P.R - base);
    const int j = lane / k;
    bool hit = false;
    float tlo = 0.0f, tla = 0.0f;
    if (j < u) {
      unsigned m = unres;
      for (int q = 0; q < j; ++q) m &= m - 1u;
      position(P, keys, s_lane0 + (__ffs(m) - 1), base + (lane - j * k),
               &tlo, &tla);
      hit = mask_at(P, run_mask, tlo, tla) >= P.mask_thr;
    }
    const unsigned hits = __ballot_sync(FULL, hit);
    // this lane's slot: the lowest passing round of its group of lanes
    int src = lane;
    bool got = false;
    if ((unres >> lane) & 1u) {
      const int jo = __popc(unres & ((1u << lane) - 1u));
      const unsigned g = (unsigned)(((uint64_t)hits >> (jo * k)) &
                                    ((1ull << k) - 1ull));
      if (g != 0u) {
        const int t = __ffs(g) - 1;
        src = jo * k + t;
        f = base + t;
        got = true;
      }
    }
    const float slo = __shfl_sync(FULL, tlo, src);
    const float sla = __shfl_sync(FULL, tla, src);
    if (got) {
      lo = slo;
      la = sla;
    }
    unres &= ~__ballot_sync(FULL, got);
    base += k;
  }
  *lon = lo;
  *lat = la;
  return f;
}

// propose_seeds_plain after the proposal rounds, the part that depends on
// the position: basin argmax, equatorward rejection, PI gate, m_init and
// h_bl (plane: the slot's field plane, plane_ok: within the pack; u: the
// rejection's uniform, read only when a round passed)
__device__ void place(const Params& P, const float* __restrict__ basins,
                      const float* __restrict__ env, const Out& o, int64_t s,
                      bool any_pass, float lon, float lat, int64_t plane,
                      bool plane_ok, float u) {
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
  bool counted = false;
  if (any_pass && basin_ok) {
    const float p_lat = powf(
        clampf((fabsf(lat) - P.lat_vort_fac) / P.lat_scale, 0.0f, 1.0f),
        P.powers[bi]);
    counted = u < p_lat;
  }

  const Corner qe = locate(lon, lat, P.e_lon0, P.e_dlon, P.e_nlon, P.e_lat0,
                           P.e_dlat, P.e_nlat, plane);
  const float vpot = lookup(env, P.n_env, P.vpot_ch, qe, P.e_nlon);
  const float rh = lookup(env, P.n_env, P.rh_ch, qe, P.e_nlon);

  const float den = expf(-(rh - P.m_mid) * P.m_slope) + 1.0f;
  o.lon[s] = lon;
  o.lat[s] = lat;
  o.basin_idx[s] = bi;
  o.counted[s] = counted;
  o.integrate[s] = counted && plane_ok && (vpot > P.vpot_thr);
  o.dropped[s] = !any_pass;
  o.m_init[s] = nan_max(P.m_amp / den + P.m_base, 0.0f);
  o.h_bl[s] = P.h_bl[bi];
}

// the whole of propose_seeds_plain after the proposal rounds
__device__ void finalize(const Params& P, const float* __restrict__ basins,
                         const float* __restrict__ env, const Out& o,
                         int64_t s, int first, float lon, float lat,
                         const SlotDraws& d) {
  o.month[s] = d.month;
  o.plane[s] = d.plane;
  o.v_init[s] = d.v_init;
  place(P, basins, env, o, s, first < P.R, lon, lat, d.plane, d.plane_ok,
        d.u);
}

// exclusive prefix sum of v over the block (blockDim.x a multiple of 32)
__device__ int block_exclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < (int)(blockDim.x >> 5) ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  const int excl = x - v + (wid > 0 ? warp_tot[wid - 1] : 0);
  __syncthreads();
  return excl;
}

// the last block, from round r0 (the first that overflows) on.  An entry
// (slot s, first round f) still active entering round r ranks, among the
// active entries with f >= r, as all entries before it with f >= r do (an
// entry dropped earlier drops every later one that reaches that round
// too), so it is dropped iff for some round r in [r0, min(f, R - 1)] the
// entries with f >= r up to and including it outnumber w_r.  Each thread
// walks a run of consecutive blocks' lists twice: once to count its
// entries with f >= r (a block-wide scan per round of these counts gives
// each run the counts before it), once to count on and drop; a dropped
// slot is rewritten as the twin leaves it: round 0's position, no passing
// round (its month, plane and v_init stay as written).
__device__ void drop_overflow(
    const Params& P, const TfKey* keys, const float* __restrict__ basins,
    const float* __restrict__ env, const Out& o, const Scratch& sc, int r0,
    int* warp_tot) {
  const int R = P.R, t = threadIdx.x;
  // the thread's counts for each round, a column of the scratch
  int32_t* ge = sc.ge + t;
  const int nb = gridDim.x;
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int b_lo = min(nb, t * per);
  const int b_hi = min(nb, b_lo + per);
  for (int r = 0; r <= R; ++r) ge[r * THREADS] = 0;
  for (int b = b_lo; b < b_hi; ++b) {
    const int nc = __ldcg(sc.n_cand + b);
    for (int i = 0; i < nc; ++i)
      ++ge[__ldcg(sc.cand + (int64_t)b * THREADS + i).y * THREADS];
  }
  for (int r = R - 1; r >= r0; --r)
    ge[r * THREADS] += ge[(r + 1) * THREADS];
  for (int r = r0; r < R; ++r)
    ge[r * THREADS] = block_exclusive_scan(ge[r * THREADS], warp_tot);
  for (int b = b_lo; b < b_hi; ++b) {
    const int nc = __ldcg(sc.n_cand + b);
    for (int i = 0; i < nc; ++i) {
      const int2 c = __ldcg(sc.cand + (int64_t)b * THREADS + i);
      bool drop = false;
      for (int r = r0; r <= min(c.y, R - 1); ++r)
        drop = (++ge[r * THREADS] > P.widths[r]) || drop;
      if (!drop) continue;
      const int64_t s = c.x;
      float lon, lat;
      position(P, keys, s, 0, &lon, &lat);
      place(P, basins, env, o, s, false, lon, lat, __ldcg(o.plane + s),
            false, 0.0f);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
seed_kernel(const Params P, const TfKey parent,
            const float* __restrict__ run_mask,
            const float* __restrict__ basins, const float* __restrict__ env,
            const Out o, const Scratch sc) {
  __shared__ TfKey keys[N_KEYS];
  __shared__ int sh_hist[MAX_ROUNDS + 1];
  __shared__ int warp_tot[32];
  const int R = P.R;
  const bool track = sc.hist != nullptr;
  if (track)
    for (int t = threadIdx.x; t <= R; t += blockDim.x) sh_hist[t] = 0;
  derive_keys(parent, keys);

  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = s < P.n;
  // round 0 of every lane (a lane past n draws slot n - 1's), then the
  // draws that do not depend on the position, so that they run while the
  // run mask's corners load
  const int64_t s_draw = valid ? s : P.n - 1;
  float lo0, la0;
  position(P, keys, s_draw, 0, &lo0, &la0);
  const float m0 = mask_at(P, run_mask, lo0, la0);
  const SlotDraws d = slot_draws(P, keys, s_draw);
  float lon, lat;
  const int f = first_round(P, keys, run_mask, s, valid, m0 >= P.mask_thr,
                            lo0, la0, &lon, &lat);
  if (valid && o.lon) finalize(P, basins, env, o, s, f, lon, lat, d);
  if (!track) return;

  // the histogram, and (with caps) the block's list of slots that missed
  // round 0, in slot order
  if (valid) atomicAdd(&sh_hist[f], 1);
  if (sc.cand) {
    const int c = (valid && f >= 1) ? 1 : 0;
    const int pos = block_exclusive_scan(c, warp_tot);
    if (c) sc.cand[(int64_t)blockIdx.x * THREADS + pos] = make_int2((int)s, f);
    if (threadIdx.x == blockDim.x - 1) sc.n_cand[blockIdx.x] = pos + c;
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= R; t += blockDim.x)
    if (sh_hist[t]) atomicAdd(sc.hist + t, sh_hist[t]);

  // the last block to finish reads every block's histogram and lists
  __threadfence();
  __syncthreads();
  __shared__ bool s_last;
  __shared__ int r0_sh;
  if (threadIdx.x == 0)
    s_last = atomicAdd(sc.count, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the grid's histogram, read at once into the block's (whose counts
  // went out above)
  for (int t = threadIdx.x; t <= R; t += blockDim.x)
    sh_hist[t] = __ldcg(sc.hist + t);
  __syncthreads();
  if (threadIdx.x == 0) {
    // #{f >= r} = n - #{f < r}: the first retry round r whose unresolved
    // slots exceed its width, and the curve #{f > r}
    int64_t total = 0;
    for (int t = 0; t <= R; ++t) total += sh_hist[t];
    int64_t below = 0;
    int r0 = R;
    for (int r = 0; r < R; ++r) {
      if (r >= 1 && r0 == R && total - below > P.widths[r]) r0 = r;
      below += sh_hist[r];
      if (sc.curve) sc.curve[r] = (int32_t)(total - below);
    }
    r0_sh = r0;
  }
  __syncthreads();
  if (o.lon && sc.cand && r0_sh < R)
    drop_overflow(P, keys, basins, env, o, sc, r0_sh, warp_tot);
  // zero the scratch for the next launch
  for (int t = threadIdx.x; t <= R; t += blockDim.x) sc.hist[t] = 0;
  if (threadIdx.x == 0) *sc.count = 0u;
}

}  // namespace

// iparams: n, R, mask and env grid sizes, basins, env channels, vpot and
// rh channels, planes, plane_base, month span and multiplier, month min,
// widths[MAX_ROUNDS]; ptrs: run_mask, basin masks, env, then the scratch
// (hist, count, cand, n_cand, ge, curve; 0 where unused), then the byte
// offsets of the 11 outputs in the arena (unread without one)
extern "C" int tc_propose_seeds(const double* dparams, const float* fparams,
                                const int64_t* iparams, const int64_t* ptrs,
                                uint32_t key0, uint32_t key1, void* arena,
                                void* stream) {
  Params P;
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
  if (P.R < 1 || P.R > MAX_ROUNDS || P.n_basins < 1 ||
      P.n_basins > MAX_BASINS || P.n < 1)
    return (int)cudaErrorInvalidValue;

  const int64_t* pp = ptrs;
  const float* run_mask = (const float*)*pp++;
  const float* basins = (const float*)*pp++;
  const float* env = (const float*)*pp++;
  Scratch sc;
  sc.hist = (int32_t*)*pp++;
  sc.count = (uint32_t*)*pp++;
  sc.cand = (int2*)*pp++;
  sc.n_cand = (int32_t*)*pp++;
  sc.ge = (int32_t*)*pp++;
  sc.curve = (int32_t*)*pp++;
  Out o = {};
  if (arena) {
    char* a = (char*)arena;
    o.lon = (float*)(a + *pp++);
    o.lat = (float*)(a + *pp++);
    o.month = (int32_t*)(a + *pp++);
    o.basin_idx = (int64_t*)(a + *pp++);
    o.counted = (bool*)(a + *pp++);
    o.integrate = (bool*)(a + *pp++);
    o.dropped = (bool*)(a + *pp++);
    o.v_init = (float*)(a + *pp++);
    o.m_init = (float*)(a + *pp++);
    o.h_bl = (float*)(a + *pp++);
    o.plane = (int64_t*)(a + *pp++);
  }
  const int blocks = (int)((P.n + THREADS - 1) / THREADS);
  seed_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      P, TfKey{key0, key1}, run_mask, basins, env, o, sc);
  return (int)cudaGetLastError();
}
