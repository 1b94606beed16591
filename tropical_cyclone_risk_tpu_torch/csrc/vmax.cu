// K2: the vmax diagnostic pass for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA-fused pass of the JAX package (there is no Pallas kernel
// to translate): models/diagnostics.py:193 axi_to_max_wind_raw with :83
// _translation_tm and :69 _vmax_from_inc, called per re-compaction segment
// of a launch (models/pipeline.py, nine segments on the bench's launch).
// Its plain PyTorch twin is models/diagnostics.py axi_to_max_wind_raw_plain.
// The file's second entry, the last-sample fix of the in-scan vmax over
// every segment of a launch (models/diagnostics.py:148 fix_last_sample and
// the launch's banking of the fixed samples into the peak,
// models/pipeline.py:527-535; twin diagnostics.fix_in_scan_plain), is at
// the end.
//
// Per sample (t, n) of a segment's [T, N] buffers: the centred-chord
// translation speed on the sphere from the neighbouring rows (the samples
// pos_before / pos_after across the segment's edges, or the start-edge
// extrapolation 2 x[0] - x[1] and the end row itself), the linear edge
// extrapolation at each track's last sample L (rows L and L-1, or
// pos_before / row 0 at L = 0; L may lie outside the segment), the
// G-scaled translation plus the shear asymmetry, vmax = v + min(|inc|,
// v / 2), and each storm's alive-masked lifetime peak.
//
// What bounds it on this card: bytes.  Per (step, storm) it reads 29 bytes
// (lon, lat, v, the four shear winds, alive) and writes 4 (vmax), against
// ~40 float32 operations (a transcendental as one), far below the card's
// ~20 operations per byte.
//
// Design.  A storm's samples depend on each other only through the
// neighbouring rows and the running peak, so the pass splits T as well as
// N: a 2-D grid of (blocks of storms) x (chunks of rows), each thread one
// storm through one chunk, with a one-row halo on each side (the row before
// the chunk and the row after it, or at the segment's edges the
// pos_before / pos_after samples or the extrapolations above).  The chunk
// length follows T, N and the SM count (kernels/vmax.py launch_geometry), so
// that even the narrow late segments put several blocks on every SM; a
// storm's rows are then a short serial chain, and the row after the current
// one is loaded before the current one is computed, so its latency leaves
// the chain.  The extrapolation at L needs rows L and L-1, which lie in the
// chunk that holds L or in its halo.  Every load is coalesced across the
// storm axis.  The winds are a template argument kW = 2 x steering levels:
// with two levels a sample's four winds are one 16-byte load; with more,
// the deep-layer shear's two (u, v) pairs are two 8-byte loads, the other
// levels unread (the wrapper checks the alignment and that each shear pair
// is an aligned (u, v)).  Three and four levels have instances of their
// own (kW = 6, 8); every other even count takes the instances kW = 0, which
// take W, a sample's stride, as a trailing kernel argument (only the
// stride: the loads are the same two pairs).  Each entry's pass is a
// device function that both kinds of instance call, so the compile-time
// instances keep their parameter block and their code.
//
// The peak is a reduction across the chunks of a storm: each block writes
// its storms' alive-masked partial peaks to a [chunks, N] scratch, fences,
// and counts itself done on its storm block's counter; the last block of a
// storm block to finish reduces the partials in chunk order (NaN
// propagating, as torch.amax) and writes the peak, then resets the counter.
// The order is fixed, so the result does not depend on which block
// finishes last.  With one chunk the block writes the peak directly.
//
// Numerics: built without --use_fast_math and with -fmad=false (the zonal
// chord differences two longitudes near 3 rad, and a contracted product
// there moves ut by up to 1e-3 m/s); each sample is vmaxc::vmax_at of
// csrc/vmax_common.cuh, which K1's in-scan diagnostic shares: CUDA's
// accurate sinf / cosf (their fast path, sincos_rad) and tanhf (no __sinf:
// the zonal chord's half-step angles are tiny), IEEE sqrtf, and the twin's
// products with float32 reciprocals where it divides by a Python number,
// in the twin's operation order.
//
// The C entry returns cudaGetLastError() after the launch; the wrapper
// (kernels/vmax.py) raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vmax_common.cuh"

namespace {

constexpr int kThreads = 128;     // threads per block (__launch_bounds__)
constexpr int kMaxChunks = 65535; // gridDim.y

struct Params {
  int T, N, chunk;
  int has_before, has_after;
  int iu2, iv2, iu8, iv8;         // deep-layer shear channels of the winds
  vmaxc::Consts c;                // float32 roundings of the twin's values
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float pick(float4 w, int i) {
  return i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
}

// the deep-layer shear's winds (u250, v250, u850, v850) of sample o of a
// [.., kW] wind buffer (kW = 0: [.., W]): one 16-byte load of all four
// winds at kW = 4, else the two aligned (u, v) pairs
template <int kW>
__device__ __forceinline__ float4 shear_winds(const float* __restrict__ wnds,
                                              int64_t o, const Params& p,
                                              int W) {
  if constexpr (kW == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(wnds) + o);
    return make_float4(pick(w, p.iu2), pick(w, p.iv2), pick(w, p.iu8),
                       pick(w, p.iv8));
  } else if constexpr (kW == 0) {
    const float* row = wnds + o * W;
    const float2 a = __ldg(reinterpret_cast<const float2*>(row + p.iu2));
    const float2 b = __ldg(reinterpret_cast<const float2*>(row + p.iu8));
    return make_float4(a.x, a.y, b.x, b.y);
  } else {
    const float2 a = __ldg(reinterpret_cast<const float2*>(wnds + o * kW +
                                                           p.iu2));
    const float2 b = __ldg(reinterpret_cast<const float2*>(wnds + o * kW +
                                                           p.iu8));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

// vmax_at of one sample from its shear winds
__device__ __forceinline__ float vmax_at(const Params& p, float lat,
                                         float b_lon, float b_lat,
                                         float a_lon, float a_lat, float v,
                                         float4 s) {
  return vmaxc::vmax_at(p.c, lat, b_lon, b_lat, a_lon, a_lat, v, s.x - s.z,
                        s.y - s.w);
}

// vmax_kernel's pass; W is the winds per sample where kW is 0
template <int kW>
__device__ __forceinline__ void vmax_pass(
    const Params& p, int W, const float* __restrict__ lon,
    const float* __restrict__ lat, const float* __restrict__ tc_v,
    const float* __restrict__ wnds, const uint8_t* __restrict__ alive,
    const int64_t* __restrict__ last, const float* __restrict__ before,
    const float* __restrict__ after, float* __restrict__ vmax,
    float* __restrict__ peak, float* __restrict__ partial,
    unsigned* __restrict__ count) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = n < p.N;
  const int64_t N = p.N;
  const int T = p.T;
  const int t0 = blockIdx.y * p.chunk;
  const int t1 = min(t0 + p.chunk, T);
  float acc = -INFINITY;
  if (valid) {
    const int64_t L = last[n];
    float cur_lon = lon[t0 * N + n], cur_lat = lat[t0 * N + n];
    // the neighbour before row t of a row that is not L; at row 0, pos_before
    // or the start-edge extrapolation (T >= 2 there, checked by the wrapper)
    float prev_lon, prev_lat;
    if (t0 > 0) {
      prev_lon = lon[(t0 - 1) * N + n];
      prev_lat = lat[(t0 - 1) * N + n];
    } else if (p.has_before) {
      prev_lon = before[n];
      prev_lat = before[N + n];
    } else {
      prev_lon = 2.0f * cur_lon - lon[N + n];
      prev_lat = 2.0f * cur_lat - lat[N + n];
    }
    // the extrapolation base of a track whose last sample is row 0 (read
    // in the first chunk only)
    const bool base_before = t0 == 0 && p.has_before;
    const float base_lon = base_before ? before[n] : cur_lon;
    const float base_lat = base_before ? before[N + n] : cur_lat;
    const float end_lon = p.has_after ? after[n] : 0.0f;
    const float end_lat = p.has_after ? after[N + n] : 0.0f;
    // the row after t: the next row, or past the segment's end pos_after
    // or row T-1 itself
    float nxt_lon = cur_lon, nxt_lat = cur_lat;
    if (t0 + 1 < T) {
      nxt_lon = lon[(t0 + 1) * N + n];
      nxt_lat = lat[(t0 + 1) * N + n];
    } else if (p.has_after) {
      nxt_lon = end_lon;
      nxt_lat = end_lat;
    }
    float v = tc_v[t0 * N + n];
    float4 w = shear_winds<kW>(wnds, t0 * N + n, p, W);
    bool live = alive[t0 * N + n] != 0;
    for (int t = t0; t < t1; ++t) {
      // row t+1's samples and row t+2's position, loaded ahead
      float v_n = 0.0f, lon_nn = 0.0f, lat_nn = 0.0f;
      float4 w_n = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      bool live_n = false;
      if (t + 1 < t1) {
        const int64_t o = (int64_t)(t + 1) * N + n;
        v_n = tc_v[o];
        w_n = shear_winds<kW>(wnds, o, p, W);
        live_n = alive[o] != 0;
      }
      if (t + 2 < T && t + 1 < t1) {
        lon_nn = lon[(int64_t)(t + 2) * N + n];
        lat_nn = lat[(int64_t)(t + 2) * N + n];
      }

      float b_lon = prev_lon, b_lat = prev_lat;
      float a_lon = nxt_lon, a_lat = nxt_lat;
      if (t == L) {
        // the last valid sample: next = pos[L] + (pos[L] - pos[L-1])
        const float P_lon = t == 0 ? base_lon : prev_lon;
        const float P_lat = t == 0 ? base_lat : prev_lat;
        b_lon = P_lon;
        b_lat = P_lat;
        a_lon = cur_lon + (cur_lon - P_lon);
        a_lat = cur_lat + (cur_lat - P_lat);
      }
      const float vm = vmax_at(p, cur_lat, b_lon, b_lat, a_lon, a_lat, v, w);
      vmax[(int64_t)t * N + n] = vm;
      acc = nan_max(acc, live ? vm : -INFINITY);

      prev_lon = cur_lon;
      prev_lat = cur_lat;
      cur_lon = nxt_lon;
      cur_lat = nxt_lat;
      if (t + 2 < T) {
        nxt_lon = lon_nn;
        nxt_lat = lat_nn;
      } else if (p.has_after) {
        nxt_lon = end_lon;
        nxt_lat = end_lat;
      }           // else row T-1's neighbour after is row T-1 (cur) itself
      v = v_n;
      w = w_n;
      live = live_n;
    }
  }

  if (gridDim.y == 1) {
    if (valid) peak[n] = acc;
    return;
  }
  // the cross-chunk peak: partials, then the last block reduces in order
  if (valid) partial[(int64_t)blockIdx.y * N + n] = acc;
  __threadfence();
  __syncthreads();
  __shared__ bool s_last;
  if (threadIdx.x == 0)
    s_last = atomicAdd(count + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (valid) {
    float r = -INFINITY;
    for (int c = 0; c < (int)gridDim.y; ++c)
      r = nan_max(r, __ldcg(partial + (int64_t)c * N + n));
    peak[n] = r;
  }
  if (threadIdx.x == 0) count[blockIdx.x] = 0u;
}

template <int kW>
__global__ void __launch_bounds__(kThreads)
vmax_kernel(const __grid_constant__ Params p, const float* __restrict__ lon,
            const float* __restrict__ lat, const float* __restrict__ tc_v,
            const float* __restrict__ wnds,
            const uint8_t* __restrict__ alive,
            const int64_t* __restrict__ last,
            const float* __restrict__ before,
            const float* __restrict__ after, float* __restrict__ vmax,
            float* __restrict__ peak, float* __restrict__ partial,
            unsigned* __restrict__ count) {
  vmax_pass<kW>(p, kW, lon, lat, tc_v, wnds, alive, last, before, after,
                vmax, peak, partial, count);
}

// the run-time-stride instance <0>: W winds per sample
template <int kW>
__global__ void __launch_bounds__(kThreads)
vmax_kernel(const __grid_constant__ Params p, const float* __restrict__ lon,
            const float* __restrict__ lat, const float* __restrict__ tc_v,
            const float* __restrict__ wnds,
            const uint8_t* __restrict__ alive,
            const int64_t* __restrict__ last,
            const float* __restrict__ before,
            const float* __restrict__ after, float* __restrict__ vmax,
            float* __restrict__ peak, float* __restrict__ partial,
            unsigned* __restrict__ count, int W) {
  static_assert(kW == 0, "the run-time-stride instance is <0>");
  vmax_pass<0>(p, W, lon, lat, tc_v, wnds, alive, last, before, after, vmax,
               peak, partial, count);
}

// The last-sample entry (diagnostics.fix_in_scan_plain, and
// fix_last_sample_plain on one segment): the in-scan vmax's fix of every
// track's final sample, over every segment of a launch in one launch.  A
// thread takes one column n of one segment k: its m slot a (a_idx[n], or
// n), its segment-local last step L = last[a] - edge_k, the sample at L
// with the reference's edge extrapolation next = pos[L] + (pos[L] -
// pos[L-1]) (pos[L-1] from the row before the segment where L is 0: the
// previous segment's last row at column order[n]), and where L lies in the
// segment and the track is alive there (ok), the fixed sample written in
// place and peak[a] = nan_max(peak[a], vmax_L), _bank's update of that
// slot.  last[a] - edge_k lies in [0, T_k) for one segment k at most, and
// a segment's slots are distinct, so each slot is written by one thread
// at most and no atomics are needed.  On one segment (the per-segment API)
// it also writes vmax_L and ok for every column.
//
// What bounds it: bytes, one sample per column (lon, lat at L and L-1, v,
// the shear winds, alive, last and the slot map), far below a launch's
// other work; one launch replaces a launch per segment and the torch
// operations around each (the pos_before gather, the slot map's index, the
// banking's scatter and maximum).  The grid covers the segments' widths
// back to back, each segment's blocks from its first_block (the segment of
// a block is the last one whose blocks start at or before it), as K4's
// gather pass finds its tensor.
constexpr int kMaxSegs = 16;

// one segment of the fix: its time-major [T, width] buffers (winds [T,
// width, W]) and vmax buffer (fixed in place), the m slot of each column
// (null: the column itself), and the row before its first (null: none),
// read at column order[n] (null: n)
struct LastSeg {
  const float *lon, *lat, *v, *wnds;
  const uint8_t* alive;
  float* vmax;
  const int64_t* a_idx;
  const int64_t* order;
  const float *before_lon, *before_lat;
  int64_t edge;
  int T, width, first_block;
};

// the segment table and what the segments share: the shear channels and
// constants (in sp), the last step of each slot on the launch's time axis,
// the banked peak (null: none) and, on one segment, vmax_L and ok (null:
// not written)
struct LastParams {
  Params sp;
  int n_segs;
  const int64_t* last;
  float* peak;
  float* vmax_L;
  uint8_t* ok;
  LastSeg segs[kMaxSegs];
};

template <int kW>
__device__ __forceinline__ void last_sample_pass(const LastParams& lp,
                                                 int W) {
  int k = 0;
  for (int s = 1; s < lp.n_segs; ++s)
    if (lp.segs[s].first_block <= (int)blockIdx.x) k = s;
  const LastSeg& g = lp.segs[k];
  const int n = ((int)blockIdx.x - g.first_block) * blockDim.x + threadIdx.x;
  if (n >= g.width) return;
  const int64_t N = g.width, T = g.T;
  const int64_t a = g.a_idx != nullptr ? g.a_idx[n] : n;
  const int64_t L = lp.last[a] - g.edge;
  const int64_t Lc = min(max(L, (int64_t)0), T - 1);
  const int64_t Lm1 = min(max(L - 1, (int64_t)0), T - 1);
  const float lon_L = g.lon[Lc * N + n], lat_L = g.lat[Lc * N + n];
  float lon_P = g.lon[Lm1 * N + n], lat_P = g.lat[Lm1 * N + n];
  if (g.before_lon != nullptr && L == 0) {
    const int64_t j = g.order != nullptr ? g.order[n] : n;
    lon_P = g.before_lon[j];
    lat_P = g.before_lat[j];
  }
  const float vm = vmax_at(lp.sp, lat_L, lon_P, lat_P,
                           lon_L + (lon_L - lon_P), lat_L + (lat_L - lat_P),
                           g.v[Lc * N + n],
                           shear_winds<kW>(g.wnds, Lc * N + n, lp.sp, W));
  const bool good = L >= 0 && L < T && g.alive[Lc * N + n] != 0;
  if (lp.vmax_L != nullptr) {
    lp.vmax_L[n] = vm;
    lp.ok[n] = good;
  }
  if (good) {
    g.vmax[Lc * N + n] = vm;
    if (lp.peak != nullptr) lp.peak[a] = nan_max(lp.peak[a], vm);
  }
}

template <int kW>
__global__ void __launch_bounds__(kThreads)
last_sample_kernel(const __grid_constant__ LastParams lp) {
  last_sample_pass<kW>(lp, kW);
}

// the run-time-stride instance <0>: W winds per sample
template <int kW>
__global__ void __launch_bounds__(kThreads)
last_sample_kernel(const __grid_constant__ LastParams lp, int W) {
  static_assert(kW == 0, "the run-time-stride instance is <0>");
  last_sample_pass<0>(lp, W);
}

// the shared parameter block of both entries; false if it is not valid
bool read_params(const int* ip, const float* fp, Params* p) {
  p->T = ip[0]; p->N = ip[1]; p->chunk = ip[2];
  p->has_before = ip[3]; p->has_after = ip[4];
  p->iu2 = ip[5]; p->iv2 = ip[6]; p->iu8 = ip[7]; p->iv8 = ip[8];
  p->c = vmaxc::Consts{fp[0], fp[1], fp[2]};
  const int W = ip[12];
  if (W < 4 || W % 2 != 0) return false;
  const int shear[4] = {p->iu2, p->iv2, p->iu8, p->iv8};
  for (int i : shear)
    if (i < 0 || i >= W) return false;
  // the pairs of the 8-byte loads
  return W == 4 || (p->iu2 % 2 == 0 && p->iv2 == p->iu2 + 1 &&
                    p->iu8 % 2 == 0 && p->iv8 == p->iu8 + 1);
}

}  // namespace

// ip: T, N, chunk, has_before, has_after, iu2, iv2, iu8, iv8, threads,
// storm blocks, chunks, W (any even W >= 4; the instance <W> at 4, 6 and
// 8, else <0>); fp: 1 / dt_s, km2, deg2rad.  partial [chunks, N]
// and count [storm blocks] (zeroed) are the wrapper's scratch, unread with
// one chunk.
extern "C" int tc_vmax(const int* ip, const float* fp, const float* lon,
                       const float* lat, const float* tc_v, const float* wnds,
                       const uint8_t* alive, const int64_t* last,
                       const float* before, const float* after, float* vmax,
                       float* peak, float* partial, unsigned* count,
                       void* stream) {
  Params p;
  const bool ok = read_params(ip, fp, &p);
  const int threads = ip[9], sblocks = ip[10], chunks = ip[11];
  if (!ok || p.T < 1 || p.N < 1 || p.chunk < 1 || threads < 32 ||
      threads > kThreads || threads % 32 != 0 ||
      (int64_t)sblocks * threads < p.N || chunks < 1 ||
      chunks > kMaxChunks || (int64_t)chunks * p.chunk < p.T ||
      (int64_t)(chunks - 1) * p.chunk >= p.T || (p.T < 2 && !p.has_before))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(sblocks, chunks);
  cudaStream_t s = (cudaStream_t)stream;
  switch (ip[12]) {
    case 4:
      vmax_kernel<4><<<grid, threads, 0, s>>>(p, lon, lat, tc_v, wnds, alive,
                                               last, before, after, vmax, peak,
                                               partial, count);
      break;
    case 6:
      vmax_kernel<6><<<grid, threads, 0, s>>>(p, lon, lat, tc_v, wnds, alive,
                                               last, before, after, vmax, peak,
                                               partial, count);
      break;
    case 8:
      vmax_kernel<8><<<grid, threads, 0, s>>>(p, lon, lat, tc_v, wnds, alive,
                                               last, before, after, vmax, peak,
                                               partial, count);
      break;
    default:
      vmax_kernel<0><<<grid, threads, 0, s>>>(p, lon, lat, tc_v, wnds, alive,
                                               last, before, after, vmax, peak,
                                               partial, count, ip[12]);
  }
  return (int)cudaGetLastError();
}

// The last-sample entry.  ip: n_segs, W, iu2, iv2, iu8, iv8, threads,
// blocks, last, peak, vmax_L, ok, then per segment edge, T, width,
// first_block, lon, lat, v, wnds, alive, vmax, a_idx, order, before_lon,
// before_lat (pointers as integers, 0 for null); fp: 1 / dt_s, km2,
// deg2rad.  vmax_L and ok only on one segment.
extern "C" int tc_vmax_last(const int64_t* ip, const float* fp,
                            void* stream) {
  LastParams lp{};
  int q = 0;
  lp.n_segs = (int)ip[q++];
  const int W = (int)ip[q++];
  int sp_ip[13] = {0};
  for (int i = 0; i < 4; ++i) sp_ip[5 + i] = (int)ip[q++];
  sp_ip[12] = W;
  const bool shear_ok = read_params(sp_ip, fp, &lp.sp);
  const int64_t threads = ip[q++], blocks = ip[q++];
  lp.last = reinterpret_cast<const int64_t*>(ip[q++]);
  lp.peak = reinterpret_cast<float*>(ip[q++]);
  lp.vmax_L = reinterpret_cast<float*>(ip[q++]);
  lp.ok = reinterpret_cast<uint8_t*>(ip[q++]);
  if (!shear_ok || lp.n_segs < 1 || lp.n_segs > kMaxSegs || threads < 32 ||
      threads > kThreads || threads % 32 != 0 || blocks < 1 ||
      blocks > INT32_MAX || lp.last == nullptr ||
      ((lp.vmax_L != nullptr || lp.ok != nullptr) &&
       (lp.n_segs != 1 || lp.vmax_L == nullptr || lp.ok == nullptr)))
    return (int)cudaErrorInvalidValue;
  int64_t next = 0;   // the first block after the segments so far
  for (int k = 0; k < lp.n_segs; ++k) {
    LastSeg& g = lp.segs[k];
    g.edge = ip[q++];
    const int64_t T = ip[q++], width = ip[q++], first = ip[q++];
    g.lon = reinterpret_cast<const float*>(ip[q++]);
    g.lat = reinterpret_cast<const float*>(ip[q++]);
    g.v = reinterpret_cast<const float*>(ip[q++]);
    g.wnds = reinterpret_cast<const float*>(ip[q++]);
    g.alive = reinterpret_cast<const uint8_t*>(ip[q++]);
    g.vmax = reinterpret_cast<float*>(ip[q++]);
    g.a_idx = reinterpret_cast<const int64_t*>(ip[q++]);
    g.order = reinterpret_cast<const int64_t*>(ip[q++]);
    g.before_lon = reinterpret_cast<const float*>(ip[q++]);
    g.before_lat = reinterpret_cast<const float*>(ip[q++]);
    if (T < 1 || T > INT32_MAX || width < 0 || width > INT32_MAX ||
        first != next ||
        (g.before_lon == nullptr) != (g.before_lat == nullptr))
      return (int)cudaErrorInvalidValue;
    g.T = (int)T;
    g.width = (int)width;
    g.first_block = (int)first;
    next = first + (width + threads - 1) / threads;
  }
  if (next != blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 4:
      last_sample_kernel<4><<<(unsigned)blocks, (unsigned)threads, 0, s>>>(lp);
      break;
    case 6:
      last_sample_kernel<6><<<(unsigned)blocks, (unsigned)threads, 0, s>>>(lp);
      break;
    case 8:
      last_sample_kernel<8><<<(unsigned)blocks, (unsigned)threads, 0, s>>>(lp);
      break;
    default:
      last_sample_kernel<0><<<(unsigned)blocks, (unsigned)threads, 0, s>>>(
          lp, W);
  }
  return (int)cudaGetLastError();
}
