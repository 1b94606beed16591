// K4: the launch's compactions for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA-fused compaction idiom of the JAX package (no Pallas
// kernel; XLA fused these jnp functions):
//   ops/compact.py:30 stable_partition_order (the prefix-sum form of
//     argsort(where(mask, slot, slot + n))[:w]) and the jnp.take /
//     .at[].set around it in models/pipeline.py: launch_inputs' integrate
//     compaction (:392-404, with fourier.take_leading), the re-compaction
//     boundaries of launch_body (:455-469), the keep and segment-map
//     scatters (:556-560, :571-572) and compact_survivors (:618-651).
// Its plain PyTorch twins are ops/compact.py partition_take_plain and
// stitch_survivors_plain.
//
// Four kernels, at most three per partition:
//   count_kernel     per-tile true counts of the mask (and, in the spare
//                    threads, the zero fill of the inverse-map buffer);
//   partition_kernel one block per tile: the tiles before it and the total
//                    from count_kernel's output, a block scan of the tile,
//                    then each slot's rank (True: count before it; False:
//                    total + slot - inclusive count) and, for ranks < w, the
//                    order, the composed map and its inverse; each slot's
//                    rank (-1 past w) on request; the overflow
//                    max(count - w, 0) on the device;
//   gather_kernel    the row copies, as a pass over the destination: one
//                    launch over every output row tensor, each block on one
//                    tensor, each thread kUnroll words of it, a word being
//                    16, 8, 4, 2 or 1 bytes by the alignment of the tensor's
//                    pointers and row size (kernels/compact.py gather_plan);
//                    a thread reads order[row] and copies one word of that
//                    source row to the next word of the dense output;
//   stitch_kernel    the survivor stitch: one block per tile of kStitchSurv
//                    survivors x TS steps lying in one segment (TS a power
//                    of two up to kStitchSteps; kernels/compact.py
//                    stitch_plan), step tiles fastest, then the survivor
//                    mask put back on the slot axis in blocks of its own.
//                    A block finds its segment from blockIdx alone (the
//                    count of segments whose first tile, in one table, is
//                    at or before its own), loads its survivors' column
//                    (the slot itself, or the segment's inverse map) and
//                    selected flag once into shared memory, reads the five
//                    track fields and alive with lanes over survivors at
//                    one step and writes them NaN-masked with lanes over
//                    the steps of one survivor's output row, through
//                    shared memory; the W = 2 x steering levels winds are
//                    copied without a turn, the tile's 16- or 8-byte words
//                    spread over lanes by (survivor, step, word).
//
// What bounds it on this card: bytes.  Each input (mask, rows, time-major
// buffers) is read once and each output written once; the arithmetic is a
// few integer operations per slot.  The first form copied each gathered
// row inside partition_kernel, one thread per slot walking every row
// tensor in turn: 40 blocks at n = 40960 on 132 SMs, few loads in flight,
// and ~0.05 ms whatever n.  The gather pass instead walks the destination:
// writes are coalesced, consecutive threads read consecutive words of a
// source row (a [4, 15] Fourier row is 15 16-byte words of 15 threads),
// each thread issues its kUnroll loads before its stores, and the grid is
// sized by the words to move (at n = 40960 with the launch's 11 row
// tensors ~1500 blocks of 256 threads, 16 KB of 16-byte loads in flight
// per block), so every SM holds tens of KB of loads in flight at every n.
// Separate kernels keep the order logic's tiles (1024 slots, one block
// each) apart from the copy's grid.  Nothing synchronises with the host:
// the overflow stays on the device, as the twin's does.  Everything is
// integer or a copy, so the results equal the twin's bit for bit.
//
// The stitch is a column gather out of time-major [T_s, w_s] buffers into
// survivor-major [k, T] rows, and the card moves 32-byte sectors: a
// 4-byte value read alone costs a sector.  Survivors come in ascending
// slot order and keep it in every later segment (the compactions are
// stable), so where they are dense (late, narrow segments; k_max = m)
// neighbouring survivors share sectors.  The tiled form reads with lanes over survivors, so such
// neighbours share each sector of a warp's load, and turns the tile in
// shared memory (an XOR swizzle by step keeps both the survivor-fastest
// writes and the step-fastest reads free of bank conflicts at every TS)
// so that the [k, T] writes are runs along a row.  The winds need no turn:
// a sample's W floats are contiguous in both layouts, so lanes run over
// (step, word) of one survivor and both sides are runs.  Each thread
// issues its loads before its stores, the first round of wind loads
// before the tile's barrier; alive && selected is formed once per
// (survivor, step) and kept in shared memory for the winds.  The plan
// keeps the bench's [64, 361] at 132 blocks or more (TS shrinks while
// fewer tiles than SMs: a latency of three dependent loads, order, map,
// data), and a tile's winds within four rounds of kWindBytes a thread (TS
// shrinks as W grows); the staging is static, 24960 bytes at every W.
// Step tiles run fastest so that a survivor tile's rows are written by
// neighbouring blocks: with survivor tiles fastest, or with a block
// walking several tiles, the rows in flight spread over more of the
// output and the dense stitches ran slower on the H100.  What a dense
// stitch (k_max = m) still pays is its writes in 128-byte row pieces that
// start at any 4-byte offset (T is odd), not whole aligned lines.
//
// Each C entry returns cudaGetLastError() after its launches; the wrapper
// (kernels/compact.py) raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                    // slots per thread
constexpr int kTile = kThreads * kPer;     // slots per block
constexpr int kMaxRows = 16;
constexpr int kGatherThreads = 256;
constexpr int kUnroll = 4;                 // words per gather thread
constexpr int kMaxSegs = 16;
constexpr int kFields = 5;                 // lon, lat, v, m, vmax
constexpr unsigned kFull = 0xffffffffu;
// the stitch: survivors a tile (a warp's lanes), most steps a tile, threads
// a block, (survivor, step) cells a thread, wind bytes a thread loads per
// round and keep_full slots a thread of the tail (kernels/compact.py
// stitch_plan reads these)
constexpr int kLogSurv = 5;
constexpr int kStitchSurv = 1 << kLogSurv;
constexpr int kStitchSteps = 32;
constexpr int kStitchThreads = 256;
constexpr int kTileCells = kStitchSurv * kStitchSteps;
constexpr int kCellRounds = kTileCells / kStitchThreads;
constexpr int kWindBytes = 64;
constexpr int kKeepPer = 4;

// one row tensor of the gather pass, planned by kernels/compact.py
struct GatherRow {
  const unsigned char* src;
  unsigned char* dst;
  uint32_t words;           // k * words per row
  uint32_t wpr;             // words per row
  int word_bytes;           // 16, 8, 4, 2 or 1
  int first_block;          // this tensor's blocks start here
};

struct GatherParams {
  const int64_t* order;
  int n_rows;
  GatherRow rows[kMaxRows];
};

struct PartParams {
  const uint8_t* mask;
  int64_t n, w;
  int n_tiles;
  const int32_t* counts;
  int64_t* order;
  int64_t* overflow;
  const int64_t* acc;       // may be null
  int64_t* rank;            // may be null
  const int64_t* a_prev;    // may be null: the identity
  int64_t* a_out;           // may be null
  int64_t* inv;             // may be null
  uint8_t* sel;             // may be null
};

// one segment of the stitch
struct Seg {
  const float* f[kFields];
  const float* wnds;
  const uint8_t* alive;
  const int64_t* inv;       // null for segment 0
  const uint8_t* sel;       // null for segment 0
  int64_t width;
  int edge, steps;
};

struct StitchParams {
  int first_tile[kMaxSegs]; // each segment's first step tile, back to back
  const int64_t* order;
  int64_t k, T, n;
  int n_segs;
  int W;                    // winds per sample
  int log_ts;               // log2 of a tile's steps
  int step_tiles;           // over every segment
  int tile_blocks;          // tiles of kStitchSurv survivors x step_tiles
  float* out[kFields];
  float* out_wnds;
  const int64_t* rank;      // may be null
  const uint8_t* keep;
  uint8_t* keep_full;
  Seg segs[kMaxSegs];
};

__device__ __forceinline__ int64_t warp_sum(int64_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, int64_t n, int n_tiles,
             int32_t* __restrict__ counts, unsigned char* zero,
             int64_t zero_bytes) {
  __shared__ int64_t s_warp[kWarps];
  if (blockIdx.x < n_tiles) {
    const int64_t base = (int64_t)blockIdx.x * kTile;
    int64_t c = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int64_t s = base + q * kThreads + threadIdx.x;
      if (s < n) c += mask[s] != 0;
    }
    c = warp_sum(c);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
      int64_t t = 0;
      for (int i = 0; i < kWarps; ++i) t += s_warp[i];
      counts[blockIdx.x] = (int32_t)t;
    }
  }
  if (zero != nullptr) {
    const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    const int64_t n16 = zero_bytes / 16;
    for (int64_t i = tid; i < n16; i += stride)
      reinterpret_cast<uint4*>(zero)[i] = make_uint4(0, 0, 0, 0);
    for (int64_t i = n16 * 16 + tid; i < zero_bytes; i += stride) zero[i] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
partition_kernel(const __grid_constant__ PartParams p) {
  __shared__ int64_t s_pre[kWarps], s_tot[kWarps];
  __shared__ int s_scan[kWarps];
  __shared__ int64_t s_base[2];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;

  // true slots in the tiles before this one, and in all of them
  int64_t pre = 0, tot = 0;
  for (int t = threadIdx.x; t < p.n_tiles; t += kThreads) {
    const int64_t c = p.counts[t];
    tot += c;
    if (t < (int)blockIdx.x) pre += c;
  }
  pre = warp_sum(pre);
  tot = warp_sum(tot);
  if (lane == 0) { s_pre[wid] = pre; s_tot[wid] = tot; }

  // this thread's kPer consecutive slots and its exclusive scan in the tile
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kPer;
  bool mk[kPer];
  int c = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    mk[q] = base + q < p.n && p.mask[base + q] != 0;
    c += mk[q];
  }
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[wid] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t a = 0, b = 0;
    for (int i = 0; i < kWarps; ++i) { a += s_pre[i]; b += s_tot[i]; }
    s_base[0] = a;
    s_base[1] = b;
    int run = 0;
    for (int i = 0; i < kWarps; ++i) { const int v = s_scan[i]; s_scan[i] = run; run += v; }
  }
  __syncthreads();
  const int64_t total = s_base[1];
  int64_t cin = s_base[0] + s_scan[wid] + (x - c);   // true slots before

  for (int q = 0; q < kPer; ++q) {
    const int64_t s = base + q;
    if (s >= p.n) break;
    cin += mk[q];                                     // inclusive count
    const int64_t rank = mk[q] ? cin - 1 : total + s - cin;
    const bool in = rank < p.w;
    if (p.rank != nullptr) p.rank[s] = in ? rank : -1;
    if (!in) continue;
    p.order[rank] = s;
    if (p.a_out != nullptr) {
      const int64_t a = p.a_prev != nullptr ? p.a_prev[s] : s;
      p.a_out[rank] = a;
      if (p.inv != nullptr) p.inv[a] = rank;
      if (p.sel != nullptr) p.sel[a] = 1;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int64_t o = total > p.w ? total - p.w : 0;
    if (p.acc != nullptr) o += p.acc[0];
    p.overflow[0] = o;
  }
}

// kUnroll words of one row tensor: all loads first, then the stores
template <typename Word>
__device__ __forceinline__ void gather_words(const GatherRow& r,
                                             const int64_t* __restrict__ order,
                                             uint32_t e0) {
  const Word* __restrict__ src = reinterpret_cast<const Word*>(r.src);
  Word* __restrict__ dst = reinterpret_cast<Word*>(r.dst);
  Word v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const uint32_t e = e0 + u * kGatherThreads;
    if (e < r.words) {
      const uint32_t row = r.wpr == 1 ? e : e / r.wpr;
      const uint32_t col = e - row * r.wpr;
      v[u] = __ldg(src + order[row] * r.wpr + col);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const uint32_t e = e0 + u * kGatherThreads;
    if (e < r.words) dst[e] = v[u];
  }
}

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const __grid_constant__ GatherParams p) {
  // the tensor owning this block: the last one whose blocks start at or
  // before it (a tensor with no words has no blocks)
  int r = 0;
  for (int i = 1; i < p.n_rows; ++i)
    if (p.rows[i].first_block <= (int)blockIdx.x) r = i;
  const GatherRow& row = p.rows[r];
  const uint32_t e0 = (uint32_t)((int)blockIdx.x - row.first_block) *
                          (kGatherThreads * kUnroll) + threadIdx.x;
  switch (row.word_bytes) {
    case 16: gather_words<uint4>(row, p.order, e0); break;
    case 8: gather_words<uint2>(row, p.order, e0); break;
    case 4: gather_words<unsigned int>(row, p.order, e0); break;
    case 2: gather_words<unsigned short>(row, p.order, e0); break;
    default: gather_words<unsigned char>(row, p.order, e0); break;
  }
}

template <typename Word>
__device__ __forceinline__ Word nan_word();
template <>
__device__ __forceinline__ uint4 nan_word<uint4>() {
  return make_uint4(0x7fc00000u, 0x7fc00000u, 0x7fc00000u, 0x7fc00000u);
}
template <>
__device__ __forceinline__ uint2 nan_word<uint2>() {
  return make_uint2(0x7fc00000u, 0x7fc00000u);
}

// Word: the winds' 16- or 8-byte word
template <typename Word>
__global__ void __launch_bounds__(kStitchThreads)
stitch_kernel(const __grid_constant__ StitchParams p) {
  __shared__ float s_val[kFields][kTileCells];
  __shared__ int s_live[kTileCells];
  __shared__ int64_t s_col[kStitchSurv];
  __shared__ int s_on[kStitchSurv];
  const int b = (int)blockIdx.x, tid = (int)threadIdx.x;
  if (b >= p.tile_blocks) {                 // keep back on the slot axis
    const int64_t q0 = (int64_t)(b - p.tile_blocks) *
                           (kStitchThreads * kKeepPer) + tid;
    int64_t r[kKeepPer];
    uint8_t v[kKeepPer];
#pragma unroll
    for (int u = 0; u < kKeepPer; ++u) {
      const int64_t q = q0 + u * kStitchThreads;
      r[u] = q < p.n ? p.rank[q] : -1;
    }
#pragma unroll
    for (int u = 0; u < kKeepPer; ++u) v[u] = r[u] >= 0 ? p.keep[r[u]] : 0;
#pragma unroll
    for (int u = 0; u < kKeepPer; ++u) {
      const int64_t q = q0 + u * kStitchThreads;
      if (q < p.n) p.keep_full[q] = v[u];
    }
    return;
  }

  // the block's tile, step tiles fastest (a survivor tile's rows are
  // written by neighbouring blocks); its segment is the number of later
  // segments whose first tile is at or before it (uniform)
  const int sv = b / p.step_tiles, st = b - sv * p.step_tiles;
  int s = 0;
#pragma unroll
  for (int i = 1; i < kMaxSegs; ++i)
    s += i < p.n_segs && p.first_tile[i] <= st;
  const Seg& g = p.segs[s];
  const int lts = p.log_ts, ts = 1 << lts;
  const int swz = kLogSurv - lts;           // cell (tt, i) at tt * 32 + (i ^ tt << swz)
  const int tt0 = (st - p.first_tile[s]) << lts;       // in the segment
  const int n_steps = min(ts, g.steps - tt0);
  const int64_t j0 = (int64_t)sv * kStitchSurv;
  const int n_surv = p.k - j0 < kStitchSurv ? (int)(p.k - j0) : kStitchSurv;
  const int64_t t_out = (int64_t)g.edge + tt0;         // on the output's T

  // the tile's survivors: column and selected flag in this segment
  if (tid < kStitchSurv) {
    int64_t col = 0;
    int on = 0;
    if (tid < n_surv) {
      const int64_t slot = p.order[j0 + tid];
      col = slot;
      on = 1;
      if (g.inv != nullptr) {
        col = g.inv[slot];
        on = g.sel[slot] != 0;
      }
    }
    s_col[tid] = col;
    s_on[tid] = on;
  }
  __syncthreads();

  // the winds: word e of the tile is (survivor i, step tt, word c), c
  // fastest; a thread's round is kU words kStitchThreads apart
  constexpr int kU = kWindBytes / (int)sizeof(Word);
  const int wv = p.W * 4 / (int)sizeof(Word);
  const int n_words = (kStitchSurv << lts) * wv;
  const Word* __restrict__ src = reinterpret_cast<const Word*>(g.wnds);
  Word* __restrict__ dst = reinterpret_cast<Word*>(p.out_wnds);
  Word w[kU];
  int at[kU];                               // c << 10 | i << 5 | tt, or -1
  // loads of the round from e0 where the survivor is selected (live: and
  // the sample alive)
  auto load_round = [&](int e0, bool live) {
    int q = e0 / wv, c = e0 - q * wv;
    const int dq = kStitchThreads / wv, dc = kStitchThreads - dq * wv;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = q >> lts, tt = q & (ts - 1);
      const bool in = e0 + u * kStitchThreads < n_words && i < n_surv &&
                      tt < n_steps;
      at[u] = in ? (c << 10 | i << 5 | tt) : -1;
      if (in && (live ? s_live[tt * kStitchSurv + (i ^ tt << swz)] != 0
                      : s_on[i] != 0))
        w[u] = __ldg(src + ((int64_t)(tt0 + tt) * g.width + s_col[i]) * wv + c);
      q += dq;
      c += dc;
      if (c >= wv) {
        c -= wv;
        ++q;
      }
    }
  };
  auto store_round = [&]() {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (at[u] < 0) continue;
      const int i = at[u] >> 5 & (kStitchSurv - 1), tt = at[u] & 31,
                c = at[u] >> 10;
      const bool live = s_live[tt * kStitchSurv + (i ^ tt << swz)] != 0;
      dst[((j0 + i) * p.T + t_out + tt) * wv + c] =
          live ? w[u] : nan_word<Word>();
    }
  };

  // read: lanes over survivors at one step, every load before a store
  const int cells = n_steps << kLogSurv;
  float v[kCellRounds][kFields];
  uint8_t a[kCellRounds];
#pragma unroll
  for (int r = 0; r < kCellRounds; ++r) {
    const int c = tid + r * kStitchThreads;
    const int tt = c >> kLogSurv, i = c & (kStitchSurv - 1);
    a[r] = 0;
    if (c < cells && s_on[i] != 0) {
      const int64_t o = (int64_t)(tt0 + tt) * g.width + s_col[i];
      a[r] = __ldg(g.alive + o);
#pragma unroll
      for (int f = 0; f < kFields; ++f) v[r][f] = __ldg(g.f[f] + o);
    }
  }
  load_round(tid, false);
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int r = 0; r < kCellRounds; ++r) {
    const int c = tid + r * kStitchThreads;
    const int tt = c >> kLogSurv, i = c & (kStitchSurv - 1);
    if (c < cells) {
      const int cell = tt * kStitchSurv + (i ^ tt << swz);
      const bool live = a[r] != 0;
      s_live[cell] = live;
#pragma unroll
      for (int f = 0; f < kFields; ++f) s_val[f][cell] = live ? v[r][f] : nan;
    }
  }
  __syncthreads();

  // write: lanes over the steps of one survivor's row
#pragma unroll
  for (int r = 0; r < kCellRounds; ++r) {
    const int c = tid + r * kStitchThreads;
    const int i = c >> lts, tt = c & (ts - 1);
    if (c < (kStitchSurv << lts) && i < n_surv && tt < n_steps) {
      const int cell = tt * kStitchSurv + (i ^ tt << swz);
      const int64_t o = (j0 + i) * p.T + t_out + tt;
#pragma unroll
      for (int f = 0; f < kFields; ++f) p.out[f][o] = s_val[f][cell];
    }
  }
  store_round();
  for (int e0 = tid + kU * kStitchThreads; e0 < n_words;
       e0 += kU * kStitchThreads) {
    load_round(e0, true);
    store_round();
  }
}

}  // namespace

// ip: n, w, n_tiles, mask, counts, order, overflow, acc, rank, a_prev,
// a_out, inv, sel, zero, zero_bytes, n_rows, gather blocks, then per row
// (src, dst, words, words per row, word bytes, first block)
extern "C" int tc_k4_partition(const int64_t* ip, void* stream) {
  PartParams p;
  GatherParams g;
  int q = 0;
  p.n = ip[q++];
  p.w = ip[q++];
  p.n_tiles = (int)ip[q++];
  p.mask = reinterpret_cast<const uint8_t*>(ip[q++]);
  int32_t* counts = reinterpret_cast<int32_t*>(ip[q++]);
  p.counts = counts;
  p.order = reinterpret_cast<int64_t*>(ip[q++]);
  p.overflow = reinterpret_cast<int64_t*>(ip[q++]);
  p.acc = reinterpret_cast<const int64_t*>(ip[q++]);
  p.rank = reinterpret_cast<int64_t*>(ip[q++]);
  p.a_prev = reinterpret_cast<const int64_t*>(ip[q++]);
  p.a_out = reinterpret_cast<int64_t*>(ip[q++]);
  p.inv = reinterpret_cast<int64_t*>(ip[q++]);
  p.sel = reinterpret_cast<uint8_t*>(ip[q++]);
  unsigned char* zero = reinterpret_cast<unsigned char*>(ip[q++]);
  const int64_t zero_bytes = ip[q++];
  g.order = p.order;
  g.n_rows = (int)ip[q++];
  const int64_t gather_blocks = ip[q++];
  if (g.n_rows > kMaxRows || gather_blocks < 0 || gather_blocks > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < g.n_rows; ++r) {
    GatherRow& row = g.rows[r];
    row.src = reinterpret_cast<const unsigned char*>(ip[q++]);
    row.dst = reinterpret_cast<unsigned char*>(ip[q++]);
    row.words = (uint32_t)ip[q++];
    row.wpr = (uint32_t)ip[q++];
    row.word_bytes = (int)ip[q++];
    row.first_block = (int)ip[q++];
  }
  cudaStream_t s = (cudaStream_t)stream;
  int64_t zero_blocks = zero != nullptr ? (zero_bytes / 16 + kThreads - 1) / kThreads : 0;
  if (zero_blocks > 1024) zero_blocks = 1024;
  const int grid = (int)(zero_blocks > p.n_tiles ? zero_blocks : p.n_tiles);
  count_kernel<<<grid, kThreads, 0, s>>>(p.mask, p.n, p.n_tiles, counts, zero,
                                         zero_bytes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  partition_kernel<<<p.n_tiles, kThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || gather_blocks == 0) return (int)err;
  gather_kernel<<<(unsigned)gather_blocks, kGatherThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// ip: k, T, n, n_segs, W, wind word bytes, log2 of a tile's steps, step
// tiles, tile blocks, keep blocks, order, out (lon, lat, v, m, vmax),
// out_wnds, rank, keep, keep_full, then per segment: edge, steps, width,
// first tile, the five fields, wnds, alive, inv, sel (the tiles and blocks
// of kernels/compact.py stitch_plan, from _stitch)
extern "C" int tc_k4_stitch(const int64_t* ip, void* stream) {
  StitchParams p;
  int q = 0;
  p.k = ip[q++];
  p.T = ip[q++];
  p.n = ip[q++];
  p.n_segs = (int)ip[q++];
  p.W = (int)ip[q++];
  const int64_t word = ip[q++];
  p.log_ts = (int)ip[q++];
  p.step_tiles = (int)ip[q++];
  p.tile_blocks = (int)ip[q++];
  const int64_t keep_blocks = ip[q++];
  if (p.n_segs < 1 || p.n_segs > kMaxSegs || (word != 8 && word != 16))
    return (int)cudaErrorInvalidValue;
  p.order = reinterpret_cast<const int64_t*>(ip[q++]);
  for (int f = 0; f < kFields; ++f) p.out[f] = reinterpret_cast<float*>(ip[q++]);
  p.out_wnds = reinterpret_cast<float*>(ip[q++]);
  p.rank = reinterpret_cast<const int64_t*>(ip[q++]);
  p.keep = reinterpret_cast<const uint8_t*>(ip[q++]);
  p.keep_full = reinterpret_cast<uint8_t*>(ip[q++]);
  for (int i = 0; i < kMaxSegs; ++i) p.first_tile[i] = 0;
  for (int i = 0; i < p.n_segs; ++i) {
    Seg& sg = p.segs[i];
    sg.edge = (int)ip[q++];
    sg.steps = (int)ip[q++];
    sg.width = ip[q++];
    p.first_tile[i] = (int)ip[q++];
    for (int f = 0; f < kFields; ++f) sg.f[f] = reinterpret_cast<const float*>(ip[q++]);
    sg.wnds = reinterpret_cast<const float*>(ip[q++]);
    sg.alive = reinterpret_cast<const uint8_t*>(ip[q++]);
    sg.inv = reinterpret_cast<const int64_t*>(ip[q++]);
    sg.sel = reinterpret_cast<const uint8_t*>(ip[q++]);
  }
  if (p.tile_blocks + keep_blocks == 0) return (int)cudaSuccess;
  auto kern = word == 16 ? stitch_kernel<uint4> : stitch_kernel<uint2>;
  kern<<<(unsigned)(p.tile_blocks + keep_blocks), kStitchThreads, 0,
         (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
