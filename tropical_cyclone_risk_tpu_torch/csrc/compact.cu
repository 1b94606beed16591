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
//   stitch_kernel    one thread per (survivor, output step): the segment
//                    holding the step, the survivor's column there (its own
//                    slot, or the segment's inverse map), the six track
//                    fields NaN-masked where not alive, time second (the
//                    W = 2 x steering levels winds as one 16-byte word at
//                    W = 4, else as 8-byte pairs); and the survivor mask
//                    put back on the slot axis.
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

struct Seg {
  const float* f[kFields];
  const float* wnds;
  const uint8_t* alive;
  const int64_t* inv;       // null for segment 0
  const uint8_t* sel;       // null for segment 0
  int64_t edge, width;
};

struct StitchParams {
  const int64_t* order;
  int64_t k, T, n;
  int n_segs;
  float* out[kFields];
  float* out_wnds;
  int W;                    // winds per sample
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

// kVec4: four winds per sample (one 16-byte word), else p.W as 8-byte pairs
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
stitch_kernel(const __grid_constant__ StitchParams p) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t kT = p.k * p.T;
  if (g >= kT) {
    const int64_t q = g - kT;                 // keep back on the slot axis
    if (q < p.n) {
      const int64_t r = p.rank[q];
      p.keep_full[q] = r >= 0 ? p.keep[r] : 0;
    }
    return;
  }
  const int64_t j = g / p.T, t = g - j * p.T;
  int s = p.n_segs - 1;
  while (s > 0 && t < p.segs[s].edge) --s;
  const Seg& sg = p.segs[s];
  const int64_t slot = p.order[j];
  int64_t col = slot;
  bool alive = true;
  if (s > 0) {
    col = sg.inv[slot];
    alive = sg.sel[slot] != 0;
  }
  const int64_t o = (t - sg.edge) * sg.width + col;
  alive = alive && sg.alive[o] != 0;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int f = 0; f < kFields; ++f) p.out[f][g] = alive ? sg.f[f][o] : nan;
  if constexpr (kVec4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(sg.wnds) + o);
    reinterpret_cast<float4*>(p.out_wnds)[g] =
        alive ? w : make_float4(nan, nan, nan, nan);
  } else {
    const int pairs = p.W / 2;
    const float2* src = reinterpret_cast<const float2*>(sg.wnds) + o * pairs;
    float2* dst = reinterpret_cast<float2*>(p.out_wnds) + g * pairs;
    for (int c = 0; c < pairs; ++c)
      dst[c] = alive ? __ldg(src + c) : make_float2(nan, nan);
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

// ip: k, T, n, n_segs, W, order, out (lon, lat, v, m, vmax), out_wnds,
// rank, keep, keep_full, then per segment: edge, width, the five fields,
// wnds, alive, inv, sel
extern "C" int tc_k4_stitch(const int64_t* ip, void* stream) {
  StitchParams p;
  int q = 0;
  p.k = ip[q++];
  p.T = ip[q++];
  p.n = ip[q++];
  p.n_segs = (int)ip[q++];
  p.W = (int)ip[q++];
  if (p.n_segs < 1 || p.n_segs > kMaxSegs || p.W < 2 || p.W % 2 != 0)
    return (int)cudaErrorInvalidValue;
  p.order = reinterpret_cast<const int64_t*>(ip[q++]);
  for (int f = 0; f < kFields; ++f) p.out[f] = reinterpret_cast<float*>(ip[q++]);
  p.out_wnds = reinterpret_cast<float*>(ip[q++]);
  p.rank = reinterpret_cast<const int64_t*>(ip[q++]);
  p.keep = reinterpret_cast<const uint8_t*>(ip[q++]);
  p.keep_full = reinterpret_cast<uint8_t*>(ip[q++]);
  for (int i = 0; i < p.n_segs; ++i) {
    Seg& sg = p.segs[i];
    sg.edge = ip[q++];
    sg.width = ip[q++];
    for (int f = 0; f < kFields; ++f) sg.f[f] = reinterpret_cast<const float*>(ip[q++]);
    sg.wnds = reinterpret_cast<const float*>(ip[q++]);
    sg.alive = reinterpret_cast<const uint8_t*>(ip[q++]);
    sg.inv = reinterpret_cast<const int64_t*>(ip[q++]);
    sg.sel = reinterpret_cast<const uint8_t*>(ip[q++]);
  }
  const int64_t threads = p.k * p.T + (p.rank != nullptr ? p.n : 0);
  if (threads == 0) return (int)cudaSuccess;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  auto kern = p.W == 4 ? stitch_kernel<true> : stitch_kernel<false>;
  kern<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
