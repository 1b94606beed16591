// The field stacks: the corner-packed gather rows of models/fields.py
// GatherStacks for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its stacks with
// jnp.concatenate and ops/interp.py pack_corners, which XLA fuses.  Its
// plain PyTorch twin is models/fields.py build_stacks_plain, the same chain
// in torch (a cat of the sources, three edge-shifted copies and a cat of
// the four), which writes the output once and every intermediate once
// more: at 17 steering levels about 36 GB of traffic a launch for an 8 GB
// output.
//
// What it computes: out[p, i, j, :] = [src(i, j) | src(i, j+1) |
// src(i+1, j) | src(i+1, j+1)] of C channels each, the indices clamped to
// the last row and column, where src(i, j) of plane p is the channel
// concatenation of up to kMaxSources sources, each [P, H, W, c] or one
// plane [H, W, c] shared by every p (land and bathymetry: a plane stride of
// 0, read from the one plane, never expanded).  A pure copy: the output is
// the twin's bit for bit.
//
// What bounds it on this card: bytes.  The least traffic is every source
// float read once and every output float written once (2 + 8 GB at 17
// levels, 3 ms at 3.35 TB/s); nothing is computed.  Design:
//  - a block owns a tile of `tile` cells of one plane's row and walks a
//    strip of `strip` rows down the grid.  Output row i needs source rows
//    i and i+1 over the tile's columns and one more (tile + 1 cells); row
//    i+1 is kept as the next step's row i, so each source row is read
//    (strip + 1) / strip times and each column (tile + 1) / tile times;
//  - the rows are staged in shared memory as concatenated cell rows (C
//    floats a cell, the sources side by side), because the sources' own
//    rows are not 16-byte aligned (629 wind channels: 2516 bytes a cell)
//    and do not interleave: each source row is one contiguous run of
//    (tile + 1) c floats in device memory, copied with 4-byte cp.async by
//    consecutive threads on consecutive floats, the clamped last column
//    read again in place of the one past the edge;
//  - three row buffers: while a step writes row i from buffers i and i+1,
//    the copy of row i+2 is in flight;
//  - the output of a tile row is contiguous (tile cells of 4C floats, a
//    cell's two upper corners being two neighbouring staged cells of row
//    i, its lower ones of row i+1), written by consecutive threads on
//    consecutive words with streaming stores (st.global.cs: the output is
//    read by later kernels, not by this one).  The word is 16 bytes where
//    C is a multiple of 4 (every staged cell then starts 16-byte aligned,
//    and no word straddles a corner), 8 where C is even, else 4;
//  - each thread's walk over a row's (cell, channel) pairs advances by a
//    running quotient and remainder (Walk), computed once a block: no
//    division per element;
//  - the wrapper (kernels/stacks.py plan) takes the tile from C and the
//    227 KB of shared memory an SM has, sized for eight blocks an SM (its
//    2048 threads; at most MAX_TILE cells), and a strip of four rows: more
//    blocks in flight beat fewer source bytes (a row read 1.25 times, at
//    17 levels a column 1.5 times), within 4% of the fastest plan timed
//    on an H100.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSources = 4;
constexpr int kThreads = 256;
constexpr int kBuffers = 3;
constexpr int64_t kDefaultDynamicBytes = 48 * 1024;
constexpr int64_t kMaxSharedBytes = 227 * 1024;

struct Params {
  const float* src[kMaxSources];
  int64_t plane[kMaxSources];  // floats from one plane to the next (0: one)
  int ch[kMaxSources];         // channels of each source
  int n_src, P, H, W, C;       // sources; planes, rows, columns, channels
  int tile, strip;             // cells and rows a block writes
  float* out;                  // [P, H, W, 4C]
};

// a thread's walk over the elements t, t + kThreads, ... of a [rows,
// width] array: its (row, col), advanced by the step's quotient and
// remainder
struct Walk {
  int row, col, drow, dcol;
  __device__ Walk() {}
  __device__ Walk(int start, int width)
      : row(start / width),
        col(start % width),
        drow(kThreads / width),
        dcol(kThreads % width) {}
  __device__ __forceinline__ void next(int width) {
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// copy source row r of plane pl over staged cells 0..n (columns j0..j0+n,
// the last clamped) into buf, each source at its channel offset
__device__ __forceinline__ void stage_row(const Params& p,
                                          const Walk (&walk)[kMaxSources],
                                          int pl, int r, int j0, int n,
                                          float* buf) {
  int off = 0;
#pragma unroll
  for (int k = 0; k < kMaxSources; ++k) {
    if (k < p.n_src) {
      const int ch = p.ch[k];
      const float* row = p.src[k] + pl * p.plane[k] + (int64_t)r * p.W * ch;
      for (Walk w = walk[k]; w.row <= n; w.next(ch)) {
        const int col = min(j0 + w.row, p.W - 1);
        cp_async4(buf + w.row * p.C + off + w.col, row + col * ch + w.col);
      }
      off += ch;
    }
  }
}

// write one tile row: n cells of 4c words (c = C / the word's floats)
// from the staged rows top (i) and bot (i+1)
template <typename V>
__device__ __forceinline__ void emit_row(const V* top, const V* bot, V* dst,
                                         Walk w, int start, int n, int c) {
  const int c2 = 2 * c, c4 = 4 * c, total = n * c4;
#pragma unroll 4
  for (int o = start; o < total; o += kThreads) {
    const bool lower = w.col >= c2;
    const V v = (lower ? bot : top)[w.row * c + w.col - (lower ? c2 : 0)];
    __stcs(dst + o, v);
    w.next(c4);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    stack_corners_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x;
  const int pl = blockIdx.z;
  const int j0 = blockIdx.x * p.tile, i0 = blockIdx.y * p.strip;
  const int n = min(p.tile, p.W - j0), rows = min(p.strip, p.H - i0);
  const int stage = (p.tile + 1) * p.C;  // floats a staged row
  constexpr int kWord = sizeof(V) / sizeof(float);
  const int c = p.C / kWord;

  Walk walk[kMaxSources];
#pragma unroll
  for (int k = 0; k < kMaxSources; ++k)
    if (k < p.n_src) walk[k] = Walk(t, p.ch[k]);
  const Walk out_walk(t, 4 * c);
  // output row i reads source rows i and i+1 (the last clamped): the
  // strip reads rows i0 .. i0 + rows
  const int last = p.H - 1;

  stage_row(p, walk, pl, i0, j0, n, smem);
  cp_async_commit();
  stage_row(p, walk, pl, min(i0 + 1, last), j0, n, smem + stage);
  cp_async_commit();
  for (int k = 0; k < rows; ++k) {
    if (k + 2 <= rows)
      stage_row(p, walk, pl, min(i0 + k + 2, last), j0, n,
                smem + ((k + 2) % kBuffers) * stage);
    cp_async_commit();
    cp_async_wait_one();  // rows k and k + 1 have landed
    __syncthreads();
    const V* top = reinterpret_cast<const V*>(smem + (k % kBuffers) * stage);
    const V* bot =
        reinterpret_cast<const V*>(smem + ((k + 1) % kBuffers) * stage);
    V* dst = reinterpret_cast<V*>(
        p.out + (((int64_t)pl * p.H + i0 + k) * p.W + j0) * 4 * p.C);
    emit_row<V>(top, bot, dst, out_walk, t, n, c);
    __syncthreads();  // buffer k % kBuffers takes row k + 3 next
  }
}

template <typename V>
int launch(const Params& p, cudaStream_t stream) {
  const int64_t bytes = (int64_t)kBuffers * (p.tile + 1) * p.C * 4;
  if (bytes > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (bytes > kDefaultDynamicBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        stack_corners_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.W + p.tile - 1) / p.tile, (p.H + p.strip - 1) / p.strip,
                  p.P);
  stack_corners_kernel<V><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ip: n_src, P, H, W, C, tile, strip, out, then (pointer, channels, plane
// stride in floats) for each source; kernels/stacks.py params writes it
extern "C" int tc_stacks(const int64_t* ip, void* stream) {
  Params p;
  p.n_src = (int)ip[0];
  p.P = (int)ip[1];
  p.H = (int)ip[2];
  p.W = (int)ip[3];
  p.C = (int)ip[4];
  p.tile = (int)ip[5];
  p.strip = (int)ip[6];
  p.out = reinterpret_cast<float*>(ip[7]);
  if (p.n_src < 1 || p.n_src > kMaxSources || p.tile < 1 || p.strip < 1)
    return (int)cudaErrorInvalidValue;
  int sum = 0;
  for (int k = 0; k < kMaxSources; ++k) {
    const bool on = k < p.n_src;
    p.src[k] = on ? reinterpret_cast<const float*>(ip[8 + 3 * k]) : nullptr;
    p.ch[k] = on ? (int)ip[9 + 3 * k] : 0;
    p.plane[k] = on ? ip[10 + 3 * k] : 0;
    sum += p.ch[k];
  }
  if (sum != p.C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.C % 4 == 0) return launch<float4>(p, s);
  if (p.C % 2 == 0) return launch<float2>(p, s);
  return launch<float>(p, s);
}
