// Backward of the embedding-bag lookup, for Hopper (sm_90a):
//
//   grad_table[ids[b, l], :] += w[b, l] * grad_out[b, :]   (w = 1 if absent)
//
// into a dense grad_table [V, D] that the wrapper has zero-filled; duplicate
// ids, within a bag and across bags, accumulate.
//
// No TPU kernel precedes it: the reference differentiates `jnp.take` in
// src/repro/models/recsys/dlrm.py (forward), and the forward's Pallas
// kernel (src/repro/kernels/embedding_bag/embedding_bag.py,
// embedding_bag_pallas) has no custom VJP. It is the backward of this
// port's embedding_bag.cu.
//
// Bound: bytes. A call reads grad_out once (B * D * 4 bytes), the ids and
// the sort's permutation, and writes each touched row of grad_table once
// (the zero fill of the untouched rows is the wrapper's). Its 2 * B * L * D
// flops are nothing beside that.
//
// Design: sorted segments, deterministic and free of contention. Power-law
// ids put ~20,000 adds on each of a few hot rows (DLRM-RM2's tables of 3 to
// 27 rows at B = 65,536), where atomicAdd would serialize and sum in a
// different order every run. The wrapper sorts the flat ids stably
// (torch.sort: index preparation), so the entries of one id form one
// segment, in position order. Then:
//   pass 1: one warp per chunk of kChunk sorted entries; lanes own columns
//     (a float2 each, 64 columns per sweep). The warp adds its chunk's
//     entries in order and flushes at every change of id: a piece that both
//     starts and ends its segment inside the chunk is written straight to
//     grad_table; the chunk's first piece, when its segment began in an
//     earlier chunk, goes to head[chunk]; its last piece, when its segment
//     starts in this chunk and runs on into the next, goes to tail[chunk].
//   pass 2: one warp per chunk whose last piece opens a segment that runs
//     on: it adds tail[chunk], then head[] of the following chunks in order
//     until the segment ends, and writes the row once.
// Every row is written by exactly one warp and every sum is taken in a fixed
// order, so the result is bitwise the same from run to run. ids must lie in
// [0, V); the wrapper does not check them on the device.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kChunk = 256;               // sorted entries per warp (pass 1)
constexpr int64_t kMaxBlocks = int64_t(1) << 20;

// Columns [c, c + 1] of a row of `dim` floats, as far as they exist.
__device__ __forceinline__ float2 load2(const float* row, int64_t c,
                                        int64_t dim) {
  float2 r;
  r.x = c < dim ? __ldg(row + c) : 0.0f;
  r.y = c + 1 < dim ? __ldg(row + c + 1) : 0.0f;
  return r;
}

__device__ __forceinline__ void store2(float* row, int64_t c, int64_t dim,
                                       float2 v) {
  if (c < dim) row[c] = v.x;
  if (c + 1 < dim) row[c + 1] = v.y;
}

// sid [n] sorted ids; perm [n] their flat positions in ids [B, bag];
// w [B * bag] or null; gout [B, dim]; grad [V, dim]; head, tail
// [n_chunks, dim].
__global__ void __launch_bounds__(kWarps * 32)
segments_pass1(const int32_t* __restrict__ sid,
               const int64_t* __restrict__ perm,
               const float* __restrict__ w,
               const float* __restrict__ gout,
               float* __restrict__ grad, float* __restrict__ head,
               float* __restrict__ tail, int64_t n, int64_t bag,
               int64_t dim) {
  const int lane = threadIdx.x & 31;
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  const int64_t stride = int64_t(gridDim.x) * kWarps;
  for (int64_t c = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
       c < n_chunks; c += stride) {
    const int64_t lo = c * kChunk;
    const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
    const bool cont = lo > 0 && __ldg(sid + lo) == __ldg(sid + lo - 1);
    const bool open = hi < n && __ldg(sid + hi - 1) == __ldg(sid + hi);
    for (int64_t col = 2 * lane; col < dim; col += 64) {
      float2 acc = make_float2(0.0f, 0.0f);
      bool first = true;
      for (int64_t i = lo; i < hi; ++i) {
        const int32_t id = __ldg(sid + i);
        const int64_t p = __ldg(perm + i);
        const float wt = w ? __ldg(w + p) : 1.0f;
        const float2 g = load2(gout + (p / bag) * dim, col, dim);
        acc.x = fmaf(wt, g.x, acc.x);
        acc.y = fmaf(wt, g.y, acc.y);
        const bool last = i + 1 == hi || __ldg(sid + i + 1) != id;
        if (!last) continue;
        float* dst;
        if (first && cont) {
          dst = head + c * dim;                 // continues a segment
        } else if (i + 1 == hi && open) {
          dst = tail + c * dim;                 // opens a segment that runs on
        } else {
          dst = grad + int64_t(id) * dim;       // a whole segment
        }
        store2(dst, col, dim, acc);
        acc = make_float2(0.0f, 0.0f);
        first = false;
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
segments_pass2(const int32_t* __restrict__ sid,
               const float* __restrict__ head,
               const float* __restrict__ tail, float* __restrict__ grad,
               int64_t n, int64_t dim) {
  const int lane = threadIdx.x & 31;
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  const int64_t stride = int64_t(gridDim.x) * kWarps;
  for (int64_t c = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
       c < n_chunks; c += stride) {
    const int64_t lo = c * kChunk;
    const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
    if (hi >= n) continue;
    const int32_t id = __ldg(sid + hi - 1);
    // owner: the chunk whose last piece opens a segment that runs on
    if (__ldg(sid + hi) != id || (lo > 0 && __ldg(sid + lo - 1) == id))
      continue;
    for (int64_t col = 2 * lane; col < dim; col += 64) {
      float2 acc = load2(tail + c * dim, col, dim);
      for (int64_t j = c + 1; j < n_chunks; ++j) {
        const float2 h = load2(head + j * dim, col, dim);
        acc.x += h.x;
        acc.y += h.y;
        const int64_t hj = (j + 1) * kChunk;
        if (hj >= n || __ldg(sid + hj) != id) break;   // segment ends in j
      }
      store2(grad + int64_t(id) * dim, col, dim, acc);
    }
  }
}

inline unsigned blocks_for(int64_t n_chunks) {
  int64_t blocks = (n_chunks + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// Scratch floats the wrapper allocates for `head` and `tail` each.
extern "C" int64_t embedding_bag_backward_scratch(int64_t n, int64_t dim) {
  return ((n + kChunk - 1) / kChunk) * dim;
}

// sorted_ids [n] int32 (stably sorted flat ids), perm [n] int64 (their
// positions in the flat [n_bags * bag] ids), weights [n_bags * bag] f32 or
// null, grad_out [n_bags, dim] f32, grad_table [V, dim] f32 (zero-filled;
// only the touched rows are written), head and tail scratch of
// embedding_bag_backward_scratch(n, dim) floats each. All contiguous on the
// current device. Launches both passes on `stream` and returns
// cudaGetLastError() after each (0 = cudaSuccess).
extern "C" int embedding_bag_backward_f32(
    const void* sorted_ids, const void* perm, const void* weights,
    const void* grad_out, void* grad_table, void* head, void* tail, int64_t n,
    int64_t bag, int64_t dim, void* stream) {
  if (n <= 0 || dim <= 0) return 0;
  const auto* sid = static_cast<const int32_t*>(sorted_ids);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for((n + kChunk - 1) / kChunk);
  segments_pass1<<<blocks, kWarps * 32, 0, st>>>(
      sid, static_cast<const int64_t*>(perm),
      static_cast<const float*>(weights), static_cast<const float*>(grad_out),
      static_cast<float*>(grad_table), static_cast<float*>(head),
      static_cast<float*>(tail), n, bag, dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segments_pass2<<<blocks, kWarps * 32, 0, st>>>(
      sid, static_cast<const float*>(head), static_cast<const float*>(tail),
      static_cast<float*>(grad_table), n, dim);
  return static_cast<int>(cudaGetLastError());
}
