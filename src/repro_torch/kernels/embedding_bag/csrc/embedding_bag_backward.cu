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
// flops are nothing beside that. The reads of grad_out are rows of D floats
// in sorted-id order, so random: at DLRM-RM2's train_batch, 1,703,936 rows
// of 256 bytes. What holds such a gather back is latency: each warp must
// keep several rows in flight, and no row read may wait on an index read.
//
// Design: sorted segments, deterministic and free of contention. Power-law
// ids put tens of thousands of adds on each of a few hot rows, where
// atomicAdd would serialize and sum in a different order every run. The
// wrapper sorts the flat ids stably (torch.sort: index preparation), so the
// entries of one id form one segment, in position order, and cuts the n
// sorted entries into chunks of `chunk` entries (backward_plan in ops.py:
// at least kTile, and no more chunks than one wave of this pass's resident
// warps on an H100, so every warp walks one chunk).
//   pieces (pass 1): one warp per chunk; lanes own columns (a float2 each
//     when D is even, 64 columns per sweep). Per kTile entries the lanes
//     load the sorted ids, the output rows (perm / bag) and the weights
//     coalesced into shared memory; then the warp loads kDepth rows of
//     grad_out into one register group while it adds the group before, so
//     4 to 8 rows are in flight per warp. Sums run in position order and
//     flush at each change of id: a piece that starts and ends its segment
//     inside the chunk is written straight to grad_table; the chunk's first
//     piece, when its segment began in an earlier chunk, goes to
//     head[chunk]; its last piece, when its segment starts in this chunk
//     and runs on, goes to tail[chunk]. kMinBlocks = 4 blocks of 8 warps
//     per SM leave 64 registers a thread, so nothing spills (at 5 or 6
//     blocks the spills cost more than the extra warps bring).
//   join (pass 2): one warp per chunk; the warp of a chunk whose last piece
//     opens a segment that runs on (the others exit after three reads)
//     finds the chunk where that segment ends (128 chunk ends per round,
//     their reads in flight together), loads the partials tail[c0],
//     head[c0 + 1], ..., head[c1] kBatch at a time (the next batch in
//     flight while one is summed), adds each batch in a fixed pairwise
//     tree and the batch sums in order, and writes the row once. No walk
//     over chunks is left: the hottest row at train_batch (37,807 adds over
//     ~94 chunks of 404) takes one round of search and 6 batches.
// Every row is written by exactly one warp and every sum is taken in an
// order fixed by the sorted ids, the chunk length and these constants, so
// two launches are bitwise equal. Nothing is added into grad_table with
// atomics.
//
// Window. grad_table may be one rank's row shard [n_local, D] of the table's
// gradient, rows [row_lo, row_lo + n_local) (the row-sharded layout P("model",
// None)). An entry whose id lies outside the window writes nothing: the
// pieces pass tests each staged id in its row loads (no grad_out row is read
// for it) and at each flush (no row of grad_table is written for it), and the
// join's owner tests the id of the segment it would write. There is no pass
// of its own over the ids, and the sort and the chunk plan are those of the
// whole call, so the sums of the rows inside the window run in the same
// order as without one (embedding_bag_backward_window_f32). The whole table
// is the window [0, V) (embedding_bag_backward_f32): every id passes, so the
// tests are compiled out there (kWindow = false), as in the lookup, and the
// kernel does what it did before it took a window, bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;          // warps per block (both passes)
constexpr int kMinBlocks = 4;      // resident blocks per SM (the plan's wave)
constexpr int kTile = 256;         // entries staged in shared memory per warp
constexpr int kDepth = 4;          // rows per register group (two in turn)
constexpr int kBatch = 16;         // partials per batch in the join
constexpr int kScan = 4;           // chunk ends each lane tests per round

// Columns [c, c + V) of a row, at `p` (V = 2 only when D is even and the
// rows are 8-byte aligned, so both columns exist or neither).
template <int V>
__device__ __forceinline__ float2 load_cols(const float* p) {
  if (V == 2) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), 0.0f);
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, float2 v) {
  if (V == 2) {
    *reinterpret_cast<float2*>(p) = v;
  } else {
    *p = v.x;
  }
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// True when `id` lies in the window of n_local rows from row_lo (always,
// without a window).
template <bool kWindow>
__device__ __forceinline__ bool in_window(int32_t id, int64_t row_lo,
                                          int64_t n_local) {
  return !kWindow || static_cast<uint64_t>(int64_t(id) - row_lo) <
                         static_cast<uint64_t>(n_local);
}

// sid [n] sorted ids; perm [n] their flat positions in ids [n_bags, bag];
// w [n_bags * bag] or null; gout [n_bags, dim]; grad [n_local, dim], rows
// [row_lo, row_lo + n_local) of the table's gradient (kWindow; else the
// whole gradient, row_lo 0); head, tail [n_chunks, dim].
template <int V, bool kWindow>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
backward_pieces(const int32_t* __restrict__ sid,
                const int64_t* __restrict__ perm,
                const float* __restrict__ w,
                const float* __restrict__ gout, float* __restrict__ grad,
                float* __restrict__ head, float* __restrict__ tail,
                int64_t n, int64_t chunk, int64_t bag, int dim,
                int64_t row_lo, int64_t n_local) {
  __shared__ int32_t s_ids[kWarps][kTile + 1];
  __shared__ int64_t s_rows[kWarps][kTile];
  __shared__ float s_wts[kWarps][kTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int64_t c = int64_t(blockIdx.x) * kWarps + warp;
  const int64_t lo = c * chunk;
  if (lo >= n) return;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const bool cont = lo > 0 && __ldg(sid + lo) == __ldg(sid + lo - 1);
  const bool open_end = hi < n && __ldg(sid + hi - 1) == __ldg(sid + hi);
  int32_t* ids = s_ids[warp];
  int64_t* rows = s_rows[warp];
  float* wts = s_wts[warp];
  for (int sweep = 0; sweep < dim; sweep += 32 * V) {
    const int col = sweep + V * lane;
    const bool live = col < dim;
    float2 acc = make_float2(0.0f, 0.0f);
    bool first = true;                   // no piece flushed yet
    for (int64_t t0 = lo; t0 < hi; t0 += kTile) {
      const int cnt = static_cast<int>(hi - t0 < kTile ? hi - t0 : kTile);
      const bool last_tile = t0 + cnt == hi;
      __syncwarp();                      // the last tile's reads are done
      for (int j = lane; j < cnt; j += 32) {
        const int64_t p = __ldg(perm + t0 + j);
        ids[j] = __ldg(sid + t0 + j);
        rows[j] = (bag == 1 ? p : p / bag) * dim;
        wts[j] = w ? __ldg(w + p) : 1.0f;
      }
      // past the tile: the next entry's id, or -1 (no id) at the chunk end
      if (lane == 0) ids[cnt] = last_tile ? -1 : __ldg(sid + t0 + cnt);
      __syncwarp();
      auto load = [&](int j0, float2 (&g)[kDepth]) {
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int j = j0 + u;
          g[u] = j < cnt && live &&
                         in_window<kWindow>(ids[j], row_lo, n_local)
                     ? load_cols<V>(gout + rows[j] + col)
                     : make_float2(0.0f, 0.0f);
        }
      };
      auto add = [&](int j0, const float2 (&g)[kDepth]) {
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int j = j0 + u;
          if (j >= cnt) return;
          acc.x = fmaf(wts[j], g[u].x, acc.x);
          acc.y = fmaf(wts[j], g[u].y, acc.y);
          const int32_t id = ids[j];
          if (ids[j + 1] == id) continue;        // the piece goes on
          float* dst;
          if (first && cont) {
            dst = head + c * dim;                // continues a segment
          } else if (last_tile && j + 1 == cnt && open_end) {
            dst = tail + c * dim;                // opens one that runs on
          } else if (in_window<kWindow>(id, row_lo, n_local)) {
            dst = grad + (int64_t(id) - row_lo) * dim;  // a whole segment
          } else {
            dst = nullptr;                       // outside the window
          }
          if (live && dst) store_cols<V>(dst + col, acc);
          acc = make_float2(0.0f, 0.0f);
          first = false;
        }
      };
      float2 ga[kDepth], gb[kDepth];
      load(0, ga);
      for (int j = 0; j < cnt; j += 2 * kDepth) {
        load(j + kDepth, gb);
        add(j, ga);
        load(j + 2 * kDepth, ga);
        add(j + kDepth, gb);
      }
    }
  }
}

__device__ __forceinline__ float2 tree_sum(float2 (&g)[kBatch]) {
#pragma unroll
  for (int step = 1; step < kBatch; step *= 2) {
#pragma unroll
    for (int i = 0; i + step < kBatch; i += 2 * step)
      g[i] = add2(g[i], g[i + step]);
  }
  return g[0];
}

template <int V, bool kWindow>
__global__ void __launch_bounds__(kWarps * 32)
backward_join(const int32_t* __restrict__ sid,
              const float* __restrict__ head,
              const float* __restrict__ tail, float* __restrict__ grad,
              int64_t n, int64_t chunk, int dim, int64_t row_lo,
              int64_t n_local) {
  const int lane = threadIdx.x & 31;
  const int64_t c0 = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int64_t lo = c0 * chunk;
  const int64_t hi = lo + chunk;
  if (hi >= n) return;                   // past the end, or the last chunk
  const int32_t id = __ldg(sid + hi - 1);
  // owner: the chunk whose last piece opens a segment that runs on
  if (__ldg(sid + hi) != id || (lo > 0 && __ldg(sid + lo - 1) == id)) return;
  if (!in_window<kWindow>(id, row_lo, n_local)) return;  // another window
  // c1: the first chunk after c0 in which the segment ends; a round tests
  // 32 * kScan chunk ends, their reads in flight together
  int64_t c1 = -1;
  for (int64_t base = c0 + 1; c1 < 0; base += 32 * kScan) {
    bool ends[kScan];
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int64_t h = (base + 32 * k + lane + 1) * chunk;
      ends[k] = h >= n || __ldg(sid + h) != id;
    }
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const unsigned found = __ballot_sync(0xffffffffu, ends[k]);
      if (found && c1 < 0) c1 = base + 32 * k + __ffs(found) - 1;
    }
  }
  const int64_t parts = c1 - c0 + 1;    // tail[c0], head[c0 + 1 .. c1]
  for (int sweep = 0; sweep < dim; sweep += 32 * V) {
    const int col = sweep + V * lane;
    if (col >= dim) break;
    auto load = [&](int64_t k0, float2 (&g)[kBatch]) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t k = k0 + u;
        g[u] = k >= parts ? make_float2(0.0f, 0.0f)
                          : load_cols<V>((k == 0 ? tail + c0 * dim
                                                 : head + (c0 + k) * dim)
                                         + col);
      }
    };
    float2 sum = make_float2(0.0f, 0.0f);
    float2 ga[kBatch], gb[kBatch];
    load(0, ga);
    for (int64_t k = 0; k < parts; k += 2 * kBatch) {
      load(k + kBatch, gb);
      sum = add2(sum, tree_sum(ga));
      load(k + 2 * kBatch, ga);
      if (k + kBatch < parts) sum = add2(sum, tree_sum(gb));
    }
    store_cols<V>(grad + (int64_t(id) - row_lo) * dim + col, sum);
  }
}

template <int V, bool kWindow>
int launch(const int32_t* sid, const int64_t* perm, const float* w,
           const float* gout, float* grad, float* head, float* tail,
           int64_t n, int64_t chunk, int64_t bag, int dim, int64_t row_lo,
           int64_t n_local, cudaStream_t st) {
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  const auto blocks = static_cast<unsigned>((n_chunks + kWarps - 1) / kWarps);
  backward_pieces<V, kWindow><<<blocks, kWarps * 32, 0, st>>>(
      sid, perm, w, gout, grad, head, tail, n, chunk, bag, dim, row_lo,
      n_local);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  backward_join<V, kWindow><<<blocks, kWarps * 32, 0, st>>>(
      sid, head, tail, grad, n, chunk, dim, row_lo, n_local);
  return static_cast<int>(cudaGetLastError());
}

// n_local < 0: the whole gradient, no window.
int backward(const void* sorted_ids, const void* perm, const void* weights,
             const void* grad_out, void* grad_table, void* head, void* tail,
             int64_t n, int64_t chunk, int64_t bag, int64_t dim,
             int64_t row_lo, int64_t n_local, void* stream) {
  if (n <= 0 || dim <= 0) return 0;
  if (chunk <= 0 || dim > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sid = static_cast<const int32_t*>(sorted_ids);
  const auto* p = static_cast<const int64_t*>(perm);
  const auto* w = static_cast<const float*>(weights);
  const auto* g = static_cast<const float*>(grad_out);
  auto* out = static_cast<float*>(grad_table);
  auto* h = static_cast<float*>(head);
  auto* t = static_cast<float*>(tail);
  auto st = static_cast<cudaStream_t>(stream);
  const bool pairs = dim % 2 == 0 &&
      (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(t)) %
          8 == 0;
  const int d = static_cast<int>(dim);
  if (n_local < 0) {
    return pairs ? launch<2, false>(sid, p, w, g, out, h, t, n, chunk, bag,
                                    d, 0, 0, st)
                 : launch<1, false>(sid, p, w, g, out, h, t, n, chunk, bag,
                                    d, 0, 0, st);
  }
  return pairs ? launch<2, true>(sid, p, w, g, out, h, t, n, chunk, bag, d,
                                 row_lo, n_local, st)
               : launch<1, true>(sid, p, w, g, out, h, t, n, chunk, bag, d,
                                 row_lo, n_local, st);
}

}  // namespace

// Resident blocks of kWarps warps per SM that the pieces pass reaches on
// this device (ops.py's CHUNKS assumes kMinBlocks on an H100), or -1.
extern "C" int embedding_bag_backward_blocks_per_sm() {
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, backward_pieces<2, false>, kWarps * 32, 0) != cudaSuccess)
    return -1;
  return blocks;
}

// sorted_ids [n] int32 (stably sorted flat ids), perm [n] int64 (their
// positions in the flat [n_bags * bag] ids), weights [n_bags * bag] f32 or
// null, grad_out [n_bags, dim] f32, grad_table [V, dim] f32 (zero-filled;
// only the touched rows are written), head and tail scratch of
// ceil(n / chunk) * dim floats each. All contiguous on the current device;
// chunk >= 1 entries per warp (backward_plan). Launches both passes on
// `stream` and returns cudaGetLastError() after each (0 = cudaSuccess).
extern "C" int embedding_bag_backward_f32(
    const void* sorted_ids, const void* perm, const void* weights,
    const void* grad_out, void* grad_table, void* head, void* tail, int64_t n,
    int64_t chunk, int64_t bag, int64_t dim, void* stream) {
  return backward(sorted_ids, perm, weights, grad_out, grad_table, head, tail,
                  n, chunk, bag, dim, 0, -1, stream);
}

// embedding_bag_backward_f32 into rows [row_lo, row_lo + n_local) of the
// table's gradient, which grad_table ([n_local, dim], zero-filled) holds:
// an id outside them writes nothing.
extern "C" int embedding_bag_backward_window_f32(
    const void* sorted_ids, const void* perm, const void* weights,
    const void* grad_out, void* grad_table, void* head, void* tail, int64_t n,
    int64_t chunk, int64_t bag, int64_t dim, int64_t row_lo, int64_t n_local,
    void* stream) {
  if (row_lo < 0 || n_local < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return backward(sorted_ids, perm, weights, grad_out, grad_table, head, tail,
                  n, chunk, bag, dim, row_lo, n_local, stream);
}
