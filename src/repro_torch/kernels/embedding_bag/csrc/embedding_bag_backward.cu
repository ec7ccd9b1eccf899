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
// atomics. ids must lie in [0, V); the wrapper does not check them on the
// device.
//
// Window (embedding_bag_backward_window_f32). grad_table may be one rank's
// row shard [n_local, D] of the table's gradient, rows [row_lo, row_lo +
// n_local) (the row-sharded layout P("model", None)); an id outside it
// writes nothing. A rank's window holds ~1/16 of the ids it sees, so the
// window test runs once, first: embedding_bag_window_sort (at the end of
// this file) compacts the entries inside and sorts their local rows id -
// row_lo stably, with int32 positions, and leaves their count n_in on the
// card. The window's passes walk only those. Each block (window_pieces) or
// warp (backward_join<V, true>) computes the chunk plan backward_plan(n_in)
// from n_in itself, so nothing is read back to the host; the grids are
// sized for the plan of all n entries of the call, and the blocks and warps
// past the plan's chunks exit. Positions are int32 (bag indices staged, not
// row offsets). At a rank's window the plan has few chunks (~36 of 256
// entries at DLRM-RM2 train_batch on a 16-way split), and what bounds a
// warp's walk over its chunk is the instructions it issues per entry, not
// its rows in flight. So where the call's plan has at most kSplitChunks
// chunks, each chunk gets a block, whose warps take ranges of it cut at
// segment starts; and a group of kWinDepth entries of one segment (a hot
// row's long run) is summed with no per-entry test. Larger plans give each
// chunk a warp, as the whole-table pass does. The sums depend on the pieces
// alone: each is taken in position order and written where the chunk's one
// warp would write it (head, tail or its row), so neither the ranges nor
// the rows in flight change a bit, and a stable sort's output is unique:
// on the window [0, V) the window's passes give the whole-table kernel's
// bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;          // warps per block (both passes)
constexpr int kMinBlocks = 4;      // resident blocks per SM (the plan's wave)
constexpr int kTile = 256;         // entries staged in shared memory per warp
constexpr int kDepth = 4;          // rows per register group (two in turn)
constexpr int kBatch = 16;         // partials per batch in the join
constexpr int kScan = 4;           // chunk ends each lane tests per round
// The chunk plan's most chunks (ops.CHUNKS): one wave of the pieces pass.
constexpr int64_t kChunks = 132LL * kMinBlocks * kWarps;
// The window's pieces pass with a block to a chunk: rows per register
// group, resident blocks per SM (deeper groups spill at 2 blocks, and at 1
// block gain ~1 us at one window and lose it at another).
constexpr int kWinDepth = 8;
constexpr int kWinBlocks = 2;
// Plans of at most kSplitChunks chunks (of the call's n entries, so n_in <
// kTile * kChunks and every chunk is kTile entries) give each chunk a block
// of the window's pieces pass, larger ones a warp.
constexpr int64_t kSplitChunks = 132 * 4;

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

// load_cols through the coherent path: for a row this kernel wrote.
template <int V>
__device__ __forceinline__ float2 load_cols_written(const float* p) {
  if (V == 2) return *reinterpret_cast<const float2*>(p);
  return make_float2(*p, 0.0f);
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// sid [n] sorted ids; perm [n] their flat positions in ids [n_bags, bag];
// w [n_bags * bag] or null; gout [n_bags, dim]; grad [V, dim]; head, tail
// [n_chunks, dim].
template <int V>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
backward_pieces(const int32_t* __restrict__ sid,
                const int64_t* __restrict__ perm,
                const float* __restrict__ w,
                const float* __restrict__ gout, float* __restrict__ grad,
                float* __restrict__ head, float* __restrict__ tail,
                int64_t n, int64_t chunk, int64_t bag, int dim) {
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
          g[u] = j < cnt && live ? load_cols<V>(gout + rows[j] + col)
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
          } else {
            dst = grad + int64_t(id) * dim;      // a whole segment
          }
          if (live) store_cols<V>(dst + col, acc);
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

// backward_plan's chunk for n sorted entries: at least kTile, and no more
// than kChunks chunks.
__device__ __forceinline__ int64_t plan_chunk(int64_t n) {
  const int64_t c = (n + kChunks - 1) / kChunks;
  return c > kTile ? c : kTile;
}

// kCompact: the window's join, over the n_in compacted entries (n and chunk
// are then read from n_in and computed here; the arguments are ignored).
template <int V, bool kCompact>
__global__ void __launch_bounds__(kWarps * 32)
backward_join(const int32_t* __restrict__ sid,
              const float* __restrict__ head,
              const float* __restrict__ tail, float* __restrict__ grad,
              int64_t n, int64_t chunk, int dim,
              const int32_t* __restrict__ n_in) {
  if (kCompact) {
    n = __ldg(n_in);
    chunk = plan_chunk(n);
  }
  const int lane = threadIdx.x & 31;
  const int64_t c0 = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int64_t lo = c0 * chunk;
  const int64_t hi = lo + chunk;
  if (hi >= n) return;                   // past the end, or the last chunk
  const int32_t id = __ldg(sid + hi - 1);
  // owner: the chunk whose last piece opens a segment that runs on
  if (__ldg(sid + hi) != id || (lo > 0 && __ldg(sid + lo - 1) == id)) return;
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
    store_cols<V>(grad + int64_t(id) * dim + col, sum);
  }
}

// The window's pieces pass: the pieces of backward_pieces over the n_in
// compacted entries, kSplit warps to a chunk of backward_plan(n_in) (one,
// or the block's kWarps). sid [n_in] the sorted local rows; perm [n_in]
// their flat positions in ids [n_bags, bag] (int32); n_in on the card; w,
// gout as above; grad [n_local, dim]; head, tail, carry [min(kChunks,
// ceil(n / kTile)), dim]. A chunk's warps stage kTile of its entries at a
// time (with kSplit > 1 the chunk is kTile entries: see kSplitChunks) and
// cut them at segment starts into one range per warp (near equal where
// segments are short); each warp sums the pieces of its range in position
// order, as the chunk's one warp would. A piece that runs past the staged
// entries goes on from `carry`.
template <int V, int kSplit>
__global__ void __launch_bounds__(kWarps * 32,
                                  kSplit == 1 ? kMinBlocks : kWinBlocks)
window_pieces(const int32_t* __restrict__ sid,
              const int32_t* __restrict__ perm,
              const int32_t* __restrict__ n_in,
              const float* __restrict__ w,
              const float* __restrict__ gout, float* __restrict__ grad,
              float* __restrict__ head, float* __restrict__ tail,
              float* carry, int32_t bag, int dim) {
  static_assert(kSplit == 1 || kSplit == kWarps, "a warp or a block a chunk");
  constexpr int kGroups = kWarps / kSplit;   // chunks a block walks
  constexpr int kStage = kTile;              // entries a chunk stages
  constexpr int kRows = kSplit == 1 ? kDepth : kWinDepth;
  __shared__ int32_t s_ids[kGroups][kStage + 1];
  __shared__ int32_t s_bags[kGroups][kStage];
  __shared__ float s_wts[kGroups][kStage];
  __shared__ int s_cut[kGroups][kSplit + 1];  // warp k: [cut[k], cut[k + 1])
  __shared__ bool s_carry_first[kGroups];     // the carry began the chunk
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int grp = warp / kSplit;         // this warp's chunk in the block
  const int sub = warp % kSplit;         // and its place among the chunk's
  const int t = sub * 32 + lane;         // thread among the chunk's
  auto sync = [] {
    if (kSplit == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  };
  const int64_t n = __ldg(n_in);
  const int64_t chunk = plan_chunk(n);
  const int64_t c = int64_t(blockIdx.x) * kGroups + grp;
  const int64_t lo = c * chunk;
  if (lo >= n) return;                   // past the plan's chunks
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const bool cont = lo > 0 && __ldg(sid + lo) == __ldg(sid + lo - 1);
  const bool open_end = hi < n && __ldg(sid + hi - 1) == __ldg(sid + hi);
  int32_t* ids = s_ids[grp];
  int32_t* bags = s_bags[grp];
  float* wts = s_wts[grp];
  int* cut = s_cut[grp];
  bool carried = false;                  // a piece runs on from the last tile
  for (int64_t t0 = lo; t0 < hi; t0 += kStage) {
    const int cnt = static_cast<int>(hi - t0 < kStage ? hi - t0 : kStage);
    sync();                              // the last tile's reads are done
    for (int j = t; j < cnt; j += kSplit * 32) {
      const int32_t p = __ldg(perm + t0 + j);
      ids[j] = __ldg(sid + t0 + j);
      bags[j] = bag == 1 ? p : p / bag;
      wts[j] = w ? __ldg(w + p) : 1.0f;
    }
    // past the tile: the next entry's row, or -1 (no row) at the chunk end
    if (t == 0) {
      ids[cnt] = t0 + cnt < hi ? __ldg(sid + t0 + cnt) : -1;
      cut[0] = 0;
      cut[kSplit] = cnt;
    }
    sync();
    if (sub > 0) {
      // the first segment start at or after sub * cnt / kSplit (never 0:
      // the tile's first entry may go on from the tile before)
      int at = cnt;
      for (int base = sub * cnt / kSplit; base < cnt; base += 32) {
        const int j = base + lane;
        const unsigned starts = __ballot_sync(
            0xffffffffu, j > 0 && j < cnt && ids[j] != ids[j - 1]);
        if (starts) {
          at = base + __ffs(starts) - 1;
          break;
        }
      }
      if (lane == 0) cut[sub] = at;
    }
    sync();
    const int a = cut[sub];
    const int b = cut[sub + 1];
    const bool goes_on = carried && sub == 0;   // begins with the carry
    const bool carry_first = goes_on && s_carry_first[grp];
    const bool runs_on = t0 + cnt < hi && ids[cnt] == ids[cnt - 1];
    sync();                              // s_carry_first is read
    if (a < b) {
      for (int sweep = 0; sweep < dim; sweep += 32 * V) {
        const int col = sweep + V * lane;
        const bool live = col < dim;
        float2 acc = goes_on && live
                         ? load_cols_written<V>(carry + c * dim + col)
                         : make_float2(0.0f, 0.0f);
        // the piece being summed began the chunk
        bool first = goes_on ? carry_first : t0 + a == lo;
        // where this sweep's columns of a piece go: the chunk's head or
        // tail partial, or its segment's row
        float* const head_c = head + c * dim + col;
        float* const tail_c = tail + c * dim + col;
        float* const grad_c = grad + col;
        const int64_t last = hi - 1 - t0;     // the chunk's last entry
        // the piece ending at entry j (of row id) is summed: write it
        auto flush = [&](int j, int32_t id) {
          float* dst;
          if (first && cont) {
            dst = head_c;                        // continues a segment
          } else if (j == last && open_end) {
            dst = tail_c;                        // opens one that runs on
          } else {
            dst = grad_c + int64_t(id) * dim;    // a whole segment
          }
          if (live) store_cols<V>(dst, acc);
          acc = make_float2(0.0f, 0.0f);
          first = false;
        };
        auto load = [&](int j0, float2 (&g)[kRows]) {
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            const int j = j0 + u;
            g[u] = j < b && live
                       ? load_cols<V>(gout + int64_t(bags[j]) * dim + col)
                       : make_float2(0.0f, 0.0f);
          }
        };
        auto add = [&](int j0, const float2 (&g)[kRows]) {
          if (j0 + kRows <= b) {
            // a whole group: its weights and rows read before the sums
            float wv[kRows];
            int32_t iv[kRows + 1];
#pragma unroll
            for (int u = 0; u <= kRows; ++u) {
              iv[u] = ids[j0 + u];
              if (u < kRows) wv[u] = wts[j0 + u];
            }
            // the whole group in one piece (a long segment): the sums
            // alone, a per-entry test costing more than they do
            bool one = true;
#pragma unroll
            for (int u = 0; u < kRows; ++u) one = one && iv[u + 1] == iv[u];
            if (one) {
#pragma unroll
              for (int u = 0; u < kRows; ++u) {
                acc.x = fmaf(wv[u], g[u].x, acc.x);
                acc.y = fmaf(wv[u], g[u].y, acc.y);
              }
              return;
            }
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
              acc.x = fmaf(wv[u], g[u].x, acc.x);
              acc.y = fmaf(wv[u], g[u].y, acc.y);
              if (iv[u + 1] != iv[u]) flush(j0 + u, iv[u]);
            }
            return;
          }
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            const int j = j0 + u;
            if (j >= b) return;
            acc.x = fmaf(wts[j], g[u].x, acc.x);
            acc.y = fmaf(wts[j], g[u].y, acc.y);
            if (ids[j + 1] != ids[j]) flush(j, ids[j]);
          }
        };
        float2 ga[kRows], gb[kRows];
        load(a, ga);
        for (int j = a; j < b; j += 2 * kRows) {
          load(j + kRows, gb);
          add(j, ga);
          load(j + 2 * kRows, ga);
          add(j + kRows, gb);
        }
        // the range's last piece runs on into the next tile
        if (b == cnt && runs_on) {
          if (live) store_cols<V>(carry + c * dim + col, acc);
          if (sweep == 0 && lane == 0) s_carry_first[grp] = first;
        }
      }
    }
    carried = runs_on;
  }
}

template <int V>
int launch_window(const int32_t* sid, const int32_t* perm,
                  const int32_t* n_in, const float* w, const float* gout,
                  float* grad, float* head, float* tail, float* carry,
                  int64_t n, int32_t bag, int dim, cudaStream_t st) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int64_t n_chunks = n_tiles < kChunks ? n_tiles : kChunks;
  // few chunks: a block to each, else a warp
  if (n_chunks <= kSplitChunks) {
    window_pieces<V, kWarps><<<static_cast<unsigned>(n_chunks), kWarps * 32,
                               0, st>>>(sid, perm, n_in, w, gout, grad, head,
                                        tail, carry, bag, dim);
  } else {
    window_pieces<V, 1><<<static_cast<unsigned>((n_chunks + kWarps - 1) /
                                                kWarps),
                          kWarps * 32, 0, st>>>(sid, perm, n_in, w, gout,
                                                grad, head, tail, carry, bag,
                                                dim);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto blocks = static_cast<unsigned>((n_chunks + kWarps - 1) / kWarps);
  backward_join<V, true><<<blocks, kWarps * 32, 0, st>>>(
      sid, head, tail, grad, 0, 0, dim, n_in);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch(const int32_t* sid, const int64_t* perm, const float* w,
           const float* gout, float* grad, float* head, float* tail,
           int64_t n, int64_t chunk, int64_t bag, int dim, cudaStream_t st) {
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  const auto blocks = static_cast<unsigned>((n_chunks + kWarps - 1) / kWarps);
  backward_pieces<V><<<blocks, kWarps * 32, 0, st>>>(
      sid, perm, w, gout, grad, head, tail, n, chunk, bag, dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  backward_join<V, false><<<blocks, kWarps * 32, 0, st>>>(
      sid, head, tail, grad, n, chunk, dim, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Resident blocks of kWarps warps per SM that the pieces pass reaches on
// this device (ops.py's CHUNKS assumes kMinBlocks on an H100), or -1.
extern "C" int embedding_bag_backward_blocks_per_sm() {
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, backward_pieces<2>, kWarps * 32, 0) != cudaSuccess)
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
  return pairs ? launch<2>(sid, p, w, g, out, h, t, n, chunk, bag, d, st)
               : launch<1>(sid, p, w, g, out, h, t, n, chunk, bag, d, st);
}

// The window: sorted_keys [n] int32 and perm [n] int32, of which the first
// n_in (int32 on the card) hold embedding_bag_window_sort's output (the
// local rows id - row_lo of the entries inside, stably sorted, and their
// positions in the flat [n_bags * bag] ids); weights, grad_out as above;
// grad_table [n_local, dim] f32 (zero-filled; only the touched rows are
// written); head, tail and carry scratch of min(kChunks, ceil(n / kTile)) *
// dim floats each, n the entries of the whole call (n_in <= n). Launches
// both passes on `stream` and returns cudaGetLastError() after each.
extern "C" int embedding_bag_backward_window_f32(
    const void* sorted_keys, const void* perm, const void* n_in,
    const void* weights, const void* grad_out, void* grad_table, void* head,
    void* tail, void* carry, int64_t n, int64_t bag, int64_t dim,
    void* stream) {
  if (n <= 0 || dim <= 0) return 0;
  if (bag <= 0 || bag > INT32_MAX || n > INT32_MAX || dim > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sid = static_cast<const int32_t*>(sorted_keys);
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* cnt = static_cast<const int32_t*>(n_in);
  const auto* w = static_cast<const float*>(weights);
  const auto* g = static_cast<const float*>(grad_out);
  auto* out = static_cast<float*>(grad_table);
  auto* h = static_cast<float*>(head);
  auto* t = static_cast<float*>(tail);
  auto* r = static_cast<float*>(carry);
  auto st = static_cast<cudaStream_t>(stream);
  const bool pairs = dim % 2 == 0 &&
      (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(t) |
       reinterpret_cast<uintptr_t>(r)) % 8 == 0;
  const auto b = static_cast<int32_t>(bag);
  const int d = static_cast<int>(dim);
  return pairs
             ? launch_window<2>(sid, p, cnt, w, g, out, h, t, r, n, b, d, st)
             : launch_window<1>(sid, p, cnt, w, g, out, h, t, r, n, b, d, st);
}

// ---------------------------------------------------------------------------
// The window's index preparation (embedding_bag_window_sort): compact the
// entries of one rank's window and sort them.
//
// In:  the flat ids [n] (int32) of a call, and the window of table rows
//      [row_lo, row_lo + n_local) that the rank holds (the row-sharded
//      layout P("model", None)).
// Out: n_in, the count of entries whose id lies in the window; keys[0, n_in)
//      their local rows id - row_lo in ascending order and vals[0, n_in)
//      their flat positions (int32), in position order among equal keys (a
//      stable sort, whose output is unique). n_in stays on the card: nothing
//      here reads it back, so grids and buffers are sized for all n entries
//      and the blocks past what n_in needs exit.
//
// It feeds the window passes above, which walk only the entries inside (a
// rank's window holds ~1/16 of the ids it sees) in the order of the sorted
// keys.
//
// Bound: bytes. The ids are read once (4 n bytes) and the n_in keys and
// values written once (8 n_in); the radix passes move the n_in pairs again.
// At a rank's window (106,496 ids, ~9,000 inside at DLRM-RM2 train_batch on
// a 16-way row split) that is ~0.5 MB, a fraction of a microsecond at the
// card's rate, and the launches and the latency of each pass's loads and
// look-back set the time.
//
// Design: an LSD radix sort over only the significant bits of n_local - 1
// (22 at a 16-way split of DLRM-RM2's 33.76M rows, 26 for the whole table;
// torch.sort takes all 32, with int64 indices), kDigitBits a pass, in the
// single-pass ("onesweep") scheme:
//   histogram: one pass over the ids counts the entries inside (n_in) and
//     the digits of their local rows, for every digit pass at once.
//   digit pass p (one launch each): a block takes a tile of kTileKeys
//     entries in the order of a ticket counter; ranks its entries by digit,
//     stably (each warp its kItems * 32 entries item by item, peers found
//     by warp match, then a prefix over the warps: two block barriers),
//     drops the empty slots; publishes its count
//     of each digit and adds the counts of the tiles before it by decoupled
//     look-back (a tile's status word holds its own count, then its
//     inclusive prefix; kLookback words read at once, so the walk back
//     over tiles that have only their own count is not one read at a
//     time); and writes its entries to their places, first in
//     digit order into shared memory and then out, so entries of one digit
//     leave as runs. The first pass reads the ids themselves and keeps an
//     entry only when its id lies in the window: that is the compaction.
// Every block waits only on tiles whose tickets came before its own, held
// by running blocks, so the look-back cannot deadlock.

namespace {

constexpr int kThreads = 256;                 // threads per block
constexpr int kBlockWarps = kThreads / 32;
constexpr int kItems = 8;                     // entries per thread per tile
constexpr int kTileKeys = kThreads * kItems;  // entries per tile
constexpr int kDigitBits = 8;                 // bits per digit pass
constexpr int kDigits = 1 << kDigitBits;      // one digit per thread
constexpr int kMaxPasses = 4;                 // 32 bits
constexpr int kHistBlocks = 132 * 4;          // the histogram's grid, at most
constexpr int kLookback = 8;                  // status words read at once
// scratch words: n_in, the passes' tickets, their digit counts, then each
// pass's status words [tiles][kDigits] (ops.SORT_HEAD is kStatus)
constexpr int kNIn = 0;
constexpr int kTickets = 1;
constexpr int kHist = 8;
constexpr int kStatus = kHist + kMaxPasses * kDigits;
// status word: flag in the top two bits, a count below
constexpr uint32_t kAggregate = 1u << 30;     // the tile's own count
constexpr uint32_t kPrefix = 2u << 30;        // counts of the tiles <= it
constexpr uint32_t kCount = kAggregate - 1;

static_assert(kDigits == kThreads, "one digit per thread");

// hist [passes][kDigits]: the digits of the local rows of the ids inside
// the window; n_in: their count. Both zero before the launch.
__global__ void __launch_bounds__(kThreads)
window_histogram(const int32_t* __restrict__ ids, int64_t n, int64_t row_lo,
                 int64_t n_local, int passes, uint32_t* __restrict__ hist,
                 uint32_t* __restrict__ n_in) {
  __shared__ uint32_t s_hist[kMaxPasses][kDigits];
  for (int p = 0; p < kMaxPasses; ++p) s_hist[p][threadIdx.x] = 0;
  __syncthreads();
  uint32_t inside = 0;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * kThreads) {
    const int64_t local = int64_t(__ldg(ids + i)) - row_lo;
    if (static_cast<uint64_t>(local) >= static_cast<uint64_t>(n_local))
      continue;
    ++inside;
    for (int p = 0; p < passes; ++p)
      atomicAdd(&s_hist[p][(local >> (kDigitBits * p)) & (kDigits - 1)], 1u);
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const uint32_t c = s_hist[p][threadIdx.x];
    if (c) atomicAdd(hist + p * kDigits + threadIdx.x, c);
  }
  for (int off = 16; off > 0; off /= 2)
    inside += __shfl_down_sync(0xffffffffu, inside, off);
  if ((threadIdx.x & 31) == 0 && inside) atomicAdd(n_in, inside);
}

// The exclusive prefix sum of v over the block's threads, in thread order;
// *total gets the sum of all. Every thread of the block calls it.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v,
                                                        uint32_t* s_warp,
                                                        uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  uint32_t x = v;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    const uint32_t t = s_warp[w];
    if (w < warp) before += t;
    all += t;
  }
  __syncthreads();                       // s_warp is free again
  *total = all;
  return before + x - v;
}

// One digit pass over bits [shift, shift + kDigitBits) of the keys.
// kFirst: the input is the n flat ids, and an entry is kept when its id
// lies in the window (its key the local row, its value its position);
// otherwise the input is the n_in keys and values of the pass before.
// hist: this pass's digit counts over all n_in keys; status [tiles][kDigits]
// and ticket: this pass's look-back state, zero before the launch.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
window_digit_pass(const int32_t* __restrict__ keys_in,
                  const int32_t* __restrict__ vals_in,
                  int32_t* __restrict__ keys_out,
                  int32_t* __restrict__ vals_out,
                  const uint32_t* __restrict__ hist, uint32_t* status,
                  uint32_t* __restrict__ ticket,
                  const uint32_t* __restrict__ n_in, int64_t n,
                  int64_t row_lo, int64_t n_local, int shift) {
  // a warp's entries per digit, then the entries in the warps before it
  __shared__ uint32_t s_count[kBlockWarps][kDigits];
  __shared__ uint32_t s_start[kDigits];   // the tile's first slot per digit
  __shared__ int64_t s_offset[kDigits];   // output position - tile slot
  __shared__ int32_t s_keys[kTileKeys];
  __shared__ int32_t s_vals[kTileKeys];
  __shared__ uint32_t s_warp[kBlockWarps];
  __shared__ uint32_t s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid / 32;
  if (tid == 0) s_tile = atomicAdd(ticket, 1u);
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) s_count[w][tid] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t count = kFirst ? n : int64_t(__ldg(n_in));
  const int64_t t0 = tile * kTileKeys;
  if (t0 >= count) return;               // no tile waits on this one

  // load: a warp takes kItems * 32 consecutive entries, item k of a lane
  // entry t0 + (warp * kItems + k) * 32 + lane
  int32_t key[kItems], val[kItems];
  uint32_t digit[kItems];                // kDigits: an empty slot
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = t0 + (warp * kItems + k) * 32 + lane;
    bool keep = i < count;
    if (kFirst) {
      const int64_t local = keep ? int64_t(__ldg(keys_in + i)) - row_lo : -1;
      keep = static_cast<uint64_t>(local) < static_cast<uint64_t>(n_local);
      key[k] = static_cast<int32_t>(local);
      val[k] = static_cast<int32_t>(i);
    } else {
      key[k] = keep ? __ldg(keys_in + i) : 0;
      val[k] = keep ? __ldg(vals_in + i) : 0;
    }
    digit[k] = keep ? (static_cast<uint32_t>(key[k]) >> shift) & (kDigits - 1)
                    : uint32_t(kDigits);
  }

  // rank: the entries of the same digit ahead of each in the tile; first
  // those ahead in its warp (item by item, peers found by warp match),
  // then those in the warps before
  uint32_t rank[kItems];
  const uint32_t lanes_below = (1u << lane) - 1;
  uint32_t* counts = s_count[warp];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t d = digit[k];
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    const uint32_t below = __popc(peers & lanes_below);
    const uint32_t base = d < kDigits ? counts[d] : 0u;
    rank[k] = base + below;
    __syncwarp();                        // every peer has read the count
    if (d < kDigits && below == 0) counts[d] = base + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  uint32_t mine = 0;                     // the tile's entries of digit tid
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    const uint32_t c = s_count[w][tid];
    s_count[w][tid] = mine;
    mine += c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (digit[k] < kDigits) rank[k] += s_count[warp][digit[k]];

  // look-back: the entries of digit tid in the tiles before this one
  volatile uint32_t* vs = status;
  uint32_t ahead = 0;
  if (tile == 0) {
    vs[tid] = kPrefix | mine;
  } else {
    vs[tile * kDigits + tid] = kAggregate | mine;
    // kLookback tiles back at once (their reads in flight together), each
    // tile's count added until one holds its prefix; an unpublished tile
    // is read again. Tile 0 always holds its prefix.
    for (int64_t j = tile - 1;;) {
      uint32_t st[kLookback];
#pragma unroll
      for (int u = 0; u < kLookback; ++u) {
        st[u] = kPrefix;                   // before tile 0: nothing more
        if (j - u >= 0) st[u] = vs[(j - u) * kDigits + tid];
      }
      int u = 0;
      bool found = false;
      for (; u < kLookback && (st[u] & ~kCount) != 0; ++u) {
        ahead += st[u] & kCount;
        if (st[u] & kPrefix) {
          found = true;
          break;
        }
      }
      if (found) break;
      j -= u;
    }
    vs[tile * kDigits + tid] = kPrefix | (ahead + mine);
  }
  uint32_t in_tile, all;
  const uint32_t start = block_exclusive_sum(mine, s_warp, &in_tile);
  const uint32_t smaller = block_exclusive_sum(__ldg(hist + tid), s_warp,
                                               &all);
  s_start[tid] = start;
  s_offset[tid] = int64_t(smaller) + ahead - start;
  __syncthreads();

  // write: into shared memory in digit order, then out in runs
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (digit[k] < kDigits) {
      const uint32_t slot = s_start[digit[k]] + rank[k];
      s_keys[slot] = key[k];
      s_vals[slot] = val[k];
    }
  }
  __syncthreads();
  for (uint32_t i = tid; i < in_tile; i += kThreads) {
    const int32_t k = s_keys[i];
    const int64_t at =
        s_offset[(static_cast<uint32_t>(k) >> shift) & (kDigits - 1)] + i;
    keys_out[at] = k;
    vals_out[at] = s_vals[i];
  }
}

}  // namespace

// ids [n] int32; the window [row_lo, row_lo + n_local); `passes` digit
// passes (the keys are sorted by their low kDigitBits * passes bits: all
// of them when n_local - 1 is below 2^(kDigitBits * passes)); keys, vals
// [n] int32 (the output: its first n_in entries); keys_tmp, vals_tmp [n]
// int32 (the passes' other buffer); scratch of scratch_words uint32 (at
// least kStatus + passes * ceil(n / kTileKeys) * kDigits; n_in at word
// kNIn). All contiguous on the current device, n below 2^30. Zeroes the
// scratch and launches the histogram and the digit passes on `stream`;
// returns the first CUDA error (0 = cudaSuccess).
extern "C" int embedding_bag_window_sort(
    const void* ids, void* keys, void* vals, void* keys_tmp, void* vals_tmp,
    void* scratch, int64_t n, int64_t row_lo, int64_t n_local,
    int64_t passes, int64_t scratch_words, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 30) || row_lo < 0 || n_local < 1 ||
      passes < 1 || passes > kMaxPasses)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (n + kTileKeys - 1) / kTileKeys;
  const int64_t words = kStatus + passes * tiles * kDigits;
  if (scratch_words < words) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* s = static_cast<uint32_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(s, 0, words * sizeof(uint32_t), st);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const auto* in = static_cast<const int32_t*>(ids);
  int32_t* out_k[2] = {static_cast<int32_t*>(keys),
                       static_cast<int32_t*>(keys_tmp)};
  int32_t* out_v[2] = {static_cast<int32_t*>(vals),
                       static_cast<int32_t*>(vals_tmp)};
  const auto hist_blocks =
      static_cast<unsigned>(tiles < kHistBlocks ? tiles : kHistBlocks);
  window_histogram<<<hist_blocks, kThreads, 0, st>>>(
      in, n, row_lo, n_local, static_cast<int>(passes), s + kHist, s + kNIn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto blocks = static_cast<unsigned>(tiles);
  for (int p = 0; p < passes; ++p) {
    // the last pass writes the output; each pass reads what the one before
    // wrote
    const int to = static_cast<int>((passes - 1 - p) & 1);
    uint32_t* status = s + kStatus + p * tiles * kDigits;
    if (p == 0) {
      window_digit_pass<true><<<blocks, kThreads, 0, st>>>(
          in, nullptr, out_k[to], out_v[to], s + kHist, status,
          s + kTickets, s + kNIn, n, row_lo, n_local, 0);
    } else {
      window_digit_pass<false><<<blocks, kThreads, 0, st>>>(
          out_k[1 - to], out_v[1 - to], out_k[to], out_v[to],
          s + kHist + p * kDigits, status, s + kTickets + p, s + kNIn, n, 0,
          0, kDigitBits * p);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
