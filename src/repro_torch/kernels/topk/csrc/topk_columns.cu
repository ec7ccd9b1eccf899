// Ranked top-k down the columns of a row-major array, for Hopper (sm_90a).
//
// For each column b of x [rows, cols] (contiguous, f32 or f64), the k
// entries of rows r < rows that come first under one strict total order:
// larger value first, then the lower vertex id, where row r holds vertex
// ids[r] (or r without a row map). That is `lax.top_k`'s rule, lower index
// first, applied to the vertex id and not to the row. Ids are distinct, so
// the result is unique: the same bits on every call, whatever the grid.
// +0.0 and -0.0 compare equal and come out as +0.0; inputs are finite.
// Outputs: out_v [cols, k] values and out_i [cols, k] int32 vertex ids,
// each row ranked best first.
//
// Replaces no Pallas kernel: the reference ranks with `jax.lax.top_k`,
// which XLA runs, at src/repro/serve/pagerank_service.py:311 (the
// fixed-round tick), :323 (the refresh) and :339 (the adaptive tick), over
// pi.T in vertex order. Eager PyTorch built that rule from two torch.topk
// calls, masks, a cumsum and a stable sort over the transposed [B, n] view
// of pi, after a row gather into vertex order and a normalization: some
// twenty passes over [n, B] and their strided copies. Here the adaptive
// tick ranks the loop's own normalized snapshot in the engine's internal
// layout (block-ELL's BFS order, padding rows past `rows`), so nothing is
// gathered, transposed or copied first.
//
// Bound: x read once (rows * cols elements), plus the row map, and the
// [cols, k] outputs: bytes. Design, in two launches:
//   topk_partial: a block takes a chunk of rows x a group of 32 columns,
//     a warp 4 of them. Lane l reads the warp's 4 values of rows l, l + 32,
//     ... in 16-byte pieces (single elements where cols is not a multiple
//     of the vector or x is unaligned), 4 batches of 32 rows at once, so a
//     batch of one column lies in the lanes' registers and the 8 warps
//     share each 128-byte row segment; no warp waits on another. The warp
//     keeps each column's best k of the chunk as a ranked list in shared
//     memory behind a threshold, its k-th entry. It tests the 4 batches
//     of its 4 columns at once (one ballot a column); in a column where
//     some entry beats the threshold, those entries join a buffer of 32.
//     A full buffer is sorted across the warp (bitonic) and merged into
//     the list in one step, each entry written at its rank in the union
//     (a binary search in the other side). An equal value with a lower id
//     beats the threshold too, so columns of ties stay exact. A full
//     list's k-th entry bounds the whole column (k entries rank at least
//     as well), so f32 lists publish it (atomicMax of a 64-bit key) and
//     every 4th step each warp takes its columns' best published bound as
//     threshold: in a snapshot of mostly exact zeros, the zeros stop being
//     offered once any chunk holds k positive entries. The bound changes
//     what is offered, never the result. It writes [chunks, cols, k]
//     candidates, id -1 where a chunk held fewer than k entries.
//   topk_merge: a block a column; its 8 warps each rank an interleaved
//     share of the column's candidates, several loads in flight a lane, and
//     warp 0 merges the other seven lists into its own.
// The chunk count is a function of rows alone (at most 256 chunks of at
// least 2,048 rows), so a single column (the refresh) still spreads over
// the card. What holds it now is the reads of 16 bytes a lane from 32
// rows, not the ranking: the pass with the ranking cut out takes most of
// its time.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;                  // columns of a topk_partial block
constexpr int kSlots = kGroup / kWarps;     // columns a warp ranks there
constexpr int kMaxK = 128;
constexpr int kQ = kMaxK / 32;              // list entries a lane holds
constexpr int64_t kMinChunkRows = 2048;
constexpr int64_t kMaxChunks = 256;
constexpr int kLoads = 4;                   // topk_merge: loads a lane at once
constexpr int kBatches = 4;                 // 32-row batches read at once
constexpr int kBoundEvery = 4;              // steps between bound reads
constexpr unsigned kFull = 0xffffffffu;

// Chunks of rows for topk_partial: a function of rows alone.
inline int64_t chunks_for(int64_t rows) {
  const int64_t c = (rows + kMinChunkRows - 1) / kMinChunkRows;
  return c < 1 ? 1 : (c > kMaxChunks ? kMaxChunks : c);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

__device__ __forceinline__ float plus_zero(float v) {
  return __fadd_rn(v, 0.0f);
}
__device__ __forceinline__ double plus_zero(double v) {
  return __dadd_rn(v, 0.0);
}

// (av, ai) ranks before (bv, bi): the larger value, then the lower id
template <typename T>
__device__ __forceinline__ bool before(T av, int ai, T bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// An f32 entry as one 64-bit key in the same order (a larger key ranks
// before): the value's bits made monotone, then ~id, so a lower id is a
// larger key. 0 is below every entry. f64 entries publish no key.
__device__ __forceinline__ unsigned long long rank_key(float v, int id) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(~id);
}
__device__ __forceinline__ unsigned long long rank_key(double, int) {
  return 0;
}
__device__ __forceinline__ void from_key(unsigned long long key, float* v,
                                         int* id) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  *v = __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
  *id = ~static_cast<int>(static_cast<unsigned>(key));
}
__device__ __forceinline__ void from_key(unsigned long long, double*, int*) {}

// The shared-memory arrays of a block's ranked lists: list c is
// v[c * k, (c + 1) * k) with its buffer bv[c * 32, (c + 1) * 32).
template <typename T>
struct Lists {
  T* v;
  int* id;
  T* bv;
  int* bi;
  int k;
};

// One warp's ranked list of at most k entries, best first, and a buffer of
// up to 32 entries waiting to join it, in a `Lists` slot; this holds the
// counts and the threshold. Every field is the same in all lanes of the
// warp, which calls each method together.
//
// The threshold is the better of the list's own k-th entry (once it holds
// k) and a bound published for the whole column: any full list's k-th
// entry is one, since the column then holds k entries at least as good.
// An entry that does not rank before it cannot be in the column's top k.
// Where `g` is given (f32 in topk_partial), a list that fills or improves
// its k-th entry publishes it there (atomicMax of `rank_key`), and
// `tighten` takes what the other chunks published. The bound changes only
// which entries are offered, never the result.
template <typename T>
struct List {
  int n;          // entries in the list
  int nb;         // entries in the buffer
  T thr_v;        // the threshold entry; thr_id < 0: none yet
  int thr_id;

  __device__ bool admits(T cv, int ci) const {
    return thr_id < 0 || before(cv, ci, thr_v, thr_id);
  }

  // Take the column's published bound where it ranks before the threshold.
  __device__ void tighten(const unsigned long long* g) {
    const unsigned long long key = __ldcg(g);
    if (key == 0) return;
    T v;
    int id;
    from_key(key, &v, &id);
    if (thr_id < 0 || before(v, id, thr_v, thr_id)) {
      thr_v = v;
      thr_id = id;
    }
  }

  // Offer each lane's entry (where ok) to list c: the lanes that beat the
  // threshold append theirs to the buffer; a buffer that would overflow
  // is merged first, and the lanes are checked again against the
  // threshold that left.
  __device__ void offer(const Lists<T>& s, int c, unsigned long long* g,
                        bool ok, T cv, int ci, int lane) {
    bool pass = ok && admits(cv, ci);
    unsigned m = __ballot_sync(kFull, pass);
    if (m == 0) return;
    if (nb + __popc(m) > 32) {
      merge(s, c, g, lane);
      pass = ok && admits(cv, ci);
      m = __ballot_sync(kFull, pass);
    }
    if (pass) {
      const int slot = c * 32 + nb + __popc(m & ((1u << lane) - 1u));
      s.bv[slot] = cv;
      s.bi[slot] = ci;
    }
    nb += __popc(m);
    __syncwarp();
  }

  // Merge the buffer into the list: a bitonic sort of the buffer across
  // the lanes, then every entry of either side written at its rank in the
  // union (a binary search in the other side); ranks past k drop out.
  __device__ void merge(const Lists<T>& s, int c, unsigned long long* g,
                        int lane) {
    const int k = s.k;
    T* v = s.v + c * k;
    int* id = s.id + c * k;
    bool xo = lane < nb;
    T x = xo ? s.bv[c * 32 + lane] : T(0);
    int xi = xo ? s.bi[c * 32 + lane] : 0;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int j = size >> 1; j > 0; j >>= 1) {
        const T y = __shfl_xor_sync(kFull, x, j);
        const int yi = __shfl_xor_sync(kFull, xi, j);
        const bool yo = __shfl_xor_sync(kFull, static_cast<int>(xo), j);
        // the lower lane of the pair keeps the entry that ranks first in
        // a block sorted best first, the last in one sorted the other way
        const bool x_first = xo && (!yo || before(x, xi, y, yi));
        const bool keep_first = ((lane & j) == 0) == ((lane & size) == 0);
        if (keep_first != x_first) {
          x = y;
          xi = yi;
          xo = yo;
        }
      }
    }
    // lane b now holds the buffer's b-th entry (b < nb); its rank in the
    // list is the count of list entries before it
    int r = 0;
    if (xo) {
      int hi = n;
      while (r < hi) {
        const int mid = (r + hi) >> 1;
        if (before(v[mid], id[mid], x, xi)) r = mid + 1;
        else hi = mid;
      }
    }
    T lv[kQ];
    int li[kQ], lpos[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      lpos[q] = k;
      if (q * 32 < n) {
        const int j = q * 32 + lane;
        const bool held = j < n;
        lv[q] = held ? v[j] : T(0);
        li[q] = held ? id[j] : 0;
        // buffer entries before list entry j: a search over the sorted
        // lanes (steps 16..1 find up to 31; the last probe the 32nd)
        int cnt = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int probe = cnt + step - 1;
          const T pv = __shfl_sync(kFull, x, probe);
          const int pi = __shfl_sync(kFull, xi, probe);
          if (probe < nb && before(pv, pi, lv[q], li[q])) cnt += step;
        }
        const T pv = __shfl_sync(kFull, x, cnt & 31);
        const int pi = __shfl_sync(kFull, xi, cnt & 31);
        if (cnt < nb && before(pv, pi, lv[q], li[q])) ++cnt;
        if (held) lpos[q] = j + cnt;
      }
    }
    __syncwarp();
    if (xo && lane + r < k) {
      v[lane + r] = x;
      id[lane + r] = xi;
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (lpos[q] < k) {
        v[lpos[q]] = lv[q];
        id[lpos[q]] = li[q];
      }
    }
    __syncwarp();
    n = n + nb < k ? n + nb : k;
    nb = 0;
    if (n == k) {
      const T kv = v[k - 1];
      const int ki = id[k - 1];
      if (thr_id < 0 || before(kv, ki, thr_v, thr_id)) {
        thr_v = kv;
        thr_id = ki;
        if (g != nullptr && lane == 0) atomicMax(g, rank_key(kv, ki));
      }
    }
  }

  // Merge what the buffer still holds.
  __device__ void finish(const Lists<T>& s, int c, int lane) {
    if (nb > 0) merge(s, c, nullptr, lane);
  }
};

// Dynamic shared memory of topk_partial: the block's lists and their
// buffers.
template <typename T>
inline size_t partial_smem(int k) {
  return static_cast<size_t>(kGroup) * (k + 32) * (sizeof(T) + sizeof(int));
}

// Block (chunk, group): the best k of each column of the group over the
// chunk's rows -> cand_[vi][chunk, col, :], ranked, id -1 past its rows.
// Warp w of the block takes kSlots columns of the group; lane l reads the
// kSlots values of rows l, l + 32, ... in 16-byte pieces, so a warp's
// batch of 32 rows of one column lies in its lanes' registers. No warp
// waits on another.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 3)
    topk_partial(const T* __restrict__ x, const int* __restrict__ ids,
                 int64_t rows, int64_t cols, int k, int64_t chunk_rows,
                 unsigned long long* __restrict__ bound,
                 T* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c0 = (int64_t(blockIdx.y) * kWarps + warp) * kSlots;
  if (c0 >= cols) return;
  const int cw = static_cast<int>(cols - c0 < kSlots ? cols - c0 : kSlots);
  T* list_v = reinterpret_cast<T*>(smem);
  T* buf_v = list_v + kGroup * k;
  int* list_i = reinterpret_cast<int*>(buf_v + kGroup * 32);
  int* buf_i = list_i + kGroup * k;
  const Lists<T> lists{list_v, list_i, buf_v, buf_i, k};
  List<T> st[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) st[q] = List<T>{0, 0, T(0), -1};

  const int64_t r0 = int64_t(blockIdx.x) * chunk_rows;
  const int64_t r1 = r0 + chunk_rows < rows ? r0 + chunk_rows : rows;
  int step = 0;
  for (int64_t b0 = r0; b0 < r1; b0 += kBatches * 32, ++step) {
    // kBatches x 32 rows of this warp's columns, a row to a lane
    T v[kBatches][kSlots];
    int id[kBatches];
    bool ok[kBatches];
#pragma unroll
    for (int s = 0; s < kBatches; ++s) {
      const int64_t row = b0 + s * 32 + lane;
      ok[s] = row < r1;
#pragma unroll
      for (int q = 0; q < kSlots; ++q) v[s][q] = T(0);
      id[s] = 0;
      if (ok[s]) {
        const T* src = x + row * cols + c0;
#pragma unroll
        for (int u = 0; u < kSlots / V; ++u) {
          if (u * V < cw) {
            const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(
                src + u * V);
#pragma unroll
            for (int j = 0; j < V; ++j) v[s][u * V + j] = plus_zero(pk.x[j]);
          }
        }
        id[s] = ids != nullptr ? ids[row] : static_cast<int>(row);
      }
    }
    // the columns' published bounds, read while those loads are in
    // flight, every kBoundEvery steps
    if (bound != nullptr && step % kBoundEvery == 0) {
#pragma unroll
      for (int q = 0; q < kSlots; ++q)
        if (q < cw) st[q].tighten(bound + c0 + q);
    }
    // which columns have a row here that beats its threshold
    unsigned hit[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      bool any = false;
#pragma unroll
      for (int s = 0; s < kBatches; ++s)
        any = any || (ok[s] && q < cw && st[q].admits(v[s][q], id[s]));
      hit[q] = __ballot_sync(kFull, any);
    }
    // the offers read their rows again (cached): one inlined offer a
    // column, not one a batch, keeps the kernel's code small
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      if (hit[q] == 0) continue;
#pragma unroll 1
      for (int s = 0; s < kBatches; ++s) {
        const int64_t row = b0 + s * 32 + lane;
        const bool in = row < r1;
        const T val = in ? plus_zero(x[row * cols + c0 + q]) : T(0);
        const int vid = !in ? 0
                        : (ids != nullptr ? ids[row]
                                          : static_cast<int>(row));
        st[q].offer(lists, warp * kSlots + q,
                    bound != nullptr ? bound + c0 + q : nullptr, in, val,
                    vid, lane);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    if (q < cw) {
      const int c = warp * kSlots + q;
      st[q].finish(lists, c, lane);
      const int64_t o = (int64_t(blockIdx.x) * cols + c0 + q) * k;
      for (int j = lane; j < k; j += 32) {
        const bool held = j < st[q].n;
        cand_v[o + j] = held ? list_v[c * k + j] : T(0);
        cand_i[o + j] = held ? list_i[c * k + j] : -1;
      }
    }
  }
}

// Block col: the best k of the column's chunks * k candidates -> out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_merge(const T* __restrict__ cand_v, const int* __restrict__ cand_i,
               int64_t chunks, int64_t cols, int k, T* __restrict__ out_v,
               int* __restrict__ out_i) {
  __shared__ T list_v[kWarps * kMaxK];
  __shared__ int list_i[kWarps * kMaxK];
  __shared__ T buf_v[kWarps * 32];
  __shared__ int buf_i[kWarps * 32];
  __shared__ int held[kWarps];
  const int64_t col = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // list w of `lists` is warp w's
  const Lists<T> lists{list_v, list_i, buf_v, buf_i, k};
  List<T> st{0, 0, T(0), -1};
  const int64_t total = chunks * k;
  for (int64_t j0 = int64_t(warp) * 32; j0 < total;
       j0 += int64_t(kLoads) * kThreads) {
    T v[kLoads];
    int id[kLoads];
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      const int64_t j = j0 + int64_t(s) * kThreads + lane;
      v[s] = T(0);
      id[s] = -1;
      if (j < total) {
        const int64_t ch = j / k;
        const int64_t g = (ch * cols + col) * k + (j - ch * k);
        v[s] = cand_v[g];
        id[s] = cand_i[g];
      }
    }
#pragma unroll
    for (int s = 0; s < kLoads; ++s)
      st.offer(lists, warp, nullptr, id[s] >= 0, v[s], id[s], lane);
  }
  st.finish(lists, warp, lane);
  if (lane == 0) held[warp] = st.n;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    for (int b = 0; b < held[w]; b += 32) {
      const int j = b + lane;
      const bool ok = j < held[w];
      st.offer(lists, 0, nullptr, ok, ok ? list_v[w * k + j] : T(0),
               ok ? list_i[w * k + j] : 0, lane);
    }
  }
  st.finish(lists, 0, lane);
  for (int j = lane; j < k; j += 32) {
    out_v[col * k + j] = list_v[j];
    out_i[col * k + j] = list_i[j];
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int V>
int launch_partial(dim3 grid, size_t smem, cudaStream_t st, const T* x,
                   const int* ids, int64_t rows, int64_t cols, int k,
                   int64_t chunk_rows, unsigned long long* bound, T* cand_v,
                   int* cand_i) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_partial<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  topk_partial<T, V><<<grid, kThreads, smem, st>>>(
      x, ids, rows, cols, k, chunk_rows, bound, cand_v, cand_i);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* ids, int64_t rows, int64_t cols, int k,
        void* bound, void* cand_v, void* cand_i, void* out_v, void* out_i,
        cudaStream_t st) {
  const int64_t groups = (cols + kGroup - 1) / kGroup;
  if (rows <= 0 || rows > INT32_MAX || cols <= 0 || groups > 65535 ||
      k < 1 || k > kMaxK || k > rows)
    return -1;
  constexpr int V = 16 / sizeof(T);
  const int64_t chunks = chunks_for(rows);
  const int64_t chunk_rows = (rows + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks),
                  static_cast<unsigned>(groups));
  const size_t smem = partial_smem<T>(k);
  const auto* xp = static_cast<const T*>(x);
  const auto* ip = static_cast<const int*>(ids);
  auto* cv = static_cast<T*>(cand_v);
  auto* ci = static_cast<int*>(cand_i);
  // the column bounds start at 0, below every entry (f32 only)
  unsigned long long* bp = nullptr;
  if (sizeof(T) == 4) {
    bp = static_cast<unsigned long long*>(bound);
    const cudaError_t e = cudaMemsetAsync(bp, 0, cols * sizeof(*bp), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int err =
      cols % V == 0 && aligned16(x)
          ? launch_partial<T, V>(grid, smem, st, xp, ip, rows, cols, k,
                                 chunk_rows, bp, cv, ci)
          : launch_partial<T, 1>(grid, smem, st, xp, ip, rows, cols, k,
                                 chunk_rows, bp, cv, ci);
  if (err != 0) return err;
  topk_merge<T><<<static_cast<unsigned>(cols), kThreads, 0, st>>>(
      cv, ci, chunks, cols, k, static_cast<T*>(out_v),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Chunks of candidates for `rows` rows (host only): the scratch cand_v and
// cand_i each hold chunks * cols * k elements.
extern "C" int64_t topk_columns_chunks(int64_t rows) {
  return chunks_for(rows);
}

// x: [rows_total, cols] contiguous f32 on the current device, ranked over
// its first `rows` rows; ids: `rows` int32 vertex ids of those rows, or
// null for ids 0..rows-1; 1 <= k <= min(128, rows); bound: cols 8-byte
// words of scratch (the column bounds, zeroed here). out_v [cols, k] f32
// and out_i [cols, k] int32. Launches on `stream`; returns
// cudaGetLastError() (0 = cudaSuccess), or -1 for arguments the kernel
// does not take.
extern "C" int topk_columns_f32(const void* x, const void* ids, int64_t rows,
                                int64_t cols, int k, void* bound,
                                void* cand_v, void* cand_i, void* out_v,
                                void* out_i, void* stream) {
  return run<float>(x, ids, rows, cols, k, bound, cand_v, cand_i, out_v,
                    out_i, static_cast<cudaStream_t>(stream));
}

// The same for f64 x, cand_v and out_v (bound unused: may be null).
extern "C" int topk_columns_f64(const void* x, const void* ids, int64_t rows,
                                int64_t cols, int k, void* bound,
                                void* cand_v, void* cand_i, void* out_v,
                                void* out_i, void* stream) {
  return run<double>(x, ids, rows, cols, k, bound, cand_v, cand_i, out_v,
                     out_i, static_cast<cudaStream_t>(stream));
}
