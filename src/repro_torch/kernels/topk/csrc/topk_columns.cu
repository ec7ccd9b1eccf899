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
// pi.T in vertex order, and at src/repro/models/recsys/dlrm.py:129 (DLRM
// retrieval, one column of candidate scores). The adaptive tick ranks the
// loop's own normalized snapshot in the engine's internal layout
// (block-ELL's BFS order through the row map, padding rows past `rows`),
// so nothing is gathered, transposed or copied first.
//
// Bound: x read once (rows * cols elements), plus the row map, and the
// [cols, k] outputs: bytes. What held the first design (one warp loading
// 16 bytes from each of 32 rows, the block's 8 warps sharing every
// 128-byte row segment) was those loads. So rows now reach the ranking
// warps through shared memory, as whole segments copied asynchronously,
// and no ranking warp loads x:
//   topk_partial: a block takes a set of columns and, tile by tile, the
//     rows it gets from its column group's counter (a block that meets
//     many passing entries takes fewer tiles); a producer warp keeps a
//     ring of kStages stages full, each a tile's rows, their row-map ids
//     and its first row, and the 8 ranking warps read their columns out
//     of it. Three ways to fill a stage (the plan picks by width, type
//     and alignment):
//     * kTma (cols >= 32, x 16-byte aligned, a row a multiple of 16
//       bytes): one thread issues cp.async.bulk.tensor.2d of a [stage_rows
//       x 128-byte] box (32 f32 columns, or two boxes of 16 f64 columns)
//       in the 128-byte swizzle, completing on the stage's mbarrier. Lane
//       l of a warp reads row l's 16-byte chunk of its 4 columns at chunk
//       index c ^ (l & 7): no bank conflict. A tile's column groups are
//       neighbours in the grid, so they read its rows together.
//     * kCopy (cols >= 32 otherwise: ragged widths, offset views): the
//       producer warp's lanes copy one element each with cp.async into
//       the same swizzled layout, a row of the group a warp instruction.
//     * kNarrow (cols < 32: the tick's small buckets, the refresh, DLRM
//       retrieval): the block takes every column; its 8 warps are Q
//       column quads x S = 8 / Q row splits, so every warp ranks. The
//       producer copies whole 16-byte pieces of the tile with cp.async
//       (single elements where a row does not tile into them); a staged
//       row is padded to an odd number of 16-byte pieces, so a warp's
//       16-byte reads down its column quad hit no bank twice, or packed
//       where a row is under 16 bytes (B = 1: 4 rows a piece).
//     The ids come into the stage by the producer's lanes' cp.async. A
//     warp keeps each of its (up to 4) columns' best k as a ranked list
//     in shared memory behind a threshold, its k-th entry. A step is 4
//     batches of 32 rows, read into registers, after which the warp
//     releases the stage to the producer (a warp that merges holds back
//     no other). A lane takes its best value of each column and its
//     lowest id, and the warp skips the step when no lane has a column at
//     or above its threshold (a column of exact zeros behind a zero
//     threshold with lower ids costs one test). Otherwise, in a column
//     where some entry beats the threshold, those entries join a buffer
//     of 32; a full buffer is sorted across the warp (bitonic) and merged
//     into the list in one step, each entry written at its rank in the
//     union (a binary search in the other side). An equal value with a
//     lower id beats the threshold too, so columns of ties stay exact. A
//     full list's k-th entry bounds the whole column (k entries rank at
//     least as well), so f32 lists publish it (atomicMax of a 64-bit key)
//     and every 4th step each warp takes its columns' best published
//     bound, loaded 4 steps before. With S > 1 the quad's warps join
//     their lists pairwise in log2(S) rounds (each list sorted, so a
//     list's offers stop at its first batch that no entry passes). It
//     writes [chunks, cols, k] candidates (chunks: a column group's
//     blocks), id -1 where a block held fewer than k entries.
//   topk_merge: a block a column. Before ranking, a cut from the
//     candidates themselves: the t-th best of the chunks' entries at depth
//     p, t (p + 1) >= k, has k candidates at or before it; with the
//     published bound, only lists whose first entry is at or before the
//     tighter of the two are read, and only their entries at or before
//     it offered. Its 8 warps take whole lists, kLoads at a time, stop a
//     list at its first batch that fails, and join their lists pairwise.
// Both kernels are built for k <= 32 (a lane holds one list entry in a
// merge: the PPR ticks and refreshes) and for k <= 128 (four: DLRM
// retrieval's 100), since the merge's registers at k = 128 cost the
// ranking warps a third of their speed at 2 blocks a SM.
// What bounds it now (PERF.md §6): the ring alone moves slice B's
// 532 MB at 77-87% of the bytes bound, and the ring with the step tests
// at 80-83%; the offers of the few steps that pass, latency-bound at 2
// blocks a SM (the registers' cap), hold the rest. The plan (`make_plan`:
// path, blocks, stage rows, splits, scratch) is a function of the shape
// alone, one wave of 2 blocks a SM on the card's 132 SMs; the wrapper
// reads it through `topk_columns_plan` and the entries make it again.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;                   // ranking warps of a block
constexpr int kThreads = kWarps * 32;       // topk_merge; topk_partial has
constexpr int kPartialThreads = kThreads + 32;  // a producer warp besides
constexpr int kGroup = 32;                  // columns of a wide block
constexpr int kSlots = 4;                   // columns a warp ranks
constexpr int kLists = kWarps * kSlots;     // lists of a topk_partial block
constexpr int kMaxK = 128;
constexpr int kStep = 128;                  // rows a warp tests at once
constexpr int kBatches = kStep / 32;        // 32-row batches of a step
constexpr int kStages = 3;                  // ring depth
constexpr int kMinBlocks = 2;               // topk_partial blocks a SM
constexpr int kMaxChunks = kThreads;        // topk_merge: a head a thread
constexpr int kLoads = 4;                   // topk_merge: lists at once
constexpr int kBoundEvery = 4;              // steps between bound reads
constexpr int kHeader = 1024;               // barriers, counts
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSms = 132;                   // the H100's SMs
constexpr int kNarrowStageBytes = 16384;    // a narrow stage's rows (about)

enum Mode { kNarrow = 0, kTma = 1, kCopy = 2 };

// ------------------------------------------------------------ PTX helpers --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// wait of more than ~1e10 cycles (seconds; a stage takes microseconds) can
// only be a broken pipeline: trap, so that the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 10000000000LL) __trap();
  }
}

// TMA: the box at (c0 = column, c1 = row) of `map` into shared memory,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// cp.async of N bytes (4, 8 or 16) from global to shared memory.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
               :: "r"(smem_u32(dst)), "l"(src), "n"(N) : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (counted as one of the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------ the order --
__device__ __forceinline__ float plus_zero(float v) {
  return __fadd_rn(v, 0.0f);
}
__device__ __forceinline__ double plus_zero(double v) {
  return __dadd_rn(v, 0.0);
}

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() {
  return -__int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return -__longlong_as_double(0x7ff0000000000000LL);
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
// `tighten` takes what the other lists published. The bound changes only
// which entries are offered, never the result. A lane holds KQ entries
// of a list of up to 32 KQ in a merge: the kernels are built for k <= 32
// (KQ = 1, the PPR ticks and refreshes, in fewer registers) and for k <=
// 128 (KQ = 4).
template <typename T, int KQ>
struct List {
  int n;          // entries in the list
  int nb;         // entries in the buffer
  T thr_v;        // the threshold entry; thr_id < 0: none yet
  int thr_id;

  __device__ bool admits(T cv, int ci) const {
    return thr_id < 0 || before(cv, ci, thr_v, thr_id);
  }

  // Take a bound published for the column (`key`, loaded a step before)
  // where it ranks before the threshold.
  __device__ void tighten(unsigned long long key) {
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
    T lv[KQ];
    int li[KQ], lpos[KQ];
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
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
    for (int q = 0; q < KQ; ++q) {
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

  // Offer the n_src entries of a ranked list src_v / src_i (best first),
  // 32 at a time, stopping at the first batch in which no entry passes:
  // the threshold only tightens, so no later entry could.
  __device__ void offer_sorted(const Lists<T>& s, int c,
                               unsigned long long* g, const T* src_v,
                               const int* src_i, int n_src, int lane) {
    for (int b = 0; b < n_src; b += 32) {
      const int j = b + lane;
      const bool ok = j < n_src;
      const T cv = ok ? src_v[j] : T(0);
      const int ci = ok ? src_i[j] : 0;
      if (!__any_sync(kFull, ok && admits(cv, ci))) return;
      offer(s, c, g, ok, cv, ci, lane);
    }
  }
};

// ------------------------------------------------------- the staged rows --
// Where a topk_partial block's stages and lists lie, and how a staged
// row is laid out.
struct Geo {
  int64_t rows;        // ranked rows (n_valid)
  int64_t cols;
  int tiles;           // tiles of stage_rows rows: ceil(rows / stage_rows)
  int stage_rows;      // rows of one stage, a multiple of kStep * splits
  int stage_bytes;     // bytes from one stage to the next (1024-aligned)
  int ids_off;         // a stage's row map ids (stage_rows ints) ...
  int row_off;         // ... and its first row (-1: no tile left)
  int pitch;           // kNarrow: bytes of a staged row (packed: cols * sz)
  int packed;          // kNarrow: rows under 16 bytes, staged back to back
  int quads;           // column quads of a block
  int splits;          // warps sharing a quad, each its share of a stage
  int k;
};

// Byte offset of element (r, c) of a wide stage: kGroup columns in
// 128-byte boxes (one for f32, two for f64), each [stage_rows x 128 B]
// in TMA's 128-byte swizzle (16-byte chunk index XOR row mod 8).
template <typename T>
__device__ __forceinline__ int wide_offset(int r, int c, int stage_rows) {
  const int b = c * static_cast<int>(sizeof(T));
  const int chunk = (b & 127) >> 4;
  return (b >> 7) * stage_rows * 128 + r * 128 +
         (((chunk ^ (r & 7)) << 4) | (b & 15));
}

// Byte offset of element (r, c) of a narrow stage whose first staged
// element lies `mis` bytes past a 16-byte boundary (packed rows only).
template <typename T>
__device__ __forceinline__ int narrow_offset(int r, int c, const Geo& g,
                                             int mis) {
  return g.packed ? mis + (r * static_cast<int>(g.cols) + c) *
                              static_cast<int>(sizeof(T))
                  : r * g.pitch + c * static_cast<int>(sizeof(T));
}

template <typename T, int M>
__device__ __forceinline__ T stage_value(const unsigned char* stage, int r,
                                         int c, const Geo& g, int mis) {
  const int off = M == kNarrow ? narrow_offset<T>(r, c, g, mis)
                               : wide_offset<T>(r, c, g.stage_rows);
  return *reinterpret_cast<const T*>(stage + off);
}

// The kSlots values of row r in columns [4 * quad, 4 * quad + cw) of a
// stage, as stored (-0.0 compares equal to +0.0), -inf in the slots past
// cw: 16-byte reads where the layout allows, else one at a time.
template <typename T, int M>
__device__ __forceinline__ void stage_quad(T (&v)[kSlots],
                                           const unsigned char* stage, int r,
                                           int quad, int cw, const Geo& g,
                                           int mis) {
  if (M != kNarrow || !g.packed) {
    // 16-byte aligned quads: 1 (f32) or 2 (f64) vector reads
#pragma unroll
    for (int h = 0; h < static_cast<int>(sizeof(T)) / 4; ++h) {
      const int c = quad * kSlots + h * (16 / static_cast<int>(sizeof(T)));
      const int off = M == kNarrow
                          ? r * g.pitch + c * static_cast<int>(sizeof(T))
                          : wide_offset<T>(r, c, g.stage_rows);
      const float4 u = *reinterpret_cast<const float4*>(stage + off);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
        v[h * (16 / sizeof(T)) + j] = e[j];
    }
    if (cw < kSlots) {
#pragma unroll
      for (int q = 0; q < kSlots; ++q)
        if (q >= cw) v[q] = neg_inf<T>();
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSlots; ++q)
      v[q] = q < cw ? stage_value<T, M>(stage, r, quad * kSlots + q, g, mis)
                    : neg_inf<T>();
  }
}

// Bytes before a narrow stage's first element past its 16-byte boundary.
template <typename T>
__device__ __forceinline__ int stage_mis(const T* x, const Geo& g,
                                         int64_t row0) {
  return g.packed ? static_cast<int>(
                        reinterpret_cast<uintptr_t>(x + row0 * g.cols) & 15)
                  : 0;
}

// Arrivals that complete one phase of a stage's "full" barrier: lane 0
// once (the TMA's expect_tx, or a plain arrive after it writes the
// stage's first row), and every lane once more where cp.async copies go
// into the stage (each lane's arrival waits for its own copies).
template <int M>
__host__ __device__ constexpr unsigned full_count(bool ids) {
  return 1u + (M != kTma || ids ? 32u : 0u);
}

// The producer warp: takes the block's next tile of its column group from
// `counter` and fills the next stage with it once the ranking warps have
// released that stage: x's rows [row0, row0 + nr) of the block's columns,
// the row map's ids of those rows, and row0 itself (-1 once the tiles are
// gone, which ends the block).
template <typename T, int M>
__device__ void produce(const CUtensorMap* map, const T* __restrict__ x,
                        const int* __restrict__ ids, const Geo& g,
                        unsigned char* stages, uint64_t* full,
                        uint64_t* empty, unsigned* counter, int64_t cbase,
                        int lane) {
  constexpr int sz = sizeof(T);
  for (int it = 0;; ++it) {
    const int st = it % kStages;
    unsigned char* stage = stages + st * g.stage_bytes;
    if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
    int tile = 0;
    if (lane == 0) tile = static_cast<int>(atomicAdd(counter, 1u));
    tile = __shfl_sync(kFull, tile, 0);
    const bool done = tile >= g.tiles;
    const int row0 = done ? -1 : tile * g.stage_rows;
    if (lane == 0)
      *reinterpret_cast<int*>(stage + g.row_off) = row0;
    if (done) {
      // the same arrivals as a fill, with no bytes: the ranking warps
      // read row0 = -1 and stop
      if (lane == 0) mbar_arrive(&full[st]);
      if (M != kTma || ids != nullptr) mbar_arrive(&full[st]);
      break;
    }
    const int nr = static_cast<int>(
        g.rows - row0 < g.stage_rows ? g.rows - row0 : g.stage_rows);
    if constexpr (M == kTma) {
      if (lane == 0) {
        constexpr int boxes = sz / 4;
        mbar_arrive_expect_tx(&full[st], boxes * g.stage_rows * 128);
#pragma unroll
        for (int b = 0; b < boxes; ++b)
          tma_load_2d(stage + b * g.stage_rows * 128, map,
                      static_cast<int>(cbase) + b * (128 / sz), row0,
                      &full[st]);
      }
    } else {
      if (lane == 0) mbar_arrive(&full[st]);   // row0 is written
      if constexpr (M == kCopy) {
        // lane l copies column cbase + l of every row: a row a warp step
        const int64_t c = cbase + lane;
        if (c < g.cols) {
          const T* src = x + int64_t(row0) * g.cols + c;
          for (int r = 0; r < nr; ++r)
            cp_async<sz>(stage + wide_offset<T>(r, lane, g.stage_rows),
                         src + int64_t(r) * g.cols);
        }
      } else {
        const int B = static_cast<int>(g.cols);
        if (g.packed) {
          // the stage's span of x in 16-byte pieces, the ragged ends (at
          // most two pieces) element by element
          const uintptr_t ga =
              reinterpret_cast<uintptr_t>(x + int64_t(row0) * B);
          const int mis = static_cast<int>(ga & 15);
          const unsigned char* base =
              reinterpret_cast<const unsigned char*>(ga - mis);
          const int end = mis + nr * B * sz;
          for (int p = lane; p * 16 < end; p += 32) {
            const int lo = p * 16, hi = lo + 16;
            if (lo >= mis && hi <= end) {
              cp_async<16>(stage + lo, base + lo);
            } else {
              for (int e = lo > mis ? lo : mis; e < (hi < end ? hi : end);
                   e += sz)
                cp_async<sz>(stage + e, base + e);
            }
          }
        } else if ((B * sz) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
          // rows of whole 16-byte pieces
          const int u = B * sz / 16;
          for (int i = lane; i < nr * u; i += 32) {
            const int r = i / u, p = i - r * u;
            cp_async<16>(stage + r * g.pitch + p * 16,
                         reinterpret_cast<const unsigned char*>(
                             x + int64_t(row0 + r) * B) + p * 16);
          }
        } else {
          for (int i = lane; i < nr * B; i += 32) {
            const int r = i / B, c = i - r * B;
            cp_async<sz>(stage + r * g.pitch + c * sz,
                         x + int64_t(row0 + r) * B + c);
          }
        }
      }
    }
    if (ids != nullptr) {
      int* sid = reinterpret_cast<int*>(stage + g.ids_off);
      for (int r = lane; r < nr; r += 32) cp_async<4>(sid + r, ids + row0 + r);
    }
    if (M != kTma || ids != nullptr) cp_async_arrive(&full[st]);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Dynamic shared memory of topk_partial: the header (barriers, list
// counts), alignment slack, the ring and the block's lists and buffers.
template <typename T>
inline size_t partial_smem(int k, int stage_bytes) {
  return size_t(kHeader) + 1024 + size_t(kStages) * stage_bytes +
         size_t(kLists) * (k + 32) * (sizeof(T) + sizeof(int));
}

// Block (group, chunk): the best k of each of the block's columns over
// the tiles it took -> cand_[vi][chunk, col, :], ranked, id -1 past its
// entries. The blocks of a column group take its tiles from one counter
// as they go, so a block that meets many passing entries takes fewer
// tiles. Warp w < kWarps ranks quad w % quads over split w / quads of
// every stage; warp kWarps fills the stages.
template <typename T, int M, int KQ>
__global__ void __launch_bounds__(kPartialThreads, kMinBlocks)
    topk_partial(const __grid_constant__ CUtensorMap map,
                 const T* __restrict__ x, const int* __restrict__ ids,
                 Geo g, unsigned long long* __restrict__ bound,
                 unsigned* __restrict__ counters, T* __restrict__ cand_v,
                 int* __restrict__ cand_i) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  int* held = reinterpret_cast<int*>(empty + kStages);     // kLists
  unsigned char* stages = smem + kHeader;
  const int k = g.k;
  T* list_v = reinterpret_cast<T*>(stages + kStages * g.stage_bytes);
  T* buf_v = list_v + kLists * k;
  int* list_i = reinterpret_cast<int*>(buf_v + kLists * 32);
  int* buf_i = list_i + kLists * k;
  const Lists<T> lists{list_v, list_i, buf_v, buf_i, k};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t cbase = M == kNarrow ? 0 : int64_t(blockIdx.x) * kGroup;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], full_count<M>(ids != nullptr));
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps) {
    produce<T, M>(&map, x, ids, g, stages, full, empty,
                  counters + blockIdx.x, cbase, lane);
    return;
  }

  const int quad = warp % g.quads, split = warp / g.quads;
  const int64_t c0 = cbase + quad * kSlots;
  const int cw = static_cast<int>(
      g.cols - c0 < kSlots ? (g.cols - c0 > 0 ? g.cols - c0 : 0) : kSlots);
  const int steps = g.stage_rows / g.splits / kStep;   // a stage's, a warp's
  const int rows = static_cast<int>(g.rows);   // < 2^31 (make_plan's)
  unsigned long long* gb = bound != nullptr ? bound + c0 : nullptr;
  List<T, KQ> st[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) st[q] = List<T, KQ>{0, 0, T(0), -1};
  // the columns' published bounds, loaded kBoundEvery steps before they
  // are taken
  unsigned long long key[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) key[q] = 0;
  int gs = 0;                                  // the warp's steps so far
  for (int it = 0;; ++it) {
    const int si = it % kStages;
    const unsigned char* stage = stages + si * g.stage_bytes;
    mbar_wait(&full[si], (it / kStages) & 1);
    const int row0 = *reinterpret_cast<const int*>(stage + g.row_off);
    if (row0 < 0) break;
    const int r1 = row0 + g.stage_rows < rows ? row0 + g.stage_rows : rows;
    const int* sid = reinterpret_cast<const int*>(stage + g.ids_off);
    const int mis = M == kNarrow ? stage_mis(x, g, row0) : 0;
    bool released = false;
    for (int m = 0; cw > 0 && m < steps; ++m, ++gs) {
      const int lr0 = (split * steps + m) * kStep;
      if (gb != nullptr && gs % kBoundEvery == 0) {
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          st[q].tighten(key[q]);
          key[q] = q < cw ? __ldcg(gb + q) : 0;
        }
      }
      // kBatches x 32 rows of this warp's columns, a row to a lane, and
      // their ids; a value past the rows or the columns is -inf, below
      // every entry, an id past the rows INT_MAX
      T v[kBatches][kSlots];
      int id[kBatches];
      const bool whole = row0 + lr0 + kStep <= r1;
#pragma unroll
      for (int b = 0; b < kBatches; ++b) {
        const int lr = lr0 + b * 32 + lane;
        if (whole || row0 + lr < r1) {
          stage_quad<T, M>(v[b], stage, lr, quad, cw, g, mis);
          id[b] = ids != nullptr ? sid[lr] : row0 + lr;
        } else {
#pragma unroll
          for (int q = 0; q < kSlots; ++q) v[b][q] = neg_inf<T>();
          id[b] = 0x7fffffff;
        }
      }
      // the stage's last rows are in registers: release it to the
      // producer before ranking, so a warp that merges holds back no other
      if (m == steps - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[si]);
        released = true;
      }
      // a lane's best value of each column and its lowest id against the
      // column's threshold: a few comparisons a column; the warp skips the
      // step when no lane can offer anything
      T best[kSlots];
      int low = id[0];
#pragma unroll
      for (int b = 1; b < kBatches; ++b) low = min(low, id[b]);
      bool maybe = false;
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        best[q] = v[0][q];
#pragma unroll
        for (int b = 1; b < kBatches; ++b)
          best[q] = v[b][q] > best[q] ? v[b][q] : best[q];
        maybe = maybe || (best[q] != neg_inf<T>() &&
                          (st[q].thr_id < 0 || best[q] > st[q].thr_v ||
                           (best[q] == st[q].thr_v && low < st[q].thr_id)));
      }
      if (__any_sync(kFull, maybe)) {
        unsigned hit[kSlots];
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          bool any;
          if (st[q].thr_id < 0) {
            any = best[q] != neg_inf<T>();
          } else {
            any = best[q] > st[q].thr_v;
            if (best[q] == st[q].thr_v) {
#pragma unroll
              for (int b = 0; b < kBatches; ++b)
                any = any || (v[b][q] == best[q] && id[b] < st[q].thr_id);
            }
          }
          hit[q] = __ballot_sync(kFull, any);
        }
        // one inlined offer a column, batch by batch
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          if (hit[q] == 0) continue;
#pragma unroll 1
          for (int b = 0; b < kBatches; ++b) {
            T e = v[0][q];
            int i = id[0];
#pragma unroll
            for (int j = 1; j < kBatches; ++j) {
              e = b == j ? v[j][q] : e;
              i = b == j ? id[j] : i;
            }
            st[q].offer(lists, warp * kSlots + q,
                        gb != nullptr ? gb + q : nullptr,
                        e != neg_inf<T>(), plus_zero(e), i, lane);
          }
        }
      }
    }
    if (!released) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[si]);
    }
  }
#pragma unroll
  for (int q = 0; q < kSlots; ++q) st[q].tighten(key[q]);
#pragma unroll
  for (int q = 0; q < kSlots; ++q)
    if (q < cw) st[q].finish(lists, warp * kSlots + q, lane);

  // splits > 1: the quad's warps join their lists pairwise, in log2(S)
  // rounds, into the first split's
  for (int d = 1; d < g.splits; d <<= 1) {
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kSlots; ++q)
        held[warp * kSlots + q] = q < cw ? st[q].n : 0;
    }
    bar_sync(1, kThreads);
    if (split % (2 * d) == 0) {
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (q >= cw) continue;
        const int c = warp * kSlots + q;
        const int src = (quad + (split + d) * g.quads) * kSlots + q;
        st[q].offer_sorted(lists, c, gb != nullptr ? gb + q : nullptr,
                           list_v + src * k, list_i + src * k, held[src],
                           lane);
        st[q].finish(lists, c, lane);
      }
    }
    bar_sync(1, kThreads);
  }
  if (split != 0) return;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    if (q < cw) {
      const int c = warp * kSlots + q;
      const int64_t o = (int64_t(blockIdx.y) * g.cols + c0 + q) * k;
      for (int j = lane; j < k; j += 32) {
        const bool h = j < st[q].n;
        cand_v[o + j] = h ? list_v[c * k + j] : T(0);
        cand_i[o + j] = h ? list_i[c * k + j] : -1;
      }
    }
  }
}

// Block col: the best k of the column's chunks' ranked lists -> out.
template <typename T, int KQ>
__global__ void __launch_bounds__(kThreads)
    topk_merge(const T* __restrict__ cand_v, const int* __restrict__ cand_i,
               int chunks, int64_t cols, int k,
               const unsigned long long* __restrict__ bound,
               T* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ T list_v[kWarps * KQ * 32];
  __shared__ int list_i[kWarps * KQ * 32];
  __shared__ T buf_v[kWarps * 32];
  __shared__ int buf_i[kWarps * 32];
  __shared__ T head_v[kMaxChunks];
  __shared__ int head_i[kMaxChunks];
  __shared__ int kept[kMaxChunks];
  __shared__ int counts[kWarps];
  __shared__ int held[kWarps];
  __shared__ T cut_v;
  __shared__ int cut_i;
  const int64_t col = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = threadIdx.x;
  auto at = [&](int ch, int j) { return (int64_t(ch) * cols + col) * k + j; };

  // a bound from the candidates: the t_sel-th best entry at depth p of
  // the chunks' lists has t_sel (p + 1) >= k entries at or before it
  const int depth = (k + chunks - 1) / chunks - 1;
  const int t_sel = (k + depth) / (depth + 1);
  if (t == 0) cut_i = -1;
  T hv = T(0), fv = T(0);
  int hi = -1, fi = -1;
  if (t < chunks) {
    hv = cand_v[at(t, depth)];
    hi = cand_i[at(t, depth)];
    fv = cand_v[at(t, 0)];
    fi = cand_i[at(t, 0)];
    head_v[t] = hv;
    head_i[t] = hi;
  }
  __syncthreads();
  if (hi >= 0) {
    int cnt = 0;
#pragma unroll 8
    for (int j = 0; j < chunks; ++j)
      cnt += head_i[j] >= 0 && before(head_v[j], head_i[j], hv, hi);
    if (cnt == t_sel - 1) {
      cut_v = hv;
      cut_i = hi;
    }
  }
  __syncthreads();
  // and the bound the chunks published (f32), where it is tighter
  T cv = cut_v;
  int ci = cut_i;
  if (bound != nullptr && bound[col] != 0) {
    T bv;
    int bi;
    from_key(bound[col], &bv, &bi);
    if (ci < 0 || before(bv, bi, cv, ci)) {
      cv = bv;
      ci = bi;
    }
  }
  // an entry can be in the top k only at or before (cv, ci)
  auto keep = [&](T v, int i) {
    return i >= 0 && (ci < 0 || !before(cv, ci, v, i));
  };
  // the lists whose first entry is kept, gathered in chunk order
  const bool first = t < chunks && keep(fv, fi);
  const unsigned mask = __ballot_sync(kFull, first);
  if (lane == 0) counts[warp] = __popc(mask);
  __syncthreads();
  int n_open = 0, off = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? counts[w] : 0;
    n_open += counts[w];
  }
  if (first) kept[off + __popc(mask & ((1u << lane) - 1u))] = t;
  __syncthreads();

  const Lists<T> lists{list_v, list_i, buf_v, buf_i, k};
  List<T, KQ> st{0, 0, T(0), -1};
  // warp w takes open lists w, w + 8, ..., kLoads at a time, 32 entries
  // a round; a list stays open while the last entry of its batch passes
  for (int l0 = warp; l0 < n_open; l0 += kLoads * kWarps) {
    unsigned live = 0;
#pragma unroll
    for (int s = 0; s < kLoads; ++s)
      if (l0 + s * kWarps < n_open) live |= 1u << s;
    for (int b = 0; live != 0 && b < k; b += 32) {
      T v[kLoads];
      int id[kLoads];
#pragma unroll
      for (int s = 0; s < kLoads; ++s) {
        v[s] = T(0);
        id[s] = -1;
        if ((live >> s) & 1) {
          const int j = b + lane;
          if (j < k) {
            const int64_t o = at(kept[l0 + s * kWarps], j);
            v[s] = cand_v[o];
            id[s] = cand_i[o];
          }
        }
      }
      // one list at a time: the offer is inlined once
#pragma unroll 1
      for (int s = 0; s < kLoads; ++s) {
        if (((live >> s) & 1) == 0) continue;
        T e = v[0];
        int i = id[0];
#pragma unroll
        for (int j = 1; j < kLoads; ++j) {
          e = s == j ? v[j] : e;
          i = s == j ? id[j] : i;
        }
        const bool ok = keep(e, i);
        const bool last = __shfl_sync(kFull, ok && st.admits(e, i),
                                      (k - b < 32 ? k - b : 32) - 1);
        st.offer(lists, warp, nullptr, ok, e, i, lane);
        if (!last) live &= ~(1u << s);
      }
    }
  }
  st.finish(lists, warp, lane);
  // the warps' lists joined pairwise, in log2(8) rounds, into warp 0's
  for (int d = 1; d < kWarps; d <<= 1) {
    if (lane == 0) held[warp] = st.n;
    __syncthreads();
    if (warp % (2 * d) == 0) {
      st.offer_sorted(lists, warp, nullptr, list_v + (warp + d) * k,
                      list_i + (warp + d) * k, held[warp + d], lane);
      st.finish(lists, warp, lane);
    }
    __syncthreads();
  }
  if (warp != 0) return;
  for (int j = lane; j < k; j += 32) {
    out_v[col * k + j] = list_v[j];
    out_i[col * k + j] = list_i[j];
  }
}

// ------------------------------------------------------------------ host --
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn(cudaError_t* err) {
  static EncodeTiledFn encode = nullptr;
  *err = cudaSuccess;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    *err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                            12000, cudaEnableDefault, &q);
    if (*err == cudaSuccess && (q != cudaDriverEntryPointSuccess || !fn))
      *err = cudaErrorSymbolNotFound;
    if (*err != cudaSuccess) return nullptr;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  return encode;
}

// x [rows, cols] row-major as boxes of [box_rows x 128 bytes] in the
// 128-byte swizzle; rows past `rows` and columns past `cols` read as 0.
template <typename T>
cudaError_t encode_map(CUtensorMap* map, const T* x, int64_t rows,
                       int64_t cols, int box_rows) {
  cudaError_t err;
  const EncodeTiledFn encode = encode_fn(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * sizeof(T)};
  const cuuint32_t box[2] = {cuuint32_t(128 / sizeof(T)),
                             cuuint32_t(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      2, const_cast<T*>(x), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Set topk_partial<T, M, KQ>'s dynamic shared memory limit to at least
// `bytes` on the current device (asked of the runtime once per size).
template <typename T, int M, int KQ>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static size_t set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && set[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(topk_partial<T, M, KQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) set[dev] = bytes;
  return err;
}

template <typename T, int M, int KQ>
int launch_partial(const Geo& g, int64_t chunks, cudaStream_t st,
                   const T* x, const int* ids, unsigned long long* bound,
                   unsigned* counters, T* cand_v, int* cand_i) {
  CUtensorMap map = {};
  if constexpr (M == kTma) {
    const cudaError_t e = encode_map<T>(&map, x, g.rows, g.cols,
                                        g.stage_rows);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = partial_smem<T>(g.k, g.stage_bytes);
  const cudaError_t e = allow_smem<T, M, KQ>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t groups = M == kNarrow ? 1 : (g.cols + kGroup - 1) / kGroup;
  // a chunk's column groups side by side, so they read rows together
  const dim3 grid(static_cast<unsigned>(groups),
                  static_cast<unsigned>(chunks));
  topk_partial<T, M, KQ><<<grid, kPartialThreads, smem, st>>>(
      map, x, ids, g, bound, counters, cand_v, cand_i);
  return static_cast<int>(cudaGetLastError());
}

// How one call is cut, a function of its shape alone: the path (mode);
// `chunks` blocks for each group of kGroup columns, one wave of kMinBlocks
// a SM (they take tiles of `stage_rows` rows as they go, at most one
// tile's worth of blocks); `splits` warps sharing a column quad of a
// stage; and the scratch it needs: the column bounds and the groups' tile
// counters (zeroed by the launch), then the blocks' candidate values and
// ids, each part 256-byte aligned.
struct Plan {
  int mode;
  int chunks;
  int stage_rows;
  int splits;
  int pitch;           // narrow: bytes of a staged row (cols * sz if packed)
  int64_t at_v;        // scratch offset of the candidate values ...
  int64_t at_i;        // ... and of their ids
  int64_t bytes;       // scratch size
};

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t round256(int64_t a) { return cdiv(a, 256) * 256; }

// cols < kGroup: the narrow path; the block takes every column, its warps
// are Q column quads (ceil(cols / 4) up to a power of two) x kWarps / Q row
// splits, so every warp ranks, and a stage holds about kNarrowStageBytes
// of rows (whole steps a split). Otherwise TMA where x is 16-byte aligned
// and a row is whole 16-byte pieces, cp.async else; a stage is one step.
// False for a shape the kernel does not take.
inline bool make_plan(int64_t rows, int64_t cols, int k, int sz,
                      bool aligned, Plan* p) {
  const int64_t groups = cdiv(cols, kGroup);
  if (rows <= 0 || rows > INT32_MAX - 65536 || cols <= 0 || k < 1 ||
      k > kMaxK || k > rows || groups > 65535 || (sz != 4 && sz != 8))
    return false;
  int64_t want;
  if (cols < kGroup) {
    int quads = 1;
    while (quads * kSlots < cols) quads <<= 1;
    p->mode = kNarrow;
    p->splits = kWarps / quads;
    // a staged row padded to an odd number of 16-byte pieces, or packed
    // where it is under 16 bytes
    const int row_bytes = static_cast<int>(cols) * sz;
    p->pitch = row_bytes < 16
                   ? row_bytes
                   : static_cast<int>((cdiv(row_bytes, 16) | 1) * 16);
    const int steps = kNarrowStageBytes / (kStep * p->splits * p->pitch);
    int pow2 = 1;
    while (2 * pow2 <= steps) pow2 <<= 1;
    p->stage_rows = kStep * p->splits * pow2;
    want = kMaxChunks < kMinBlocks * kSms ? kMaxChunks : kMinBlocks * kSms;
  } else {
    p->mode = aligned && (cols * sz) % 16 == 0 ? kTma : kCopy;
    p->splits = 1;
    p->pitch = 0;
    p->stage_rows = kStep;
    want = cdiv(kMinBlocks * kSms, groups);
    if (want > kMaxChunks) want = kMaxChunks;
  }
  const int64_t tiles = cdiv(rows, p->stage_rows);
  p->chunks = static_cast<int>(want < tiles ? want : tiles);
  const int64_t n_cand = int64_t(p->chunks) * cols * k;
  p->at_v = round256(8 * cols + 4 * groups);
  p->at_i = p->at_v + round256(n_cand * sz);
  p->bytes = p->at_i + 4 * n_cand;
  return true;
}

template <typename T, int KQ>
int run(const void* x, const void* ids, int64_t rows, int64_t cols, int k,
        void* scratch, int64_t scratch_bytes, void* out_v, void* out_i,
        cudaStream_t st) {
  constexpr int sz = sizeof(T);
  const auto* xp = static_cast<const T*>(x);
  Plan pl;
  if (k > 32 * KQ ||
      !make_plan(rows, cols, k, sz, (reinterpret_cast<uintptr_t>(x) & 15) == 0,
                 &pl) ||
      scratch_bytes < pl.bytes)
    return -1;
  const int stage_rows = pl.stage_rows;
  Geo g{rows, cols, static_cast<int>(cdiv(rows, stage_rows)), stage_rows,
        0, 0, 0, 0, 0, kWarps / pl.splits, pl.splits, k};
  int data = 0;
  if (pl.mode == kNarrow) {
    g.packed = cols * sz < 16;
    g.pitch = pl.pitch;
    // packed spans begin up to 15 bytes in; a quad's reads end up to 32
    // bytes past a row
    data = (stage_rows * g.pitch + 48 + 15) / 16 * 16;
  } else {
    data = stage_rows * kGroup * sz;
  }
  // a stage: its rows, their ids (with a row map), its first row
  g.ids_off = data;
  g.row_off = data + (ids != nullptr ? stage_rows * 4 : 0);
  g.stage_bytes = (g.row_off + 16 + 1023) / 1024 * 1024;
  const auto* ip = static_cast<const int*>(ids);
  auto* base = static_cast<unsigned char*>(scratch);
  auto* cv = reinterpret_cast<T*>(base + pl.at_v);
  auto* ci = reinterpret_cast<int*>(base + pl.at_i);
  // the column bounds (f32; 0 is below every entry), then the column
  // groups' tile counters, zeroed together
  auto* bp = reinterpret_cast<unsigned long long*>(base);
  auto* counters = reinterpret_cast<unsigned*>(bp + cols);
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, cols * sizeof(*bp) + cdiv(cols, kGroup) * sizeof(unsigned),
      st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (sz != 4) bp = nullptr;
  int err;
  if (pl.mode == kNarrow)
    err = launch_partial<T, kNarrow, KQ>(g, pl.chunks, st, xp, ip, bp,
                                         counters, cv, ci);
  else if (pl.mode == kTma)
    err = launch_partial<T, kTma, KQ>(g, pl.chunks, st, xp, ip, bp, counters,
                                      cv, ci);
  else
    err = launch_partial<T, kCopy, KQ>(g, pl.chunks, st, xp, ip, bp,
                                       counters, cv, ci);
  if (err != 0) return err;
  topk_merge<T, KQ><<<static_cast<unsigned>(cols), kThreads, 0, st>>>(
      cv, ci, pl.chunks, cols, k, bp, static_cast<T*>(out_v),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan of ranking `rows` rows of a [*, cols] array of `itemsize`-byte
// elements (4 or 8) whose base is 16-byte aligned or not, k <= min(128,
// rows): out[0..4] = mode (0 narrow, 1 TMA, 2 cp.async), chunks, stage
// rows, splits, scratch bytes. Returns 0, or -1 for a shape the kernel
// does not take.
extern "C" int topk_columns_plan(int64_t rows, int64_t cols, int k,
                                 int itemsize, int aligned, int64_t* out) {
  Plan p;
  if (!make_plan(rows, cols, k, itemsize, aligned != 0, &p)) return -1;
  out[0] = p.mode;
  out[1] = p.chunks;
  out[2] = p.stage_rows;
  out[3] = p.splits;
  out[4] = p.bytes;
  return 0;
}

// x: [rows_total, cols] contiguous f32 on the current device, ranked over
// its first `rows` rows; ids: `rows` int32 vertex ids of those rows, or
// null for ids 0..rows-1; 1 <= k <= min(128, rows). scratch: device
// memory of at least the plan's scratch bytes (`topk_columns_plan`; the
// kernel makes the same plan). out_v [cols, k] f32 and out_i [cols, k]
// int32. Launches on `stream`; returns cudaGetLastError() (0 =
// cudaSuccess), or -1 for arguments the kernel does not take.
extern "C" int topk_columns_f32(const void* x, const void* ids, int64_t rows,
                                int64_t cols, int k, void* scratch,
                                int64_t scratch_bytes, void* out_v,
                                void* out_i, void* stream) {
  auto* go = k <= 32 ? run<float, 1> : run<float, kMaxK / 32>;
  return go(x, ids, rows, cols, k, scratch, scratch_bytes, out_v, out_i,
            static_cast<cudaStream_t>(stream));
}

// The same for f64 x and out_v.
extern "C" int topk_columns_f64(const void* x, const void* ids, int64_t rows,
                                int64_t cols, int k, void* scratch,
                                int64_t scratch_bytes, void* out_v,
                                void* out_i, void* stream) {
  return run<double, kMaxK / 32>(x, ids, rows, cols, k, scratch,
                                 scratch_bytes, out_v, out_i,
                                 static_cast<cudaStream_t>(stream));
}
