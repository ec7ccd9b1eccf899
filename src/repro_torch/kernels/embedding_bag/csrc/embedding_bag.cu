// Embedding-bag lookup for Hopper (sm_90a):
//
//   out[b, :] = sum_l w[b, l] * table[ids[b, l], :]     (w = 1 when absent)
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/embedding_bag.py
// (embedding_bag_pallas + _kernel): there the grid is (B, L), the ids are
// scalar-prefetched, every grid step DMAs one (1, D) table row into VMEM by
// its BlockSpec index map, and the output row stays resident across the
// sequential l axis.
//
// Bound: bytes. A call gathers B*L rows of D floats (B*L*D*4 bytes when no
// row repeats; each distinct row read once is the floor, since repeats can
// hit the 50 MB L2), writes B*D*4 bytes, and reads the B*L ids (and the B*L
// weights when given). Its 2*B*L*D flops are nothing beside that. At
// DLRM-RM2's serve_bulk shape (262,144 samples x 26 bags of one row, D = 64)
// one call reads 1.74 GB of 256-byte random rows and writes 1.74 GB.
//
// Design on Hopper. A group of G lanes owns one bag: G is the number of
// columns rounded up to a power of two and capped at 32, where a column is a
// float4 when D % 4 == 0 and both table and out are 16-byte aligned, else a
// float. The group reads its bag's ids and weights itself (Hopper has no
// scalar prefetch: the lanes of a group read the same word, one broadcast
// load). Each lane keeps its columns' sums in f32 registers, adds the rows
// in l order and writes each column once, with a streaming store so the
// output does not push table rows out of L2. The loop over l replaces the
// TPU grid's sequential axis; rows of four l's are loaded before they are
// added, so every lane has four random reads in flight. Nothing is shared
// between groups, so no barrier and no shared memory.
//
// Row offsets are 64-bit ((int64_t)id * columns): the full RM2 table holds
// 2.16e9 floats, so a 32-bit offset would read the wrong row from row
// 33,554,432 on.
//
// Window. The table may be one rank's row shard of a larger table: rows
// [row_lo, row_lo + n_local) of it, as the row-sharded layout P("model",
// None) puts 1/16 of RM2's rows on each rank of a 16-way model axis
// (embedding_bag_window_f32). An id outside the window adds nothing: the
// test sits in the loop over l, beside the row load it guards (no row is
// read for such an id), with no pass of its own over the ids. The whole
// table is the window [0, V) (embedding_bag_f32), where every id passes the
// test, so the test is compiled out there (kWindow = false): the test's
// registers (40 against 32 a thread) cost the whole-table lookup 14% at
// serve_bulk's shape (probes/eb_window_probe.py), and without it the loads
// and fmas are those of the kernel before it took a window, in the same
// order, with the same bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;   // grid-stride beyond this
constexpr int kUnroll = 4;                           // rows in flight per lane

__device__ __forceinline__ void fma_into(float& acc, float w, float r) {
  acc = fmaf(w, r, acc);
}

__device__ __forceinline__ void fma_into(float4& acc, float w, float4 r) {
  acc.x = fmaf(w, r.x, acc.x);
  acc.y = fmaf(w, r.y, acc.y);
  acc.z = fmaf(w, r.z, acc.z);
  acc.w = fmaf(w, r.w, acc.w);
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The row of `id` in a window of n_local rows from row_lo, or -1 outside.
__device__ __forceinline__ int64_t window_row(int32_t id, int64_t row_lo,
                                              int64_t n_local) {
  const int64_t row = int64_t(id) - row_lo;
  return static_cast<uint64_t>(row) < static_cast<uint64_t>(n_local) ? row
                                                                     : -1;
}

// ids [n_bags, bag] int32; table [n_local, cols] of V-typed columns, rows
// [row_lo, row_lo + n_local) of the whole table (kWindow; else the whole
// table, row_lo 0); w [n_bags, bag] f32 or null (unit weights); out
// [n_bags, cols].
template <typename V, int G, bool kWindow>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int32_t* __restrict__ ids,
                     const V* __restrict__ table,
                     const float* __restrict__ w,
                     V* __restrict__ out,
                     int64_t n_bags, int64_t bag, int64_t cols,
                     int64_t row_lo, int64_t n_local) {
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t stride = int64_t(gridDim.x) * kGroups;
  for (int64_t b = int64_t(blockIdx.x) * kGroups + threadIdx.x / G;
       b < n_bags; b += stride) {
    const int32_t* bag_ids = ids + b * bag;
    const float* bag_w = w ? w + b * bag : nullptr;
    V* out_row = out + b * cols;
    for (int64_t c = lane; c < cols; c += G) {
      V acc = zero<V>();
      int64_t l = 0;
      for (; l + kUnroll <= bag; l += kUnroll) {
        V r[kUnroll];
        float wl[kUnroll];
        bool in[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int32_t id = __ldg(bag_ids + l + k);
          if constexpr (kWindow) {
            const int64_t row = window_row(id, row_lo, n_local);
            in[k] = row >= 0;
            r[k] = in[k] ? __ldg(table + row * cols + c) : zero<V>();
          } else {
            r[k] = __ldg(table + int64_t(id) * cols + c);
          }
          wl[k] = bag_w ? __ldg(bag_w + l + k) : 1.0f;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if constexpr (kWindow) {
            if (in[k]) fma_into(acc, wl[k], r[k]);
          } else {
            fma_into(acc, wl[k], r[k]);
          }
        }
      }
      for (; l < bag; ++l) {
        int64_t row = __ldg(bag_ids + l);
        if constexpr (kWindow) {
          row = window_row(static_cast<int32_t>(row), row_lo, n_local);
          if (row < 0) continue;
        }
        const V r = __ldg(table + row * cols + c);
        fma_into(acc, bag_w ? __ldg(bag_w + l) : 1.0f, r);
      }
      __stcs(out_row + c, acc);
    }
  }
}

template <typename V, int G>
cudaError_t launch(const int32_t* ids, const V* table, const float* w, V* out,
                   int64_t n_bags, int64_t bag, int64_t cols, int64_t row_lo,
                   int64_t n_local, cudaStream_t st) {
  constexpr int64_t kGroups = kThreads / G;
  int64_t blocks = (n_bags + kGroups - 1) / kGroups;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto grid = static_cast<unsigned>(blocks);
  if (n_local < 0) {           // the whole table: no window to test
    embedding_bag_kernel<V, G, false><<<grid, kThreads, 0, st>>>(
        ids, table, w, out, n_bags, bag, cols, 0, 0);
  } else {
    embedding_bag_kernel<V, G, true><<<grid, kThreads, 0, st>>>(
        ids, table, w, out, n_bags, bag, cols, row_lo, n_local);
  }
  return cudaGetLastError();
}

// Lanes per bag: the column count rounded up to a power of two, at most 32.
template <typename V>
cudaError_t dispatch(const int32_t* ids, const V* table, const float* w,
                     V* out, int64_t n_bags, int64_t bag, int64_t cols,
                     int64_t lo, int64_t n, cudaStream_t st) {
  if (cols <= 1)
    return launch<V, 1>(ids, table, w, out, n_bags, bag, cols, lo, n, st);
  if (cols <= 2)
    return launch<V, 2>(ids, table, w, out, n_bags, bag, cols, lo, n, st);
  if (cols <= 4)
    return launch<V, 4>(ids, table, w, out, n_bags, bag, cols, lo, n, st);
  if (cols <= 8)
    return launch<V, 8>(ids, table, w, out, n_bags, bag, cols, lo, n, st);
  if (cols <= 16)
    return launch<V, 16>(ids, table, w, out, n_bags, bag, cols, lo, n, st);
  return launch<V, 32>(ids, table, w, out, n_bags, bag, cols, lo, n, st);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

namespace {

// n_local < 0: the whole table, no window.
int lookup(const void* ids, const void* table, const void* weights, void* out,
           int64_t n_bags, int64_t bag, int64_t dim, int64_t row_lo,
           int64_t n_local, void* stream) {
  if (n_bags <= 0 || dim <= 0) return 0;
  const auto* ip = static_cast<const int32_t*>(ids);
  const auto* wp = static_cast<const float*>(weights);
  auto st = static_cast<cudaStream_t>(stream);
  if (dim % 4 == 0 && aligned16(table) && aligned16(out)) {
    return static_cast<int>(dispatch<float4>(
        ip, static_cast<const float4*>(table), wp, static_cast<float4*>(out),
        n_bags, bag, dim / 4, row_lo, n_local, st));
  }
  return static_cast<int>(dispatch<float>(
      ip, static_cast<const float*>(table), wp, static_cast<float*>(out),
      n_bags, bag, dim, row_lo, n_local, st));
}

}  // namespace

// ids: [n_bags, bag] int32; table: [V, dim] f32; weights: [n_bags, bag] f32,
// or null for unit weights; out: [n_bags, dim] f32. All contiguous on the
// current device. Launches on `stream` and returns cudaGetLastError() of the
// launch (0 = cudaSuccess); launches nothing when n_bags or dim is 0.
extern "C" int embedding_bag_f32(const void* ids, const void* table,
                                 const void* weights, void* out,
                                 int64_t n_bags, int64_t bag, int64_t dim,
                                 void* stream) {
  return lookup(ids, table, weights, out, n_bags, bag, dim, 0, -1, stream);
}

// embedding_bag_f32 over rows [row_lo, row_lo + n_local) of the whole table,
// which `table` ([n_local, dim]) holds: an id outside them adds nothing.
extern "C" int embedding_bag_window_f32(const void* ids, const void* table,
                                        const void* weights, void* out,
                                        int64_t n_bags, int64_t bag,
                                        int64_t dim, int64_t row_lo,
                                        int64_t n_local, void* stream) {
  if (row_lo < 0 || n_local < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return lookup(ids, table, weights, out, n_bags, bag, dim, row_lo, n_local,
                stream);
}
