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
// 33,554,432 on. ids must lie in [0, V); the wrapper does not check them on
// the device (that would cost a host sync on the serve path).

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

// ids [n_bags, bag] int32; table [V, cols] of V-typed columns; w [n_bags,
// bag] f32 or null (unit weights); out [n_bags, cols].
template <typename V, int G>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int32_t* __restrict__ ids,
                     const V* __restrict__ table,
                     const float* __restrict__ w,
                     V* __restrict__ out,
                     int64_t n_bags, int64_t bag, int64_t cols) {
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
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          r[k] = __ldg(table + int64_t(__ldg(bag_ids + l + k)) * cols + c);
          wl[k] = bag_w ? __ldg(bag_w + l + k) : 1.0f;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) fma_into(acc, wl[k], r[k]);
      }
      for (; l < bag; ++l) {
        const V r = __ldg(table + int64_t(__ldg(bag_ids + l)) * cols + c);
        fma_into(acc, bag_w ? __ldg(bag_w + l) : 1.0f, r);
      }
      __stcs(out_row + c, acc);
    }
  }
}

template <typename V, int G>
cudaError_t launch(const int32_t* ids, const V* table, const float* w, V* out,
                   int64_t n_bags, int64_t bag, int64_t cols,
                   cudaStream_t st) {
  constexpr int64_t kGroups = kThreads / G;
  int64_t blocks = (n_bags + kGroups - 1) / kGroups;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  embedding_bag_kernel<V, G><<<static_cast<unsigned>(blocks), kThreads, 0,
                               st>>>(ids, table, w, out, n_bags, bag, cols);
  return cudaGetLastError();
}

// Lanes per bag: the column count rounded up to a power of two, at most 32.
template <typename V>
cudaError_t dispatch(const int32_t* ids, const V* table, const float* w,
                     V* out, int64_t n_bags, int64_t bag, int64_t cols,
                     cudaStream_t st) {
  if (cols <= 1) return launch<V, 1>(ids, table, w, out, n_bags, bag, cols, st);
  if (cols <= 2) return launch<V, 2>(ids, table, w, out, n_bags, bag, cols, st);
  if (cols <= 4) return launch<V, 4>(ids, table, w, out, n_bags, bag, cols, st);
  if (cols <= 8) return launch<V, 8>(ids, table, w, out, n_bags, bag, cols, st);
  if (cols <= 16)
    return launch<V, 16>(ids, table, w, out, n_bags, bag, cols, st);
  return launch<V, 32>(ids, table, w, out, n_bags, bag, cols, st);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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
  if (n_bags <= 0 || dim <= 0) return 0;
  const auto* ip = static_cast<const int32_t*>(ids);
  const auto* wp = static_cast<const float*>(weights);
  auto st = static_cast<cudaStream_t>(stream);
  if (dim % 4 == 0 && aligned16(table) && aligned16(out)) {
    return static_cast<int>(dispatch<float4>(
        ip, static_cast<const float4*>(table), wp, static_cast<float4*>(out),
        n_bags, bag, dim / 4, st));
  }
  return static_cast<int>(dispatch<float>(
      ip, static_cast<const float*>(table), wp, static_cast<float*>(out),
      n_bags, bag, dim, st));
}
