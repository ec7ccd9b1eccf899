// Sum of squares of one leaf for Hopper (sm_90a): sum_i x_i^2, the term
// each gradient leaf adds to the clip's global norm.
//
// Replaces no Pallas kernel: the reference's `global_norm`
// (src/repro/train/optimizer.py:39) is one XLA reduction per leaf inside
// the jitted step. Eager PyTorch's `x.square().sum()` first writes the
// squares, a temporary the size of the leaf (8.64 GB at DLRM-RM2's table).
//
// Bound: one read of the leaf (n x 4 or 8 bytes over 3.35 TB/s); 2 FLOPs
// an element. Design: two launches and no atomics, so the result is the
// same bits on every call (the replay gates compare steps bitwise):
//   1. `partial`: a grid whose size is a function of n alone (never of the
//      SM count), each thread accumulating its grid-stride elements (4 at a
//      time, one 16-byte or 2 x 16-byte load, where x is aligned) in f64,
//      where the square of an f32 is exact; a fixed shuffle tree per warp
//      and a fixed order over the warps give one partial per block;
//   2. `final`: one block adds the partials in a fixed order and writes the
//      sum in the leaf's math type (f32 rounded once from f64, or f64).
// 64-bit indices throughout.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kPerBlock = int64_t(kThreads) * 4 * 16;   // min elements
constexpr int64_t kMaxBlocks = 1024;

// Blocks of pass 1 for n elements: at least kPerBlock elements a block, at
// most kMaxBlocks blocks. A function of n alone.
inline int64_t blocks_for(int64_t n) {
  const int64_t b = (n + kPerBlock - 1) / kPerBlock;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

__device__ __forceinline__ double sq_add(double acc, float x) {
  const double d = static_cast<double>(x);
  return __fma_rn(d, d, acc);
}
__device__ __forceinline__ double sq_add(double acc, double x) {
  return __fma_rn(x, x, acc);
}

// Sum of `acc` over the block in a fixed order; the total lands in thread 0.
__device__ __forceinline__ double block_sum(double acc) {
  __shared__ double warp_sums[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total = __dadd_rn(total, warp_sums[w]);
  }
  return total;
}

template <typename T>
struct alignas(4 * sizeof(T)) Pack4 {
  T x[4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sum_squares_partial(const T* x, int64_t n, bool vec, double* partials) {
  double acc = 0.0;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const auto* x4 = reinterpret_cast<const Pack4<T>*>(x);
#pragma unroll 4
    for (int64_t i = tid; i < n4; i += stride) {
      const Pack4<T> v = x4[i];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = sq_add(acc, v.x[k]);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) acc = sq_add(acc, x[i]);
  const double total = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T>
__device__ __forceinline__ T narrow(double x);
template <>
__device__ __forceinline__ float narrow<float>(double x) {
  return __double2float_rn(x);
}
template <>
__device__ __forceinline__ double narrow<double>(double x) {
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sum_squares_final(const double* partials, int64_t n_blocks, T* out) {
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < n_blocks; i += kThreads)
    acc = __dadd_rn(acc, partials[i]);
  const double total = block_sum(acc);
  if (threadIdx.x == 0) *out = narrow<T>(total);
}

template <typename T>
int launch(const void* x, int64_t n, void* partials, void* out,
           cudaStream_t st) {
  const auto* xp = static_cast<const T*>(x);
  auto* part = static_cast<double*>(partials);
  const int64_t nb = blocks_for(n);
  const bool vec = (reinterpret_cast<uintptr_t>(xp) % (4 * sizeof(T))) == 0;
  sum_squares_partial<T><<<static_cast<int>(nb), kThreads, 0, st>>>(
      xp, n, vec, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_squares_final<T><<<1, kThreads, 0, st>>>(part, nb,
                                                static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f64 scratch `partials` needs this many elements for n (host only).
extern "C" int64_t sum_squares_blocks(int64_t n) { return blocks_for(n); }

// x: n contiguous f32 on the current device (n >= 1); partials:
// sum_squares_blocks(n) f64 of scratch; out: one f32, sum x^2 rounded once
// from the f64 sum. Launches both passes on `stream` and returns
// cudaGetLastError() (0 = cudaSuccess).
extern "C" int sum_squares_f32(const void* x, int64_t n, void* partials,
                               void* out, void* stream) {
  if (n <= 0) return -1;
  return launch<float>(x, n, partials, out, static_cast<cudaStream_t>(stream));
}

// The same over n f64, into one f64.
extern "C" int sum_squares_f64(const void* x, int64_t n, void* partials,
                               void* out, void* stream) {
  if (n <= 0) return -1;
  return launch<double>(x, n, partials, out,
                        static_cast<cudaStream_t>(stream));
}
