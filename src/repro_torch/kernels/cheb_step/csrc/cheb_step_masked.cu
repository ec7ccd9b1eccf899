// Masked Chebyshev round for Hopper (sm_90a), the vector work of one round
// of the adaptive CPAA loop. Per element (i, j) of an [n] or [n, B] array,
// with `active` the loop's per-column convergence mask:
//
//   active[j]:  t'' = 2 y - t ;  acc' = acc + c_k t''
//   else:       t'' = 0       ;  acc' = acc        (acc not written)
//
// t'' is written over y, acc' over acc (both in place).
//
// Replaces no Pallas kernel: the reference's adaptive loop masks its Pallas
// cheb_step with five jnp.where (src/repro/core/pagerank.py:224-230), which
// XLA fuses around the kernel. Eager PyTorch ran them as five passes over
// [n, B] a round. The loop keeps the same function with fewer buffers:
// it rotates (t_prev, t_cur) <- (t_cur, t'') by name and feeds t_cur to the
// SpMM unmasked. A frozen column's t is never read again; its t'' is 0, so
// one round after a freeze the SpMM sees zeros in it, and the column the
// SpMM computes in the round of the freeze is dropped here.
//
// Bound: 3 reads + 2 writes of an active element, 1 write (the zero t'')
// of a frozen one; the arithmetic is negligible. Design: one elementwise
// grid-stride pass over the flat array, 16-byte vectors where every
// pointer is aligned and a vector lies in one row (B a multiple of the
// vector width, or B = 1), a scalar pass otherwise and for the tail. Each
// thread tracks the column of its element by adding the grid stride mod B,
// so no division runs in the loop. A vector whose columns are all frozen
// loads nothing and stores only the zero t''. c_k and the mask are read
// through device pointers (no host sync). Products and sums are rounded
// one by one (no FMA contraction), so the kernel is bitwise the plain
// version (`ref.cheb_step_masked_ref`).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// V elements of T in one 16-byte vector
template <typename T>
struct alignas(16) Vec {
  static constexpr int V = 16 / sizeof(T);
  T x[V];
};

template <typename T>
__global__ void cheb_step_masked_vec(T* y, const T* __restrict__ t, T* acc,
                                     const T* __restrict__ ck,
                                     const bool* __restrict__ active,
                                     int64_t n_vec, int64_t units,
                                     int lane_step) {
  constexpr int V = Vec<T>::V;
  const T c = __ldg(ck);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  // column unit of this thread's vector: tid mod units, advanced by the
  // stride mod units each step (units = B / V, or 1 when B = 1)
  int64_t u = tid % units;
  const int64_t du = stride % units;
  auto* yv = reinterpret_cast<Vec<T>*>(y);
  const auto* tv = reinterpret_cast<const Vec<T>*>(t);
  auto* av = reinterpret_cast<Vec<T>*>(acc);
  for (int64_t i = tid; i < n_vec; i += stride) {
    bool on[V];
    bool any = false;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      on[k] = active[(u * V + k) * lane_step];
      any |= on[k];
    }
    Vec<T> out;
    if (!any) {
#pragma unroll
      for (int k = 0; k < V; ++k) out.x[k] = T(0);
      yv[i] = out;
    } else {
      const Vec<T> yi = yv[i], ti = tv[i];
      Vec<T> ai = av[i];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const T tn = sub_rn(mul_rn(T(2), yi.x[k]), ti.x[k]);
        out.x[k] = on[k] ? tn : T(0);
        if (on[k]) ai.x[k] = add_rn(ai.x[k], mul_rn(c, tn));
      }
      yv[i] = out;
      av[i] = ai;
    }
    u += du;
    if (u >= units) u -= units;
  }
}

template <typename T>
__global__ void cheb_step_masked_scalar(T* y, const T* __restrict__ t,
                                        T* acc, const T* __restrict__ ck,
                                        const bool* __restrict__ active,
                                        int64_t begin, int64_t n,
                                        int64_t cols) {
  const T c = __ldg(ck);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = begin + int64_t(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  int64_t j = first % cols;
  const int64_t dj = stride % cols;
  for (int64_t i = first; i < n; i += stride) {
    if (active[j]) {
      const T tn = sub_rn(mul_rn(T(2), y[i]), t[i]);
      y[i] = tn;
      acc[i] = add_rn(acc[i], mul_rn(c, tn));
    } else {
      y[i] = T(0);
    }
    j += dj;
    if (j >= cols) j -= cols;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

inline int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(void* y, const void* t, void* acc, const void* ck,
           const void* active, int64_t n, int64_t cols, cudaStream_t st) {
  if (n <= 0) return 0;
  constexpr int V = Vec<T>::V;
  auto* yp = static_cast<T*>(y);
  const auto* tp = static_cast<const T*>(t);
  auto* ap = static_cast<T*>(acc);
  const auto* cp = static_cast<const T*>(ck);
  const auto* mp = static_cast<const bool*>(active);
  int64_t done = 0;
  if (aligned16(yp) && aligned16(tp) && aligned16(ap) &&
      (cols == 1 || cols % V == 0)) {
    const int64_t n_vec = n / V;
    if (n_vec > 0) {
      cheb_step_masked_vec<T><<<blocks_for(n_vec), kThreads, 0, st>>>(
          yp, tp, ap, cp, mp, n_vec, cols == 1 ? 1 : cols / V,
          cols == 1 ? 0 : 1);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done = n_vec * V;
  }
  if (done < n) {
    cheb_step_masked_scalar<T><<<blocks_for(n - done), kThreads, 0, st>>>(
        yp, tp, ap, cp, mp, done, n, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, t, acc: n contiguous elements each on the current device, the flat
// view of [n / cols, cols] (cols = 1 for a vector); ck: one element on the
// device; active: `cols` bools on the device. y becomes t'' and acc acc'.
// Launches on `stream` and returns cudaGetLastError() (0 = cudaSuccess).
extern "C" int cheb_step_masked_f32(void* y, const void* t, void* acc,
                                    const void* ck, const void* active,
                                    int64_t n, int64_t cols, void* stream) {
  return launch<float>(y, t, acc, ck, active, n, cols,
                       static_cast<cudaStream_t>(stream));
}

// The same over f64 elements and an f64 c_k.
extern "C" int cheb_step_masked_f64(void* y, const void* t, void* acc,
                                    const void* ck, const void* active,
                                    int64_t n, int64_t cols, void* stream) {
  return launch<double>(y, t, acc, ck, active, n, cols,
                        static_cast<cudaStream_t>(stream));
}
