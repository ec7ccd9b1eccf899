// AdamW update of one leaf for Hopper (sm_90a), in one elementwise pass:
//
//   g' = g scale
//   m' = b1 m + (1 - b1) g'              v' = b2 v + (1 - b2) g'^2
//   p' = p - lr (m'/bc1 / (sqrt(v'/bc2) + eps) + wd p)
//
// Replaces no Pallas kernel: the reference's update is `upd` in
// src/repro/train/optimizer.py:55, which XLA fuses inside the jitted step
// into one loop per leaf (p, g, m, v read once; p, m, v written once).
// Run op by op in eager PyTorch the same arithmetic is ~20 passes over the
// leaf, ~55 reads and writes of it in all.
//
// Bound: 4 reads + 3 writes of the leaf (at DLRM-RM2's table, 2.16e9
// elements, 8 x 8.65 GB with the norm's read over 3.35 TB/s); ~17 FLOPs
// an element is far under the FP32 rate. Design: a grid-stride loop over
// groups of 4 elements, each array loaded and stored as one vector of 4
// (16 bytes for f32, 2 x 16 for f64, 8 for bf16) when every pointer is
// aligned to it, a scalar pass over the tail (or over everything when a
// pointer is not). 64-bit indices: the table has more than 2^31 elements.
//
// Bitwise the plain version (`kernels/adamw/ref.py`, torch's eager ops):
//   * every product, sum, quotient and root is rounded on its own
//     (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn and the __d*_rn forms
//     in f64), so nothing contracts into an FMA; the quotients are true
//     IEEE divisions, as torch's divide by a 0-dim device tensor is;
//   * the constants arrive as the Python doubles (1 - b1 and 1 - b2
//     computed in double) and are rounded to the math type here, as torch
//     rounds a Python scalar operand;
//   * scale (f32 or f64), bc1 and bc2 (f32) are read through device
//     pointers and converted to the math type, so the step reads nothing on
//     the host;
//   * bf16 moments are widened exactly and stored round-to-nearest-even
//     (from f64 via f32 first, as c10's BFloat16 conversion does).
// In place, the outputs are the inputs: no pointer is __restrict__, and
// each element is read and then written by the same thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
struct Math;

template <>
struct Math<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float root(float a) {
    return __fsqrt_rn(a);
  }
  static __device__ __forceinline__ float of(double x) {
    return __double2float_rn(x);
  }
  static __device__ __forceinline__ float of(float x) { return x; }
};

template <>
struct Math<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double root(double a) {
    return __dsqrt_rn(a);
  }
  static __device__ __forceinline__ double of(double x) { return x; }
  static __device__ __forceinline__ double of(float x) {
    return static_cast<double>(x);
  }
};

// storage -> math type (exact: widening only) and back (rounded)
template <typename T>
__device__ __forceinline__ T widen(float x) {
  return Math<T>::of(x);
}
template <typename T>
__device__ __forceinline__ T widen(double x) {
  return static_cast<T>(x);   // double -> double only (no f64 g with f32 p)
}
template <typename T>
__device__ __forceinline__ T widen(__nv_bfloat16 x) {
  return Math<T>::of(__bfloat162float(x));
}

template <typename S>
struct Narrow;
template <>
struct Narrow<float> {
  static __device__ __forceinline__ float of(float x) { return x; }
  static __device__ __forceinline__ float of(double x) {
    return __double2float_rn(x);
  }
};
template <>
struct Narrow<double> {
  static __device__ __forceinline__ double of(double x) { return x; }
};
template <>
struct Narrow<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 of(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 of(double x) {
    return __float2bfloat16_rn(__double2float_rn(x));
  }
};

// The hyperparameters as Python doubles; rounded to T in `Consts`.
struct Hyper {
  double lr, b1, omb1, b2, omb2, eps, wd;
};

template <typename T>
struct Consts {
  T lr, b1, omb1, b2, omb2, eps, wd, scale, bc1, bc2;
};

template <typename T>
__device__ __forceinline__ Consts<T> consts(const Hyper& h, const void* scale,
                                            bool scale_f64, const float* bc1,
                                            const float* bc2) {
  using M = Math<T>;
  Consts<T> c;
  c.lr = M::of(h.lr);
  c.b1 = M::of(h.b1);
  c.omb1 = M::of(h.omb1);
  c.b2 = M::of(h.b2);
  c.omb2 = M::of(h.omb2);
  c.eps = M::of(h.eps);
  c.wd = M::of(h.wd);
  c.scale = scale_f64 ? M::of(*static_cast<const double*>(scale))
                      : M::of(*static_cast<const float*>(scale));
  c.bc1 = M::of(*bc1);
  c.bc2 = M::of(*bc2);
  return c;
}

// One element, in the plain version's op order (ref.py `adamw_step_ref`).
template <typename T>
__device__ __forceinline__ void update(T p, T g, T m, T v, const Consts<T>& c,
                                       T* p_new, T* m_new, T* v_new) {
  using M = Math<T>;
  const T gs = M::mul(g, c.scale);
  const T mn = M::add(M::mul(c.b1, m), M::mul(c.omb1, gs));
  const T vn = M::add(M::mul(c.b2, v), M::mul(c.omb2, M::mul(gs, gs)));
  const T m_hat = M::div(mn, c.bc1);
  const T v_hat = M::div(vn, c.bc2);
  const T delta = M::add(M::div(m_hat, M::add(M::root(v_hat), c.eps)),
                         M::mul(c.wd, p));
  *p_new = M::sub(p, M::mul(c.lr, delta));
  *m_new = mn;
  *v_new = vn;
}

// 4 consecutive elements of S, moved as one aligned vector
template <typename S>
struct alignas(4 * sizeof(S)) Pack4 {
  S x[4];
};

template <typename T, typename P, typename G, typename MV>
__global__ void __launch_bounds__(256)
    adamw_vec4(const P* p, const G* g, const MV* m, const MV* v, P* p_out,
               MV* m_out, MV* v_out, const void* scale, bool scale_f64,
               const float* bc1, const float* bc2, Hyper h, int64_t n4) {
  const Consts<T> c = consts<T>(h, scale, scale_f64, bc1, bc2);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const Pack4<P> pv = reinterpret_cast<const Pack4<P>*>(p)[i];
    const Pack4<G> gv = reinterpret_cast<const Pack4<G>*>(g)[i];
    const Pack4<MV> mv = reinterpret_cast<const Pack4<MV>*>(m)[i];
    const Pack4<MV> vv = reinterpret_cast<const Pack4<MV>*>(v)[i];
    Pack4<P> po;
    Pack4<MV> mo, vo;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      T pn, mn, vn;
      update<T>(widen<T>(pv.x[k]), widen<T>(gv.x[k]), widen<T>(mv.x[k]),
                widen<T>(vv.x[k]), c, &pn, &mn, &vn);
      po.x[k] = Narrow<P>::of(pn);
      mo.x[k] = Narrow<MV>::of(mn);
      vo.x[k] = Narrow<MV>::of(vn);
    }
    reinterpret_cast<Pack4<P>*>(p_out)[i] = po;
    reinterpret_cast<Pack4<MV>*>(m_out)[i] = mo;
    reinterpret_cast<Pack4<MV>*>(v_out)[i] = vo;
  }
}

template <typename T, typename P, typename G, typename MV>
__global__ void __launch_bounds__(256)
    adamw_scalar(const P* p, const G* g, const MV* m, const MV* v, P* p_out,
                 MV* m_out, MV* v_out, const void* scale, bool scale_f64,
                 const float* bc1, const float* bc2, Hyper h, int64_t begin,
                 int64_t n) {
  const Consts<T> c = consts<T>(h, scale, scale_f64, bc1, bc2);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = begin + int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T pn, mn, vn;
    update<T>(widen<T>(p[i]), widen<T>(g[i]), widen<T>(m[i]),
              widen<T>(v[i]), c, &pn, &mn, &vn);
    p_out[i] = Narrow<P>::of(pn);
    m_out[i] = Narrow<MV>::of(mn);
    v_out[i] = Narrow<MV>::of(vn);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;   // a grid-stride loop past this

inline int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

inline bool aligned(const void* ptr, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

// Flags of the entry points.
constexpr int64_t kMomentsBf16 = 1;   // m, v bf16 (else f32)
constexpr int64_t kScaleF64 = 2;      // *scale is f64 (else f32)
constexpr int64_t kGradF64 = 4;       // g f64 (else f32; f64 p only)

template <typename T, typename P, typename G, typename MV>
int launch(const void* p, const void* g, const void* m, const void* v,
           void* p_out, void* m_out, void* v_out, const void* scale,
           bool scale_f64, const void* bc1, const void* bc2, const Hyper& h,
           int64_t n, cudaStream_t st) {
  const auto* pp = static_cast<const P*>(p);
  const auto* gp = static_cast<const G*>(g);
  const auto* mp = static_cast<const MV*>(m);
  const auto* vp = static_cast<const MV*>(v);
  auto* po = static_cast<P*>(p_out);
  auto* mo = static_cast<MV*>(m_out);
  auto* vo = static_cast<MV*>(v_out);
  const auto* b1 = static_cast<const float*>(bc1);
  const auto* b2 = static_cast<const float*>(bc2);
  int64_t done = 0;
  if (aligned(pp, 4 * sizeof(P)) && aligned(po, 4 * sizeof(P)) &&
      aligned(gp, 4 * sizeof(G)) && aligned(mp, 4 * sizeof(MV)) &&
      aligned(vp, 4 * sizeof(MV)) && aligned(mo, 4 * sizeof(MV)) &&
      aligned(vo, 4 * sizeof(MV))) {
    const int64_t n4 = n / 4;
    if (n4 > 0) {
      adamw_vec4<T, P, G, MV><<<blocks_for(n4), kThreads, 0, st>>>(
          pp, gp, mp, vp, po, mo, vo, scale, scale_f64, b1, b2, h, n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done = n4 * 4;
  }
  if (done < n) {
    adamw_scalar<T, P, G, MV><<<blocks_for(n - done), kThreads, 0, st>>>(
        pp, gp, mp, vp, po, mo, vo, scale, scale_f64, b1, b2, h, done, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p, g, m, v: n contiguous elements each on the current device; p_out,
// m_out, v_out: where the new p, m, v go (p, m, v themselves in place, or
// n fresh elements each). scale: one f32 or f64 (flags & kScaleF64); bc1,
// bc2: one f32 each, all three on the device. lr ... wd: the
// hyperparameters as doubles (omb1 = 1 - b1, omb2 = 1 - b2). m and v are
// f32 or, with flags & kMomentsBf16, bf16. Launches on `stream` and returns
// cudaGetLastError() of the launches (0 = cudaSuccess); -1 for flags this
// entry point does not take.
//
// adamw_step_f32: p and g f32; math in f32.
extern "C" int adamw_step_f32(const void* p, const void* g, const void* m,
                              const void* v, void* p_out, void* m_out,
                              void* v_out, const void* scale, const void* bc1,
                              const void* bc2, double lr, double b1,
                              double omb1, double b2, double omb2, double eps,
                              double wd, int64_t n, int64_t flags,
                              void* stream) {
  if (flags & ~(kMomentsBf16 | kScaleF64)) return -1;
  if (n <= 0) return 0;
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd};
  const bool sf64 = flags & kScaleF64;
  auto st = static_cast<cudaStream_t>(stream);
  if (flags & kMomentsBf16)
    return launch<float, float, float, __nv_bfloat16>(
        p, g, m, v, p_out, m_out, v_out, scale, sf64, bc1, bc2, h, n, st);
  return launch<float, float, float, float>(
      p, g, m, v, p_out, m_out, v_out, scale, sf64, bc1, bc2, h, n, st);
}

// adamw_step_f64: p f64, g f64 or (flags & kGradF64 clear) f32; math in
// f64.
extern "C" int adamw_step_f64(const void* p, const void* g, const void* m,
                              const void* v, void* p_out, void* m_out,
                              void* v_out, const void* scale, const void* bc1,
                              const void* bc2, double lr, double b1,
                              double omb1, double b2, double omb2, double eps,
                              double wd, int64_t n, int64_t flags,
                              void* stream) {
  if (flags & ~(kMomentsBf16 | kScaleF64 | kGradF64)) return -1;
  if (n <= 0) return 0;
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd};
  const bool sf64 = flags & kScaleF64;
  auto st = static_cast<cudaStream_t>(stream);
  const bool bf16 = flags & kMomentsBf16;
  if (flags & kGradF64) {
    if (bf16)
      return launch<double, double, double, __nv_bfloat16>(
          p, g, m, v, p_out, m_out, v_out, scale, sf64, bc1, bc2, h, n, st);
    return launch<double, double, double, float>(
        p, g, m, v, p_out, m_out, v_out, scale, sf64, bc1, bc2, h, n, st);
  }
  if (bf16)
    return launch<double, double, float, __nv_bfloat16>(
        p, g, m, v, p_out, m_out, v_out, scale, sf64, bc1, bc2, h, n, st);
  return launch<double, double, float, float>(
      p, g, m, v, p_out, m_out, v_out, scale, sf64, bc1, bc2, h, n, st);
}
