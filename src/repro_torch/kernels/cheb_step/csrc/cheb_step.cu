// Fused Chebyshev update for Hopper (sm_90a):
//
//   t'' = 2 y - t            (three-term recurrence)
//   acc' = acc + c_k t''     (mass accumulation)
//
// Replaces the TPU kernel src/repro/kernels/cheb_step/cheb_step.py
// (cheb_step_pallas + _kernel), which streams [R, 128] lane tiles through
// VMEM and reads c_k from SMEM.
//
// Bound: 3 reads + 2 writes of n*B floats (5*n*B*4 bytes over 3.35 TB/s);
// the arithmetic is negligible. Design: one elementwise grid-stride pass
// over the flat array ([n] and [n, B] alike; no 128-lane reshape), 16-byte
// vector loads and stores where every pointer is aligned, a scalar tail
// otherwise. c_k is read from a device pointer, so the adaptive solver's
// device-resident coefficient costs no host sync. The products and sums are
// rounded separately (__fmul_rn/__fadd_rn, no FMA contraction), so the
// kernel matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void step(float y, float t, float acc, float c,
                                     float* t_out, float* acc_out) {
  const float tn = __fsub_rn(__fmul_rn(2.0f, y), t);
  *t_out = tn;
  *acc_out = __fadd_rn(acc, __fmul_rn(c, tn));
}

__global__ void cheb_step_vec4(const float4* __restrict__ y,
                               const float4* __restrict__ t,
                               const float4* __restrict__ acc,
                               const float* __restrict__ ck,
                               float4* __restrict__ t_out,
                               float4* __restrict__ acc_out, int64_t n4) {
  const float c = __ldg(ck);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 yv = y[i], tv = t[i], av = acc[i];
    float4 to, ao;
    step(yv.x, tv.x, av.x, c, &to.x, &ao.x);
    step(yv.y, tv.y, av.y, c, &to.y, &ao.y);
    step(yv.z, tv.z, av.z, c, &to.z, &ao.z);
    step(yv.w, tv.w, av.w, c, &to.w, &ao.w);
    t_out[i] = to;
    acc_out[i] = ao;
  }
}

__global__ void cheb_step_scalar(const float* __restrict__ y,
                                 const float* __restrict__ t,
                                 const float* __restrict__ acc,
                                 const float* __restrict__ ck,
                                 float* __restrict__ t_out,
                                 float* __restrict__ acc_out, int64_t begin,
                                 int64_t n) {
  const float c = __ldg(ck);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = begin + int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    step(y[i], t[i], acc[i], c, &t_out[i], &acc_out[i]);
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

}  // namespace

// y, t, acc, t_out, acc_out: n contiguous f32 each on the current device;
// ck: pointer to one f32 on the device. Launches on `stream` and returns
// cudaGetLastError() of the launches (0 = cudaSuccess).
extern "C" int cheb_step_f32(const void* y, const void* t, const void* acc,
                             const void* ck, void* t_out, void* acc_out,
                             int64_t n, void* stream) {
  if (n <= 0) return 0;
  const auto* yp = static_cast<const float*>(y);
  const auto* tp = static_cast<const float*>(t);
  const auto* ap = static_cast<const float*>(acc);
  const auto* cp = static_cast<const float*>(ck);
  auto* to = static_cast<float*>(t_out);
  auto* ao = static_cast<float*>(acc_out);
  auto st = static_cast<cudaStream_t>(stream);
  int64_t done = 0;
  if (aligned16(yp) && aligned16(tp) && aligned16(ap) && aligned16(to) &&
      aligned16(ao)) {
    const int64_t n4 = n / 4;
    if (n4 > 0) {
      cheb_step_vec4<<<blocks_for(n4), kThreads, 0, st>>>(
          reinterpret_cast<const float4*>(yp),
          reinterpret_cast<const float4*>(tp),
          reinterpret_cast<const float4*>(ap), cp,
          reinterpret_cast<float4*>(to), reinterpret_cast<float4*>(ao), n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done = n4 * 4;
  }
  if (done < n) {
    cheb_step_scalar<<<blocks_for(n - done), kThreads, 0, st>>>(
        yp, tp, ap, cp, to, ao, done, n);
  }
  return static_cast<int>(cudaGetLastError());
}
