// Attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(Dh)) v by
// the online softmax over KV tiles, one block per (query tile, query
// head, batch), writing the output and one f32 log-sum-exp a row for the
// backward (attention_bwd.cu).
//
// Replaces no Pallas kernel: the reference's attention is
// `chunked_attention` (src/repro/models/layers.py:87), a `lax.scan` of a
// `jax.checkpoint`ed tile step (:132-163) that XLA fuses on the TPU. The
// port ran that tile step as ~15 eager ops a tile (score, mask, max, exp,
// sums, rescale, two products) over [G q_chunk, k_chunk] f32 tiles, with
// pad and permute copies of q, k, v and the output around the loop.
//
// Bound: the tensor cores. Causal attention over S tokens is 4 S^2/2 Dh
// FLOPs a head (two products), 8.6e10 a danube layer at 1 x 4,096 (32
// heads, Dh 80): 0.087 ms at 989 TFLOP/s, against 11 MB of q, k, v and o
// (0.003 ms at 3.35 TB/s). Design (FlashAttention-2's forward):
//   * a block of 4 warps takes 64 query rows of one head, 16 a warp; it
//     loads them once (cp.async) and walks the KV tiles of 64 keys its
//     rows can see, the next tile's k and v in flight (two stages, one
//     barrier a tile) while the warps work on this one. Tiles every pair
//     of which is masked (past the causal diagonal, before the window)
//     are never visited;
//   * a GQA group's query heads read the same KV head (blocks of one
//     group are neighbours in the grid, so its tiles come from L2);
//   * per tile: S = q k^T on the tensor cores (bf16 in, f32 out), the mask
//     and the scale, the running max and sum per row (a quad of lanes
//     shares a row), p = exp2(s - m) rounded to v's dtype for P v in
//     registers, o rescaled by exp2(m_old - m). Scores never leave
//     registers;
//   * the blocks with the most tiles (the last query rows under a causal
//     mask) are launched first.
// f32 (the smoke configs and the float32 gates) runs the same dataflow as
// FFMA (attention_common.cuh). ms against this bound: PERF.md §6.

#include "attention_common.cuh"

namespace attn {
namespace {

template <typename T, int DP>
struct Fwd {
  static constexpr int LD = ld<T, DP>();
  static constexpr int KS = DP / 16;     // 16-deep steps of q k^T
  static constexpr int NO = DP / 8;      // 8-column tiles of o
  static constexpr int NS = kBN / 8;     // 8-column tiles of a score row
  // bf16 up to DP 80: 4 blocks an SM (128 registers), 7% faster at
  // danube's layer than ptxas' own 164 (probes/attention_probe.py)
  static constexpr int kMinBlocks =
      std::is_same<T, bf16>::value && DP <= 80 ? 4 : 1;   // fwd

  static constexpr int smem_bytes() {
    return (kBM + 4 * kBN) * LD * (int)sizeof(T) + scratch_bytes<T, kBN / 16>();
  }

  static __device__ __forceinline__ void kernel(const T* __restrict__ q,
                                                const T* __restrict__ k,
                                                const T* __restrict__ v,
                                                T* __restrict__ o,
                                                float* __restrict__ lse,
                                                const Shape& s) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* sQ = reinterpret_cast<T*>(smem);
    T* sK = sQ + kBM * LD;                // 2 stages of [kBN][LD]
    T* sV = sK + 2 * kBN * LD;            // 2 stages
    float* scratch = reinterpret_cast<float*>(sV + 2 * kBN * LD);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int h = blockIdx.x, b = blockIdx.z;
    const int qt = gridDim.y - 1 - blockIdx.y;     // the longest rows first
    const int kh = h / (s.h / s.hkv);
    const int i0 = qt * kBM, i1 = min(i0 + kBM, s.sq) - 1;
    const T* qb = q + b * s.q[0] + h * s.q[2];
    const T* kb = k + b * s.k[0] + kh * s.k[2];
    const T* vb = v + b * s.v[0] + kh * s.v[2];

    zero_pad<T, DP>(sQ, kBM + 4 * kBN, s);        // sQ, sK and sV are one run
    load_rows(sQ, LD, qb, s.q[1], i0, kBM, s.sq, s);
    cp_commit();
    int k0, k1;
    key_range(s, i0, i1, k0, k1);
    const int t0 = k0 / kBN, t1 = (k1 + kBN - 1) / kBN;
    if (t0 < t1) {
      load_rows(sK, LD, kb, s.k[1], t0 * kBN, kBN, s.sk, s);
      load_rows(sV, LD, vb, s.v[1], t0 * kBN, kBN, s.sk, s);
    }
    cp_commit();

    const Row rw[2] = {row_keys(s, i0 + warp * 16 + g),
                       row_keys(s, i0 + warp * 16 + g + 8)};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[NO][4];
    zero_acc(acc);
    const T* sQw = sQ + warp * 16 * LD;
    float* scr = scratch + warp * 16 * scratch_ld<kBN / 16>();

    for (int kt = t0; kt < t1; ++kt) {
      const int st = (kt - t0) & 1;
      cp_wait<0>();               // tile kt is in
      __syncthreads();            // ... for all, and tile kt - 1 is done
      if (kt + 1 < t1) {          // so its stage takes tile kt + 1
        load_rows(sK + (st ^ 1) * kBN * LD, LD, kb, s.k[1], (kt + 1) * kBN,
                  kBN, s.sk, s);
        load_rows(sV + (st ^ 1) * kBN * LD, LD, vb, s.v[1], (kt + 1) * kBN,
                  kBN, s.sk, s);
      }
      cp_commit();

      float sc[NS][4];
      zero_acc(sc);
      mma_ss<NS, KS, false>(sc, sQw, LD, sK + st * kBN * LD, LD, lane);

      // mask and scale (base 2), the tile's row maxima
      float mx[2] = {-INFINITY, -INFINITY};
      if (tile_full(s, i0, i1, kt * kBN)) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            sc[j][x] *= s.scale_log2;
            mx[x >> 1] = fmaxf(mx[x >> 1], sc[j][x]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1;
            const int col = kt * kBN + 8 * j + 2 * t + (x & 1);
            const bool ok = col >= rw[r].lo && col < rw[r].hi;
            const float val = ok ? (rw[r].dead ? 0.f : sc[j][x] * s.scale_log2)
                                 : -INFINITY;
            sc[j][x] = val;
            mx[r] = fmaxf(mx[r], val);
          }
        }
      }
      float alpha[2], mu[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        mu[r] = mn == -INFINITY ? 0.f : mn;     // a row with nothing yet
        alpha[r] = exp2_approx(m[r] - mu[r]);
        m[r] = mn;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float p = exp2_approx(sc[j][x] - mu[x >> 1]);
          sc[j][x] = p;
          ls[x >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
      }
      mma_rs<NO, kBN / 16, true>(acc, sc, sV + st * kBN * LD, LD, scr, lane);
    }

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = rw[r].dead ? s.dead_norm : l[r];
    }
    const int row0 = i0 + warp * 16;
    store_rows<T, NO>(o + b * s.o[0] + h * s.o[2], s.o[1], row0, s.sq, s.dh,
                      acc, den, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + g + 8 * r;
        if (i < s.sq) {
          const float mm = m[r] == -INFINITY ? 0.f : m[r];
          lse[((int64_t)b * s.h + h) * s.sq + i] = mm + log2f(den[r]);
        }
      }
    }
  }
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Fwd<T, DP>::kMinBlocks)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, Shape s) {
  Fwd<T, DP>::kernel(q, k, v, o, lse, s);
}

template <typename T, int DP>
struct LaunchFwd {
  static int run(const void* q, const void* k, const void* v, void* o,
                 void* lse, Shape s, cudaStream_t stream) {
    const int smem = Fwd<T, DP>::smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(s.h, (s.sq + kBM - 1) / kBM, s.b);
    attention_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), s);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace attn

// a: the int64 shape array of attention_common.cuh's `make_shape`. The
// output o is [B, Sq, H, Dh] with the strides a[20..22]; lse [B, H, Sq]
// f32 (base 2). Returns the CUDA error of the launch (0 when it started).
extern "C" int attention_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const int64_t* a,
                                  double scale, double dead_norm,
                                  void* stream) {
  const attn::Shape s = attn::make_shape(a, scale, dead_norm);
  return attn::by_width<attn::LaunchFwd, attn::bf16>(
      s.dh, q, k, v, o, lse, s, static_cast<cudaStream_t>(stream));
}

extern "C" int attention_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* lse, const int64_t* a,
                                 double scale, double dead_norm,
                                 void* stream) {
  const attn::Shape s = attn::make_shape(a, scale, dead_norm);
  return attn::by_width<attn::LaunchFwd, float>(
      s.dh, q, k, v, o, lse, s, static_cast<cudaStream_t>(stream));
}
