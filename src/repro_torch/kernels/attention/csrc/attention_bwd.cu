// Attention backward for Hopper (sm_90a): FlashAttention-2's dataflow as
// the port's `_Attention.backward` has it (kernels/attention/ref.py), from
// the forward's output o and base-2 log-sum-exp per row
// (attention_fwd.cu), in three passes:
//
//   attention_dot   D = rowsum(dO * o), one f32 a row (one warp a row);
//   attention_dkdv  one block per (KV tile of 64 keys, KV head, batch): for
//                   each query head of the GQA group and each query tile
//                   that sees the keys, recompute S^T = k q^T, P^T =
//                   exp2(S^T - lse), then dV += P^T dO, dP^T = v dO^T,
//                   dS^T = P^T (dP^T - D) / sqrt(Dh), dK += dS^T q;
//   attention_dq    one block per (query tile of 64 rows, query head,
//                   batch): for each KV tile it sees, recompute S and P,
//                   dP = dO v^T, dS as above, dQ += dS k.
//
// Deterministic: each block owns its output rows (dK and dV of its keys,
// summed over the group's heads and the query tiles in a fixed order; dQ
// of its rows), so nothing is added with atomics and every call gives the
// same bits (chip_smoke's gate I-b replays a training step bitwise).
// The price is the recompute: attention_dq computes S = q k^T and
// dP = dO v^T again, 2 products on top of the 5 the backward needs (the
// two of the recomputed P in attention_dkdv included: S^T, dV, dP^T, dK;
// then S, dP, dQ), so the backward's tensor work is 7/5 of FlashAttention-2
// with an atomic dQ, and k and v are read once a query tile more. The
// reference's backward is XLA's through the `jax.checkpoint`ed tile step of
// `chunked_attention` (src/repro/models/layers.py:87, :132-163); it
// replaces no Pallas kernel.
//
// Rounding, as the plain version: the scores, P and the sums in f32; P
// rounded to v's dtype for dV, dS (after the scale) to q's dtype for dQ
// and dK, dO used in its own dtype; a row with no valid key (a "dead" row,
// attention_common.cuh) weighs every key below Sk by 1 / (n_k k_chunk) in
// dV and gets no dS.
//
// Bound: the tensor cores, 5 products of the causal pairs (0.217 ms a
// danube layer at 1 x 4,096 at 989 TFLOP/s). Tiles as the forward: two
// stages of cp.async and one barrier a tile, 4 warps of 16 rows (keys in
// attention_dkdv, query rows in attention_dq); attention_dkdv steps 64
// query rows at a time, 32 at DP = 128 (registers: dK and dV live in them
// with S^T and dP^T).

#include "attention_common.cuh"

namespace attn {
namespace {

// ------------------------------------------------------------ D = dO.o --

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_dot_kernel(const T* __restrict__ o, const T* __restrict__ g,
                         float* __restrict__ dsum, Shape s) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (int64_t)s.b * s.sq * s.h) return;
  const int h = (int)(row % s.h);
  const int64_t bi = row / s.h;
  const int i = (int)(bi % s.sq), b = (int)(bi / s.sq);
  const T* op = o + b * s.o[0] + (int64_t)i * s.o[1] + h * s.o[2];
  const T* gp = g + b * s.g[0] + (int64_t)i * s.g[1] + h * s.g[2];
  float acc = 0.f;
  for (int d = lane; d < s.dh; d += 32)
    acc = fmaf(to_f32(gp[d]), to_f32(op[d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) dsum[((int64_t)b * s.h + h) * s.sq + i] = acc;
}

// --------------------------------------------------------- dK and dV --

template <typename T, int DP>
struct DkDv {
  static constexpr int LD = ld<T, DP>();
  static constexpr int BQ = DP > 80 ? 32 : 64;   // query rows a step
  static constexpr int KS = DP / 16;
  static constexpr int NO = DP / 8;
  static constexpr int NQ = BQ / 8;
  // ptxas' own registers (up to 254): capped for 3 blocks an SM it ran 5%
  // slower at danube's layer (probes/attention_probe.py)
  static constexpr int kMinBlocks = 1;   // dkdv: blocks an SM, for ptxas

  static constexpr int smem_bytes() {
    return (2 * kBN + 4 * BQ) * LD * (int)sizeof(T) + 4 * BQ * 4 +
           scratch_bytes<T, BQ / 16>();
  }

  // The query tile qt sees some key of [key0, key1].
  static __device__ __forceinline__ bool sees(const Shape& s, int qt,
                                              int key0, int key1) {
    int k0, k1;
    key_range(s, qt * BQ, min(qt * BQ + BQ, s.sq) - 1, k0, k1);
    return k0 <= key1 && k1 > key0;
  }

  // The first item (query head of the group, query tile) from `it` on
  // whose tile sees the keys; n_items when none is left.
  static __device__ __forceinline__ int next(const Shape& s, int it,
                                             int n_items, int n_qt, int key0,
                                             int key1) {
    while (it < n_items && !sees(s, it % n_qt, key0, key1)) ++it;
    return it;
  }

  static __device__ __forceinline__ void kernel(
      const T* __restrict__ q, const T* __restrict__ k,
      const T* __restrict__ v, const T* __restrict__ gout,
      const float* __restrict__ lse, const float* __restrict__ dsum,
      T* __restrict__ dk, T* __restrict__ dv, const Shape& s) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* sK = reinterpret_cast<T*>(smem);
    T* sV = sK + kBN * LD;
    T* sQ = sV + kBN * LD;              // 2 stages of [BQ][LD]
    T* sG = sQ + 2 * BQ * LD;           // dO, 2 stages
    float* sL = reinterpret_cast<float*>(sG + 2 * BQ * LD);   // 2 x BQ
    float* sD = sL + 2 * BQ;                                   // 2 x BQ
    float* scratch = sD + 2 * BQ;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int kh = blockIdx.x, kt = blockIdx.y, b = blockIdx.z;
    const int groups = s.h / s.hkv;
    const int n_qt = (s.sq + BQ - 1) / BQ, n_items = groups * n_qt;
    const int key0 = kt * kBN, key1 = min(key0 + kBN, s.sk) - 1;

    zero_pad<T, DP>(sK, 2 * kBN + 4 * BQ, s);
    load_rows(sK, LD, k + b * s.k[0] + kh * s.k[2], s.k[1], key0, kBN, s.sk,
              s);
    load_rows(sV, LD, v + b * s.v[0] + kh * s.v[2], s.v[1], key0, kBN, s.sk,
              s);
    cp_commit();

    auto load_item = [&](int it, int st) {
      const int h = kh * groups + it / n_qt, i0 = (it % n_qt) * BQ;
      load_rows(sQ + st * BQ * LD, LD, q + b * s.q[0] + h * s.q[2], s.q[1],
                i0, BQ, s.sq, s);
      load_rows(sG + st * BQ * LD, LD, gout + b * s.g[0] + h * s.g[2],
                s.g[1], i0, BQ, s.sq, s);
      const int64_t rb = ((int64_t)b * s.h + h) * s.sq;
      load_floats(sL + st * BQ, lse + rb, i0, BQ, s.sq);
      load_floats(sD + st * BQ, dsum + rb, i0, BQ, s.sq);
    };
    int it = next(s, 0, n_items, n_qt, key0, key1);
    if (it < n_items) load_item(it, 0);
    cp_commit();

    float dK[NO][4], dV[NO][4];
    zero_acc(dK);
    zero_acc(dV);
    const int kr[2] = {key0 + warp * 16 + g, key0 + warp * 16 + g + 8};
    const T* sKw = sK + warp * 16 * LD;
    const T* sVw = sV + warp * 16 * LD;
    float* scr = scratch + warp * 16 * scratch_ld<BQ / 16>();
    int st = 0;
    while (it < n_items) {
      cp_wait<0>();               // item it is in
      __syncthreads();            // ... for all, and the last one is done
      const int nx = next(s, it + 1, n_items, n_qt, key0, key1);
      if (nx < n_items) load_item(nx, st ^ 1);
      cp_commit();
      const int i0 = (it % n_qt) * BQ;
      const T* sQs = sQ + st * BQ * LD;
      const T* sGs = sG + st * BQ * LD;
      const float* sLs = sL + st * BQ;
      const float* sDs = sD + st * BQ;

      // P^T: the keys' rows of exp2(s - lse), masked
      const bool full = tile_full(s, i0, min(i0 + BQ, s.sq) - 1, key0);
      float pt[NQ][4];
      zero_acc(pt);
      mma_ss<NQ, KS, false>(pt, sKw, LD, sQs, LD, lane);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float l2 = sLs[c];
          if (full) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
              pt[j][2 * r + e] =
                  exp2_approx(pt[j][2 * r + e] * s.scale_log2 - l2);
            continue;
          }
          const Row rw = row_keys(s, i0 + c);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool ok = kr[r] >= rw.lo && kr[r] < rw.hi;
            const float x = pt[j][2 * r + e];
            pt[j][2 * r + e] =
                ok ? exp2_approx((rw.dead ? 0.f : x * s.scale_log2) - l2)
                   : 0.f;
          }
        }
      }
      mma_rs<NO, BQ / 16, true>(dV, pt, sGs, LD, scr, lane);   // dV += P^T dO

      // dS^T = P^T (dP^T - D) scale, with dP^T = v dO^T; none for dead rows
      float ds[NQ][4];
      zero_acc(ds);
      mma_ss<NQ, KS, false>(ds, sVw, LD, sGs, LD, lane);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const bool dead = !full && row_keys(s, i0 + c).dead;
          const float dd = sDs[c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p = pt[j][2 * r + e];
            ds[j][2 * r + e] =
                dead ? 0.f : p * (ds[j][2 * r + e] - dd) * s.scale;
          }
        }
      }
      mma_rs<NO, BQ / 16, true>(dK, ds, sQs, LD, scr, lane);   // dK += dS^T q
      st ^= 1;
      it = nx;
    }
    const float one[2] = {1.f, 1.f};
    const int64_t kb = (int64_t)b * s.sk * s.hkv * s.dh + (int64_t)kh * s.dh;
    const int64_t rs = (int64_t)s.hkv * s.dh;
    store_rows<T, NO>(dk + kb, rs, key0 + warp * 16, s.sk, s.dh, dK, one,
                      lane);
    store_rows<T, NO>(dv + kb, rs, key0 + warp * 16, s.sk, s.dh, dV, one,
                      lane);
  }
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, DkDv<T, DP>::kMinBlocks)
    attention_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ gout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum, T* __restrict__ dk,
                          T* __restrict__ dv, Shape s) {
  DkDv<T, DP>::kernel(q, k, v, gout, lse, dsum, dk, dv, s);
}

// ------------------------------------------------------------------ dQ --

template <typename T, int DP>
struct Dq {
  static constexpr int LD = ld<T, DP>();
  static constexpr int KS = DP / 16;
  static constexpr int NO = DP / 8;
  static constexpr int NS = kBN / 8;
  // bf16 up to DP 80: 4 blocks an SM (128 registers), 2% faster at
  // danube's layer than ptxas' own 164 (probes/attention_probe.py)
  static constexpr int kMinBlocks =
      std::is_same<T, bf16>::value && DP <= 80 ? 4 : 1;   // dq

  static constexpr int smem_bytes() {
    return (2 * kBM + 4 * kBN) * LD * (int)sizeof(T) +
           scratch_bytes<T, kBN / 16>();
  }

  static __device__ __forceinline__ void kernel(
      const T* __restrict__ q, const T* __restrict__ k,
      const T* __restrict__ v, const T* __restrict__ gout,
      const float* __restrict__ lse, const float* __restrict__ dsum,
      T* __restrict__ dq, const Shape& s) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* sQ = reinterpret_cast<T*>(smem);
    T* sG = sQ + kBM * LD;
    T* sK = sG + kBM * LD;              // 2 stages of [kBN][LD]
    T* sV = sK + 2 * kBN * LD;          // 2 stages
    float* scratch = reinterpret_cast<float*>(sV + 2 * kBN * LD);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int h = blockIdx.x, b = blockIdx.z;
    const int qt = gridDim.y - 1 - blockIdx.y;     // the longest rows first
    const int kh = h / (s.h / s.hkv);
    const int i0 = qt * kBM, i1 = min(i0 + kBM, s.sq) - 1;
    const T* kb = k + b * s.k[0] + kh * s.k[2];
    const T* vb = v + b * s.v[0] + kh * s.v[2];

    zero_pad<T, DP>(sQ, 2 * kBM + 4 * kBN, s);
    load_rows(sQ, LD, q + b * s.q[0] + h * s.q[2], s.q[1], i0, kBM, s.sq, s);
    load_rows(sG, LD, gout + b * s.g[0] + h * s.g[2], s.g[1], i0, kBM, s.sq,
              s);
    cp_commit();
    int k0, k1;
    key_range(s, i0, i1, k0, k1);
    const int t0 = k0 / kBN, t1 = (k1 + kBN - 1) / kBN;
    if (t0 < t1) {
      load_rows(sK, LD, kb, s.k[1], t0 * kBN, kBN, s.sk, s);
      load_rows(sV, LD, vb, s.v[1], t0 * kBN, kBN, s.sk, s);
    }
    cp_commit();

    const int row0 = i0 + warp * 16;
    const Row rw[2] = {row_keys(s, row0 + g), row_keys(s, row0 + g + 8)};
    float l2[2], dd[2];
    const int64_t rb = ((int64_t)b * s.h + h) * s.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + g + 8 * r;
      l2[r] = i < s.sq ? lse[rb + i] : 0.f;
      dd[r] = i < s.sq ? dsum[rb + i] : 0.f;
    }
    float dQ[NO][4];
    zero_acc(dQ);
    const T* sQw = sQ + warp * 16 * LD;
    const T* sGw = sG + warp * 16 * LD;
    float* scr = scratch + warp * 16 * scratch_ld<kBN / 16>();

    for (int kt = t0; kt < t1; ++kt) {
      const int st = (kt - t0) & 1;
      cp_wait<0>();               // tile kt is in
      __syncthreads();            // ... for all, and tile kt - 1 is done
      if (kt + 1 < t1) {
        load_rows(sK + (st ^ 1) * kBN * LD, LD, kb, s.k[1], (kt + 1) * kBN,
                  kBN, s.sk, s);
        load_rows(sV + (st ^ 1) * kBN * LD, LD, vb, s.v[1], (kt + 1) * kBN,
                  kBN, s.sk, s);
      }
      cp_commit();
      const T* sKs = sK + st * kBN * LD;
      const T* sVs = sV + st * kBN * LD;

      float p[NS][4];
      zero_acc(p);
      mma_ss<NS, KS, false>(p, sQw, LD, sKs, LD, lane);        // S = q k^T
      float ds[NS][4];
      zero_acc(ds);
      mma_ss<NS, KS, false>(ds, sGw, LD, sVs, LD, lane);       // dP = dO v^T
      const bool full = tile_full(s, i0, i1, kt * kBN);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = x >> 1;
          const int col = kt * kBN + 8 * j + 2 * t + (x & 1);
          const bool ok = full || (col >= rw[r].lo && col < rw[r].hi &&
                                   !rw[r].dead);
          const float pv = exp2_approx(p[j][x] * s.scale_log2 - l2[r]);
          ds[j][x] = ok ? pv * (ds[j][x] - dd[r]) * s.scale : 0.f;
        }
      }
      mma_rs<NO, kBN / 16, true>(dQ, ds, sKs, LD, scr, lane);  // dQ += dS k
    }
    const float one[2] = {1.f, 1.f};
    store_rows<T, NO>(dq + (int64_t)b * s.sq * s.h * s.dh + (int64_t)h * s.dh,
                      (int64_t)s.h * s.dh, row0, s.sq, s.dh, dQ, one, lane);
  }
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Dq<T, DP>::kMinBlocks)
    attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ gout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, T* __restrict__ dq,
                        Shape s) {
  Dq<T, DP>::kernel(q, k, v, gout, lse, dsum, dq, s);
}

template <typename T, int DP>
struct LaunchBwd {
  static int run(const void* q, const void* k, const void* v, const void* o,
                 const void* gout, const void* lse, void* dsum, void* dq,
                 void* dk, void* dv, Shape s, cudaStream_t stream) {
    const T* q_ = static_cast<const T*>(q);
    const T* k_ = static_cast<const T*>(k);
    const T* v_ = static_cast<const T*>(v);
    const T* g_ = static_cast<const T*>(gout);
    const float* l_ = static_cast<const float*>(lse);
    float* d_ = static_cast<float*>(dsum);
    const int64_t rows = (int64_t)s.b * s.sq * s.h;
    attention_dot_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps),
                              kThreads, 0, stream>>>(
        static_cast<const T*>(o), g_, d_, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int smem_kv = DkDv<T, DP>::smem_bytes();
    err = cudaFuncSetAttribute(attention_dkdv_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_kv);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_kv(s.hkv, (s.sk + kBN - 1) / kBN, s.b);
    attention_dkdv_kernel<T, DP><<<grid_kv, kThreads, smem_kv, stream>>>(
        q_, k_, v_, g_, l_, d_, static_cast<T*>(dk), static_cast<T*>(dv), s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int smem_q = Dq<T, DP>::smem_bytes();
    err = cudaFuncSetAttribute(attention_dq_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_q(s.h, (s.sq + kBM - 1) / kBM, s.b);
    attention_dq_kernel<T, DP><<<grid_q, kThreads, smem_q, stream>>>(
        q_, k_, v_, g_, l_, d_, static_cast<T*>(dq), s);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace attn

// a: the int64 shape array of attention_common.cuh's `make_shape` (o and
// dO strides at a[20..25]); lse the forward's [B, H, Sq] f32; dsum a
// [B, H, Sq] f32 workspace (D); dq [B, Sq, H, Dh] and dk, dv [B, Sk, Hkv,
// Dh] contiguous, in q's dtype. Returns the first CUDA error of the three
// launches (0 when all started).
extern "C" int attention_bwd_bf16(const void* q, const void* k, const void* v,
                                  const void* o, const void* gout,
                                  const void* lse, void* dsum, void* dq,
                                  void* dk, void* dv, const int64_t* a,
                                  double scale, double dead_norm,
                                  void* stream) {
  const attn::Shape s = attn::make_shape(a, scale, dead_norm);
  return attn::by_width<attn::LaunchBwd, attn::bf16>(
      s.dh, q, k, v, o, gout, lse, dsum, dq, dk, dv, s,
      static_cast<cudaStream_t>(stream));
}

extern "C" int attention_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* o, const void* gout,
                                 const void* lse, void* dsum, void* dq,
                                 void* dk, void* dv, const int64_t* a,
                                 double scale, double dead_norm,
                                 void* stream) {
  const attn::Shape s = attn::make_shape(a, scale, dead_norm);
  return attn::by_width<attn::LaunchBwd, float>(
      s.dh, q, k, v, o, gout, lse, dsum, dq, dk, dv, s,
      static_cast<cudaStream_t>(stream));
}
