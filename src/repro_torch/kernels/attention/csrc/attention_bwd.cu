// Attention backward for Hopper (sm_90a): FlashAttention-2's dataflow as
// the port's `_Attention.backward` has it (kernels/attention/ref.py), from
// the forward's output o and base-2 log-sum-exp per row
// (attention_fwd.cu), in three passes:
//
//   attention_dot   D = rowsum(dO * o), one f32 a row (one warp a row);
//   attention_dkdv  one block per (KV tile, KV head, batch): for each query
//                   head of the GQA group and each query tile that sees the
//                   keys, recompute S^T = k q^T, P^T = exp2(S^T - lse),
//                   then dV += P^T dO, dP^T = v dO^T, dS^T = P^T (dP^T - D)
//                   / sqrt(Dh), dK += dS^T q;
//   attention_dq    one block per (query tile, query head, batch): for each
//                   KV tile it sees, recompute S and P, dP = dO v^T, dS as
//                   above, dQ += dS k.
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
// danube layer at 1 x 4,096 at 989 TFLOP/s).
//
// bf16, FlashAttention-3's shape (attention_sm90.cuh): blocks of a producer
// warpgroup (one thread issues the TMA loads; in attention_dkdv its warp
// also copies the log-sum-exp and D) and two consumer warpgroups, all four
// products of a pass on wgmma, fed by a ring of 2 (dK/dV) or 3 (dQ) stages
// on full / empty mbarriers.
//   * attention_dkdv: a block takes 128 keys, 64 a consumer warpgroup, k
//     and v loaded once; the ring streams q and dO tiles of 64 rows with
//     their log-sum-exp and D. S^T = k q^T and dP^T = v dO^T read both
//     operands K-major from shared memory and run as two groups, so dP^T
//     is on the tensor cores while P^T is formed; dV += P^T dO and dK +=
//     dS^T q take P^T and dS^T from registers and dO, q MN-major. dK and
//     dV stay in registers for the whole walk.
//   * attention_dq: a block takes 128 query rows, 64 a consumer
//     warpgroup, q and dO loaded once, the ring streams k and v tiles of
//     64 keys; S = q k^T and dP = dO v^T K-major, dQ += dS k with k
//     MN-major.
// f32 keeps FlashAttention-2's FFMA tiles: two stages of cp.async and one
// barrier a tile, 4 warps of 16 rows (keys in attention_dkdv, query rows
// in attention_dq); attention_dkdv steps 64 query rows at a time, 32 at
// DP = 128.

#include "attention_common.cuh"
#include "attention_sm90.cuh"

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
__global__ void __launch_bounds__(kThreads, 1)
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
__global__ void __launch_bounds__(kThreads, 1)
    attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ gout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, T* __restrict__ dq,
                        Shape s) {
  Dq<T, DP>::kernel(q, k, v, gout, lse, dsum, dq, s);
}

template <typename T>
cudaError_t launch_dot(const void* o, const void* gout, void* dsum,
                       const Shape& s, cudaStream_t stream) {
  const int64_t rows = (int64_t)s.b * s.sq * s.h;
  attention_dot_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps),
                            kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(gout),
      static_cast<float*>(dsum), s);
  return cudaGetLastError();
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
    cudaError_t err = launch_dot<T>(o, gout, dsum, s, stream);
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


// ------------------------------------------------- bf16: wgmma, TMA ring --

template <int DP>
struct DkDvTc {
  static constexpr int BK = 128;   // keys: 2 consumer warpgroups of 64
  static constexpr int BQ = 64;    // dkdv: query rows a step
  static constexpr int kStages = 3;   // dkdv: ring stages
  static constexpr int KS = BQ / 16;
  struct Smem {
    alignas(1024) bf16 k[BK * DP];
    alignas(1024) bf16 v[BK * DP];
    alignas(1024) bf16 q[kStages][BQ * DP];
    alignas(1024) bf16 g[kStages][BQ * DP];
    float lse[kStages][BQ], d[kStages][BQ];
    uint64_t kv_full, full[kStages], empty[kStages];
  };
  struct Maps {                    // also attention_dq's
    sm90::TileMaps q, k, v, g;
  };

  // The query tile qt (of BQ rows) sees some key of [key0, key1].
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

  // S^T = k q^T and dP^T = v dO^T of the item in stage st into pt and
  // ds: issued, not committed.
  static __device__ __forceinline__ void scores(Smem& sm, int st, int wg,
                                                float (&pt)[BQ / 8][4],
                                                float (&ds)[BQ / 8][4]) {
    using namespace sm90;
    mma_rows<BQ, DP, BK, BQ>(pt, smem_addr(sm.k), 64 * wg, smem_addr(sm.q[st]), 0);
    mma_rows<BQ, DP, BK, BQ>(ds, smem_addr(sm.v), 64 * wg, smem_addr(sm.g[st]), 0);
  }

  // Item n (query rows from i0) once its S^T and dP^T are in: P^T and
  // dS^T in registers, packed into the bf16 fragments pa and da of dV +=
  // P^T dO and dK += dS^T q.
  static __device__ __forceinline__ void step(
      Smem& sm, const Shape& s, int n, int i0, int c0, const int (&kr)[2],
      int t, float (&pt)[BQ / 8][4], float (&ds)[BQ / 8][4],
      uint32_t (&pa)[KS][4], uint32_t (&da)[KS][4]) {
    using namespace sm90;
    const int st = n % kStages;
    const float* sL = sm.lse[st];
    const float* sD = sm.d[st];

    // P^T: the keys' rows of exp2(s - lse), masked; dS^T = P^T (dP^T - D)
    // scale, none for dead rows
    const bool full =
        c0 < s.sk && tile_full(s, i0, min(i0 + BQ, s.sq) - 1, c0, 64);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float l2 = sL[c], dd = sD[c];
        if (full) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p = exp2_approx(pt[j][2 * r + e] * s.scale_log2 - l2);
            pt[j][2 * r + e] = p;
            ds[j][2 * r + e] = p * (ds[j][2 * r + e] - dd) * s.scale;
          }
          continue;
        }
        const Row rw = row_keys(s, i0 + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok = kr[r] >= rw.lo && kr[r] < rw.hi;
          const float x = pt[j][2 * r + e];
          const float p =
              ok ? exp2_approx((rw.dead ? 0.f : x * s.scale_log2) - l2) : 0.f;
          pt[j][2 * r + e] = p;
          ds[j][2 * r + e] =
              rw.dead ? 0.f : p * (ds[j][2 * r + e] - dd) * s.scale;
        }
      }
    }
    pack_a<KS>(pa, pt);
    pack_a<KS>(da, ds);
  }

  // One consumer warpgroup: keys [c0, c0 + 64) of the block. Each item's
  // dV and dK are issued with the next item's S^T and dP^T right behind
  // them, one group, waited for before the loop goes round, so the tensor
  // cores run the four products of two items back to back while the other
  // warpgroup forms its P^T. ptxas serializes wgmma issued under a branch,
  // and wgmma whose accumulators are still in flight where the loop goes
  // round: the last item is peeled off the loop, and no product is in
  // flight across its back edge. (Taking turns with the other warpgroup
  // to issue, FlashAttention-3's ping-pong, gained nothing: PERF.md §6.)
  static __device__ __forceinline__ void consume(Smem& sm, bf16* dk,
                                                 bf16* dv, const Shape& s,
                                                 int kh, int b, int key0,
                                                 int key1) {
    using namespace sm90;
    const int tid = threadIdx.x;
    const int wg = tid / 128 - 1, wt = tid % 128;
    const int warp = wt / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int groups = s.h / s.hkv;
    const int n_qt = (s.sq + BQ - 1) / BQ, n_items = groups * n_qt;
    const int c0 = key0 + 64 * wg;
    const int kr[2] = {c0 + 16 * warp + g, c0 + 16 * warp + g + 8};
    const float one[2] = {1.f, 1.f};
    const int64_t kb = (int64_t)b * s.sk * s.hkv * s.dh + (int64_t)kh * s.dh;
    const int64_t rs = (int64_t)s.hkv * s.dh;
    float dK[DP / 8][4], dV[DP / 8][4];
    zero_acc(dK);
    zero_acc(dV);
    // k and v are waited for even when no query tile sees these keys
    // (dK = dV = 0): a block must not end with its loads in flight
    mbar_wait(&sm.kv_full, 0);
    int count = 0;
    for (int it = next(s, 0, n_items, n_qt, key0, key1); it < n_items;
         it = next(s, it + 1, n_items, n_qt, key0, key1))
      ++count;
    if (count == 0) {           // an early exit, not a branch around wgmma
      store_rows<bf16, DP / 8>(dk + kb, rs, c0 + 16 * warp, s.sk, s.dh, dK,
                               one, lane);
      store_rows<bf16, DP / 8>(dv + kb, rs, c0 + 16 * warp, s.sk, s.dh, dV,
                               one, lane);
      return;
    }
    float pt[BQ / 8][4], ds[BQ / 8][4];
    uint32_t pa[KS][4], da[KS][4];
    int it = next(s, 0, n_items, n_qt, key0, key1);
    mbar_wait(&sm.full[0], 0);
    wgmma_fence();
    scores(sm, 0, wg, pt, ds);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(pt);
    fence_acc(ds);
    for (int n = 0; n < count - 1; ++n) {
      const int st = n % kStages;
      const int i0 = (it % n_qt) * BQ;
      it = next(s, it + 1, n_items, n_qt, key0, key1);
      mbar_wait(&sm.full[(n + 1) % kStages], ((n + 1) / kStages) & 1);
      step(sm, s, n, i0, c0, kr, t, pt, ds, pa, da);
      wgmma_fence();
      mma_cols<KS, DP, BQ>(dV, pa, smem_addr(sm.g[st]));   // dV += P^T dO
      mma_cols<KS, DP, BQ>(dK, da, smem_addr(sm.q[st]));   // dK += dS^T q
      scores(sm, (n + 1) % kStages, wg, pt, ds);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(pt);
      fence_acc(ds);
      fence_acc(dK);
      fence_acc(dV);
      if (wt == 0) mbar_arrive(&sm.empty[st]);
    }
    {
      const int st = (count - 1) % kStages;
      step(sm, s, count - 1, (it % n_qt) * BQ, c0, kr, t, pt, ds, pa, da);
      wgmma_fence();
      mma_cols<KS, DP, BQ>(dV, pa, smem_addr(sm.g[st]));
      mma_cols<KS, DP, BQ>(dK, da, smem_addr(sm.q[st]));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(dK);
    fence_acc(dV);
    if (wt == 0) mbar_arrive(&sm.empty[(count - 1) % kStages]);
    store_rows<bf16, DP / 8>(dk + kb, rs, c0 + 16 * warp, s.sk, s.dh, dK, one,
                             lane);
    store_rows<bf16, DP / 8>(dv + kb, rs, c0 + 16 * warp, s.sk, s.dh, dV, one,
                             lane);
  }
};

template <int DP>
__global__ void __launch_bounds__(384, 1)
    attention_dkdv_tc_kernel(const __grid_constant__
                             typename DkDvTc<DP>::Maps maps,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             Shape s) {
  using F = DkDvTc<DP>;
  using namespace sm90;
  constexpr int BK = F::BK, BQ = F::BQ, S = F::kStages;
  extern __shared__ unsigned char smem_raw[];
  typename F::Smem& sm = smem_as<typename F::Smem>(smem_raw);
  const int tid = threadIdx.x;
  const int kh = blockIdx.x, b = blockIdx.z;
  const int key0 = blockIdx.y * BK, key1 = min(key0 + BK, s.sk) - 1;
  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(&sm.full[st], 32);      // the producer warp's lanes
      mbar_init(&sm.empty[st], 2);      // one arrive a consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < 128) {                      // the producer warpgroup
    producer_regs();
    if (tid >= 32) return;
    const int lane = tid;
    const int groups = s.h / s.hkv;
    const int n_qt = (s.sq + BQ - 1) / BQ, n_items = groups * n_qt;
    if (lane == 0) {
      mbar_expect(&sm.kv_full, 2 * tile_bytes<DP, BK>());
      load_tile<DP, BK>(sm.k, maps.k, key0, kh, b, &sm.kv_full);
      load_tile<DP, BK>(sm.v, maps.v, key0, kh, b, &sm.kv_full);
    }
    int n = 0;
    for (int it = F::next(s, 0, n_items, n_qt, key0, key1); it < n_items;
         it = F::next(s, it + 1, n_items, n_qt, key0, key1), ++n) {
      const int st = n % S;
      mbar_wait(&sm.empty[st], ((n / S) & 1) ^ 1);
      const int h = kh * groups + it / n_qt, i0 = (it % n_qt) * BQ;
      const int64_t rb = ((int64_t)b * s.h + h) * s.sq;
      for (int r = lane; r < BQ; r += 32) {   // rows past Sq: 0
        const bool ok = i0 + r < s.sq;
        sm.lse[st][r] = ok ? lse[rb + i0 + r] : 0.f;
        sm.d[st][r] = ok ? dsum[rb + i0 + r] : 0.f;
      }
      if (lane == 0) {                  // after its own stores
        mbar_expect(&sm.full[st], 2 * tile_bytes<DP, BQ>());
        load_tile<DP, BQ>(sm.q[st], maps.q, i0, h, b, &sm.full[st]);
        load_tile<DP, BQ>(sm.g[st], maps.g, i0, h, b, &sm.full[st]);
      } else {
        mbar_arrive(&sm.full[st]);
      }
    }
  } else {
    consumer_regs();
    F::consume(sm, dk, dv, s, kh, b, key0, key1);
  }
}

template <int DP>
struct DqTc {
  static constexpr int BM = 128;   // query rows: 2 consumer warpgroups of 64
  static constexpr int BN = 64;    // keys of a KV tile
  static constexpr int kStages = 3;   // dq: ring stages
  static constexpr int KS = BN / 16;
  struct Smem {
    alignas(1024) bf16 q[BM * DP];
    alignas(1024) bf16 g[BM * DP];
    alignas(1024) bf16 k[kStages][BN * DP];
    alignas(1024) bf16 v[kStages][BN * DP];
    uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
  };

  // Wait for the n-th KV tile's k and v.
  static __device__ __forceinline__ void arrived(Smem& sm, int n) {
    const int st = n % kStages;
    const uint32_t ph = (n / kStages) & 1;
    sm90::mbar_wait(&sm.k_full[st], ph);
    sm90::mbar_wait(&sm.v_full[st], ph);
  }

  // S = q k^T and dP = dO v^T of the n-th KV tile into p and ds: issued,
  // not committed.
  static __device__ __forceinline__ void scores(Smem& sm, int n, int wg,
                                                float (&p)[BN / 8][4],
                                                float (&ds)[BN / 8][4]) {
    using namespace sm90;
    const int st = n % kStages;
    mma_rows<BN, DP, BM, BN>(p, smem_addr(sm.q), 64 * wg, smem_addr(sm.k[st]), 0);
    mma_rows<BN, DP, BM, BN>(ds, smem_addr(sm.g), 64 * wg, smem_addr(sm.v[st]), 0);
  }

  // KV tile kt once its S and dP are in: dS in registers, packed into
  // the bf16 fragments da of dQ += dS k.
  static __device__ __forceinline__ void step(
      const Shape& s, int kt, bool live, int r0, int r1, const Row (&rw)[2],
      const float (&l2)[2], const float (&dd)[2], int t,
      float (&p)[BN / 8][4], float (&ds)[BN / 8][4], uint32_t (&da)[KS][4]) {
    using namespace sm90;
    const bool full = live && tile_full(s, r0, r1, kt * BN, BN);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = x >> 1;
        const int col = kt * BN + 8 * j + 2 * t + (x & 1);
        const bool ok = full || (col >= rw[r].lo && col < rw[r].hi &&
                                 !rw[r].dead);
        const float pv = exp2_approx(p[j][x] * s.scale_log2 - l2[r]);
        ds[j][x] = ok ? pv * (ds[j][x] - dd[r]) * s.scale : 0.f;
      }
    }
    pack_a<KS>(da, ds);
  }

  // One consumer warpgroup: rows [r0, r0 + 64) of the block. Each tile's
  // dQ += dS k is issued with the next tile's S and dP behind it, one
  // group, waited for before the loop goes round; the last tile is peeled
  // off the loop (as in DkDvTc::consume).
  static __device__ __forceinline__ void consume(Smem& sm,
                                                 const float* lse,
                                                 const float* dsum, bf16* dq,
                                                 const Shape& s, int h, int b,
                                                 int i0, int t0, int t1) {
    using namespace sm90;
    const int tid = threadIdx.x;
    const int wg = tid / 128 - 1, wt = tid % 128;
    const int warp = wt / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = i0 + 64 * wg;
    const int row = r0 + 16 * warp + g;
    const Row rw[2] = {row_keys(s, row), row_keys(s, row + 8)};
    const bool live = r0 < s.sq;
    const int r1 = min(r0 + 63, s.sq - 1);
    float l2[2], dd[2];
    const int64_t rb = ((int64_t)b * s.h + h) * s.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row + 8 * r;
      l2[r] = i < s.sq ? lse[rb + i] : 0.f;
      dd[r] = i < s.sq ? dsum[rb + i] : 0.f;
    }
    float dQ[DP / 8][4];
    zero_acc(dQ);
    float p[BN / 8][4], ds[BN / 8][4];
    uint32_t da[KS][4];
    mbar_wait(&sm.q_full, 0);
    arrived(sm, 0);
    wgmma_fence();
    scores(sm, 0, wg, p, ds);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(p);
    fence_acc(ds);
    for (int kt = t0; kt < t1 - 1; ++kt) {
      const int n = kt - t0;
      arrived(sm, n + 1);
      step(s, kt, live, r0, r1, rw, l2, dd, t, p, ds, da);
      wgmma_fence();
      mma_cols<KS, DP, BN>(dQ, da, smem_addr(sm.k[n % kStages]));   // dQ += dS k
      scores(sm, n + 1, wg, p, ds);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(p);
      fence_acc(ds);
      fence_acc(dQ);
      if (wt == 0) mbar_arrive(&sm.empty[n % kStages]);
    }
    step(s, t1 - 1, live, r0, r1, rw, l2, dd, t, p, ds, da);
    wgmma_fence();
    mma_cols<KS, DP, BN>(dQ, da, smem_addr(sm.k[(t1 - 1 - t0) % kStages]));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dQ);
    if (wt == 0) mbar_arrive(&sm.empty[(t1 - 1 - t0) % kStages]);
    const float one[2] = {1.f, 1.f};
    store_rows<bf16, DP / 8>(
        dq + (int64_t)b * s.sq * s.h * s.dh + (int64_t)h * s.dh,
        (int64_t)s.h * s.dh, r0 + 16 * warp, s.sq, s.dh, dQ, one, lane);
  }
};

template <int DP>
__global__ void __launch_bounds__(384, 1)
    attention_dq_tc_kernel(const __grid_constant__
                           typename DkDvTc<DP>::Maps maps,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           bf16* __restrict__ dq, Shape s) {
  using F = DqTc<DP>;
  using namespace sm90;
  constexpr int BM = F::BM, BN = F::BN, S = F::kStages;
  extern __shared__ unsigned char smem_raw[];
  typename F::Smem& sm = smem_as<typename F::Smem>(smem_raw);
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;     // the longest rows first
  const int kh = h / (s.h / s.hkv);
  const int i0 = qt * BM, i1 = min(i0 + BM, s.sq) - 1;
  int k0, k1;
  key_range(s, i0, i1, k0, k1);
  const int t0 = k0 / BN, t1 = (k1 + BN - 1) / BN;
  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.empty[st], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < 128) {
    producer_regs();
    if (tid != 0) return;
    mbar_expect(&sm.q_full, 2 * tile_bytes<DP, BM>());
    load_tile<DP, BM>(sm.q, maps.q, i0, h, b, &sm.q_full);
    load_tile<DP, BM>(sm.g, maps.g, i0, h, b, &sm.q_full);
    for (int kt = t0; kt < t1; ++kt) {
      const int n = kt - t0, st = n % S;
      mbar_wait(&sm.empty[st], ((n / S) & 1) ^ 1);
      mbar_expect(&sm.k_full[st], tile_bytes<DP, BN>());
      load_tile<DP, BN>(sm.k[st], maps.k, kt * BN, kh, b, &sm.k_full[st]);
      mbar_expect(&sm.v_full[st], tile_bytes<DP, BN>());
      load_tile<DP, BN>(sm.v[st], maps.v, kt * BN, kh, b, &sm.v_full[st]);
    }
  } else {
    consumer_regs();
    F::consume(sm, lse, dsum, dq, s, h, b, i0, t0, t1);
  }
}

template <int DP>
struct LaunchBwd<bf16, DP> {
  static int run(const void* q, const void* k, const void* v, const void* o,
                 const void* gout, const void* lse, void* dsum, void* dq,
                 void* dk, void* dv, Shape s, cudaStream_t stream) {
    typename DkDvTc<DP>::Maps maps;
    cudaError_t err = sm90::bind_device(q);
    if (err == cudaSuccess)
      err = sm90::make_maps<DP>(&maps.q, q, s.dh, s.sq, s.h, s.b, s.q);
    if (err == cudaSuccess)
      err = sm90::make_maps<DP>(&maps.k, k, s.dh, s.sk, s.hkv, s.b, s.k);
    if (err == cudaSuccess)
      err = sm90::make_maps<DP>(&maps.v, v, s.dh, s.sk, s.hkv, s.b, s.v);
    if (err == cudaSuccess)
      err = sm90::make_maps<DP>(&maps.g, gout, s.dh, s.sq, s.h, s.b, s.g);
    if (err == cudaSuccess) err = launch_dot<bf16>(o, gout, dsum, s, stream);
    if (err != cudaSuccess) return (int)err;
    const float* l_ = static_cast<const float*>(lse);
    const float* d_ = static_cast<const float*>(dsum);

    const int smem_kv = sm90::smem_of<typename DkDvTc<DP>::Smem>();
    err = cudaFuncSetAttribute(attention_dkdv_tc_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_kv);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_kv(s.hkv, (s.sk + DkDvTc<DP>::BK - 1) / DkDvTc<DP>::BK,
                       s.b);
    attention_dkdv_tc_kernel<DP><<<grid_kv, 384, smem_kv, stream>>>(
        maps, l_, d_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int smem_q = sm90::smem_of<typename DqTc<DP>::Smem>();
    err = cudaFuncSetAttribute(attention_dq_tc_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_q(s.h, (s.sq + DqTc<DP>::BM - 1) / DqTc<DP>::BM, s.b);
    attention_dq_tc_kernel<DP><<<grid_q, 384, smem_q, stream>>>(
        maps, l_, d_, static_cast<bf16*>(dq), s);
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
