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
// (0.003 ms at 3.35 TB/s).
//
// bf16 (every LM prefill and training step), FlashAttention-3's shape:
//   * a block takes 128 query rows of one head: a producer warpgroup, of
//     which one thread issues every load, and two consumer warpgroups of
//     64 rows each. setmaxnreg gives the producer 24 registers and the
//     consumers 240;
//   * the producer loads the q tile once by TMA, then keeps the KV tiles
//     of 128 keys the rows can see in flight in a ring (3 stages, 2 at
//     DP 128), each stage's k and v on their own "full" mbarrier so that
//     S can start before v lands, and the stage reused once both consumers
//     have arrived on its "empty" mbarrier. Tiles every pair of which is
//     masked (past the causal diagonal, before the window) are never
//     visited;
//   * S = q k^T is wgmma with both operands K-major in shared memory; the
//     softmax runs on the accumulator fragments (a quad of lanes shares a
//     row): mask and scale, the running max and sum, p = exp2(s - m) by
//     ex2.approx, o rescaled by exp2(m_old - m); then O += P v is wgmma
//     with P, rounded to v's dtype, from registers and v read MN-major
//     (attention_sm90.cuh: the layouts, Dh 80's two swizzles). One
//     warpgroup's softmax runs while the other's products do;
//   * a GQA group's query heads read the same KV head (blocks of one group
//     are neighbours in the grid, so its tiles come from L2), and the
//     blocks with the most tiles (the last query rows under a causal mask)
//     are launched first.
// f32 (the smoke configs and the float32 gates) keeps FlashAttention-2's
// dataflow as FFMA (attention_common.cuh): a block of 4 warps takes 64
// query rows, 16 a warp, loads them once (cp.async) and walks the KV tiles
// of 64 keys, two stages and one barrier a tile. ms against the bound:
// PERF.md §6.

#include "attention_common.cuh"
#include "attention_sm90.cuh"

namespace attn {
namespace {

template <typename T, int DP>
struct Fwd {
  static constexpr int LD = ld<T, DP>();
  static constexpr int KS = DP / 16;     // 16-deep steps of q k^T
  static constexpr int NO = DP / 8;      // 8-column tiles of o
  static constexpr int NS = kBN / 8;     // 8-column tiles of a score row

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
__global__ void __launch_bounds__(kThreads, 1)
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


// ------------------------------------------------- bf16: wgmma, TMA ring --

template <int DP>
struct FwdTc {
  static constexpr int BM = 128;   // query rows: 2 consumer warpgroups of 64
  static constexpr int BN = 128;   // keys of a KV tile
  static constexpr int kStages = DP > 80 ? 2 : 3;   // fwd: ring stages
  static constexpr int KS = BN / 16;                // k-steps of P v
  struct Smem {
    alignas(1024) bf16 q[BM * DP];
    alignas(1024) bf16 k[kStages][BN * DP];
    alignas(1024) bf16 v[kStages][BN * DP];
    uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
  };
  struct Maps {
    sm90::TileMaps q, k, v;
  };

  // Tile kt's scores sc into p = exp2(s - m') in place, s in base 2
  // (the scale folded in), masked; m' the rows' new running maxima (m
  // updated); alpha = exp2(m - m') rescales what came before, ls gets this
  // thread's part of the rows' sums of p. An unmasked tile takes its
  // maxima on the raw scores (the scale is positive) and forms p as
  // exp2(fma(s, scale, -m')): one rounding, no multiply a score.
  static __device__ __forceinline__ void softmax(float (&sc)[BN / 8][4],
                                                 float (&m)[2],
                                                 float (&alpha)[2],
                                                 float (&ls)[2],
                                                 const Shape& s,
                                                 const Row (&rw)[2],
                                                 bool full, int kt, int t) {
    float mx[2] = {-INFINITY, -INFINITY};
    if (full) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) mx[x >> 1] = fmaxf(mx[x >> 1], sc[j][x]);
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] *= s.scale_log2;
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = x >> 1;
          const int col = kt * BN + 8 * j + 2 * t + (x & 1);
          const bool ok = col >= rw[r].lo && col < rw[r].hi;
          const float val = ok ? (rw[r].dead ? 0.f : sc[j][x] * s.scale_log2)
                               : -INFINITY;
          sc[j][x] = val;
          mx[r] = fmaxf(mx[r], val);
        }
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mu[r] = mn == -INFINITY ? 0.f : mn;     // a row with nothing yet
      alpha[r] = exp2_approx(m[r] - mu[r]);
      m[r] = mn;
      ls[r] = 0.f;
    }
    const float c = full ? s.scale_log2 : 1.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p = exp2_approx(fmaf(sc[j][x], c, -mu[x >> 1]));
        sc[j][x] = p;
        ls[x >> 1] += p;
      }
    }
  }

  // One consumer warpgroup (wg 0 or 1): rows [r0, r0 + 64) of the block.
  // A warpgroup waits for each product before its next step; the other
  // warpgroup's products run under its softmax. Two of FlashAttention-3's
  // schedules lost here (PERF.md §6): tile n's S issued with tile
  // n - 1's P v (pipelining within a warpgroup: no gain, spills at DP
  // 128), and the warpgroups taking turns on named barriers to issue
  // (ping-pong: 5% slower).
  static __device__ __forceinline__ void consume(Smem& sm, bf16* o,
                                                 float* lse, const Shape& s,
                                                 int h, int b, int i0,
                                                 int t0, int t1) {
    using namespace sm90;
    const int tid = threadIdx.x;
    const int wg = tid / 128 - 1, wt = tid % 128;
    const int warp = wt / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = i0 + 64 * wg;
    const int row = r0 + 16 * warp + g;
    const Row rw[2] = {row_keys(s, row), row_keys(s, row + 8)};
    const bool live = r0 < s.sq;            // some row of it below Sq
    const int r1 = min(r0 + 63, s.sq - 1);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[DP / 8][4];
    zero_acc(acc);
    mbar_wait(&sm.q_full, 0);
    for (int kt = t0; kt < t1; ++kt) {
      const int n = kt - t0, st = n % kStages;
      const uint32_t ph = (n / kStages) & 1;
      float sc[BN / 8][4];
      mbar_wait(&sm.k_full[st], ph);
      wgmma_fence();
      mma_rows<BN, DP, BM, BN>(sc, smem_addr(sm.q), 64 * wg, smem_addr(sm.k[st]), 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      float alpha[2], ls[2];
      softmax(sc, m, alpha, ls, s, rw,
              live && tile_full(s, r0, r1, kt * BN, BN), kt, t);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
      }
      uint32_t pa[KS][4];
      pack_a<KS>(pa, sc);
      mbar_wait(&sm.v_full[st], ph);
      wgmma_fence();
      mma_cols<KS, DP, BN>(acc, pa, smem_addr(sm.v[st]));    // O += P v
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      if (wt == 0) mbar_arrive(&sm.empty[st]);
    }

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = rw[r].dead ? s.dead_norm : l[r];
    }
    store_rows<bf16, DP / 8>(o + b * s.o[0] + h * s.o[2], s.o[1],
                             r0 + 16 * warp, s.sq, s.dh, acc, den, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row + 8 * r;
        if (i < s.sq) {
          const float mm = m[r] == -INFINITY ? 0.f : m[r];
          lse[((int64_t)b * s.h + h) * s.sq + i] = mm + log2f(den[r]);
        }
      }
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(384, 1)
    attention_fwd_tc_kernel(const __grid_constant__
                            typename FwdTc<DP>::Maps maps,
                            bf16* __restrict__ o, float* __restrict__ lse,
                            Shape s) {
  using F = FwdTc<DP>;
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
      mbar_init(&sm.empty[st], 2);      // one arrive a consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < 128) {                      // the producer warpgroup
    producer_regs();
    if (tid != 0) return;
    mbar_expect(&sm.q_full, tile_bytes<DP, BM>());
    load_tile<DP, BM>(sm.q, maps.q, i0, h, b, &sm.q_full);
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
    F::consume(sm, o, lse, s, h, b, i0, t0, t1);
  }
}

template <int DP>
struct LaunchFwd<bf16, DP> {
  static int run(const void* q, const void* k, const void* v, void* o,
                 void* lse, Shape s, cudaStream_t stream) {
    using F = FwdTc<DP>;
    typename F::Maps maps;
    cudaError_t err = sm90::bind_device(q);
    if (err == cudaSuccess)
      err = sm90::make_maps<DP>(&maps.q, q, s.dh, s.sq, s.h, s.b, s.q);
    if (err == cudaSuccess)
      err = sm90::make_maps<DP>(&maps.k, k, s.dh, s.sk, s.hkv, s.b, s.k);
    if (err == cudaSuccess)
      err = sm90::make_maps<DP>(&maps.v, v, s.dh, s.sk, s.hkv, s.b, s.v);
    if (err != cudaSuccess) return (int)err;
    const int smem = sm90::smem_of<typename F::Smem>();
    err = cudaFuncSetAttribute(attention_fwd_tc_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(s.h, (s.sq + F::BM - 1) / F::BM, s.b);
    attention_fwd_tc_kernel<DP><<<grid, 384, smem, stream>>>(
        maps, static_cast<bf16*>(o), static_cast<float*>(lse), s);
    return (int)cudaGetLastError();
  }
};

// ------------------------------------------------- the descriptor check --
// One tile through each view the kernels use, for a card test against
// torch.matmul: a [128, Dh], b [128, Dh], v [128, Dh] bf16 contiguous.
// s_out [64, 192] f32: columns 0-127 a[64:128] b^T (K-major both, N 128,
// a's second warpgroup slice), 128-191 a[64:128] b[0:64]^T (N 64); o_out
// [64, 2 DP] f32: columns 0..DP-1 bf16(s[:, :128]) v (v MN-major, a tile
// of 128 rows), DP..2DP-1 bf16(s[:, 128:]) v[0:64] (a tile of 64 rows).
template <int DP>
struct CheckTc {
  struct Smem {
    alignas(1024) bf16 a[128 * DP];
    alignas(1024) bf16 b[128 * DP];
    alignas(1024) bf16 v[128 * DP];
    alignas(1024) bf16 v64[64 * DP];
    uint64_t full;
  };
  struct Maps {
    sm90::TileMaps a, b, v;
  };
};

template <int DP>
__global__ void __launch_bounds__(128, 1)
    attention_check_kernel(const __grid_constant__
                           typename CheckTc<DP>::Maps maps,
                           float* __restrict__ s_out,
                           float* __restrict__ o_out) {
  using namespace sm90;
  using C = CheckTc<DP>;
  extern __shared__ unsigned char smem_raw[];
  typename C::Smem& sm = smem_as<typename C::Smem>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(&sm.full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&sm.full, 3 * tile_bytes<DP, 128>() + tile_bytes<DP, 64>());
    load_tile<DP, 128>(sm.a, maps.a, 0, 0, 0, &sm.full);
    load_tile<DP, 128>(sm.b, maps.b, 0, 0, 0, &sm.full);
    load_tile<DP, 128>(sm.v, maps.v, 0, 0, 0, &sm.full);
    load_tile<DP, 64>(sm.v64, maps.v, 0, 0, 0, &sm.full);
  }
  mbar_wait(&sm.full, 0);
  float s128[16][4], s64[8][4], o128[DP / 8][4], o64[DP / 8][4];
  zero_acc(o128);
  zero_acc(o64);
  wgmma_fence();
  mma_rows<128, DP, 128, 128>(s128, smem_addr(sm.a), 64, smem_addr(sm.b), 0);
  mma_rows<64, DP, 128, 128>(s64, smem_addr(sm.a), 64, smem_addr(sm.b), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s128);
  fence_acc(s64);
  uint32_t p128[8][4], p64[4][4];
  pack_a<8>(p128, s128);
  pack_a<4>(p64, s64);
  wgmma_fence();
  mma_cols<8, DP, 128>(o128, p128, smem_addr(sm.v));
  mma_cols<4, DP, 64>(o64, p64, smem_addr(sm.v64));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o128);
  fence_acc(o64);
  for (int x = 0; x < 4; ++x) {
    const int r = 16 * warp + g + 8 * (x >> 1), e = x & 1;
    for (int j = 0; j < 16; ++j) s_out[r * 192 + 8 * j + 2 * t + e] = s128[j][x];
    for (int j = 0; j < 8; ++j)
      s_out[r * 192 + 128 + 8 * j + 2 * t + e] = s64[j][x];
    for (int j = 0; j < DP / 8; ++j) {
      o_out[r * 2 * DP + 8 * j + 2 * t + e] = o128[j][x];
      o_out[r * 2 * DP + DP + 8 * j + 2 * t + e] = o64[j][x];
    }
  }
}

template <typename, int DP>
struct LaunchCheck {
  static int run(const void* a, const void* b, const void* v, void* s_out,
                 void* o_out, int dh, cudaStream_t stream) {
    using C = CheckTc<DP>;
    typename C::Maps maps;
    const int64_t st[3] = {128 * (int64_t)dh, dh, dh};
    cudaError_t err = sm90::make_maps<DP>(&maps.a, a, dh, 128, 1, 1, st);
    if (err == cudaSuccess)
      err = sm90::make_maps<DP>(&maps.b, b, dh, 128, 1, 1, st);
    if (err == cudaSuccess)
      err = sm90::make_maps<DP>(&maps.v, v, dh, 128, 1, 1, st);
    if (err != cudaSuccess) return (int)err;
    const int smem = sm90::smem_of<typename C::Smem>();
    err = cudaFuncSetAttribute(attention_check_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    attention_check_kernel<DP><<<1, 128, smem, stream>>>(
        maps, static_cast<float*>(s_out), static_cast<float*>(o_out));
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

// The descriptor check (CheckTc above) at the width that holds dh.
extern "C" int attention_check_bf16(const void* a, const void* b,
                                    const void* v, void* s_out, void* o_out,
                                    int dh, void* stream) {
  return attn::by_width<attn::LaunchCheck, attn::bf16>(
      dh, a, b, v, s_out, o_out, dh, static_cast<cudaStream_t>(stream));
}
