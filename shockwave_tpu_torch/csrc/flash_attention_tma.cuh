// What the TMA-fed kernels share (flash_attention_tma.cu: K1-K3 in bf16;
// flash_attention_tma_f32.cu: K1-K3 in f32): the CTA shape's constants,
// mbarriers, TMA loads, register reallocation, the ring's stage
// arithmetic, the online softmax and dQ's terms of one k-tile, K3's p and
// dS^T of one q-tile, and the host's tensor maps.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encode call is reached at run time

#include "flash_attention_common.cuh"

namespace {

constexpr int kTmaThreads = 384;  // a producer warpgroup, two consumer warpgroups
// The 128-byte swizzle repeats every 1 KB, the 64-byte one every 512 bytes.
constexpr int kAlign = 1024;
constexpr int kTmaMaxSmem = 232448;  // the 227 KB an H100 CTA may take

// ---------------------------------------------------------------------------
// mbarriers, TMA and register reallocation.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (the TMA unit).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive, and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Whether the phase of parity `parity` has completed (true at once for
// parity 1 on a barrier that has not completed a phase yet).
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// A (batch, head) pair's coordinates in a tensor map (tensor_map): head
// h = bh % heads of batch b = bh / heads.
struct Head {
  int h, b;
};

__device__ __forceinline__ Head head_of(int bh, int heads) { return {bh % heads, bh / heads}; }

// The box of `map` at (col, row) of (batch, head) pair `hb` into shared
// memory at dst, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, uint64_t* bar,
                                         int col, int row, Head hb) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(hb.h),
      "r"(hb.b)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The stage and the parity of its phase for the i-th tile of a ring of S.
template <int S>
__device__ __forceinline__ int stage_of(int i) {
  return i % S;
}
template <int S>
__device__ __forceinline__ uint32_t phase_of(int i) {
  return (uint32_t)(i / S) & 1u;
}

// Run step(i, masked) over tiles [first, n): the masked instance below
// masked_end and from plain_end on, the plain one between.
template <typename Step>
__device__ __forceinline__ void run_tiles(int masked_end, int plain_end, int n, Step&& step,
                                          int first = 0) {
  for (int i = first; i < masked_end; ++i) step(i, std::true_type{});
  for (int i = max(first, masked_end); i < plain_end; ++i) step(i, std::false_type{});
  for (int i = max(first, plain_end); i < n; ++i) step(i, std::true_type{});
}

// 2^x by the special-function unit (inputs far below -126 give 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The online softmax of one k-tile, in the base-2 domain (scores times
// scale log2(e); the max m and lse follow): sc holds the tile's raw scores
// and leaves with p = 2^(x - m); m and l (this lane's part of its rows'
// normalisers) are updated, corr is the factor O must take. kMasked: the
// causal -1e30, then the tile's key bias, as _fa_kernel orders them (in
// base 2 the constants stay as they are: -1e30, or -2e30 masked twice,
// give p = 0 beside any visible key, as in base e). Plain tiles take the
// row max of the raw scores (scale > 0) and one FFMA per exponent.
template <int kN, bool kMasked>
__device__ __forceinline__ void fwd_softmax(float (&sc)[kN / 8][4], float (&m)[2], float (&l)[2],
                                            float (&corr)[2], const float* cb, int k0,
                                            const int (&row)[2], int t, float scale2,
                                            int causal) {
  float mx[2];
  if constexpr (kMasked) {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      const float2 bias = *reinterpret_cast<const float2*>(cb + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale2;
        if (causal && row[e >> 1] < k0 + 8 * n + 2 * t + (e & 1)) x = kNegInf;
        x += (e & 1) ? bias.y : bias.x;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
  } else {
    mx[0] = mx[1] = minus_infinity();
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    if constexpr (!kMasked) mx[h] = fmaxf(m[h], mx[h] * scale2);
    corr[h] = fast_exp2(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = kMasked ? fast_exp2(sc[n][e] - m[e >> 1])
                              : fast_exp2(fmaf(sc[n][e], scale2, -m[e >> 1]));
      sc[n][e] = p;
      l[e >> 1] += p;
    }
  }
}

// dS = P (dP - delta) scale in dp, from the group's S (sc) and dP (dp)
// against the kN keys of the tile at k0: the lane's rows row[h] (lse2[h]
// in base 2, delta[h]) against key 8n + 2t + (e & 1) of n8 tile n. P =
// exp(S scale - lse) = 2^(S scale log2(e) - lse2). kMasked: the causal
// -1e30, then the tile's key bias cb (0, -1e30, or -inf past Tk), and p = 0
// where that is <= -5e29, as _dq_kernel has it.
template <int kN, bool kMasked>
__device__ __forceinline__ void dq_terms(const float (&sc)[kN / 8][4], float (&dp)[kN / 8][4],
                                         const float* cb, int k0, const int (&row)[2], int t,
                                         const float (&lse2)[2], const float (&delta)[2],
                                         float scale, float scale2, int causal) {
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
    float2 bias;
    if constexpr (kMasked) bias = *reinterpret_cast<const float2*>(cb + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p;
      if constexpr (kMasked) {
        float x = sc[n][e] * scale;
        if (causal && row[h] < k0 + 8 * n + 2 * t + (e & 1)) x = kNegInf;
        x += (e & 1) ? bias.y : bias.x;
        p = x <= 0.5f * kNegInf ? 0.f : fast_exp2(fmaf(x, kLog2e, -lse2[h]));
      } else {
        p = fast_exp2(fmaf(sc[n][e], scale2, -lse2[h]));
      }
      dp[n][e] = p * (dp[n][e] - delta[h]) * scale;
    }
  }
}

// K3's p for the lane's key row h (keys key[h]) against query `query` of
// the q-tile, from its score s: p = exp(s scale - lse) = 2^(s scale log2(e)
// - lse2), lse2 the query's lse in base 2. The reference's guard, p = 0
// where the masked score is <= -5e29, is p = 0 for a key that is masked or
// past Tk (key_live[h] false: its bias is -1e30 or -inf) and, on masked
// tiles, where the query precedes the key (causal -1e30) or is past Tq;
// |s scale| is far below 5e29 elsewhere.
template <bool kMasked>
__device__ __forceinline__ float dkv_p(float s, float lse2, int query, int h, const int (&key)[2],
                                       const bool (&key_live)[2], int tq, float scale2,
                                       int causal) {
  bool live = key_live[h];
  if constexpr (kMasked) live = live && !(causal && query < key[h]) && query < tq;
  return live ? fast_exp2(fmaf(s, scale2, -lse2)) : 0.f;
}

// The lane's P^T in st (kT n8 tiles of queries) from S^T (dkv_p), its keys
// key[h] against the queries of columns 8n + 2t + (e & 1) of the q-tile at
// q0.
template <bool kMasked, int kT>
__device__ __forceinline__ void dkv_probs(float (&st)[kT][4], const float* lse2, int q0, int t,
                                          const int (&key)[2], const bool (&key_live)[2],
                                          int tq, float scale2, int causal) {
#pragma unroll
  for (int n = 0; n < kT; ++n) {
    const float2 lq = *reinterpret_cast<const float2*>(lse2 + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[n][e] = dkv_p<kMasked>(st[n][e], (e & 1) ? lq.y : lq.x, q0 + 8 * n + 2 * t + (e & 1),
                                e >> 1, key, key_live, tq, scale2, causal);
  }
}

// dS^T = P^T (dP^T - delta) scale, in dpt.
template <int kT>
__device__ __forceinline__ void dkv_grads(float (&dpt)[kT][4], const float (&p)[kT][4],
                                          const float* delta_t, int t, float scale) {
#pragma unroll
  for (int n = 0; n < kT; ++n) {
    const float2 dl = *reinterpret_cast<const float2*>(delta_t + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) dpt[n][e] = p[n][e] * (dpt[n][e] - ((e & 1) ? dl.y : dl.x)) * scale;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, reached through the runtime
// (cudaGetDriverEntryPoint) so that the library does not link libcuda;
// null where libcuda lacks it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over the (B, H, T, D) view `x` of T (bf16 or float), dims (d,
// t, h, b) with x's strides in bytes (B = bh / heads): boxes of one swizzle
// row of columns x `rows` rows x one head x one batch, zeros past every
// edge, so a box never reaches into another (batch, head)'s rows. The row
// is 128 bytes (64 bf16, 32 f32) in the 128-byte swizzle, or, where d
// holds less (bf16 at d = 32), d's 64 bytes in the 64-byte swizzle. Encoded
// at every call (a few microseconds on the host) and passed by value, so a
// CUDA graph keeps each launch's own.
template <typename T>
int tensor_map(CUtensorMap* map, const View& x, int bh, int heads, int t, int d, int rows) {
  static_assert(sizeof(T) == 2 || sizeof(T) == 4, "bf16 or f32 tensors");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  constexpr cuuint64_t kBytes = sizeof(T);
  const cuuint32_t row_bytes = d * kBytes < 128 ? (cuuint32_t)(d * kBytes) : 128;
  if (row_bytes != 128 && row_bytes != 64) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)heads,
                              (cuuint64_t)(bh / heads)};
  const cuuint64_t strides[3] = {(cuuint64_t)x.s.t * kBytes, (cuuint64_t)x.s.h * kBytes,
                                 (cuuint64_t)x.s.b * kBytes};
  const cuuint32_t box[4] = {(cuuint32_t)(row_bytes / kBytes), (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map,
                            sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            4, x.data,
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// f(D) as an integral constant for D in 64, 128, 256, and 32 with kWith32
// (the bf16 K1-K3, on 64-byte rows); cudaErrorInvalidValue for any other.
// Only the head dims asked for are instantiated.
template <bool kWith32 = false, typename F>
int by_tma_head_dim(int d, F&& f) {
  if constexpr (kWith32) {
    if (d == 32) return f(std::integral_constant<int, 32>{});
  }
  if (d == 64) return f(std::integral_constant<int, 64>{});
  if (d == 128) return f(std::integral_constant<int, 128>{});
  if (d == 256) return f(std::integral_constant<int, 256>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace
