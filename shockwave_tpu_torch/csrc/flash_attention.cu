// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// These replace the three Pallas TPU kernels of
// shockwave_tpu/ops/flash_attention.py (_fa_kernel, _dq_kernel,
// _dkv_kernel). They take (BH, T, D) bf16 tensors, D in {32, 64}, a
// (B, Tk) uint8 key mask (1 = attend, nullptr = all attend, row = bh /
// heads) and keep the reference's masking constants: causal entries are
// set to -1e30, masked keys get a -1e30 additive bias after that, and
// the backward zeroes p wherever s <= -5e29.
//
// Layout of every kernel: one CTA of four warps owns a 64-row tile of
// one (batch, head); each warp owns 16 of those rows. The sequential
// TPU grid axis becomes a loop over 64-row tiles of the other sequence
// inside the CTA. Products run on the tensor cores through WMMA
// (16x16x16, bf16 operands, f32 accumulation); softmax and masking run
// in f32 on the CUDA cores, one row at a time per warp, two columns per
// lane. Nothing is written to device memory but the outputs.
//
// This is the simple first version: no TMA, no wgmma, no double
// buffering of the streamed tiles, scalar bf16 stores. Tile loads are
// 16-byte vector loads, and rows past the sequence end are zero-filled
// and masked inside the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;          // rows of a CTA's own tile and of each streamed tile
constexpr int kWarpRows = 16;      // rows a warp owns
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float minus_infinity() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + kTile) of a (rows, D) bf16 matrix into a
// kTile x D shared tile with 16-byte loads; rows past `rows` become zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D)[c];
    reinterpret_cast<uint4*>(dst + r * D)[c] = val;
  }
}

// Additive key bias of the reference's _kbias for keys [k0, k0 + kTile):
// 0 (attend), -1e30 (masked), and -inf past the sequence end, which no
// reference tile has.
__device__ __forceinline__ void load_key_bias(float* dst, const uint8_t* mask_row, int k0,
                                              int tk) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int key = k0 + j;
    float b = 0.f;
    if (key >= tk) b = minus_infinity();
    else if (mask_row != nullptr && mask_row[key] == 0) b = kNegInf;
    dst[j] = b;
  }
}

// C (16 x kTile, f32, row stride kTile) = A (16 x D) . B^T where B is a
// (kTile x D) row-major tile: the score products Q.K^T, dO.V^T, K.Q^T
// and V.dO^T.
template <int D>
__device__ __forceinline__ void warp_a_bt(float* c_out, const bf16* a, const bf16* b) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc[kTile / 16];
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) wmma::fill_fragment(fc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::load_matrix_sync(fa, a + kk, D);
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      wmma::load_matrix_sync(fb, b + n * 16 * D + kk, D);
      wmma::mma_sync(fc[n], fa, fb, fc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n)
    wmma::store_matrix_sync(c_out + n * 16, fc[n], kTile, wmma::mem_row_major);
}

// acc[n] (16 x 16 column block n of a 16 x D f32 sum) += A (16 x kTile,
// bf16, row stride kTile) . B (kTile x D row-major tile).
template <int D>
__device__ __forceinline__ void warp_a_b_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16], const bf16* a,
    const bf16* b) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    wmma::load_matrix_sync(fa, a + kk, kTile);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::load_matrix_sync(fb, b + kk * D + n * 16, D);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Write a warp's 16 x D f32 sum as bf16 rows [row0, row0 + 16) of a
// (rows, D) matrix, staging through `stage` (16 x D f32 of shared memory).
template <int D>
__device__ __forceinline__ void warp_store_rows(
    bf16* dst, float* stage, wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    int row0, int rows, int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], D, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < kWarpRows; ++r) {
    if (row0 + r >= rows) break;
    for (int c = lane; c < D; c += 32)
      dst[(size_t)(row0 + r) * D + c] = __float2bfloat16(stage[r * D + c]);
  }
}

// ---------------------------------------------------------------------------
// K1, forward. Replaces _fa_kernel (shockwave_tpu/ops/flash_attention.py).
// Grid (BH, q-tiles); the CTA walks the k-tiles up to the causal diagonal
// with an online softmax: running max m and normaliser l per row in
// registers (replicated across the warp's lanes), the f32 output sum O in
// shared memory, rescaled by exp(m_old - m_new) before each P.V product.
// Bound on this card: at the main path's T = 32 each CTA does a few
// hundred kFLOP and the launch moves ~8.5 MB, so it is bandwidth- and
// latency-bound; at T = 2048 causal it is compute-bound (~17 GFLOP per
// call). The design reads Q once and each K/V tile once per CTA, keeps
// S and P on chip, and stops the k loop at the diagonal.
// ---------------------------------------------------------------------------
template <int D>
struct FwdSmem {
  static constexpr size_t kBytes = 3 * kTile * D * sizeof(bf16)          // Q, K, V
                                   + kTile * kTile * sizeof(float)       // S
                                   + kTile * kTile * sizeof(bf16)        // P
                                   + kTile * D * sizeof(float)           // O
                                   + kTile * sizeof(float);              // key bias
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ out, float* __restrict__ lse, int heads, int tq, int tk,
                     float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * D;
  bf16* sV = sK + kTile * D;
  float* sS = reinterpret_cast<float*>(sV + kTile * D);
  bf16* sP = reinterpret_cast<bf16*>(sS + kTile * kTile);
  float* sO = reinterpret_cast<float*>(sP + kTile * kTile);
  float* sBias = sO + kTile * D;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + (size_t)bh * tq * D;
  const bf16* kb = k + (size_t)bh * tk * D;
  const bf16* vb = v + (size_t)bh * tk * D;
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;

  load_tile<D>(sQ, qb, q0, tq);
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) sO[i] = 0.f;

  float* Sw = sS + warp * kWarpRows * kTile;
  bf16* Pw = sP + warp * kWarpRows * kTile;
  float* Ow = sO + warp * kWarpRows * D;
  const int wrow0 = q0 + warp * kWarpRows;

  float m[kWarpRows], l[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  int nk = (tk + kTile - 1) / kTile;
  if (causal) nk = min(nk, (int)blockIdx.y + 1);  // k-tiles past the diagonal see nothing
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile<D>(sK, kb, k0, tk);
    load_tile<D>(sV, vb, k0, tk);
    load_key_bias(sBias, mask_row, k0, tk);
    __syncthreads();

    warp_a_bt<D>(Sw, sQ + warp * kWarpRows * D, sK);
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        float x = Sw[r * kTile + j] * scale;
        if (causal && wrow0 + r < k0 + j) x = kNegInf;
        s[h] = x + sBias[j];
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
      Pw[r * kTile + lane] = __float2bfloat16(p0);
      Pw[r * kTile + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < D; c += 32) Ow[r * D + c] *= corr;
    }
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::load_matrix_sync(acc[n], Ow + n * 16, D, wmma::mem_row_major);
    warp_a_b_acc<D>(acc, Pw, sV);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(Ow + n * 16, acc[n], D, wmma::mem_row_major);
    __syncwarp();
  }

  bf16* ob = out + (size_t)bh * tq * D;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int row = wrow0 + r;
    if (row < tq) {
      const float lc = fmaxf(l[r], 1e-30f);
      for (int c = lane; c < D; c += 32) ob[(size_t)row * D + c] = __float2bfloat16(Ow[r * D + c] / lc);
      if (lane == 0) lse[(size_t)bh * tq + row] = m[r] + logf(lc);
    }
  }
}

// ---------------------------------------------------------------------------
// K2, dQ. Replaces _dq_kernel (shockwave_tpu/ops/flash_attention.py).
// Grid (BH, q-tiles); the CTA walks the k-tiles up to the diagonal,
// recomputes S = Q.K^T and dP = dO.V^T per tile, forms
// dS = p (dP - delta) scale in bf16 with p = exp(s - lse) (0 where
// s <= -5e29), and accumulates dQ += dS.K in WMMA accumulators that stay
// in registers for the whole loop. Bound on this card: bandwidth and
// launch latency at T = 32 (~10.6 MB per launch), compute at the bench
// shape. No atomics: dK/dV is the separate K3 pass.
// ---------------------------------------------------------------------------
template <int D>
struct DqSmem {
  static constexpr size_t kBytes = 4 * kTile * D * sizeof(bf16)          // Q, dO, K, V
                                   + 2 * kTile * kTile * sizeof(float)   // S, dP
                                   + kTile * kTile * sizeof(bf16)        // dS
                                   + 3 * kTile * sizeof(float);          // key bias, lse, delta
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, bf16* __restrict__ dq, int heads, int tq,
                    int tk, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + kTile * D;
  bf16* sK = sG + kTile * D;
  bf16* sV = sK + kTile * D;
  float* sS = reinterpret_cast<float*>(sV + kTile * D);
  float* sDP = sS + kTile * kTile;
  bf16* sDS = reinterpret_cast<bf16*>(sDP + kTile * kTile);
  float* sBias = reinterpret_cast<float*>(sDS + kTile * kTile);
  float* sLse = sBias + kTile;
  float* sDelta = sLse + kTile;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kb = k + (size_t)bh * tk * D;
  const bf16* vb = v + (size_t)bh * tk * D;
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;

  load_tile<D>(sQ, q + (size_t)bh * tq * D, q0, tq);
  load_tile<D>(sG, g + (size_t)bh * tq * D, q0, tq);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = q0 + i < tq;
    sLse[i] = in ? lse[(size_t)bh * tq + q0 + i] : 0.f;
    sDelta[i] = in ? delta[(size_t)bh * tq + q0 + i] : 0.f;
  }

  float* Sw = sS + warp * kWarpRows * kTile;
  float* DPw = sDP + warp * kWarpRows * kTile;
  bf16* DSw = sDS + warp * kWarpRows * kTile;
  const int wrow0 = q0 + warp * kWarpRows;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  int nk = (tk + kTile - 1) / kTile;
  if (causal) nk = min(nk, (int)blockIdx.y + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(sK, kb, k0, tk);
    load_tile<D>(sV, vb, k0, tk);
    load_key_bias(sBias, mask_row, k0, tk);
    __syncthreads();

    warp_a_bt<D>(Sw, sQ + warp * kWarpRows * D, sK);
    warp_a_bt<D>(DPw, sG + warp * kWarpRows * D, sV);
    __syncwarp();

#pragma unroll 4
    for (int r = 0; r < kWarpRows; ++r) {
      const float row_lse = sLse[warp * kWarpRows + r];
      const float row_delta = sDelta[warp * kWarpRows + r];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        float x = Sw[r * kTile + j] * scale;
        if (causal && wrow0 + r < k0 + j) x = kNegInf;
        x += sBias[j];
        const float p = x <= kNegInf * 0.5f ? 0.f : expf(x - row_lse);
        const float ds = p * (DPw[r * kTile + j] - row_delta) * scale;
        DSw[r * kTile + j] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    warp_a_b_acc<D>(acc, DSw, sK);
  }
  __syncwarp();
  warp_store_rows<D>(dq + (size_t)bh * tq * D, Sw, acc, wrow0, tq, lane);
}

// ---------------------------------------------------------------------------
// K3, dK and dV. Replaces _dkv_kernel (shockwave_tpu/ops/flash_attention.py).
// Grid (BH, k-tiles); the CTA holds its K and V tiles and walks the
// q-tiles from the diagonal on, computing the transposed products
// S^T = K.Q^T and dP^T = V.dO^T so that each warp owns 16 keys. It forms
// P^T (bf16) and dS^T (bf16) with the same guard as K2 and accumulates
// dV += P^T.dO and dK += dS^T.Q in registers. Bound on this card:
// bandwidth and launch latency at T = 32 (~12.7 MB per launch), compute
// at the bench shape.
// ---------------------------------------------------------------------------
template <int D>
struct DkvSmem {
  static constexpr size_t kBytes = 4 * kTile * D * sizeof(bf16)          // K, V, Q, dO
                                   + 2 * kTile * kTile * sizeof(float)   // S^T, dP^T
                                   + 2 * kTile * kTile * sizeof(bf16)    // P^T, dS^T
                                   + 3 * kTile * sizeof(float);          // key bias, lse, delta
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const uint8_t* __restrict__ mask, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int heads, int tq, int tk, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * D;
  bf16* sQ = sV + kTile * D;
  bf16* sG = sQ + kTile * D;
  float* sS = reinterpret_cast<float*>(sG + kTile * D);
  float* sDP = sS + kTile * kTile;
  bf16* sP = reinterpret_cast<bf16*>(sDP + kTile * kTile);
  bf16* sDS = sP + kTile * kTile;
  float* sBias = reinterpret_cast<float*>(sDS + kTile * kTile);
  float* sLse = sBias + kTile;
  float* sDelta = sLse + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + (size_t)bh * tq * D;
  const bf16* gb = g + (size_t)bh * tq * D;
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;

  load_tile<D>(sK, k + (size_t)bh * tk * D, k0, tk);
  load_tile<D>(sV, v + (size_t)bh * tk * D, k0, tk);
  load_key_bias(sBias, mask_row, k0, tk);

  float* Sw = sS + warp * kWarpRows * kTile;
  float* DPw = sDP + warp * kWarpRows * kTile;
  bf16* Pw = sP + warp * kWarpRows * kTile;
  bf16* DSw = sDS + warp * kWarpRows * kTile;
  const int wkey0 = k0 + warp * kWarpRows;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.f);
    wmma::fill_fragment(acc_dv[n], 0.f);
  }

  const int nq = (tq + kTile - 1) / kTile;
  const int qt_begin = causal ? (int)blockIdx.y : 0;  // q-tiles above the diagonal see none of these keys
  for (int qt = qt_begin; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<D>(sQ, qb, q0, tq);
    load_tile<D>(sG, gb, q0, tq);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = q0 + i < tq;
      sLse[i] = in ? lse[(size_t)bh * tq + q0 + i] : 0.f;
      sDelta[i] = in ? delta[(size_t)bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();

    warp_a_bt<D>(Sw, sK + warp * kWarpRows * D, sQ);
    warp_a_bt<D>(DPw, sV + warp * kWarpRows * D, sG);
    __syncwarp();

#pragma unroll 4
    for (int r = 0; r < kWarpRows; ++r) {
      const int key = wkey0 + r;
      const float bias = sBias[warp * kWarpRows + r];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        const int row = q0 + j;
        float x = Sw[r * kTile + j] * scale;
        if (causal && row < key) x = kNegInf;
        x += bias;
        const float p = (x <= kNegInf * 0.5f || row >= tq) ? 0.f : expf(x - sLse[j]);
        const float ds = p * (DPw[r * kTile + j] - sDelta[j]) * scale;
        Pw[r * kTile + j] = __float2bfloat16(p);
        DSw[r * kTile + j] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    warp_a_b_acc<D>(acc_dv, Pw, sG);
    warp_a_b_acc<D>(acc_dk, DSw, sQ);
  }
  __syncwarp();
  warp_store_rows<D>(dk + (size_t)bh * tk * D, Sw, acc_dk, wkey0, tk, lane);
  __syncwarp();
  warp_store_rows<D>(dv + (size_t)bh * tk * D, Sw, acc_dv, wkey0, tk, lane);
}

constexpr int kMaxDevices = 64;

// Opt in to more than 48 KB of dynamic shared memory, once per kernel and
// device (the attribute belongs to the device's context). `done` is the
// kernel's table of devices already configured.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
               void* lse, int bh, int heads, int tq, int tk, float scale, int causal,
               cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_fwd_kernel<D>, FwdSmem<D>::kBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tq + kTile - 1) / kTile);
  flash_fwd_kernel<D><<<grid, kThreads, FwdSmem<D>::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse),
      heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
              const void* delta, const void* mask, void* dq, int bh, int heads, int tq, int tk,
              float scale, int causal, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_dq_kernel<D>, DqSmem<D>::kBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tq + kTile - 1) / kTile);
  flash_dq_kernel<D><<<grid, kThreads, DqSmem<D>::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(dq), heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, const void* mask, void* dk, void* dv, int bh, int heads,
               int tq, int tk, float scale, int causal, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_dkv_kernel<D>, DkvSmem<D>::kBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tk + kTile - 1) / kTile);
  flash_dkv_kernel<D><<<grid, kThreads, DkvSmem<D>::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every entry makes `device`
// current for this library's CUDA runtime (its own copy, linked
// statically, so PyTorch's current device does not carry over), launches
// on `stream`, and returns the cudaError_t of the launch (0 = launched);
// an unsupported head dim returns cudaErrorInvalidValue. Nothing here
// synchronises.
extern "C" {

int swt_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                  void* lse, int bh, int heads, int tq, int tk, int d, float scale, int causal,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(q, k, v, mask, out, lse, bh, heads, tq, tk, scale, causal, s);
  if (d == 32) return launch_fwd<32>(q, k, v, mask, out, lse, bh, heads, tq, tk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

int swt_flash_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                 const void* delta, const void* mask, void* dq, int bh, int heads, int tq, int tk,
                 int d, float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq<64>(q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, scale, causal, s);
  if (d == 32)
    return launch_dq<32>(q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

int swt_flash_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
                  const void* delta, const void* mask, void* dk, void* dv, int bh, int heads,
                  int tq, int tk, int d, float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64>(q, k, v, g, lse, delta, mask, dk, dv, bh, heads, tq, tk, scale,
                          causal, s);
  if (d == 32)
    return launch_dkv<32>(q, k, v, g, lse, delta, mask, dk, dv, bh, heads, tq, tk, scale,
                          causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* swt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
