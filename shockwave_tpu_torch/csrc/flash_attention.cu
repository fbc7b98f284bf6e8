// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// These replace the three Pallas TPU kernels of
// shockwave_tpu/ops/flash_attention.py (_fa_kernel, _dq_kernel,
// _dkv_kernel). They take (B, H, T, D) bf16 views (base and strides, rows
// s.t apart: the model's (B, T, H, D) tensors in place; each also has an
// f32 instance, below the bf16 kernels, 3xTF32 on the tensor cores), D in
// {32, 64, 128, 256} (the wrapper zero-pads any head dim up to 256 to one
// of them, as the reference pads; wider head dims go to the wide
// instances in flash_attention_wide.cu, which take D at run time; the
// building blocks both files use are in flash_attention_common.cuh), a
// (B, Tk) uint8 key
// mask (1 = attend, nullptr = all attend, row = bh /
// heads) and keep the reference's masking constants: causal entries are
// set to -1e30, masked keys get a -1e30 additive bias after that, and
// the backward zeroes p wherever s <= -5e29. Rows or keys past a ragged
// sequence end get -inf, which no reference tile has, so they never move
// a running max. Nothing is written to device memory but the outputs.
//
// All three kernels are built on mma.sync.m16n8k16 (bf16 operands, f32
// accumulation) in the FA2 register layout: operands come from shared
// memory through ldmatrix, and scores, probabilities and sums stay in
// registers in the accumulator fragment layout. A CTA owns a square tile
// of `kBlock` rows (16 per warp) of one (batch, head) and streams
// `kBlock`-wide tiles of the other sequence through a two-stage cp.async
// ring. The wrapper picks kBlock from the sequence lengths
// (ops/flash_attention.py:launch_config): 32 when both are at most 32
// (the trainer's T = 32: a 2-warp CTA per (bh), no padding rows), 64
// otherwise. In bf16 the long tile of K1-K3 is the TMA-fed wgmma
// kernels' at every head dim (flash_attention_tma.cu, reached from
// swt_flash_fwd, swt_flash_dq and swt_flash_dkv below), so here K1-K3 are
// built at the short tile only (a wgmma tile's 64 rows, which the T = 32
// path cannot fill).
#include "flash_attention_common.cuh"

namespace {

// Start cp.async copies of rows [row0, row0 + R) of a (rows, D) bf16
// matrix whose rows are `ld` elements apart into an R-row shared tile;
// rows past `rows` are zero-filled (and read nothing). The tile's row
// offsets stay in 32 bits (rows_fit).
template <int D, int R, int kCtaThreads>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src, long long ld, int row0,
                                                int rows) {
  constexpr int kChunks = D / 8;
  const int ld32 = (int)ld;
  for (int i = threadIdx.x; i < R * kChunks; i += kCtaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * smem_stride<D>() + c * 8, src + (valid ? row0 + r : 0) * ld32 + c * 8,
               valid);
  }
}

// Write 16 staged bf16 rows to rows [row0, row0 + 16) of a (rows, D)
// matrix whose rows are `ld` elements apart with 16-byte stores: W columns
// from `dst` and `stage` on (a warp that owns a column slice passes both
// offset to it).
template <int D, int W = D>
__device__ __forceinline__ void warp_store_tile(bf16* dst, long long ld, const bf16* stage,
                                                int row0, int rows, int lane) {
  constexpr int kChunks = W / 8;
  const int ld32 = (int)ld;  // rows_fit
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * ld32 + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * smem_stride<D>() + c * 8);
  }
}

// Stage a warp's 16 x W f32 sum (W = D unless the warp owns a column
// slice), held as W/8 accumulator tiles, as bf16 rows of `stage` (row
// stride D + 8).
template <int D, int N = D / 8>
__device__ __forceinline__ void stage_accum(bf16* stage, const float (&acc)[N][4], float scale0,
                                            float scale1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * smem_stride<D>() + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * scale0, acc[n][1] * scale0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * smem_stride<D>() + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * scale1, acc[n][3] * scale1);
  }
}

// ---------------------------------------------------------------------------
// K1, forward. Replaces _fa_kernel (shockwave_tpu/ops/flash_attention.py:40).
//
// Grid (BH, q-tiles), heaviest causal tile first; a CTA of kBlock / 16
// warps owns kBlock query rows and walks the kBlock-wide k-tiles up to
// the causal diagonal with an online softmax.
//
// Bound on an H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s): at the trainer's
// shape (BH 512, T 32, D 64) it moves 8.5 MB for 0.27 GFLOP, 2.5 us by
// bytes; at the bench shape (4, 2048, 8, 64) causal it does 17.2 GFLOP
// for 17 MB, 17 us by operations.
//
// What the design does about what held the first version back:
// 1. Softmax: each lane holds 2 rows x (kBlock / 4) scores; the row max
//    and sum are reduced over the 4 lanes of a quad with 2 shuffles, for
//    all 16 rows of the warp at once, and the partial sums stay per lane
//    until the epilogue.
// 2. Registers: Q fragments are loaded once; S, P and the f32 output sum
//    O live in accumulator fragments, P is repacked into A operands of
//    P.V in registers and O is rescaled in registers. Nothing of S, P or
//    O goes through shared memory until the epilogue.
// 3. Tiles follow the sequence: kBlock = 32 at T = 32, no padding rows.
// 4. Shared memory: Q plus two K/V stages, (5 kBlock (D + 8) bf16 +
//    2 kBlock f32): 23 KB at the trainer's shape, 46 KB at kBlock 64.
// 5. K/V tiles are double-buffered with cp.async: tile j + 1 is copied
//    while tile j is multiplied.
// 6. The epilogue normalises O, stages it through the warp's own Q rows
//    and writes 16-byte stores; lse is written once per row.
// 7. At D = 256 the O sum alone takes 128 registers a lane, and the Q
//    fragments would take 64 more: there each warp reads its Q fragments
//    from its own rows of the shared Q tile, which stays in place for the
//    whole loop, at every k-step (kHoldQ false), as K3 reads K and V at
//    D = 128. Q plus two K/V stages take 84,736 bytes at kBlock 32 (the
//    only tile built at D = 256): two CTAs per SM.
// ---------------------------------------------------------------------------
template <int D, int kBlock>
struct FwdShape {
  static constexpr int kCtaThreads = kBlock * 2;  // kBlock / 16 warps
  static constexpr bool kHoldQ = D <= 128;        // Q fragments in registers
  static constexpr int kTileElems = kBlock * smem_stride<D>();
  static constexpr size_t kSmemBytes =
      5 * kTileElems * sizeof(bf16)       // Q, 2 x K, 2 x V
      + 2 * kBlock * sizeof(float);       // 2 x key bias
};

template <int D, int kBlock>
__global__ void __launch_bounds__(FwdShape<D, kBlock>::kCtaThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, Strides qs, const bf16* __restrict__ k,
                     Strides ks, const bf16* __restrict__ v, Strides vs,
                     const uint8_t* __restrict__ mask, bf16* __restrict__ out, Strides os,
                     float* __restrict__ lse, int heads, int tq, int tk, float scale,
                     int causal) {
  using Shape = FwdShape<D, kBlock>;
  constexpr int S = smem_stride<D>();
  constexpr int kThr = Shape::kCtaThreads;
  constexpr int kN = kBlock / 8;  // n8 score tiles per row block
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + Shape::kTileElems;
  bf16* sV = sK + 2 * Shape::kTileElems;
  float* sBias = reinterpret_cast<float*>(sV + 2 * Shape::kTileElems);

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // causal: the longest k loops start first
  const int q0 = qt * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kb = k + head_offset(ks, bh, heads);
  const bf16* vb = v + head_offset(vs, bh, heads);
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int nk = (tk + kBlock - 1) / kBlock;
  if (causal) nk = min(nk, qt + 1);  // k-tiles past the diagonal see nothing

  copy_tile_async<D, kBlock, kThr>(sQ, q + head_offset(qs, bh, heads), qs.t, q0, tq);
  copy_tile_async<D, kBlock, kThr>(sK, kb, ks.t, 0, tk);
  copy_tile_async<D, kBlock, kThr>(sV, vb, vs.t, 0, tk);
  for (int j = threadIdx.x; j < kBlock; j += kThr) sBias[j] = key_bias(mask_row, j, tk);
  cp_async_commit();

  uint32_t qf[Shape::kHoldQ ? D / 16 : 1][4];
  const bf16* warp_q = sQ + warp * 16 * S;
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of their normalisers

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * kBlock;
      copy_tile_async<D, kBlock, kThr>(sK + (buf ^ 1) * Shape::kTileElems, kb, ks.t, k1, tk);
      copy_tile_async<D, kBlock, kThr>(sV + (buf ^ 1) * Shape::kTileElems, vb, vs.t, k1, tk);
      for (int j = threadIdx.x; j < kBlock; j += kThr)
        sBias[(buf ^ 1) * kBlock + j] = key_bias(mask_row, k1 + j, tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Shape::kHoldQ) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) load_a<S>(qf[kk], warp_q + kk * 16, lane);
      }
    }
    const bf16* cK = sK + buf * Shape::kTileElems;
    const bf16* cV = sV + buf * Shape::kTileElems;
    const float* cBias = sBias + buf * kBlock;
    const int k0 = kt * kBlock;

    float s[kN][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (Shape::kHoldQ) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
      } else {
        load_a<S>(qa, warp_q + kk * 16, lane);
      }
#pragma unroll
      for (int nn = 0; nn < kN / 2; ++nn) {
        uint32_t b[4];
        load_bt<S>(b, cK + nn * 16 * S + kk * 16, lane);
        mma_bf16(s[2 * nn], qa, b[0], b[1]);
        mma_bf16(s[2 * nn + 1], qa, b[2], b[3]);
      }
    }

    // Scale, causal -1e30, then the key bias, as _fa_kernel orders them;
    // the new running max starts from the old one.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (causal && row[e >> 1] < k0 + kl) x = kNegInf;
        x += cBias[kl];
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P.V, P cast to bf16 straight from the score fragments.
#pragma unroll
    for (int c = 0; c < kN / 2; ++c) {
      uint32_t pa[4];
      accum_to_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t b[4];
        load_b<S>(b, cV + c * 16 * S + nn * 16, lane);
        mma_bf16(o[2 * nn], pa, b[0], b[1]);
        mma_bf16(o[2 * nn + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float lc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    lc[h] = fmaxf(l[h], 1e-30f);
  }
  // The warp's own Q rows are free: only this warp reads them, and it is
  // done with them.
  bf16* stage = sQ + warp * 16 * S;
  stage_accum<D>(stage, o, 1.f / lc[0], 1.f / lc[1], lane);
  __syncwarp();
  warp_store_tile<D>(out + head_offset(os, bh, heads), os.t, stage, q0 + warp * 16, tq, lane);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < tq) lse[(size_t)bh * tq + row[h]] = m[h] + logf(lc[h]);
  }
}

// ---------------------------------------------------------------------------
// K2, dQ. Replaces _dq_kernel (shockwave_tpu/ops/flash_attention.py:167).
//
// Grid (BH, q-tiles), heaviest causal tile first; a CTA of kBlock / 16
// warps owns kBlock query rows, 16 per warp, and walks the kBlock-wide
// k-tiles up to the causal diagonal. Each warp keeps its Q and dO rows as
// A fragments and its rows' lse and delta in registers for the whole
// loop, and works through a k-tile 16 keys at a time: S = Q.K^T and
// dP = dO.V^T in registers, then dS = p (dP - delta) scale with the
// reference's p = 0 where s <= -5e29 guard, repacked as the A operand of
// dQ += dS.K. No atomics: dK/dV is the separate K3 pass.
//
// Bound on an H100 SXM: at the trainer's shape it moves 10.6 MB for
// 0.20 GFLOP, 3.2 us by bytes; at the bench shape it does 25.8 GFLOP
// (three products per (q, k) pair), 26 us by operations.
//
// What the design does about what held the first version back:
// 1. Tiles follow the sequence: kBlock = 32 at T = 32, a 2-warp CTA with
//    no padding rows and no padding keys (the first version's fixed
//    64-row tile left half of each CTA's rows and keys as padding).
// 2. Shared memory: Q, dO and two K/V stages, (6 kBlock (D + 8) bf16 +
//    2 kBlock f32): 27,904 B at the trainer's shape (74,496 B before),
//    so all 512 CTAs of a main-path launch are resident in one wave.
// 3. S, dP and dS never leave registers: the scores are formed in
//    accumulator fragments, the p and dS terms element-wise in them, and
//    dS is repacked into an A operand (no f32 staging in shared memory,
//    no serial per-row pass, no bf16 round trip of dS).
// 4. K/V tiles and their key-bias rows are double-buffered with
//    cp.async: tile j + 1 is copied while tile j is multiplied.
// 5. dQ is staged as bf16 through the warp's own Q rows and written with
//    16-byte stores (the first version stored 2 bytes at a time).
// 6. 16 keys at a time, as K3 works 16 queries at a time: the live
//    scores stay at 16 floats per lane at either tile, and the unrolled
//    chunk loop leaves the compiler free to overlap one chunk's products
//    with the next one's.
// 7. At D = 256 the dQ sum takes 128 registers a lane and the Q and dO
//    fragments would take 128 more: there each warp reads them from its
//    own rows of the shared Q and dO tiles at every 16 keys (kHoldQG
//    false), as K1 reads Q at D = 256. Q, dO and two K/V stages take
//    101,632 bytes at kBlock 32: two CTAs per SM. Only kBlock 32 is
//    built: the long tile is the TMA-fed K2's (flash_attention_tma.cu).
// ---------------------------------------------------------------------------
template <int D, int kBlock>
struct DqShape {
  static constexpr int kCtaThreads = kBlock * 2;  // kBlock / 16 warps
  static constexpr bool kHoldQG = D <= 128;       // Q and dO fragments in registers
  static constexpr int kTileElems = kBlock * smem_stride<D>();
  static constexpr size_t kSmemBytes =
      6 * kTileElems * sizeof(bf16)       // Q, dO, 2 x K, 2 x V
      + 2 * kBlock * sizeof(float);       // 2 x key bias
};

template <int D, int kBlock>
__global__ void __launch_bounds__(DqShape<D, kBlock>::kCtaThreads)
    flash_dq_kernel(const bf16* __restrict__ q, Strides qs, const bf16* __restrict__ k,
                    Strides ks, const bf16* __restrict__ v, Strides vs,
                    const bf16* __restrict__ g, Strides gs, const float* __restrict__ lse,
                    const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                    bf16* __restrict__ dq, Strides dqs, int heads, int tq, int tk, float scale,
                    int causal) {
  using Shape = DqShape<D, kBlock>;
  constexpr int S = smem_stride<D>();
  constexpr int kThr = Shape::kCtaThreads;
  constexpr int kE = Shape::kTileElems;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + kE;
  bf16* sK = sG + kE;      // 2 stages
  bf16* sV = sK + 2 * kE;  // 2 stages
  float* sBias = reinterpret_cast<float*>(sV + 2 * kE);  // 2 stages

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // causal: the longest k loops start first
  const int q0 = qt * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const bf16* kb = k + head_offset(ks, bh, heads);
  const bf16* vb = v + head_offset(vs, bh, heads);
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
  const int row[2] = {q0 + warp * 16 + gq, q0 + warp * 16 + gq + 8};

  int nk = (tk + kBlock - 1) / kBlock;
  if (causal) nk = min(nk, qt + 1);  // k-tiles past the diagonal see nothing

  copy_tile_async<D, kBlock, kThr>(sQ, q + head_offset(qs, bh, heads), qs.t, q0, tq);
  copy_tile_async<D, kBlock, kThr>(sG, g + head_offset(gs, bh, heads), gs.t, q0, tq);
  copy_tile_async<D, kBlock, kThr>(sK, kb, ks.t, 0, tk);
  copy_tile_async<D, kBlock, kThr>(sV, vb, vs.t, 0, tk);
  for (int j = threadIdx.x; j < kBlock; j += kThr) sBias[j] = key_bias(mask_row, j, tk);
  cp_async_commit();

  // lse and delta of the lane's rows g and g + 8; a row past tq reads 0
  // and its dQ is never written.
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < tq;
    row_lse[h] = in ? lse[(size_t)bh * tq + row[h]] : 0.f;
    row_delta[h] = in ? delta[(size_t)bh * tq + row[h]] : 0.f;
  }

  constexpr int kHeld = Shape::kHoldQG ? D / 16 : 1;
  uint32_t qf[kHeld][4], gf[kHeld][4];
  const bf16* warp_q = sQ + warp * 16 * S;
  const bf16* warp_g = sG + warp * 16 * S;
  float dq_acc[D / 8][4] = {};

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * kBlock;
      copy_tile_async<D, kBlock, kThr>(sK + (buf ^ 1) * kE, kb, ks.t, k1, tk);
      copy_tile_async<D, kBlock, kThr>(sV + (buf ^ 1) * kE, vb, vs.t, k1, tk);
      for (int j = threadIdx.x; j < kBlock; j += kThr)
        sBias[(buf ^ 1) * kBlock + j] = key_bias(mask_row, k1 + j, tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Shape::kHoldQG) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          load_a<S>(qf[kk], warp_q + kk * 16, lane);
          load_a<S>(gf[kk], warp_g + kk * 16, lane);
        }
      }
    }
    const bf16* cK = sK + buf * kE;
    const bf16* cV = sV + buf * kE;
    const float* cBias = sBias + buf * kBlock;
    const int k0 = kt * kBlock;

#pragma unroll
    for (int c = 0; c < kBlock / 16; ++c) {  // 16 keys at a time
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], ga[4], b[4];
        if constexpr (Shape::kHoldQG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i], ga[i] = gf[kk][i];
        } else {
          load_a<S>(qa, warp_q + kk * 16, lane);
          load_a<S>(ga, warp_g + kk * 16, lane);
        }
        load_bt<S>(b, cK + c * 16 * S + kk * 16, lane);
        mma_bf16(s[0], qa, b[0], b[1]);
        mma_bf16(s[1], qa, b[2], b[3]);
        load_bt<S>(b, cV + c * 16 * S + kk * 16, lane);
        mma_bf16(dp[0], ga, b[0], b[1]);
        mma_bf16(dp[1], ga, b[2], b[3]);
      }
      // Scale, causal -1e30, then the key bias, as _dq_kernel orders
      // them; lane holds rows row[0] (e = 0, 1) and row[1] (e = 2, 3)
      // against keys kl and kl + 1 of each n8 tile.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = c * 16 + j * 8 + 2 * t + (e & 1);
          const int h = e >> 1;
          float x = s[j][e] * scale;
          if (causal && row[h] < k0 + kl) x = kNegInf;
          x += cBias[kl];
          const float p = x <= kNegInf * 0.5f ? 0.f : expf(x - row_lse[h]);
          dp[j][e] = p * (dp[j][e] - row_delta[h]) * scale;
        }
      }
      uint32_t dsa[4];
      accum_to_a(dsa, dp[0], dp[1]);
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t b[4];
        load_b<S>(b, cK + c * 16 * S + nn * 16, lane);
        mma_bf16(dq_acc[2 * nn], dsa, b[0], b[1]);
        mma_bf16(dq_acc[2 * nn + 1], dsa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The warp's own Q rows are free: only this warp reads them, and it is
  // done with them.
  bf16* stage = sQ + warp * 16 * S;
  stage_accum<D>(stage, dq_acc, 1.f, 1.f, lane);
  __syncwarp();
  warp_store_tile<D>(dq + head_offset(dqs, bh, heads), dqs.t, stage, q0 + warp * 16, tq, lane);
}

// ---------------------------------------------------------------------------
// K3, dK and dV. Replaces _dkv_kernel (shockwave_tpu/ops/flash_attention.py:222).
//
// Grid (BH, k-tiles); a CTA of kBlock / 16 warps owns kBlock keys, 16
// per warp, and walks the kBlock-wide q-tiles from the causal diagonal
// on. Each warp keeps its K and V rows as A fragments for the whole loop
// and works through a q-tile 16 queries at a time: S^T = K.Q^T and
// dP^T = V.dO^T in registers, then P^T and dS^T (with the reference's
// p = 0 where s <= -5e29 guard) repacked as A operands of dV += P^T.dO
// and dK += dS^T.Q. No atomics: dQ is the separate K2 pass.
//
// Bound on an H100 SXM: at the trainer's shape it moves 12.7 MB for
// 0.27 GFLOP, 3.8 us by bytes; at the bench shape it does 34.4 GFLOP
// (four products per (q, k) pair), 35 us by operations.
//
// What the design does about what held the first version back:
// 1. The p and dS terms are formed for all 16 keys of a warp at once,
//    element-wise in registers; the q-side lse and delta come per tile
//    from shared memory as float2 pairs. No shuffles are needed.
// 2. S^T, dP^T, P^T and dS^T never leave registers; the dK and dV sums
//    stay in accumulator fragments.
// 3. Tiles follow the sequence: kBlock = 32 at T = 32, no padding keys
//    and no padding queries.
// 4. Shared memory: K, V and two Q/dO stages, (6 kBlock (D + 8) bf16 +
//    4 kBlock f32): 28 KB at the trainer's shape, 56 KB at kBlock 64.
//    Working 16 queries at a time keeps the live scores to 16 floats
//    per lane at any kBlock.
// 5. Q/dO tiles and their lse/delta rows are double-buffered with
//    cp.async: tile j + 1 is copied while tile j is multiplied.
// 6. dK and dV are staged through the warp's own K and V rows and
//    written with 16-byte stores.
// 7. At D = 128 the dK and dV sums alone (dk_acc, dv_acc: D / 2 floats
//    each a lane) leave no room for K and V fragments beside them: there
//    the warp reads its K and V fragments from its own rows of the shared
//    K and V tiles, which stay in place for the whole loop, as each 16
//    queries' products need them (kHoldKV false).
// 8. At D = 256 the dK and dV sums of 16 keys would take 256 registers a
//    lane, more than a thread has. There two warps share each 16 keys
//    (kColSplit 2): warp w owns keys (w % (kBlock / 16)) * 16 on and the
//    128-column half w / (kBlock / 16) of their dK and dV. Each of the two
//    forms S^T and dP^T over the full D from the shared K, V, Q and dO
//    tiles (so the two score products run twice: 6 products per (q, k)
//    pair in place of 4) and adds its half of dV += P^T.dO and dK +=
//    dS^T.Q. The CTA has kBlock / 8 warps; shared memory is the same as
//    one warp per 16 keys would take (101,888 bytes at kBlock 32, the only
//    tile built at D = 256; the TMA-fed K3 takes the long one and forms
//    each score tile once).
// ---------------------------------------------------------------------------
template <int D, int kBlock>
struct DkvShape {
  static constexpr int kColSplit = D > 128 ? 2 : 1;  // warps per 16 keys
  static constexpr int kCols = D / kColSplit;        // dK and dV columns a warp owns
  static constexpr int kCtaThreads = kBlock * 2 * kColSplit;
  static constexpr bool kHoldKV = D <= 64;  // K and V fragments in registers
  static constexpr int kTileElems = kBlock * smem_stride<D>();
  static constexpr size_t kSmemBytes =
      6 * kTileElems * sizeof(bf16)       // K, V, 2 x Q, 2 x dO
      + 4 * kBlock * sizeof(float);       // 2 x lse, 2 x delta
};

template <int D, int kBlock>
__device__ __forceinline__ void copy_q_side_async(bf16* sQ, bf16* sG, float* sLse, float* sDelta,
                                                  const bf16* qb, long long q_ld, const bf16* gb,
                                                  long long g_ld, const float* lse_b,
                                                  const float* delta_b, int q0, int tq) {
  constexpr int kThr = DkvShape<D, kBlock>::kCtaThreads;
  static_assert(kThr >= 2 * kBlock, "one lse or one delta entry per thread");
  copy_tile_async<D, kBlock, kThr>(sQ, qb, q_ld, q0, tq);
  copy_tile_async<D, kBlock, kThr>(sG, gb, g_ld, q0, tq);
  // The first 2 kBlock threads: one f32 each, lse then delta; rows past
  // tq read 0.
  if (threadIdx.x < 2 * kBlock) {
    const int i = threadIdx.x % kBlock;
    const bool valid = q0 + i < tq;
    const float* src = threadIdx.x < kBlock ? lse_b : delta_b;
    float* dst = threadIdx.x < kBlock ? sLse : sDelta;
    cp_async4(dst + i, src + (valid ? q0 + i : 0), valid);
  }
}

template <int D, int kBlock>
__global__ void __launch_bounds__(DkvShape<D, kBlock>::kCtaThreads)
    flash_dkv_kernel(const bf16* __restrict__ q, Strides qs, const bf16* __restrict__ k,
                     Strides ks, const bf16* __restrict__ v, Strides vs,
                     const bf16* __restrict__ g, Strides gs, const float* __restrict__ lse,
                     const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ dk, Strides dks, bf16* __restrict__ dv, Strides dvs,
                     int heads, int tq, int tk, float scale, int causal) {
  using Shape = DkvShape<D, kBlock>;
  constexpr int S = smem_stride<D>();
  constexpr int kThr = Shape::kCtaThreads;
  constexpr int kE = Shape::kTileElems;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kE;
  bf16* sQ = sV + kE;       // 2 stages
  bf16* sG = sQ + 2 * kE;   // 2 stages
  float* sLse = reinterpret_cast<float*>(sG + 2 * kE);  // 2 stages
  float* sDelta = sLse + 2 * kBlock;                    // 2 stages

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  // The warp's 16 keys (rw) and the first of its dK and dV columns (col0).
  const int rw = (threadIdx.x >> 5) % (kBlock / 16), lane = threadIdx.x & 31;
  const int col0 = (threadIdx.x >> 5) / (kBlock / 16) * Shape::kCols;
  const int gq = lane >> 2, t = lane & 3;
  const bf16* qb = q + head_offset(qs, bh, heads);
  const bf16* gb = g + head_offset(gs, bh, heads);
  const float* lse_b = lse + (size_t)bh * tq;
  const float* delta_b = delta + (size_t)bh * tq;
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
  const int key[2] = {k0 + rw * 16 + gq, k0 + rw * 16 + gq + 8};
  const float bias[2] = {key_bias(mask_row, key[0], tk), key_bias(mask_row, key[1], tk)};

  const int nq = (tq + kBlock - 1) / kBlock;
  const int qt0 = causal ? (int)blockIdx.y : 0;  // q-tiles above the diagonal see none of these keys

  copy_tile_async<D, kBlock, kThr>(sK, k + head_offset(ks, bh, heads), ks.t, k0, tk);
  copy_tile_async<D, kBlock, kThr>(sV, v + head_offset(vs, bh, heads), vs.t, k0, tk);
  if (qt0 < nq)
    copy_q_side_async<D, kBlock>(sQ, sG, sLse, sDelta, qb, qs.t, gb, gs.t, lse_b, delta_b,
                                 qt0 * kBlock, tq);
  cp_async_commit();

  constexpr int kHeld = Shape::kHoldKV ? D / 16 : 1;
  uint32_t kf[kHeld][4], vf[kHeld][4];
  float dk_acc[Shape::kCols / 8][4] = {}, dv_acc[Shape::kCols / 8][4] = {};
  const bf16* warp_k = sK + rw * 16 * S;
  const bf16* warp_v = sV + rw * 16 * S;

  for (int qt = qt0; qt < nq; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < nq) {
      const int nb = buf ^ 1;
      copy_q_side_async<D, kBlock>(sQ + nb * kE, sG + nb * kE, sLse + nb * kBlock,
                                   sDelta + nb * kBlock, qb, qs.t, gb, gs.t, lse_b, delta_b,
                                   (qt + 1) * kBlock, tq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Shape::kHoldKV) {
      if (qt == qt0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          load_a<S>(kf[kk], warp_k + kk * 16, lane);
          load_a<S>(vf[kk], warp_v + kk * 16, lane);
        }
      }
    }
    const bf16* cQ = sQ + buf * kE;
    const bf16* cG = sG + buf * kE;
    const float* cLse = sLse + buf * kBlock;
    const float* cDelta = sDelta + buf * kBlock;
    const int q0 = qt * kBlock;

#pragma unroll
    for (int c = 0; c < kBlock / 16; ++c) {  // 16 queries at a time
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4], b[4];
        if constexpr (Shape::kHoldKV) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ka[i] = kf[kk][i], va[i] = vf[kk][i];
        } else {
          load_a<S>(ka, warp_k + kk * 16, lane);
          load_a<S>(va, warp_v + kk * 16, lane);
        }
        load_bt<S>(b, cQ + c * 16 * S + kk * 16, lane);
        mma_bf16(st[0], ka, b[0], b[1]);
        mma_bf16(st[1], ka, b[2], b[3]);
        load_bt<S>(b, cG + c * 16 * S + kk * 16, lane);
        mma_bf16(dpt[0], va, b[0], b[1]);
        mma_bf16(dpt[1], va, b[2], b[3]);
      }
      // Lane holds keys key[0] (e = 0, 1) and key[1] (e = 2, 3) against
      // queries ql and ql + 1 of each n8 tile.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ql = c * 16 + j * 8 + 2 * t;
        const float2 lq = *reinterpret_cast<const float2*>(cLse + ql);
        const float2 dq = *reinterpret_cast<const float2*>(cDelta + ql);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = q0 + ql + (e & 1);
          float x = st[j][e] * scale;
          if (causal && query < key[e >> 1]) x = kNegInf;
          x += bias[e >> 1];
          const float p = (x <= kNegInf * 0.5f || query >= tq)
                              ? 0.f
                              : expf(x - ((e & 1) ? lq.y : lq.x));
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dq.y : dq.x)) * scale;
        }
      }
      uint32_t pa[4], dsa[4];
      accum_to_a(pa, st[0], st[1]);
      accum_to_a(dsa, dpt[0], dpt[1]);
#pragma unroll
      for (int nn = 0; nn < Shape::kCols / 16; ++nn) {  // the warp's columns
        uint32_t b[4];
        load_b<S>(b, cG + c * 16 * S + col0 + nn * 16, lane);
        mma_bf16(dv_acc[2 * nn], pa, b[0], b[1]);
        mma_bf16(dv_acc[2 * nn + 1], pa, b[2], b[3]);
        load_b<S>(b, cQ + c * 16 * S + col0 + nn * 16, lane);
        mma_bf16(dk_acc[2 * nn], dsa, b[0], b[1]);
        mma_bf16(dk_acc[2 * nn + 1], dsa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // no copy is left in flight when the loop never ran
  __syncthreads();

  // The warp's own K and V rows are free: no warp reads them any more.
  // Each warp stages and stores its own columns.
  bf16* stage_k = sK + rw * 16 * S + col0;
  bf16* stage_v = sV + rw * 16 * S + col0;
  stage_accum<D, Shape::kCols / 8>(stage_k, dk_acc, 1.f, 1.f, lane);
  stage_accum<D, Shape::kCols / 8>(stage_v, dv_acc, 1.f, 1.f, lane);
  __syncwarp();
  warp_store_tile<D, Shape::kCols>(dk + head_offset(dks, bh, heads) + col0, dks.t, stage_k,
                                   k0 + rw * 16, tk, lane);
  warp_store_tile<D, Shape::kCols>(dv + head_offset(dvs, bh, heads) + col0, dvs.t, stage_v,
                                   k0 + rw * 16, tk, lane);
}

// ---------------------------------------------------------------------------
// K1-K3 in f32: flash_fwd_f32, flash_dq_f32, flash_dkv_f32.
//
// The same three functions on (B, H, T, D) f32 views, as the Pallas
// kernels compute them in f32 (every dot there runs with
// preferred_element_type=f32), to the plain f32 versions' digits: no
// one-pass TF32 anywhere. Masking is the bf16 kernels': -1e30 after the
// causal where, then the key bias, -inf past a ragged end (so such keys
// never move a max), the running max from -1e30, p = 0 where s <= -5e29
// in the backward.
//
// All three run their products on the tensor cores as 3xTF32, as
// PyTorch's f32 attention does on sm80+: flash_fwd_f32 (replaces
// _fa_kernel, shockwave_tpu/ops/flash_attention.py:40), flash_dq_f32
// (replaces _dq_kernel, :167) and flash_dkv_f32 (replaces _dkv_kernel,
// :222). Each operand is split as x = big + small, both TF32
// (split_tf32), and a product a.b becomes a_small.b_big + a_big.b_small +
// a_big.b_big, the small terms first, into one f32 accumulator of
// mma.sync.m16n8k8.tf32. That keeps about 21 bits of each product
// (one-pass TF32 keeps 11, which misses the f32 tolerance).
//
// Bound on an H100 SXM (3.35 TB/s; f32-accurate products at 494.5 / 3 =
// 164.8 TFLOP/s, a third of the dense TF32 rate):
// - K1 f32: at the bench shape (4, 2048, 8, 64) causal, 17.2 GFLOP for
//   67 MB, 104 us by operations; at the f32 decoder's (8, 64, 4 x 32)
//   causal, 1.06 MB, 0.32 us by bytes.
// - K2 f32: 25.8 GFLOP for 84 MB, 156 us by operations at the bench
//   shape; 1.33 MB, 0.40 us by bytes at the decoder's.
// - K3 f32: 34.4 GFLOP for 101 MB, 209 us by operations at the bench
//   shape; 1.59 MB, 0.47 us by bytes at the decoder's.
//
// What the design does about that bound:
// 1. Tensor cores: K1 runs S = Q.K^T and O += P.V; K2 runs S = Q.K^T,
//    dP = dO.V^T and dQ += dS.K; K3 runs S^T = K.Q^T, dP^T = V.dO^T,
//    dV += P^T.dO and dK += dS^T.Q; each as three m16n8k8 TF32 products.
//    The operands a CTA owns (K1: Q; K2: Q and dO; K3: K and V) are
//    split once per CTA, straight from device memory; the streamed
//    operands are split as their fragments are read, in three integer
//    and float ops. The tensor cores' f32 accumulation truncates, so O,
//    dQ, dV and dK are summed one tile (K2 and K3: 16 keys or queries)
//    at a time from zero and added up in f32. Exponentials take __expf
//    (ex2.approx), well inside the tolerance.
// 2. The accumulator-to-operand hand-off: in m16n8k8.tf32 a lane's A
//    registers hold columns t and t + 4 of a row, its C registers columns
//    2t and 2t + 1. Rather than move P (or dS, dS^T) across lanes, the
//    reduction index is permuted: slot t takes column 2t and slot t + 4
//    column 2t + 1, and the B fragment of V (K in K2, dO and Q in K3) is
//    read from rows 2t and 2t + 1 to match, so the product is unchanged.
// 3. K/V tiles and the key bias (K1, K2) and Q/dO/lse/delta tiles (K3)
//    stream through a two-stage cp.async ring of 16-byte copies; shared
//    rows are padded to D + 4 floats, so every fragment read is free of
//    bank conflicts. Two 64-row f32 stages take 70 KB, so the launchers
//    opt in to more than 48 KB.
// 4. Warps own 16 rows (K1, K2: queries; K3: keys). K1 keeps its online
//    softmax in registers, the row max and sum reduced over a quad with
//    two shuffles. K2 and K3 work 16 keys (K3: queries) at a time, one
//    chunk live at a time, so their scores stay at 16 floats beside the
//    split operand and the sums held in registers (K2: split Q and dQ;
//    K3: split K, dK and dV); the other split operand (K2: dO, K3: V)
//    waits in shared memory in fragment order. Every instance compiles
//    with 0 spill bytes at D <= 64.
// 5. At D = 128 the sums a warp holds (K1: O and the tile's P.V; K2: dQ;
//    K3: dK and dV) leave no room for a split 16-row operand beside them
//    (big and small parts: D floats a lane). There the operands a CTA
//    owns (K1: Q; K2: Q and dO; K3: K and V) wait in shared memory as
//    they are, in rows of D + 4 floats, and are split as their fragments
//    are read (split_a_shared), as the streamed tiles are (kOwnedInSmem).
//    Two 64-row stages of two 128-wide tiles and the owned tiles then
//    leave room for one CTA per SM.
// 6. Tiles follow the grid: up to T = 64 a CTA is one warp of 16 rows, so
//    the decoder's 32 (batch, head) pairs give 128 CTAs, not 32, on 132
//    SMs; longer sequences take 64-row CTAs that share each streamed tile
//    among four warps (K1 at D = 32 only: K2's and K3's long tile at D =
//    32-256 and K1's at D = 64-256 are flash_attention_tma_f32.cu's
//    TMA-fed kernels).
// 7. At D = 256 a 64-row f32 tile takes 66,560 bytes, so two stages of K
//    and V alone would pass the 227 KB a CTA may take: the long tile is 32
//    rows (K1: 166,656 bytes; K2, K3: about 200 KB; one CTA per SM). K1's
//    O takes 128 registers a lane, so the tile's P.V is formed one n8
//    column tile at a time (each summed from zero over the tile's keys and
//    added to O by an FMA, the same sums in the same order), from P's
//    split A operands held for the tile (kN x 8 registers) rather than a
//    second D-wide sum. K3's dK and dV would take 256 registers: two warps
//    share each 16 keys, each owning a 128-column half of dK and dV and
//    forming the scores over the full D, as bf16 K3 does at D = 256.
// (Note 7's long tiles at D = 256, and the 64-row ones at D = 64 and 128,
// are no longer built: flash_attention_tma_f32.cu runs K1-K3 there on
// TF32 wgmma, P.V, dS.K, P^T.dO and dS^T.Q as O^T = V^T.P^T, dQ^T =
// K^T.dS^T, dV^T = dO^T.P and dK^T = Q^T.dS, since wgmma takes 32-bit B
// operands only K-major; at D = 32 it runs K2 and K3 there too, as dQ =
// dS.K, dV = P^T.dO and dK = dS^T.Q from transposed planes of K, Q and dO.
// The short tile and K1's long tile at D = 32 stay here.)

// The A operand of rows [r0, r0 + 16), columns [c0, c0 + 8) of a (rows,
// D) f32 matrix in device memory whose rows are `ld` elements apart,
// split; rows past `rows` read 0.
__device__ __forceinline__ Split<4> split_a_global(const float* x, long long ld, int r0, int rows,
                                                   int c0, int g, int t) {
  const bool in0 = r0 + g < rows, in1 = r0 + g + 8 < rows;
  const float* x0 = x + (in0 ? r0 + g : 0) * (int)ld + c0;
  const float* x1 = x + (in1 ? r0 + g + 8 : 0) * (int)ld + c0;
  const float v[4] = {in0 ? x0[t] : 0.f, in1 ? x1[t] : 0.f, in0 ? x0[t + 4] : 0.f,
                      in1 ? x1[t + 4] : 0.f};
  Split<4> a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], a.big[i], a.small[i]);
  return a;
}

// Start cp.async copies of rows [row0, row0 + R) of a (rows, D) f32
// matrix whose rows are `ld` elements apart into an R-row shared tile of
// stride f32_stride<D>(); rows past `rows` are zero-filled.
template <int D, int R, int kCtaThreads>
__device__ __forceinline__ void copy_tile_f32_async(float* dst, const float* src, long long ld,
                                                    int row0, int rows) {
  constexpr int kChunks = D / 4;
  const int ld32 = (int)ld;
  for (int i = threadIdx.x; i < R * kChunks; i += kCtaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * f32_stride<D>() + c * 4, src + (valid ? row0 + r : 0) * ld32 + c * 4,
               valid);
  }
}

// K1 in f32. Grid (BH, q-tiles), heaviest causal tile first; a CTA of
// kBlock / 16 warps owns kBlock query rows, 16 per warp, and walks the
// kBlock-wide k-tiles up to the causal diagonal with an online softmax.
template <int D, int kBlock>
struct FwdF32Shape {
  static constexpr int kCtaThreads = kBlock * 2;  // kBlock / 16 warps
  static constexpr int kTileElems = kBlock * f32_stride<D>();
  static constexpr bool kOwnedInSmem = D > 64;  // Q in shared memory (design note 5)
  static constexpr bool kPvByColumn = D > 128;  // design note 7
  static constexpr size_t kSmemBytes =
      ((4 + kOwnedInSmem) * kTileElems + 2 * kBlock) *
      sizeof(float);  // 2 x K, 2 x V, 2 x key bias[, Q]
};

template <int D, int kBlock>
__global__ void __launch_bounds__(FwdF32Shape<D, kBlock>::kCtaThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, Strides qs, const float* __restrict__ k,
                         Strides ks, const float* __restrict__ v, Strides vs,
                         const uint8_t* __restrict__ mask, float* __restrict__ out, Strides os,
                         float* __restrict__ lse, int heads, int tq, int tk, float scale,
                         int causal) {
  using Shape = FwdF32Shape<D, kBlock>;
  constexpr int S = f32_stride<D>();
  constexpr int kThr = Shape::kCtaThreads;
  constexpr int kE = Shape::kTileElems;
  constexpr int kN = kBlock / 8;  // n8 score tiles per row block
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // 2 stages
  float* sV = sK + 2 * kE;                     // 2 stages
  float* sBias = sV + 2 * kE;                  // 2 stages
  float* sQ = sBias + 2 * kBlock;              // kOwnedInSmem only

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // causal: the longest k loops start first
  const int q0 = qt * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + head_offset(qs, bh, heads);
  const float* kb = k + head_offset(ks, bh, heads);
  const float* vb = v + head_offset(vs, bh, heads);
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int nk = (tk + kBlock - 1) / kBlock;
  if (causal) nk = min(nk, qt + 1);  // k-tiles past the diagonal see nothing

  copy_tile_f32_async<D, kBlock, kThr>(sK, kb, ks.t, 0, tk);
  copy_tile_f32_async<D, kBlock, kThr>(sV, vb, vs.t, 0, tk);
  if constexpr (Shape::kOwnedInSmem) copy_tile_f32_async<D, kBlock, kThr>(sQ, qb, qs.t, q0, tq);
  for (int j = threadIdx.x; j < kBlock; j += kThr) sBias[j] = key_bias(mask_row, j, tk);
  cp_async_commit();

  // The warp's 16 Q rows, split once while the first tiles arrive (at D
  // = 128 split as they are read from sQ).
  Split<4> qf[Shape::kOwnedInSmem ? 1 : D / 8];
  if constexpr (!Shape::kOwnedInSmem) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      qf[kk] = split_a_global(qb, qs.t, q0 + warp * 16, tq, kk * 8, g, t);
  }
  const float* warp_q = sQ + warp * 16 * S;

  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of their normalisers

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * kBlock;
      copy_tile_f32_async<D, kBlock, kThr>(sK + (buf ^ 1) * kE, kb, ks.t, k1, tk);
      copy_tile_f32_async<D, kBlock, kThr>(sV + (buf ^ 1) * kE, vb, vs.t, k1, tk);
      for (int j = threadIdx.x; j < kBlock; j += kThr)
        sBias[(buf ^ 1) * kBlock + j] = key_bias(mask_row, k1 + j, tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cK = sK + buf * kE;
    const float* cV = sV + buf * kE;
    const float* cBias = sBias + buf * kBlock;
    const int k0 = kt * kBlock;

    float s[kN][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      Split<4> qa;
      if constexpr (Shape::kOwnedInSmem)
        qa = split_a_shared<S>(warp_q + kk * 8, g, t);
      else
        qa = qf[kk];
#pragma unroll
      for (int j = 0; j < kN; ++j)
        mma_3xtf32(s[j], qa, split_bt<S>(cK + j * 8 * S + kk * 8, g, t));
    }

    // Scale, causal -1e30, then the key bias, as _fa_kernel orders them;
    // the new running max starts from the old one.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (causal && row[e >> 1] < k0 + kl) x = kNegInf;
        x += cBias[kl];
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = __expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }

    // O = O corr + P.V, 8 keys at a time: P's accumulator tiles are A
    // operands as they stand, V's rows read in the matching order. The
    // tile's P.V is summed from zero on the tensor cores and added to O by
    // an FMA, so that the tensor cores' f32 accumulation, which truncates,
    // runs over one tile and not the whole sequence.
    if constexpr (Shape::kPvByColumn) {  // D = 256: one n8 column tile at a time
      Split<4> pa[kN];
#pragma unroll
      for (int c = 0; c < kN; ++c) pa[c] = accum_to_a_tf32(s[c]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float pv[4] = {};
#pragma unroll
        for (int c = 0; c < kN; ++c)
          mma_3xtf32(pv, pa[c], split_b_permuted<S>(cV + c * 8 * S + n * 8, g, t));
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], corr[e >> 1], pv[e]);
      }
    } else {
      float pv[D / 8][4] = {};
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        const Split<4> pa = accum_to_a_tf32(s[c]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          mma_3xtf32(pv[n], pa, split_b_permuted<S>(cV + c * 8 * S + n * 8, g, t));
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], corr[e >> 1], pv[n][e]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The tile's row offsets fit 32 bits (rows_fit).
  float* ob = out + head_offset(os, bh, heads) + q0 * os.t;
  const int ld = (int)os.t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lc = fmaxf(l[h], 1e-30f);
    if (row[h] < tq) {
      const float inv = 1.f / lc;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(ob + (row[h] - q0) * ld + n * 8 + 2 * t) =
            make_float2(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
      if (t == 0) lse[(size_t)bh * tq + row[h]] = m[h] + logf(lc);
    }
  }
}

// K2 in f32: dQ. Grid (BH, q-tiles), heaviest causal tile first; a CTA
// of kBlock / 16 warps owns kBlock query rows, 16 per warp, and walks the
// kBlock-wide k-tiles up to the causal diagonal, 16 keys at a time. A warp
// keeps its split Q rows in registers beside the dQ sum; its split dO
// rows wait in shared memory in fragment order, big and small parts in
// planes of their own (each a warp's contiguous 512 bytes per k8 slice,
// read back as one 16-byte load per lane), as K3 f32 keeps split V.
template <int D, int kBlock>
struct DqF32Shape {
  static constexpr int kCtaThreads = kBlock * 2;  // kBlock / 16 warps
  static constexpr int kTileElems = kBlock * f32_stride<D>();
  static constexpr int kSplitGElems = kBlock * D * 2;  // big and small of each warp's dO rows
  static constexpr bool kOwnedInSmem = D > 64;  // Q and dO as they are (design note 5)
  static constexpr size_t kSmemBytes =
      (4 * kTileElems + 2 * kBlock + (kOwnedInSmem ? 2 * kTileElems : kSplitGElems)) *
      sizeof(float);  // 2 x K, 2 x V, 2 x key bias, split dO [or Q and dO]
};

template <int D, int kBlock>
__global__ void __launch_bounds__(DqF32Shape<D, kBlock>::kCtaThreads)
    flash_dq_f32_kernel(const float* __restrict__ q, Strides qs, const float* __restrict__ k,
                        Strides ks, const float* __restrict__ v, Strides vs,
                        const float* __restrict__ g, Strides gs, const float* __restrict__ lse,
                        const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                        float* __restrict__ dq, Strides dqs, int heads, int tq, int tk,
                        float scale, int causal) {
  using Shape = DqF32Shape<D, kBlock>;
  constexpr int S = f32_stride<D>();
  constexpr int kThr = Shape::kCtaThreads;
  constexpr int kE = Shape::kTileElems;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // 2 stages
  float* sV = sK + 2 * kE;                     // 2 stages
  float* sBias = sV + 2 * kE;                  // 2 stages
  uint32_t* sGf = reinterpret_cast<uint32_t*>(sBias + 2 * kBlock);  // split dO
  float* sQ = sBias + 2 * kBlock;  // kOwnedInSmem: Q, then dO, in place of sGf
  float* sG = sQ + kE;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // causal: the longest k loops start first
  const int q0 = qt * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const float* kb = k + head_offset(ks, bh, heads);
  const float* vb = v + head_offset(vs, bh, heads);
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
  const int row[2] = {q0 + warp * 16 + gq, q0 + warp * 16 + gq + 8};
  // A row past tq reads 0 (Q, dO, lse and delta): its dS is 0 and its dQ
  // is never written.
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < tq;
    row_lse[h] = in ? lse[(size_t)bh * tq + row[h]] : 0.f;
    row_delta[h] = in ? delta[(size_t)bh * tq + row[h]] : 0.f;
  }

  int nk = (tk + kBlock - 1) / kBlock;
  if (causal) nk = min(nk, qt + 1);  // k-tiles past the diagonal see nothing

  const float* qb = q + head_offset(qs, bh, heads);
  const float* gb = g + head_offset(gs, bh, heads);
  copy_tile_f32_async<D, kBlock, kThr>(sK, kb, ks.t, 0, tk);
  copy_tile_f32_async<D, kBlock, kThr>(sV, vb, vs.t, 0, tk);
  if constexpr (Shape::kOwnedInSmem) {
    copy_tile_f32_async<D, kBlock, kThr>(sQ, qb, qs.t, q0, tq);
    copy_tile_f32_async<D, kBlock, kThr>(sG, gb, gs.t, q0, tq);
  }
  for (int j = threadIdx.x; j < kBlock; j += kThr) sBias[j] = key_bias(mask_row, j, tk);
  cp_async_commit();

  // The warp's 16 Q and dO rows, split once while the first tiles arrive:
  // Q into registers, dO into the warp's own slots of sGf (the loop's
  // first __syncthreads orders these stores before their loads). At D =
  // 128 both are split as they are read from sQ and sG.
  Split<4> qf[Shape::kOwnedInSmem ? 1 : D / 8];
  uint32_t* gf_warp = sGf + warp * (D / 8) * 256;  // + kk * 256: big plane, then small
  const float* warp_q = sQ + warp * 16 * S;
  const float* warp_g = sG + warp * 16 * S;
  if constexpr (!Shape::kOwnedInSmem) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      qf[kk] = split_a_global(qb, qs.t, q0 + warp * 16, tq, kk * 8, gq, t);
      const Split<4> gf = split_a_global(gb, gs.t, q0 + warp * 16, tq, kk * 8, gq, t);
      uint4* dst = reinterpret_cast<uint4*>(gf_warp + kk * 256) + lane;
      dst[0] = make_uint4(gf.big[0], gf.big[1], gf.big[2], gf.big[3]);
      dst[32] = make_uint4(gf.small[0], gf.small[1], gf.small[2], gf.small[3]);
    }
  }
  float dq_acc[D / 8][4] = {};

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * kBlock;
      copy_tile_f32_async<D, kBlock, kThr>(sK + (buf ^ 1) * kE, kb, ks.t, k1, tk);
      copy_tile_f32_async<D, kBlock, kThr>(sV + (buf ^ 1) * kE, vb, vs.t, k1, tk);
      for (int j = threadIdx.x; j < kBlock; j += kThr)
        sBias[(buf ^ 1) * kBlock + j] = key_bias(mask_row, k1 + j, tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cBias = sBias + buf * kBlock;
    const int k0 = kt * kBlock;
    // On the causal diagonal (k0 == q0) the chunks past the warp's own 16
    // rows hold only keys above them: their dS is 0, so they are skipped.
    const int nc = (causal && kt == qt) ? warp + 1 : kBlock / 16;

#pragma unroll 1  // one chunk's operands live at a time
    for (int c = 0; c < nc; ++c) {  // 16 keys at a time
      const float* cK = sK + buf * kE + c * 16 * S;
      const float* cV = sV + buf * kE + c * 16 * S;
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        Split<4> qa, gf;
        if constexpr (Shape::kOwnedInSmem) {
          qa = split_a_shared<S>(warp_q + kk * 8, gq, t);
          gf = split_a_shared<S>(warp_g + kk * 8, gq, t);
        } else {
          const uint4* src = reinterpret_cast<const uint4*>(gf_warp + kk * 256) + lane;
          const uint4 gbig = src[0], gsmall = src[32];
          qa = qf[kk];
          gf = {{gbig.x, gbig.y, gbig.z, gbig.w}, {gsmall.x, gsmall.y, gsmall.z, gsmall.w}};
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_3xtf32(st[j], qa, split_bt<S>(cK + j * 8 * S + kk * 8, gq, t));
          mma_3xtf32(dpt[j], gf, split_bt<S>(cV + j * 8 * S + kk * 8, gq, t));
        }
      }
      // Lane holds rows row[0] (e = 0, 1) and row[1] (e = 2, 3) against
      // keys kl and kl + 1 of each n8 tile: dS = p (dP - delta) scale.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = c * 16 + j * 8 + 2 * t;
        const float2 bias = *reinterpret_cast<const float2*>(cBias + kl);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = st[j][e] * scale;
          if (causal && row[h] < k0 + kl + (e & 1)) x = kNegInf;
          x += (e & 1) ? bias.y : bias.x;
          const float p = x <= kNegInf * 0.5f ? 0.f : __expf(x - row_lse[h]);
          dpt[j][e] = p * (dpt[j][e] - row_delta[h]) * scale;
        }
      }
      // dQ += dS.K: dS's accumulator tiles are A operands as they stand,
      // K's rows read in the matching order. Each 16 keys' part is summed
      // from zero on the tensor cores and added to dQ in f32 (see K1's O).
      const Split<4> dsa[2] = {accum_to_a_tf32(dpt[0]), accum_to_a_tf32(dpt[1])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float part[4] = {};
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma_3xtf32(part, dsa[j], split_b_permuted<S>(cK + j * 8 * S + n * 8, gq, t));
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[n][e] += part[e];
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float* dqb = dq + head_offset(dqs, bh, heads) + q0 * dqs.t;  // as K1 f32's O
  const int ld = (int)dqs.t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= tq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dqb + (row[h] - q0) * ld + n * 8 + 2 * t) =
          make_float2(dq_acc[n][2 * h], dq_acc[n][2 * h + 1]);
  }
}

// K3 in f32: dK and dV. Grid (BH, k-tiles); a CTA of kBlock / 16 warps
// owns kBlock keys, 16 per warp, and walks the kBlock-wide q-tiles from
// the causal diagonal on, 16 queries at a time. A warp keeps its split K
// rows in registers beside the dK and dV sums; its split V rows wait in
// shared memory in fragment order (each lane's 8 values of a k8 slice
// side by side, read back as two 16-byte loads), since registers would
// not hold both with the scores (255 a thread).
template <int D, int kBlock>
struct DkvF32Shape {
  static constexpr int kColSplit = D > 128 ? 2 : 1;  // warps per 16 keys (design note 7)
  static constexpr int kCols = D / kColSplit;        // dK and dV columns a warp owns
  static constexpr int kCtaThreads = kBlock * 2 * kColSplit;  // kBlock / 16 x kColSplit warps
  static constexpr int kTileElems = kBlock * f32_stride<D>();
  static constexpr int kSplitVElems = kBlock * D * 2;  // big and small of each warp's V rows
  static constexpr bool kOwnedInSmem = D > 64;  // K and V as they are (design note 5)
  static constexpr size_t kSmemBytes =
      (4 * kTileElems + 4 * kBlock + (kOwnedInSmem ? 2 * kTileElems : kSplitVElems)) *
      sizeof(float);  // 2 x Q, 2 x dO, 2 x lse, 2 x delta, split V [or K and V]
};

template <int D, int kBlock>
__device__ __forceinline__ void copy_q_side_f32_async(float* sQ, float* sG, float* sLse,
                                                      float* sDelta, const float* qb,
                                                      long long q_ld, const float* gb,
                                                      long long g_ld, const float* lse_b,
                                                      const float* delta_b, int q0, int tq) {
  constexpr int kThr = DkvF32Shape<D, kBlock>::kCtaThreads;
  static_assert(kThr >= 2 * kBlock, "one lse or one delta entry per thread");
  copy_tile_f32_async<D, kBlock, kThr>(sQ, qb, q_ld, q0, tq);
  copy_tile_f32_async<D, kBlock, kThr>(sG, gb, g_ld, q0, tq);
  // The first 2 kBlock threads: one f32 each, lse then delta; rows past
  // tq read 0.
  if (threadIdx.x < 2 * kBlock) {
    const int i = threadIdx.x % kBlock;
    const bool valid = q0 + i < tq;
    const float* src = threadIdx.x < kBlock ? lse_b : delta_b;
    float* dst = threadIdx.x < kBlock ? sLse : sDelta;
    cp_async4(dst + i, src + (valid ? q0 + i : 0), valid);
  }
}

template <int D, int kBlock>
__global__ void __launch_bounds__(DkvF32Shape<D, kBlock>::kCtaThreads)
    flash_dkv_f32_kernel(const float* __restrict__ q, Strides qs, const float* __restrict__ k,
                         Strides ks, const float* __restrict__ v, Strides vs,
                         const float* __restrict__ g, Strides gs, const float* __restrict__ lse,
                         const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                         float* __restrict__ dk, Strides dks, float* __restrict__ dv, Strides dvs,
                         int heads, int tq, int tk, float scale, int causal) {
  using Shape = DkvF32Shape<D, kBlock>;
  constexpr int S = f32_stride<D>();
  constexpr int kE = Shape::kTileElems;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // 2 stages
  float* sG = sQ + 2 * kE;                      // 2 stages
  float* sLse = sG + 2 * kE;                    // 2 stages
  float* sDelta = sLse + 2 * kBlock;            // 2 stages
  uint32_t* sVf = reinterpret_cast<uint32_t*>(sDelta + 2 * kBlock);  // split V
  float* sK = sDelta + 2 * kBlock;  // kOwnedInSmem: K, then V, in place of sVf
  float* sV = sK + kE;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  // The warp's 16 keys (warp) and the first of its dK and dV columns (col0).
  const int warp = (threadIdx.x >> 5) % (kBlock / 16), lane = threadIdx.x & 31;
  const int col0 = (threadIdx.x >> 5) / (kBlock / 16) * Shape::kCols;
  const int gq = lane >> 2, t = lane & 3;
  const float* qb = q + head_offset(qs, bh, heads);
  const float* gb = g + head_offset(gs, bh, heads);
  const float* lse_b = lse + (size_t)bh * tq;
  const float* delta_b = delta + (size_t)bh * tq;
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
  const int key[2] = {k0 + warp * 16 + gq, k0 + warp * 16 + gq + 8};
  const float bias[2] = {key_bias(mask_row, key[0], tk), key_bias(mask_row, key[1], tk)};

  const int nq = (tq + kBlock - 1) / kBlock;
  // q-tiles above the diagonal see none of these keys
  const int qt0 = causal ? (int)blockIdx.y : 0;

  const float* kb = k + head_offset(ks, bh, heads);
  const float* vb = v + head_offset(vs, bh, heads);
  if (qt0 < nq)
    copy_q_side_f32_async<D, kBlock>(sQ, sG, sLse, sDelta, qb, qs.t, gb, gs.t, lse_b, delta_b,
                                     qt0 * kBlock, tq);
  if constexpr (Shape::kOwnedInSmem) {
    copy_tile_f32_async<D, kBlock, Shape::kCtaThreads>(sK, kb, ks.t, k0, tk);
    copy_tile_f32_async<D, kBlock, Shape::kCtaThreads>(sV, vb, vs.t, k0, tk);
  }
  cp_async_commit();

  // The warp's 16 K and V rows, split once while the first tiles arrive:
  // K into registers, V into the warp's own slots of sVf (the loop's
  // first __syncthreads orders these stores before their loads). At D =
  // 128 both are split as they are read from sK and sV.
  Split<4> kf[Shape::kOwnedInSmem ? 1 : D / 8];
  uint32_t* vf_lane = sVf + (warp * (D / 8) * 32 + lane) * 8;  // + kk * 256
  const float* warp_k = sK + warp * 16 * S;
  const float* warp_v = sV + warp * 16 * S;
  if constexpr (!Shape::kOwnedInSmem) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      kf[kk] = split_a_global(kb, ks.t, k0 + warp * 16, tk, kk * 8, gq, t);
      const Split<4> vf = split_a_global(vb, vs.t, k0 + warp * 16, tk, kk * 8, gq, t);
      uint4* dst = reinterpret_cast<uint4*>(vf_lane + kk * 256);
      dst[0] = make_uint4(vf.big[0], vf.big[1], vf.big[2], vf.big[3]);
      dst[1] = make_uint4(vf.small[0], vf.small[1], vf.small[2], vf.small[3]);
    }
  }
  float dk_acc[Shape::kCols / 8][4] = {}, dv_acc[Shape::kCols / 8][4] = {};

  for (int qt = qt0; qt < nq; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < nq) {
      const int nb = buf ^ 1;
      copy_q_side_f32_async<D, kBlock>(sQ + nb * kE, sG + nb * kE, sLse + nb * kBlock,
                                       sDelta + nb * kBlock, qb, qs.t, gb, gs.t, lse_b, delta_b,
                                       (qt + 1) * kBlock, tq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cLse = sLse + buf * kBlock;
    const float* cDelta = sDelta + buf * kBlock;
    const int q0 = qt * kBlock;

#pragma unroll 1  // one chunk's operands live at a time: no spills at D = 64
    for (int c = 0; c < kBlock / 16; ++c) {  // 16 queries at a time
      const float* cQ = sQ + buf * kE + c * 16 * S;
      const float* cG = sG + buf * kE + c * 16 * S;
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        Split<4> ka, vf;
        if constexpr (Shape::kOwnedInSmem) {
          ka = split_a_shared<S>(warp_k + kk * 8, gq, t);
          vf = split_a_shared<S>(warp_v + kk * 8, gq, t);
        } else {
          const uint4* src = reinterpret_cast<const uint4*>(vf_lane + kk * 256);
          const uint4 vbig = src[0], vsmall = src[1];
          ka = kf[kk];
          vf = {{vbig.x, vbig.y, vbig.z, vbig.w}, {vsmall.x, vsmall.y, vsmall.z, vsmall.w}};
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_3xtf32(st[j], ka, split_bt<S>(cQ + j * 8 * S + kk * 8, gq, t));
          mma_3xtf32(dpt[j], vf, split_bt<S>(cG + j * 8 * S + kk * 8, gq, t));
        }
      }
      // Lane holds keys key[0] (e = 0, 1) and key[1] (e = 2, 3) against
      // queries ql and ql + 1 of each n8 tile.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ql = c * 16 + j * 8 + 2 * t;
        const float2 lq = *reinterpret_cast<const float2*>(cLse + ql);
        const float2 dq = *reinterpret_cast<const float2*>(cDelta + ql);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = q0 + ql + (e & 1);
          float x = st[j][e] * scale;
          if (causal && query < key[e >> 1]) x = kNegInf;
          x += bias[e >> 1];
          const float p = (x <= kNegInf * 0.5f || query >= tq)
                              ? 0.f
                              : __expf(x - ((e & 1) ? lq.y : lq.x));
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dq.y : dq.x)) * scale;
        }
      }
      // dV += P^T.dO, then dK += dS^T.Q: the accumulator tiles are A
      // operands as they stand, dO's and Q's rows read in the matching
      // order. Each 16 queries' part is summed from zero on the tensor
      // cores and added to dV and dK in f32 (see K1's O).
      {
        const Split<4> pa[2] = {accum_to_a_tf32(st[0]), accum_to_a_tf32(st[1])};
#pragma unroll
        for (int n = 0; n < Shape::kCols / 8; ++n) {  // the warp's columns
          float part[4] = {};
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma_3xtf32(part, pa[j],
                       split_b_permuted<S>(cG + j * 8 * S + col0 + n * 8, gq, t));
#pragma unroll
          for (int e = 0; e < 4; ++e) dv_acc[n][e] += part[e];
        }
      }
      {
        const Split<4> dsa[2] = {accum_to_a_tf32(dpt[0]), accum_to_a_tf32(dpt[1])};
#pragma unroll
        for (int n = 0; n < Shape::kCols / 8; ++n) {
          float part[4] = {};
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma_3xtf32(part, dsa[j],
                       split_b_permuted<S>(cQ + j * 8 * S + col0 + n * 8, gq, t));
#pragma unroll
          for (int e = 0; e < 4; ++e) dk_acc[n][e] += part[e];
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // no copy is left in flight when the loop never ran

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= tk) continue;
    float* dk_row = dk + head_offset(dks, bh, heads) + k0 * dks.t +
                    (key[h] - k0) * (int)dks.t + col0 + 2 * t;  // as K1 f32's O
    float* dv_row = dv + head_offset(dvs, bh, heads) + k0 * dvs.t +
                    (key[h] - k0) * (int)dvs.t + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < Shape::kCols / 8; ++n) {
      *reinterpret_cast<float2*>(dk_row + n * 8) =
          make_float2(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      *reinterpret_cast<float2*>(dv_row + n * 8) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

template <int D, int kBlock>
int launch_fwd(View q, View k, View v, const void* mask, View out, void* lse, int bh, int heads,
               int tq, int tk, float scale, int causal, cudaStream_t stream) {
  using Shape = FwdShape<D, kBlock>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_fwd_kernel<D, kBlock>, Shape::kSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_fwd_kernel<D, kBlock><<<grid, Shape::kCtaThreads, Shape::kSmemBytes, stream>>>(
      ptr<const bf16>(q), q.s, ptr<const bf16>(k), k.s, ptr<const bf16>(v), v.s,
      static_cast<const uint8_t*>(mask), ptr<bf16>(out), out.s, static_cast<float*>(lse),
      heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, int kBlock>
int launch_dq(View q, View k, View v, View g, const void* lse, const void* delta,
              const void* mask, View dq, int bh, int heads, int tq, int tk, float scale,
              int causal, cudaStream_t stream) {
  using Shape = DqShape<D, kBlock>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_dq_kernel<D, kBlock>, Shape::kSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_dq_kernel<D, kBlock><<<grid, Shape::kCtaThreads, Shape::kSmemBytes, stream>>>(
      ptr<const bf16>(q), q.s, ptr<const bf16>(k), k.s, ptr<const bf16>(v), v.s,
      ptr<const bf16>(g), g.s, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), ptr<bf16>(dq), dq.s, heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, int kBlock>
int launch_dkv(View q, View k, View v, View g, const void* lse, const void* delta,
               const void* mask, View dk, View dv, int bh, int heads, int tq, int tk, float scale,
               int causal, cudaStream_t stream) {
  using Shape = DkvShape<D, kBlock>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_dkv_kernel<D, kBlock>, Shape::kSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tk + kBlock - 1) / kBlock);
  flash_dkv_kernel<D, kBlock><<<grid, Shape::kCtaThreads, Shape::kSmemBytes, stream>>>(
      ptr<const bf16>(q), q.s, ptr<const bf16>(k), k.s, ptr<const bf16>(v), v.s,
      ptr<const bf16>(g), g.s, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), ptr<bf16>(dk), dk.s, ptr<bf16>(dv), dv.s, heads, tq,
      tk, scale, causal);
  return (int)cudaGetLastError();
}


// The 3xTF32 instances opt in to more than 48 KB of shared memory as the
// bf16 launchers do (two 64-row f32 stages of two tiles take 70 KB; K2
// and K3 f32 add a CTA's split dO or V, 32 KB more at D = 64; D = 128
// and 256 take more, design notes 5 and 7).
template <int D, int kBlock>
int launch_fwd_f32(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                   int heads, int tq, int tk, float scale, int causal, cudaStream_t stream) {
  using Shape = FwdF32Shape<D, kBlock>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_fwd_f32_kernel<D, kBlock>, Shape::kSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_fwd_f32_kernel<D, kBlock><<<grid, Shape::kCtaThreads, Shape::kSmemBytes, stream>>>(
      ptr<const float>(q), q.s, ptr<const float>(k), k.s, ptr<const float>(v), v.s,
      static_cast<const uint8_t*>(mask), ptr<float>(out), out.s, static_cast<float*>(lse),
      heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, int kBlock>
int launch_dq_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                  const void* mask, View dq, int bh, int heads, int tq, int tk, float scale,
                  int causal, cudaStream_t stream) {
  using Shape = DqF32Shape<D, kBlock>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_dq_f32_kernel<D, kBlock>, Shape::kSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_dq_f32_kernel<D, kBlock><<<grid, Shape::kCtaThreads, Shape::kSmemBytes, stream>>>(
      ptr<const float>(q), q.s, ptr<const float>(k), k.s, ptr<const float>(v), v.s,
      ptr<const float>(g), g.s, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), ptr<float>(dq), dq.s, heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, int kBlock>
int launch_dkv_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                   const void* mask, View dk, View dv, int bh, int heads, int tq, int tk,
                   float scale, int causal, cudaStream_t stream) {
  using Shape = DkvF32Shape<D, kBlock>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_dkv_f32_kernel<D, kBlock>, Shape::kSmemBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (tk + kBlock - 1) / kBlock);
  flash_dkv_f32_kernel<D, kBlock><<<grid, Shape::kCtaThreads, Shape::kSmemBytes, stream>>>(
      ptr<const float>(q), q.s, ptr<const float>(k), k.s, ptr<const float>(v), v.s,
      ptr<const float>(g), g.s, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), ptr<float>(dk), dk.s, ptr<float>(dv), dv.s, heads, tq,
      tk, scale, causal);
  return (int)cudaGetLastError();
}


// f(D, kBlock) as integral constants for a (head dim, tile) pair that the
// mma.sync K1-K3 in bf16 are built for, cudaErrorInvalidValue for any
// other: the short tile, at every head dim. The TMA-fed kernels take the
// long tiles of K1-K3 at every head dim (flash_attention_tma.cu,
// swt::tma_tile); only the pairs listed here are instantiated.
template <typename F>
int by_shape(int d, int tile, F&& f) {
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I256 = std::integral_constant<int, 256>;
  if (d == 256 && tile == 32) return f(I256{}, I32{});
  if (d == 128 && tile == 32) return f(I128{}, I32{});
  if (d == 64 && tile == 32) return f(I64{}, I32{});
  if (d == 32 && tile == 32) return f(I32{}, I32{});
  return (int)cudaErrorInvalidValue;
}

// The same for the 3xTF32 instances of K1-K3: the short tile (16, one
// warp per CTA) at every head dim, and with kLong32 (K1 only) the long one
// (64) at D = 32; the TMA-fed kernels of flash_attention_tma_f32.cu take
// the long tile of K1 at D = 64, 128 and 256 and of K2 and K3 at D = 32,
// 64, 128 and 256 (swt::tma_f32_tile).
template <bool kLong32 = false, typename F>
int by_shape_tf32_short(int d, int tile, F&& f) {
  using I16 = std::integral_constant<int, 16>;
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I256 = std::integral_constant<int, 256>;
  if (d == 256 && tile == 16) return f(I256{}, I16{});
  if (d == 128 && tile == 16) return f(I128{}, I16{});
  if (d == 64 && tile == 16) return f(I64{}, I16{});
  if (d == 32 && tile == 16) return f(I32{}, I16{});
  if constexpr (kLong32) {
    if (d == 32 && tile == 64) return f(I32{}, I64{});
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel kKernel of 0-2 (K1-K3 in bf16, on mma.sync).
template <int kKernel, int D, int kBlock>
int occupancy_of_bf16(int* out) {
  if constexpr (kKernel == 0)
    return occupancy(flash_fwd_kernel<D, kBlock>, FwdShape<D, kBlock>::kCtaThreads,
                     FwdShape<D, kBlock>::kSmemBytes, out);
  else if constexpr (kKernel == 1)
    return occupancy(flash_dq_kernel<D, kBlock>, DqShape<D, kBlock>::kCtaThreads,
                     DqShape<D, kBlock>::kSmemBytes, out);
  else
    return occupancy(flash_dkv_kernel<D, kBlock>, DkvShape<D, kBlock>::kCtaThreads,
                     DkvShape<D, kBlock>::kSmemBytes, out);
}

// occupancy_of_bf16 of kernel kKernel (0-2) at (d, tile), by_shape's pairs.
template <int kKernel>
int bf16_occupancy(int d, int tile, int* out) {
  return by_shape(d, tile, [&](auto dd, auto tt) {
    return occupancy_of_bf16<kKernel, decltype(dd)::value, decltype(tt)::value>(out);
  });
}

// Kernel kKernel of 3-5 (K1-K3 in f32, on mma.sync).
template <int kKernel, int D, int kBlock>
int occupancy_of_tf32(int* out) {
  if constexpr (kKernel == 3)
    return occupancy(flash_fwd_f32_kernel<D, kBlock>, FwdF32Shape<D, kBlock>::kCtaThreads,
                     FwdF32Shape<D, kBlock>::kSmemBytes, out);
  else if constexpr (kKernel == 4)
    return occupancy(flash_dq_f32_kernel<D, kBlock>, DqF32Shape<D, kBlock>::kCtaThreads,
                     DqF32Shape<D, kBlock>::kSmemBytes, out);
  else
    return occupancy(flash_dkv_f32_kernel<D, kBlock>, DkvF32Shape<D, kBlock>::kCtaThreads,
                     DkvF32Shape<D, kBlock>::kSmemBytes, out);
}

// occupancy_of_tf32 of kernel kKernel (3-5) at (d, tile), by_shape_tf32_short's
// pairs (K1's with the long tile at D = 32).
template <int kKernel>
int tf32_occupancy(int d, int tile, int* out) {
  return by_shape_tf32_short<kKernel == 3>(d, tile, [&](auto dd, auto tt) {
    return occupancy_of_tf32<kKernel, decltype(dd)::value, decltype(tt)::value>(out);
  });
}

}  // namespace

// Plain C interface, loaded with ctypes. Every entry makes `device`
// current for this library's CUDA runtime (its own copy, linked
// statically, so PyTorch's current device does not carry over), launches
// on `stream`, and returns the cudaError_t of the launch (0 = launched);
// an unsupported head dim or tile, or a View that breaks the 16-byte rule
// (aligned16), returns cudaErrorInvalidValue. q, k, v, g, out, dq, dk and
// dv are (B, H, T, D) views (View: base and strides, B = bh / heads); lse
// and delta are packed (bh, tq) f32. `tile` is the tile that the wrapper's
// launch_config chose for the instance: 32 or the long tile for the bf16
// instances, 16 or the long tile for the f32 ones; in bf16 the long tile
// of K1 and K2 (128 query rows) and of K3 (128 keys, 64 at D = 256)
// launches the TMA-fed kernels of flash_attention_tma.cu, and in f32 the
// long tile of K1 at D = 64, 128 and 256 (64 query rows) and of K2 and K3
// at D = 32-256 (64 query rows or keys; at D = 32 K2's kRows and K3's
// kKeys) those of flash_attention_tma_f32.cu. Nothing here synchronises.
extern "C" {

int swt_flash_fwd(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                  int heads, int tq, int tk, int d, int tile, float scale, int causal, int device,
                  void* stream) {
  if (!fwd_views_ok(2, q, k, v, out, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (swt::tma_tile(0, d, tile))
    return swt::launch_fwd_tma(q, k, v, mask, out, lse, bh, heads, tq, tk, d, scale, causal, s);
  return by_shape(d, tile, [&](auto dd, auto tt) {
    return launch_fwd<decltype(dd)::value, decltype(tt)::value>(
        q, k, v, mask, out, lse, bh, heads, tq, tk, scale, causal, s);
  });
}

int swt_flash_dq(View q, View k, View v, View g, const void* lse, const void* delta,
                 const void* mask, View dq, int bh, int heads, int tq, int tk, int d, int tile,
                 float scale, int causal, int device, void* stream) {
  if (!dq_views_ok(2, q, k, v, g, dq, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (swt::tma_tile(1, d, tile))
    return swt::launch_dq_tma(q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, d, scale,
                              causal, s);
  return by_shape(d, tile, [&](auto dd, auto tt) {
    return launch_dq<decltype(dd)::value, decltype(tt)::value>(
        q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, scale, causal, s);
  });
}

int swt_flash_dkv(View q, View k, View v, View g, const void* lse, const void* delta,
                  const void* mask, View dk, View dv, int bh, int heads, int tq, int tk, int d,
                  int tile, float scale, int causal, int device, void* stream) {
  if (!dkv_views_ok(2, q, k, v, g, dk, dv, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (swt::tma_tile(2, d, tile))
    return swt::launch_dkv_tma(q, k, v, g, lse, delta, mask, dk, dv, bh, heads, tq, tk, d, scale,
                               causal, s);
  return by_shape(d, tile, [&](auto dd, auto tt) {
    return launch_dkv<decltype(dd)::value, decltype(tt)::value>(
        q, k, v, g, lse, delta, mask, dk, dv, bh, heads, tq, tk, scale, causal, s);
  });
}

// The f32 instances of K1-K3, with the bf16 entries' arguments.
int swt_flash_fwd_f32(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                      int heads, int tq, int tk, int d, int tile, float scale, int causal,
                      int device, void* stream) {
  if (!fwd_views_ok(4, q, k, v, out, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (swt::tma_f32_tile(0, d, tile))
    return swt::launch_fwd_tma_f32(q, k, v, mask, out, lse, bh, heads, tq, tk, d, scale, causal,
                                   s);
  return by_shape_tf32_short<true>(d, tile, [&](auto dd, auto tt) {
    return launch_fwd_f32<decltype(dd)::value, decltype(tt)::value>(
        q, k, v, mask, out, lse, bh, heads, tq, tk, scale, causal, s);
  });
}

int swt_flash_dq_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                     const void* mask, View dq, int bh, int heads, int tq, int tk, int d,
                     int tile, float scale, int causal, int device, void* stream) {
  if (!dq_views_ok(4, q, k, v, g, dq, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (swt::tma_f32_tile(1, d, tile))
    return swt::launch_dq_tma_f32(q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, d, scale,
                                  causal, s);
  return by_shape_tf32_short(d, tile, [&](auto dd, auto tt) {
    return launch_dq_f32<decltype(dd)::value, decltype(tt)::value>(
        q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, scale, causal, s);
  });
}

int swt_flash_dkv_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                      const void* mask, View dk, View dv, int bh, int heads, int tq, int tk,
                      int d, int tile, float scale, int causal, int device, void* stream) {
  if (!dkv_views_ok(4, q, k, v, g, dk, dv, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (swt::tma_f32_tile(2, d, tile))
    return swt::launch_dkv_tma_f32(q, k, v, g, lse, delta, mask, dk, dv, bh, heads, tq, tk, d,
                                   scale, causal, s);
  return by_shape_tf32_short(d, tile, [&](auto dd, auto tt) {
    return launch_dkv_f32<decltype(dd)::value, decltype(tt)::value>(
        q, k, v, g, lse, delta, mask, dk, dv, bh, heads, tq, tk, scale, causal, s);
  });
}

// Occupancy of kernel 0 (K1), 1 (K2), 2 (K3), or 3-5 (their f32
// instances) at head dim d and tile `tile` (16 or the long tile for kernels
// 3-5, the TMA-fed f32 kernels' but K1's at D = 32; for the others 32,
// or their long tile, the TMA-fed kernels': K1 and K2 128, K3 128 or, at
// D = 256, 64), or 6-8 (the wide bf16
// instances) and 9-11 (the wide f32 ones) at a wide d and their tile
// (flash_attention_wide.cu), on `device`: writes {CTAs per SM, threads per
// CTA, dynamic shared bytes, registers per thread} to out[0..3].
int swt_flash_occupancy(int kernel, int d, int tile, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kernel >= 6) return swt::wide_occupancy(kernel, d, tile, out);
  if (kernel >= 3) {
    if (swt::tma_f32_tile(kernel - 3, d, tile)) return swt::tma_f32_occupancy(kernel - 3, d, out);
    if (kernel == 3) return tf32_occupancy<3>(d, tile, out);
    if (kernel == 4) return tf32_occupancy<4>(d, tile, out);
    return tf32_occupancy<5>(d, tile, out);
  }
  if (swt::tma_tile(kernel, d, tile)) return swt::tma_occupancy(kernel, d, out);
  if (kernel == 0) return bf16_occupancy<0>(d, tile, out);
  if (kernel == 1) return bf16_occupancy<1>(d, tile, out);
  return bf16_occupancy<2>(d, tile, out);
}

const char* swt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
