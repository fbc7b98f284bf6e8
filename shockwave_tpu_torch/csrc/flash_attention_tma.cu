// Flash attention for Hopper (sm_90a): K1 (forward) and K3 (dK, dV) in
// bf16 at head dims 64, 128 and 256 on sequences past the short tile
// (ops/flash_attention.py:launch_config: max(Tq, Tk) > 32), fed by TMA.
// They replace _fa_kernel (:40) and _dkv_kernel (:222) of
// shockwave_tpu/ops/flash_attention.py there, with the narrow kernels'
// arguments and masking (flash_attention.cu): causal entries -1e30, then
// the key bias (-1e30 for a masked key, so an entry both causal-masked and
// padded sits at -2e30), -inf past a ragged end, the running max from
// -1e30, and p = 0 where s <= -5e29 in the backward. The narrow mma.sync
// kernels keep the short tile (a wgmma tile has 64 rows) and D = 32; K2
// keeps its mma.sync kernel.
//
// One CTA shape in both (kTmaThreads = 384 threads):
// - warpgroup 0 is the producer. After setmaxnreg lowers it to
//   kProducerRegs registers a thread, its first warp issues every TMA load
//   and computes the small per-tile vectors (K1: the key bias; K3: lse and
//   delta) into shared memory; its other warps exit.
// - warpgroups 1 and 2 are the consumers. setmaxnreg raises them to
//   kConsumerRegs; they run only wgmma and the elementwise terms.
// Operands arrive by TMA (cp.async.bulk.tensor.3d) through 3-D tensor maps
// over (BH, T, D), boxes of 64 columns (128 bytes, the 128-byte swizzle's
// row) by the tile's rows: rows past a ragged T land as zeros and never
// reach into the next (batch, head)'s rows. A tile of R rows and D columns
// is D / 64 such boxes, each R rows of 128 bytes in wgmma's 128-byte
// swizzle, 1 KB aligned. Each streamed stage has a "full" mbarrier (the
// producer's arrive.expect_tx, completed by the copies' bytes and the
// producer warp's arrivals after its plain stores) and an "empty" one (one
// arrival per consumer warp after its last wgmma on the stage). Products
// read the tiles in place through matrix descriptors: K-major for the
// scores, MN-major (the tile row-major, as it landed) for the B operand of
// P.V, P^T.dO and dS^T.Q.
//
// Masking is chosen per tile by template, not per element: tiles that
// need no causal compare, no key bias and no ragged-end test (K1: keys
// wholly below the group's rows, no key mask, inside Tk; K3: queries wholly
// at or past the group's keys, inside Tq) take the plain step, the others
// the masked one, in separate loops, so no wgmma sits behind a per-step
// branch.
#include <cuda.h>  // CUtensorMap and its enums; the encode call is reached at run time

#include "flash_attention_common.cuh"

namespace {

constexpr int kTmaThreads = 384;  // a producer warpgroup, two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 384 x 168, what the launch gives
constexpr int kBox = 64;            // columns of a TMA box: 128 bytes of bf16
constexpr int kAlign = 1024;        // the 128-byte swizzle repeats every 1 KB
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

// The box of `map` at (col, row, bh) into shared memory at dst, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, uint64_t* bar,
                                         int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(bh)
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

// Load the D / 64 boxes of rows [row0, row0 + rows) of (batch, head) bh
// into the tile at dst (box c at dst + c rows 64).
template <int D>
__device__ __forceinline__ void tma_load_tile(bf16* dst, const CUtensorMap& map, uint64_t* bar,
                                              int rows, int row0, int bh) {
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) tma_load(dst + c * rows * kBox, map, bar, c * kBox, row0, bh);
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

// ---------------------------------------------------------------------------
// K1, forward: flash_fwd_tma_kernel<D>.
//
// Grid (BH, q-tiles of 128 rows), heaviest causal tile first. Consumer
// group G owns query rows 64G..64G + 63 of the CTA's tile. The producer
// loads the 128 x D Q tile once, then K and V tiles of kN keys (128 at D =
// 64 and 128, 64 at D = 256) through a ring of kStages, K and V on
// separate "full" and "empty" barriers (S can start before V has landed,
// and K's slot is released as soon as S and the softmax have read it and
// the tile's key bias (key_bias: 0, -1e30 or -inf), which comes with K).
// Per k-tile a group:
// 1. waits for K and forms S = Q.K^T (64 x kN f32) with SS wgmma, both
//    operands K-major from the swizzled tiles, D / 16 instructions of
//    m64nkNk16;
// 2. scales and masks S in registers (masked tiles only: causal -1e30,
//    then the bias), takes the online softmax in base 2 (row max and sum
//    reduced over the quad with two shuffles; O rescaled in registers),
//    and packs P to bf16 A fragments in registers;
// 3. waits for V and adds P.V to O with RS wgmma (m64n64k16 per 64 output
//    columns, V MN-major), then releases the stage.
// 4. Overlap: tile j's S is issued right before tile j - 1's P.V, the
//    softmax of S_j runs while P_{j-1}.V is in flight, and O takes S_j's
//    correction once P.V has landed; the two groups drift apart on their
//    own. K3's ping-pong of the groups' turns (turn_wait, turn_pass) made
//    K1 1.1x slower at D = 64 and 1.3-1.5x at D = 128 and 256 on the card
//    (PERF.md), so K1 issues without turns.
// The epilogue normalises O, stages it as bf16 through the group's own Q
// rows (in the same swizzle) and writes 16-byte stores; lse once per row.
//
// Bound on an H100 SXM (989 bf16 TFLOP/s, 3.35 TB/s): at the bench shape
// (4, 2048, 8, D) causal, 17.2 / 34.4 / 68.8 GFLOP at D = 64 / 128 / 256:
// 17.4 / 34.8 / 69.5 us by operations.
//
// Shared memory (1 KB alignment, Q, the ring, the bias, the barriers):
// D = 64: 16 KB + 4 x 32 KB; D = 128: 32 KB + 2 x 64 KB; D = 256: 64 KB +
// 2 x 64 KB. One CTA per SM (the consumers' registers allow no second).
// ---------------------------------------------------------------------------
template <int D>
struct TmaFwdShape {
  static constexpr int kRows = 128;              // query rows a CTA owns
  static constexpr int kN = D == 256 ? 64 : 128;  // keys a k-tile
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kTileBytes = kN * D * 2;  // one K or V tile
  static constexpr int kQBytes = kRows * D * 2;
  // Byte offsets from the 1 KB aligned base.
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBias = kV + kStages * kTileBytes;
  static constexpr int kBars = kBias + kStages * kN * 4;
  static constexpr size_t kSmemBytes = kAlign + kBars + (1 + 4 * kStages) * 8;
  static_assert(kSmemBytes <= kTmaMaxSmem, "K1's tiles do not fit a CTA");
};

// 2^x by the special-function unit (inputs far below -126 give 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// K3's consumer groups take turns issuing their products ("ping-pong"):
// group G issues between turn_wait (named barrier 3 + G) and turn_pass,
// which opens the other group's turn, so that one group's gradient terms
// run while the other's products keep the tensor cores busy. Group 1
// opens group 0's first turn (turn_open) and skips its last pass, so
// every arrival meets a wait.
__device__ __forceinline__ void turn_open(int grp) {
  if (grp == 1) named_arrive(3, 256);
}
__device__ __forceinline__ void turn_wait(int grp) { named_sync(3 + grp, 256); }
__device__ __forceinline__ void turn_pass(int grp, bool last) {
  if (grp == 0 || !last) named_arrive(3 + (grp ^ 1), 256);
}

// Issue S = Q.K^T for the group's 64 rows (gq) against the kN-key tile at
// ck, into sc (zeroed here): D / 16 SS wgmma, committed, not waited.
template <int D>
__device__ __forceinline__ void fwd_issue_scores(float (&sc)[TmaFwdShape<D>::kN / 8][4],
                                                 const bf16* gq, const bf16* ck) {
  using Shape = TmaFwdShape<D>;
  constexpr int kN = Shape::kN;
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
  }
  wgmma_fence();
  wgmma_hold(sc);
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    const uint64_t da = wgmma_desc(gq + c * Shape::kRows * kBox, 16);
    const uint64_t db = wgmma_desc(ck + c * kN * kBox, 16);
#pragma unroll
    for (int kk = 0; kk < kBox / 16; ++kk) {
      if constexpr (kN == 128)
        wgmma_ss_n128(sc, da + 2 * kk, db + 2 * kk);
      else
        wgmma_ss(sc, da + 2 * kk, db + 2 * kk);
    }
  }
  wgmma_commit();
}

// Issue O += P.V for the kN-key tile whose V is at cv, P the bf16 A
// fragments pa: RS wgmma, m64n64k16 per 64 output columns and 16 keys,
// V MN-major; committed, not waited.
template <int D>
__device__ __forceinline__ void fwd_issue_pv(float (&o)[D / kBox][8][4],
                                             const uint32_t (&pa)[TmaFwdShape<D>::kN / 16][4],
                                             const bf16* cv) {
  constexpr int kN = TmaFwdShape<D>::kN;
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) wgmma_hold(o[c]);
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    const uint64_t db = wgmma_desc(cv + c * kN * kBox, kN * kBox * 2);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) wgmma_rs(o[c], pa[kk], db + (16 * 128 >> 4) * kk);
  }
  wgmma_commit();
}

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

template <int kN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kN / 16][4], const float (&sc)[kN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) accum_to_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                         float* __restrict__ lse, int heads, int tq, int tk, float scale,
                         int causal) {
  using Shape = TmaFwdShape<D>;
  constexpr int kN = Shape::kN, kS = Shape::kStages, kRows = Shape::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kAlign - smem_addr(smem) % kAlign) % kAlign;
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* sk = reinterpret_cast<bf16*>(base + Shape::kK);
  bf16* sv = reinterpret_cast<bf16*>(base + Shape::kV);
  float* sbias = reinterpret_cast<float*>(base + Shape::kBias);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(base + Shape::kBars);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kS;
  uint64_t* empty_k = full_v + kS;
  uint64_t* empty_v = empty_k + kS;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // causal: the longest k loops start first
  int nk = (tk + kN - 1) / kN;
  if (causal) nk = min(nk, (q0 + kRows - 1) / kN + 1);  // k-tiles past the diagonal see nothing

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full_k[s], 32);  // the producer warp: expect_tx, and the bias stored
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);  // one arrival per consumer warp
      mbar_init(&empty_v[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, Shape::kQBytes);
      tma_load_tile<D>(sq, q_map, bar_q, kRows, q0, bh);
    }
    // K runs one tile ahead of V: a consumer group holds tile j's K and
    // tile j - 1's V at once, and K_{j+1} must not wait behind V_j's slot.
    auto load_k = [&](int j) {
      const int s = stage_of<kS>(j);
      mbar_wait(&empty_k[s], phase_of<kS>(j) ^ 1);
      for (int i = lane; i < kN; i += 32) sbias[s * kN + i] = key_bias(mask_row, j * kN + i, tk);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_k[s], Shape::kTileBytes);
        tma_load_tile<D>(sk + s * kN * D, k_map, &full_k[s], kN, j * kN, bh);
      } else {
        mbar_arrive(&full_k[s]);
      }
    };
    load_k(0);
    for (int j = 0; j < nk; ++j) {
      if (j + 1 < nk) load_k(j + 1);
      const int s = stage_of<kS>(j);
      mbar_wait(&empty_v[s], phase_of<kS>(j) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_v[s], Shape::kTileBytes);
        tma_load_tile<D>(sv + s * kN * D, v_map, &full_v[s], kN, j * kN, bh);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int grp = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int r0 = q0 + 64 * grp;  // the group's first row
  const int row[2] = {r0 + warp * 16 + (lane >> 2), r0 + warp * 16 + (lane >> 2) + 8};
  bf16* gq = sq + grp * 64 * kBox;  // the group's rows of each Q box
  float o[D / kBox][8][4];
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][n][e] = 0.f;
    }
  }
  float m[2] = {kNegInf, kNegInf};  // running max of rows row[0], row[1] (base 2)
  float l[2] = {0.f, 0.f};          // this lane's part of their normalisers
  const float scale2 = scale * kLog2e;

  // Tiles from `plain_end` on need a mask: the first whose keys pass a row
  // of the group (causal), or pass Tk; every tile where a key mask is given.
  int plain_end = min(nk, tk / kN);
  if (causal) plain_end = min(plain_end, (r0 + 1) / kN);
  if (mask != nullptr) plain_end = 0;

  // Tile j's S is issued right before tile j - 1's P.V, and its softmax
  // runs while that P.V is in flight; O takes tile j's correction once
  // P.V has landed (design note 4).
  float sc[kN / 8][4], corr[2];
  uint32_t pa[kN / 16][4];
  mbar_wait(bar_q, 0);
  mbar_wait(&full_k[0], 0);
  fwd_issue_scores<D>(sc, gq, sk);
  wgmma_wait<0>();
  wgmma_hold(sc);
  if (plain_end > 0)
    fwd_softmax<kN, false>(sc, m, l, corr, sbias, 0, row, t, scale2, causal);
  else
    fwd_softmax<kN, true>(sc, m, l, corr, sbias, 0, row, t, scale2, causal);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty_k[0]);  // K and the bias are read
  pack_p<kN>(pa, sc);
  run_tiles(0, plain_end, nk, [&](int j, auto masked) {
    const int s = stage_of<kS>(j), sp = stage_of<kS>(j - 1);
    mbar_wait(&full_k[s], phase_of<kS>(j));
    fwd_issue_scores<D>(sc, gq, sk + s * kN * D);
    mbar_wait(&full_v[sp], phase_of<kS>(j - 1));
    fwd_issue_pv<D>(o, pa, sv + sp * kN * D);
    wgmma_wait<1>();
    wgmma_hold(sc);
    fwd_softmax<kN, decltype(masked)::value>(sc, m, l, corr, sbias + s * kN, j * kN, row, t,
                                             scale2, causal);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_k[s]);  // K and the bias are read
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / kBox; ++c) wgmma_hold(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_v[sp]);
#pragma unroll
    for (int c = 0; c < D / kBox; ++c) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[c][n][0] *= corr[0];
        o[c][n][1] *= corr[0];
        o[c][n][2] *= corr[1];
        o[c][n][3] *= corr[1];
      }
    }
    pack_p<kN>(pa, sc);
  }, 1);
  {  // the last tile's P.V
    const int sp = stage_of<kS>(nk - 1);
    mbar_wait(&full_v[sp], phase_of<kS>(nk - 1));
    wgmma_fence();
    fwd_issue_pv<D>(o, pa, sv + sp * kN * D);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / kBox; ++c) wgmma_hold(o[c]);
  }

  float lc[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    lc[h] = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / lc[h];
  }
  // The group's own Q rows are free once all its warps are past their
  // last S: O goes there as bf16 in the same swizzle (unit u of row r at u
  // ^ (r % 8)), then out in 16-byte stores of whole 128-byte rows.
  named_sync(1 + grp, 128);
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    bf16* box = gq + c * kRows * kBox;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + 8 * h;
        store2(box + r * kBox + ((n ^ (r & 7)) * 8) + 2 * t, o[c][n][2 * h] * inv[h],
               o[c][n][2 * h + 1] * inv[h]);
      }
    }
  }
  named_sync(1 + grp, 128);
  bf16* out_b = out + (size_t)bh * tq * D;
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    const bf16* box = gq + c * kRows * kBox;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 16 * i, u = tid & 7;
      if (r0 + r < tq)
        *reinterpret_cast<uint4*>(out_b + (size_t)(r0 + r) * D + c * kBox + u * 8) =
            *reinterpret_cast<const uint4*>(box + r * kBox + (u ^ (r & 7)) * 8);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < tq) lse[(size_t)bh * tq + row[h]] = m[h] / kLog2e + logf(lc[h]);
  }
}

// ---------------------------------------------------------------------------
// K3, dK and dV: flash_dkv_tma_kernel<D>.
//
// Grid (BH, k-tiles of kKeys keys); a CTA walks the 64-query tiles from
// the causal diagonal on. K and V come by TMA once; Q and dO tiles stream
// through a ring of kStages on one "full" barrier each, with the tile's
// lse and delta, which the producer warp reads with plain loads (0 past
// Tq). Every product is wgmma: S^T = K.Q^T and dP^T = V.dO^T as SS (both
// K-major), dV += P^T.dO and dK += dS^T.Q as RS (P^T and dS^T packed from
// the score accumulators, dO and Q MN-major), each once per tile pair.
// - D = 64 and 128: kKeys = 128; consumer group G owns keys 64G..64G + 63
//   and their dK and dV (D / 2 + D / 2 f32 registers a thread), and forms
//   all four products of its keys.
// - D = 256: kKeys = 64, since a group's 64 x 256 f32 sum takes 128
//   registers a thread: group 0 forms S^T, turns it into P^T and owns dV
//   (dV += P^T.dO); it hands P^T, in f32 as _dkv_kernel keeps it, to group
//   1 through a 16 KB exchange in shared memory (named barriers 1 and 2,
//   one wait a group per tile). Group 1 forms dP^T and owns dK (dK +=
//   dS^T.Q). Each score tile is formed once (the mma.sync kernel formed S^T
//   and dP^T twice at D = 256).
// The terms (dkv_probs, dkv_grads): P^T = exp(S^T scale - lse) after the
// causal -1e30 and the key bias, p = 0 where that is <= -5e29 (and past
// Tq), as 2^(S^T scale log2(e) - lse log2(e)) with lse in base 2 from the
// producer; dS^T = P^T (dP^T - delta) scale. At D = 64 and 128 the groups
// take turns issuing (K1's ping-pong, two turns a tile: the score
// products, then the output products), so that one group's terms run
// under the other's products. dK and dV leave straight from the
// accumulators.
//
// Bound on an H100 SXM: at the bench shape (4, 2048, 8, D) causal, 34.4 /
// 68.8 / 137.5 GFLOP at D = 64 / 128 / 256: 34.8 / 69.5 / 139 us by
// operations.
//
// Shared memory: K, V, the ring (Q and dO, lse and delta) and at D = 256
// the exchange: D = 64: 32 KB + 4 x 16 KB; D = 128: 64 KB + 3 x 32 KB; D =
// 256: 64 KB + 2 x 64 KB + 16 KB.
// ---------------------------------------------------------------------------
template <int D>
struct TmaDkvShape {
  static constexpr bool kSplit = D == 256;  // group 0 owns dV, group 1 dK
  static constexpr int kKeys = kSplit ? 64 : 128;
  static constexpr int kQ = 64;  // queries a q-tile
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr int kKVBytes = kKeys * D * 2;  // K or V
  static constexpr int kQBytes = kQ * D * 2;      // a Q or dO tile
  static constexpr int kV = kKVBytes;
  static constexpr int kQs = 2 * kKVBytes;
  static constexpr int kGs = kQs + kStages * kQBytes;
  static constexpr int kRowTerms = kGs + kStages * kQBytes;  // lse, then delta, per stage
  static constexpr int kExchange = kRowTerms + 2 * kStages * kQ * 4;
  static constexpr int kBars = kExchange + (kSplit ? kKeys * kQ * 4 : 0);
  static constexpr size_t kSmemBytes = kAlign + kBars + (1 + 2 * kStages) * 8;
  static_assert(kSmemBytes <= kTmaMaxSmem, "K3's tiles do not fit a CTA");
};

// The lane's p for its key row h (keys key[h]) against query `query` of
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

// The lane's P^T in st from S^T (dkv_p), its keys key[h] against the
// queries of columns 8n + 2t + (e & 1) of the q-tile at q0.
template <bool kMasked>
__device__ __forceinline__ void dkv_probs(float (&st)[8][4], const float* lse2, int q0, int t,
                                          const int (&key)[2], const bool (&key_live)[2],
                                          int tq, float scale2, int causal) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 lq = *reinterpret_cast<const float2*>(lse2 + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[n][e] = dkv_p<kMasked>(st[n][e], (e & 1) ? lq.y : lq.x, q0 + 8 * n + 2 * t + (e & 1),
                                e >> 1, key, key_live, tq, scale2, causal);
  }
}

// P^T and dS^T = P^T (dP^T - delta) scale from S^T (st) and dP^T (dpt),
// packed 16 queries at a time into the A fragments pa and dsa as they are
// formed, so that few of the f32 terms are live at once.
template <bool kMasked>
__device__ __forceinline__ void dkv_terms(uint32_t (&pa)[4][4], uint32_t (&dsa)[4][4],
                                          float (&st)[8][4], float (&dpt)[8][4],
                                          const float* lse2, const float* delta, int q0, int t,
                                          const int (&key)[2], const bool (&key_live)[2], int tq,
                                          float scale, float scale2, int causal) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 2 * kk; n < 2 * kk + 2; ++n) {
      const float2 lq = *reinterpret_cast<const float2*>(lse2 + 8 * n + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = dkv_p<kMasked>(st[n][e], (e & 1) ? lq.y : lq.x,
                                       q0 + 8 * n + 2 * t + (e & 1), e >> 1, key, key_live, tq,
                                       scale2, causal);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
    }
    accum_to_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
    accum_to_a(dsa[kk], dpt[2 * kk], dpt[2 * kk + 1]);
  }
}

// dS^T = P^T (dP^T - delta) scale, in dpt.
__device__ __forceinline__ void dkv_grads(float (&dpt)[8][4], const float (&p)[8][4],
                                          const float* delta_t, int t, float scale) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 dl = *reinterpret_cast<const float2*>(delta_t + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) dpt[n][e] = p[n][e] * (dpt[n][e] - ((e & 1) ? dl.y : dl.x)) * scale;
  }
}

// s (64 x 64 f32) = A.B^T over D: A the group's 64 rows of a tile of
// `a_rows` rows at a (box c at a + c a_rows 64), B the 64-row tile at b.
template <int D>
__device__ __forceinline__ void scores_ss(float (&s)[8][4], const bf16* a, int a_rows,
                                          const bf16* b) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  }
  wgmma_fence();
  wgmma_hold(s);
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    const uint64_t da = wgmma_desc(a + c * a_rows * kBox, 16);
    const uint64_t db = wgmma_desc(b + c * 64 * kBox, 16);
#pragma unroll
    for (int kk = 0; kk < kBox / 16; ++kk) wgmma_ss(s, da + 2 * kk, db + 2 * kk);
  }
}

// acc (64 x D) += A.X over the tile's 64 queries: A from the 64 x 64
// accumulator a (P^T or dS^T) packed to bf16, X the 64-row tile at x,
// MN-major, a m64n64k16 per 64 columns and 16 queries. Issued, not waited.
template <int D>
__device__ __forceinline__ void add_product_rs(float (&acc)[D / kBox][8][4],
                                               const uint32_t (&a)[4][4], const bf16* x) {
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    const uint64_t db = wgmma_desc(x + c * 64 * kBox, 64 * kBox * 2);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[c], a[kk], db + (16 * 128 >> 4) * kk);
  }
}

template <int kC>
__device__ __forceinline__ void hold_all(float (&acc)[kC][8][4]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) wgmma_hold(acc[c]);
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_dkv_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap g_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const uint8_t* __restrict__ mask, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int heads, int tq, int tk, float scale,
                         int causal) {
  using Shape = TmaDkvShape<D>;
  constexpr int kS = Shape::kStages, kKeys = Shape::kKeys, kQ = Shape::kQ;
  constexpr int kC = D / kBox;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kAlign - smem_addr(smem) % kAlign) % kAlign;
  bf16* sk = reinterpret_cast<bf16*>(base);
  bf16* sv = reinterpret_cast<bf16*>(base + Shape::kV);
  bf16* sq = reinterpret_cast<bf16*>(base + Shape::kQs);
  bf16* sg = reinterpret_cast<bf16*>(base + Shape::kGs);
  float* slse = reinterpret_cast<float*>(base + Shape::kRowTerms);
  float* sdelta = slse + kS * kQ;
  float* ex = reinterpret_cast<float*>(base + Shape::kExchange);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(base + Shape::kBars);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kS;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;
  const int qt0 = causal ? k0 / kQ : 0;  // q-tiles above the diagonal see none of these keys
  const int tiles = max((tq + kQ - 1) / kQ - qt0, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 32);  // the producer warp: expect_tx, and lse and delta stored
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * Shape::kKVBytes);
      tma_load_tile<D>(sk, k_map, bar_kv, kKeys, k0, bh);
      tma_load_tile<D>(sv, v_map, bar_kv, kKeys, k0, bh);
    }
    const float* lse_b = lse + (size_t)bh * tq;
    const float* delta_b = delta + (size_t)bh * tq;
    for (int i = 0; i < tiles; ++i) {
      const int s = stage_of<kS>(i), q0 = (qt0 + i) * kQ;
      mbar_wait(&empty[s], phase_of<kS>(i) ^ 1);
      for (int r = lane; r < kQ; r += 32) {  // lse in base 2
        const bool valid = q0 + r < tq;
        slse[s * kQ + r] = valid ? lse_b[q0 + r] * kLog2e : 0.f;
        sdelta[s * kQ + r] = valid ? delta_b[q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * Shape::kQBytes);
        tma_load_tile<D>(sq + s * kQ * D, q_map, &full[s], kQ, q0, bh);
        tma_load_tile<D>(sg + s * kQ * D, g_map, &full[s], kQ, q0, bh);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int grp = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int kg0 = k0 + (Shape::kSplit ? 0 : 64 * grp);  // the group's first key
  const int key[2] = {kg0 + warp * 16 + (lane >> 2), kg0 + warp * 16 + (lane >> 2) + 8};
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
  const bool key_live[2] = {key_bias(mask_row, key[0], tk) == 0.f,
                            key_bias(mask_row, key[1], tk) == 0.f};
  const float scale2 = scale * kLog2e;
  const int krow = Shape::kSplit ? 0 : 64 * grp;  // the group's rows of K and V
  const bf16* gk = sk + krow * kBox;
  const bf16* gv = sv + krow * kBox;
  // Tiles [0, masked_end) hold a query before a key of the group (causal);
  // tiles from plain_end on pass Tq.
  const int masked_end = causal ? min(max((kg0 + 62) / kQ + 1 - qt0, 0), tiles) : 0;
  const int plain_end = max(min(tq / kQ - qt0, tiles), masked_end);

  // The group's 64 keys x D of dV and dK (kSplit: group 0's acc is dV,
  // group 1's dK).
  float acc[kC][8][4], acc2[Shape::kSplit ? 1 : kC][8][4];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][n][e] = 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < (Shape::kSplit ? 1 : kC); ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[c][n][e] = 0.f;
    }
  }
  mbar_wait(bar_kv, 0);

  if constexpr (!Shape::kSplit) {
    // acc: dV, acc2: dK. Two turns of the groups' ping-pong a tile: the
    // score products, then the output products.
    if (tiles > 0) turn_open(grp);
    run_tiles(masked_end, plain_end, tiles, [&](int i, auto masked) {
      const int s = stage_of<kS>(i), q0 = (qt0 + i) * kQ;
      const bf16* cq = sq + s * kQ * D;
      const bf16* cg = sg + s * kQ * D;
      mbar_wait(&full[s], phase_of<kS>(i));
      float st[8][4], dpt[8][4];
      turn_wait(grp);
      scores_ss<D>(st, gk, kKeys, cq);
      wgmma_commit();
      scores_ss<D>(dpt, gv, kKeys, cg);
      wgmma_commit();
      turn_pass(grp, false);
      wgmma_wait<0>();
      wgmma_hold(st);
      wgmma_hold(dpt);
      uint32_t pa[4][4], dsa[4][4];
      dkv_terms<decltype(masked)::value>(pa, dsa, st, dpt, slse + s * kQ, sdelta + s * kQ, q0,
                                         t, key, key_live, tq, scale, scale2, causal);
      turn_wait(grp);
      wgmma_fence();
      hold_all(acc);
      hold_all(acc2);
      add_product_rs<D>(acc, pa, cg);
      add_product_rs<D>(acc2, dsa, cq);
      wgmma_commit();
      turn_pass(grp, i == tiles - 1);
      wgmma_wait<0>();
      hold_all(acc);
      hold_all(acc2);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    });
  } else if (grp == 0) {
    // S^T, P^T handed to group 1, dV += P^T.dO.
    run_tiles(masked_end, plain_end, tiles, [&](int i, auto masked) {
      const int s = stage_of<kS>(i), q0 = (qt0 + i) * kQ;
      mbar_wait(&full[s], phase_of<kS>(i));
      float st[8][4];
      scores_ss<D>(st, gk, kKeys, sq + s * kQ * D);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(st);
      dkv_probs<decltype(masked)::value>(st, slse + s * kQ, q0, t, key, key_live, tq, scale2,
                                         causal);
      if (i > 0) named_sync(2, 256);  // group 1 has read the last tile's P^T
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ex[(4 * n + e) * 128 + tid] = st[n][e];
      }
      named_arrive(1, 256);
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) accum_to_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
      wgmma_fence();
      hold_all(acc);
      add_product_rs<D>(acc, pa, sg + s * kQ * D);
      wgmma_commit();
      wgmma_wait<0>();
      hold_all(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    });
    if (tiles > 0) named_sync(2, 256);  // group 1's last arrival
  } else {
    // dP^T, dS^T from group 0's P^T, dK += dS^T.Q.
    for (int i = 0; i < tiles; ++i) {
      const int s = stage_of<kS>(i);
      mbar_wait(&full[s], phase_of<kS>(i));
      float dpt[8][4], p[8][4];
      scores_ss<D>(dpt, gv, kKeys, sg + s * kQ * D);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(dpt);
      named_sync(1, 256);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n][e] = ex[(4 * n + e) * 128 + tid];
      }
      named_arrive(2, 256);
      dkv_grads(dpt, p, sdelta + s * kQ, t, scale);
      uint32_t dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) accum_to_a(dsa[kk], dpt[2 * kk], dpt[2 * kk + 1]);
      wgmma_fence();
      hold_all(acc);
      add_product_rs<D>(acc, dsa, sq + s * kQ * D);
      wgmma_commit();
      wgmma_wait<0>();
      hold_all(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // Rows past Tk are not written.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= tk) continue;
    const size_t at = ((size_t)bh * tk + key[h]) * D;
    bf16* first = Shape::kSplit ? (grp == 0 ? dv : dk) + at : dv + at;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(first + c * kBox + 8 * n + 2 * t, acc[c][n][2 * h], acc[c][n][2 * h + 1]);
    }
    if constexpr (!Shape::kSplit) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
          store2(dk + at + c * kBox + 8 * n + 2 * t, acc2[c][n][2 * h], acc2[c][n][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, launchers, occupancy.
// ---------------------------------------------------------------------------

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

// A 3-D map over the (bh, t, d) bf16 tensor at `base`: boxes of 64
// columns x `rows` rows x one (batch, head), 128-byte swizzle, zeros past
// every edge. Encoded at every call (a few microseconds on the host) and
// passed by value, so a CUDA graph keeps each launch's own.
int tensor_map(CUtensorMap* map, const void* base, int bh, int t, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_fwd_tma_as(const void* q, const void* k, const void* v, const void* mask, void* out,
                      void* lse, int bh, int heads, int tq, int tk, float scale, int causal,
                      cudaStream_t stream) {
  using Shape = TmaFwdShape<D>;
  CUtensorMap maps[3];
  int err = tensor_map(&maps[0], q, bh, tq, D, Shape::kRows);
  if (err == 0) err = tensor_map(&maps[1], k, bh, tk, D, Shape::kN);
  if (err == 0) err = tensor_map(&maps[2], v, bh, tk, D, Shape::kN);
  if (err != 0) return err;
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = set_smem(flash_fwd_tma_kernel<D>, Shape::kSmemBytes, configured);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(bh, (tq + Shape::kRows - 1) / Shape::kRows);
  flash_fwd_tma_kernel<D><<<grid, kTmaThreads, Shape::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tma_as(const void* q, const void* k, const void* v, const void* g, const void* lse,
                      const void* delta, const void* mask, void* dk, void* dv, int bh, int heads,
                      int tq, int tk, float scale, int causal, cudaStream_t stream) {
  using Shape = TmaDkvShape<D>;
  CUtensorMap maps[4];
  int err = tensor_map(&maps[0], q, bh, tq, D, Shape::kQ);
  if (err == 0) err = tensor_map(&maps[1], k, bh, tk, D, Shape::kKeys);
  if (err == 0) err = tensor_map(&maps[2], v, bh, tk, D, Shape::kKeys);
  if (err == 0) err = tensor_map(&maps[3], g, bh, tq, D, Shape::kQ);
  if (err != 0) return err;
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = set_smem(flash_dkv_tma_kernel<D>, Shape::kSmemBytes, configured);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(bh, (tk + Shape::kKeys - 1) / Shape::kKeys);
  flash_dkv_tma_kernel<D><<<grid, kTmaThreads, Shape::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

// f(D) as an integral constant for D in 64, 128, 256; cudaErrorInvalidValue
// for any other.
template <typename F>
int by_tma_head_dim(int d, F&& f) {
  if (d == 64) return f(std::integral_constant<int, 64>{});
  if (d == 128) return f(std::integral_constant<int, 128>{});
  if (d == 256) return f(std::integral_constant<int, 256>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace swt {

// K1's tile is its 128 query rows; K3's its keys (128, or 64 at D = 256).
bool tma_tile(int kernel, int d, int tile) {
  if (d != 64 && d != 128 && d != 256) return false;
  if (kernel == 0) return tile == 128;
  if (kernel == 2) return tile == (d == 256 ? 64 : 128);
  return false;
}

int launch_fwd_tma(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int bh, int heads, int tq, int tk, int d, float scale, int causal,
                   cudaStream_t stream) {
  return by_tma_head_dim(d, [&](auto dd) {
    return launch_fwd_tma_as<decltype(dd)::value>(q, k, v, mask, out, lse, bh, heads, tq, tk,
                                                  scale, causal, stream);
  });
}

int launch_dkv_tma(const void* q, const void* k, const void* v, const void* g, const void* lse,
                   const void* delta, const void* mask, void* dk, void* dv, int bh, int heads,
                   int tq, int tk, int d, float scale, int causal, cudaStream_t stream) {
  return by_tma_head_dim(d, [&](auto dd) {
    return launch_dkv_tma_as<decltype(dd)::value>(q, k, v, g, lse, delta, mask, dk, dv, bh,
                                                  heads, tq, tk, scale, causal, stream);
  });
}

int tma_occupancy(int kernel, int d, int* out) {
  return by_tma_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    if (kernel == 0)
      return occupancy(flash_fwd_tma_kernel<D>, kTmaThreads, TmaFwdShape<D>::kSmemBytes, out);
    if (kernel == 2)
      return occupancy(flash_dkv_tma_kernel<D>, kTmaThreads, TmaDkvShape<D>::kSmemBytes, out);
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace swt
