// Flash attention for Hopper (sm_90a): K1 (forward), K2 (dQ) and K3 (dK,
// dV) in bf16 at head dims 64, 128 and 256, and K1 and K3 at 32, on
// sequences past the short tile (ops/flash_attention.py:launch_config:
// max(Tq, Tk) > 32), fed by TMA. They replace _fa_kernel (:40),
// _dq_kernel (:167) and _dkv_kernel (:222) of
// shockwave_tpu/ops/flash_attention.py there, with the narrow
// kernels' arguments and masking (flash_attention.cu): causal entries
// -1e30, then the key bias (-1e30 for a masked key, so an entry both
// causal-masked and padded sits at -2e30), -inf past a ragged end, the
// running max from -1e30, and p = 0 where s <= -5e29 in the backward. The
// narrow mma.sync kernels keep the short tile (a wgmma tile has 64 rows)
// and K2's long tile at D = 32.
//
// One CTA shape in all three (kTmaThreads = 384 threads):
// - warpgroup 0 is the producer. After setmaxnreg lowers it to
//   kProducerRegs registers a thread (K1: TmaFwdShape's, which at D = 32
//   fits two CTAs an SM), its first warp issues every TMA load
//   and computes the small per-tile vectors (K1 and K2: the key bias; K3:
//   lse and delta) into shared memory; its other warps exit.
// - warpgroups 1 and 2 are the consumers. setmaxnreg raises them to
//   kConsumerRegs; they run only wgmma and the elementwise terms.
// Operands arrive by TMA (cp.async.bulk.tensor.4d) through 4-D tensor maps
// over (D, T, H, B) with the views' strides (the model's (B, T, H, D)
// tensors in place), boxes of kBoxCols<D> columns by the tile's rows by
// one head of one batch: rows past a ragged T land as zeros and never
// reach into another (batch, head)'s rows. A box is 64 columns (128 bytes,
// the 128-byte swizzle's row) at D >= 64, and at D = 32 the whole row, 32
// columns (64 bytes) in the 64-byte swizzle: a zero-filled 64-column box
// would double the shared memory and the products of kernels that the
// exponentials bound there. A tile of R rows and D columns is D /
// kBoxCols<D> such boxes, each R rows in wgmma's swizzle of that row
// width, aligned to its pattern (1 KB, or 512 bytes). Each streamed stage
// has a "full" mbarrier (the producer's arrive.expect_tx, completed by the copies' bytes and the
// producer warp's arrivals after its plain stores) and an "empty" one (one
// arrival per consumer warp after its last wgmma on the stage). Products
// read the tiles in place through matrix descriptors: K-major for the
// scores, MN-major (the tile row-major, as it landed) for the B operand of
// P.V, dS.K, P^T.dO and dS^T.Q.
//
// Masking is chosen per tile by template, not per element: tiles that
// need no causal compare, no key bias and no ragged-end test (K1 and K2:
// keys wholly below the group's rows, no key mask, inside Tk; K3: queries
// wholly at or past the group's keys, inside Tq) take the plain step, the
// others the masked one, in separate loops, so no wgmma sits behind a
// per-step branch.
#include "flash_attention_tma.cuh"

namespace {

constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 384 x 168, what the launch gives
// Columns of a TMA box at head dim D: one 128-byte swizzle row of bf16,
// or at D = 32 the whole 64-byte row (tensor_map picks the swizzle).
template <int D>
constexpr int kBoxCols = D == 32 ? 32 : 64;

// A descriptor of a tile of head dim D's boxes (wgmma_desc in the swizzle
// of their rows).
template <int D>
__device__ __forceinline__ uint64_t box_desc(const void* p, uint32_t lbo) {
  return wgmma_desc<2 * kBoxCols<D>>(p, lbo);
}

// Load the D / kBoxCols<D> boxes of rows [row0, row0 + rows) of (batch,
// head) hb into the tile at dst (box c at dst + c rows kBoxCols<D>).
template <int D>
__device__ __forceinline__ void tma_load_tile(bf16* dst, const CUtensorMap& map, uint64_t* bar,
                                              int rows, int row0, Head hb) {
  constexpr int kBox = kBoxCols<D>;
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) tma_load(dst + c * rows * kBox, map, bar, c * kBox, row0, hb);
}

// ---------------------------------------------------------------------------
// K1, forward: flash_fwd_tma_kernel<D>.
//
// Grid (BH, q-tiles of 128 rows), heaviest causal tile first. Consumer
// group G owns query rows 64G..64G + 63 of the CTA's tile. The producer
// loads the 128 x D Q tile once, then K and V tiles of kN keys (128 at D =
// 64 and 128, 64 at D = 32 and 256) through a ring of kStages, K and V on
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
// At D = 32 the tiles are one box of 64-byte rows: S is two SS m64nkNk16
// a k-tile, P.V an RS m64n32k16 per 16 keys (V MN-major as it landed), O
// 64 x 32 f32 (16 registers a thread). The registers D = 32 frees run two
// CTAs an SM (kCtas; 80 registers a thread at launch, the consumers raised
// to 104), so four consumer groups share an SM's special-function units
// and one CTA's prologue and epilogue run under the other's tiles; S and
// its P fragments then fit in 104 registers at kN = 64 keys a tile. On
// the card (PERF.md) that beat one CTA of two groups at kN = 128
// by 6% at the bench shape, and one CTA of three groups (192 rows, 160
// registers) by 4%.
//
// Bound on an H100 SXM (989 bf16 TFLOP/s, 3.35 TB/s): at the bench shape
// (4, 2048, 8, D) causal, 8.6 / 17.2 / 34.4 / 68.8 GFLOP at D = 32 / 64 /
// 128 / 256: 8.7 / 17.4 / 34.8 / 69.5 us by operations. The exponentials
// bound it further at D = 32 and 64: one per visible score, 67.1 M at the
// bench shape, 16 a clock on each of 132 SMs, about 16 us at 1.98 GHz. A
// 128 x 128 tile's 16,384 exponentials take 1,024 clocks of an SM's
// special-function units, its products 512 clocks at D = 32: the two
// groups' softmaxes, each running under the other's and its own next
// products, keep those units busy.
//
// Shared memory (1 KB alignment, Q, the ring, the bias, the barriers):
// D = 32: 8 KB + kStages x 8 KB; D = 64: 16 KB + 4 x 32 KB; D = 128: 32 KB
// + 2 x 64 KB; D = 256: 64 KB + 2 x 64 KB. One CTA per SM at D >= 64 (the
// consumers' registers allow no second).
// ---------------------------------------------------------------------------
template <int D>
struct TmaFwdShape {
  static constexpr int kCtas = D == 32 ? 2 : 1;  // CTAs an SM
  static constexpr int kRows = 128;              // query rows a CTA owns
  static constexpr int kN = D == 256 || kCtas > 1 ? 64 : 128;  // keys a k-tile
  static constexpr int kStages = D <= 64 ? 4 : 2;
  // Registers a thread: what the launch gives (65,536 over the SM's
  // threads, in steps of 8: 168, or 80 at two CTAs), the producer's after
  // setmaxnreg, and the two consumer groups' (the rest: 240, or 104).
  static constexpr int kLaunchRegs = 65536 / (kTmaThreads * kCtas) / 8 * 8;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kTmaThreads - 128 * kProducerRegs) / 256 / 8 * 8;
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

// The SS wgmma of a 64 x kN f32 accumulator, kN = 32, 64 or 128 keys.
template <int kN>
__device__ __forceinline__ void wgmma_ss_n(float (&d)[kN / 8][4], uint64_t da, uint64_t db) {
  if constexpr (kN == 128)
    wgmma_ss_n128(d, da, db);
  else if constexpr (kN == 64)
    wgmma_ss(d, da, db);
  else
    wgmma_ss_n32(d, da, db);
}

// s (64 x kN f32) = A.B^T over D: A the group's 64 rows of a tile of
// kRowsA rows at a (box c at a + c kRowsA kBoxCols<D>), B the kN-row tile
// at b. SS wgmma, both operands K-major, D / 16 instructions (two at D =
// 32); s is zeroed here, the products issued, not committed.
template <int D, int kRowsA, int kN>
__device__ __forceinline__ void scores_ss(float (&s)[kN / 8][4], const bf16* a, const bf16* b) {
  constexpr int kBox = kBoxCols<D>;
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  }
  wgmma_fence();
  wgmma_hold(s);
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    const uint64_t da = box_desc<D>(a + c * kRowsA * kBox, 16);
    const uint64_t db = box_desc<D>(b + c * kN * kBox, 16);
#pragma unroll
    for (int kk = 0; kk < kBox / 16; ++kk) wgmma_ss_n<kN>(s, da + 2 * kk, db + 2 * kk);
  }
}

template <int kC, int kJ>
__device__ __forceinline__ void hold_all(float (&acc)[kC][kJ][4]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) wgmma_hold(acc[c]);
}

// A group's 64 x D f32 sum: one accumulator per box of columns.
template <int D>
using RowSums = float[D / kBoxCols<D>][kBoxCols<D> / 8][4];

// acc (64 x D) += A.X over the kK rows of the tile at x: A the bf16 A
// fragments a (16 rows of X each; P, dS, P^T or dS^T packed from a score
// accumulator), X MN-major (row-major, as it landed), an RS m64nNk16 per
// box of N = kBoxCols<D> columns and 16 rows. Issued, not committed.
template <int D, int kK>
__device__ __forceinline__ void add_product_rs(RowSums<D>& acc, const uint32_t (&a)[kK / 16][4],
                                               const bf16* x) {
  constexpr int kBox = kBoxCols<D>;
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    const uint64_t db = box_desc<D>(x + c * kK * kBox, kK * kBox * 2);
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      if constexpr (kBox == 64)
        wgmma_rs(acc[c], a[kk], db + (16 * 128 >> 4) * kk);
      else
        wgmma_rs_n32(acc[c], a[kk], db + (16 * 64 >> 4) * kk);
    }
  }
}

// The 16-byte unit that unit u of row r of a box of kBox bf16 columns
// occupies in its swizzle: u ^ (r % 8) in 128-byte rows, u ^ (r / 2 % 4)
// in 64-byte rows (address bits 4-6 or 4-5 XORed with bits 7-9 or 7-8).
template <int kBox>
__device__ __forceinline__ int swizzled_unit(int r, int u) {
  return kBox == 64 ? u ^ (r & 7) : u ^ ((r >> 1) & 3);
}

// Write the group's 64 x D f32 sum acc (its rows r0..r0 + 63; each
// lane's row h times mul[h]) as bf16 rows of out_b (rows `ld` elements
// apart), rows past tq dropped. The group's own rows of the 128-row tile at `stage`
// (box c at stage + c 128 kBoxCols<D>; the group's Q rows) are free once
// all its warps are past their last product that reads them: the rows go
// there in the boxes' swizzle (swizzled_unit), then out in 16-byte stores
// of whole rows.
template <int D>
__device__ __forceinline__ void store_rows(const RowSums<D>& acc, const float (&mul)[2],
                                           bf16* stage, bf16* out_b, long long ld, int r0, int tq,
                                           int grp, int tid) {
  constexpr int kBox = kBoxCols<D>, kUnits = kBox / 8;  // 16-byte units a box row
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  named_sync(1 + grp, 128);
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    bf16* box = stage + c * 128 * kBox;
#pragma unroll
    for (int n = 0; n < kUnits; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + 8 * h;
        store2(box + r * kBox + swizzled_unit<kBox>(r, n) * 8 + 2 * t,
               acc[c][n][2 * h] * mul[h], acc[c][n][2 * h + 1] * mul[h]);
      }
    }
  }
  named_sync(1 + grp, 128);
  bf16* rows = out_b + r0 * ld;
  const int ld32 = (int)ld;  // rows_fit
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    const bf16* box = stage + c * 128 * kBox;
#pragma unroll
    for (int i = 0; i < 64 * kUnits / 128; ++i) {
      const int r = tid / kUnits + (128 / kUnits) * i, u = tid % kUnits;
      if (r0 + r < tq)
        *reinterpret_cast<uint4*>(rows + r * ld32 + c * kBox + u * 8) =
            *reinterpret_cast<const uint4*>(box + r * kBox + swizzled_unit<kBox>(r, u) * 8);
    }
  }
}


template <int kN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kN / 16][4], const float (&sc)[kN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) accum_to_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, TmaFwdShape<D>::kCtas)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const uint8_t* __restrict__ mask, bf16* __restrict__ out, Strides os,
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
  const Head hb = head_of(bh, heads);
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
    setmaxnreg_dec<Shape::kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, Shape::kQBytes);
      tma_load_tile<D>(sq, q_map, bar_q, kRows, q0, hb);
    }
    // K runs one tile ahead of V: a consumer group holds tile j's K and
    // tile j - 1's V at once, and K_{j+1} must not wait behind V_j's slot.
    auto load_k = [&](int j) {
      const int s = stage_of<kS>(j);
      mbar_wait(&empty_k[s], phase_of<kS>(j) ^ 1);
      for (int i = lane; i < kN; i += 32) sbias[s * kN + i] = key_bias(mask_row, j * kN + i, tk);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_k[s], Shape::kTileBytes);
        tma_load_tile<D>(sk + s * kN * D, k_map, &full_k[s], kN, j * kN, hb);
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
        tma_load_tile<D>(sv + s * kN * D, v_map, &full_v[s], kN, j * kN, hb);
      }
    }
    return;
  }

  setmaxnreg_inc<Shape::kConsumerRegs>();
  constexpr int kBox = kBoxCols<D>;
  const int grp = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int r0 = q0 + 64 * grp;  // the group's first row
  const int row[2] = {r0 + warp * 16 + (lane >> 2), r0 + warp * 16 + (lane >> 2) + 8};
  bf16* gq = sq + grp * 64 * kBox;  // the group's rows of each Q box
  RowSums<D> o;
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
#pragma unroll
    for (int n = 0; n < kBox / 8; ++n) {
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
  // A causal group stops at its last tile with a key at or before its last
  // row (nk covers the CTA's last row: at 64 keys a tile, group 0's last
  // tile is all masked; skipping it made K1 5% faster at D = 32 and 2% at D
  // = 256 on the card, PERF.md). No later tile reuses its slots, so
  // they need no release.
  const int nkg = causal ? min(nk, (r0 + 63) / kN + 1) : nk;

  // Tile j's S is issued right before tile j - 1's P.V, and its softmax
  // runs while that P.V is in flight; O takes tile j's correction once
  // P.V has landed (design note 4).
  float sc[kN / 8][4], corr[2];
  uint32_t pa[kN / 16][4];
  mbar_wait(bar_q, 0);
  mbar_wait(&full_k[0], 0);
  scores_ss<D, kRows, kN>(sc, gq, sk);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(sc);
  if (plain_end > 0)
    fwd_softmax<kN, false>(sc, m, l, corr, sbias, 0, row, t, scale2, causal);
  else
    fwd_softmax<kN, true>(sc, m, l, corr, sbias, 0, row, t, scale2, causal);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty_k[0]);  // K and the bias are read
  pack_p<kN>(pa, sc);
  run_tiles(0, plain_end, nkg, [&](int j, auto masked) {
    const int s = stage_of<kS>(j), sp = stage_of<kS>(j - 1);
    mbar_wait(&full_k[s], phase_of<kS>(j));
    scores_ss<D, kRows, kN>(sc, gq, sk + s * kN * D);
    wgmma_commit();
    mbar_wait(&full_v[sp], phase_of<kS>(j - 1));
    hold_all(o);
    add_product_rs<D, kN>(o, pa, sv + sp * kN * D);
    wgmma_commit();
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
      for (int n = 0; n < kBox / 8; ++n) {
        o[c][n][0] *= corr[0];
        o[c][n][1] *= corr[0];
        o[c][n][2] *= corr[1];
        o[c][n][3] *= corr[1];
      }
    }
    pack_p<kN>(pa, sc);
  }, 1);
  {  // the last tile's P.V
    const int sp = stage_of<kS>(nkg - 1);
    mbar_wait(&full_v[sp], phase_of<kS>(nkg - 1));
    wgmma_fence();
    hold_all(o);
    add_product_rs<D, kN>(o, pa, sv + sp * kN * D);
    wgmma_commit();
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
  store_rows<D>(o, inv, gq, out + head_offset(os, bh, heads), os.t, r0, tq, grp, tid);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < tq) lse[(size_t)bh * tq + row[h]] = m[h] / kLog2e + logf(lc[h]);
  }
}

// ---------------------------------------------------------------------------
// K2, dQ: flash_dq_tma_kernel<D>.
//
// Grid (BH, q-tiles of 128 rows), heaviest causal tile first, as K1's.
// Consumer group G owns query rows 64G..64G + 63 of the CTA's tile, their
// 64 x D f32 dQ sum (D / 2 registers a thread) and, in each thread's
// registers, its two rows' lse (base 2) and delta, read once. The producer
// loads the 128 x D Q and dO tiles once, under one barrier, then K and V
// tiles of kN keys through a ring of kStages, K and V on their own "full"
// and "empty" barriers (one shared pair stalled K1 1.5x on the card), the
// tile's key bias with K. Per k-tile a group:
// 1. issues S = Q.K^T and dP = dO.V^T (64 x kN f32 each) as SS wgmma, both
//    operands K-major from the swizzled tiles, as one group; V's slot is
//    released once they have retired;
// 2. forms P = 2^(S scale log2(e) - lse2) and dS = P (dP - delta) scale in
//    registers (dq_terms; masked tiles in _dq_kernel's order: causal
//    -1e30, then the key bias, p = 0 where that is <= -5e29) and packs dS,
//    rounded to bf16 as the reference's .astype(q.dtype), into A fragments;
// 3. adds dS.K to dQ with RS wgmma (K MN-major, as K1's P.V reads V) and
//    releases K's slot once that has retired.
// 4. Overlap, as K1's: tile j's S and dP are issued right before tile j -
//    1's dS.K, and tile j's terms run while that product is in flight; the
//    groups drift apart on their own. On the card this beat waiting for
//    dS.K before the next scores by 1.16x at D = 128 and 1.23x at D = 256
//    and matched it at D = 64; K3's turns made K2 1.3-1.7x slower
//    (PERF.md).
// Masked and plain tiles are run_tiles' two instances, as in K1.
// dQ leaves as bf16 through the group's own Q rows, as K1's O does; rows
// past Tq are not stored.
//
// kN keeps S, dP, dS's A fragments and dQ inside a consumer's registers:
// D = 64: 128 keys (64 + 64 + 32 + 32 a thread), D = 128: 64 (32 + 32 +
// 16 + 64), D = 256: 32 (16 + 16 + 8 + 128).
//
// Bound on an H100 SXM: at the bench shape (4, 2048, 8, D) causal, 25.8 /
// 51.6 / 103 GFLOP at D = 64 / 128 / 256 (three products per (q, k) pair):
// 26.1 / 52.1 / 104 us by operations.
//
// Shared memory (1 KB alignment, Q and dO, the ring, the bias, the
// barriers): D = 64: 32 KB + 4 x 32 KB; D = 128: 64 KB + 4 x 32 KB; D =
// 256: 128 KB + 3 x 32 KB (230,888 bytes: a group holds K_{j-1}, K_j and
// V_j at once, and with 2 stages the overlap was 1.1x slower than none).
// ---------------------------------------------------------------------------
template <int D>
struct TmaDqShape {
  static constexpr int kRows = 128;  // query rows a CTA owns
  static constexpr int kN = D == 64 ? 128 : D == 128 ? 64 : 32;  // keys a k-tile
  static constexpr int kStages = D == 256 ? 3 : 4;
  static constexpr int kTileBytes = kN * D * 2;  // one K or V tile
  static constexpr int kQBytes = kRows * D * 2;  // the Q or dO tile
  // Byte offsets from the 1 KB aligned base.
  static constexpr int kG = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBias = kV + kStages * kTileBytes;
  static constexpr int kBars = kBias + kStages * kN * 4;
  static constexpr size_t kSmemBytes = kAlign + kBars + (1 + 4 * kStages) * 8;
  static_assert(kSmemBytes <= kTmaMaxSmem, "K2's tiles do not fit a CTA");
};


template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_dq_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap g_map,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const uint8_t* __restrict__ mask, bf16* __restrict__ dq, Strides dqs,
                        int heads, int tq, int tk, float scale, int causal) {
  using Shape = TmaDqShape<D>;
  constexpr int kN = Shape::kN, kS = Shape::kStages, kRows = Shape::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kAlign - smem_addr(smem) % kAlign) % kAlign;
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* sg = reinterpret_cast<bf16*>(base + Shape::kG);
  bf16* sk = reinterpret_cast<bf16*>(base + Shape::kK);
  bf16* sv = reinterpret_cast<bf16*>(base + Shape::kV);
  float* sbias = reinterpret_cast<float*>(base + Shape::kBias);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(base + Shape::kBars);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kS;
  uint64_t* empty_k = full_v + kS;
  uint64_t* empty_v = empty_k + kS;

  const int bh = blockIdx.x;
  const Head hb = head_of(bh, heads);
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
      mbar_arrive_expect_tx(bar_q, 2 * Shape::kQBytes);
      tma_load_tile<D>(sq, q_map, bar_q, kRows, q0, hb);
      tma_load_tile<D>(sg, g_map, bar_q, kRows, q0, hb);
    }
    for (int j = 0; j < nk; ++j) {
      const int s = stage_of<kS>(j);
      mbar_wait(&empty_k[s], phase_of<kS>(j) ^ 1);
      for (int i = lane; i < kN; i += 32) sbias[s * kN + i] = key_bias(mask_row, j * kN + i, tk);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_k[s], Shape::kTileBytes);
        tma_load_tile<D>(sk + s * kN * D, k_map, &full_k[s], kN, j * kN, hb);
      } else {
        mbar_arrive(&full_k[s]);
      }
      mbar_wait(&empty_v[s], phase_of<kS>(j) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_v[s], Shape::kTileBytes);
        tma_load_tile<D>(sv + s * kN * D, v_map, &full_v[s], kN, j * kN, hb);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int grp = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int r0 = q0 + 64 * grp;  // the group's first row
  const int row[2] = {r0 + warp * 16 + (lane >> 2), r0 + warp * 16 + (lane >> 2) + 8};
  // lse (base 2) and delta of the lane's rows; a row past Tq reads 0 (its
  // Q and dO rows land as zeros, so its dS is 0) and is not stored.
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < tq;
    lse2[h] = in ? lse[(size_t)bh * tq + row[h]] * kLog2e : 0.f;
    dl[h] = in ? delta[(size_t)bh * tq + row[h]] : 0.f;
  }
  constexpr int kBox = kBoxCols<D>;
  bf16* gq = sq + grp * 64 * kBox;  // the group's rows of each Q box
  const bf16* gg = sg + grp * 64 * kBox;
  RowSums<D> acc;
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
#pragma unroll
    for (int n = 0; n < kBox / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][n][e] = 0.f;
    }
  }
  const float scale2 = scale * kLog2e;

  // Tiles from `plain_end` on need a mask: the first whose keys pass a row
  // of the group (causal), or pass Tk; every tile where a key mask is given.
  int plain_end = min(nk, tk / kN);
  if (causal) plain_end = min(plain_end, (r0 + 1) / kN);
  if (mask != nullptr) plain_end = 0;

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float sc[kN / 8][4], dp[kN / 8][4];
  uint32_t dsa[kN / 16][4];
  // S and dP of tile j, issued as one group, not waited.
  auto issue_scores = [&](int j) {
    const int s = stage_of<kS>(j);
    mbar_wait(&full_k[s], phase_of<kS>(j));
    mbar_wait(&full_v[s], phase_of<kS>(j));
    scores_ss<D, kRows, kN>(sc, gq, sk + s * kN * D);
    scores_ss<D, kRows, kN>(dp, gg, sv + s * kN * D);
    wgmma_commit();
  };
  mbar_wait(bar_q, 0);

  // Tile j's S and dP are issued right before tile j - 1's dS.K, and its
  // terms run while that product is in flight (design note 4).
  issue_scores(0);
  wgmma_wait<0>();
  wgmma_hold(sc);
  wgmma_hold(dp);
  release(&empty_v[0]);
  if (plain_end > 0)
    dq_terms<kN, false>(sc, dp, sbias, 0, row, t, lse2, dl, scale, scale2, causal);
  else
    dq_terms<kN, true>(sc, dp, sbias, 0, row, t, lse2, dl, scale, scale2, causal);
  pack_p<kN>(dsa, dp);
  run_tiles(0, plain_end, nk, [&](int j, auto masked) {
    const int s = stage_of<kS>(j), sp = stage_of<kS>(j - 1);
    issue_scores(j);
    hold_all(acc);
    add_product_rs<D, kN>(acc, dsa, sk + sp * kN * D);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_hold(sc);
    wgmma_hold(dp);
    release(&empty_v[s]);  // V_j is read
    dq_terms<kN, decltype(masked)::value>(sc, dp, sbias + s * kN, j * kN, row, t, lse2, dl,
                                          scale, scale2, causal);
    wgmma_wait<0>();
    hold_all(acc);
    release(&empty_k[sp]);  // K_{j-1} and its bias are read
    pack_p<kN>(dsa, dp);
  }, 1);
  wgmma_fence();  // the last tile's dS.K
  hold_all(acc);
  add_product_rs<D, kN>(acc, dsa, sk + stage_of<kS>(nk - 1) * kN * D);
  wgmma_commit();
  wgmma_wait<0>();
  hold_all(acc);

  const float one[2] = {1.f, 1.f};
  store_rows<D>(acc, one, gq, dq + head_offset(dqs, bh, heads), dqs.t, r0, tq, grp, tid);
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
// under the other's products (kTurns). dK and dV leave straight from the
// accumulators.
// - D = 32: as at D = 64, on one box of 64-byte rows per tile: S^T and
//   dP^T are two SS m64n64k16 each (K = 32), dV += P^T.dO and dK +=
//   dS^T.Q an RS m64n32k16 per 16 queries, dV and dK 16 registers a
//   thread each; a Q and dO stage is 8 KB, so the ring is deep (8 stages
//   ran 3% faster than 6 on the card). The groups issue without turns:
//   their products are short at K = 32, and the turns made K3 2% slower
//   there (PERF.md).
//
// Bound on an H100 SXM: at the bench shape (4, 2048, 8, D) causal, 17.2 /
// 34.4 / 68.8 / 137.5 GFLOP at D = 32 / 64 / 128 / 256: 17.4 / 34.8 / 69.5
// / 139 us by operations. Its 67.1 M exponentials there take about 16 us
// of the special-function units (16 a clock an SM), level with the
// products at D = 32.
//
// Shared memory: K, V, the ring (Q and dO, lse and delta) and at D = 256
// the exchange: D = 32: 16 KB + 8 x 8 KB; D = 64: 32 KB + 4 x 16 KB; D =
// 128: 64 KB + 3 x 32 KB; D = 256: 64 KB + 2 x 64 KB + 16 KB.
// ---------------------------------------------------------------------------
template <int D>
struct TmaDkvShape {
  static constexpr bool kSplit = D == 256;  // group 0 owns dV, group 1 dK
  static constexpr int kKeys = kSplit ? 64 : 128;
  static constexpr int kQ = 64;  // queries a q-tile
  static constexpr int kStages = D == 32 ? 8 : D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr bool kTurns = !kSplit && D != 32;  // the groups' ping-pong
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

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_dkv_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap g_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const uint8_t* __restrict__ mask, bf16* __restrict__ dk, Strides dks,
                         bf16* __restrict__ dv, Strides dvs, int heads, int tq, int tk,
                         float scale, int causal) {
  using Shape = TmaDkvShape<D>;
  constexpr int kS = Shape::kStages, kKeys = Shape::kKeys, kQ = Shape::kQ;
  constexpr int kBox = kBoxCols<D>, kC = D / kBox;
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
  const Head hb = head_of(bh, heads);
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
      tma_load_tile<D>(sk, k_map, bar_kv, kKeys, k0, hb);
      tma_load_tile<D>(sv, v_map, bar_kv, kKeys, k0, hb);
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
        tma_load_tile<D>(sq + s * kQ * D, q_map, &full[s], kQ, q0, hb);
        tma_load_tile<D>(sg + s * kQ * D, g_map, &full[s], kQ, q0, hb);
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
  RowSums<D> acc;
  float acc2[Shape::kSplit ? 1 : kC][kBox / 8][4];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int n = 0; n < kBox / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][n][e] = 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < (Shape::kSplit ? 1 : kC); ++c) {
#pragma unroll
    for (int n = 0; n < kBox / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[c][n][e] = 0.f;
    }
  }
  mbar_wait(bar_kv, 0);

  if constexpr (!Shape::kSplit) {
    // acc: dV, acc2: dK. Two turns of the groups' ping-pong a tile: the
    // score products, then the output products.
    if (Shape::kTurns && tiles > 0) turn_open(grp);
    run_tiles(masked_end, plain_end, tiles, [&](int i, auto masked) {
      const int s = stage_of<kS>(i), q0 = (qt0 + i) * kQ;
      const bf16* cq = sq + s * kQ * D;
      const bf16* cg = sg + s * kQ * D;
      mbar_wait(&full[s], phase_of<kS>(i));
      float st[8][4], dpt[8][4];
      if constexpr (Shape::kTurns) turn_wait(grp);
      scores_ss<D, kKeys, kQ>(st, gk, cq);
      wgmma_commit();
      scores_ss<D, kKeys, kQ>(dpt, gv, cg);
      wgmma_commit();
      if constexpr (Shape::kTurns) turn_pass(grp, false);
      wgmma_wait<0>();
      wgmma_hold(st);
      wgmma_hold(dpt);
      uint32_t pa[4][4], dsa[4][4];
      dkv_terms<decltype(masked)::value>(pa, dsa, st, dpt, slse + s * kQ, sdelta + s * kQ, q0,
                                         t, key, key_live, tq, scale, scale2, causal);
      if constexpr (Shape::kTurns) turn_wait(grp);
      wgmma_fence();
      hold_all(acc);
      hold_all(acc2);
      add_product_rs<D, kQ>(acc, pa, cg);
      add_product_rs<D, kQ>(acc2, dsa, cq);
      wgmma_commit();
      if constexpr (Shape::kTurns) turn_pass(grp, i == tiles - 1);
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
      scores_ss<D, kKeys, kQ>(st, gk, sq + s * kQ * D);
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
      add_product_rs<D, kQ>(acc, pa, sg + s * kQ * D);
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
      scores_ss<D, kKeys, kQ>(dpt, gv, sg + s * kQ * D);
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
      add_product_rs<D, kQ>(acc, dsa, sq + s * kQ * D);
      wgmma_commit();
      wgmma_wait<0>();
      hold_all(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // Rows past Tk are not written.
  bf16* dk_row = dk + head_offset(dks, bh, heads);
  bf16* dv_row = dv + head_offset(dvs, bh, heads);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= tk) continue;
    bf16* first = Shape::kSplit && grp == 1 ? dk_row + key[h] * dks.t : dv_row + key[h] * dvs.t;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int n = 0; n < kBox / 8; ++n)
        store2(first + c * kBox + 8 * n + 2 * t, acc[c][n][2 * h], acc[c][n][2 * h + 1]);
    }
    if constexpr (!Shape::kSplit) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
#pragma unroll
        for (int n = 0; n < kBox / 8; ++n)
          store2(dk_row + key[h] * dks.t + c * kBox + 8 * n + 2 * t, acc2[c][n][2 * h],
                 acc2[c][n][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, launchers, occupancy.
// ---------------------------------------------------------------------------


template <int D>
int launch_fwd_tma_as(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                      int heads, int tq, int tk, float scale, int causal, cudaStream_t stream) {
  using Shape = TmaFwdShape<D>;
  CUtensorMap maps[3];
  int err = tensor_map<bf16>(&maps[0], q, bh, heads, tq, D, Shape::kRows);
  if (err == 0) err = tensor_map<bf16>(&maps[1], k, bh, heads, tk, D, Shape::kN);
  if (err == 0) err = tensor_map<bf16>(&maps[2], v, bh, heads, tk, D, Shape::kN);
  if (err != 0) return err;
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = set_smem(flash_fwd_tma_kernel<D>, Shape::kSmemBytes, configured);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(bh, (tq + Shape::kRows - 1) / Shape::kRows);
  flash_fwd_tma_kernel<D><<<grid, kTmaThreads, Shape::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const uint8_t*>(mask), ptr<bf16>(out), out.s,
      static_cast<float*>(lse), heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_tma_as(View q, View k, View v, View g, const void* lse, const void* delta,
                     const void* mask, View dq, int bh, int heads, int tq, int tk, float scale,
                     int causal, cudaStream_t stream) {
  using Shape = TmaDqShape<D>;
  CUtensorMap maps[4];
  int err = tensor_map<bf16>(&maps[0], q, bh, heads, tq, D, Shape::kRows);
  if (err == 0) err = tensor_map<bf16>(&maps[1], k, bh, heads, tk, D, Shape::kN);
  if (err == 0) err = tensor_map<bf16>(&maps[2], v, bh, heads, tk, D, Shape::kN);
  if (err == 0) err = tensor_map<bf16>(&maps[3], g, bh, heads, tq, D, Shape::kRows);
  if (err != 0) return err;
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = set_smem(flash_dq_tma_kernel<D>, Shape::kSmemBytes, configured);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(bh, (tq + Shape::kRows - 1) / Shape::kRows);
  flash_dq_tma_kernel<D><<<grid, kTmaThreads, Shape::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), ptr<bf16>(dq), dq.s,
      heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tma_as(View q, View k, View v, View g, const void* lse, const void* delta,
                      const void* mask, View dk, View dv, int bh, int heads, int tq, int tk,
                      float scale, int causal, cudaStream_t stream) {
  using Shape = TmaDkvShape<D>;
  CUtensorMap maps[4];
  int err = tensor_map<bf16>(&maps[0], q, bh, heads, tq, D, Shape::kQ);
  if (err == 0) err = tensor_map<bf16>(&maps[1], k, bh, heads, tk, D, Shape::kKeys);
  if (err == 0) err = tensor_map<bf16>(&maps[2], v, bh, heads, tk, D, Shape::kKeys);
  if (err == 0) err = tensor_map<bf16>(&maps[3], g, bh, heads, tq, D, Shape::kQ);
  if (err != 0) return err;
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = set_smem(flash_dkv_tma_kernel<D>, Shape::kSmemBytes, configured);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(bh, (tk + Shape::kKeys - 1) / Shape::kKeys);
  flash_dkv_tma_kernel<D><<<grid, kTmaThreads, Shape::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), ptr<bf16>(dk), dk.s,
      ptr<bf16>(dv), dv.s, heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

namespace swt {

// K1's and K2's tile is their 128 query rows; K3's its keys (128, or 64
// at D = 256). K1 and K3 run D = 32 too, K2 only 64, 128 and 256.
bool tma_tile(int kernel, int d, int tile) {
  if (d != 64 && d != 128 && d != 256 && !(d == 32 && kernel != 1)) return false;
  if (kernel == 0 || kernel == 1) return tile == 128;
  if (kernel == 2) return tile == (d == 256 ? 64 : 128);
  return false;
}

int launch_fwd_tma(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                   int heads, int tq, int tk, int d, float scale, int causal, cudaStream_t stream) {
  return by_tma_head_dim<true>(d, [&](auto dd) {
    return launch_fwd_tma_as<decltype(dd)::value>(q, k, v, mask, out, lse, bh, heads, tq, tk,
                                                  scale, causal, stream);
  });
}

int launch_dq_tma(View q, View k, View v, View g, const void* lse, const void* delta,
                  const void* mask, View dq, int bh, int heads, int tq, int tk, int d, float scale,
                  int causal, cudaStream_t stream) {
  return by_tma_head_dim(d, [&](auto dd) {
    return launch_dq_tma_as<decltype(dd)::value>(q, k, v, g, lse, delta, mask, dq, bh, heads, tq,
                                                 tk, scale, causal, stream);
  });
}

int launch_dkv_tma(View q, View k, View v, View g, const void* lse, const void* delta,
                   const void* mask, View dk, View dv, int bh, int heads, int tq, int tk, int d,
                   float scale, int causal, cudaStream_t stream) {
  return by_tma_head_dim<true>(d, [&](auto dd) {
    return launch_dkv_tma_as<decltype(dd)::value>(q, k, v, g, lse, delta, mask, dk, dv, bh,
                                                  heads, tq, tk, scale, causal, stream);
  });
}

int tma_occupancy(int kernel, int d, int* out) {
  if (kernel == 1) {
    return by_tma_head_dim(d, [&](auto dd) {
      constexpr int D = decltype(dd)::value;
      return occupancy(flash_dq_tma_kernel<D>, kTmaThreads, TmaDqShape<D>::kSmemBytes, out);
    });
  }
  return by_tma_head_dim<true>(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    if (kernel == 0)
      return occupancy(flash_fwd_tma_kernel<D>, kTmaThreads, TmaFwdShape<D>::kSmemBytes, out);
    if (kernel == 2)
      return occupancy(flash_dkv_tma_kernel<D>, kTmaThreads, TmaDkvShape<D>::kSmemBytes, out);
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace swt
