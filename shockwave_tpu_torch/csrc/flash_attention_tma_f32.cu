// Flash attention for Hopper (sm_90a): K1 (forward), K2 (dQ) and K3 (dK,
// dV) in f32 at head dims 64, 128 and 256 on sequences past the f32 short
// tile (ops/flash_attention.py:launch_config: max(Tq, Tk) > 64), fed by
// TMA, on TF32 wgmma as 3xTF32. They replace _fa_kernel (:40), _dq_kernel
// (:167) and _dkv_kernel (:222) of shockwave_tpu/ops/flash_attention.py
// there, and compute what the mma.sync f32 kernels of flash_attention.cu
// (design notes of "K1-K3 in f32") compute: every product a.b as
// a_small.b_big + a_big.b_small + a_big.b_big (split_tf32) into one f32
// accumulator; each tile's part of O, dQ, dK or dV summed from zero and
// added in f32 (the tensor cores' f32 accumulation truncates); causal
// entries -1e30, then the key bias (-1e30 for a masked key, -inf past Tk),
// the running max from -1e30, p = 0 where s <= -5e29 in the backward. The
// mma.sync kernels keep the f32 short tile (one-warp CTAs up to T = 64)
// and D = 32.
//
// CTA shape: flash_attention_tma.cu's (384 threads). Warpgroup 0 is the
// producer: setmaxnreg lowers it to kF32ProducerRegs; its thread 0 issues
// every TMA load, its warps 1-3 (the helpers, kHelpers threads) stage each
// streamed tile's small TF32 planes and the tile's key bias (K3: lse and
// delta). Warpgroups 1
// and 2 are the consumers (setmaxnreg raises them to kF32ConsumerRegs) and
// run only wgmma and the elementwise terms. Operands arrive by TMA over
// 4-D tensor maps of (B, H, T, D) f32 views (tensor_map: the model's
// tensors in place), boxes of 32 columns (128 bytes, the 128-byte
// swizzle's row) by the tile's rows, zeros past a ragged end.
// A stage has three mbarriers: "land" (the copies' bytes), "full" (one
// arrival per helper, after its small-plane and bias stores and their
// fence into the async proxy) and "empty" (one arrival per warp of the
// group that read it).
//
// Design notes.
// 1. TF32 wgmma takes B only K-major from shared memory (the transpose
//    bits exist only for 16-bit types), and P.V and dS.K contract over
//    keys, which the landed V and K tiles hold as rows. Of the two ways
//    round it, staged transposed planes of V and K (big and small, 8 x
//    keys x D bytes a tile, beside the tile itself) or swapped operands,
//    this takes the second: O^T += V^T.P^T and dQ^T += K^T.dS^T. The
//    streamed V (K) is wgmma's A operand from registers, read from its
//    row-major landing and split as it is read (split_at_box); P (dS), a
//    64 x kN f32 score tile, goes to shared memory as big and small TF32
//    planes in the K-major B layout (store_planes), written into the room
//    of the tile the step has finished with (K1: K and its small plane;
//    K2: V and its small plane), so the planes cost no bytes of their own.
//    The keys of each 8 sit in the planes and in the A fragments in the
//    same order (slot t key 2t, slot t + 4 key 2t + 1), which makes the
//    fragment reads of V (K) free of bank conflicts. The online softmax's
//    per-row factor then falls on the accumulator's columns: the group
//    passes its 64 factors through shared memory with P.
//    S = Q.K^T and dP = dO.V^T keep their natural orientation: Q and dO
//    are A from registers, split from their resident landing as read, one
//    commit group (a box of 32 columns, or less where the sums leave too
//    few registers; K2's S and dP in one group) ahead of the products;
//    K (V) is B, its landed tile the big plane as it stands (the tensor
//    cores read an f32's top 19 bits, which is split_tf32's big part), its
//    small plane staged by the helpers once per tile for both products.
// 2. Shared memory at D = 256: a 64 x 256 f32 tile is 64 KB. Q resident
//    for 64 rows (64 KB; 128 rows would take 128 KB), a stage of kN keys
//    is 3 x kN KB in K1 (K, K small, V) and 4 x kN KB in K2 (and V small),
//    K2 keeps dO resident too (128 KB in all). So a CTA owns 64 query
//    rows, and its two consumer groups share them:
//    - D = 64 and 128: the groups split the k-tiles (group G takes j = G,
//      G + 2, ...), each with its own online softmax (K1) or dQ sum; at
//      the end group 1 hands its sums through the ring's room to group 0,
//      which merges them (K1: the two softmax states by their maxima, as a
//      two-part flash-decoding merge) and stores.
//    - D = 256 (kSplitD): both groups take every k-tile and split D: each
//      forms S (and dP) over its 128 columns, the partial tiles meet in a
//      double-buffered exchange (exchange_scores: one barrier of both
//      groups a tile, s_0 + s_1 alike in both), both run the same softmax
//      or terms, and each forms and owns its 128 columns of O^T or dQ^T.
//      That halves a group's sum to 64 registers a thread: with the k-tiles
//      split instead, its 128 registers beside the products spilled 216-
//      736 bytes, and split D ran as fast (K1) or 3% faster (K2; PERF.md).
//    The tiles (keys kN x stages kStages; bytes with the 1 KB alignment,
//    the bias, K1's factors, the exchanges and the barriers):
//    K1: D = 64: 64 x 4 (215,656); D = 128: 32 x 4 (231,528); D = 256:
//        16 x 3 (231,184).
//    K2: D = 64: 64 x 3 (231,248); D = 128: 32 x 2 (197,944); D = 256:
//        8 x 2 (214,136). K2 at D = 128 ran 1.3x faster on 32-key tiles
//        in 2 stages than on 16-key tiles in 5 (PERF.md).
//    One CTA per SM (the consumers' registers allow no second): 8 consumer
//    warps, where the mma.sync kernels ran 2 at D = 256 and 4 at D = 128.
// 3. Registers: a group's O^T or dQ^T is 64 x D f32 (64 x D / 2 at D =
//    256), 64 registers a thread at most, in accumulators of 64 x 64 (one
//    per 64 columns of O, each a wgmma m64n64k8 over 8 keys); each is
//    formed from zero over the tile (planes_product) and added in f32:
//    K1's O^T = O^T corr + part by an FMA per entry, the factor of each
//    query column read from the group's 64 in shared memory; K2's dQ^T +=
//    part. 128 x 40 + 256 x 232 registers fill the 384 x 168 the launch
//    gives; ptxas uses them up to R229 in the consumers.
// 4. Masking per tile by template, as in flash_attention_tma.cu: tiles that
//    need no causal compare, no key bias and no ragged-end test take the
//    plain step in a loop of their own, the others the masked one.
// 5. K3 owns 64 keys a CTA and walks q-tiles of kQ queries. A wgmma's M is
//    64 rows of A, and the keys are the rows that stay: S^T = K.Q^T and
//    dP^T = V.dO^T put K and V, resident, on A (split from their landing
//    as read, every q-tile) and stream Q and dO as B (their landings the
//    big planes, their small planes staged by the helpers). dV and dK
//    contract over queries, which the landed Q and dO hold as rows, so
//    they run swapped (note 1): dV^T = dO^T.P and dK^T = Q^T.dS, dO^T and
//    Q^T split from the landings, P^T and dS^T as planes written into Q's
//    and dO's small-plane rooms once the score products are past (at D =
//    64 those hold 256 kQ bytes against the planes' 512 kQ, so the stage
//    has rooms of its own). The other orientation, S = Q.K^T with K and V
//    as B, needs 64 queries a tile: at D = 256 Q and dO alone then take
//    128 KB a stage, beside 128 KB of K, V and their small planes for 32
//    keys.
//    The groups split the products: group 0 forms S^T and P^T and owns
//    dV^T; group 1 forms dP^T, reads P^T back from group 0's planes
//    (load_planes: exact, after handed[s]) and owns dK^T. A group's sum is
//    D x 64 f32, D / 2 registers a thread: 32 and 64 at D = 64 and 128,
//    128 at D = 256, where every tiling tried spilled 44-1,556 bytes with it
//    all in registers (PERF.md). So at D = 256 the sum's last 64 columns
//    (32 registers) live in a stash in shared memory (kStash), each part
//    added there in f32; the keys' bias and the tile loop's bounds are read
//    from shared memory where they are used; the tile body is one loop
//    (kOneLoop: three loops of it spilled more); and the consumers take 240
//    registers, the producer 24. That compiles without spills and ran 1.37x
//    faster than the mma.sync kernel it replaces; tilings that spilled
//    16-288 bytes ran up to 1.18x faster still.
//    Tiles (queries kQ x stages; bytes with the alignment, the terms, the
//    bias, the bounds, the stash and the barriers): D = 64: 32 x 3
//    (231,560); D = 128: 32 x 2 (198,504); D = 256: 16 x 1 (230,856); 8 x
//    2 (n8 score products, twice as many a query) ran 1.01-1.1x slower.
//
// Bound on an H100 SXM at f32-accurate products (494.5 / 3 = 164.8
// TFLOP/s): at the bench shape (4, 2048, 8, D) causal, K1 17.2 / 34.4 /
// 68.8 GFLOP at D = 64 / 128 / 256 (104 / 209 / 417 us), K2 25.8 / 51.6 /
// 103 GFLOP (156 / 313 / 626 us), K3 34.4 / 68.8 / 137.5 GFLOP (209 / 417 /
// 834 us).
#include "flash_attention_tma.cuh"

namespace {

constexpr int kF32Rows = 64;        // query rows a CTA owns
constexpr int kF32BoxCols = 32;     // columns of an f32 TMA box: a 128-byte swizzle row
constexpr int kF32BoxFloats = kF32Rows * kF32BoxCols;  // a 64-row box, 8 KB
constexpr int kHelpers = 96;        // the producer warpgroup's warps 1-3
constexpr int kF32ProducerRegs = 40;
constexpr int kF32ConsumerRegs = 232;  // 128 x 40 + 256 x 232 = 384 x 168, what the launch gives

// Element (r, x) of an f32 box (rows of 32 floats, 1 KB aligned) in the
// 128-byte swizzle: 16-byte unit x / 4 of row r at unit (x / 4) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int x) {
  return r * kF32BoxCols + (((x >> 2) ^ r) & 7) * 4 + (x & 3);
}

// Load the D / 32 boxes of rows [row0, row0 + rows) of (batch, head) hb
// into the tile at dst (box c at dst + c rows 32).
template <int D>
__device__ __forceinline__ void tma_load_f32(float* dst, const CUtensorMap& map, uint64_t* bar,
                                             int rows, int row0, Head hb) {
#pragma unroll
  for (int c = 0; c < D / kF32BoxCols; ++c)
    tma_load(dst + c * rows * kF32BoxCols, map, bar, c * kF32BoxCols, row0, hb);
}

// The small TF32 plane of an f32 tile of n floats at x (split_tf32's small
// part of each element, at the element's own position) into xs, by helper
// h of kHelpers. The tile as it landed is its big plane.
template <int n>
__device__ __forceinline__ void stage_small(const float* x, float* xs, int h) {
  static_assert(n % 4 == 0, "whole 16-byte units");
  for (int e = 4 * h; e < n; e += 4 * kHelpers) {
    const float4 v = *reinterpret_cast<const float4*>(x + e);
    uint32_t b, s[4];
    split_tf32(v.x, b, s[0]);
    split_tf32(v.y, b, s[1]);
    split_tf32(v.z, b, s[2]);
    split_tf32(v.w, b, s[3]);
    *reinterpret_cast<uint4*>(xs + e) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// The A fragment of rows r0 + g and r0 + g + 8, columns 8kk + t and 8kk +
// t + 4 of the 64-row box at `box` (m16n8k8's A layout), split.
__device__ __forceinline__ Split<4> split_a_box(const float* box, int r0, int kk, int g, int t) {
  const int r = r0 + g, x = 8 * kk + t;
  const float v[4] = {box[swz(r, x)], box[swz(r + 8, x)], box[swz(r, x + 4)],
                      box[swz(r + 8, x + 4)]};
  Split<4> a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], a.big[i], a.small[i]);
  return a;
}

// The A fragment of X^T for the tile X at x (kN key rows, D columns in
// boxes of kN x 32): rows 64mt + 16w + g and + 8 of X^T (columns of X),
// k-slots t and t + 4 holding keys 8kk + 2t and 8kk + 2t + 1, the order
// store_planes gives the keys of P and dS. Split.
template <int kN>
__device__ __forceinline__ Split<4> split_at_box(const float* x, int mt, int w, int kk, int g,
                                                 int t) {
  const int col = 64 * mt + 16 * w + g;  // col and col + 8 share a box
  const float* box = x + (col / kF32BoxCols) * kN * kF32BoxCols;
  const int c = col % kF32BoxCols, key = 8 * kk + 2 * t;
  const float v[4] = {box[swz(key, c)], box[swz(key, c + 8)], box[swz(key + 1, c)],
                      box[swz(key + 1, c + 8)]};
  Split<4> a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], a.big[i], a.small[i]);
  return a;
}

// s[p] (the group's 64 x kN scores) = A_p.B_p^T over D as 3xTF32 for each
// of kP products (K1: S; K2: S and dP): A_p the group's 64 rows, the
// 64-row tile at a[p] (boxes of 32 columns), its fragments split in
// registers as read, kChunk k8 steps of every product a commit group, one
// group ahead of the products (two sets of fragments, the older retired
// before its registers are read into again); B_p the kN-row tile at b[p],
// its small plane at bs[p]. Waited for before return.
template <int D, int kN, int kChunk, int kP>
__device__ __forceinline__ void scores_3xtf32(float (&s)[kP][kN / 8][4],
                                              const float* const (&a)[kP],
                                              const float* const (&b)[kP],
                                              const float* const (&bs)[kP], int w, int g, int t) {
  static_assert(4 % kChunk == 0, "a chunk lies within one box");
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[p][n][e] = 0.f;
    }
  }
  Split<4> frag[2][kP][kChunk];
#pragma unroll
  for (int c = 0; c < D / 8 / kChunk; ++c) {
    const int box = c * kChunk / 4, kk0 = c * kChunk % 4;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        frag[c & 1][p][i] = split_a_box(a[p] + box * kF32BoxFloats, 16 * w, kk0 + i, g, t);
    }
    uint64_t db[kP], ds[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      db[p] = wgmma_desc(b[p] + box * kN * kF32BoxCols, 16) + 2 * kk0;
      ds[p] = wgmma_desc(bs[p] + box * kN * kF32BoxCols, 16) + 2 * kk0;
    }
    // Every accumulator held before the group's first wgmma: a hold
    // between two of them makes ptxas wait for the products in flight.
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kP; ++p) wgmma_hold(s[p]);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
#pragma unroll
      for (int p = 0; p < kP; ++p)
        wgmma_3xtf32<kN>(s[p], frag[c & 1][p][i], db[p] + 2 * i, ds[p] + 2 * i);
    }
    wgmma_commit();
    if (c > 0) wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < kP; ++p) wgmma_hold(s[p]);
}

// Write x (the group's 64 x kN P or dS, accumulator layout) at pl as the
// K-major B operand of the planes product: row q of each plane holds query
// q's kN keys, key 8n + 2t in slot t and 8n + 2t + 1 in slot t + 4 of k8
// step n; the big plane's keys are floats [0, kN) of the row, the small
// plane's [kN, 2kN), in 64-row boxes of 32 floats in the 128-byte swizzle.
template <int kN>
__device__ __forceinline__ void store_planes(float* pl, const float (&x)[kN / 8][4], int w, int g,
                                             int t) {
  uint32_t* u = reinterpret_cast<uint32_t*>(pl);
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + g + 8 * h;
      uint32_t b[2], s[2];
      split_tf32(x[n][2 * h], b[0], s[0]);
      split_tf32(x[n][2 * h + 1], b[1], s[1]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int f = p * kN + 8 * n + t;
        uint32_t* box = u + (f / kF32BoxCols) * kF32BoxFloats;
        box[swz(r, f % kF32BoxCols)] = p ? s[0] : b[0];
        box[swz(r, f % kF32BoxCols + 4)] = p ? s[1] : b[1];
      }
    }
  }
}

// The descriptor of k8 step kk of plane p (0 big, 1 small) of the planes
// at pl (store_planes).
template <int kN>
__device__ __forceinline__ uint64_t plane_desc(const float* pl, int p, int kk) {
  const int f = p * kN + 8 * kk;
  return wgmma_desc(pl + (f / kF32BoxCols) * kF32BoxFloats, 16) + (f % kF32BoxCols) / 4;
}

// part (64 x kM f32: rows 64mt.. of X^T against kM of the 64 rows of Y,
// from row m0 on) = X^T.Y^T over the kN keys of one tile, as 3xTF32 from
// zero: A the m-tile mt of X^T split from the tile x as it landed
// (split_at_box), B the planes of Y (P or dS) at pl. Waited for before
// return.
template <int kN, int kM = 64>
__device__ __forceinline__ void planes_product(float (&part)[kM / 8][4], const float* x,
                                               const float* pl, int mt, int w, int g, int t,
                                               int m0 = 0) {
  Split<4> a[kN / 8];
#pragma unroll
  for (int kk = 0; kk < kN / 8; ++kk) a[kk] = split_at_box<kN>(x, mt, w, kk, g, t);
#pragma unroll
  for (int n = 0; n < kM / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
  }
  const float* rows = pl + m0 * kF32BoxCols;  // rows m0.. of each 64-row box
  wgmma_fence();
  wgmma_hold(part);
#pragma unroll
  for (int kk = 0; kk < kN / 8; ++kk)
    wgmma_3xtf32<kM>(part, a[kk], plane_desc<kN>(rows, 0, kk), plane_desc<kN>(rows, 1, kk));
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(part);
}

// The producer warpgroup of the three kernels. Thread 0 loads the
// resident tiles (`resident`), then for each streamed tile j < n, once its
// stage is empty, the kN rows (first + j) kN.. of x_map and of y_map (K1
// and K2: K and V; K3: Q and dO) into the stage's x and y rooms (kY floats
// apart), completing on land[s]. The helpers wait for each tile to land,
// stage x's small plane (and, with kYSmall, y's) right after its tile,
// store the tile's small vectors (terms(s, j, h): K1's and K2's key bias,
// K3's lse and delta), fence them into the async proxy and arrive on
// full[s]. Every other thread returns.
template <int D, int kN, int kS, int kStageFloats, int kY, bool kYSmall,
          int kRegs = kF32ProducerRegs, typename Resident, typename Terms>
__device__ __forceinline__ void produce(Resident&& resident, Terms&& terms, float* ring,
                                        uint64_t* land, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap& x_map, const CUtensorMap& y_map,
                                        int first, int n, Head hb) {
  constexpr int kTile = kN * D;
  setmaxnreg_dec<kRegs>();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      resident();
      for (int j = 0; j < n; ++j) {
        const int s = stage_of<kS>(j);
        float* xt = ring + s * kStageFloats;
        mbar_wait(&empty[s], phase_of<kS>(j) ^ 1);
        mbar_arrive_expect_tx(&land[s], 2 * kTile * 4);
        tma_load_f32<D>(xt, x_map, &land[s], kN, (first + j) * kN, hb);
        tma_load_f32<D>(xt + kY, y_map, &land[s], kN, (first + j) * kN, hb);
      }
    }
    return;
  }
  const int h = threadIdx.x - 32;
  for (int j = 0; j < n; ++j) {
    const int s = stage_of<kS>(j);
    float* xt = ring + s * kStageFloats;
    mbar_wait(&land[s], phase_of<kS>(j));
    stage_small<kTile>(xt, xt + kTile, h);
    if constexpr (kYSmall) stage_small<kTile>(xt + kY, xt + kY + kTile, h);
    terms(s, first + j, h);
    fence_async_shared();
    mbar_arrive(&full[s]);
  }
}

// K1's and K2's helper terms: the key bias of k-tile j's kN keys (0, -1e30
// for a masked key, -inf past Tk) into stage s's slots of sbias.
template <int kN>
__device__ __forceinline__ auto key_bias_terms(float* sbias, const uint8_t* mask, int heads,
                                               int tk, int bh) {
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
  return [=](int s, int j, int h) {
    for (int i = h; i < kN; i += kHelpers) sbias[s * kN + i] = key_bias(mask_row, j * kN + i, tk);
  };
}

// Run step(j, masked) over the group's k-tiles j = grp, grp + 2, ... < nk:
// the plain instance below plain_end, the masked one from there on.
template <typename Step>
__device__ __forceinline__ void run_group_tiles(int grp, int plain_end, int nk, Step&& step) {
  int j = grp;
  for (; j < plain_end; j += 2) step(j, std::false_type{});
  for (; j < nk; j += 2) step(j, std::true_type{});
}

// The first k-tile that needs a mask: past Tk, or with a key past the
// CTA's first row q0 (causal), or any tile where a key mask is given.
template <int kN>
__device__ __forceinline__ int plain_tiles(int nk, int tk, int q0, int causal,
                                           const uint8_t* mask) {
  int plain_end = min(nk, tk / kN);
  if (causal) plain_end = min(plain_end, (q0 + 1) / kN);
  return mask != nullptr ? 0 : plain_end;
}

template <int kC>
__device__ __forceinline__ void zero_all(float (&acc)[kC][8][4]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][n][e] = 0.f;
    }
  }
}

// The groups' partial scores of one k-tile where they split D (each forms
// s over its half of the columns): each group writes its kArrays
// accumulators into its slots of the exchange ex (slot i of thread tid at
// i 128 + tid), named barrier 5 of both groups passes, and each adds the
// other's: s_0 + s_1 in both groups alike (a + b == b + a). The caller
// alternates two exchanges by the tile's parity, so a group's next writes
// never meet the other's reads.
template <int kN, int kArrays>
__device__ __forceinline__ void exchange_scores(float (&s)[kArrays][kN / 8][4], float* ex,
                                                int grp, int tid) {
  constexpr int kSlots = kArrays * kN / 2;
  float* mine = ex + grp * kSlots * 128;
  const float* theirs = ex + (grp ^ 1) * kSlots * 128;
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[((a * kN / 8 + n) * 4 + e) * 128 + tid] = s[a][n][e];
    }
  }
  named_sync(5, 256);
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[a][n][e] += theirs[((a * kN / 8 + n) * 4 + e) * 128 + tid];
    }
  }
}

// Keeps the compiler from moving shared-memory reads across it: without
// it ptxas hoists a merge's reads of the ring ahead of its stores, and K1
// spilled 32 bytes at D = 64.
__device__ __forceinline__ void compiler_fence() { asm volatile("" ::: "memory"); }

// Group 1 hands its 64 x D sum acc (accumulator layout) to group 0 through
// `room` (register i of thread tid at room[i 128 + tid]), after named
// barrier 5 of both groups: every group is past its last tile, so the
// ring is free; the caller's second barrier 5 publishes it.
template <int kC>
__device__ __forceinline__ void hand_over(const float (&acc)[kC][8][4], float* room, int tid) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) room[((c * 8 + n) * 4 + e) * 128 + tid] = acc[c][n][e];
    }
  }
}

// ---------------------------------------------------------------------------
// K1, forward: flash_fwd_tma_f32_kernel<D>.
//
// Grid (BH, q-tiles of 64 rows), heaviest causal tile first. The producer
// loads the 64 x D Q tile once, then K and V tiles of kN keys through a
// ring of kStages (design note 2). Per k-tile a group that takes it:
// 1. waits for the stage and forms S = Q.K^T (64 x kN f32) as 3xTF32
//    (scores_3xtf32: Q split in registers, K's big and small planes; at D
//    = 256 over its half of D, then the exchange);
// 2. takes the online softmax in base 2 (fwd_softmax, flash_attention_tma.cu's;
//    masked tiles: causal -1e30, then the bias) and, once every S product
//    that reads K is past, writes P's planes into the stage's K room (at
//    D = 256 group 1's into K small's) and the rows' correction factors
//    beside them;
// 3. forms each of its 64 output columns' part of O^T = V^T.P^T from zero
//    and adds it to O^T corr (design note 3); releases the stage.
// Epilogue: at D = 64 and 128 group 1's O^T, row maxima and sums go
// through the ring to group 0, which merges the two states (max m, each
// part scaled by 2^(m_G - m)), normalises, and writes O and lse; at D =
// 256 each group normalises and writes its own columns. Rows past Tq are
// not written.
// ---------------------------------------------------------------------------
template <int D>
struct TmaFwdF32Shape {
  static constexpr bool kSplitD = D == 256;  // the groups split D, else the k-tiles (note 2)
  static constexpr int kN = D == 64 ? 64 : D == 128 ? 32 : 16;  // keys a k-tile
  static constexpr int kStages = D == 256 ? 3 : 4;
  static constexpr int kTileBytes = kN * D * 4;                  // K, K's small plane or V
  static constexpr int kQBytes = kF32Rows * D * 4;
  static constexpr int kStageBytes = 3 * kTileBytes;  // K, K small, V
  static constexpr int kExchangeFloats = 2 * (kN / 2) * 128;  // both groups' S halves
  // Byte offsets from the 1 KB aligned base.
  static constexpr int kRing = kQBytes;
  static constexpr int kBias = kRing + kStages * kStageBytes;
  static constexpr int kCorr = kBias + kStages * kN * 4;  // each group's 64 row factors
  static constexpr int kExchange = kCorr + 2 * kF32Rows * 4;  // two, by the tile's parity
  static constexpr int kBars = kExchange + (kSplitD ? 2 * kExchangeFloats * 4 : 0);
  static constexpr size_t kSmemBytes = kAlign + kBars + (1 + 3 * kStages) * 8;
  static_assert(kSmemBytes <= kTmaMaxSmem, "K1's tiles do not fit a CTA");
  static_assert((kSplitD ? 1 : 2) * kTileBytes >= kF32Rows * 2 * kN * 4,
                "P's planes do not fit their room");
  static_assert(kSplitD || kStages * kStageBytes >= kQBytes + 4 * kF32Rows * 4,
                "the merge does not fit");
};

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_tma_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const uint8_t* __restrict__ mask, float* __restrict__ out,
                             Strides os, float* __restrict__ lse, int heads, int tq, int tk,
                             float scale, int causal) {
  using Shape = TmaFwdF32Shape<D>;
  constexpr int kN = Shape::kN, kS = Shape::kStages, kTile = kN * D;
  constexpr int kStageFloats = Shape::kStageBytes / 4;
  constexpr bool kSplitD = Shape::kSplitD;
  constexpr int kDg = kSplitD ? D / 2 : D;  // the columns a group contracts S over and owns of O
  constexpr int kChunk = 4;                 // k8 steps a score commit group: a box
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kAlign - smem_addr(smem) % kAlign) % kAlign;
  float* sq = reinterpret_cast<float*>(base);
  float* ring = reinterpret_cast<float*>(base + Shape::kRing);
  float* sbias = reinterpret_cast<float*>(base + Shape::kBias);
  float* scorr = reinterpret_cast<float*>(base + Shape::kCorr);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(base + Shape::kBars);
  uint64_t* land = bar_q + 1;
  uint64_t* full = land + kS;
  uint64_t* empty = full + kS;

  const int bh = blockIdx.x;
  const Head hb = head_of(bh, heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;  // causal: the longest k loops first
  int nk = (tk + kN - 1) / kN;
  if (causal) nk = min(nk, (q0 + kF32Rows - 1) / kN + 1);  // k-tiles past the diagonal see nothing

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&land[s], 1);
      mbar_init(&full[s], kHelpers);
      mbar_init(&empty[s], kSplitD ? 8 : 4);  // the warps of the groups that take the tile
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    produce<D, kN, kS, kStageFloats, 2 * kTile, false>(
        [&] {
          mbar_arrive_expect_tx(bar_q, Shape::kQBytes);
          tma_load_f32<D>(sq, q_map, bar_q, kF32Rows, q0, hb);
        },
        key_bias_terms<kN>(sbias, mask, heads, tk, bh), ring, land, full, empty, k_map, v_map, 0,
        nk, hb);
    return;
  }

  setmaxnreg_inc<kF32ConsumerRegs>();
  const int grp = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + 16 * w + g, q0 + 16 * w + g + 8};
  const int c0 = kSplitD ? grp * kDg : 0;  // the group's first column of D
  float* gcorr = scorr + grp * kF32Rows;
  float* ex = reinterpret_cast<float*>(base + Shape::kExchange);
  float o[kDg / 64][8][4];  // O^T: 64 output columns each, against the 64 rows
  zero_all(o);
  float m[2] = {kNegInf, kNegInf};  // running max of rows row[0], row[1] (base 2)
  float l[2] = {0.f, 0.f};          // this lane's part of their normalisers
  const float scale2 = scale * kLog2e;
  mbar_wait(bar_q, 0);

  auto step = [&](int j, auto masked) {
    const int s = stage_of<kS>(j);
    float* kt = ring + s * kStageFloats;
    const int koff = c0 * kN;  // the group's boxes of K
    mbar_wait(&full[s], phase_of<kS>(j));
    float sc[1][kN / 8][4], corr[2];
    scores_3xtf32<kDg, kN, kChunk, 1>(sc, {sq + c0 * kF32Rows}, {kt + koff},
                                      {kt + kTile + koff}, w, g, t);
    float* pl = kt;  // P's planes
    if constexpr (kSplitD) {  // both groups' S products are past: K's room is free
      exchange_scores<kN, 1>(sc, ex + (j & 1) * Shape::kExchangeFloats, grp, tid);
      pl = kt + grp * kTile;  // group 0's P in K's room, group 1's in K small's
    }
    fwd_softmax<kN, decltype(masked)::value>(sc[0], m, l, corr, sbias + s * kN, j * kN, row, t,
                                             scale2, causal);
    if constexpr (!kSplitD) named_sync(1 + grp, 128);  // the group's S products have read K
    store_planes<kN>(pl, sc[0], w, g, t);
    if (t == 0) {
      gcorr[16 * w + g] = corr[0];
      gcorr[16 * w + g + 8] = corr[1];
    }
    fence_async_shared();
    named_sync(1 + grp, 128);
    float cq[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 c = *reinterpret_cast<const float2*>(gcorr + 8 * n + 2 * t);
      cq[n][0] = c.x;
      cq[n][1] = c.y;
    }
#pragma unroll
    for (int mt = 0; mt < kDg / 64; ++mt) {
      float part[8][4];
      planes_product<kN>(part, kt + 2 * kTile, pl, c0 / 64 + mt, w, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] = fmaf(o[mt][n][e], cq[n][e & 1], part[n][e]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  const int plain_end = plain_tiles<kN>(nk, tk, q0, causal, mask);
  if constexpr (kSplitD)
    run_tiles(0, plain_end, nk, step);
  else
    run_group_tiles(grp, plain_end, nk, step);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* ob = out + head_offset(os, bh, heads) + q0 * os.t;
  const int ld = (int)os.t;  // rows_fit: q ld fits 32 bits
  if constexpr (kSplitD) {
    // Both groups hold the same softmax state: each normalises and writes
    // its own columns of O (1 / l of each row through the group's factor
    // slots, once every warp has read the last tile's factors); group 0
    // writes lse.
    float lc[2];
    named_sync(1 + grp, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lc[h] = fmaxf(l[h], 1e-30f);
      if (t == 0) gcorr[16 * w + g + 8 * h] = 1.f / lc[h];
    }
    named_sync(1 + grp, 128);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int q = 8 * n + 2 * t + e1;
        const float inv = gcorr[q];
        if (q0 + q >= tq) continue;
#pragma unroll
        for (int mt = 0; mt < kDg / 64; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ob[q * ld + c0 + 64 * mt + 16 * w + g + 8 * h] = o[mt][n][2 * h + e1] * inv;
        }
      }
    }
    if (grp == 0 && t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row[h] < tq) lse[(size_t)bh * tq + row[h]] = m[h] / kLog2e + logf(lc[h]);
    }
    return;
  }
  // Merge the groups' states (group 1's through the ring) and store.
  float* ml = ring + kF32Rows * D;  // group G's row maxima at G 128, sums at G 128 + 64
  named_sync(5, 256);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml[grp * 128 + 16 * w + g + 8 * h] = m[h];
      ml[grp * 128 + 64 + 16 * w + g + 8 * h] = l[h];
    }
  }
  if (grp == 1) hand_over(o, ring, tid);
  named_sync(5, 256);
  if (grp == 1) return;
  // The merged state of query q: max mq, lc the sum, a0 and a1 the groups'
  // factors over it.
  auto merged = [&](int q, float& mq, float& lc, float& a0, float& a1) {
    mq = fmaxf(ml[q], ml[128 + q]);
    const float c0 = fast_exp2(ml[q] - mq), c1 = fast_exp2(ml[128 + q] - mq);
    lc = fmaxf(ml[64 + q] * c0 + ml[192 + q] * c1, 1e-30f);
    a0 = c0 / lc;
    a1 = c1 / lc;
  };
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int q = 8 * n + 2 * t + e1;
      float mq, lc, a0, a1;
      merged(q, mq, lc, a0, a1);
      if (q0 + q >= tq) continue;
#pragma unroll
      for (int mt = 0; mt < kDg / 64; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + e1;
          ob[q * ld + 64 * mt + 16 * w + g + 8 * h] =
              o[mt][n][e] * a0 + ring[((mt * 8 + n) * 4 + e) * 128 + tid] * a1;
        }
      }
    }
    compiler_fence();  // one column pair's reads of the ring live at a time
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 16 * w + g + 8 * h;
      float mq, lc, a0, a1;
      merged(q, mq, lc, a0, a1);
      if (q0 + q < tq) lse[(size_t)bh * tq + q0 + q] = mq / kLog2e + logf(lc);
    }
  }
}

// ---------------------------------------------------------------------------
// K2, dQ: flash_dq_tma_f32_kernel<D>.
//
// Grid (BH, q-tiles of 64 rows), heaviest causal tile first, as K1's. The
// producer loads the 64 x D Q and dO tiles once, under one barrier, then K
// and V tiles of kN keys through a ring of kStages; the helpers stage both
// small planes. Per k-tile a group that takes it:
// 1. forms S = Q.K^T and dP = dO.V^T as 3xTF32, both products of a chunk
//    in one commit group (scores_3xtf32; at D = 256 over its half of D,
//    then the exchange);
// 2. forms P = 2^(S scale log2(e) - lse2) and dS = P (dP - delta) scale
//    (dq_terms, flash_attention_tma.cu's; masked tiles: causal -1e30, then
//    the key bias, p = 0 where that is <= -5e29) and, once every dP
//    product that reads V is past, writes dS's planes into the stage's V
//    room (at D = 256 group 1's into V small's);
// 3. forms each of its 64 columns' part of dQ^T = K^T.dS^T from zero and
//    adds it to dQ^T in f32; releases the stage.
// Epilogue: at D = 64 and 128 group 0 adds group 1's dQ^T (through the
// ring) to its own and writes dQ; at D = 256 each group writes its own
// columns. Rows past Tq are not written. A row that sees no key has every
// p = 0, so its dQ is exactly 0.
// ---------------------------------------------------------------------------
template <int D>
struct TmaDqF32Shape {
  static constexpr bool kSplitD = D == 256;  // the groups split D, else the k-tiles (note 2)
  static constexpr int kN = D == 64 ? 64 : D == 128 ? 32 : 8;  // keys a k-tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTileBytes = kN * D * 4;  // K, V or a small plane
  static constexpr int kQBytes = kF32Rows * D * 4;  // the Q or dO tile
  static constexpr int kStageBytes = 4 * kTileBytes;  // K, K small, V, V small
  static constexpr int kExchangeFloats = 2 * 2 * (kN / 2) * 128;  // both groups' S and dP halves
  // Byte offsets from the 1 KB aligned base.
  static constexpr int kG = kQBytes;
  static constexpr int kRing = 2 * kQBytes;
  static constexpr int kBias = kRing + kStages * kStageBytes;
  static constexpr int kExchange = kBias + kStages * kN * 4;  // two, by the tile's parity
  static constexpr int kBars = kExchange + (kSplitD ? 2 * kExchangeFloats * 4 : 0);
  static constexpr size_t kSmemBytes = kAlign + kBars + (1 + 3 * kStages) * 8;
  static_assert(kSmemBytes <= kTmaMaxSmem, "K2's tiles do not fit a CTA");
  static_assert((kSplitD ? 1 : 2) * kTileBytes >= kF32Rows * 2 * kN * 4,
                "dS's planes do not fit their room");
  static_assert(kSplitD || kStages * kStageBytes >= kQBytes, "the merge does not fit");
};

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_dq_tma_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap g_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const uint8_t* __restrict__ mask, float* __restrict__ dq,
                            Strides dqs, int heads, int tq, int tk, float scale, int causal) {
  using Shape = TmaDqF32Shape<D>;
  constexpr int kN = Shape::kN, kS = Shape::kStages, kTile = kN * D;
  constexpr int kStageFloats = Shape::kStageBytes / 4;
  constexpr bool kSplitD = Shape::kSplitD;
  constexpr int kDg = kSplitD ? D / 2 : D;  // the columns a group contracts over and owns of dQ
  // k8 steps of S and of dP a commit group (two sets of split fragments of
  // both beside dQ^T, S and dP; two steps spilled at D = 64).
  constexpr int kChunk = D == 64 ? 1 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kAlign - smem_addr(smem) % kAlign) % kAlign;
  float* sq = reinterpret_cast<float*>(base);
  float* sg = reinterpret_cast<float*>(base + Shape::kG);
  float* ring = reinterpret_cast<float*>(base + Shape::kRing);
  float* sbias = reinterpret_cast<float*>(base + Shape::kBias);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(base + Shape::kBars);
  uint64_t* land = bar_q + 1;
  uint64_t* full = land + kS;
  uint64_t* empty = full + kS;

  const int bh = blockIdx.x;
  const Head hb = head_of(bh, heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;  // causal: the longest k loops first
  int nk = (tk + kN - 1) / kN;
  if (causal) nk = min(nk, (q0 + kF32Rows - 1) / kN + 1);  // k-tiles past the diagonal see nothing

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&land[s], 1);
      mbar_init(&full[s], kHelpers);
      mbar_init(&empty[s], kSplitD ? 8 : 4);  // the warps of the groups that take the tile
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    produce<D, kN, kS, kStageFloats, 2 * kTile, true>(
        [&] {
          mbar_arrive_expect_tx(bar_q, 2 * Shape::kQBytes);
          tma_load_f32<D>(sq, q_map, bar_q, kF32Rows, q0, hb);
          tma_load_f32<D>(sg, g_map, bar_q, kF32Rows, q0, hb);
        },
        key_bias_terms<kN>(sbias, mask, heads, tk, bh), ring, land, full, empty, k_map, v_map, 0,
        nk, hb);
    return;
  }

  setmaxnreg_inc<kF32ConsumerRegs>();
  const int grp = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + 16 * w + g, q0 + 16 * w + g + 8};
  // lse (base 2) and delta of the lane's rows; a row past Tq reads 0 (its
  // Q and dO rows land as zeros, so its dS is 0) and is not stored.
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < tq;
    lse2[h] = in ? lse[(size_t)bh * tq + row[h]] * kLog2e : 0.f;
    dl[h] = in ? delta[(size_t)bh * tq + row[h]] : 0.f;
  }
  const int c0 = kSplitD ? grp * kDg : 0;  // the group's first column of D
  float* ex = reinterpret_cast<float*>(base + Shape::kExchange);
  float acc[kDg / 64][8][4];  // dQ^T: 64 columns of dQ each, against the 64 rows
  zero_all(acc);
  const float scale2 = scale * kLog2e;
  mbar_wait(bar_q, 0);

  auto step = [&](int j, auto masked) {
    const int s = stage_of<kS>(j);
    float* kt = ring + s * kStageFloats;
    float* vt = kt + 2 * kTile;
    const int koff = c0 * kN;  // the group's boxes of K and V
    mbar_wait(&full[s], phase_of<kS>(j));
    float sd[2][kN / 8][4];  // S, then dP and dS
    scores_3xtf32<kDg, kN, kChunk, 2>(sd, {sq + c0 * kF32Rows, sg + c0 * kF32Rows},
                                      {kt + koff, vt + koff},
                                      {kt + kTile + koff, vt + kTile + koff}, w, g, t);
    float* pl = vt;  // dS's planes
    if constexpr (kSplitD) {  // both groups' S and dP products are past: V's room is free
      exchange_scores<kN, 2>(sd, ex + (j & 1) * Shape::kExchangeFloats, grp, tid);
      pl = vt + grp * kTile;  // group 0's dS in V's room, group 1's in V small's
    }
    dq_terms<kN, decltype(masked)::value>(sd[0], sd[1], sbias + s * kN, j * kN, row, t, lse2, dl,
                                          scale, scale2, causal);
    if constexpr (!kSplitD) named_sync(1 + grp, 128);  // the group's dP products have read V
    store_planes<kN>(pl, sd[1], w, g, t);
    fence_async_shared();
    named_sync(1 + grp, 128);
#pragma unroll
    for (int mt = 0; mt < kDg / 64; ++mt) {
      float part[8][4];
      planes_product<kN>(part, kt, pl, c0 / 64 + mt, w, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] += part[n][e];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  const int plain_end = plain_tiles<kN>(nk, tk, q0, causal, mask);
  float* dqb = dq + head_offset(dqs, bh, heads) + q0 * dqs.t;
  const int ld = (int)dqs.t;  // rows_fit: q ld fits 32 bits
  if constexpr (kSplitD) {  // each group writes its own columns of dQ
    run_tiles(0, plain_end, nk, step);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * n + 2 * t + (e & 1);
        if (q0 + q >= tq) continue;
#pragma unroll
        for (int mt = 0; mt < kDg / 64; ++mt)
          dqb[q * ld + c0 + 64 * mt + 16 * w + g + 8 * (e >> 1)] = acc[mt][n][e];
      }
    }
    return;
  }
  run_group_tiles(grp, plain_end, nk, step);

  named_sync(5, 256);  // both groups are past their last tile: the ring is free
  if (grp == 1) hand_over(acc, ring, tid);
  named_sync(5, 256);
  if (grp == 1) return;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = 8 * n + 2 * t + (e & 1);
      if (q0 + q >= tq) continue;
#pragma unroll
      for (int mt = 0; mt < kDg / 64; ++mt)
        dqb[q * ld + 64 * mt + 16 * w + g + 8 * (e >> 1)] =
            acc[mt][n][e] + ring[((mt * 8 + n) * 4 + e) * 128 + tid];
    }
    compiler_fence();  // one column pair's reads of the ring live at a time
  }
}

// x (64 x kN, accumulator layout) read back from the planes at pl as
// store_planes wrote them: big + small, the small plane's word less the
// 0x1000 split_tf32 rounds it by, which gives back x exactly (big and x -
// big are both exact in f32).
template <int kN>
__device__ __forceinline__ void load_planes(float (&x)[kN / 8][4], const float* pl, int w, int g,
                                            int t) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(pl);
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + g + 8 * h;
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        uint32_t word[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int f = p * kN + 8 * n + t;
          word[p] = u[(f / kF32BoxCols) * kF32BoxFloats + swz(r, f % kF32BoxCols + 4 * e1)];
        }
        x[n][2 * h + e1] = __uint_as_float(word[0]) + __uint_as_float(word[1] - 0x1000u);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3, dK and dV: flash_dkv_tma_f32_kernel<D>.
//
// Grid (BH, k-tiles of 64 keys), heaviest causal tile first; a CTA walks
// the q-tiles of kQ queries from the causal diagonal on. The producer
// loads the CTA's 64 x D K and V tiles once, under one barrier, then Q and
// dO tiles through a ring of kStages; the helpers stage both small planes
// and the tile's lse (base 2) and delta (0 past Tq). The two consumer
// groups share the 64 keys and split the products (design note 5): per
// q-tile
// - group 0 forms S^T = K.Q^T (64 keys x kQ, 3xTF32; K is A, split from
//   its resident landing as read, Q is B, its landing and small plane),
//   P^T = exp(S^T scale - lse) (dkv_probs: the key's bias; masked tiles:
//   causal and past Tq; p = 0 there), writes P^T's planes (into Q small's
//   room, or at D = 64 a room of the stage's own), arrives on handed[s],
//   and adds each of its 64 columns' part of dV^T = dO^T.P, formed from
//   zero over the tile (planes_product: dO^T split from dO's landing), to
//   dV^T in f32;
// - group 1 forms dP^T = V.dO^T the same way, waits for handed[s], reads
//   P^T back from group 0's planes (load_planes, exact), forms dS^T = P^T
//   (dP^T - delta) scale (dkv_grads), writes its planes (into dO small's
//   room, or a room of its own at D = 64) and adds the parts of dK^T =
//   Q^T.dS to dK^T.
// Each group releases the stage after its last product. Epilogue: group 0
// writes dV, group 1 dK, from their sums; keys past Tk are not written. A
// key that is masked or past Tk has every p = 0, so its dK and dV are
// exactly 0.
// ---------------------------------------------------------------------------
template <int D>
struct TmaDkvF32Shape {
  static constexpr int kKeys = kF32Rows;  // keys a CTA owns, both groups'
  static constexpr int kQ = D == 256 ? 16 : 32;  // queries a q-tile
  static constexpr int kStages = D == 64 ? 3 : D == 256 ? 1 : 2;
  // k8 steps of a score product a commit group (two sets of split
  // fragments beside the group's sum), and the keys of each part of an
  // output product.
  static constexpr int kChunk = D == 256 ? 1 : 2;
  static constexpr int kPartKeys = D == 256 ? 32 : 64;
  // m-tiles of a group's sum kept in shared memory (design note 5).
  static constexpr int kStash = D == 256 ? 1 : 0;
  // One loop over the q-tiles, the masked terms behind a branch, rather
  // than a loop for each kind of tile (as run_tiles runs them).
  static constexpr bool kOneLoop = D == 256;
  // Registers a thread of the producer and of the consumers (128 x
  // kProducerRegs + 256 x kConsumerRegs within the launch's 384 x 168).
  static constexpr int kProducerRegs = D == 256 ? 24 : kF32ProducerRegs;
  static constexpr int kConsumerRegs = D == 256 ? 240 : kF32ConsumerRegs;
  static constexpr bool kOwnPlanes = D == 64;  // P^T's and dS^T's planes in rooms of their own
  static constexpr int kTileBytes = kQ * D * 4;           // Q, dO or a small plane
  static constexpr int kPlaneBytes = kKeys * 2 * kQ * 4;  // P^T's or dS^T's big and small planes
  static constexpr int kKVBytes = kKeys * D * 4;          // K or V
  static constexpr int kStageBytes = 4 * kTileBytes + (kOwnPlanes ? 2 * kPlaneBytes : 0);
  // Byte offsets from the 1 KB aligned base.
  static constexpr int kV = kKVBytes;
  static constexpr int kRing = 2 * kKVBytes;
  static constexpr int kTerms = kRing + kStages * kStageBytes;  // lse2, then delta, per stage
  static constexpr int kKeyBias = kTerms + 2 * kStages * kQ * 4;  // the 64 keys' bias
  static constexpr int kBounds = kKeyBias + kKeys * 4;  // each group's copy of the loop's bounds
  static constexpr int kStashAt = kBounds + 2 * 4 * 4;  // both groups' stashes
  static constexpr int kBars = kStashAt + kStash * 2 * 32 * 128 * 4;
  static constexpr size_t kSmemBytes = kAlign + kBars + (1 + 4 * kStages) * 8;
  static_assert(kSmemBytes <= kTmaMaxSmem, "K3's tiles do not fit a CTA");
  static_assert(kOwnPlanes || kTileBytes >= kPlaneBytes, "the planes do not fit their room");
};

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_dkv_tma_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap g_map,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const uint8_t* __restrict__ mask, float* __restrict__ dk,
                             Strides dks, float* __restrict__ dv, Strides dvs, int heads, int tq,
                             int tk, float scale, int causal) {
  using Shape = TmaDkvF32Shape<D>;
  constexpr int kQ = Shape::kQ, kS = Shape::kStages, kTile = kQ * D;
  constexpr int kStageFloats = Shape::kStageBytes / 4, kPlaneFloats = Shape::kPlaneBytes / 4;
  constexpr int kChunk = Shape::kChunk, kM = Shape::kPartKeys;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kAlign - smem_addr(smem) % kAlign) % kAlign;
  float* sk = reinterpret_cast<float*>(base);
  float* sv = reinterpret_cast<float*>(base + Shape::kV);
  float* ring = reinterpret_cast<float*>(base + Shape::kRing);
  float* slse = reinterpret_cast<float*>(base + Shape::kTerms);
  float* sdelta = slse + kS * kQ;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(base + Shape::kBars);
  uint64_t* land = bar_kv + 1;
  uint64_t* full = land + kS;
  uint64_t* empty = full + kS;
  uint64_t* handed = empty + kS;

  const int bh = blockIdx.x;
  const Head hb = head_of(bh, heads);
  const int k0 = blockIdx.y * Shape::kKeys;
  const int qt0 = causal ? k0 / kQ : 0;  // q-tiles above the diagonal see none of these keys
  const int tiles = max((tq + kQ - 1) / kQ - qt0, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&land[s], 1);
      mbar_init(&full[s], kHelpers);
      mbar_init(&empty[s], 8);     // every consumer warp
      mbar_init(&handed[s], 128);  // every thread of group 0, after its P^T stores
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    const float* lse_b = lse + (size_t)bh * tq;
    const float* delta_b = delta + (size_t)bh * tq;
    produce<D, kQ, kS, kStageFloats, 2 * kTile, true, Shape::kProducerRegs>(
        [&] {
          mbar_arrive_expect_tx(bar_kv, 2 * Shape::kKVBytes);
          tma_load_f32<D>(sk, k_map, bar_kv, Shape::kKeys, k0, hb);
          tma_load_f32<D>(sv, v_map, bar_kv, Shape::kKeys, k0, hb);
        },
        [&](int s, int j, int h) {
          for (int i = h; i < kQ; i += kHelpers) {
            const int q = j * kQ + i;
            slse[s * kQ + i] = q < tq ? lse_b[q] * kLog2e : 0.f;
            sdelta[s * kQ + i] = q < tq ? delta_b[q] : 0.f;
          }
        },
        ring, land, full, empty, q_map, g_map, qt0, tiles, hb);
    return;
  }

  setmaxnreg_inc<Shape::kConsumerRegs>();
  const int grp = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // The keys' bias (0, -1e30 masked, -inf past Tk) and the q-tile loop's
  // bounds go to shared memory and are read back where they are used,
  // rather than held in registers beside the sum: tiles [0, bound[0]) hold
  // a query before one of the keys (causal), tiles from bound[1] on pass
  // Tq, bound[2] is the tile count.
  float* skey = reinterpret_cast<float*>(base + Shape::kKeyBias);
  volatile int* bound = reinterpret_cast<int*>(base + Shape::kBounds) + 4 * grp;
  if (grp == 0 && t == 0) {
    const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
    skey[16 * w + g] = key_bias(mask_row, k0 + 16 * w + g, tk);
    skey[16 * w + g + 8] = key_bias(mask_row, k0 + 16 * w + g + 8, tk);
  }
  if (tid == 0) {
    const int masked_end =
        causal ? min(max((k0 + Shape::kKeys - 1 + kQ - 1) / kQ - qt0, 0), tiles) : 0;
    bound[0] = masked_end;
    bound[1] = max(min(tq / kQ - qt0, tiles), masked_end);
    bound[2] = tiles;
  }
  named_sync(1 + grp, 128);
  const float scale2 = scale * kLog2e;
  // The group's sum (group 0: dV^T, group 1: dK^T), m-tiles of 64 columns
  // of D by the 64 keys: the first kRegTiles in registers, the rest in the
  // group's stash in shared memory (slot j of thread tid at stash[j 128]).
  constexpr int kRegTiles = D / 64 - Shape::kStash;
  float acc[kRegTiles][8][4];
  float* stash = reinterpret_cast<float*>(base + Shape::kStashAt) +
                 grp * Shape::kStash * 32 * 128 + tid;
  zero_all(acc);
  for (int j = 0; j < Shape::kStash * 32; ++j) stash[j * 128] = 0.f;
  mbar_wait(bar_kv, 0);

  // Tile i, the masked terms as `masked` says (a type, or a bool tested
  // at run time).
  auto step = [&](int i, auto masked) {
    const int s = stage_of<kS>(i);
    float* qt = ring + s * kStageFloats;  // Q, Q small, dO, dO small[, P^T's, dS^T's planes]
    float* gt = qt + 2 * kTile;
    float* pl_p = Shape::kOwnPlanes ? qt + 4 * kTile : qt + kTile;
    float* pl_ds = Shape::kOwnPlanes ? pl_p + kPlaneFloats : gt + kTile;
    mbar_wait(&full[s], phase_of<kS>(i));
    float sc[1][kQ / 8][4];  // S^T, then P^T (group 0); dP^T, then dS^T (group 1)
    scores_3xtf32<D, kQ, kChunk, 1>(sc, {grp == 0 ? sk : sv}, {grp == 0 ? qt : gt},
                                    {(grp == 0 ? qt : gt) + kTile}, w, g, t);
    float* pl = grp == 0 ? pl_p : pl_ds;
    if (grp == 0) {
      const int key[2] = {k0 + 16 * w + g, k0 + 16 * w + g + 8};
      const bool key_live[2] = {skey[16 * w + g] == 0.f, skey[16 * w + g + 8] == 0.f};
      auto probs = [&](auto m) {
        dkv_probs<decltype(m)::value>(sc[0], slse + s * kQ, (qt0 + i) * kQ, t, key, key_live, tq,
                                      scale2, causal);
      };
      if constexpr (std::is_same_v<decltype(masked), bool>) {
        if (masked)
          probs(std::true_type{});
        else
          probs(std::false_type{});
      } else {
        probs(masked);
      }
    } else {
      float p[kQ / 8][4];
      mbar_wait(&handed[s], phase_of<kS>(i));
      load_planes<kQ>(p, pl_p, w, g, t);
      dkv_grads(sc[0], p, sdelta + s * kQ, t, scale);
    }
    named_sync(1 + grp, 128);  // the group's score products have read the small plane
    store_planes<kQ>(pl, sc[0], w, g, t);
    fence_async_shared();
    if (grp == 0) mbar_arrive(&handed[s]);
    named_sync(1 + grp, 128);
    // Each part of X^T.Y^T (x the landed dO or Q, pl the planes of P^T or
    // dS^T), formed from zero, added to the sum.
    const float* x = grp == 0 ? gt : qt;
#pragma unroll
    for (int mt = 0; mt < D / 64; ++mt) {
#pragma unroll
      for (int m0 = 0; m0 < 64; m0 += kM) {
        float part[kM / 8][4];
        planes_product<kQ, kM>(part, x, pl, mt, w, g, t, m0);
#pragma unroll
        for (int n = 0; n < kM / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (mt < kRegTiles)
              acc[mt < kRegTiles ? mt : 0][m0 / 8 + n][e] += part[n][e];
            else
              stash[(((mt - kRegTiles) * 8 + m0 / 8 + n) * 4 + e) * 128] += part[n][e];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  // The q-tiles: one loop, or a loop for each kind of tile (run_tiles').
  int i = 0;
  if constexpr (Shape::kOneLoop) {
    for (; i < bound[2]; ++i) step(i, i < bound[0] || i >= bound[1]);
  } else {
    for (; i < bound[0]; ++i) step(i, std::true_type{});
    for (; i < bound[1]; ++i) step(i, std::false_type{});
    for (; i < bound[2]; ++i) step(i, std::true_type{});
  }

  // Column 64 mt + 16 w + g + 8 (e >> 1) of key 8 n + 2 t + (e & 1) is
  // acc[mt][n][e] (or its stash slot).
  const Strides& os = grp == 0 ? dvs : dks;
  float* out = (grp == 0 ? dv : dk) + head_offset(os, bh, heads) + k0 * os.t;
  const int ld = (int)os.t;  // rows_fit: kk ld fits 32 bits
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 8 * n + 2 * t + (e & 1);
      if (k0 + kk >= tk) continue;
#pragma unroll
      for (int mt = 0; mt < D / 64; ++mt)
        out[kk * ld + 64 * mt + 16 * w + g + 8 * (e >> 1)] =
            mt < kRegTiles ? acc[mt < kRegTiles ? mt : 0][n][e]
                           : stash[(((mt - kRegTiles) * 8 + n) * 4 + e) * 128];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: launchers, occupancy.
// ---------------------------------------------------------------------------

template <int D>
int launch_fwd_tma_f32_as(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                          int heads, int tq, int tk, float scale, int causal,
                          cudaStream_t stream) {
  using Shape = TmaFwdF32Shape<D>;
  CUtensorMap maps[3];
  int err = tensor_map<float>(&maps[0], q, bh, heads, tq, D, kF32Rows);
  if (err == 0) err = tensor_map<float>(&maps[1], k, bh, heads, tk, D, Shape::kN);
  if (err == 0) err = tensor_map<float>(&maps[2], v, bh, heads, tk, D, Shape::kN);
  if (err != 0) return err;
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = set_smem(flash_fwd_tma_f32_kernel<D>, Shape::kSmemBytes, configured);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(bh, (tq + kF32Rows - 1) / kF32Rows);
  flash_fwd_tma_f32_kernel<D><<<grid, kTmaThreads, Shape::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const uint8_t*>(mask), ptr<float>(out), out.s,
      static_cast<float*>(lse), heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_tma_f32_as(View q, View k, View v, View g, const void* lse, const void* delta,
                         const void* mask, View dq, int bh, int heads, int tq, int tk,
                         float scale, int causal, cudaStream_t stream) {
  using Shape = TmaDqF32Shape<D>;
  CUtensorMap maps[4];
  int err = tensor_map<float>(&maps[0], q, bh, heads, tq, D, kF32Rows);
  if (err == 0) err = tensor_map<float>(&maps[1], k, bh, heads, tk, D, Shape::kN);
  if (err == 0) err = tensor_map<float>(&maps[2], v, bh, heads, tk, D, Shape::kN);
  if (err == 0) err = tensor_map<float>(&maps[3], g, bh, heads, tq, D, kF32Rows);
  if (err != 0) return err;
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = set_smem(flash_dq_tma_f32_kernel<D>, Shape::kSmemBytes, configured);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(bh, (tq + kF32Rows - 1) / kF32Rows);
  flash_dq_tma_f32_kernel<D><<<grid, kTmaThreads, Shape::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), ptr<float>(dq), dq.s,
      heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tma_f32_as(View q, View k, View v, View g, const void* lse, const void* delta,
                          const void* mask, View dk, View dv, int bh, int heads, int tq, int tk,
                          float scale, int causal, cudaStream_t stream) {
  using Shape = TmaDkvF32Shape<D>;
  CUtensorMap maps[4];
  int err = tensor_map<float>(&maps[0], q, bh, heads, tq, D, Shape::kQ);
  if (err == 0) err = tensor_map<float>(&maps[1], k, bh, heads, tk, D, Shape::kKeys);
  if (err == 0) err = tensor_map<float>(&maps[2], v, bh, heads, tk, D, Shape::kKeys);
  if (err == 0) err = tensor_map<float>(&maps[3], g, bh, heads, tq, D, Shape::kQ);
  if (err != 0) return err;
  static bool configured[kMaxDevices] = {};
  const cudaError_t set = set_smem(flash_dkv_tma_f32_kernel<D>, Shape::kSmemBytes, configured);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(bh, (tk + Shape::kKeys - 1) / Shape::kKeys);
  flash_dkv_tma_f32_kernel<D><<<grid, kTmaThreads, Shape::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), ptr<float>(dk), dk.s,
      ptr<float>(dv), dv.s, heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

namespace swt {

// Their tile is the CTA's 64 rows (K1's and K2's queries, K3's keys), the
// f32 instances' long tile.
bool tma_f32_tile(int kernel, int d, int tile) {
  return kernel >= 0 && kernel <= 2 && (d == 64 || d == 128 || d == 256) && tile == kF32Rows;
}

int launch_fwd_tma_f32(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                       int heads, int tq, int tk, int d, float scale, int causal,
                       cudaStream_t stream) {
  return by_tma_head_dim(d, [&](auto dd) {
    return launch_fwd_tma_f32_as<decltype(dd)::value>(q, k, v, mask, out, lse, bh, heads, tq, tk,
                                                      scale, causal, stream);
  });
}

int launch_dq_tma_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                      const void* mask, View dq, int bh, int heads, int tq, int tk, int d,
                      float scale, int causal, cudaStream_t stream) {
  return by_tma_head_dim(d, [&](auto dd) {
    return launch_dq_tma_f32_as<decltype(dd)::value>(q, k, v, g, lse, delta, mask, dq, bh, heads,
                                                     tq, tk, scale, causal, stream);
  });
}

int launch_dkv_tma_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                       const void* mask, View dk, View dv, int bh, int heads, int tq, int tk,
                       int d, float scale, int causal, cudaStream_t stream) {
  return by_tma_head_dim(d, [&](auto dd) {
    return launch_dkv_tma_f32_as<decltype(dd)::value>(q, k, v, g, lse, delta, mask, dk, dv, bh,
                                                      heads, tq, tk, scale, causal, stream);
  });
}

int tma_f32_occupancy(int kernel, int d, int* out) {
  return by_tma_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    if (kernel == 0)
      return occupancy(flash_fwd_tma_f32_kernel<D>, kTmaThreads, TmaFwdF32Shape<D>::kSmemBytes,
                       out);
    if (kernel == 1)
      return occupancy(flash_dq_tma_f32_kernel<D>, kTmaThreads, TmaDqF32Shape<D>::kSmemBytes,
                       out);
    if (kernel == 2)
      return occupancy(flash_dkv_tma_f32_kernel<D>, kTmaThreads, TmaDkvF32Shape<D>::kSmemBytes,
                       out);
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace swt
