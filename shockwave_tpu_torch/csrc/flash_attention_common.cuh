// Building blocks that the narrow kernels (flash_attention.cu), the wide
// ones (flash_attention_wide.cu) and the TMA-fed ones
// (flash_attention_tma.cu) share: cp.async, ldmatrix, mma.sync in bf16 and
// as 3xTF32, named barriers, wgmma in bf16, and the launch helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float minus_infinity() { return __int_as_float(0xff800000); }

}  // namespace

// ---------------------------------------------------------------------------
// The tensors' layout. K1-K3 read q, k, v and dO and write out, dQ, dK and
// dV in place as (B, H, T, D) views with packed columns: the model's (B, T,
// H, D) tensors transposed (row stride H D), a fused QKV projection's
// slices (row stride 3 H D), or packed (BH, T, D) tensors (b = H T D, h =
// T D, t = D). lse and delta stay packed (BH, Tq) f32.
// ---------------------------------------------------------------------------

// Elements between batches, heads and rows; the column stride is 1.
struct Strides {
  long long b, h, t;
};

// What a C entry point takes for each of those tensors, by value: its first
// element and its strides.
struct View {
  void* data;
  Strides s;
};

namespace {

// The offset of (batch, head) pair bh's row 0 (batch bh / heads, head bh
// % heads).
__host__ __device__ __forceinline__ long long head_offset(const Strides& s, int bh, int heads) {
  return (long long)(bh / heads) * s.b + (long long)(bh % heads) * s.h;
}

// cp.async's and TMA's 16-byte rule: the base and every stride of v, in
// bytes, a multiple of 16, no stride negative (`elem`: bytes an element).
inline bool aligned16(const View& v, int elem) {
  const long long s[3] = {v.s.b, v.s.h, v.s.t};
  for (long long x : s)
    if (x < 0 || (x * elem) % 16) return false;
  return reinterpret_cast<uintptr_t>(v.data) % 16 == 0;
}

template <typename... Views>
bool all_aligned16(int elem, const Views&... views) {
  return (aligned16(views, elem) && ...);
}

// The kernels keep a (batch, head)'s row offsets in 32 bits (row ld): its
// t rows of v span under 2^31 elements.
inline bool rows_fit(const View& v, int t) { return (long long)t * v.s.t < (1ll << 31); }

template <typename... Views>
bool all_rows_fit(int t, const Views&... views) {
  return (rows_fit(views, t) && ...);
}

// Whether the views of K1, K2 or K3 (`elem`: bytes an element) keep both
// rules. An entry point returns cudaErrorInvalidValue for views that do
// not (the wrapper hands the kernels packed copies of such views).
inline bool fwd_views_ok(int elem, const View& q, const View& k, const View& v, const View& out,
                         int tq, int tk) {
  return all_aligned16(elem, q, k, v, out) && all_rows_fit(tq, q, out) &&
         all_rows_fit(tk, k, v);
}

inline bool dq_views_ok(int elem, const View& q, const View& k, const View& v, const View& g,
                        const View& dq, int tq, int tk) {
  return all_aligned16(elem, q, k, v, g, dq) && all_rows_fit(tq, q, g, dq) &&
         all_rows_fit(tk, k, v);
}

inline bool dkv_views_ok(int elem, const View& q, const View& k, const View& v, const View& g,
                         const View& dk, const View& dv, int tq, int tk) {
  return all_aligned16(elem, q, k, v, g, dk, dv) && all_rows_fit(tq, q, g) &&
         all_rows_fit(tk, k, v, dk, dv);
}

// A tensor's pointer as the kernels take it.
template <typename T>
T* ptr(const View& v) {
  return static_cast<T*>(v.data);
}

// Additive bias of one key, as the reference's _kbias gives it: 0
// (attend), -1e30 (masked), and -inf past the sequence end.
__device__ __forceinline__ float key_bias(const uint8_t* mask_row, int key, int tk) {
  if (key >= tk) return minus_infinity();
  return (mask_row != nullptr && mask_row[key] == 0) ? kNegInf : 0.f;
}

// ---------------------------------------------------------------------------
// Building blocks of the kernels: cp.async, ldmatrix, mma.sync.
// ---------------------------------------------------------------------------

// Shared tiles keep rows of D + 8 bf16 (D = 64: 144 bytes). The 8 rows an
// ldmatrix phase reads then start in 8 different 16-byte bank groups, so
// neither ldmatrix nor the epilogue's staging stores conflict.
template <int D>
__host__ __device__ constexpr int smem_stride() {
  return D + 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with valid false the 16 bytes are zeroed
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of lane l holds row l/4, columns 2(l%4) and
// 2(l%4)+1 of matrix i (with .trans: of its transpose).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row-major) . b (16x8 bf16, col-major).
// With g = lane / 4 and t = lane % 4: c[0], c[1] are row g, columns
// 2t, 2t+1; c[2], c[3] the same columns of row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand (16 x 16, row-major) at `tile` (row stride S) for this lane.
template <int S>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * S + (lane >> 4) * 8);
}

// B operands of two n8 tiles for A . X^T where X is row-major (rows =
// n): rows 0-7 and 8-15 of `tile`, columns 0-15. b[0], b[1] feed n-tile
// 0, b[2], b[3] n-tile 1.
template <int S>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile, int lane) {
  ldmatrix_x4(b, tile + (((lane >> 4) << 3) + (lane & 7)) * S + ((lane >> 3) & 1) * 8);
}

// B operands of two n8 tiles for A . X where X is row-major (rows = k):
// rows 0-15 of `tile`, columns 0-7 (b[0], b[1]) and 8-15 (b[2], b[3]).
template <int S>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int lane) {
  ldmatrix_x4_trans(b, tile + (((lane >> 3) & 1) * 8 + (lane & 7)) * S + (lane >> 4) * 8);
}

// The A operand of a 16 x 16 slice of probabilities held as two n8
// accumulator tiles: the FA2 repacking, no shared memory.
__device__ __forceinline__ void accum_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}


// ---------------------------------------------------------------------------
// 3xTF32 building blocks of K1 and K3 in f32: the TF32 split, mma.sync
// m16n8k8. g = lane / 4 and t = lane % 4 throughout.
// ---------------------------------------------------------------------------

// The 3xTF32 kernels' shared tiles keep rows of D + 4 floats (D = 64: 272
// bytes): the fragment reads below (row g, column t; or row 2t, column g)
// then fall in 32 different banks, and each row stays 16-byte aligned for
// cp.async.
template <int D>
__host__ __device__ constexpr int f32_stride() {
  return D + 4;
}

// N registers of an f32 operand fragment, each split as x = big + small,
// both TF32.
template <int N>
struct Split {
  uint32_t big[N], small[N];
};

// x = big + small, both TF32, as CUTLASS's fast f32 GEMMs (and so
// PyTorch's f32 attention) split an operand: big is x with the 13 bits
// below TF32's 10 mantissa bits cleared, small = x - big (exact) rounded
// to nearest by adding half of its dropped bits, which stay in place: the
// tensor cores read only a TF32 operand's top 19 bits. Three integer or
// float ops for finite x; cvt.rna.tf32.f32 alone compiles to a longer
// sequence that also screens infinities and NaNs, which these operands
// never are. big.big + big.small + small.big then keeps about 21 bits of
// each product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c (16x8 f32) += a (16x8 TF32, row-major) . b (8x8 TF32, col-major).
// a[0..3] hold (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b0 (t, g),
// b1 (t + 4, g); c as in mma_bf16.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b to f32 accuracy: the two small terms first, then big . big,
// all into the one f32 accumulator.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split<4>& a, const Split<2>& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// The same from a raw f32 tile in shared memory: rows g and g + 8,
// columns [0, 8) at `x` (row stride S), split as they are read. With S =
// D + 4 the 32 lanes' reads fall in 32 different banks.
template <int S>
__device__ __forceinline__ Split<4> split_a_shared(const float* x, int g, int t) {
  const float v[4] = {x[g * S + t], x[(g + 8) * S + t], x[g * S + t + 4], x[(g + 8) * S + t + 4]};
  Split<4> a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], a.big[i], a.small[i]);
  return a;
}

// The B operand of A . X^T for 8 rows of X (the n side) at `x` in shared
// memory, row stride S, 8 columns: b0 = X[g][t], b1 = X[g][t + 4].
template <int S>
__device__ __forceinline__ Split<2> split_bt(const float* x, int g, int t) {
  Split<2> b;
  split_tf32(x[g * S + t], b.big[0], b.small[0]);
  split_tf32(x[g * S + t + 4], b.big[1], b.small[1]);
  return b;
}

// The B operand of A . X for 8 rows of X (the reduction side) at `x`, 8
// columns, with the reduction index permuted: slot t takes row 2t, slot
// t + 4 row 2t + 1, so b0 = X[2t][g] and b1 = X[2t + 1][g]. It pairs with
// accum_to_a_tf32, which permutes A's columns the same way.
template <int S>
__device__ __forceinline__ Split<2> split_b_permuted(const float* x, int g, int t) {
  Split<2> b;
  split_tf32(x[2 * t * S + g], b.big[0], b.small[0]);
  split_tf32(x[(2 * t + 1) * S + g], b.big[1], b.small[1]);
  return b;
}

// A 16x8 accumulator tile c (rows g and g + 8, columns 2t and 2t + 1) as
// a split A operand, its columns permuted as split_b_permuted's rows:
// slot t holds column 2t and slot t + 4 column 2t + 1. Each lane keeps
// its own values; nothing moves across lanes.
__device__ __forceinline__ Split<4> accum_to_a_tf32(const float (&c)[4]) {
  Split<4> a;
  split_tf32(c[0], a.big[0], a.small[0]);  // (g, 2t)
  split_tf32(c[2], a.big[1], a.small[1]);  // (g + 8, 2t)
  split_tf32(c[1], a.big[2], a.small[2]);  // (g, 2t + 1)
  split_tf32(c[3], a.big[3], a.small[3]);  // (g + 8, 2t + 1)
  return a;
}

// ---------------------------------------------------------------------------
// Building blocks of the wgmma kernels (flash_attention_wide.cu,
// flash_attention_tma.cu): named barriers, the async-proxy fence, wgmma's
// matrix descriptors in the 128- and 64-byte swizzles and its bf16 products. A
// warpgroup's accumulator holds warp w's rows 16w..16w + 15 in mma.sync's C
// layout, n8 tile j in d[j].
// ---------------------------------------------------------------------------

// Two adjacent outputs of an accumulator row, (a, b), at p.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// bar.sync and bar.arrive on named barrier `id` (1-15; __syncthreads
// takes 0) of `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Make this thread's landed cp.async copies and its stores to shared
// memory visible to the async proxy, which wgmma reads its shared operands
// through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma matrix descriptor of the tile at p, whose rows are kRowBytes
// long in the swizzle of that width (the PTX ISA's shared-memory matrix
// layouts): 128 bytes, layout type 1 (bits 62-63), or 64 bytes, layout
// type 2. Start address, leading byte offset `lbo` (K-major: unused;
// MN-major: the next 64 or 32 columns), stride byte offset 8 rows
// (1,024 or 512 bytes: the next 8 rows; MN-major: the next 8 reduction
// rows). The pattern repeats every 8 rows, so the tile sits on a
// multiple of that (1 KB or 512 bytes), base offset 0.
template <int kRowBytes = 128>
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo) {
  static_assert(kRowBytes == 128 || kRowBytes == 64, "the 128- or the 64-byte swizzle");
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(8 * kRowBytes >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator (kN n8
// tiles) across the asynchronous wgmma that owns it.
template <int kN>
__device__ __forceinline__ void wgmma_hold(float (&d)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

// The accumulator operand list of a 64 x 64 f32 wgmma (d[j][e]: register 4j
// + e, n8 tile j) and of a 64 x 32 one.
#define SWT_ACC64(d)                                                                              \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),      \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),  \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),  \
      "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),  \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),  \
      "+f"(d[7][2]), "+f"(d[7][3])
#define SWT_ACC32(d)                                                                              \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),      \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),  \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
#define SWT_REGS32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "   \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SWT_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 64 f32) += A . B^T over 16 columns, A (64 x 16) and B (64 x 16)
// bf16 K-major in shared memory at descriptors da and db.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SWT_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SWT_ACC64(d)
      : "l"(da), "l"(db), "r"(1));
}

// The same for a 64 x 32 accumulator: B (32 x 16) K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SWT_REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SWT_ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 f32) += A . B over 16 reduction rows: A (64 x 16 bf16) in
// registers, warp w's rows 16w.. in mma.sync's A layout (accum_to_a), and
// B (16 x 64 bf16) MN-major (rows of 64 columns) at descriptor db.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SWT_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SWT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same for a 64 x 32 accumulator: B (16 x 32 bf16) MN-major (rows of
// 32 columns, the 64-byte swizzle's row) at descriptor db.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SWT_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : SWT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The operand list of a 64 x 128 f32 accumulator (d[j][e]: register 4j + e,
// n8 tile j), and its register list.
#define SWT_ACC128(d)                                                                             \
  SWT_ACC64(d), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]),       \
      "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),               \
      "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),            \
      "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),            \
      "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),            \
      "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),            \
      "+f"(d[15][2]), "+f"(d[15][3])
#define SWT_REGS64                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "   \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "     \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "     \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128 f32) += A . B^T over 16 columns, A (64 x 16) and B (128 x
// 16) bf16 K-major in shared memory at descriptors da and db.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SWT_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SWT_ACC128(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 f32) += A . B^T over 8 columns in TF32: A (64 x 8) in
// registers, warp w's rows 16w.. in mma.sync's m16n8k8 A layout (a[0..3]:
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)), and B (64 x 8) K-major
// at descriptor db. The tensor cores read each operand's top 19 bits.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SWT_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SWT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same for a 64 x 32 accumulator (B 32 x 8).
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SWT_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : SWT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same for a 64 x 16 and a 64 x 8 accumulator (B 16 x 8, 8 x 8).
#define SWT_ACC16(d)                                                                              \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),      \
      "+f"(d[1][2]), "+f"(d[1][3])
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[2][4], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : SWT_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_n8(float (&d)[1][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}"
      ", {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x kN f32) += A . B^T over 8 columns in TF32, kN = 8, 16, 32 or 64.
template <int kN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kN / 8][4], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (kN == 64)
    wgmma_tf32_n64(d, a, db);
  else if constexpr (kN == 32)
    wgmma_tf32_n32(d, a, db);
  else if constexpr (kN == 16)
    wgmma_tf32_n16(d, a, db);
  else
    wgmma_tf32_n8(d, a, db);
}

// d += A . B^T to f32 accuracy as 3xTF32 (mma_3xtf32's three products, the
// small terms first, into the one accumulator): A split in registers, B's
// big plane at descriptor db and its small plane at ds.
template <int kN>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[kN / 8][4], const Split<4>& a,
                                             uint64_t db, uint64_t ds) {
  wgmma_tf32<kN>(d, a.small, db);
  wgmma_tf32<kN>(d, a.big, ds);
  wgmma_tf32<kN>(d, a.big, db);
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

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

// out = {resident CTAs per SM, threads per CTA, dynamic shared bytes,
// registers per thread} of one kernel instantiation.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = threads;
  out[2] = (int)smem;
  out[3] = attr.numRegs;
  return 0;
}

}  // namespace

namespace swt {
// swt_flash_occupancy's kernels 6-11, the wide instances (defined in
// flash_attention_wide.cu): {CTAs per SM, threads, dynamic shared bytes,
// registers} of wide kernel `kernel` at head dim d and tile `tile`.
int wide_occupancy(int kernel, int d, int tile, int* out);

// The TMA-fed K1-K3 in bf16 (defined in flash_attention_tma.cu), which
// take the long tile of kernels 0 (K1), 1 (K2) and 2 (K3) at head dims 64,
// 128 and 256, and of K1 and K3 at 32: whether (d, tile) is theirs, their launches with
// swt_flash_fwd's, swt_flash_dq's and swt_flash_dkv's arguments, and their
// occupancy in the form above.
bool tma_tile(int kernel, int d, int tile);
int launch_fwd_tma(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                   int heads, int tq, int tk, int d, float scale, int causal, cudaStream_t stream);
int launch_dq_tma(View q, View k, View v, View g, const void* lse, const void* delta,
                  const void* mask, View dq, int bh, int heads, int tq, int tk, int d, float scale,
                  int causal, cudaStream_t stream);
int launch_dkv_tma(View q, View k, View v, View g, const void* lse, const void* delta,
                   const void* mask, View dk, View dv, int bh, int heads, int tq, int tk, int d,
                   float scale, int causal, cudaStream_t stream);
int tma_occupancy(int kernel, int d, int* out);

// The TMA-fed K1-K3 in f32 (defined in flash_attention_tma_f32.cu), which
// take the long tile (K1's and K2's query rows, K3's keys: 64, and at D =
// 32 K2's and K3's own) of kernels 0 (K1) at head dims 64, 128 and 256, and
// 1 (K2) and 2 (K3) at 32, 64, 128 and 256, in f32, in the same form.
bool tma_f32_tile(int kernel, int d, int tile);
int launch_fwd_tma_f32(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                       int heads, int tq, int tk, int d, float scale, int causal,
                       cudaStream_t stream);
int launch_dq_tma_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                      const void* mask, View dq, int bh, int heads, int tq, int tk, int d,
                      float scale, int causal, cudaStream_t stream);
int launch_dkv_tma_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                       const void* mask, View dk, View dv, int bh, int heads, int tq, int tk,
                       int d, float scale, int causal, cudaStream_t stream);
int tma_f32_occupancy(int kernel, int d, int* out);
}  // namespace swt
