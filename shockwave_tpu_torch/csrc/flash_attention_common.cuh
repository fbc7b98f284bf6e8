// Building blocks that the narrow kernels (flash_attention.cu) and the
// wide ones (flash_attention_wide.cu) share: cp.async, ldmatrix,
// mma.sync in bf16 and as 3xTF32, and the launch helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float minus_infinity() { return __int_as_float(0xff800000); }

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
}  // namespace swt
