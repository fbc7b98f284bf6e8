// delta = rowsum(dO * O) of flash attention's backward, in f32:
// flash_bwd_delta, in bf16 and f32.
//
// It replaces no Pallas kernel: the JAX package forms delta in plain jnp
// (shockwave_tpu/ops/flash_attention.py:290-292), which XLA fuses into the
// ops around it on the TPU. In eager PyTorch the same expression,
// (out.float() * g.float()).sum(-1), is four launches (two casts, a
// product and a sum) with f32 temporaries of the whole (B, H, T, D)
// tensor. This kernel reads O and dO once each, as (B, H, T, D) views
// through their strides (the model's (B, T, H, D) tensors in place, as
// K1-K3 read them), sums each row's products in f32 in one pass, and
// writes delta packed (B H, T) f32, as K2 and K3 read it.
//
// Bound on an H100 SXM: bytes. At the bench shape (4, 2048, 8, 64) in bf16
// it reads 16.8 MB and writes 0.26 MB: 5.1 us at 3.35 TB/s.
//
// Design: `lanes` threads own a row (the largest power of two up to 32
// that is at most the row's 16-byte chunks: 8 at D = 64 in bf16); each
// loads its chunks of O and dO with 16-byte loads, multiplies and sums in
// f32, and the row's lanes add their sums with shuffles. A CTA of 256
// threads takes 256 / lanes rows, neighbouring rows side by side, so a
// warp reads whole 128-byte rows.
#include "flash_attention_common.cuh"

namespace {

constexpr int kDeltaThreads = 256;

// The sum of the products of the elements of two 16-byte chunks: 8 bf16 or
// 4 f32 each (a bf16 is the top half of its f32).
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, bf16) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), sum);
    sum = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), sum);
  }
  return sum;
}

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, float) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) sum = fmaf(__uint_as_float(x[i]), __uint_as_float(y[i]), sum);
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, Strides os, const T* __restrict__ g,
                           Strides gs, float* __restrict__ delta, int rows, int heads, int t,
                           int d, int lanes) {
  constexpr int U = 16 / (int)sizeof(T);  // elements of a 16-byte chunk
  const int r = blockIdx.x * (kDeltaThreads / lanes) + (int)threadIdx.x / lanes;
  const int lane = (int)threadIdx.x % lanes;
  float sum = 0.f;
  if (r < rows) {
    const int bh = r / t, row = r % t;
    const T* o_row = o + head_offset(os, bh, heads) + row * os.t;
    const T* g_row = g + head_offset(gs, bh, heads) + row * gs.t;
    for (int c = lane * U; c < d; c += lanes * U)
      sum += dot16(*reinterpret_cast<const uint4*>(o_row + c),
                   *reinterpret_cast<const uint4*>(g_row + c), T{});
  }
  // Every lane of the warp takes part; a row's lanes are an aligned group.
  for (int off = lanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (r < rows && lane == 0) delta[r] = sum;
}

template <typename T>
int launch_delta(View o, View g, void* delta, int bh, int heads, int t, int d,
                 cudaStream_t stream) {
  constexpr int U = 16 / (int)sizeof(T);
  if (bh < 1 || t < 1 || d < U || d % U || !all_aligned16((int)sizeof(T), o, g))
    return (int)cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes < 32 && 2 * lanes * U <= d) lanes *= 2;
  const int rows = bh * t, per_cta = kDeltaThreads / lanes;
  flash_bwd_delta_kernel<T><<<(rows + per_cta - 1) / per_cta, kDeltaThreads, 0, stream>>>(
      ptr<const T>(o), o.s, ptr<const T>(g), g.s, static_cast<float*>(delta), rows, heads, t, d,
      lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// delta (bh, t) f32 = rowsum(g * o) of the (B, H, T, D) views o and g (B =
// bh / heads), in bf16 (swt_flash_bwd_delta) or f32 (_f32): d a multiple of
// 16 bytes' elements, every base and stride 16-byte aligned, or
// cudaErrorInvalidValue. Launches on `stream` of `device`; nothing
// synchronises.
int swt_flash_bwd_delta(View o, View g, void* delta, int bh, int heads, int t, int d, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_delta<bf16>(o, g, delta, bh, heads, t, d, static_cast<cudaStream_t>(stream));
}

int swt_flash_bwd_delta_f32(View o, View g, void* delta, int bh, int heads, int t, int d,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_delta<float>(o, g, delta, bh, heads, t, d, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
