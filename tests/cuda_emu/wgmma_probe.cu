// A probe of the wide K1's wgmma steps (flash_attention_wide.cu) for the
// CPU emulation only: one warpgroup copies A, B and V (64 rows of 128
// bytes each, row-major) into swizzled chunks with the kernel's
// copy_chunk, forms S = A . B^T and O = P . V with P = S (in bf16 rounded
// to bf16, as the kernel rounds P) through the kernel's own step
// functions, and writes both accumulators out row-major.
#include "../../shockwave_tpu_torch/csrc/flash_attention_wide.cu"

namespace {

// out (64 x cols, row-major) from a warpgroup's accumulator of `tiles` n8
// tiles: warp w's rows 16w.. in mma.sync's C layout.
__device__ void store_accumulator(float* out, const float (*acc)[4], int tiles, int cols,
                                  int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  for (int j = 0; j < tiles; ++j)
    for (int e = 0; e < 4; ++e)
      out[(16 * warp + g + 8 * (e >> 1)) * cols + 8 * j + 2 * t + (e & 1)] = acc[j][e];
}

template <typename T>
__global__ void wgmma_probe_kernel(const T* a, const T* b, const T* v, float* s_out,
                                   float* o_out) {
  constexpr int CC = 128 / (int)sizeof(T), kElems = kChunkBytes / (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kSmemAlign - smem_addr(smem) % kSmemAlign) % kSmemAlign;
  T* ca = reinterpret_cast<T*>(base);
  T* cb = ca + kElems;
  T* cv = cb + kElems;
  float* scratch = reinterpret_cast<float*>(cv + kElems);  // f32: two chunks
  const int tid = threadIdx.x, g = (tid & 31) >> 2, t = tid & 3;
  copy_chunk(ca, a, CC, 0, 64, 0, tid);
  copy_chunk(cb, b, CC, 0, 64, 0, tid);
  copy_chunk(cv, v, CC, 0, 64, 0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_shared();
  named_sync(1, 128);
  float s[8][4] = {}, o[8][4] = {};
  if constexpr (std::is_same<T, bf16>::value) {
    scores_chunk_wgmma(s, ca, cb);
    uint32_t p[4][4];
    for (int kk = 0; kk < 4; ++kk) accum_to_a(p[kk], s[2 * kk], s[2 * kk + 1]);
    pv_chunk_wgmma(o, p, cv);
    store_accumulator(o_out, o, 8, 64, tid);
  } else {
    split_chunk(cb, scratch, tid);
    fence_async_shared();
    named_sync(1, 128);
    scores_chunk_tf32(s, ca, cb, scratch, 16 * (tid >> 5), g, t);
    named_sync(1, 128);  // every wgmma on the scratch is done before it is restaged
    stage_v_transposed(cv, scratch, tid);
    fence_async_shared();
    named_sync(1, 128);
    const float one[2] = {1.f, 1.f};
    pv_chunk_tf32(reinterpret_cast<float(&)[4][4]>(o[0]), s, scratch, one);
    store_accumulator(o_out, o, 4, 32, tid);
  }
  store_accumulator(s_out, s, 8, 64, tid);
}

}  // namespace

extern "C" {

int swt_wgmma_probe_bf16(const void* a, const void* b, const void* v, float* s, float* o) {
  wgmma_probe_kernel<bf16><<<1, 128, 3 * kChunkBytes + kSmemAlign, nullptr>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<const bf16*>(v), s,
      o);
  return 0;
}

int swt_wgmma_probe_f32(const void* a, const void* b, const void* v, float* s, float* o) {
  wgmma_probe_kernel<float><<<1, 128, 5 * kChunkBytes + kSmemAlign, nullptr>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(v), s,
      o);
  return 0;
}

}  // extern "C"
