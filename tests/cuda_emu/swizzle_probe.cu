// A probe of the 64-byte swizzle for the CPU emulation only: one thread
// lands a box of 32 bf16 columns (64-byte rows) through the TMA-fed
// kernels' own tensor_map and tma_load (flash_attention_tma.cuh) at a
// 512-byte boundary that is not a 1 KB one, copies the landed bytes out,
// and reads every element back through wgmma descriptors as the D = 32
// kernels form them: K-major (the scores' operands, a k16 step 32 bytes
// on) and MN-major (P.V's V, a k16 step 16 rows on).
#include "../../shockwave_tpu_torch/csrc/flash_attention_tma.cuh"

namespace {

template <typename T>
__global__ void swizzle_probe_kernel(const __grid_constant__ CUtensorMap map, int rows,
                                     uint16_t* landed, float* k_major, float* mn_major) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kAlign - smem_addr(smem) % kAlign) % kAlign;
  T* tile = reinterpret_cast<T*>(base + 512);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 512 + rows * 64);
  mbar_init(bar, 1);
  mbar_arrive_expect_tx(bar, rows * 64);
  tma_load(tile, map, bar, 0, 0, Head{0, 0});
  mbar_wait(bar, 0);
  memcpy(landed, tile, rows * 64);
  const uint64_t desc_k = wgmma_desc<64>(tile, 16);
  const uint64_t desc_mn = wgmma_desc<64>(tile, rows * 64);
  for (int r = 0; r < rows; ++r)
    for (int c = 0; c < 32; ++c) {
      k_major[r * 32 + c] = emu::desc_element(desc_k + 2 * (c / 16), false, r, c % 16);
      mn_major[r * 32 + c] =
          emu::desc_element(desc_mn + (16 * 64 >> 4) * (r / 16), true, c, r % 16);
    }
}

}  // namespace

extern "C" {

// x: `rows` packed rows of 32 bf16; landed: the box's rows * 32 bf16 as
// they sit in shared memory; k_major, mn_major: rows x 32 f32; swizzle:
// the map's CUtensorMapSwizzle. Returns tensor_map's error, or 0.
int swt_swizzle_probe(const void* x, int rows, void* landed, float* k_major, float* mn_major,
                      int* swizzle) {
  const View view{const_cast<void*>(x), Strides{rows * 32, rows * 32, 32}};
  CUtensorMap map;
  const int err = tensor_map<bf16>(&map, view, 1, 1, rows, 32, rows);
  if (err != 0) return err;
  *swizzle = map.swizzle;
  swizzle_probe_kernel<bf16><<<1, 1, kAlign + 512 + rows * 64 + 8, nullptr>>>(
      map, rows, static_cast<uint16_t*>(landed), k_major, mn_major);
  return 0;
}

}  // extern "C"
