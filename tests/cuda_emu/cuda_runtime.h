// A host stand-in for the CUDA runtime and device built-ins, enough to
// compile the port's kernel source with a host C++ compiler and run it on
// the CPU (see emulate.py). Each CUDA thread of a CTA is a host thread;
// CTAs run one after another. __syncthreads and the warp's collectives
// are barriers. Shared memory starts filled with 0xff bytes (NaN as
// f32), so a read of shared memory that no copy wrote shows in the
// results.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
using std::max;
using std::min;
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(unsigned i) { float f; memcpy(&f, &i, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned i; memcpy(&i, &f, 4); return i; }
inline float __expf(float x) { return exp2f(x * 1.4426950408889634f); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes { int numRegs = 0; };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <typename K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
template <typename K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, K) { return 0; }
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

namespace emu {
inline thread_local dim3 t_thread, t_block;
inline dim3 g_grid;
inline std::atomic<long> g_shared_overruns{0};

struct Cta {
  std::vector<unsigned char> smem;
  size_t smem_bytes;
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  float exchange[32][32][8];  // [warp][lane][value]: shuffles and mma operands
};
inline thread_local Cta* t_cta;

// kernel<<<grid, threads, smem, stream>>>(args...) becomes
// emu::launch(kernel, grid, threads, smem, stream)(args...).
template <typename Kernel>
struct Launch {
  Kernel kernel;
  dim3 grid;
  int threads;
  size_t smem;
  template <typename... A>
  void operator()(A... args) {
    g_grid = grid;
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        Cta cta;
        cta.smem.assign(smem, 0xff);
        cta.smem_bytes = smem;
        cta.all = std::make_unique<std::barrier<>>(threads);
        for (int w = 0; w < (threads + 31) / 32; ++w)
          cta.warps.push_back(std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([&, t] {
            t_thread = dim3(t);
            t_block = dim3(bx, by);
            t_cta = &cta;
            kernel(args...);
          });
        for (auto& th : pool) th.join();
      }
  }
};
template <typename Kernel>
Launch<Kernel> launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t) {
  return Launch<Kernel>{kernel, grid, threads, smem};
}
inline unsigned char* smem() { return t_cta->smem.data(); }
inline int lane() { return t_thread.x & 31; }
inline int warp() { return t_thread.x >> 5; }
inline void warp_sync() { t_cta->warps[warp()]->arrive_and_wait(); }

// A copy into shared memory that would overrun the CTA's allocation is
// counted and dropped.
inline bool shared_fits(const void* dst, size_t bytes) {
  const size_t off = static_cast<const unsigned char*>(dst) - smem();
  if (off + bytes <= t_cta->smem_bytes) return true;
  ++g_shared_overruns;
  return false;
}

// mma.sync.m16n8k8 on TF32 operands, from the 32 lanes' fragments as the
// PTX ISA lays them out (g = lane / 4, t = lane % 4): a[0..3] = A(g, t),
// A(g + 8, t), A(g, t + 4), A(g + 8, t + 4); b0 = B(t, g), b1 = B(t + 4, g);
// c[0..3] = C(g, 2t), C(g, 2t + 1), C(g + 8, 2t), C(g + 8, 2t + 1). Only
// each operand's top 19 bits are read, as the tensor cores read TF32.
inline void mma_m16n8k8_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  const int ln = lane();
  auto& x = t_cta->exchange[warp()];
  for (int i = 0; i < 4; ++i) x[ln][i] = __uint_as_float(a[i]);
  x[ln][4] = __uint_as_float(b0);
  x[ln][5] = __uint_as_float(b1);
  warp_sync();
  auto tf32 = [](float v) { return __uint_as_float(__float_as_uint(v) & 0xffffe000u); };
  auto A = [&](int r, int k) { return tf32(x[(r & 7) * 4 + (k & 3)][(r >= 8) + 2 * (k >= 4)]); };
  auto B = [&](int k, int n) { return tf32(x[n * 4 + (k & 3)][4 + (k >= 4)]); };
  const int g = ln >> 2, t = ln & 3;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    double sum = 0;
    for (int k = 0; k < 8; ++k) sum += (double)A(r, k) * (double)B(k, n);
    out[e] = c[e] + (float)sum;
  }
  warp_sync();
  for (int e = 0; e < 4; ++e) c[e] = out[e];
}
}  // namespace emu

extern "C" long emu_shared_overruns() { return emu::g_shared_overruns.load(); }

#define threadIdx (emu::t_thread)
#define blockIdx (emu::t_block)
#define gridDim (emu::g_grid)

inline void __syncthreads() { emu::t_cta->all->arrive_and_wait(); }
inline void __syncwarp() { emu::warp_sync(); }
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  auto& x = emu::t_cta->exchange[emu::warp()];
  x[emu::lane()][0] = v;
  emu::warp_sync();
  const float r = x[emu::lane() ^ lane_mask][0];
  emu::warp_sync();
  return r;
}
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<const unsigned char*>(p) - emu::smem();
}
