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
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __grid_constant__

#include "cuda.h"

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
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaErrorNotSupported = 801 };
enum { cudaEnableDefault = 0 };
typedef enum { cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1 }
    cudaDriverEntryPointQueryResult;
// What cudaGetDriverEntryPoint hands the kernels: cuTensorMapEncodeTiled only.
inline cudaError_t cudaGetDriverEntryPoint(const char* symbol, void** fn, unsigned long long,
                                           cudaDriverEntryPointQueryResult* found) {
  const bool known = strcmp(symbol, "cuTensorMapEncodeTiled") == 0;
  *fn = known ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  *found = known ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}
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
// Multiply-adds the tensor-core instructions of the last launch issued
// (mma.sync and wgmma, each as its M x N x K; a 3xTF32 product is three).
inline std::atomic<long> g_tensor_macs{0};
// wgmma instructions of the last launch, by form (0: A from shared memory,
// 1: A from registers) and N / 8, counted once per thread of the
// warpgroup that issues them.
inline std::atomic<long> g_wgmma_ops[2][33];

struct Cta {
  std::vector<unsigned char> smem;
  size_t smem_bytes;
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::unique_ptr<std::barrier<>> named[16];  // bar.sync / bar.arrive ids, made at first use
  std::mutex named_mu;
  // mbarriers by shared-memory offset: arrivals still pending, the count a
  // phase starts with, transaction bytes outstanding, phases completed.
  struct Mbar { int pending = 0, expected = 0; long tx = 0; unsigned phase = 0; };
  std::map<uint32_t, Mbar> mbars;
  std::mutex mbar_mu;
  std::condition_variable mbar_cv;
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
    g_tensor_macs = 0;
    for (auto& form : g_wgmma_ops)
      for (auto& count : form) count = 0;
    for (unsigned bz = 0; bz < grid.z; ++bz)
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
            t_block = dim3(bx, by, bz);
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
  g_tensor_macs += 4 * 8;
}

inline float bf16_bits_to_float(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: lanes 8i..8i+7 give
// the row addresses of 8x8 matrix i; register i of lane l holds row l/4,
// columns 2(l%4) and 2(l%4)+1 of matrix i, the lower column in the low
// half (with .trans: rows 2(l%4) and 2(l%4)+1, column l/4).
inline void ldmatrix_x4(uint32_t* r, const void* p, bool trans) {
  const int ln = lane();
  auto& x = t_cta->exchange[warp()];
  const uint32_t offset = (uint32_t)(static_cast<const unsigned char*>(p) - smem());
  memcpy(&x[ln][0], &offset, 4);
  warp_sync();
  auto row = [&](int src) {
    uint32_t off;
    memcpy(&off, &x[src][0], 4);
    return reinterpret_cast<const uint16_t*>(smem() + off);
  };
  uint32_t out[4];
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (trans) {
      lo = row(8 * i + 2 * (ln & 3))[ln >> 2];
      hi = row(8 * i + 2 * (ln & 3) + 1)[ln >> 2];
    } else {
      lo = row(8 * i + (ln >> 2))[2 * (ln & 3)];
      hi = row(8 * i + (ln >> 2))[2 * (ln & 3) + 1];
    }
    out[i] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  warp_sync();
  for (int i = 0; i < 4; ++i) r[i] = out[i];
}

// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 from the 32 lanes'
// fragments as the PTX ISA lays them out (g = lane / 4, t = lane % 4; the
// lower index of each pair in the low half): a[0] = A(g, 2t..2t+1), a[1]
// = A(g + 8, 2t..), a[2] = A(g, 2t+8..), a[3] = A(g + 8, 2t+8..); b0 =
// B(2t..2t+1, g), b1 = B(2t+8..2t+9, g); c as in m16n8k8 above.
inline void mma_m16n8k16_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  const int ln = lane();
  auto& x = t_cta->exchange[warp()];
  const uint32_t regs[6] = {a[0], a[1], a[2], a[3], b0, b1};
  memcpy(&x[ln][0], regs, sizeof(regs));
  warp_sync();
  auto half = [&](int src, int reg, int hi) {
    uint32_t v;
    memcpy(&v, &x[src][reg], 4);
    return bf16_bits_to_float(hi ? v >> 16 : v & 0xffffu);
  };
  auto A = [&](int r, int k) { return half((r & 7) * 4 + ((k & 7) >> 1), (r >= 8) + 2 * (k >= 8), k & 1); };
  auto B = [&](int k, int n) { return half(n * 4 + ((k & 7) >> 1), 4 + (k >= 8), k & 1); };
  const int g = ln >> 2, t = ln & 3;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    double sum = 0;
    for (int k = 0; k < 16; ++k) sum += (double)A(r, k) * (double)B(k, n);
    out[e] = c[e] + (float)sum;
  }
  warp_sync();
  for (int e = 0; e < 4; ++e) c[e] = out[e];
  g_tensor_macs += 4 * 16;
}

// bar.sync / bar.arrive on named barrier `id` of `count` threads: a
// barrier of the CTA's, made by its first user. An arrival does not wait.
inline std::barrier<>& named_barrier(int id, int count) {
  std::lock_guard<std::mutex> hold(t_cta->named_mu);
  if (!t_cta->named[id]) t_cta->named[id] = std::make_unique<std::barrier<>>(count);
  return *t_cta->named[id];
}
inline void named_sync(int id, int count) { named_barrier(id, count).arrive_and_wait(); }
inline void named_arrive(int id, int count) { (void)named_barrier(id, count).arrive(); }

// A wgmma matrix descriptor's operand element as the PTX ISA lays out the
// 128-byte swizzle (layout type 1 in bits 62-63) and the 64-byte one (type
// 2), the modes the kernels use: start address, leading byte offset (LBO)
// and stride byte offset (SBO), each in 16-byte units, and R the
// swizzle's row, 128 or 64 bytes. K-major element (mn, k) sits at start +
// (mn / 8) SBO + (mn % 8) R + k E (E the element's bytes); MN-major
// element (k, mn) at start + (k / 8) SBO + (k % 8) R + 2 (mn % (R / 2)) +
// (mn / (R / 2)) LBO (bf16 only); then address bits 4-6 are XORed with
// bits 7-9 (128 bytes), or bits 4-5 with bits 7-8 (64 bytes). Any other
// layout type, or a base offset (bits 49-51) other than 0, aborts. A bf16
// element is read as its value, a TF32 one as its 32 bits' top 19.
inline float desc_element(uint64_t desc, bool mn_major, int mn, int k, bool tf32 = false) {
  const uint32_t start = (uint32_t)(desc & 0x3fff) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3fff) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3fff) << 4;
  const uint64_t layout = desc >> 62;
  if ((layout != 1 && layout != 2) || ((desc >> 49) & 7) != 0) {
    fprintf(stderr, "emulated wgmma: descriptor %llx is not a 128- or 64-byte swizzle at "
            "offset 0\n", (unsigned long long)desc);
    abort();
  }
  const uint32_t row = layout == 1 ? 128 : 64, cols = row / 2;
  const uint32_t size = tf32 ? 4 : 2;
  uint32_t off = mn_major
                     ? start + (k / 8) * sbo + (k % 8) * row + (mn % cols) * 2 + (mn / cols) * lbo
                     : start + (mn / 8) * sbo + (mn % 8) * row + k * size;
  off ^= ((off >> 7) & (row / 16 - 1)) << 4;
  if (off + size > t_cta->smem_bytes) {
    ++g_shared_overruns;
    return 0.f;
  }
  if (tf32) {
    uint32_t bits;
    memcpy(&bits, t_cta->smem.data() + off, 4);
    return __uint_as_float(bits & 0xffffe000u);
  }
  uint16_t bits;
  memcpy(&bits, t_cta->smem.data() + off, 2);
  return bf16_bits_to_float(bits);
}

// mbarrier.init / arrive / arrive.expect_tx / try_wait.parity and the
// transaction bytes of cp.async.bulk.tensor, as the PTX ISA defines them
// for one CTA: a phase completes when its pending arrivals reach 0 and its
// transaction count is back at 0; then the next phase starts with the
// barrier's count. try_wait on parity P returns once the phase of parity P
// has completed (at once for P = 1 on a barrier with no completed phase).
// A wait that lasts a minute is a deadlock: it aborts with the barrier.
inline uint32_t shared_offset(const void* p) {
  return (uint32_t)(static_cast<const unsigned char*>(p) - smem());
}
inline Cta::Mbar& mbar_at(const void* bar) {
  auto it = t_cta->mbars.find(shared_offset(bar));
  if (it == t_cta->mbars.end()) {
    fprintf(stderr, "emulated mbarrier at %u used before mbarrier.init\n", shared_offset(bar));
    abort();
  }
  return it->second;
}
inline void mbar_settle(Cta::Mbar& m, const void* bar) {
  if (m.pending < 0) {
    fprintf(stderr, "emulated mbarrier at %u: more arrivals than its count\n", shared_offset(bar));
    abort();
  }
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.expected;
    t_cta->mbar_cv.notify_all();
  }
}
inline void mbar_init(void* bar, int count) {
  std::lock_guard<std::mutex> hold(t_cta->mbar_mu);
  t_cta->mbars[shared_offset(bar)] = Cta::Mbar{count, count, 0, 0};
}
inline void mbar_arrive(void* bar, long tx_bytes = 0) {
  std::lock_guard<std::mutex> hold(t_cta->mbar_mu);
  Cta::Mbar& m = mbar_at(bar);
  m.tx += tx_bytes;
  --m.pending;
  mbar_settle(m, bar);
}
inline void mbar_complete_tx(void* bar, long bytes) {
  std::lock_guard<std::mutex> hold(t_cta->mbar_mu);
  Cta::Mbar& m = mbar_at(bar);
  m.tx -= bytes;
  mbar_settle(m, bar);
}
inline bool mbar_try_wait(void* bar, uint32_t parity) {
  std::unique_lock<std::mutex> hold(t_cta->mbar_mu);
  Cta::Mbar& m = mbar_at(bar);
  if (!t_cta->mbar_cv.wait_for(hold, std::chrono::seconds(60),
                               [&] { return (m.phase & 1u) != parity; })) {
    fprintf(stderr, "emulated mbarrier at %u: parity %u never completed (deadlock)\n",
            shared_offset(bar), parity);
    abort();
  }
  return true;
}

// cp.async.bulk.tensor (tile mode) from global to shared memory: the box
// of `map` at coordinates c (innermost first) lands at dst, row after row,
// elements out of bounds as zeros; under the 128-byte swizzle, bits 4-6
// of each shared address are XORed with bits 7-9, which needs dst 1 KB
// aligned for the pattern wgmma's descriptors assume, and under the
// 64-byte swizzle bits 4-5 with bits 7-8, which needs dst 512-byte
// aligned. Then the box's bytes complete on `bar`. The copy runs in the
// issuing thread: it has landed before the barrier can complete.
inline void tma_load(void* dst, const CUtensorMap* map, void* bar, const int* c) {
  const uint32_t base = shared_offset(dst);
  if (map->swizzle == CU_TENSOR_MAP_SWIZZLE_128B && base % 1024) {
    fprintf(stderr, "emulated TMA: 128-byte swizzled box at %u is not 1 KB aligned\n", base);
    abort();
  }
  if (map->swizzle == CU_TENSOR_MAP_SWIZZLE_64B && base % 512) {
    fprintf(stderr, "emulated TMA: 64-byte swizzled box at %u is not 512-byte aligned\n", base);
    abort();
  }
  const int e = map->elem_bytes;
  size_t n = 1;
  for (int i = 0; i < map->rank; ++i) n *= map->box[i];
  const size_t bytes = n * e;
  if (shared_fits(dst, bytes)) {
    for (size_t idx = 0; idx < n; ++idx) {
      size_t rest = idx, src = 0;
      bool in = true;
      for (int i = 0; i < map->rank; ++i) {
        const long coord = (long)c[i] + (long)(rest % map->box[i]);
        rest /= map->box[i];
        in = in && coord >= 0 && coord < (long)map->dims[i];
        src += (size_t)(coord < 0 ? 0 : coord) * (i == 0 ? e : map->strides[i - 1]);
      }
      uint32_t off = base + (uint32_t)(idx * e);
      if (map->swizzle == CU_TENSOR_MAP_SWIZZLE_128B) off ^= ((off >> 7) & 7) << 4;
      if (map->swizzle == CU_TENSOR_MAP_SWIZZLE_64B) off ^= ((off >> 7) & 3) << 4;
      if (in)
        memcpy(smem() + off, map->base + src, e);
      else
        memset(smem() + off, 0, e);
    }
  }
  mbar_complete_tx(bar, (long)bytes);
}

// wgmma.mma_async m64nNk16 (f32 += bf16 x bf16) runs when it is waited
// for, as on the card, where it reads its shared operands and registers
// asynchronously until then: a kernel that rewrites either before its
// wgmma_wait reads the rewritten values here too. A from registers is
// copied at issue (a correct kernel leaves it alone until the wait).
struct WgmmaOp {
  float* d;
  uint64_t da, db;
  uint32_t a[4];
  bool a_in_registers;
  bool tf32 = false;  // m64nNk8 on TF32 (A in registers, B K-major), else m64nNk16 on bf16
  int n = 64;
};
inline thread_local std::vector<WgmmaOp> t_wgmma_open;
inline thread_local std::deque<std::vector<WgmmaOp>> t_wgmma_groups;

inline void wgmma_ss(float* d, uint64_t da, uint64_t db, int n = 64) {
  t_wgmma_open.push_back({d, da, db, {0, 0, 0, 0}, false, false, n});
}
inline void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int n = 64) {
  t_wgmma_open.push_back({d, 0, db, {a[0], a[1], a[2], a[3]}, true, false, n});
}
inline void wgmma_tf32(float* d, int n, const uint32_t* a, uint64_t db) {
  t_wgmma_open.push_back({d, 0, db, {a[0], a[1], a[2], a[3]}, true, true, n});
}
inline void wgmma_commit() {
  t_wgmma_groups.push_back(std::move(t_wgmma_open));
  t_wgmma_open.clear();
}

// One op for this thread: warp w of the warpgroup holds rows 16w..16w + 15
// of the 64 x N accumulator in mma.sync's C layout (n8 tile j in d[4j..4j
// + 3]); A from registers is mma.sync's A layout per warp (m16n8k16 in
// bf16, m16n8k8 in TF32); in bf16, B is K-major (A . B^T, S = Q.K^T) for
// an A in shared memory and MN-major (A . B, P.V) for an A in registers,
// as the kernels pair them; in TF32 it is K-major.
inline void wgmma_run(const WgmmaOp& op) {
  const int ln = lane(), wq = warp() % 4, g = ln >> 2, t = ln & 3;
  const int depth = op.tf32 ? 8 : 16;
  auto& x = t_cta->exchange[warp()];
  if (op.a_in_registers) {
    memcpy(&x[ln][0], op.a, sizeof(op.a));
    warp_sync();
  }
  auto A = [&](int r, int k) {  // r: 0..15 within the warp's rows
    if (!op.a_in_registers) return desc_element(op.da, false, 16 * wq + r, k);
    uint32_t v;
    if (op.tf32) {
      memcpy(&v, &x[(r & 7) * 4 + (k & 3)][(r >= 8) + 2 * (k >= 4)], 4);
      return __uint_as_float(v & 0xffffe000u);
    }
    memcpy(&v, &x[(r & 7) * 4 + ((k & 7) >> 1)][(r >= 8) + 2 * (k >= 8)], 4);
    return bf16_bits_to_float(k & 1 ? v >> 16 : v & 0xffffu);
  };
  auto B = [&](int k, int n) {
    return desc_element(op.db, op.a_in_registers && !op.tf32, n, k, op.tf32);
  };
  float out[128];
  for (int j = 0; j < op.n / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      double sum = 0;
      for (int k = 0; k < depth; ++k) sum += (double)A(r, k) * (double)B(k, n);
      out[4 * j + e] = op.d[4 * j + e] + (float)sum;
    }
  if (op.a_in_registers) warp_sync();
  for (int i = 0; i < op.n / 2; ++i) op.d[i] = out[i];
  g_tensor_macs += op.n / 2 * depth;
  ++g_wgmma_ops[op.a_in_registers][op.n / 8];
}

// wgmma.wait_group n: the committed groups but the newest n run, in order.
inline void wgmma_wait(int n) {
  while ((int)t_wgmma_groups.size() > n) {
    for (const WgmmaOp& op : t_wgmma_groups.front()) wgmma_run(op);
    t_wgmma_groups.pop_front();
  }
}
}  // namespace emu

// The library's counters, defined in the one translation unit that
// emulate.py marks with EMU_EXPORTS.
#ifdef EMU_EXPORTS
extern "C" long emu_shared_overruns() { return emu::g_shared_overruns.load(); }
extern "C" long emu_tensor_products() { return emu::g_tensor_macs.load(); }
// The last launch's wgmma instructions of one form (rs: A from registers)
// and width n, a warpgroup's instruction once.
extern "C" long emu_wgmma_instructions(int rs, int n) {
  return emu::g_wgmma_ops[rs != 0][n / 8].load() / 128;
}
extern "C" unsigned emu_tensor_map_ranks() {
  const unsigned ranks = emu_map_ranks;
  emu_map_ranks = 0;
  return ranks;
}
#endif

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
