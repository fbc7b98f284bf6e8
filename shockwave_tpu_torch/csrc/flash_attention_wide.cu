// Flash attention for Hopper (sm_90a) at head dims above 256: the wide
// instances of K1-K3 (flash_fwd_wide, flash_dq_wide, flash_dkv_wide), each
// in bf16 and in f32 (3xTF32), which take the padded head dim D at run
// time: any multiple of 256 above 256 (the wrapper pads 257-512 to 512 and
// wider head dims to the next multiple of 256, as the reference pads any
// head dim to its sublane multiple). They replace the same Pallas kernels
// as the narrow instances in flash_attention.cu (_fa_kernel :40,
// _dq_kernel :167, _dkv_kernel :222 of shockwave_tpu/ops/flash_attention.py)
// at those widths, with the same arguments and masking, and share its
// building blocks (flash_attention_common.cuh). One data flow in all six:
// two warpgroups over 64-row tiles on wgmma, operands streamed through a
// cp.async ring of 8 KB chunks per group, swizzled as wgmma reads them.
// - K1 in both dtypes (flash_fwd_wide_kernel): the scores formed once per
//   row tile.
// - K2 and K3 in f32 (flash_dq_wide_f32_kernel, flash_dkv_wide_f32_kernel):
//   K1's data flow for the backward, on TF32 wgmma as 3xTF32.
// - K2 and K3 in bf16 (flash_dq_wide_kernel, flash_dkv_wide_kernel): the
//   f32 pair's data flow on bf16 wgmma, with no staging.
#include "flash_attention_common.cuh"

namespace {

constexpr int kWideSlice = 256;  // dK and dV columns a K3 CTA owns

// ---------------------------------------------------------------------------
// K1 at wide head dims: flash_fwd_wide, on wgmma in both dtypes (bf16, and
// f32 as 3xTF32). Replaces _fa_kernel (shockwave_tpu/ops/flash_attention.py:40)
// at head dims above 256.
//
// Grid (BH, q-tiles of 64 rows, ceil(D / 512)), heaviest causal tile
// first. A CTA is two warpgroups of 128 threads, G = 0 and 1, over 64
// query rows (warp w of a group holds rows 16w to 16w + 15 of a wgmma
// accumulator, in mma.sync's C layout) and up to 512 output columns:
// group G owns half of those columns and sums S over half of the
// contraction, columns [G D / 2, (G + 1) D / 2).
//
// Bound on an H100 SXM (3.35 TB/s; 989 bf16 TFLOP/s; 164.8 TFLOP/s for
// f32-accurate 3xTF32 products): at the bench shape (4, 2048, 8, 512)
// causal, 137.5 GFLOP for 268 MB in bf16 (537 MB in f32), 139 us by
// operations (834 us in f32); at the main shape (64, 32, 8, 512)
// key-padded, 67 MB, 20 us by bytes (134 MB, 40 us in f32).
//
// What held the first wide design (32- and 16-row CTAs of 256 columns,
// two warps per 16 rows, mma.sync) back, and what this one does:
// 1. The scores were formed 2 x D / 256 times per row tile
//    (4 at D = 512). Here each group forms the 64 x 64 partial S of its
//    contraction half, and the halves meet in a 16 KB f32 exchange in
//    shared memory, each thread's 32 scores in its own slots
//    (conflict-free): group 0 writes its half and arrives at named
//    barrier 3; group 1 waits there, reads it, writes its own half into
//    the same slots and arrives at barrier 4, where group 0 waits. One
//    wait per group and k-tile, and no race: a slot is rewritten only by
//    its own thread, after the other group has read it. Both groups then
//    run the same online softmax on the same sum (a + b == b + a, so
//    their P, max and lse agree bit for bit) and each forms P.V for its
//    own columns. At D <= 512 the tensor cores do S + P.V once (the CPU
//    emulation counts the products); each further 512 columns of D adds
//    a CTA that forms S again.
// 2. Q was copied again at every k-tile. Here a CTA copies its 64 x D Q
//    tile once into shared memory (64 KB in bf16, 128 KB in f32 at D =
//    512), where it stays, and K and V stream through a ring of 8 KB
//    chunks per group (64 rows of 128 bytes: 64 bf16 or 32 f32 columns;
//    4 in bf16, 3 in f32): the group's contraction half of K, then its
//    output columns of V, every k-tile in one flat sequence. Where Q would
//    not fit (bf16 above D = 1024, f32 above 512) its chunks stream in a
//    ring of 8 too, each beside the K chunk it meets, two chunks a step
//    (kQResident false). At the bench shape in bf16: 1,024 CTAs x (64 KB
//    + 16.5 k-tiles x 128 KB) = 2.2 GB from L2 into shared memory (the
//    first design: 11). A ring as deep as shared memory allows (8 chunks
//    in bf16 at D = 512), chosen at run time, ran slower on the card than
//    these fixed depths, and so did separate S and P.V instances for tiles
//    of 32 keys (PERF.md).
// 3. Two __syncthreads per 64-column chunk. Here a group waits once per
//    step, on its own named barrier (bar.sync 1 + G of 128 threads) after
//    the step's cp.async groups land, then refills the slots of the
//    chunks before them (free: every thread of the group waited for its
//    wgmma on them before the barrier), plus once per k-tile on the
//    exchange: 9 waits a k-tile at D = 512 in bf16 (the first design: 16
//    __syncthreads). f32 waits once more per step, after staging (4).
// 4. No wgmma, and in f32 a third of the products' instructions spent
//    splitting operands. Both dtypes now form S with wgmma m64n64 and
//    O += P.V with wgmma m64n64 (bf16) or m64n32 (f32), P from registers
//    (the S accumulators repacked into A fragments, FA2's hand-off, since
//    a warpgroup's accumulator and register-A layouts are mma.sync's per
//    warp). O stays in registers (a group's 64 x 256 f32: 128 registers
//    a thread). Chunks are copied by 16-byte cp.async of the group's own
//    128 threads straight into the 128-byte swizzled layout that wgmma
//    reads (unit u of row r at u ^ (r % 8)); each thread fences its
//    landed copies (and its staging stores) into the async proxy before
//    the group's barrier. TMA is not used: it needs a tensor map per
//    tensor, encoded on the host (cuTensorMapEncodeTiled), and does no more
//    for rows one swizzle atom (128 bytes) wide than 128 threads of
//    cp.async do.
//    bf16: S takes Q and K both from shared memory through matrix
//    descriptors (K-major, 8-row groups 1,024 bytes apart), four wgmma of
//    16 columns a chunk; P.V takes V through a transposed (MN-major)
//    descriptor, so V stays row-major.
//    f32 stays 3xTF32 (one-pass TF32 misses the 1e-4 tolerance: each
//    product is a_small.b_big + a_big.b_small + a_big.b_big into one f32
//    accumulator), on wgmma's TF32, which takes B only K-major from
//    shared memory. S: Q's fragments are split in registers as they are
//    read; each K chunk is split in place into its big plane, its small
//    plane staged in the group's 16 KB scratch. P.V: each V chunk is
//    staged transposed (keys contiguous) into the scratch as a big and a
//    small plane, its keys permuted within each 8 as P's A fragments hold
//    them (slot t key 2t, slot t + 4 key 2t + 1: accum_to_a_tf32). Each
//    k-tile's part of O is summed from zero (the tensor cores' f32
//    accumulation truncates) and added to O in f32.
// Shared memory: 1 KB of alignment, the 16 KB exchange, the rings, f32's
// 2 x 16 KB scratch and Q where it stays: 148,480 bytes at D = 512 in bf16
// and 230,400 in f32, one CTA of 8 warps per SM (a thread's registers
// allow no second).
// ---------------------------------------------------------------------------
constexpr int kFwdWideRows = 64;      // query rows per CTA, and keys per k-tile
constexpr int kFwdWideSlice = 512;    // output columns per CTA (grid z)
constexpr int kFwdWideThreads = 256;  // two warpgroups
constexpr int kChunkBytes = 64 * 128;  // a ring chunk: 64 rows of 128 bytes
constexpr int kExchangeBytes = kFwdWideRows * kFwdWideRows * 4;  // a 64 x 64 f32 S
constexpr int kSmemAlign = 1024;       // the 128-byte swizzle repeats every 1 KB
constexpr int kMaxSmemPerCta = 232448;  // the 227 KB an H100 CTA may take

// Ring chunks per group: where Q stays in shared memory, 4 in bf16 and 3
// in f32 (whose staging scratch takes the room of two more); where Q
// streams, 8 (a step takes two chunks, which the step before must already
// have issued: 4 at least).
template <typename T, bool kQResident>
constexpr int kFwdWideStages = !kQResident ? 8 : sizeof(T) == 2 ? 4 : 3;

// Shared bytes besides Q: alignment, the exchange, the rings and, in f32,
// each group's staging scratch (two chunks).
template <typename T, bool kQResident>
__host__ __device__ constexpr size_t fwd_wide_fixed_smem() {
  return kSmemAlign + kExchangeBytes + 2 * kFwdWideStages<T, kQResident> * kChunkBytes +
         (sizeof(T) == 4 ? 2 * 2 * kChunkBytes : 0);
}

// Whether Q's 64 x d tile stays in shared memory beside the rest (bf16 up
// to d = 1024, f32 up to 512).
template <typename T>
__host__ __device__ constexpr bool fwd_wide_q_resident(int d) {
  return fwd_wide_fixed_smem<T, true>() + (size_t)kFwdWideRows * d * sizeof(T) <=
         kMaxSmemPerCta;
}

// The CTA's dynamic shared bytes.
template <typename T, bool kQResident>
__host__ __device__ constexpr size_t fwd_wide_smem(int d) {
  return fwd_wide_fixed_smem<T, kQResident>() +
         (kQResident ? (size_t)kFwdWideRows * d * sizeof(T) : 0);
}

// Element (r, c) of a chunk: 16-byte unit c / U of row r (U = 16 /
// sizeof(T) elements a unit) sits at unit (c / U) ^ (r % 8), the layout of
// wgmma's 128-byte swizzle for a chunk that starts on a 1 KB boundary.
template <typename T>
__host__ __device__ constexpr int chunk_index(int r, int c) {
  return r * 128 / (int)sizeof(T) + (((c * (int)sizeof(T) / 16) ^ r) & 7) * 16 / (int)sizeof(T) +
         c % (16 / (int)sizeof(T));
}

// Start cp.async copies of rows [row0, row0 + 64) and the 128 bytes of
// columns from `col` on of a (rows, d) matrix whose rows are `ld` elements
// apart (rows_fit) into a chunk, by a group's 128 threads
// (tid); rows past `rows` are zero-filled.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int ld, int row0, int rows,
                                           int col, int tid) {
  constexpr int U = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < kFwdWideRows * 8 / 128; ++i) {
    const int r = (tid >> 3) + 16 * i, u = tid & 7;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * 8 * U + (u ^ (r & 7)) * U,
               src + (valid ? row0 + r : 0) * ld + col + u * U, valid);
  }
}

// Wait until at most n (0 to 7) of this thread's cp.async groups are in
// flight.
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>();
  }
}

// s (the warpgroup's 64 x 64 scores) += Q chunk qc . (K chunk kc)^T over
// the chunk's 64 columns: four wgmma of 16 columns (32 bytes into each
// swizzled row), waited for before return.
__device__ __forceinline__ void scores_chunk_wgmma(float (&s)[8][4], const bf16* qc,
                                                   const bf16* kc) {
  const uint64_t da = wgmma_desc(qc, 16), db = wgmma_desc(kc, 16);
  wgmma_fence();
  wgmma_hold(s);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, da + 2 * kk, db + 2 * kk);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(s);
}

// o (the warpgroup's 64 rows x 64 columns of O) += P . V over one 64-key
// tile: p[kk] the A fragments of keys 16kk..16kk + 15, vc the V chunk (64
// keys x 64 columns, row-major), 16 key rows (2,048 bytes) a wgmma.
__device__ __forceinline__ void pv_chunk_wgmma(float (&o)[8][4], const uint32_t (&p)[4][4],
                                               const bf16* vc) {
  const uint64_t db = wgmma_desc(vc, kChunkBytes);
  wgmma_fence();
  wgmma_hold(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, p[kk], db + (16 * 128 >> 4) * kk);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(o);
}

__device__ __forceinline__ float chunk_at(const float* c, int r, int col) {
  return c[chunk_index<float>(r, col)];
}

// Split an f32 K chunk (rows of 32 floats, swizzled) in place into its big
// TF32 plane, its small plane into `small` at the same positions, by a
// group's 128 threads.
__device__ __forceinline__ void split_chunk(float* chunk, float* small, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = 4 * (tid + 128 * i);
    float4 x = *reinterpret_cast<float4*>(chunk + e);
    uint32_t b[4], s[4];
    split_tf32(x.x, b[0], s[0]);
    split_tf32(x.y, b[1], s[1]);
    split_tf32(x.z, b[2], s[2]);
    split_tf32(x.w, b[3], s[3]);
    *reinterpret_cast<uint4*>(chunk + e) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + e) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// Stage an f32 V chunk (64 keys x 32 columns) transposed, keys contiguous,
// as wgmma's K-major B of P.V: big plane at vt, small plane at vt + 2,048,
// each two 4 KB atoms of 32 rows (columns of V) x 32 keys. Within each 8
// keys, slot p holds key 2p (p < 4) or 2(p - 4) + 1, the order of P's A
// fragments (accum_to_a_tf32). A thread takes one column and 16 keys, 4
// slots to a 16-byte store.
__device__ __forceinline__ void stage_v_transposed(const float* vc, float* vt, int tid) {
  const int n = tid & 31, kq = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp0 = 16 * kq + 4 * i;  // the first of this store's 4 slots
    uint32_t b[4], s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = (kp0 + j) & 7;
      const int key = ((kp0 + j) & ~7) + (p < 4 ? 2 * p : 2 * (p - 4) + 1);
      split_tf32(chunk_at(vc, key, n), b[j], s[j]);
    }
    const int at = (kp0 >> 5) * 1024 + chunk_index<float>(n, kp0 & 31);
    *reinterpret_cast<uint4*>(vt + at) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(vt + 2048 + at) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// s (the warpgroup's 64 x 64 scores) += Q chunk qc . (K chunk kc)^T over
// the chunk's 32 columns as 3xTF32: four steps of 8 columns, each three
// wgmma (Q small . K big, Q big . K small, Q big . K big), Q's fragments
// (warp's rows r0 + g, r0 + g + 8) split as they are read, K's big plane
// at kc and small plane at ks.
__device__ __forceinline__ void scores_chunk_tf32(float (&s)[8][4], const float* qc,
                                                  const float* kc, const float* ks, int r0,
                                                  int g, int t) {
  Split<4> a[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 8 * kk;
    const float v[4] = {chunk_at(qc, r0 + g, c + t), chunk_at(qc, r0 + g + 8, c + t),
                        chunk_at(qc, r0 + g, c + t + 4), chunk_at(qc, r0 + g + 8, c + t + 4)};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], a[kk].big[i], a[kk].small[i]);
  }
  const uint64_t db = wgmma_desc(kc, 16), ds = wgmma_desc(ks, 16);
  wgmma_fence();
  wgmma_hold(s);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32_n64(s, a[kk].small, db + 2 * kk);
    wgmma_tf32_n64(s, a[kk].big, ds + 2 * kk);
    wgmma_tf32_n64(s, a[kk].big, db + 2 * kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(s);
}

// o (the warpgroup's 64 rows x 32 columns of O, 4 n8 tiles) = o corr +
// P . V over one 64-key tile, as 3xTF32 from V's staged transposed planes
// (vt, stage_v_transposed): the tile's part summed from zero, then added
// in f32. P (p, the accumulator tiles of keys 8kk..8kk + 7) is split into
// A fragments (accum_to_a_tf32), 32 keys at a time.
__device__ __forceinline__ void pv_chunk_tf32(float (&o)[4][4], const float (&p)[8][4],
                                              const float* vt, const float (&corr)[2]) {
  float part[4][4] = {};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    Split<4> a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = accum_to_a_tf32(p[4 * half + i]);
    const uint64_t db = wgmma_desc(vt + half * 1024, 16);
    const uint64_t ds = wgmma_desc(vt + 2048 + half * 1024, 16);
    wgmma_fence();
    wgmma_hold(part);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wgmma_tf32_n32(part, a[i].small, db + 2 * i);
      wgmma_tf32_n32(part, a[i].big, ds + 2 * i);
      wgmma_tf32_n32(part, a[i].big, db + 2 * i);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(part);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], corr[e >> 1], part[n][e]);
  }
}

template <typename T, bool kQResident>
__global__ void __launch_bounds__(kFwdWideThreads, 1)
    flash_fwd_wide_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k,
                          Strides ks, const T* __restrict__ v, Strides vs,
                          const uint8_t* __restrict__ mask, T* __restrict__ out, Strides os,
                          float* __restrict__ lse, int heads, int tq, int tk, int d, float scale,
                          int causal) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int CC = 128 / (int)sizeof(T);  // columns of a chunk
  constexpr int kChunkElems = kChunkBytes / (int)sizeof(T);
  constexpr int kTilesPerChunk = CC / 8;    // n8 tiles of O a V chunk gives
  constexpr int kMaxV = kFwdWideSlice / 2 / CC;  // V chunks a group takes per k-tile
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kSmemAlign - smem_addr(smem) % kSmemAlign) % kSmemAlign;
  const int grp = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  constexpr int kS = kFwdWideStages<T, kQResident>;  // ring chunks a group takes
  const size_t q_bytes = kQResident ? (size_t)kFwdWideRows * d * sizeof(T) : 0;
  T* ring = reinterpret_cast<T*>(base) + grp * kS * kChunkElems;  // this group's ring
  float* ex = reinterpret_cast<float*>(base + 2 * kS * kChunkBytes);
  T* sQ = reinterpret_cast<T*>(base + 2 * kS * kChunkBytes + kExchangeBytes);
  float* scratch = reinterpret_cast<float*>(base + 2 * kS * kChunkBytes + kExchangeBytes +
                                            q_bytes + grp * 2 * kChunkBytes);  // f32 only

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // causal: the longest k loops start first
  const int q0 = qt * kFwdWideRows;
  const int slice0 = blockIdx.z * kFwdWideSlice;
  const int half = min(kFwdWideSlice, d - slice0) / 2;  // output columns a group owns
  const int col0 = slice0 + grp * half;
  const int nv = half / CC;     // V chunks per k-tile
  const int nkc = d / 2 / CC;   // contraction chunks per k-tile
  const int kc0 = grp * nkc;    // the group's first contraction chunk
  const int per_s = kQResident ? 1 : 2;  // ring chunks a score step takes
  const int per_tile = nkc * per_s + nv;
  int nk = (tk + kFwdWideRows - 1) / kFwdWideRows;
  if (causal) nk = min(nk, qt + 1);  // k-tiles past the diagonal see nothing
  const int total = nk * per_tile;
  const T* qb = q + head_offset(qs, bh, heads);
  const T* kb = k + head_offset(ks, bh, heads);
  const T* vb = v + head_offset(vs, bh, heads);
  // Held across the loop as 32 bits each (rows_fit).
  const int q_ld = (int)qs.t, k_ld = (int)ks.t, v_ld = (int)vs.t;
  const uint8_t* mask_row = mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // Ring chunk e: chunk e % per_tile of k-tile e / per_tile (Q and K chunks
  // of the contraction half, then V chunks of the group's columns), in
  // slot e % kS.
  auto load = [&](int e) {
    T* dst = ring + (e % kS) * kChunkElems;
    const int kt = e / per_tile, r = e % per_tile;
    if (r < nkc * per_s) {
      const int col = (kc0 + r / per_s) * CC;
      if (per_s == 2 && r % 2 == 0)
        copy_chunk(dst, qb, q_ld, q0, tq, col, tid);
      else
        copy_chunk(dst, kb, k_ld, kt * kFwdWideRows, tk, col, tid);
    } else {
      copy_chunk(dst, vb, v_ld, kt * kFwdWideRows, tk, col0 + (r - nkc * per_s) * CC, tid);
    }
    cp_async_commit();
  };
  if (kQResident) {
    for (int c = kc0; c < kc0 + nkc; ++c)
      copy_chunk(sQ + c * kChunkElems, qb, q_ld, q0, tq, c * CC, tid);
    cp_async_commit();
  }
  int loaded = 0, next = 0;  // ring chunks issued, and taken
  while (loaded < total && loaded < kS) load(loaded++);
  // Chunks [next, next + n) have landed for the whole group; the slots of
  // the chunks before them are refilled.
  auto acquire = [&](int n) {
    cp_async_wait_at_most(loaded - next - n);
    fence_async_shared();
    named_sync(1 + grp, 128);
    while (loaded < total && loaded < next + kS) load(loaded++);
  };
  // f32 staging (into the chunk's slot and the group's scratch), then the
  // group's second wait, before wgmma reads it.
  auto staged = [&]() {
    fence_async_shared();
    named_sync(1 + grp, 128);
  };

  float o[kMaxV * kTilesPerChunk][4] = {};  // the group's 64 rows x up to 256 columns
  float m[2] = {kNegInf, kNegInf};          // running max of rows row[0], row[1]
  float l[2] = {0.f, 0.f};                  // this lane's part of their normalisers
  for (int kt = 0; kt < nk; ++kt) {
    float s[8][4] = {};
    for (int c = 0; c < nkc; ++c) {
      acquire(per_s);
      T* kc = ring + ((next + per_s - 1) % kS) * kChunkElems;
      const T* qc = kQResident ? sQ + (kc0 + c) * kChunkElems : ring + (next % kS) * kChunkElems;
      if constexpr (kBf16) {
        scores_chunk_wgmma(s, qc, kc);
      } else {
        split_chunk(kc, scratch, tid);
        staged();
        scores_chunk_tf32(s, qc, kc, scratch, warp * 16, g, t);
      }
      next += per_s;
    }
    // S = the two groups' halves, through the exchange (design note 1).
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ex[(4 * j + e) * 128 + tid] = s[j][e];
      }
      named_arrive(3, 256);
      named_sync(4, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += ex[(4 * j + e) * 128 + tid];
      }
    } else {
      named_sync(3, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float other = ex[(4 * j + e) * 128 + tid];
          ex[(4 * j + e) * 128 + tid] = s[j][e];
          s[j][e] += other;
        }
      }
      named_arrive(4, 256);
    }
    // Scale, causal -1e30, then the key bias, as _fa_kernel orders them;
    // the new running max starts from the old one.
    const int k0 = kt * kFwdWideRows;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (causal && row[e >> 1] < key) x = kNegInf;
        x += key_bias(mask_row, key, tk);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = __expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
    // O = O corr + P.V over the group's columns, a V chunk a step.
    if constexpr (kBf16) {
#pragma unroll
      for (int n = 0; n < kMaxV * kTilesPerChunk; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
      }
      uint32_t pa[4][4];  // P in bf16 as wgmma's A fragments, 16 keys each
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) accum_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int vc = 0; vc < kMaxV; ++vc) {
        if (vc < nv) {
          acquire(1);
          pv_chunk_wgmma(reinterpret_cast<float(&)[8][4]>(o[vc * kTilesPerChunk]), pa,
                         ring + (next % kS) * kChunkElems);
          ++next;
        }
      }
    } else {
#pragma unroll
      for (int vc = 0; vc < kMaxV; ++vc) {
        if (vc < nv) {
          acquire(1);
          stage_v_transposed(ring + (next % kS) * kChunkElems, scratch, tid);
          staged();
          pv_chunk_tf32(reinterpret_cast<float(&)[4][4]>(o[vc * kTilesPerChunk]), s, scratch,
                        corr);
          ++next;
        }
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lc = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / lc;
    // lse is the same in both groups and every slice: group 0 of slice 0
    // writes it.
    if (blockIdx.z == 0 && grp == 0 && t == 0 && row[h] < tq)
      lse[(size_t)bh * tq + row[h]] = m[h] + logf(lc);
  }
  T* ob = out + head_offset(os, bh, heads) + col0;
#pragma unroll
  for (int n = 0; n < kMaxV * kTilesPerChunk; ++n) {
    if (n < nv * kTilesPerChunk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] < tq)
          store2(ob + row[h] * os.t + 8 * n + 2 * t, o[n][2 * h] * inv[h],
                 o[n][2 * h + 1] * inv[h]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2 and K3 at wide head dims in f32: flash_dq_wide_f32 and
// flash_dkv_wide_f32, on K1 wide's data flow (TF32 wgmma as 3xTF32, two
// warpgroups over 64-row tiles, 8 KB chunks streamed through a cp.async
// ring per group). Replace _dq_kernel (:167) and _dkv_kernel (:222) of
// shockwave_tpu/ops/flash_attention.py in f32 at head dims above 256.
//
// Bound on an H100 SXM at the bench shape (4, 2048, 8, 512) causal, as
// 3xTF32 at 164.8 TFLOP/s: K2 206 GFLOP, 1.25 ms; K3 275 GFLOP, 1.67 ms.
// At the main shape (64, 32, 8, 512) key-padded by bytes: K2 168 MB, 50
// us; K3 201 MB, 60 us.
//
// What held the first f32 design (16-row CTAs of 256 output columns, two
// warps per 16 rows on mma.sync) back, and what this one does:
// 1. CTAs of 64 threads on 16 rows, 4-6 warps per SM. Here a CTA is two
//    warpgroups (256 threads) over a 64-row tile, one CTA per SM; a
//    group's output columns (64 x 256 f32) are 128 registers a thread.
// 2. Each score tile formed 2 x D / 256 = 4 times at D = 512.
//    K3 (grid BH x 64-key tiles x D / 256): group 0 forms S^T = K.Q^T over
//    the full contraction, turns it into P^T and owns the CTA's 256
//    columns of dV (dV += P^T.dO); group 1 forms dP^T = V.dO^T and owns
//    the same columns of dK (dK += dS^T.Q). Group 0 hands P to group 1
//    through a 16 KB f32 exchange, each thread's 32 values in its own
//    slots: it waits at named barrier 4 until group 1 has read the last
//    tile's P (from the second tile on), writes, and arrives at barrier 3,
//    where group 1 waits; group 1 reads and arrives at 4. Each score tile
//    is formed D / 256 times (2 at D = 512): no register file holds all
//    512 columns of both dK and dV. The two groups do equal work, one
//    score product and one output product each.
//    K2 (grid BH x 64-query tiles x ceil(D / 512)): group 0 forms S =
//    Q.K^T, group 1 dP = dO.V^T; they swap tiles through the exchange as
//    K1 wide's groups swap halves of S (barriers 3 and 4, one wait a
//    group), and both form the same dS (the same inputs and the same
//    code). Each owns 256 columns of dQ (dQ += dS.K), so at D <= 512 each
//    score tile is formed once; each further 512 columns of D adds a CTA
//    that forms it again. Where D is a multiple of 512 an instance of its
//    own (kWhole) takes a constant count of output steps.
// 3. K3 copied its own K and V again at every q-tile, and every operand
//    of every product was re-read by each warp. Here every operand streams
//    once per (q-tile, k-tile) and CTA through the group's ring in 8 KB
//    chunks (64 rows x 32 f32, swizzled for wgmma): two a score step (the
//    A chunk, then the B chunk), then one per output step (the slice
//    operand: K3's dO and Q, K2's K), every tile in one flat sequence, 8
//    chunks deep (a step of two needs 4 at least). A step waits twice on
//    the group's named barrier, once when its chunks have landed and once
//    after staging, as K1 wide's f32 steps do. 64 x 512 f32 rows of K and
//    V (256 KB) cannot stay in shared memory beside the rings, so K3
//    re-streams them. At the bench shape K3 moves 2,048 CTAs x 16.5
//    q-tiles x 640 KB = 22 GB from L2 into shared memory (the first
//    design: 87), K2 1,024 x 16.5 x 640 KB = 11 GB (78). Measured on an
//    H100 and dropped (PERF.md): rings of 4 and 10 chunks (no faster);
//    staging the next step while a step's wgmma runs, one barrier a step
//    (K2 and K3 1.3-1.7x slower); K2's output steps counted at run time
//    (10% slower than kWhole).
// 4. 3xTF32 splits per fragment in each of the 4 formations. Here the
//    score step is K1 wide's (scores_chunk_tf32: A's fragments split in
//    registers as they are read, B split in place into its big plane, its
//    small plane staged in the group's scratch) and the output step is
//    K1's P.V (pv_chunk_tf32): the slice chunk staged transposed as wgmma's
//    K-major B, its rows permuted within each 8 as the accumulator's A
//    fragments hold them. Each tile's part of dK, dV and dQ is summed from
//    zero and added in f32.
// 5. Short sequences: a 64-row tile at T = 32 would be half padding.
//    kRows = 32 packs two (batch, head) pairs into one 64-row tile (rows
//    0-31 the first, 32-63 the second; pairs that do not meet give p = 0),
//    so the main shape runs half as many CTAs; launch_config picks it up to
//    T = 32. The masking, the guard p = 0 where s <= -5e29 and the order
//    (scale, causal -1e30, key bias) are the narrow kernels'; rows past a
//    ragged end or a missing pair read 0 and are never written.
// Shared memory: 1 KB of alignment, two rings of 8 chunks, the exchange and
// each group's 16 KB scratch: 181,248 bytes at every D.
// ---------------------------------------------------------------------------
constexpr int kBwdWideStages = 8;   // ring chunks per group
constexpr int kBwdChunkCols = 32;   // f32 columns of a chunk
constexpr int kChunkFloats = kChunkBytes / 4;
constexpr size_t kBwdWideSmem =
    kSmemAlign + 2 * kBwdWideStages * kChunkBytes + kExchangeBytes + 2 * 2 * kChunkBytes;

// The (batch, head) pairs bh0 and bh0 + 1 of a (B, H, T, D) view x (B =
// BH / heads): row r of pair p at x0 + p step + r ld. The offsets fit 32
// bits (the wide entries check it: rows_fit, pairs_fit), so a tensor holds
// four registers across the loops, as a base and a pair stride did.
template <typename T>
struct Pairs {
  const T* x0;
  int step, ld;
  __device__ __forceinline__ Pairs(const T* x, const Strides& s, int bh0, int heads)
      : x0(x + head_offset(s, bh0, heads)),
        step((int)(head_offset(s, bh0 + 1, heads) - head_offset(s, bh0, heads))),
        ld((int)s.t) {}
  __device__ __forceinline__ const T* at(int pair, int row) const {
    return x0 + (pair * step + row * ld);
  }
};

// Start cp.async copies of a 64-row chunk (the 128 bytes of columns from
// `col` on: 32 f32 or 64 bf16) of 64 / kRows (batch, head) pairs' (len, d)
// matrices: chunk row r is row row0 + r % kRows of pair r / kRows. Pairs
// from `pairs` on and rows past `len` are zero-filled.
template <int kRows, typename T>
__device__ __forceinline__ void copy_chunk_pairs(T* dst, const Pairs<T>& src, int pairs, int row0,
                                                 int len, int col, int tid) {
  constexpr int U = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < kFwdWideRows * 8 / 128; ++i) {
    const int r = (tid >> 3) + 16 * i, u = tid & 7;
    const int pair = r / kRows, row = row0 + r % kRows;
    const bool valid = pair < pairs && row < len;
    cp_async16(dst + r * 8 * U + (u ^ (r & 7)) * U,
               (valid ? src.at(pair, row) : src.x0) + col + u * U, valid);
  }
}

// The key bias of `key` of (batch, head) pair bh (mask row bh / heads), or
// -inf where the pair is missing.
__device__ __forceinline__ float pair_key_bias(const uint8_t* mask, int bh, int nbh, int heads,
                                               int key, int tk) {
  if (bh >= nbh) return minus_infinity();
  return key_bias(mask != nullptr ? mask + (size_t)(bh / heads) * tk : nullptr, key, tk);
}

// The ring of a group of a K2 or K3 CTA: chunk e of the flat sequence in
// slot e % kStages; `acquire(n)` waits until chunks [next, next + n) have
// landed for the whole group and refills the slots before them,
// `staged()` releases what the group staged to wgmma.
template <typename T = float, int kStages = kBwdWideStages>
struct BwdRing {
  T* slots;
  int loaded, next, total;
  template <typename Load>
  __device__ __forceinline__ void start(const Load& load) {
    loaded = next = 0;
    while (loaded < total && loaded < kStages) load(loaded++);
  }
  template <typename Load>
  __device__ __forceinline__ void acquire(int n, int grp, const Load& load) {
    cp_async_wait_at_most(loaded - next - n);
    fence_async_shared();
    named_sync(1 + grp, 128);
    while (loaded < total && loaded < next + kStages) load(loaded++);
  }
  __device__ __forceinline__ T* at(int e) const {
    return slots + (e % kStages) * (kChunkBytes / (int)sizeof(T));
  }
};

__device__ __forceinline__ void staged(int grp) {
  fence_async_shared();
  named_sync(1 + grp, 128);
}

// s (the group's 64 x 64 score tile) = A.B^T over the full contraction:
// chunk c of the A rows, then chunk c of the B rows, a step each.
template <typename Load>
__device__ __forceinline__ void scores_tf32(float (&s)[8][4], BwdRing<>& ring, float* scratch,
                                            int nc, int grp, int tid, const Load& load) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    ring.acquire(2, grp, load);
    float* bc = ring.at(ring.next + 1);
    split_chunk(bc, scratch, tid);
    staged(grp);
    scores_chunk_tf32(s, ring.at(ring.next), bc, scratch, warp * 16, g, t);
    ring.next += 2;
  }
}

// acc (the group's 64 rows x 32 nv columns) += A.X over the tile's 64
// reduction rows: A the 64 x 64 accumulator tile a (P^T, dS^T or dS), X
// the next nv ring chunks (64 rows x 32 columns each), each staged
// transposed, its part summed from zero and added in f32.
template <int kMaxV, typename Load>
__device__ __forceinline__ void add_products_tf32(float (&acc)[kMaxV * 4][4],
                                                  const float (&a)[8][4], BwdRing<>& ring,
                                                  float* scratch, int nv, int grp, int tid,
                                                  const Load& load) {
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int vc = 0; vc < kMaxV; ++vc) {
    if (vc < nv) {
      ring.acquire(1, grp, load);
      stage_v_transposed(ring.at(ring.next), scratch, tid);
      staged(grp);
      pv_chunk_tf32(reinterpret_cast<float(&)[4][4]>(acc[vc * 4]), a, scratch, one);
      ++ring.next;
    }
  }
}

// K3's per-tile terms, as the f32 and bf16 kernels form them (design note
// 2): group 0 turns its S^T into P^T in s (scale, causal -1e30, then the
// key bias, as _dkv_kernel orders them; p = 0 where s <= -5e29, past tq,
// and where the query's pair is not the key's) and hands it to group 1
// through the exchange: it waits at barrier 4 until group 1 has read the
// last tile's P (unless `first`), writes and arrives at barrier 3. Group 1
// waits there and turns its dP^T into dS^T = p (dP^T - delta) scale in s,
// then arrives at barrier 4. The lane holds keys key[h] (e >> 1 = h) of
// pairs kpair[h], biases bias[h], against the queries of columns 8j + 2t +
// (e & 1) of q-tile qt.
template <int kRows>
__device__ __forceinline__ void dkv_terms(float (&s)[8][4], float* ex, int grp, int tid, int qt,
                                          bool first, const int (&key)[2],
                                          const int (&kpair)[2], const float (&bias)[2],
                                          const float* lse, const float* delta, int bh0, int tq,
                                          float scale, int causal) {
  const int t = tid & 3;
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const int qpair = c / kRows, query = qt * kRows + c % kRows;
        float x = s[j][e] * scale;
        if (causal && query < key[h]) x = kNegInf;
        x += bias[h];
        const bool live = qpair == kpair[h] && query < tq && x > kNegInf * 0.5f;
        s[j][e] = live ? __expf(x - lse[(size_t)(bh0 + qpair) * tq + query]) : 0.f;
      }
    }
    if (!first) named_sync(4, 256);  // group 1 has read the last tile's P
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ex[(4 * j + e) * 128 + tid] = s[j][e];
    }
    named_arrive(3, 256);
  } else {
    named_sync(3, 256);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const float p = ex[(4 * j + e) * 128 + tid];
        const float dl =
            p != 0.f ? delta[(size_t)(bh0 + c / kRows) * tq + qt * kRows + c % kRows] : 0.f;
        s[j][e] = p * (s[j][e] - dl) * scale;
      }
    }
    named_arrive(4, 256);
  }
}

// K2's per-tile dS, as the f32 and bf16 kernels form it (design note 2):
// group 0 holds S and group 1 dP in s; they swap tiles through the
// exchange as K1 wide's groups swap halves of S (barriers 3 and 4, one
// wait a group), and both form the same dS = p (dP - delta) scale in s:
// scale, causal -1e30, then the key bias, as _dq_kernel orders them; p = 0
// where s <= -5e29 and where the key's pair is not the query's. The lane
// holds queries query[h] (e >> 1 = h) of pairs qpair[h] against the keys
// of columns 8j + 2t + (e & 1) of k-tile kt.
template <int kRows>
__device__ __forceinline__ void dq_terms(float (&s)[8][4], float* ex, int grp, int tid, int kt,
                                         const int (&query)[2], const int (&qpair)[2],
                                         const float (&row_lse)[2], const float (&row_delta)[2],
                                         const uint8_t* mask, int bh0, int nbh, int heads,
                                         int tk, float scale, int causal) {
  const int t = tid & 3;
  float o[8][4];  // the other group's tile
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ex[(4 * j + e) * 128 + tid] = s[j][e];
    }
    named_arrive(3, 256);
    named_sync(4, 256);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = ex[(4 * j + e) * 128 + tid];
    }
  } else {
    named_sync(3, 256);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[j][e] = ex[(4 * j + e) * 128 + tid];
        ex[(4 * j + e) * 128 + tid] = s[j][e];
      }
    }
    named_arrive(4, 256);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1), h = e >> 1;
      const int kpair = c / kRows, key = kt * kRows + c % kRows;
      const float sv = grp == 0 ? s[j][e] : o[j][e];
      const float dpv = grp == 0 ? o[j][e] : s[j][e];
      float x = sv * scale;
      if (causal && query[h] < key) x = kNegInf;
      x += pair_key_bias(mask, bh0 + kpair, nbh, heads, key, tk);
      const float p =
          (x <= kNegInf * 0.5f || kpair != qpair[h]) ? 0.f : __expf(x - row_lse[h]);
      s[j][e] = p * (dpv - row_delta[h]) * scale;
    }
  }
}

// The lane's rows of a 64-row tile of kRows-row tiles (K2: queries of
// q-tile `tile`; K3: keys of k-tile `tile`): row 16 warp + g + 8h (h = e >>
// 1 of its accumulator entries) is row[h] of (batch, head) pair bh0 +
// pair[h].
template <int kRows>
struct TileRows {
  int row[2], pair[2];
  __device__ __forceinline__ TileRows(int tile, int tid) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (tid >> 5) * 16 + ((tid & 31) >> 2) + 8 * h;
      pair[h] = r / kRows;
      row[h] = tile * kRows + r % kRows;
    }
  }
};

// K3 in f32 at wide head dims: dK and dV. Grid (ceil(BH / kPairs),
// k-tiles of kRows keys, D / 256); a CTA walks the q-tiles from the causal
// diagonal on.
template <int kRows>
__global__ void __launch_bounds__(kFwdWideThreads, 1)
    flash_dkv_wide_f32_kernel(const float* __restrict__ q, Strides qs,
                              const float* __restrict__ k, Strides ks,
                              const float* __restrict__ v, Strides vs,
                              const float* __restrict__ g, Strides gs,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const uint8_t* __restrict__ mask, float* __restrict__ dk,
                              Strides dks, float* __restrict__ dv, Strides dvs, int nbh,
                              int heads, int tq, int tk, int d, float scale, int causal) {
  constexpr int kPairs = kFwdWideRows / kRows;  // (batch, head) pairs a tile packs
  constexpr int kMaxV = kWideSlice / kBwdChunkCols;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kSmemAlign - smem_addr(smem) % kSmemAlign) % kSmemAlign;
  const int grp = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int t = tid & 3;
  float* ex = reinterpret_cast<float*>(base + 2 * kBwdWideStages * kChunkBytes);
  float* scratch = reinterpret_cast<float*>(base + 2 * kBwdWideStages * kChunkBytes +
                                            kExchangeBytes + grp * 2 * kChunkBytes);

  const int bh0 = blockIdx.x * kPairs, pairs = min(kPairs, nbh - bh0);
  const int kt = blockIdx.y;
  const int slice0 = blockIdx.z * kWideSlice;
  const int nc = d / kBwdChunkCols;  // contraction chunks per q-tile
  const int per_tile = 2 * nc + kMaxV;
  const int qt0 = causal ? kt : 0;  // q-tiles above the diagonal see none of these keys
  const int tiles = max((tq + kRows - 1) / kRows - qt0, 0);
  // Group 0: S^T = K.Q^T, then dV += P^T.dO; group 1: dP^T = V.dO^T, then
  // dK += dS^T.Q.
  const Pairs<float> a_src(grp == 0 ? k : v, grp == 0 ? ks : vs, bh0, heads);
  const Pairs<float> b_src(grp == 0 ? q : g, grp == 0 ? qs : gs, bh0, heads);
  const Pairs<float> x_src(grp == 0 ? g : q, grp == 0 ? gs : qs, bh0, heads);
  const TileRows<kRows> keys(kt, tid);
  float bias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    bias[h] = pair_key_bias(mask, bh0 + keys.pair[h], nbh, heads, keys.row[h], tk);

  BwdRing<> ring{reinterpret_cast<float*>(base) + grp * kBwdWideStages * kChunkFloats, 0, 0,
                 tiles * per_tile};
  auto load = [&](int e) {
    const int q0 = (qt0 + e / per_tile) * kRows, r = e % per_tile;
    float* dst = ring.at(e);
    if (r >= 2 * nc)
      copy_chunk_pairs<kRows>(dst, x_src, pairs, q0, tq, slice0 + (r - 2 * nc) * kBwdChunkCols,
                              tid);
    else if (r % 2 == 0)
      copy_chunk_pairs<kRows>(dst, a_src, pairs, kt * kRows, tk, r / 2 * kBwdChunkCols, tid);
    else
      copy_chunk_pairs<kRows>(dst, b_src, pairs, q0, tq, r / 2 * kBwdChunkCols, tid);
    cp_async_commit();
  };
  ring.start(load);

  float acc[kMaxV * 4][4] = {};  // the group's 64 keys x 256 columns of dV or dK
  for (int i = 0; i < tiles; ++i) {
    float s[8][4];
    scores_tf32(s, ring, scratch, nc, grp, tid, load);
    dkv_terms<kRows>(s, ex, grp, tid, qt0 + i, i == 0, keys.row, keys.pair, bias, lse, delta,
                     bh0, tq, scale, causal);
    add_products_tf32<kMaxV>(acc, s, ring, scratch, kMaxV, grp, tid, load);
  }
  if (grp == 0 && tiles > 0) named_sync(4, 256);  // group 1's last arrival

  float* out = grp == 0 ? dv : dk;
  const Strides& os = grp == 0 ? dvs : dks;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys.pair[h] >= pairs || keys.row[h] >= tk) continue;
    float* row = out + head_offset(os, bh0 + keys.pair[h], heads) + keys.row[h] * os.t + slice0;
#pragma unroll
    for (int n = 0; n < kMaxV * 4; ++n)
      store2(row + 8 * n + 2 * t, acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// K2 in f32 at wide head dims: dQ. Grid (ceil(BH / kPairs), q-tiles of
// kRows queries, ceil(D / 512)), heaviest causal tile first. kWhole: D is a
// multiple of 512, so every CTA owns 512 columns and a group's output
// steps a tile are a constant (design note 3).
template <int kRows, bool kWhole>
__global__ void __launch_bounds__(kFwdWideThreads, 1)
    flash_dq_wide_f32_kernel(const float* __restrict__ q, Strides qs,
                             const float* __restrict__ k, Strides ks,
                             const float* __restrict__ v, Strides vs,
                             const float* __restrict__ g, Strides gs,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const uint8_t* __restrict__ mask, float* __restrict__ dq,
                             Strides dqs, int nbh, int heads, int tq, int tk, int d, float scale,
                             int causal) {
  constexpr int kPairs = kFwdWideRows / kRows;
  constexpr int kMaxV = kFwdWideSlice / 2 / kBwdChunkCols;  // output chunks a group owns
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kSmemAlign - smem_addr(smem) % kSmemAlign) % kSmemAlign;
  const int grp = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int t = tid & 3;
  float* ex = reinterpret_cast<float*>(base + 2 * kBwdWideStages * kChunkBytes);
  float* scratch = reinterpret_cast<float*>(base + 2 * kBwdWideStages * kChunkBytes +
                                            kExchangeBytes + grp * 2 * kChunkBytes);

  const int bh0 = blockIdx.x * kPairs, pairs = min(kPairs, nbh - bh0);
  const int qt = gridDim.y - 1 - blockIdx.y;  // causal: the longest k loops start first
  const int slice0 = blockIdx.z * kFwdWideSlice;
  const int half = kWhole ? kFwdWideSlice / 2 : min(kFwdWideSlice, d - slice0) / 2;
  const int col0 = slice0 + grp * half;
  const int nv = half / kBwdChunkCols;  // output chunks a group takes per k-tile
  const int nc = d / kBwdChunkCols;
  const int per_tile = 2 * nc + nv;
  int nk = (tk + kRows - 1) / kRows;
  if (causal) nk = min(nk, qt + 1);  // k-tiles past the diagonal see nothing
  // Group 0: S = Q.K^T; group 1: dP = dO.V^T; both then dQ += dS.K over
  // their own columns.
  const Pairs<float> a_src(grp == 0 ? q : g, grp == 0 ? qs : gs, bh0, heads);
  const Pairs<float> b_src(grp == 0 ? k : v, grp == 0 ? ks : vs, bh0, heads);
  const Pairs<float> x_src(k, ks, bh0, heads);
  // A row past tq or of a missing pair reads 0 (Q, dO, lse and delta), so
  // its dS is 0, and is never written.
  const TileRows<kRows> rows(qt, tid);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows.pair[h] < pairs && rows.row[h] < tq;
    const size_t at = (size_t)(bh0 + rows.pair[h]) * tq + rows.row[h];
    row_lse[h] = in ? lse[at] : 0.f;
    row_delta[h] = in ? delta[at] : 0.f;
  }

  BwdRing<> ring{reinterpret_cast<float*>(base) + grp * kBwdWideStages * kChunkFloats, 0, 0,
                 nk * per_tile};
  auto load = [&](int e) {
    const int k0 = e / per_tile * kRows, r = e % per_tile;
    float* dst = ring.at(e);
    if (r >= 2 * nc)
      copy_chunk_pairs<kRows>(dst, x_src, pairs, k0, tk, col0 + (r - 2 * nc) * kBwdChunkCols,
                              tid);
    else if (r % 2 == 0)
      copy_chunk_pairs<kRows>(dst, a_src, pairs, qt * kRows, tq, r / 2 * kBwdChunkCols, tid);
    else
      copy_chunk_pairs<kRows>(dst, b_src, pairs, k0, tk, r / 2 * kBwdChunkCols, tid);
    cp_async_commit();
  };
  ring.start(load);

  float acc[kMaxV * 4][4] = {};  // the group's 64 rows x up to 256 columns of dQ
  for (int kt = 0; kt < nk; ++kt) {
    float s[8][4];
    scores_tf32(s, ring, scratch, nc, grp, tid, load);
    dq_terms<kRows>(s, ex, grp, tid, kt, rows.row, rows.pair, row_lse, row_delta, mask, bh0,
                    nbh, heads, tk, scale, causal);
    add_products_tf32<kMaxV>(acc, s, ring, scratch, nv, grp, tid, load);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows.pair[h] >= pairs || rows.row[h] >= tq) continue;
    float* row = dq + head_offset(dqs, bh0 + rows.pair[h], heads) + rows.row[h] * dqs.t + col0;
#pragma unroll
    for (int n = 0; n < kMaxV * 4; ++n) {
      if (n < nv * 4) store2(row + 8 * n + 2 * t, acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 and K3 at wide head dims in bf16: flash_dq_wide and flash_dkv_wide, on
// the f32 pair's data flow (two warpgroups over 64-row tiles, 8 KB chunks
// streamed through a cp.async ring per group, K2's exchange and K3's
// hand-off: dq_terms, dkv_terms) with bf16 wgmma for every product. Replace
// _dq_kernel (:167) and _dkv_kernel (:222) of
// shockwave_tpu/ops/flash_attention.py in bf16 at head dims above 256.
//
// Bound on an H100 SXM (989 bf16 TFLOP/s; 3.35 TB/s): at the bench shape
// (4, 2048, 8, 512) causal, by operations, K2 206 GFLOP, 209 us; K3 275
// GFLOP, 278 us. At the main shape (64, 32, 8, 512) key-padded, by bytes,
// K2 84 MB, 25 us; K3 101 MB, 30 us.
//
// What held the first bf16 design (32-row CTAs of 4 warps and 256 output
// columns on mma.sync) back, and what this one does:
// 1. 32-row CTAs, two warps per 16 rows. Here a CTA is two warpgroups (256
//    threads) over a 64-row tile, one CTA per SM; a group's 256 output
//    columns (64 rows, f32) are 128 registers a thread. Up to T = 32,
//    kRows = 32 packs two (batch, head) pairs into a tile, as in f32.
// 2. Each score tile formed 2 x D / 256 = 4 times at D = 512 (each of two
//    warps of 16 rows, and each CTA of 256 columns). Here K2 (a CTA per
//    64-query tile and 512 columns of dQ): group 0 forms S = Q.K^T, group
//    1 dP = dO.V^T, they swap tiles through the 16 KB f32 exchange and
//    both form the same dS; each owns 256 columns of dQ, so at D <= 512
//    each score tile is formed once per CTA. K3 (a CTA per 64-key tile and
//    256 columns of dK and dV): group 0 forms S^T = K.Q^T, turns it into P^T and owns dV (dV
//    += P^T.dO); it hands P, in f32 as _dkv_kernel keeps it, to group 1,
//    which forms dP^T = V.dO^T and owns dK (dK += dS^T.Q): each score tile
//    is formed D / 256 times (2 at D = 512), since no register file holds
//    512 columns of both dK and dV.
// 3. mma.sync from ldmatrix fragments, and the second product's operand
//    (K2: K; K3: Q and dO) copied a second time into a slice buffer. Here
//    every product is bf16 wgmma m64n64k16. The scores take both operands
//    K-major from swizzled chunks through descriptors (wgmma_ss), four
//    wgmma a chunk. The output products take dS, P^T or dS^T from
//    registers (the score accumulators repacked into A fragments,
//    accum_to_a, as K1 wide hands P to P.V) and B, 64 reduction rows x 64
//    columns, straight from the ring chunk of K (K2), dO or Q (K3),
//    row-major, through an MN-major descriptor (wgmma_rs): nothing is
//    staged, nothing transposed. Each tile's part of each 64-column output
//    chunk is summed from zero and added in f32 (the tensor cores' f32
//    accumulation truncates).
// 4. Two __syncthreads per 64-column chunk. Here a chunk is 64 rows x 64
//    bf16 (8 KB), and a group waits once per step, on its own named
//    barrier, when the step's chunks have landed (BwdRing), plus once per
//    tile pair on the exchange. The score's A operands (K2: Q and dO; K3:
//    K and V) do not change across a CTA's loop: at the 64-row tile, where
//    both groups' 64 x D tiles fit beside the rings (D = 512: 128 KB;
//    kResident), a CTA copies them once and they stay, and a score step
//    takes one chunk (a ring of 4); elsewhere they stream beside the B
//    chunks, two chunks a step (a ring of 8). The 32-row tile runs up to T
//    = 32, one tile pair a CTA, where a tile that stays saves no traffic.
//    At the bench shape K2 then moves 1,024 CTAs x 16.5 k-tiles x 2 groups
//    x 96 KB = 3.2 GB from L2 into shared memory (streamed: 5.4 GB), K3
//    2,048 x 16.5 x 192 KB = 6.5 GB (10.8). A tile's CTAs of other columns
//    sit side by side in grid x, so that they run together and share
//    their operands' reads in L2. Measured on an H100 and dropped
//    (PERF.md): the A tiles streamed at D = 512 (K2 1.17x, K3 1.28x slower
//    at the bench shape); the column CTAs in grid z (K3 1.2x slower at
//    the main shape); the score steps' wgmma left in flight across the
//    next step's wait (1-3% faster at the bench shape, 1.5-2% slower at
//    the main shape); two output parts in turn (K2 5% slower at the main
//    shape).
// 5. The masking, the guard p = 0 where s <= -5e29, the order (scale,
//    causal -1e30, key bias) and the pair test are the f32 pair's; rows
//    past a ragged end or of a missing pair read 0 and are never written.
// Shared memory: 1 KB of alignment, the exchange, two rings and, where they
// stay, the A tiles: 214,016 bytes at D = 512 (kResident), 148,480
// streamed; one CTA of 8 warps per SM (a thread's registers allow no
// second).
// ---------------------------------------------------------------------------
constexpr int kBwdBf16Cols = 64;  // bf16 columns of a chunk

// Ring chunks per group: 4 where a score step takes one chunk (A resident),
// 8 where it takes two (a two-chunk step needs 4 at least).
template <bool kResident>
constexpr int kBwdBf16Stages = kResident ? 4 : 8;

// The CTA's dynamic shared bytes at head dim d.
template <bool kResident>
__host__ __device__ constexpr size_t bwd_wide_bf16_smem(int d) {
  return kSmemAlign + kExchangeBytes + 2 * kBwdBf16Stages<kResident> * kChunkBytes +
         (kResident ? (size_t)2 * kFwdWideRows * d * sizeof(bf16) : 0);
}

// Whether both groups' 64 x d A tiles stay in shared memory: at the
// 64-row tile, where they fit (d = 512; design note 4).
template <int kRows>
constexpr bool kMayStay = kRows == kFwdWideRows;

template <int kRows>
__host__ __device__ constexpr bool bwd_wide_bf16_resident(int d) {
  return kMayStay<kRows> && bwd_wide_bf16_smem<true>(d) <= kMaxSmemPerCta;
}

// s (the group's 64 x 64 score tile) = A.B^T over the full contraction, a
// step per 64 columns: chunk c of the A rows (resident at a + c chunks, or
// the ring chunk before B's) and chunk c of the B rows.
template <bool kResident, typename Ring, typename Load>
__device__ __forceinline__ void scores_bf16(float (&s)[8][4], Ring& ring, const bf16* a, int nc,
                                            int grp, const Load& load) {
  constexpr int kPer = kResident ? 1 : 2;  // ring chunks a step takes
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    ring.acquire(kPer, grp, load);
    scores_chunk_wgmma(s, kResident ? a + c * (kChunkBytes / 2) : ring.at(ring.next),
                       ring.at(ring.next + kPer - 1));
    ring.next += kPer;
  }
}

// acc (the group's 64 rows x 64 nv columns) += A.X over the tile's 64
// reduction rows: A the 64 x 64 accumulator tile a (P^T, dS^T or dS) in
// bf16, X the next nv ring chunks (64 rows x 64 columns each, MN-major),
// each chunk's part summed from zero and added in f32.
template <int kMaxV, typename Ring, typename Load>
__device__ __forceinline__ void add_products_bf16(float (&acc)[kMaxV * 8][4],
                                                  const float (&a)[8][4], Ring& ring, int nv,
                                                  int grp, const Load& load) {
  uint32_t pa[4][4];  // a's A fragments, 16 reduction rows each
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) accum_to_a(pa[kk], a[2 * kk], a[2 * kk + 1]);
#pragma unroll
  for (int vc = 0; vc < kMaxV; ++vc) {
    if (vc < nv) {
      ring.acquire(1, grp, load);
      float part[8][4] = {};
      pv_chunk_wgmma(part, pa, ring.at(ring.next));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[vc * 8 + j][e] += part[j][e];
      }
      ++ring.next;
    }
  }
}

// K3 in bf16 at wide head dims: dK and dV. Grid (ceil(BH / kPairs) x D /
// 256, k-tiles of kRows keys), a tile's 256-column slices side by side in
// x; a CTA walks the q-tiles from the causal diagonal on.
template <int kRows, bool kResident>
__global__ void __launch_bounds__(kFwdWideThreads, 1)
    flash_dkv_wide_kernel(const bf16* __restrict__ q, Strides qs, const bf16* __restrict__ k,
                          Strides ks, const bf16* __restrict__ v, Strides vs,
                          const bf16* __restrict__ g, Strides gs, const float* __restrict__ lse,
                          const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                          bf16* __restrict__ dk, Strides dks, bf16* __restrict__ dv, Strides dvs,
                          int nbh, int heads, int tq, int tk, int d, float scale, int causal) {
  constexpr int kPairs = kFwdWideRows / kRows;
  constexpr int kMaxV = kWideSlice / kBwdBf16Cols;
  constexpr int kS = kBwdBf16Stages<kResident>, kPer = kResident ? 1 : 2;
  constexpr int kChunkElems = kChunkBytes / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kSmemAlign - smem_addr(smem) % kSmemAlign) % kSmemAlign;
  const int grp = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int t = tid & 3;
  const int nc = d / kBwdBf16Cols;  // contraction chunks per q-tile
  float* ex = reinterpret_cast<float*>(base + 2 * kS * kChunkBytes);
  bf16* sA = reinterpret_cast<bf16*>(base + 2 * kS * kChunkBytes + kExchangeBytes) +
             grp * nc * kChunkElems;  // the group's A tile, where it stays

  const int slices = d / kWideSlice;  // a tile's CTAs, side by side in x
  const int bh0 = blockIdx.x / slices * kPairs, pairs = min(kPairs, nbh - bh0);
  const int kt = blockIdx.y;
  const int slice0 = blockIdx.x % slices * kWideSlice;
  const int per_tile = kPer * nc + kMaxV;
  const int qt0 = causal ? kt : 0;  // q-tiles above the diagonal see none of these keys
  const int tiles = max((tq + kRows - 1) / kRows - qt0, 0);
  // Group 0: S^T = K.Q^T, then dV += P^T.dO; group 1: dP^T = V.dO^T, then
  // dK += dS^T.Q.
  const Pairs<bf16> a_src(grp == 0 ? k : v, grp == 0 ? ks : vs, bh0, heads);
  const Pairs<bf16> b_src(grp == 0 ? q : g, grp == 0 ? qs : gs, bh0, heads);
  const Pairs<bf16> x_src(grp == 0 ? g : q, grp == 0 ? gs : qs, bh0, heads);
  const TileRows<kRows> keys(kt, tid);
  float bias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    bias[h] = pair_key_bias(mask, bh0 + keys.pair[h], nbh, heads, keys.row[h], tk);

  BwdRing<bf16, kS> ring{reinterpret_cast<bf16*>(base) + grp * kS * kChunkElems, 0, 0,
                         tiles * per_tile};
  // Chunk e: of q-tile qt0 + e / per_tile, the score steps' chunks (A
  // streamed: A then B), then the output steps' X chunks of the slice.
  auto load = [&](int e) {
    const int q0 = (qt0 + e / per_tile) * kRows, r = e % per_tile;
    bf16* dst = ring.at(e);
    if (r >= kPer * nc)
      copy_chunk_pairs<kRows>(dst, x_src, pairs, q0, tq,
                              slice0 + (r - kPer * nc) * kBwdBf16Cols, tid);
    else if (!kResident && r % 2 == 0)
      copy_chunk_pairs<kRows>(dst, a_src, pairs, kt * kRows, tk, r / 2 * kBwdBf16Cols, tid);
    else
      copy_chunk_pairs<kRows>(dst, b_src, pairs, q0, tq, r / kPer * kBwdBf16Cols, tid);
    cp_async_commit();
  };
  if (kResident && tiles > 0) {  // landed by the first step's wait: it is older
    for (int c = 0; c < nc; ++c)
      copy_chunk_pairs<kRows>(sA + c * kChunkElems, a_src, pairs, kt * kRows, tk,
                              c * kBwdBf16Cols, tid);
    cp_async_commit();
  }
  ring.start(load);

  float acc[kMaxV * 8][4] = {};  // the group's 64 keys x 256 columns of dV or dK
  for (int i = 0; i < tiles; ++i) {
    float s[8][4];
    scores_bf16<kResident>(s, ring, sA, nc, grp, load);
    dkv_terms<kRows>(s, ex, grp, tid, qt0 + i, i == 0, keys.row, keys.pair, bias, lse, delta,
                     bh0, tq, scale, causal);
    add_products_bf16<kMaxV>(acc, s, ring, kMaxV, grp, load);
  }
  if (grp == 0 && tiles > 0) named_sync(4, 256);  // group 1's last arrival

  bf16* out = grp == 0 ? dv : dk;
  const Strides& os = grp == 0 ? dvs : dks;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys.pair[h] >= pairs || keys.row[h] >= tk) continue;
    bf16* row = out + head_offset(os, bh0 + keys.pair[h], heads) + keys.row[h] * os.t + slice0;
#pragma unroll
    for (int n = 0; n < kMaxV * 8; ++n)
      store2(row + 8 * n + 2 * t, acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// K2 in bf16 at wide head dims: dQ. Grid (ceil(BH / kPairs) x ceil(D /
// 512), q-tiles of kRows queries), a tile's 512-column slices side by
// side in x, heaviest causal tile first.
template <int kRows, bool kResident>
__global__ void __launch_bounds__(kFwdWideThreads, 1)
    flash_dq_wide_kernel(const bf16* __restrict__ q, Strides qs, const bf16* __restrict__ k,
                         Strides ks, const bf16* __restrict__ v, Strides vs,
                         const bf16* __restrict__ g, Strides gs, const float* __restrict__ lse,
                         const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                         bf16* __restrict__ dq, Strides dqs, int nbh, int heads, int tq, int tk,
                         int d, float scale, int causal) {
  constexpr int kPairs = kFwdWideRows / kRows;
  constexpr int kMaxV = kFwdWideSlice / 2 / kBwdBf16Cols;  // output chunks a group owns
  constexpr int kS = kBwdBf16Stages<kResident>, kPer = kResident ? 1 : 2;
  constexpr int kChunkElems = kChunkBytes / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (kSmemAlign - smem_addr(smem) % kSmemAlign) % kSmemAlign;
  const int grp = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int t = tid & 3;
  const int nc = d / kBwdBf16Cols;  // contraction chunks per k-tile
  float* ex = reinterpret_cast<float*>(base + 2 * kS * kChunkBytes);
  bf16* sA = reinterpret_cast<bf16*>(base + 2 * kS * kChunkBytes + kExchangeBytes) +
             grp * nc * kChunkElems;  // the group's A tile, where it stays

  const int slices = (d + kFwdWideSlice - 1) / kFwdWideSlice;  // a tile's CTAs, side by side
  const int bh0 = blockIdx.x / slices * kPairs, pairs = min(kPairs, nbh - bh0);
  const int qt = gridDim.y - 1 - blockIdx.y;  // causal: the longest k loops start first
  const int slice0 = blockIdx.x % slices * kFwdWideSlice;
  // A resident A tile means D = 512: every CTA owns 512 columns.
  const int half = kResident ? kFwdWideSlice / 2 : min(kFwdWideSlice, d - slice0) / 2;
  const int col0 = slice0 + grp * half;
  const int nv = half / kBwdBf16Cols;  // output chunks a group takes per k-tile
  const int per_tile = kPer * nc + nv;
  int nk = (tk + kRows - 1) / kRows;
  if (causal) nk = min(nk, qt + 1);  // k-tiles past the diagonal see nothing
  // Group 0: S = Q.K^T; group 1: dP = dO.V^T; both then dQ += dS.K over
  // their own columns.
  const Pairs<bf16> a_src(grp == 0 ? q : g, grp == 0 ? qs : gs, bh0, heads);
  const Pairs<bf16> b_src(grp == 0 ? k : v, grp == 0 ? ks : vs, bh0, heads);
  const Pairs<bf16> x_src(k, ks, bh0, heads);
  // A row past tq or of a missing pair reads 0 (Q, dO, lse and delta), so
  // its dS is 0, and is never written.
  const TileRows<kRows> rows(qt, tid);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows.pair[h] < pairs && rows.row[h] < tq;
    const size_t at = (size_t)(bh0 + rows.pair[h]) * tq + rows.row[h];
    row_lse[h] = in ? lse[at] : 0.f;
    row_delta[h] = in ? delta[at] : 0.f;
  }

  BwdRing<bf16, kS> ring{reinterpret_cast<bf16*>(base) + grp * kS * kChunkElems, 0, 0,
                         nk * per_tile};
  // Chunk e: of k-tile e / per_tile, the score steps' chunks (A streamed: A
  // then B), then the output steps' K chunks of the group's columns.
  auto load = [&](int e) {
    const int k0 = e / per_tile * kRows, r = e % per_tile;
    bf16* dst = ring.at(e);
    if (r >= kPer * nc)
      copy_chunk_pairs<kRows>(dst, x_src, pairs, k0, tk, col0 + (r - kPer * nc) * kBwdBf16Cols,
                              tid);
    else if (!kResident && r % 2 == 0)
      copy_chunk_pairs<kRows>(dst, a_src, pairs, qt * kRows, tq, r / 2 * kBwdBf16Cols, tid);
    else
      copy_chunk_pairs<kRows>(dst, b_src, pairs, k0, tk, r / kPer * kBwdBf16Cols, tid);
    cp_async_commit();
  };
  if (kResident) {  // landed by the first step's wait: it is older
    for (int c = 0; c < nc; ++c)
      copy_chunk_pairs<kRows>(sA + c * kChunkElems, a_src, pairs, qt * kRows, tq,
                              c * kBwdBf16Cols, tid);
    cp_async_commit();
  }
  ring.start(load);

  float acc[kMaxV * 8][4] = {};  // the group's 64 rows x up to 256 columns of dQ
  for (int kt = 0; kt < nk; ++kt) {
    float s[8][4];
    scores_bf16<kResident>(s, ring, sA, nc, grp, load);
    dq_terms<kRows>(s, ex, grp, tid, kt, rows.row, rows.pair, row_lse, row_delta, mask, bh0,
                    nbh, heads, tk, scale, causal);
    add_products_bf16<kMaxV>(acc, s, ring, nv, grp, load);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows.pair[h] >= pairs || rows.row[h] >= tq) continue;
    bf16* row = dq + head_offset(dqs, bh0 + rows.pair[h], heads) + rows.row[h] * dqs.t + col0;
#pragma unroll
    for (int n = 0; n < kMaxV * 8; ++n) {
      if (n < nv * 8) store2(row + 8 * n + 2 * t, acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// The wide instances take any multiple of 256 above 256.
bool wide_head_dim(int d) { return d > 256 && d % kWideSlice == 0; }

template <typename T, bool kQResident>
int launch_fwd_wide_as(View q, View k, View v, const void* mask, View out,
                       void* lse, int bh, int heads, int tq, int tk, int d, float scale,
                       int causal, cudaStream_t stream) {
  // The opt-in covers every d: the launch asks for what this d takes.
  static bool configured[kMaxDevices] = {};
  cudaError_t err =
      set_smem(flash_fwd_wide_kernel<T, kQResident>, kMaxSmemPerCta, configured);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fwd_wide_smem<T, kQResident>(d);
  const dim3 grid(bh, (tq + kFwdWideRows - 1) / kFwdWideRows,
                  (d + kFwdWideSlice - 1) / kFwdWideSlice);
  flash_fwd_wide_kernel<T, kQResident><<<grid, kFwdWideThreads, smem, stream>>>(
      ptr<const T>(q), q.s, ptr<const T>(k), k.s, ptr<const T>(v), v.s,
      static_cast<const uint8_t*>(mask), ptr<T>(out), out.s, static_cast<float*>(lse), heads,
      tq, tk, d, scale, causal);
  return (int)cudaGetLastError();
}

// K1 wide with Q staying in shared memory where it fits, streamed where not.
template <typename T>
int launch_fwd_wide(View q, View k, View v, const void* mask, View out,
                    void* lse, int bh, int heads, int tq, int tk, int d, float scale, int causal,
                    cudaStream_t stream) {
  return fwd_wide_q_resident<T>(d)
             ? launch_fwd_wide_as<T, true>(q, k, v, mask, out, lse, bh, heads, tq, tk, d, scale,
                                          causal, stream)
             : launch_fwd_wide_as<T, false>(q, k, v, mask, out, lse, bh, heads, tq, tk, d, scale,
                                           causal, stream);
}

// K2 and K3 wide, both dtypes: 64 rows of one (batch, head) pair, or 32
// rows of each of two.
bool bwd_wide_tile(int tile) { return tile == kFwdWideRows || tile == kFwdWideRows / 2; }

template <int kRows, bool kResident>
int launch_dq_wide_as(View q, View k, View v, View g, const void* lse,
                      const void* delta, const void* mask, View dq, int bh, int heads, int tq,
                      int tk, int d, float scale, int causal, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_dq_wide_kernel<kRows, kResident>, kMaxSmemPerCta, configured);
  if (err != cudaSuccess) return (int)err;
  constexpr int kPairs = kFwdWideRows / kRows;
  const dim3 grid((bh + kPairs - 1) / kPairs * ((d + kFwdWideSlice - 1) / kFwdWideSlice),
                  (tq + kRows - 1) / kRows);
  const size_t smem = bwd_wide_bf16_smem<kResident>(d);
  flash_dq_wide_kernel<kRows, kResident><<<grid, kFwdWideThreads, smem, stream>>>(
      ptr<const bf16>(q), q.s, ptr<const bf16>(k), k.s, ptr<const bf16>(v), v.s,
      ptr<const bf16>(g), g.s, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      ptr<bf16>(dq), dq.s, bh, heads, tq, tk, d, scale, causal);
  return (int)cudaGetLastError();
}

// K2 wide in bf16 at tile kRows, the A tiles resident where they stay.
template <int kRows>
int launch_dq_wide_of(View q, View k, View v, View g, const void* lse, const void* delta,
                      const void* mask, View dq, int bh,
                      int heads, int tq, int tk, int d, float scale, int causal,
                      cudaStream_t stream) {
  const auto launch = bwd_wide_bf16_resident<kRows>(d)
                          ? launch_dq_wide_as<kRows, kMayStay<kRows>>
                          : launch_dq_wide_as<kRows, false>;
  return launch(q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, d, scale, causal, stream);
}

template <int kRows, bool kResident>
int launch_dkv_wide_as(View q, View k, View v, View g, const void* lse, const void* delta,
                       const void* mask, View dk, View dv,
                       int bh, int heads, int tq, int tk, int d, float scale, int causal,
                       cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err =
      set_smem(flash_dkv_wide_kernel<kRows, kResident>, kMaxSmemPerCta, configured);
  if (err != cudaSuccess) return (int)err;
  constexpr int kPairs = kFwdWideRows / kRows;
  const dim3 grid((bh + kPairs - 1) / kPairs * (d / kWideSlice), (tk + kRows - 1) / kRows);
  const size_t smem = bwd_wide_bf16_smem<kResident>(d);
  flash_dkv_wide_kernel<kRows, kResident><<<grid, kFwdWideThreads, smem, stream>>>(
      ptr<const bf16>(q), q.s, ptr<const bf16>(k), k.s, ptr<const bf16>(v), v.s,
      ptr<const bf16>(g), g.s, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      ptr<bf16>(dk), dk.s, ptr<bf16>(dv), dv.s, bh, heads, tq, tk, d, scale, causal);
  return (int)cudaGetLastError();
}

// K3 wide in bf16 at tile kRows, the A tiles resident where they stay.
template <int kRows>
int launch_dkv_wide_of(View q, View k, View v, View g, const void* lse, const void* delta,
                       const void* mask, View dk, View dv,
                       int bh, int heads, int tq, int tk, int d, float scale, int causal,
                       cudaStream_t stream) {
  const auto launch = bwd_wide_bf16_resident<kRows>(d)
                          ? launch_dkv_wide_as<kRows, kMayStay<kRows>>
                          : launch_dkv_wide_as<kRows, false>;
  return launch(q, k, v, g, lse, delta, mask, dk, dv, bh, heads, tq, tk, d, scale, causal,
                stream);
}

template <int kRows, bool kWhole>
int launch_dq_wide_f32_as(View q, View k, View v, View g, const void* lse, const void* delta,
                          const void* mask, View dq, int bh,
                          int heads, int tq, int tk, int d, float scale, int causal,
                          cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_dq_wide_f32_kernel<kRows, kWhole>, kBwdWideSmem, configured);
  if (err != cudaSuccess) return (int)err;
  constexpr int kPairs = kFwdWideRows / kRows;
  const dim3 grid((bh + kPairs - 1) / kPairs, (tq + kRows - 1) / kRows,
                  (d + kFwdWideSlice - 1) / kFwdWideSlice);
  flash_dq_wide_f32_kernel<kRows, kWhole><<<grid, kFwdWideThreads, kBwdWideSmem, stream>>>(
      ptr<const float>(q), q.s, ptr<const float>(k), k.s, ptr<const float>(v), v.s,
      ptr<const float>(g), g.s, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      ptr<float>(dq), dq.s, bh, heads, tq, tk, d, scale, causal);
  return (int)cudaGetLastError();
}

// K2 wide in f32 at tile kRows: every CTA of 512 columns where D is a
// multiple of 512.
template <int kRows>
int launch_dq_wide_f32_of(View q, View k, View v, View g, const void* lse, const void* delta,
                          const void* mask, View dq, int bh,
                          int heads, int tq, int tk, int d, float scale, int causal,
                          cudaStream_t stream) {
  const auto launch = d % kFwdWideSlice == 0 ? launch_dq_wide_f32_as<kRows, true>
                                             : launch_dq_wide_f32_as<kRows, false>;
  return launch(q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, d, scale, causal, stream);
}

template <int kRows>
int launch_dkv_wide_f32_as(View q, View k, View v, View g, const void* lse, const void* delta,
                           const void* mask, View dk, View dv, int bh, int heads, int tq, int tk,
                           int d, float scale,
                           int causal, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(flash_dkv_wide_f32_kernel<kRows>, kBwdWideSmem, configured);
  if (err != cudaSuccess) return (int)err;
  constexpr int kPairs = kFwdWideRows / kRows;
  const dim3 grid((bh + kPairs - 1) / kPairs, (tk + kRows - 1) / kRows, d / kWideSlice);
  flash_dkv_wide_f32_kernel<kRows><<<grid, kFwdWideThreads, kBwdWideSmem, stream>>>(
      ptr<const float>(q), q.s, ptr<const float>(k), k.s, ptr<const float>(v), v.s,
      ptr<const float>(g), g.s, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      ptr<float>(dk), dk.s, ptr<float>(dv), dv.s, bh, heads, tq, tk, d, scale, causal);
  return (int)cudaGetLastError();
}

// The occupancy of a wide kernel that takes `smem` bytes (its shared bytes
// at the head dim asked about). The query sets the kernel's shared-memory
// opt-in to those bytes; it is put back to the most a CTA may take, which
// the launchers rely on.
template <typename Kernel>
int occupancy_restoring(Kernel kernel, size_t smem, int* out) {
  const int err = occupancy(kernel, kFwdWideThreads, smem, out);
  if (err != 0) return err;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSmemPerCta);
}

// Kernels 6 and 9 (K1 wide in bf16 and f32) at head dim d, the instance
// that d takes.
template <typename T>
int occupancy_of_fwd_wide(int d, int* out) {
  return fwd_wide_q_resident<T>(d)
             ? occupancy_restoring(flash_fwd_wide_kernel<T, true>, fwd_wide_smem<T, true>(d), out)
             : occupancy_restoring(flash_fwd_wide_kernel<T, false>, fwd_wide_smem<T, false>(d),
                                   out);
}

// Kernels 7-8 (K2-K3 wide in bf16) at head dim d and a tile of kRows rows
// a pair, the instance that d takes.
template <int kRows, bool kResident>
int occupancy_of_wide_bf16_as(int kernel, int d, int* out) {
  const size_t smem = bwd_wide_bf16_smem<kResident>(d);
  return kernel == 7 ? occupancy_restoring(flash_dq_wide_kernel<kRows, kResident>, smem, out)
                     : occupancy_restoring(flash_dkv_wide_kernel<kRows, kResident>, smem, out);
}

template <int kRows>
int occupancy_of_wide_bf16(int kernel, int d, int* out) {
  return bwd_wide_bf16_resident<kRows>(d)
             ? occupancy_of_wide_bf16_as<kRows, kMayStay<kRows>>(kernel, d, out)
             : occupancy_of_wide_bf16_as<kRows, false>(kernel, d, out);
}

// Kernels 10-11 (K2-K3 wide in f32) at a tile of kRows rows a pair (K2's
// instance for D a multiple of 512).
template <int kRows>
int occupancy_of_wide_f32(int kernel, int* out) {
  if (kernel == 10)
    return occupancy(flash_dq_wide_f32_kernel<kRows, true>, kFwdWideThreads, kBwdWideSmem, out);
  return occupancy(flash_dkv_wide_f32_kernel<kRows>, kFwdWideThreads, kBwdWideSmem, out);
}

}  // namespace

namespace swt {
int wide_occupancy(int kernel, int d, int tile, int* out) {
  const bool f32 = kernel >= 9;
  if (kernel < 6 || kernel > 11 || !wide_head_dim(d)) return (int)cudaErrorInvalidValue;
  if (kernel % 3 == 0) {
    if (tile != kFwdWideRows) return (int)cudaErrorInvalidValue;
    return f32 ? occupancy_of_fwd_wide<float>(d, out) : occupancy_of_fwd_wide<bf16>(d, out);
  }
  if (!bwd_wide_tile(tile)) return (int)cudaErrorInvalidValue;
  if (!f32)
    return tile == kFwdWideRows ? occupancy_of_wide_bf16<kFwdWideRows>(kernel, d, out)
                                : occupancy_of_wide_bf16<kFwdWideRows / 2>(kernel, d, out);
  return tile == kFwdWideRows ? occupancy_of_wide_f32<kFwdWideRows>(kernel, out)
                              : occupancy_of_wide_f32<kFwdWideRows / 2>(kernel, out);
}
}  // namespace swt


namespace {

// Whether the step between two (batch, head) pairs of each view fits 32
// bits (Pairs; the rows do by rows_fit).
template <typename... Views>
bool pairs_fit(const Views&... views) {
  return ((views.s.b < (1ll << 31) && views.s.h < (1ll << 31)) && ...);
}

}  // namespace

extern "C" {

// The wide instances of K1-K3 (any multiple of 256 above 256 as d; tile
// 64 for K1, 64 or 32 (two pairs a CTA) for K2 and K3), with the narrow
// entries' arguments (flash_attention.cu).
int swt_flash_fwd_wide(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                       int heads, int tq, int tk, int d, int tile, float scale, int causal,
                       int device, void* stream) {
  if (!fwd_views_ok(2, q, k, v, out, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide_head_dim(d) || tile != kFwdWideRows) return (int)cudaErrorInvalidValue;
  return launch_fwd_wide<bf16>(q, k, v, mask, out, lse, bh, heads, tq, tk, d,
                               scale, causal, static_cast<cudaStream_t>(stream));
}

int swt_flash_dq_wide(View q, View k, View v, View g, const void* lse, const void* delta,
                      const void* mask, View dq, int bh, int heads, int tq, int tk, int d,
                      int tile, float scale, int causal, int device, void* stream) {
  if (!dq_views_ok(2, q, k, v, g, dq, tq, tk) || !pairs_fit(q, k, v, g, dq))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide_head_dim(d) || !bwd_wide_tile(tile)) return (int)cudaErrorInvalidValue;
  const auto launch = tile == kFwdWideRows ? launch_dq_wide_of<kFwdWideRows>
                                           : launch_dq_wide_of<kFwdWideRows / 2>;
  return launch(q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, d,
                scale, causal, static_cast<cudaStream_t>(stream));
}

int swt_flash_dkv_wide(View q, View k, View v, View g, const void* lse, const void* delta,
                       const void* mask, View dk, View dv, int bh, int heads, int tq, int tk,
                       int d, int tile, float scale, int causal, int device, void* stream) {
  if (!dkv_views_ok(2, q, k, v, g, dk, dv, tq, tk) || !pairs_fit(q, k, v, g, dk, dv))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide_head_dim(d) || !bwd_wide_tile(tile)) return (int)cudaErrorInvalidValue;
  const auto launch = tile == kFwdWideRows ? launch_dkv_wide_of<kFwdWideRows>
                                           : launch_dkv_wide_of<kFwdWideRows / 2>;
  return launch(q, k, v, g, lse, delta, mask, dk, dv, bh, heads, tq,
                tk, d, scale, causal, static_cast<cudaStream_t>(stream));
}

int swt_flash_fwd_wide_f32(View q, View k, View v, const void* mask, View out, void* lse, int bh,
                           int heads, int tq, int tk, int d, int tile, float scale, int causal,
                           int device, void* stream) {
  if (!fwd_views_ok(4, q, k, v, out, tq, tk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide_head_dim(d) || tile != kFwdWideRows) return (int)cudaErrorInvalidValue;
  return launch_fwd_wide<float>(q, k, v, mask, out, lse, bh, heads, tq, tk,
                                d, scale, causal, static_cast<cudaStream_t>(stream));
}

int swt_flash_dq_wide_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                          const void* mask, View dq, int bh, int heads, int tq, int tk, int d,
                          int tile, float scale, int causal, int device, void* stream) {
  if (!dq_views_ok(4, q, k, v, g, dq, tq, tk) || !pairs_fit(q, k, v, g, dq))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide_head_dim(d) || !bwd_wide_tile(tile)) return (int)cudaErrorInvalidValue;
  const auto launch = tile == kFwdWideRows ? launch_dq_wide_f32_of<kFwdWideRows>
                                           : launch_dq_wide_f32_of<kFwdWideRows / 2>;
  return launch(q, k, v, g, lse, delta, mask, dq, bh, heads, tq, tk, d,
                scale, causal, static_cast<cudaStream_t>(stream));
}

int swt_flash_dkv_wide_f32(View q, View k, View v, View g, const void* lse, const void* delta,
                           const void* mask, View dk, View dv, int bh, int heads, int tq, int tk,
                           int d, int tile, float scale, int causal, int device, void* stream) {
  if (!dkv_views_ok(4, q, k, v, g, dk, dv, tq, tk) || !pairs_fit(q, k, v, g, dk, dv))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide_head_dim(d) || !bwd_wide_tile(tile)) return (int)cudaErrorInvalidValue;
  const auto launch = tile == kFwdWideRows ? launch_dkv_wide_f32_as<kFwdWideRows>
                                           : launch_dkv_wide_f32_as<kFwdWideRows / 2>;
  return launch(q, k, v, g, lse, delta, mask, dk, dv, bh, heads, tq,
                tk, d, scale, causal, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
