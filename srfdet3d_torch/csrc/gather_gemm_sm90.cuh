// Hopper (sm_90a) bfloat16 gather-GEMM device code, shared by
// gather_conv.cu (K1-bf16, the forward) and gather_conv_bwd.cu (K4-bf16:
// the dfeats gather over the reverse rulebook, and the dW pass, which uses
// the helpers below):
//
//     out[m, :] = sum_j feats[idx[m, j], :] @ W[j]      (idx == N: a miss, zeros)
//
// feats (N, Cin), W (K, Cin, Cout) and out (M, Cout) bf16, idx (M, K) int32
// in [0, N], K <= 32; f32 sums, each output rounded to bf16 once.
//
// What bounds it.  By the bytes it must move (each hit row's channels
// gathered, W read once, the output written) and the bf16 tensor-core rate
// (989 TFLOP/s) the flagship's convs need 2-11 us each: bytes at every
// conv but stage 3, where the products (11 us) lead.  On the card it runs
// 4-15x above that, bound by the latency of its row gathers and by each
// tile's fixed cost (its rulebook slice and barriers), not by the tensor
// cores: bench/probe_gather_gemm.py's no_mma variant is at most 16% faster
// than the kernel at any conv, no_a (no row gathers) 15-50% faster (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md §6).  The earlier bf16 kernel (mma.sync,
// commit 29fd5f7) ran 12x its bound over a predict: 32-channel steps
// behind a block-wide barrier, a 3-deep cp.async ring.  The design:
//   - the product is wgmma.mma_async m64nNk16 (N = the block's Cout tile,
//     16-128, one instruction across it) with both operands read from
//     shared memory through descriptors; one or two consumer warpgroups
//     own 64 output rows each (consumers_of: 64-row tiles at 16 and 128
//     columns, 128-row tiles at 32 and 64), f32 accumulators in registers;
//   - a step is kStepK (64) deep along the reduction: one offset times 64
//     channels at Cin >= 64 (two steps an offset at Cin 128), several
//     offsets that hit the tile side by side at Cin 16-32 (4 x 16, 2 x 32):
//     every row of A is 128 bytes a step, every step four k16 products, the
//     same four in every step (the last step's empty items read zero rows),
//     so that ptxas does not serialize them.  Offsets that miss every row
//     of the tile are skipped.  One offset a step is 1.3-3x slower at Cin
//     16-64 (the probe's step_16 and step_32);
//   - A, the gathered rows: one producer warpgroup loads its rows' indices
//     and then issues 16-byte cp.async copies straight into the
//     128-byte-swizzled K-major layout that A's descriptor names (a missed
//     row or a channel past Cin zero-fills with src-size 0); rows that are
//     not 16-byte aligned (Cin % 8 != 0, the 5 point features of
//     conv_input) are copied by ordinary loads, so the wrapper pads
//     nothing;
//   - B, the weights, read in place from (K, Cin, Cout): TMA boxes of W[j]'s
//     rows (a 3-D tensor map; rows past Cin and columns past Cout
//     zero-filled), MN-major with the swizzle of the tile's width, so
//     bf16 wgmma's transposed-B form reads them as they are.  The dfeats
//     gather reads W (K, Cin, Cout) with Cout as the reduction: K-major B,
//     one box an offset;
//   - a ring of (A, B) stages (stages_of: 4, 2 at 16 columns, where a
//     shallower ring fits more blocks an SM) with full / empty mbarriers:
//     the copies arrive on a stage's full barrier (cp.async.mbarrier.arrive
//     and the TMA's byte count), consumers release it after the wgmma
//     group that read it retires; no block-wide barrier after the tile's
//     rulebook slice is loaded (16-byte copies where it is contiguous);
//   - the tensor core's in-place f32 accumulation over the whole reduction
//     (its truncation drifts ~1e-5 relative over thousands of terms, far
//     below a bf16 ulp), one rounding on the store, through the row map
//     (perm) where the strided backward groups its rows.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kStepK = 64;     // reduction depth of a step (bf16 elements)
constexpr int kProducers = 128;  // one producer warpgroup

// consumer warpgroups of a BN-column tile, 64 output rows each.  Measured
// on the card at the flagship's convs (bench/probe_gather_gemm.py): 64-row
// tiles are faster at 16 and 128 columns (conv_input and stage 0, where
// most rows miss; stages 3 and down2, where 128 rows x 128 columns leave
// one block an SM), 128-row tiles at 32 and 64 (stages 1-2)
__host__ __device__ constexpr int consumers_of(int bn) {
  return bn == 32 || bn == 64 ? 2 : 1;
}

// the ring's depth: 4 stages, 2 at 16 columns (measured: conv_input and
// stage 0, where a shallower ring fits more blocks an SM)
__host__ __device__ constexpr int stages_of(int bn) {
  return bn == 16 ? 2 : 4;
}

using bf16 = __nv_bfloat16;

// ---- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait until the barrier's phase of parity `parity` has completed; a wait
// of 2^36 cycles (~40 s) is a deadlock: trap, which fails the launch with
// an error, rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 36)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// an arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills without a read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one arrival on bar once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// a box of a 3-D tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// generic-proxy writes (cp.async, st.shared) before async-proxy reads
// (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// keep the compiler from moving accumulator accesses across a wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// swizzle mode of rows of `bytes` bytes: 1 = 128 B, 2 = 64 B, 3 = 32 B
__host__ __device__ constexpr int swz_mode(int bytes) {
  return bytes == 128 ? 1 : (bytes == 64 ? 2 : 3);
}

// byte offset of the 16-byte chunk at unswizzled offset `off` in a tile of
// rows of `bytes` bytes (based at a multiple of 1024): the chunk index XOR
// the row's place in the swizzle pattern, as TMA and wgmma lay them out
__device__ __forceinline__ uint32_t swz(uint32_t off, int bytes) {
  const uint32_t mask = bytes == 128 ? 7u : (bytes == 64 ? 3u : 1u);
  return off ^ ((off >> 3) & (mask << 4));
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle mode
__device__ __forceinline__ uint64_t mdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo, int mode) {
  return (uint64_t)((addr >> 4) & 0x3FFFu) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) |
         ((uint64_t)mode << 62);
}

// d (64 x N, f32) += A (64 x 16) B (16 x N), both bf16 from shared memory;
// TA / TB: A / B MN-major (transposed) rather than K-major.  Fragment of
// d: warp w of the warpgroup holds rows 16w..16w+15; d[4i + 2h + c] is row
// lane / 4 + 8h, column 8i + 2 (lane % 4) + c.

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 16)
    wgmma_n16<TA, TB>(d, da, db);
  else if constexpr (N == 32)
    wgmma_n32<TA, TB>(d, da, db);
  else if constexpr (N == 64)
    wgmma_n64<TA, TB>(d, da, db);
  else
    wgmma_n128<TA, TB>(d, da, db);
}

// the 16-byte chunk of a row that is not 16-byte aligned, by ordinary
// loads: channels cc..cc+7 below cin, zeros past it (and all zeros where
// !ok)
__device__ __forceinline__ void st_chunk(uint32_t dst, const bf16* feats,
                                         int row, int cc, int cin, bool ok) {
  const unsigned short* src =
      reinterpret_cast<const unsigned short*>(feats) +
      (long long)row * cin + cc;
  unsigned v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const unsigned lo = ok && cc + 2 * t < cin ? src[2 * t] : 0u;
    const unsigned hi = ok && cc + 2 * t + 1 < cin ? src[2 * t + 1] : 0u;
    v[t] = lo | (hi << 16);
  }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// ---- the gather-GEMM

__host__ __device__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

template <int BN>
struct GatherCfg {
  static constexpr int kConsumers = consumers_of(BN);
  static constexpr int kStages = stages_of(BN);
  static constexpr int BM = 64 * kConsumers;
  static constexpr int kThreads = 128 * kConsumers + kProducers;
  static constexpr int A_BYTES = BM * 128;  // BM rows of 64 bf16
  static constexpr int B_BYTES = (kStepK * BN * 2 + 1023) / 1024 * 1024;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // MN-major B: atoms of AW columns, rows of RB bytes
  static constexpr int AW = BN < 64 ? BN : 64, RB = AW * 2;
};

// shared memory of a gather-GEMM block (bytes): the 1024-byte-aligned
// ring, its barriers, the offset list, the warps' masks, the row map and
// the tile's rulebook slice
template <int BN>
constexpr size_t gather_smem(int k) {
  using C = GatherCfg<BN>;
  return 1024 + (size_t)C::kStages * C::STAGE + 16 * C::kStages + 4 * 32 +
         4 * (C::kThreads / 32) + 4 * C::BM + 4 * (size_t)C::BM * k;
}

// One block: BM output rows x BN output columns.  kBmn: B is W (K, Cin,
// Cout) read MN-major (the forward); else W (K, Cout, Cin) in the
// kernel's terms, i.e. the weights (K, Cin', Cout') of the dfeats gather
// with Cout' the reduction, read K-major.  cw: channels an item (16, 32 or
// 64), items = (offset that hits the tile, cw-channel chunk) pairs, kStepK
// / cw of them a step.  perm: the tile's rows (nullptr: m0 + r).  vec:
// feats rows are 16-byte aligned (Cin % 8 == 0).
template <int BN, bool kBmn>
__global__ void __launch_bounds__(GatherCfg<BN>::kThreads, BN >= 128 ? 1 : 2)
gather_kernel(const bf16* __restrict__ feats, const int* __restrict__ idx,
              const int* __restrict__ perm,
              const __grid_constant__ CUtensorMap wmap,
              bf16* __restrict__ out, int n, int m, int k, int cin,
              int cout, int cw, int vec) {
  using C = GatherCfg<BN>;
  constexpr int BM = C::BM, T = C::kThreads, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(sm);
  const uint32_t full0 = ring + kStages * C::STAGE, empty0 = full0 + 8 * kStages;
  int* jlist = reinterpret_cast<int*>(sm + kStages * C::STAGE + 16 * kStages);
  unsigned* wmask = reinterpret_cast<unsigned*>(jlist + 32);
  int* prow = reinterpret_cast<int*>(wmask + T / 32);
  int* rows = prow + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tile_rows = m - m0 < BM ? m - m0 : BM;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, kProducers + 1);  // copies + the TMA bytes
      mbar_init(empty0 + 8 * s, C::kConsumers);
    }
    mbar_init_fence();
  }
  // the tile's rulebook slice (all of it in flight at once), and the
  // offsets that hit some row of it
  for (int r = tid; r < BM; r += T)
    prow[r] = r < tile_rows ? (perm ? perm[m0 + r] : m0 + r) : 0;
  __syncthreads();
  if (perm == nullptr && aligned16(idx)) {
    // in order: the slice is (tile_rows * k) contiguous ints, BM * k * 4
    // bytes a multiple of 16 (BM is)
    const int* src = idx + (long long)m0 * k;
    const int words = tile_rows * k;
    for (int e = 4 * tid; e < BM * k; e += 4 * T) {
      const int left = words - e;
      cp_async16(smem_u32(rows + e), left > 0 ? src + e : idx,
                 left >= 4 ? 16 : (left > 0 ? 4 * left : 0));
    }
  } else {
    for (int e = tid; e < BM * k; e += T) {
      const int r = e / k;
      const bool ok = r < tile_rows;
      cp_async4(smem_u32(rows + e),
                ok ? idx + (long long)prow[r] * k + (e - r * k) : idx,
                ok ? 4 : 0);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  unsigned mine = 0;
  for (int e = tid; e < BM * k; e += T) {
    const int r = e / k;
    const int row = r < tile_rows ? rows[e] : n;
    rows[e] = row;
    if ((unsigned)row < (unsigned)n) mine |= 1u << (e - r * k);
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if (lane == 0) wmask[warp] = mine;
  __syncthreads();
  unsigned mask = 0;
#pragma unroll
  for (int i = 0; i < T / 32; ++i) mask |= wmask[i];
  if (tid < 32 && ((mask >> tid) & 1u))
    jlist[__popc(mask & ((1u << tid) - 1u))] = tid;
  __syncthreads();
  const int chunks = (cin + cw - 1) / cw;
  const int per_step = kStepK / cw;
  const int items = __popc(mask) * chunks;
  const int steps = (items + per_step - 1) / per_step;
  // the warpgroup's role, warp-uniform to the compiler (as CUTLASS's
  // canonical_warp_group_idx): a branch it cannot prove uniform makes
  // ptxas serialize the wgmma instructions
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (role == C::kConsumers) {
    // producer warpgroup: thread pt copies 16-byte chunk q = pt % 8 of
    // rows pt / 8, + 16, ... of A; thread 0 also issues B's boxes.  Every
    // step holds per_step items, so that every step runs the same wgmma
    // instructions: the last step's items past the list read zero rows of
    // A against the last item's weights
    const int pt = tid - 128 * C::kConsumers, q = pt & 7;
    for (int s = 0; s < steps; ++s) {
      const int st = s % kStages;
      const uint32_t full = full0 + 8 * st;
      const uint32_t As = ring + st * C::STAGE, Bs = As + C::A_BYTES;
      if (s >= kStages) mbar_wait(empty0 + 8 * st, ((s / kStages) - 1) & 1);
      const int it0 = s * per_step;
      {
        const int it = it0 + (q * 8) / cw;
        const bool real = it < items;
        const int jq = (real ? it : items - 1) / chunks;
        const int cc = ((real ? it : items - 1) - jq * chunks) * cw +
                       (q * 8) % cw;
        const int* rj = rows + jlist[jq];
        // the rows' indices first: each copy below is a barrier to the
        // compiler (its memory clobber), so a load between two copies
        // would wait for the first to issue
        constexpr int R = BM / (kProducers / 8);
        int row[R];
#pragma unroll
        for (int t = 0; t < R; ++t) row[t] = rj[((pt >> 3) + 16 * t) * k];
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int r = (pt >> 3) + 16 * t;
          const bool ok =
              real && (unsigned)row[t] < (unsigned)n && cc < cin;
          const uint32_t dst = As + swz(r * 128 + q * 16, 128);
          if (vec)
            cp_async16(dst, ok ? feats + (long long)row[t] * cin + cc : feats,
                       ok ? 16 : 0);
          else
            st_chunk(dst, feats, row[t], cc, cin, ok);
        }
      }
      if (vec) {
        cp_async_arrive(full);
      } else {
        fence_async_smem();
        mbar_arrive(full);
      }
      if (pt == 0) {
        mbar_expect_tx(full, (uint32_t)(per_step * cw * BN * 2));
        for (int i = 0; i < per_step; ++i) {
          const int it = it0 + i < items ? it0 + i : items - 1;
          const int jq = it / chunks;
          const int j = jlist[jq], c = (it - jq * chunks) * cw;
          if constexpr (kBmn) {
#pragma unroll
            for (int a = 0; a < BN / C::AW; ++a)
              tma_load_3d(Bs + a * kStepK * C::RB + i * cw * C::RB, &wmap,
                          full, n0 + a * C::AW, c, j);
          } else {
            tma_load_3d(Bs + i * BN * cw * 2, &wmap, full, c, n0, j);
          }
        }
      }
    }
    if (vec) cp_async_wait_all();
  } else {
    // consumer warpgroup wg: output rows 64 wg .. 64 wg + 63 of the tile
    const int wg = role;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int st = s % kStages;
      mbar_wait(full0 + 8 * st, (s / kStages) & 1);
      fence_async_smem();
      const uint32_t As = ring + st * C::STAGE + wg * 64 * 128;
      const uint32_t Bs = ring + st * C::STAGE + C::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStepK / 16; ++kk) {
        const uint64_t da = mdesc(As + kk * 32, 16, 1024, 1);
        uint64_t db;
        if constexpr (kBmn) {
          db = mdesc(Bs + kk * 16 * C::RB, kStepK * C::RB, 8 * C::RB,
                     swz_mode(C::RB));
        } else {
          const int i = kk * 16 / cw, ko = kk * 16 - i * cw;
          db = mdesc(Bs + i * BN * cw * 2 + ko * 2, 16, 16 * cw,
                     swz_mode(2 * cw));
        }
        wgmma<BN, 0, kBmn ? 1 : 0>(acc, da, db);  // MMA
      }
      wgmma_commit();
      wgmma_wait<1>();
      // the group before this one has read its stage: release it
      if (s > 0 && (tid & 127) == 0)
        mbar_arrive(empty0 + 8 * ((s - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // one rounding to bf16 a sum, through the row map
    const int wl = warp & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + wl * 16 + (lane >> 2) + 8 * h;
      if (r >= tile_rows) continue;
      bf16* orow = out + (long long)prow[r] * cout;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = n0 + 8 * i + 2 * (lane & 3);
        const float x = acc[4 * i + 2 * h], y = acc[4 * i + 2 * h + 1];
        if (!(cout & 1)) {
          if (c < cout)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(x, y);
        } else {
          if (c < cout) orow[c] = __float2bfloat16_rn(x);
          if (c + 1 < cout) orow[c + 1] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

// ---- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime (no -lcuda),
// looked up once a library (static: an inline function's static would be
// one symbol shared by every library of the process that has it)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// W (K, rows, cols) bf16 as a 3-D tensor map with boxes of box_cols x
// box_rows x 1, each box row (box_cols * 2 bytes: 32, 64 or 128) swizzled
// by its width; reads past rows or cols fill zeros.  cols % 8 == 0 and W
// 16-byte aligned.
inline cudaError_t weight_map(CUtensorMap* map, const bf16* w, int k,
                              int rows, int cols, int box_cols,
                              int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (cols % 8 != 0 || !aligned16(w)) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)k};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : (box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(w),
          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// channels an item: Cin's power of two, 16 to the step depth
inline int item_channels(int cin) {
  int cw = 16;
  while (cw < cin && cw < kStepK) cw *= 2;
  return cw;
}

template <int BN, bool kBmn>
cudaError_t launch_gather_cfg(const bf16* feats, const int* idx,
                              const int* perm, const bf16* w, bf16* out,
                              int n, int m, int k, int cin, int cout,
                              cudaStream_t s) {
  using C = GatherCfg<BN>;
  const int cw = item_channels(cin);
  CUtensorMap map;
  cudaError_t err = kBmn ? weight_map(&map, w, k, cin, cout, C::AW, cw)
                         : weight_map(&map, w, k, cout, cin, cw, BN);
  if (err != cudaSuccess) return err;
  const size_t smem = gather_smem<BN>(k);
  auto fn = gather_kernel<BN, kBmn>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = cin % 8 == 0 && aligned16(feats);
  dim3 grid((unsigned)((m + C::BM - 1) / C::BM), (unsigned)((cout + BN - 1) / BN));
  fn<<<grid, C::kThreads, smem, s>>>(feats, idx, perm, map, out, n, m, k,
                                     cin, cout, cw, vec);
  return cudaGetLastError();
}

// The bf16 gather-GEMM.  kBmn: W is (K, Cin, Cout) (the forward: out (M,
// Cout)); else W is (K, Cout, Cin) (the dfeats gather over g (M', Cin):
// the conv's weights as they are, its Cout the reduction).  The weights'
// row width (Cout with kBmn, else Cin) must be a multiple of 8.  perm: the
// tile rows' places (the strided backward's grouping; nullptr: in order),
// for the rulebook rows read and the output rows written.  The block's
// column tile is the output width's power of two, 16 to 128.
template <bool kBmn>
cudaError_t launch_gather(const bf16* feats, const int* idx, const int* perm,
                          const bf16* w, bf16* out, int n, long long m,
                          int k, int cin, int cout, cudaStream_t s) {
  if (k < 1 || k > 32 || cin < 1 || cout < 0 || n < 0 || m < 0 ||
      m > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (m == 0 || cout == 0) return cudaSuccess;
  const int mm = (int)m;
  if (cout <= 16)
    return launch_gather_cfg<16, kBmn>(feats, idx, perm, w, out, n, mm, k,
                                       cin, cout, s);
  if (cout <= 32)
    return launch_gather_cfg<32, kBmn>(feats, idx, perm, w, out, n, mm, k,
                                       cin, cout, s);
  if (cout <= 64)
    return launch_gather_cfg<64, kBmn>(feats, idx, perm, w, out, n, mm, k,
                                       cin, cout, s);
  return launch_gather_cfg<128, kBmn>(feats, idx, perm, w, out, n, mm, k,
                                      cin, cout, s);
}

}  // namespace sm90
