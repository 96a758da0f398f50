// Sparse-conv gather-GEMM backward, float32 through 3xTF32 tensor cores,
// CUDA C++ for sm_90a.
//
// Replaces two TPU kernels of srfdet3d_tpu/ops/pallas_onehot_bwd.py:
// gather_matmul_onehot_symbwd (kernel body _symbwd_kernel; the subm
// backward) and gather_matmul_onehot_bwd (_bwd_kernel; the strided and
// conv_out backward).  Both become one gather over a rulebook rb (N, K)
// that maps each input row r to the output rows that read it:
//
//     dfeats[r]  = sum_j g[rb[r, j]] @ W[jo]^T             (rb == M: a miss)
//     dW[jo]     = sum_r feats[r]^T (x) g[rb[r, j]]
//
// with jo = K-1-j (flip: a subm rulebook is its own reverse, offset K-1-j
// being the negation of offset j) or jo = j (the reverse rulebook of a
// strided conv, rev[r, j] = the unique m with idx[m, j] == r).  feats
// (N, Cin), g (M, Cout), W (K, Cin, Cout), all f32.  No scatter and no
// atomics: every output element is written by one thread, in a fixed order.
//
// What bounds it: each half does 2 * nnz * Cin * Cout flops (nnz = rulebook
// entries that hit) against about (N*K + N*Cin + M*Cout + K*Cin*Cout)*4
// bytes.  At stages 2-3 (Cin = Cout = 64, 128; 13-22 hits a row) that is
// 400-800 flops a byte, so the tensor cores' 3xTF32 rate (495 TFLOP/s TF32
// / 3 products = 165 TFLOP/s) bounds it; at stages 0-1 (16, 32 channels,
// 1-5 hits a row) the row gathers' bytes and their latency do.  The design:
//   - dfeats is the forward's gather-GEMM (gather_gemm.cuh: 3xTF32
//     mma.sync, a 3-stage cp.async ring of row gathers, whole-tile offset
//     skips) over g, with the (flipped) transposed weights, which the
//     wrapper lays out as (K, Cout, Cin).  Its own entry point.
//   - dW: a grid over (row chunk, offset j, Cin x Cout tile).  A block first
//     compacts the chunk's rows that hit offset j, in row order (a ballot
//     prefix sum), so a row that misses costs no MMA: at stage 1, where an
//     offset hits ~1 row in 5, the work follows the hits, not the rows.
//     Then the same 3xTF32 MMA runs with the hit rows as the reduction
//     dimension: A = the feature rows' Cin tile (stored row-major, read
//     transposed), B = the gathered g rows' Cout tile, both staged 32 hit
//     rows at a time through a 3-stage cp.async ring (zero-filled past the
//     last hit).  Each block writes its tile to part[chunk]; a second pass
//     adds the partials in chunk order.  Deterministic, no atomics.
//   - the strided backward's preparation runs on the card, with no host
//     sync: a kernel writes the reverse rulebook (one thread per (m, j)),
//     and a stable counting sort groups the input rows by their lowest hit
//     offset.  An input row of a 3x3x3 stride-2 conv hits only the offsets
//     its coordinate parities allow (8 classes; 27/8 hits a row on
//     average); in voxel order a 128-row tile mixes every class and runs
//     all 27 offsets, grouped it runs about its class's offsets only.  The
//     dfeats gather-GEMM reads its rows through the permutation and writes
//     each row back to its own place (gather_gemm::launch<true>).  dW keeps
//     the voxel order: it compacts each offset's hit rows already.
// The TPU kernels' windows, one-hot matmuls and read-modify-write window
// accumulation exist because Mosaic has no dynamic gather or scatter; here
// rows load by index and the reverse rulebook turns the scatter into a
// gather.
//
// bfloat16 (the bf16 model, K4 only; JAX pallas_onehot_bwd.py:95-129,
// :187, :196, :234-246): K4-bf16 takes bf16 feats, g and W, sums in f32 and
// rounds each dfeats and dW element to bf16 once.  (The subm backward, K3,
// has no bf16 variant: as on the TPU, pallas_onehot_bwd.py:428, its
// wrapper upcasts to f32, runs the f32 kernel and casts the results back.)
//   - dfeats is gather_gemm_sm90.cuh's wgmma gather-GEMM over the grouped
//     reverse rulebook, through the row map, with W (K, Cin, Cout) read as
//     it is as a K-major B (Cout is the reduction).
//   - dW (dw_wgmma_kernel): the f32 pass's compaction of each (row chunk,
//     offset)'s hit rows and its partials (f32, no atomics), with wgmma
//     m64nNk16 for the product: the hit rows are the reduction, and both
//     operands are staged as they are loaded, MN-major (A: the feature
//     rows' Cin tile, one 64-channel atom a consumer warpgroup; B: the
//     gathered g rows' Cout tile), 64 hit rows a stage through a 4-deep
//     ring of cp.async copies with full / empty mbarriers (one producer
//     warpgroup); the partials are summed in a fixed order by 8 threads an
//     element (dw_reduce_bf16_kernel).
//   What bounds dW at the flagship's strided convs is not the product
//   (bench/probe_gather_gemm.py's no_mma variant is within 4% of it) but
//   its compaction scan and partials (scan_only, which keeps both, takes
//   60-80% of the pass): a block per (chunk, offset) read a 32-byte
//   sector of the strided reverse-rulebook column for each 4-byte entry.
//   So a block scans 4 neighbouring offsets at once (K >= 8), one sector
//   serving them all, and sums them one after another through its ring
//   (one offset a block: +51% at down0, +12% at down2); the wrapper
//   doubles the chunk where the partials' bytes (chunks x K x Cin x Cout
//   floats, written and read back) lead (PERF.md §6).
// The TPU kernel rounds each offset's product (`ystack`) to bf16 before its
// one-hot scatter (pallas_onehot_bwd.py:98); the JAX package's XLA path on
// the CPU keeps them f32, and so does this gather, which has no such step:
// it computes the XLA path's numbers.  Measured on the CPU
// (tests/test_torch_port_bf16_kernels.py, N 400, Cin 16, Cout 32, K 27):
// the TPU kernel in interpret mode differs from the XLA path by up to
// 2.4e-3 of the largest |dfeats| (dW 2.5e-3); the plain version, which
// this kernel is held to on the card, within one bf16 ulp.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; each entry returns the launch's CUDA error code.

#include "gather_gemm.cuh"
#include "gather_gemm_sm90.cuh"

namespace {

constexpr int kMaxChunk = 4096;  // rows a dW block compacts
constexpr int kDwStages = 3;
constexpr int kDwBK = 32;        // hit rows a stage
constexpr int kScan = 4;         // rulebook rows a thread reads a round

constexpr int tile_of(int c) {
  return c <= 16 ? 16 : (c <= 32 ? 32 : (c <= 64 ? 64 : 128));
}

// A dW tile of TM x TN over WM x WN warps of 32 x 32 accumulators (16
// warps at 128 x 128); at least 4 warps, so that small tiles still compact
// and load with 128 threads.
template <int TM, int TN>
struct DwCfg {
  static constexpr int WM = TM >= 32 ? TM / 32 : 1;
  static constexpr int WN = TN >= 32 ? TN / 32 : 1;
  static constexpr int kThreads = WM * WN * 32 < 128 ? 128 : WM * WN * 32;
  static constexpr int MT = TM / WM / 16, NT = TN / WN / 8;
  static constexpr int LDA = TM + 8, LDB = TN + 8;
  static constexpr int A_FLOATS = kDwBK * LDA, B_FLOATS = kDwBK * LDB;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static_assert(MT >= 1 && NT >= 1 && TM % (16 * WM) == 0 &&
                    TN % (8 * WN) == 0,
                "tile shape");
};

// Partial dW tile of one (row chunk, offset j, TM x TN tile): the sum over
// the chunk's rows r that hit offset j of feats[r, ci] * g[rb[r, j], co].
// Warps past WM x WN (small tiles) only compact and load.
template <int TM, int TN>
__global__ void __launch_bounds__(DwCfg<TM, TN>::kThreads)
dw_partial_kernel(const float* __restrict__ feats, const int* __restrict__ rb,
                  const float* __restrict__ g, float* __restrict__ part,
                  long long nrows, int mg, int k, int cin, int cout,
                  int chunk, int flip, int vec_a, int vec_b) {
  using C = DwCfg<TM, TN>;
  constexpr int WM = C::WM, WN = C::WN, T = C::kThreads;
  constexpr int MT = C::MT, NT = C::NT, LDA = C::LDA, LDB = C::LDB;
  constexpr int A_FLOATS = C::A_FLOATS, STAGE = C::STAGE;
  extern __shared__ __align__(16) float smem[];
  int* hit_r = reinterpret_cast<int*>(smem + kDwStages * STAGE);
  int* hit_g = hit_r + chunk;
  __shared__ int counts[kScan][T / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.y;
  const int tiles_co = (cout + TN - 1) / TN;
  const int ci0 = (blockIdx.z / tiles_co) * TM;
  const int co0 = (blockIdx.z % tiles_co) * TN;
  const long long r_begin = (long long)blockIdx.x * chunk;
  const long long r_end =
      r_begin + chunk < nrows ? r_begin + chunk : nrows;

  // compact the rows of the chunk that hit offset j, in row order
  int hits = 0;
  for (long long base = r_begin; base < r_end; base += kScan * T) {
    int gr[kScan];
#pragma unroll
    for (int i = 0; i < kScan; ++i) {
      const long long r = base + i * T + tid;
      gr[i] = r < r_end ? rb[r * k + j] : mg;
    }
    unsigned ballot[kScan];
#pragma unroll
    for (int i = 0; i < kScan; ++i) {
      const bool hit = (unsigned)gr[i] < (unsigned)mg;
      ballot[i] = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) counts[i][warp] = __popc(ballot[i]);
    }
    __syncthreads();
    int pos = hits;
#pragma unroll
    for (int i = 0; i < kScan; ++i) {
      int before = pos;
      for (int w = 0; w < T / 32; ++w) {
        const int c = counts[i][w];
        if (w < warp) before += c;
        pos += c;
      }
      if ((unsigned)gr[i] < (unsigned)mg) {
        const int at = before + __popc(ballot[i] & ((1u << lane) - 1u));
        hit_r[at] = (int)(base + i * T + tid - r_begin);
        hit_g[at] = gr[i];
      }
    }
    hits = pos;
    __syncthreads();  // counts are reused; the lists are complete
  }
  const int steps = (hits + kDwBK - 1) / kDwBK;
  const float* fchunk = feats + r_begin * cin;

  auto load = [&](int s, int buf) {
    const int h0 = s * kDwBK;
    float* As = smem + buf * STAGE;
    float* Bs = As + A_FLOATS;
    if (vec_a) {
      for (int e = tid; e < kDwBK * (TM / 4); e += T) {
        const int kr = e / (TM / 4), c = (e % (TM / 4)) * 4;
        const int h = h0 + kr, cc = ci0 + c;
        const bool ok = h < hits && cc < cin;
        tc::cp_async16(As + kr * LDA + c,
                       ok ? fchunk + (long long)hit_r[h] * cin + cc : feats,
                       ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kDwBK * TM; e += T) {
        const int kr = e / TM, c = e % TM;
        const int h = h0 + kr, cc = ci0 + c;
        const bool ok = h < hits && cc < cin;
        tc::cp_async4(As + kr * LDA + c,
                      ok ? fchunk + (long long)hit_r[h] * cin + cc : feats,
                      ok ? 4 : 0);
      }
    }
    if (vec_b) {
      for (int e = tid; e < kDwBK * (TN / 4); e += T) {
        const int kr = e / (TN / 4), c = (e % (TN / 4)) * 4;
        const int h = h0 + kr, cc = co0 + c;
        const bool ok = h < hits && cc < cout;
        tc::cp_async16(Bs + kr * LDB + c,
                       ok ? g + (long long)hit_g[h] * cout + cc : g,
                       ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kDwBK * TN; e += T) {
        const int kr = e / TN, c = e % TN;
        const int h = h0 + kr, cc = co0 + c;
        const bool ok = h < hits && cc < cout;
        tc::cp_async4(Bs + kr * LDB + c,
                      ok ? g + (long long)hit_g[h] * cout + cc : g,
                      ok ? 4 : 0);
      }
    }
  };

  float acc[MT][NT][4] = {};
  const bool computes = warp < WM * WN;
  const int wm0 = (warp % WM) * (TM / WM), wn0 = (warp / WM) * (TN / WN);
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < steps) load(s, s);
    tc::cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_wait<kDwStages - 2>();
    __syncthreads();  // step s landed for every thread; step s-1 is done
    const int next = s + kDwStages - 1;
    if (next < steps) load(next, next % kDwStages);
    tc::cp_commit();
    if (computes) {
      const float* As = smem + (s % kDwStages) * STAGE;
      tc::mma_stage<MT, NT, kDwBK, LDA, LDB, true>(As, As + A_FLOATS, acc,
                                                   wm0, wn0, lane);
    }
  }
  tc::cp_wait<0>();

  if (computes) {
    const int jo = flip ? k - 1 - j : j;
    float* dst = part + ((long long)blockIdx.x * k + jo) * cin * cout;
    tc::store_tile(acc, dst, cin, cout, cout, ci0 + wm0, co0 + wn0, lane);
  }
}

__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dw, int chunks,
                                 long long per) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per) return;
  float v = 0.f;
  for (int c = 0; c < chunks; ++c) v += part[(long long)c * per + e];
  dw[e] = v;
}

// ---- the bf16 dW pass (wgmma)

// dW (bf16) = the partials summed in a fixed order, rounded once: thread
// (x, y) of a 32 x 8 block sums chunks y, y + 8, ... of element 32
// blockIdx.x + x in order, and the 8 sums are added in y order (no
// atomics: the same bits every run).  dw_reduce_kernel's one thread an
// element in chunk order leaves most SMs idle at Cin x Cout of 16 x 32
// and hundreds of chunks.
__global__ void __launch_bounds__(256)
dw_reduce_bf16_kernel(const float* __restrict__ part,
                      __nv_bfloat16* __restrict__ dw, int chunks,
                      long long per) {
  __shared__ float sums[8][33];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const long long e = (long long)blockIdx.x * 32 + x;
  float v = 0.f;
  if (e < per)
    for (int c = y; c < chunks; c += 8) v += part[(long long)c * per + e];
  sums[y][x] = v;
  __syncthreads();
  if (y == 0 && e < per) {
    float t = sums[0][x];
#pragma unroll
    for (int i = 1; i < 8; ++i) t += sums[i][x];
    dw[e] = __float2bfloat16_rn(t);
  }
}

constexpr int kDwWgStages = 4;  // ring depth
constexpr int kDwHits = 64;     // hit rows a stage: four k16 products
constexpr int kDwOffsets = 4;   // offsets a block sums, one after another
// (K >= 8; below, one offset a block: measured at conv_out, K 3, where
// one block for all offsets leaves the card idle)
__host__ __device__ constexpr int dw_offsets(int k) {
  return k >= 8 ? kDwOffsets : 1;
}

// A bf16 dW tile: TM = 64 kWG rows of dW (Cin; a consumer warpgroup each
// 64) x TN columns (Cout); a stage holds kDwHits hit rows of each operand,
// MN-major: A one 128-byte swizzled atom of 64 channels a warpgroup, B
// atoms of AW columns in rows of RB bytes
template <int TN, int kWG>
struct DwWgCfg {
  static constexpr int TM = 64 * kWG;
  static constexpr int kThreads = 128 * kWG + sm90::kProducers;
  static constexpr int AW = TN < 64 ? TN : 64, RB = AW * 2;
  static constexpr int A_BYTES = kWG * kDwHits * 128;
  static constexpr int B_BYTES = (kDwHits * TN * 2 + 1023) / 1024 * 1024;
  static constexpr int STAGE = A_BYTES + B_BYTES;
};

// shared memory: the ring, its barriers, the scan's warp counts, the hit
// counts and the hit lists of kDwOffsets offsets
template <int TN, int kWG>
constexpr size_t dw_wgmma_smem(int chunk) {
  using C = DwWgCfg<TN, kWG>;
  return 1024 + (size_t)kDwWgStages * C::STAGE + 16 * kDwWgStages +
         4 * kScan * kDwOffsets * (C::kThreads / 32) + 4 * kDwOffsets +
         8 * (size_t)kDwOffsets * chunk;
}

// Partial dW tiles of one (row chunk, kDwOffsets offsets j0.., TM x TN
// tile), bf16 tables, f32 sums.  The block first compacts, for each of its
// offsets, the chunk's rows that hit it, in row order (a ballot prefix sum
// as in dw_partial_kernel; each row's kDwOffsets neighbouring rulebook
// entries are read together, so a 32-byte sector of the strided column
// serves them all, where one offset a block read a sector an entry).  Then
// a producer warpgroup gathers 64 hit rows a stage, offset after offset
// through one ring, and each consumer warpgroup runs wgmma on its 64
// channels, storing an offset's partial tile before the next offset's
// first product.  Rows of dW past Cin and columns past Cout are not loaded
// (their sums are not stored); hit rows past an offset's last zero-fill.
template <int TN, int kWG>
__global__ void __launch_bounds__(DwWgCfg<TN, kWG>::kThreads)
dw_wgmma_kernel(const sm90::bf16* __restrict__ feats,
                const int* __restrict__ rb,
                const sm90::bf16* __restrict__ g, float* __restrict__ part,
                long long nrows, int mg, int k, int cin, int cout,
                int chunk, int flip) {
  using namespace sm90;
  using C = DwWgCfg<TN, kWG>;
  constexpr int T = C::kThreads, W = T / 32, J = kDwOffsets;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(sm);
  const uint32_t full0 = ring + kDwWgStages * C::STAGE;
  const uint32_t empty0 = full0 + 8 * kDwWgStages;
  int* counts = reinterpret_cast<int*>(sm + kDwWgStages * C::STAGE +
                                       16 * kDwWgStages);  // [kScan][J][W]
  int* nhit = counts + kScan * J * W;
  int* hit_r = nhit + J;                                  // [J][chunk]
  int* hit_g = hit_r + J * chunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = dw_offsets(k);
  const int j0 = blockIdx.y * per;
  const int nj = k - j0 < per ? k - j0 : per;
  const int tiles_co = (cout + TN - 1) / TN;
  const int ci0 = (blockIdx.z / tiles_co) * C::TM;
  const int co0 = (blockIdx.z % tiles_co) * TN;
  const long long r_begin = (long long)blockIdx.x * chunk;
  const long long r_end =
      r_begin + chunk < nrows ? r_begin + chunk : nrows;

  if (tid == 0) {
    for (int s = 0; s < kDwWgStages; ++s) {
      mbar_init(full0 + 8 * s, kProducers);
      mbar_init(empty0 + 8 * s, kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // compact the rows of the chunk that hit each offset, in row order
  int hits[J] = {};
  for (long long base = r_begin; base < r_end; base += kScan * T) {
    int gr[kScan][J];
#pragma unroll
    for (int i = 0; i < kScan; ++i) {
      const long long r = base + i * T + tid;
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        gr[i][jj] = r < r_end && jj < nj ? rb[r * k + j0 + jj] : mg;
    }
    unsigned ballot[kScan][J];
#pragma unroll
    for (int i = 0; i < kScan; ++i)
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        ballot[i][jj] =
            __ballot_sync(0xffffffffu, (unsigned)gr[i][jj] < (unsigned)mg);
        if (lane == 0) counts[(i * J + jj) * W + warp] = __popc(ballot[i][jj]);
      }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      int pos = hits[jj];
#pragma unroll
      for (int i = 0; i < kScan; ++i) {
        int before = pos;
        for (int w = 0; w < W; ++w) {
          const int c = counts[(i * J + jj) * W + w];
          if (w < warp) before += c;
          pos += c;
        }
        if ((unsigned)gr[i][jj] < (unsigned)mg) {
          const int at =
              before + __popc(ballot[i][jj] & ((1u << lane) - 1u));
          hit_r[jj * chunk + at] = (int)(base + i * T + tid - r_begin);
          hit_g[jj * chunk + at] = gr[i][jj];
        }
      }
      hits[jj] = pos;
    }
    __syncthreads();  // counts are reused; the lists are complete
  }
  if (tid == 0)
#pragma unroll
    for (int jj = 0; jj < J; ++jj) nhit[jj] = hits[jj];
  __syncthreads();
  const bf16* fchunk = feats + r_begin * cin;
  // the warpgroup's role, warp-uniform to the compiler (see gather_kernel)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (role == kWG) {
    // producer warpgroup: 16-byte copies of the stage's hit rows; thread
    // pt copies chunk pt % QA of A's hit rows pt / QA + (128 / QA) t and
    // chunk pt % QB of B's, their row indices loaded first (each copy is a
    // barrier to the compiler)
    const int pt = tid - 128 * kWG;
    constexpr int QA = C::TM / 8, QB = TN / 8, QR = C::AW / 8;
    constexpr int NA = kDwHits * QA / kProducers;
    constexpr int NB = kDwHits * QB / kProducers;
    const int qa = pt % QA, qb = pt % QB;
    const int ci = ci0 + qa * 8, co = co0 + qb * 8;
    int gs = 0;  // the ring's step, over all the block's offsets
    for (int jj = 0; jj < nj; ++jj) {
      const int nh = nhit[jj];
      const int* lr = hit_r + jj * chunk;
      const int* lg = hit_g + jj * chunk;
      for (int h0 = 0; h0 < nh; h0 += kDwHits, ++gs) {
        const int st = gs % kDwWgStages;
        const uint32_t full = full0 + 8 * st;
        const uint32_t As = ring + st * C::STAGE, Bs = As + C::A_BYTES;
        if (gs >= kDwWgStages)
          mbar_wait(empty0 + 8 * st, ((gs / kDwWgStages) - 1) & 1);
        int ra[NA], rg[NB];
#pragma unroll
        for (int t = 0; t < NA; ++t) {
          const int h = h0 + (pt + kProducers * t) / QA;
          ra[t] = h < nh ? lr[h] : -1;
        }
#pragma unroll
        for (int t = 0; t < NB; ++t) {
          const int h = h0 + (pt + kProducers * t) / QB;
          rg[t] = h < nh ? lg[h] : -1;
        }
        if (ci < cin) {
#pragma unroll
          for (int t = 0; t < NA; ++t) {
            const int hr = (pt + kProducers * t) / QA;
            cp_async16(As + (qa >> 3) * (kDwHits * 128) +
                           swz(hr * 128 + (qa & 7) * 16, 128),
                       ra[t] >= 0 ? fchunk + (long long)ra[t] * cin + ci
                                  : feats,
                       ra[t] >= 0 ? 16 : 0);
          }
        }
        if (co < cout) {
#pragma unroll
          for (int t = 0; t < NB; ++t) {
            const int hr = (pt + kProducers * t) / QB;
            cp_async16(Bs + (qb / QR) * (kDwHits * C::RB) +
                           swz(hr * C::RB + (qb % QR) * 16, C::RB),
                       rg[t] >= 0 ? g + (long long)rg[t] * cout + co : g,
                       rg[t] >= 0 ? 16 : 0);
          }
        }
        cp_async_arrive(full);
      }
    }
    cp_async_wait_all();
  } else {
    // consumer warpgroup wg: dW rows ci0 + 64 wg .. + 63 of each offset
    const int wg = role, wl = warp & 3;
    int gs = 0;
    for (int jj = 0; jj < nj; ++jj) {
      float acc[TN / 2];
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
      const int nh = nhit[jj];
      for (int h0 = 0; h0 < nh; h0 += kDwHits, ++gs) {
        const int st = gs % kDwWgStages;
        mbar_wait(full0 + 8 * st, (gs / kDwWgStages) & 1);
        fence_async_smem();
        const uint32_t As = ring + st * C::STAGE + wg * kDwHits * 128;
        const uint32_t Bs = ring + st * C::STAGE + C::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDwHits / 16; ++kk) {
          const uint64_t da =
              mdesc(As + kk * 16 * 128, kDwHits * 128, 1024, 1);
          const uint64_t db = mdesc(Bs + kk * 16 * C::RB, kDwHits * C::RB,
                                    8 * C::RB, swz_mode(C::RB));
          wgmma<TN, 1, 1>(acc, da, db);  // MMA
        }
        wgmma_commit();
        wgmma_wait<1>();
        // the group before this one has read its stage: release it
        if (gs > 0 && (tid & 127) == 0)
          mbar_arrive(empty0 + 8 * ((gs - 1) % kDwWgStages));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      const int j = j0 + jj, jo = flip ? k - 1 - j : j;
      float* dst = part + ((long long)blockIdx.x * k + jo) * cin * cout;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + wg * 64 + wl * 16 + (lane >> 2) + 8 * h;
        if (ci >= cin) continue;
#pragma unroll
        for (int i = 0; i < TN / 8; ++i) {
          const int co = co0 + 8 * i + 2 * (lane & 3);
          if (co < cout)
            *reinterpret_cast<float2*>(dst + (long long)ci * cout + co) =
                make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      }
    }
  }
}

// ---- the strided backward's preparation: reverse rulebook, row grouping

constexpr int kGroupRows = 1024;    // input rows a grouping block orders
constexpr int kGroupThreads = 256;
constexpr int kMaxKeys = 33;        // lowest hit offset 0..31, or K: none

__global__ void strided_prep_fill(int* __restrict__ rev, long long total,
                                  int value) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x)
    rev[e] = value;
}

// rev[idx[m, j], j] = m where idx[m, j] < n; each (r, j) is hit at most
// once (a fixed offset maps an input cell to at most one output cell)
__global__ void strided_prep_reverse(const int* __restrict__ idx,
                                     int* __restrict__ rev, long long m,
                                     int n, int k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m * k) return;
  const int r = idx[e];
  if ((unsigned)r < (unsigned)n) {
    const long long mm = e / k;
    rev[(long long)r * k + (e - mm * k)] = (int)mm;
  }
}

// key[r] = the lowest offset j with rev[r, j] < mg, or K; hist[key][block]
// = the rows of the block with that key (key-major, for the scan)
__global__ void __launch_bounds__(kGroupThreads)
strided_prep_hist(const int* __restrict__ rev, unsigned char* __restrict__ key,
                  int* __restrict__ hist, long long n, int mg, int k,
                  int blocks) {
  __shared__ int cnt[kMaxKeys];
  for (int i = threadIdx.x; i <= k; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * kGroupRows;
  for (int i = threadIdx.x; i < kGroupRows && r0 + i < n; i += blockDim.x) {
    const int* row = rev + (r0 + i) * k;
    unsigned mask = 0;
    for (int j = 0; j < k; ++j)
      if ((unsigned)row[j] < (unsigned)mg) mask |= 1u << j;
    const int kk = mask ? __ffs(mask) - 1 : k;
    key[r0 + i] = (unsigned char)kk;
    atomicAdd(&cnt[kk], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= k; i += blockDim.x)
    hist[(long long)i * blocks + blockIdx.x] = cnt[i];
}

// exclusive prefix sum of hist (total entries) in place, one block of 1024
__global__ void __launch_bounds__(1024)
strided_prep_scan(int* __restrict__ hist, int total) {
  __shared__ int part[1024];
  const int t = threadIdx.x;
  const int per = (total + 1023) / 1024;
  const int b = t * per < total ? t * per : total;
  const int e = b + per < total ? b + per : total;
  int sum = 0;
  for (int i = b; i < e; ++i) sum += hist[i];
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = t ? part[t - 1] : 0;
  for (int i = b; i < e; ++i) {
    const int v = hist[i];
    hist[i] = run;
    run += v;
  }
}

// perm[offs[key][block] + rank] = r, rank = the rows before r in the block
// with r's key: a stable counting sort (rows go in block, warp, lane order)
__global__ void __launch_bounds__(kGroupThreads)
strided_prep_scatter(const unsigned char* __restrict__ key,
                     const int* __restrict__ offs, int* __restrict__ perm,
                     long long n, int k, int blocks) {
  constexpr int W = kGroupThreads / 32;
  __shared__ int base[kMaxKeys];
  __shared__ int wcnt[W][kMaxKeys];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i <= k; i += blockDim.x)
    base[i] = offs[(long long)i * blocks + blockIdx.x];
  const long long r0 = (long long)blockIdx.x * kGroupRows;
  for (int round = 0; round < kGroupRows && r0 + round < n;
       round += kGroupThreads) {
    for (int i = t; i < W * kMaxKeys; i += blockDim.x)
      wcnt[i / kMaxKeys][i % kMaxKeys] = 0;
    __syncthreads();
    const long long r = r0 + round + t;
    const bool live = r < n;
    const int kk = live ? key[r] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, kk);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (live && lane == __ffs(peers) - 1) wcnt[warp][kk] = __popc(peers);
    __syncthreads();
    if (live) {
      int at = base[kk] + rank;
      for (int w = 0; w < warp; ++w) at += wcnt[w][kk];
      perm[at] = (int)r;
    }
    __syncthreads();
    if (t <= k) {
      int add = 0;
      for (int w = 0; w < W; ++w) add += wcnt[w][t];
      base[t] += add;
    }
    __syncthreads();
  }
}

template <int TM, int TN>
cudaError_t launch_dw(const float* feats, const int* rb, const float* g,
                      float* part, long long nrows, int mg, int k, int cin,
                      int cout, int chunk, int flip, int chunks,
                      cudaStream_t s) {
  using C = DwCfg<TM, TN>;
  const size_t smem =
      sizeof(float) * kDwStages * C::STAGE + sizeof(int) * 2 * chunk;
  auto fn = dw_partial_kernel<TM, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec_a = cin % 4 == 0 && tc::aligned16(feats);
  const int vec_b = cout % 4 == 0 && tc::aligned16(g);
  const int tiles = ((cin + TM - 1) / TM) * ((cout + TN - 1) / TN);
  dim3 grid((unsigned)chunks, (unsigned)k, (unsigned)tiles);
  fn<<<grid, C::kThreads, smem, s>>>(feats, rb, g, part, nrows, mg, k, cin,
                                     cout, chunk, flip, vec_a, vec_b);
  return cudaGetLastError();
}

template <int TN, int kWG>
cudaError_t launch_dw_wgmma(const sm90::bf16* feats, const int* rb,
                            const sm90::bf16* g, float* part,
                            long long nrows, int mg, int k, int cin,
                            int cout, int chunk, int flip, int chunks,
                            cudaStream_t s) {
  using C = DwWgCfg<TN, kWG>;
  const size_t smem = dw_wgmma_smem<TN, kWG>(chunk);
  auto fn = dw_wgmma_kernel<TN, kWG>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((cin + C::TM - 1) / C::TM) * ((cout + TN - 1) / TN);
  dim3 grid((unsigned)chunks,
            (unsigned)((k + dw_offsets(k) - 1) / dw_offsets(k)),
            (unsigned)tiles);
  fn<<<grid, C::kThreads, smem, s>>>(feats, rb, g, part, nrows, mg, k, cin,
                                     cout, chunk, flip);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dfeats (N, Cin) = gather-GEMM of g (M, Cout) over rb (N, K) with wt
// (K, Cout, Cin), the (flipped) transposed weights.
int conv_bwd_dfeats_f32(const void* g, const void* rb, const void* wt,
                        void* dfeats, int mg, long long nrows, int k,
                        int cout, int cin, void* stream) {
  return (int)gather_gemm::launch((const float*)g, (const int*)rb,
                                  (const float*)wt, (float*)dfeats, mg,
                                  nrows, k, cout, cin, (cudaStream_t)stream);
}

// dfeats through the row grouping: tile rows perm[m0 ..] of rb (N, K)
int conv_bwd_dfeats_perm_f32(const void* g, const void* rb, const void* perm,
                             const void* wt, void* dfeats, int mg,
                             long long nrows, int k, int cout, int cin,
                             void* stream) {
  return (int)gather_gemm::launch<true>(
      (const float*)g, (const int*)rb, (const float*)wt, (float*)dfeats, mg,
      nrows, k, cout, cin, (cudaStream_t)stream, (const int*)perm);
}

// the bf16 dfeats: g (M, Cout), w (K, Cin, Cout) the (flipped) weights
// as they are (Cout, the reduction, a multiple of 8), dfeats (N, Cin)
int conv_bwd_dfeats_bf16(const void* g, const void* rb, const void* w,
                         void* dfeats, int mg, long long nrows, int k,
                         int cout, int cin, void* stream) {
  return (int)sm90::launch_gather<false>(
      (const sm90::bf16*)g, (const int*)rb, nullptr, (const sm90::bf16*)w,
      (sm90::bf16*)dfeats, mg, nrows, k, cout, cin, (cudaStream_t)stream);
}

int conv_bwd_dfeats_perm_bf16(const void* g, const void* rb, const void* perm,
                              const void* w, void* dfeats, int mg,
                              long long nrows, int k, int cout, int cin,
                              void* stream) {
  return (int)sm90::launch_gather<false>(
      (const sm90::bf16*)g, (const int*)rb, (const int*)perm,
      (const sm90::bf16*)w, (sm90::bf16*)dfeats, mg, nrows, k, cout, cin,
      (cudaStream_t)stream);
}

// rev (N, K) int32: the reverse rulebook of idx (M, K) over N input rows,
// rev[r, j] = the m with idx[m, j] == r, else M (0 <= M < 2^31)
int strided_reverse_i32(const void* idx, void* rev, long long m, int n,
                        int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m < 0 || m > 0x7fffffffLL || n < 0 || k < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * k;
  if (total > 0) {
    const long long blocks = (total + 255) / 256;
    strided_prep_fill<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                        s>>>((int*)rev, total, (int)m);
  }
  if (m * k > 0)
    strided_prep_reverse<<<(unsigned)((m * k + 255) / 256), 256, 0, s>>>(
        (const int*)idx, (int*)rev, m, n, k);
  return (int)cudaGetLastError();
}

// perm (N,) int32: the input rows ordered stably by their lowest hit offset
// in rev (N, K) (K: no hit).  Scratch: key N bytes, hist (K + 1) *
// ceil(N / 1024) ints.
int strided_group_i32(const void* rev, void* key, void* hist, void* perm,
                      long long n, int mg, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || k > 32 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int blocks = (int)((n + kGroupRows - 1) / kGroupRows);
  strided_prep_hist<<<blocks, kGroupThreads, 0, s>>>(
      (const int*)rev, (unsigned char*)key, (int*)hist, n, mg, k, blocks);
  strided_prep_scan<<<1, 1024, 0, s>>>((int*)hist, (k + 1) * blocks);
  strided_prep_scatter<<<blocks, kGroupThreads, 0, s>>>(
      (const unsigned char*)key, (const int*)hist, (int*)perm, n, k, blocks);
  return (int)cudaGetLastError();
}

// dW (K, Cin, Cout); part holds chunks * K * Cin * Cout floats of scratch,
// chunks = ceil(nrows / chunk), 0 < chunk <= 4096.
int conv_bwd_dw_f32(const void* feats, const void* rb, const void* g,
                    void* part, void* dw, long long nrows, int mg, int k,
                    int cin, int cout, int chunk, int flip, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)feats;
  const int* r = (const int*)rb;
  const float* gg = (const float*)g;
  float* p = (float*)part;
  if (chunk < 1 || chunk > kMaxChunk || k < 1 || cin < 0 || cout < 0 ||
      nrows < 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = (int)((nrows + chunk - 1) / chunk);
  const long long per = (long long)k * cin * cout;
  if (per == 0) return (int)cudaSuccess;
  if (chunks > 0) {
    const int ti = tile_of(cin), to = tile_of(cout);
    cudaError_t err = cudaErrorInvalidValue;
#define SRF_DW(TI, TO)                                                      \
  if (ti == TI && to == TO)                                                 \
    err = launch_dw<TI, TO>(f, r, gg, p, nrows, mg, k, cin, cout, chunk,   \
                            flip, chunks, s);
    SRF_DW(16, 16) SRF_DW(16, 32) SRF_DW(16, 64) SRF_DW(16, 128)
    SRF_DW(32, 16) SRF_DW(32, 32) SRF_DW(32, 64) SRF_DW(32, 128)
    SRF_DW(64, 16) SRF_DW(64, 32) SRF_DW(64, 64) SRF_DW(64, 128)
    SRF_DW(128, 16) SRF_DW(128, 32) SRF_DW(128, 64) SRF_DW(128, 128)
#undef SRF_DW
    if (err != cudaSuccess) return (int)err;
  }
  dw_reduce_kernel<<<(unsigned)((per + 255) / 256), 256, 0, s>>>(
      p, (float*)dw, chunks, per);
  return (int)cudaGetLastError();
}

// the same with bf16 feats, g and dW (f32 partials, dW rounded once); Cin
// and Cout multiples of 8, feats and g 16-byte aligned.  Each consumer
// warpgroup owns 64 channels of Cin (two above 64), the Cout tile is
// Cout's power of two, 16 to 128.
int conv_bwd_dw_bf16(const void* feats, const void* rb, const void* g,
                     void* part, void* dw, long long nrows, int mg, int k,
                     int cin, int cout, int chunk, int flip, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using sm90::bf16;
  const bf16* f = (const bf16*)feats;
  const int* r = (const int*)rb;
  const bf16* gg = (const bf16*)g;
  float* p = (float*)part;
  if (chunk < 1 || chunk > kMaxChunk || k < 1 || cin < 0 || cout < 0 ||
      nrows < 0 || cin % 8 != 0 || cout % 8 != 0 || !sm90::aligned16(f) ||
      !sm90::aligned16(gg))
    return (int)cudaErrorInvalidValue;
  const int chunks = (int)((nrows + chunk - 1) / chunk);
  const long long per = (long long)k * cin * cout;
  if (per == 0) return (int)cudaSuccess;
  if (chunks > 0) {
    const int to = tile_of(cout), wgs = cin > 64 ? 2 : 1;
    cudaError_t err = cudaErrorInvalidValue;
#define SRF_DW(TO, WG)                                                     \
  if (to == TO && wgs == WG)                                               \
    err = launch_dw_wgmma<TO, WG>(f, r, gg, p, nrows, mg, k, cin, cout,    \
                                  chunk, flip, chunks, s);
    SRF_DW(16, 1) SRF_DW(32, 1) SRF_DW(64, 1) SRF_DW(128, 1)
    SRF_DW(16, 2) SRF_DW(32, 2) SRF_DW(64, 2) SRF_DW(128, 2)
#undef SRF_DW
    if (err != cudaSuccess) return (int)err;
  }
  dw_reduce_bf16_kernel<<<(unsigned)((per + 31) / 32), 256, 0, s>>>(
      p, (bf16*)dw, chunks, per);
  return (int)cudaGetLastError();
}

}  // extern "C"
