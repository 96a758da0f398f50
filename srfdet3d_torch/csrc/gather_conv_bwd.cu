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
// The TPU kernels' windows, one-hot matmuls and read-modify-write window
// accumulation exist because Mosaic has no dynamic gather or scatter; here
// rows load by index and the reverse rulebook turns the scatter into a
// gather.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; each entry returns the launch's CUDA error code.

#include "gather_gemm.cuh"

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

}  // extern "C"
