// Sparse-conv gather-GEMM backward, float32, CUDA C++ for sm_90a.
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
// bytes, the f32 rate outside the tensor cores at the wide stages and the
// row gather at the narrow ones, as for the forward.  The design:
//   - dfeats is the forward's gather-GEMM (gather_gemm.cuh) over g, with the
//     (flipped) transposed weights, which the wrapper lays out as
//     (K, Cout, Cin).  Its own entry point.
//   - dW: a grid over (row chunk, offset j, Cin x Cout tile).  A block walks
//     its chunk 32 rows at a time, staging the feature rows and the gathered
//     g rows (zeros for a miss) in shared memory; its 256 threads split into
//     S row slices, each thread accumulating a 4x4 register tile of the
//     block's TCI x TCO dW tile.  Stages that miss for all 32 rows are
//     skipped.  The slices are summed in shared memory in slice order, and
//     each block writes its partial to part[chunk]; a second pass adds the
//     partials in chunk order.  Deterministic, no atomics.
// The TPU kernels' windows, one-hot matmuls and read-modify-write window
// accumulation exist because Mosaic has no dynamic gather or scatter; here
// rows load by index and the reverse rulebook turns the scatter into a
// gather.  Tensor cores (3xTF32) and TMA row gathers are later work.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; each entry returns cudaGetLastError().

#include "gather_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows per shared-memory stage

template <int TCI, int TCO>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const float* __restrict__ feats, const int* __restrict__ rb,
                  const float* __restrict__ g, float* __restrict__ part,
                  long long nrows, int mg, int k, int cin, int cout,
                  int chunk, int flip) {
  constexpr int TCOLS = TCO / 4;
  constexpr int TPT = (TCI / 4) * TCOLS;  // threads per copy of the tile
  constexpr int S = kThreads / TPT;       // row slices
  __shared__ float As[kRows][TCI];
  __shared__ float Bs[kRows][TCO];
  __shared__ float red[kThreads * 16];    // S * TCI * TCO floats
  __shared__ int rows[kRows];

  const int tid = threadIdx.x;
  const int slice = tid / TPT, l = tid % TPT;
  const int tr = l / TCOLS, tc = l % TCOLS;
  const int j = blockIdx.y;
  const int tiles_co = (cout + TCO - 1) / TCO;
  const int ci0 = (blockIdx.z / tiles_co) * TCI;
  const int co0 = (blockIdx.z % tiles_co) * TCO;
  const long long r_begin = (long long)blockIdx.x * chunk;
  long long r_end = r_begin + chunk;
  if (r_end > nrows) r_end = nrows;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kRows) {
    int hit = 0;
    if (tid < kRows) {
      long long r = r0 + tid;
      int gr = r < r_end ? rb[r * k + j] : mg;
      rows[tid] = gr;
      hit = (unsigned)gr < (unsigned)mg;
    }
    // a stage that misses for all its rows adds nothing
    if (!__syncthreads_or(hit)) continue;
    for (int e = tid; e < kRows * TCI; e += kThreads) {
      int rr = e / TCI, c = e % TCI;
      long long r = r0 + rr;
      int cc = ci0 + c;
      As[rr][c] = ((unsigned)rows[rr] < (unsigned)mg && cc < cin)
                      ? __ldg(feats + r * cin + cc) : 0.f;
    }
    for (int e = tid; e < kRows * TCO; e += kThreads) {
      int rr = e / TCO, c = e % TCO;
      int gr = rows[rr], cc = co0 + c;
      Bs[rr][c] = ((unsigned)gr < (unsigned)mg && cc < cout)
                      ? __ldg(g + (long long)gr * cout + cc) : 0.f;
    }
    __syncthreads();
    for (int rr = slice; rr < kRows; rr += S) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][tr * 4 + i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = Bs[rr][tc * 4 + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(a[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

  // sum the slices in slice order, then write this chunk's partial tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      red[slice * TCI * TCO + (tr * 4 + i) * TCO + tc * 4 + jj] = acc[i][jj];
  __syncthreads();
  const int jo = flip ? k - 1 - j : j;
  float* dst = part + ((long long)blockIdx.x * k + jo) * cin * cout;
  for (int e = tid; e < TCI * TCO; e += kThreads) {
    int ci = ci0 + e / TCO, co = co0 + e % TCO;
    if (ci >= cin || co >= cout) continue;
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += red[q * TCI * TCO + e];
    dst[(long long)ci * cout + co] = v;
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

template <int TCI, int TCO>
void launch_dw(const float* feats, const int* rb, const float* g, float* part,
               long long nrows, int mg, int k, int cin, int cout, int chunk,
               int flip, int chunks, cudaStream_t s) {
  int tiles = ((cin + TCI - 1) / TCI) * ((cout + TCO - 1) / TCO);
  dim3 grid((unsigned)chunks, (unsigned)k, (unsigned)tiles);
  dw_partial_kernel<TCI, TCO><<<grid, kThreads, 0, s>>>(
      feats, rb, g, part, nrows, mg, k, cin, cout, chunk, flip);
}

int tile_of(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : 64); }

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
  gather_gemm::launch((const float*)g, (const int*)rb, (const float*)wt,
                      (float*)dfeats, mg, nrows, k, cout, cin,
                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// dW (K, Cin, Cout); part holds chunks * K * Cin * Cout floats of scratch,
// chunks = ceil(nrows / chunk), chunk a multiple of 32.
int conv_bwd_dw_f32(const void* feats, const void* rb, const void* g,
                    void* part, void* dw, long long nrows, int mg, int k,
                    int cin, int cout, int chunk, int flip, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)feats;
  const int* r = (const int*)rb;
  const float* gg = (const float*)g;
  float* p = (float*)part;
  int chunks = (int)((nrows + chunk - 1) / chunk);
  long long per = (long long)k * cin * cout;
  if (per <= 0) return (int)cudaGetLastError();
  if (chunks > 0) {
    int ti = tile_of(cin), to = tile_of(cout);
#define SRF_DW(TI, TO)                                                      \
  if (ti == TI && to == TO)                                                 \
    launch_dw<TI, TO>(f, r, gg, p, nrows, mg, k, cin, cout, chunk, flip,   \
                      chunks, s);
    SRF_DW(16, 16) SRF_DW(16, 32) SRF_DW(16, 64)
    SRF_DW(32, 16) SRF_DW(32, 32) SRF_DW(32, 64)
    SRF_DW(64, 16) SRF_DW(64, 32) SRF_DW(64, 64)
#undef SRF_DW
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  dw_reduce_kernel<<<(unsigned)((per + 255) / 256), 256, 0, s>>>(
      p, (float*)dw, chunks, per);
  return (int)cudaGetLastError();
}

}  // extern "C"
