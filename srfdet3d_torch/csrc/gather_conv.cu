// Sparse-conv gather-GEMM, float32, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel srfdet3d_tpu/ops/pallas_onehot.py::
// gather_matmul_onehot (kernel body _kernel):
//
//     out[m, :] = sum_j feats[idx[m, j], :] @ W[j]      (idx == N: a miss, zeros)
//
// feats (N, Cin) f32, idx (M, K) int32 in [0, N], W (K, Cin, Cout) f32,
// out (M, Cout) f32.  Every gathered conv of the sparse encoder runs it.
//
// What bounds it: the work is 2*M*K*Cin*Cout flops against about
// (M*K + N*Cin + M*Cout)*4 bytes: some 20 flops a byte at conv_input
// (Cin = 5) and some 800 at stage 3 (Cin = Cout = 128).  The card's float32
// ridge is 67 TFLOP/s over 3.35 TB/s = 20 flops a byte, so the f32 rate
// bounds every conv of the encoder, and the row gather comes next.  The
// design: one block owns a tile of BM output rows x TN
// output columns; for each offset j it stages the BM gathered rows (zeros for
// a miss) and W[j] in shared memory, KC input channels at a time, and each
// thread accumulates a 4x4 register tile with f32 FMAs.  A gathered row is
// read once per (block, offset) and reused across the TN columns; W[j] is
// reused across BM rows.  An offset that misses for every row of the tile is
// skipped, so a sparse rulebook costs the offsets its tiles touch, not all K.
// Exact float32 (no TF32), accumulated over j, then over channels.  The TPU kernel's windows, one-hot matmuls, lane packing,
// bf16x3 splits and correction pass exist because Mosaic has no dynamic
// gather; here rows are loaded by index, so none of them is needed.  wgmma,
// TMA and bf16 are later work.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRM = 4;   // rows per thread
constexpr int kRN = 4;   // columns per thread
constexpr int kKC = 16;  // input channels per shared-memory stage

template <int TN>
__global__ void __launch_bounds__(kThreads)
gather_conv_kernel(const float* __restrict__ feats, const int* __restrict__ idx,
                   const float* __restrict__ w, float* __restrict__ out,
                   int n, long long m, int k, int cin, int cout) {
  constexpr int TCOLS = TN / kRN;          // threads across columns
  constexpr int TROWS = kThreads / TCOLS;  // threads across rows
  constexpr int BM = TROWS * kRM;          // output rows of the block
  __shared__ float As[kKC][BM + 4];
  __shared__ float Bs[kKC][TN];
  __shared__ int rows[BM];

  const int tid = threadIdx.x;
  const int tc = tid % TCOLS, tr = tid / TCOLS;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * TN;
  float acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int jj = 0; jj < kRN; ++jj) acc[i][jj] = 0.f;

  for (int j = 0; j < k; ++j) {
    int hit = 0;
    for (int r = tid; r < BM; r += kThreads) {
      long long mm = m0 + r;
      int row = mm < m ? idx[mm * k + j] : n;
      rows[r] = row;
      hit |= (unsigned)row < (unsigned)n;
    }
    // an offset that misses for every row of the tile adds nothing
    if (!__syncthreads_or(hit)) continue;
    for (int c0 = 0; c0 < cin; c0 += kKC) {
      for (int e = tid; e < BM * kKC; e += kThreads) {
        int r = e / kKC, c = e % kKC;
        int row = rows[r], cc = c0 + c;
        // any row outside [0, n) reads zeros: n is the miss row
        As[c][r] = ((unsigned)row < (unsigned)n && cc < cin)
                       ? __ldg(feats + (long long)row * cin + cc) : 0.f;
      }
      for (int e = tid; e < kKC * TN; e += kThreads) {
        int c = e / TN, col = e % TN;
        int cc = c0 + c, nn = n0 + col;
        Bs[c][col] = (cc < cin && nn < cout)
                         ? __ldg(w + ((long long)j * cin + cc) * cout + nn)
                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        float a[kRM], bv[kRN];
#pragma unroll
        for (int i = 0; i < kRM; ++i) a[i] = As[c][tr * kRM + i];
#pragma unroll
        for (int jj = 0; jj < kRN; ++jj) bv[jj] = Bs[c][tc * kRN + jj];
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int jj = 0; jj < kRN; ++jj)
            acc[i][jj] = fmaf(a[i], bv[jj], acc[i][jj]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    long long mm = m0 + tr * kRM + i;
    if (mm >= m) continue;
#pragma unroll
    for (int jj = 0; jj < kRN; ++jj) {
      int nn = n0 + tc * kRN + jj;
      if (nn < cout) out[mm * cout + nn] = acc[i][jj];
    }
  }
}

template <int TN>
void launch(const float* feats, const int* idx, const float* w, float* out,
            int n, long long m, int k, int cin, int cout, cudaStream_t s) {
  constexpr int BM = (kThreads / (TN / kRN)) * kRM;
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((cout + TN - 1) / TN));
  gather_conv_kernel<TN><<<grid, kThreads, 0, s>>>(feats, idx, w, out, n, m,
                                                   k, cin, cout);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gather_conv_f32(const void* feats, const void* idx, const void* w,
                    void* out, int n, long long m, int k, int cin, int cout,
                    void* stream) {
  if (m > 0 && cout > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const float* f = (const float*)feats;
    const int* ix = (const int*)idx;
    const float* wt = (const float*)w;
    float* o = (float*)out;
    if (cout >= 64)
      launch<64>(f, ix, wt, o, n, m, k, cin, cout, s);
    else if (cout > 16)
      launch<32>(f, ix, wt, o, n, m, k, cin, cout, s);
    else
      launch<16>(f, ix, wt, o, n, m, k, cin, cout, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
