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
// design (device code in gather_gemm.cuh, shared with the backward's dfeats
// gather in gather_conv_bwd.cu): one block owns a tile of output rows x
// output columns and stages the gathered rows and W[j] in shared memory;
// each thread accumulates a 4x4 register tile with f32 FMAs.  An offset that
// misses for every row of the tile is skipped, so a sparse rulebook costs
// the offsets its tiles touch, not all K.  The TPU kernel's windows, one-hot
// matmuls, lane packing, bf16x3 splits and correction pass exist because
// Mosaic has no dynamic gather; here rows are loaded by index, so none of
// them is needed.  wgmma, TMA and bf16 are later work.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns cudaGetLastError().

#include "gather_gemm.cuh"

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gather_conv_f32(const void* feats, const void* idx, const void* w,
                    void* out, int n, long long m, int k, int cin, int cout,
                    void* stream) {
  gather_gemm::launch((const float*)feats, (const int*)idx, (const float*)w,
                      (float*)out, n, m, k, cin, cout, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
