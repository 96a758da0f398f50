// Sparse-conv gather-GEMM, float32 through 3xTF32 tensor cores, CUDA C++
// for sm_90a.
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
// (M*K + N*Cin + M*Cout)*4 bytes.  At stages 2-3 (Cin = Cout = 64, 128;
// 13-22 hits a row) that is 400-800 flops a byte, above the 3xTF32 ridge
// (165 TFLOP/s over 3.35 TB/s = 49 flops a byte), so the tensor cores' rate
// for three TF32 products a multiply-add bounds them.  At stages 0-1 and
// conv_input (Cin 4-32, 1-5 hits a row) the row gathers' bytes and their
// latency do.  The design (device code in gather_gemm.cuh, shared with the
// backward's dfeats gather in gather_conv_bwd.cu):
//   - 3xTF32 mma.sync m16n8k8 (hi/lo split of both operands, lo*hi + hi*lo
//     + hi*hi in f32), so the products run on the tensor cores and stay
//     f32-faithful; never a 1-term TF32 product;
//   - a block tile of 64-128 rows x up to 128 columns over 4-8 warps; an
//     offset that misses for every row of the tile is skipped;
//   - a 3-stage cp.async ring over (offset, channel chunk) steps: the hit
//     rows' chunk is gathered by 16 B copies (4 B where Cin % 4 != 0), a
//     missed row zero-filled without a read, so the next step's gather
//     overlaps this step's MMAs;
//   - padded shared rows: fragment loads are free of bank conflicts.
// The TPU kernel's windows, one-hot matmuls, lane packing and correction
// pass exist because Mosaic has no dynamic gather; here rows are loaded by
// index, so none of them is needed.
//
// bfloat16 (the bf16 model's tables, JAX pallas_onehot.py:114-118, :275,
// :317): gather_conv_bf16 takes bf16 feats and the bf16 weights W (K, Cin,
// Cout) as they are and writes bf16 out: f32 sums of the exact bf16
// products, each output rounded to bf16 once, the TPU kernel's numbers
// (its one-hot gathers are exact, its accumulator f32).  Its device code
// is gather_gemm_sm90.cuh's: wgmma from shared memory fed by an mbarrier
// ring of cp.async row gathers (several offsets a step at Cin 16-32) and
// TMA weight boxes read MN-major in place; what bounds each shape and what
// the design does about it are in that header.  Any Cin
// (rows not 16-byte aligned are copied by ordinary loads); Cout a multiple
// of 8 (the weights' tensor map).
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns the launch's CUDA error code (invalid value for K > 32).

#include "gather_gemm.cuh"
#include "gather_gemm_sm90.cuh"

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gather_conv_f32(const void* feats, const void* idx, const void* w,
                    void* out, int n, long long m, int k, int cin, int cout,
                    void* stream) {
  return (int)gather_gemm::launch((const float*)feats, (const int*)idx,
                                  (const float*)w, (float*)out, n, m, k, cin,
                                  cout, (cudaStream_t)stream);
}

int gather_conv_bf16(const void* feats, const void* idx, const void* w,
                     void* out, int n, long long m, int k, int cin, int cout,
                     void* stream) {
  return (int)sm90::launch_gather<true>(
      (const sm90::bf16*)feats, (const int*)idx, nullptr,
      (const sm90::bf16*)w, (sm90::bf16*)out, n, m, k, cin, cout,
      (cudaStream_t)stream);
}

}  // extern "C"
