// RoIAlign backward, table cotangent, float32, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel srfdet3d_tpu/ops/pallas_patch_scatter.py::
// roi_window_scatter_add (kernel body _kernel), which adds each RoI's
// (P, P, C) patch cotangent into its window of the level image.  The port's
// RoIAlign samples the bilinear corners directly (ops/roi_align.py), so
// the same function, the cotangent of the (rows, C) feature table, is
//
//     dtable[idx[r, q]] += w[r, q] * gp[r, cell(q)] / sr^2
//
// over every RoI r that the capacity rule kept and every corner sample q
// (4 corners x S x S samples, S = out * sr); cell(q) is the output cell the
// sample is pooled into.  gp (R, out, out, C), idx (R, 4, S, S) int32 rows
// of the table, w (R, 4, S, S), drop (R,) uint8, dtable (rows, C), all f32.
//
// What bounds it: bytes.  It reads the pooled cotangent once (R*out^2*C*4
// bytes) and writes the table gradient once; the 4*S^2*C weighted adds of a
// RoI are a few flops a byte.  The design: one block per RoI, one thread per
// channel (coalesced over C).  The block stages its RoI's corner rows and
// weights in shared memory, then each thread walks the samples and
// atomicAdds w * g / sr^2 into the table row; zero weights (out-of-bounds
// samples) are skipped.  Overlapping RoIs add through the atomics, so the
// order of additions changes from run to run.  Summing each RoI's
// duplicate corner rows before the atomics is later work.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void roi_scatter_kernel(const float* __restrict__ gp,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ w,
                                   const uint8_t* __restrict__ drop,
                                   float* __restrict__ dt, int c, int out,
                                   int sr) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x;
  if (drop[r]) return;
  const int s = out * sr;
  const int nq = 4 * s * s;
  int* rows = (int*)smem;
  float* wts = (float*)(smem + sizeof(int) * nq);
  const long long base = (long long)r * nq;
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    rows[q] = idx[base + q];
    wts[q] = w[base + q];
  }
  __syncthreads();
  const float scale = 1.f / (float)(sr * sr);
  const float* g_r = gp + (long long)r * out * out * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    for (int q = 0; q < nq; ++q) {
      float wq = wts[q];
      if (wq == 0.f) continue;
      int sample = q % (s * s);
      int cy = (sample / s) / sr, cx = (sample % s) / sr;
      float gv = g_r[(cy * out + cx) * c + ch];
      atomicAdd(dt + (long long)rows[q] * c + ch, wq * gv * scale);
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtable must hold zeros on entry; the kernel adds into it.
int roi_scatter_f32(const void* gp, const void* idx, const void* w,
                    const void* drop, void* dtable, int r, int c, int out,
                    int sr, void* stream) {
  if (r > 0 && c > 0) {
    int s = out * sr;
    size_t smem = (size_t)4 * s * s * (sizeof(int) + sizeof(float));
    int threads = c >= 256 ? 256 : ((c + 31) / 32) * 32;
    roi_scatter_kernel<<<(unsigned)r, threads, smem, (cudaStream_t)stream>>>(
        (const float*)gp, (const int*)idx, (const float*)w,
        (const uint8_t*)drop, (float*)dtable, c, out, sr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
