// Column-query rulebook ("eq-match"), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel srfdet3d_tpu/ops/pallas_eqmatch.py::eqmatch_rulebook
// (kernel body _eqmatch_kernel).  It builds the submanifold 3x3x3 rulebook of
// a bitmap-column voxel set: for query row q (a voxel, base cell
// (z-1, y-1, x-1)) and tap j = (dz, dy, dx), z-major, the global feature row
// of voxel (zb+dz, yb+dy, xb+dx), or the miss row n_batch * row_cap.
//
// What bounds it: each thread does one binary search over the sorted column
// keys (17 dependent loads at 120k columns) and writes one int32.  The bytes
// it must move (the tables once, 108 B of output per voxel) take a few
// microseconds at 3.35 TB/s, so the search's load latency bounds it, not the
// memory rate.  The design keeps every thread independent (one per
// (voxel, tap)), so the card hides that latency with many warps in flight;
// the key array (< 1 MB) stays in L2 across the searches.  The TPU kernel's
// key windows, one-hot matches and fallback exist because Mosaic has no
// dynamic gather; here the search reads any key directly, so the kernel is
// exact for any layout and needs none of them.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long lower_bound(const long long* __restrict__ keys,
                                                 long long n, long long q) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void eqmatch_kernel(const long long* __restrict__ keys,
                               const unsigned long long* __restrict__ words,
                               const long long* __restrict__ starts,
                               long long n_cols,
                               const int* __restrict__ ybase,
                               const int* __restrict__ xbase,
                               const int* __restrict__ zbase,
                               const unsigned char* __restrict__ valid,
                               int q_per_sample, int n_batch, int h, int w,
                               int row_cap, int* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)n_batch * q_per_sample * 27;
  if (t >= total) return;
  long long q = t / 27;
  int j = (int)(t - q * 27);
  int b = (int)(q / q_per_sample);
  int dz = j / 9, dy = (j / 3) % 3, dx = j % 3;
  long long res = (long long)n_batch * row_cap;  // miss row
  if (valid[q]) {
    int y = ybase[q] + dy, x = xbase[q] + dx, z = zbase[q] + dz;
    if (y >= 0 && y < h && x >= 0 && x < w && z >= 0 && z < 64) {
      long long key = (long long)b * ((long long)h * w + 1) +
                      (long long)y * w + x;
      long long pos = lower_bound(keys, n_cols, key);
      if (pos < n_cols && keys[pos] == key) {
        unsigned long long word = words[pos];
        if ((word >> z) & 1ull) {
          long long row = starts[pos] +
                          __popcll(word & ((1ull << z) - 1ull));
          long long local = row - (long long)b * row_cap;
          if (local >= 0 && local < row_cap) res = row;
        }
      }
    }
  }
  out[t] = (int)res;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int eqmatch_rulebook(const void* keys, const void* words, const void* starts,
                     long long n_cols, const void* ybase, const void* xbase,
                     const void* zbase, const void* valid, int q_per_sample,
                     int n_batch, int h, int w, int row_cap, void* out,
                     void* stream) {
  long long total = (long long)n_batch * q_per_sample * 27;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    eqmatch_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (const unsigned long long*)words,
        (const long long*)starts, n_cols, (const int*)ybase,
        (const int*)xbase, (const int*)zbase, (const unsigned char*)valid,
        q_per_sample, n_batch, h, w, row_cap, (int*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
