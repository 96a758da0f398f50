// Sorted-key rulebook lookup, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel srfdet3d_tpu/ops/pallas_rulebook.py::rulebook_lookup
// (kernel body _kernel).  For each query key of each kernel offset it finds
// the equal key in an ascending key array and returns that key's row:
//
//     out[m, k] = rows[pos]   where keys[pos] == queries[m, k]
//     out[m, k] = n_keys      (the miss row) for a key that is absent, and
//                             for an invalid query (< 0 or >= sentinel)
//
// `rows` lets the key array be a sorted view of rows in any order: the
// table rulebook's stage-0 voxels arrive plan-major, and their z-major keys
// are sorted once with the permutation kept as `rows`.  Later stages are
// already in key order and pass rows = 0..n_keys-1.
//
// What bounds it: each thread does one binary search over the sorted keys
// (17 dependent loads at 65k-120k keys) and writes one int32.  The bytes it
// must move (the queries once, 12 B per key, 4 B of output per query) take
// tens of microseconds at 3.35 TB/s, so the search's load latency bounds it
// in practice.  The design keeps every thread independent (one per query),
// so the card hides that latency with many warps in flight, and the key
// array (< 1 MB) stays in L2 across the searches.  The TPU kernel's
// super-row windows, lane-wise equality sums, out-of-window flags and
// correction pass exist because Mosaic has no dynamic gather; here the
// search reads any key directly, so the kernel is exact for any query order
// and needs none of them.
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

__global__ void rulebook_lookup_kernel(const long long* __restrict__ keys,
                                       const int* __restrict__ rows,
                                       long long n_keys,
                                       const long long* __restrict__ queries,
                                       long long n_queries, long long sentinel,
                                       int* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_queries) return;
  long long q = queries[t];
  int res = (int)n_keys;  // miss row
  if (q >= 0 && q < sentinel) {
    long long pos = lower_bound(keys, n_keys, q);
    if (pos < n_keys && __ldg(keys + pos) == q) res = __ldg(rows + pos);
  }
  out[t] = res;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int rulebook_lookup(const void* keys, const void* rows, long long n_keys,
                    const void* queries, long long n_queries,
                    long long sentinel, void* out, void* stream) {
  if (n_queries > 0) {
    const int threads = 256;
    long long blocks = (n_queries + threads - 1) / threads;
    rulebook_lookup_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (const long long*)keys, (const int*)rows, n_keys,
        (const long long*)queries, n_queries, sentinel, (int*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
