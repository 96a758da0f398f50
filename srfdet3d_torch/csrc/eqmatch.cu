// Column-query rulebook ("eq-match"), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel srfdet3d_tpu/ops/pallas_eqmatch.py::eqmatch_rulebook
// (kernel body _eqmatch_kernel).  It builds the 3x3x3 rulebook of a
// bitmap-column voxel set: for query row q with base cell
// (zb, yb, xb) = coord * scale - offset and tap j = (dz, dy, dx), z-major,
// the global feature row of voxel (zb+dz, yb+dy, xb+dx), or the miss row
// n_batch * row_cap (also for an invalid query and for a row past its
// sample's capacity).  A submanifold rulebook has scale 1, offset 1.
//
// Design.  The column set is 2D: at most one column a plan cell (y, x).  So
// the kernel first builds a dense plan map, cell -> global column slot
// b * P + p (miss n_batch * P), on each call: a fill and a scatter over the
// columns (8.7 MB a sample at 1472 x 1472, written at HBM rate).  Then one
// thread takes one (voxel, plan column (dy, dx)): 9 threads a voxel, each
// with one map load (the 3 dx cells of a dy are adjacent words) and one
// load of that column's z word and first row; the word answers all 3 dz
// taps (a bit test, and a popcount below z for the row).  The old design
// ran 27 threads a voxel, each with its own 17-deep binary search over the
// sorted column keys.  A block stages its voxels' 27-entry rows in shared
// memory and writes them with 16-byte stores: consecutive voxels' rows are
// contiguous in the (B, Q, 27) output.
//
// What bounds it: the bytes.  The output (108 B a voxel) and the map fill
// are the largest streams; the map reads hit L2 (a stage's map is at most
// ~9 MB a sample).  The TPU kernel's key windows, one-hot matches and
// fallback exist because Mosaic has no dynamic gather; Hopper loads any
// address directly, so the kernel is exact for any layout and needs none.
//
// The column arrays are read as the ColumnSet holds them: (B, P) views
// whose sample stride may exceed P (build_columns strips a trash column off
// each sample), given in elements.  Queries are (B, Q, 3) int64 zyx and a
// (B, Q) bool mask, contiguous.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVoxels = 32;             // voxels a query block
constexpr int kThreads = kVoxels * 9;   // one thread a (voxel, plan column)

__global__ void plan_map_fill_kernel(int* __restrict__ map, long long n,
                                     int miss) {
  long long n4 = n >> 2;
  int4 v = make_int4(miss, miss, miss, miss);
  long long stride = (long long)gridDim.x * blockDim.x;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = t; i < n4; i += stride)
    reinterpret_cast<int4*>(map)[i] = v;
  for (long long i = (n4 << 2) + t; i < n; i += stride) map[i] = miss;
}

__global__ void plan_map_scatter_kernel(const long long* __restrict__ ccoords,
                                        const bool* __restrict__ cmask,
                                        long long s_coords, long long s_mask,
                                        int n_batch, int p_cap, int h, int w,
                                        int* __restrict__ map) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_batch * p_cap) return;
  int b = (int)(t / p_cap);
  int p = (int)(t - (long long)b * p_cap);
  if (!cmask[b * s_mask + p]) return;
  const long long* yx = ccoords + b * s_coords + 2LL * p;
  long long y = yx[0], x = yx[1];
  if (y < 0 || y >= h || x < 0 || x >= w) return;
  map[((long long)b * h + y) * w + x] = (int)t;
}

__global__ void __launch_bounds__(kThreads)
eqmatch_query_kernel(const int* __restrict__ map,
                     const long long* __restrict__ bits,
                     const long long* __restrict__ cstart, long long s_bits,
                     long long s_start, const long long* __restrict__ coords,
                     const bool* __restrict__ valid, int q_per_sample,
                     int n_batch, int p_cap, int h, int w, int row_cap,
                     int scale, int oz, int oy, int ox,
                     int* __restrict__ out) {
  __shared__ int4 stage4[kVoxels * 27 / 4];
  int* stage = reinterpret_cast<int*>(stage4);
  // the wrapper holds n_batch * q_per_sample below 2^31: 32-bit indices
  const int n_q = n_batch * q_per_sample;
  const int q0 = blockIdx.x * kVoxels;
  const int vl = threadIdx.x / 9;
  const int c = threadIdx.x - vl * 9;      // plan column (dy, dx), row-major
  const int q = q0 + vl;
  const int miss = n_batch * row_cap;
  if (q < n_q) {
    int res[3] = {miss, miss, miss};
    if (valid[q]) {
      const int b = q / q_per_sample;
      const long long* zyx = coords + 3LL * q;
      long long zb = __ldg(zyx) * scale - oz;
      long long y = __ldg(zyx + 1) * scale - oy + c / 3;
      long long x = __ldg(zyx + 2) * scale - ox + c % 3;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        // the map of sample b holds only its own slots b * P + p
        int p = __ldg(map + ((long long)b * h + y) * w + x) - b * p_cap;
        if ((unsigned)p < (unsigned)p_cap) {
          unsigned long long word =
              (unsigned long long)__ldg(bits + b * s_bits + p);
          long long start = __ldg(cstart + b * s_start + p);
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            long long z = zb + dz;
            if (z >= 0 && z < 64 && ((word >> z) & 1ull)) {
              long long row =
                  start + __popcll(word & ((1ull << z) - 1ull));
              long long local = row - (long long)b * row_cap;
              if (local >= 0 && local < row_cap) res[dz] = (int)row;
            }
          }
        }
      }
    }
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) stage[vl * 27 + dz * 9 + c] = res[dz];
  }
  __syncthreads();
  const int left = n_q - q0;
  const int n_int = (left < kVoxels ? left : kVoxels) * 27;
  // q0 * 27 ints is a multiple of 4 (kVoxels is), so the block's rows
  // start on a 16-byte boundary of the (16-byte aligned) output
  int* base = out + (long long)q0 * 27;
  int4* dst = reinterpret_cast<int4*>(base);
  for (int i = threadIdx.x; i < n_int / 4; i += kThreads) dst[i] = stage4[i];
  for (int i = (n_int / 4) * 4 + threadIdx.x; i < n_int; i += kThreads)
    base[i] = stage[i];
}

void launch_plan_map(const void* ccoords, const void* cmask,
                     long long s_coords, long long s_mask, int n_batch,
                     int p_cap, int h, int w, void* map, cudaStream_t st) {
  long long cells = (long long)n_batch * h * w;
  if (cells > 0) {
    long long blocks = ((cells >> 2) + 255) / 256;
    if (blocks < 1) blocks = 1;
    if (blocks > 4096) blocks = 4096;
    plan_map_fill_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        (int*)map, cells, n_batch * p_cap);
  }
  long long cols = (long long)n_batch * p_cap;
  if (cols > 0) {
    plan_map_scatter_kernel<<<(unsigned)((cols + 255) / 256), 256, 0, st>>>(
        (const long long*)ccoords, (const bool*)cmask, s_coords, s_mask,
        n_batch, p_cap, h, w, (int*)map);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// map (B*H*W,) int32 <- global column slot of each plan cell, miss B*P
int plan_map(const void* ccoords, const void* cmask, long long s_coords,
             long long s_mask, int n_batch, int p_cap, int h, int w,
             void* map, void* stream) {
  launch_plan_map(ccoords, cmask, s_coords, s_mask, n_batch, p_cap, h, w,
                  map, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// out (B, Q, 27) int32: the plan map of the columns into `map`, then the
// query kernel
int eqmatch_rulebook(const void* ccoords, const void* cmask,
                     long long s_coords, long long s_mask, const void* bits,
                     const void* cstart, long long s_bits, long long s_start,
                     const void* coords, const void* valid, int q_per_sample,
                     int n_batch, int p_cap, int h, int w, int row_cap,
                     int scale, int oz, int oy, int ox, void* map, void* out,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  launch_plan_map(ccoords, cmask, s_coords, s_mask, n_batch, p_cap, h, w,
                  map, st);
  long long n_q = (long long)n_batch * q_per_sample;
  if (n_q > 0) {
    long long blocks = (n_q + kVoxels - 1) / kVoxels;
    eqmatch_query_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int*)map, (const long long*)bits, (const long long*)cstart,
        s_bits, s_start, (const long long*)coords, (const bool*)valid,
        q_per_sample, n_batch, p_cap, h, w, row_cap, scale, oz, oy, ox,
        (int*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
