// RoIAlign backward, table cotangent, float32, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel srfdet3d_tpu/ops/pallas_patch_scatter.py::
// roi_window_scatter_add (kernel body _kernel), which adds each RoI's
// (P, P, C) patch cotangent into its window of the level image.  The port's
// RoIAlign samples the bilinear corners directly (ops/roi_align.py), so
// the same function, the cotangent of the (rows, C) feature table, is
//
//     dtable[base + y * width + x] += wy * wx * gp[r, cy, cx] / sr^2
//
// over every RoI r that the capacity rule kept, every sample (i, j) of its
// S x S grid (S = out * sr; cell (cy, cx) = (i / sr, j / sr)) and each of
// the sample's bilinear corners: y in {y0[i], y1[i]} with weight wy0[i] or
// wy1[i], x in {x0[j], x1[j]} with wx0[j] or wx1[j].  The grid is
// separable, so the kernel takes the per-axis corners: cells (R, 4, S)
// int32 [y0, y1, x0, x1], cw (R, 4, S) their weights, level (R, 2) int32
// [base, width] (the table row of the level's cell (0, 0) for the RoI's
// sample, and the level's width), drop (R,) uint8; gp (R, out, out, C).
//
// What bounds it: bytes.  It reads the pooled cotangent once (R*out^2*C*4
// bytes) and writes the table gradient once.  Adding every corner sample
// to the table with its own global atomic (4 S^2 = 784 a RoI and channel at
// out 7, sr 2) made the atomics the bound: a RoI's samples land on few
// cells (a small box's 784 adds of a channel on about 4 rows).  The design:
//   - a block per (RoI, 32-channel tile), 8 warps; the RoI's gp tile is
//     copied to shared memory by cp.async at the start, behind the corner
//     ranking below;
//   - each axis has 2 S corner candidates; the live ones (weight != 0) are
//     ranked to their distinct cells, at most 2 S a RoI whatever its size
//     (misfit RoIs of the fallback slots included), and each distinct cell
//     gets its weight per output cell column: wax[u][c] = the sum of its
//     candidates' weights over the samples of column c;
//   - the RoI's window sum is then two small products in shared memory,
//     h[cy][ux] = sum_cx wax_x[ux][cx] gp[cy][cx], then
//     v[uy][ux] = sum_cy wax_y[uy][cy] h[cy][ux], each slot owned by one
//     thread and summed in a fixed order (no shared atomics);
//   - one global atomic add per touched (cell, channel): ny * nx a RoI and
//     channel instead of 4 S^2, issued as 16-byte float4 atomics (sm_90)
//     where C % 4 == 0: a lane sums and adds 4 channels, 8 lanes a cell.
//     Overlapping RoIs still add through the atomics, so the sum order
//     across RoIs changes from run to run.
// Dropped RoIs return at once.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns cudaGetLastError().

#include "gather_gemm.cuh"  // tc::cp_async*

namespace {

constexpr int kCT = 32;        // channels a block
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

// dynamic shared memory of a block, in 4-byte words
__host__ __device__ inline int smem_words(int out, int sr) {
  const int a = 2 * out * sr;  // candidates per axis
  return 2 * a * 3                  // cell, weight, rank->cell per axis
         + 2 * a * out              // wax
         + out * out * kCT          // gp tile
         + out * a * kCT            // h
         + 2;                       // distinct counts
}

__global__ void __launch_bounds__(kThreads)
roi_scatter_kernel(const float* __restrict__ gp, const int* __restrict__ cells,
                   const float* __restrict__ cw, const int* __restrict__ level,
                   const uint8_t* __restrict__ drop, float* __restrict__ dt,
                   int c, int out, int sr, int vec) {
  const int r = blockIdx.x;
  if (drop[r]) return;
  extern __shared__ __align__(16) float smem[];
  const int s = out * sr, a = 2 * s;
  int* cand = reinterpret_cast<int*>(smem);       // [2][a]
  float* wc = smem + 2 * a;                       // [2][a]
  int* uniq = reinterpret_cast<int*>(wc + 2 * a); // [2][a]; first flags first
  float* wax = reinterpret_cast<float*>(uniq + 2 * a);  // [2][a][out]
  float* gs = wax + 2 * a * out;                  // [out][out][kCT]
  float* h = gs + out * out * kCT;                // [out][nx][kCT]
  int* nuniq = reinterpret_cast<int*>(h + out * a * kCT);  // [2]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c0 = blockIdx.y * kCT;

  // the gp tile, in flight while the corners are ranked (channels past C
  // zero-filled without a read)
  const float* g_r = gp + (long long)r * out * out * c;
  if (vec) {
    for (int e = t; e < out * out * kCT / 4; e += kThreads) {
      const int cell = e / (kCT / 4), l = (e - cell * (kCT / 4)) * 4;
      const bool ok = c0 + l < c;
      tc::cp_async16(gs + 4 * e, ok ? g_r + (long long)cell * c + c0 + l : gp,
                     ok ? 16 : 0);
    }
  } else {
    for (int e = t; e < out * out * kCT; e += kThreads) {
      const int cell = e / kCT, l = e - cell * kCT;
      const bool ok = c0 + l < c;
      tc::cp_async4(gs + e, ok ? g_r + (long long)cell * c + c0 + l : gp,
                    ok ? 4 : 0);
    }
  }
  tc::cp_commit();
  // the candidates, one a thread (2 a <= kThreads): axis ax, candidate
  // kk = q * S + i (corner q of sample i)
  const int ax = t / a, kk = t - ax * a;
  const bool mine = t < 2 * a;
  if (mine) {
    const long long src = ((long long)r * 4 + 2 * ax + kk / s) * s + kk % s;
    cand[t] = cells[src];
    wc[t] = cw[src];
  }
  __syncthreads();
  // is the candidate the first live one of its cell on its axis?
  bool first = false;
  if (mine) {
    first = wc[t] != 0.f;
    for (int q = 0; q < kk && first; ++q)
      first = !(wc[ax * a + q] != 0.f && cand[ax * a + q] == cand[t]);
    uniq[t] = first;
  }
  __syncthreads();
  // its rank among the first ones: the index of its distinct cell
  int rank = 0;
  if (mine) {
    for (int q = 0; q < kk; ++q) rank += uniq[ax * a + q];
    if (kk == a - 1) nuniq[ax] = rank + first;
  }
  __syncthreads();
  if (first) uniq[ax * a + rank] = cand[t];
  __syncthreads();
  const int ny = nuniq[0], nx = nuniq[1];
  if (ny == 0 || nx == 0) {
    tc::cp_wait<0>();
    return;
  }
  // wax[ax][u][cc]: distinct cell u's weight for output cell column cc
  for (int e = t; e < 2 * a * out; e += kThreads) {
    const int axis = e / (a * out), rest = e - axis * a * out;
    const int u = rest / out, cc = rest - u * out;
    if (u >= nuniq[axis]) continue;
    const int cell = uniq[axis * a + u];
    float v = 0.f;
    for (int i = cc * sr; i < cc * sr + sr; ++i)
      for (int q = 0; q < 2; ++q) {
        const int at = axis * a + q * s + i;
        if (cand[at] == cell) v += wc[at];
      }
    wax[e] = v;
  }
  tc::cp_wait<0>();
  __syncthreads();
  // a warp takes 4 slots at a time, 8 lanes a slot, 4 channels a lane
  const int sub = lane >> 3, quad = lane & 7;
  const int ch4 = c0 + 4 * quad;
  const float4* gs4 = reinterpret_cast<const float4*>(gs);
  float4* h4 = reinterpret_cast<float4*>(h);
  // h[cy][ux] = sum_cx wax_x[ux][cx] gp[cy][cx]
  const float* wx = wax + a * out;
  for (int slot = 4 * warp + sub; slot < out * nx; slot += 4 * kWarps) {
    const int cy = slot / nx, ux = slot - cy * nx;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cx = 0; cx < out; ++cx) {
      const float wv = wx[ux * out + cx];
      const float4 gv = gs4[(cy * out + cx) * (kCT / 4) + quad];
      v.x += wv * gv.x;
      v.y += wv * gv.y;
      v.z += wv * gv.z;
      v.w += wv * gv.w;
    }
    h4[slot * (kCT / 4) + quad] = v;
  }
  __syncthreads();
  // v[uy][ux] = sum_cy wax_y[uy][cy] h[cy][ux]; one atomic a cell and
  // channel, 16 bytes at a time where C allows
  const float scale = 1.f / (float)(sr * sr);
  const long long base = level[2 * r], width = level[2 * r + 1];
  for (int slot = 4 * warp + sub; slot < ny * nx; slot += 4 * kWarps) {
    const int uy = slot / nx, ux = slot - uy * nx;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cy = 0; cy < out; ++cy) {
      const float wv = wax[uy * out + cy];
      const float4 hv = h4[(cy * nx + ux) * (kCT / 4) + quad];
      v.x += wv * hv.x;
      v.y += wv * hv.y;
      v.z += wv * hv.z;
      v.w += wv * hv.w;
    }
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    float* dst = dt + (base + uniq[uy] * width + uniq[a + ux]) * c + ch4;
    if (vec) {
      if (ch4 < c) atomicAdd(reinterpret_cast<float4*>(dst), v);
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < 4; ++i)
        if (ch4 + i < c) atomicAdd(dst + i, e[i]);
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtable must hold zeros on entry; the kernel adds into it.
int roi_scatter_f32(const void* gp, const void* cells, const void* cw,
                    const void* level, const void* drop, void* dtable, int r,
                    int c, int out, int sr, void* stream) {
  // 2 S corner candidates an axis, one a thread for both axes
  if (out < 1 || sr < 1 || 4 * out * sr > kThreads)
    return (int)cudaErrorInvalidValue;
  if (r > 0 && c > 0) {
    const size_t smem = sizeof(float) * (size_t)smem_words(out, sr);
    cudaError_t err = cudaFuncSetAttribute(
        roi_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int vec = c % 4 == 0 && tc::aligned16(gp) && tc::aligned16(dtable);
    dim3 grid((unsigned)r, (unsigned)((c + kCT - 1) / kCT));
    roi_scatter_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)gp, (const int*)cells, (const float*)cw,
        (const int*)level, (const uint8_t*)drop, (float*)dtable, c, out, sr,
        vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
