// Sparse-conv gather-GEMM device code, float32 through 3xTF32 tensor-core
// MMAs, shared by gather_conv.cu (the forward, K1) and gather_conv_bwd.cu
// (the dfeats half of the backward, K3 and K4; its dW pass uses the tc::
// helpers below; the bf16 kernels are in gather_gemm_sm90.cuh):
//
//     out[m, :] = sum_j feats[idx[m, j], :] @ W[j]      (idx == N: a miss, zeros)
//
// feats (N, Cin), idx (M, K) int32 in [0, N], K <= 32, W (K, Cin, Cout),
// out (M, Cout).
//
// 3xTF32.  Each operand is split as hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi); each 8-deep step of the product is summed as
// lo*hi + hi*lo + hi*hi by mma.sync m16n8k8 TF32 into a fresh f32 register
// tile, small terms first, and added to the running f32 sum with a
// round-to-nearest add (the tensor core's own f32 sum truncates, and a
// running sum over thousands of rows would drift).  The dropped lo*lo term
// and lo's own rounding leave each product within about 2^-21 of its f32
// value, so the sums stay f32-faithful (the Hopper analogue of the TPU
// kernel's bf16x3 split).  A plain 1-term TF32 product (2^-11) is never
// used.
//
// The block.  One block owns BM output rows x BN output columns, split over
// WM x WN warps of MT x NT m16n8 tiles each.  It loads its (BM, K) slice of
// idx into shared memory once and ORs a 32-bit mask of the offsets that hit
// some row of the tile; an offset that misses for every row is skipped.  The
// work is a list of steps, one per (offset that hits, BK-channel chunk).  A
// 3-stage cp.async ring overlaps the gather of step s+2 with the MMAs of
// step s: the gather copies each hit row's channel chunk (16 B copies where
// Cin % 4 == 0 and the base is 16 B aligned, else 4 B), a missed row or a
// channel past Cin copies with src-size 0, which zero-fills without a read;
// W[j]'s chunk is staged the same way.  Shared rows are padded (A by 4
// floats, B by 8) so that every fragment load of a warp hits 32 banks.
// Above 48 KB the shared memory is dynamic, after cudaFuncSetAttribute.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; src_bytes < 16 zero-fills the rest and 0
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32 (round to nearest, ties away from zero)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's MT x NT m16n8 tiles over a BK-deep shared-memory stage, 3xTF32.
// A element (m, k) is As[m * LDA + k], or As[k * LDA + m] when A_KM; B
// element (k, n) is Bs[k * LDB + n].  m0, n0: the warp's first row and
// column in the stage.  Each k8 step sums its three products into a fresh
// tile, added to acc with a round-to-nearest f32 add: the tensor core's own
// f32 sum truncates, which drifts a long running sum of one sign.
// Fragments (PTX m16n8k8 .tf32): lane = 4 g + t; A (g, t) (g+8, t) (g, t+4)
// (g+8, t+4), B (t, g) (t+4, g), C (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1).
template <int MT, int NT, int BK, int LDA, int LDB, bool A_KM>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs,
                                          float (&acc)[MT][NT][4], int m0,
                                          int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    unsigned bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        split(Bs[(kk + t + q * 4) * LDB + n0 + j * 8 + g], bh[j][q],
              bl[j][q]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      unsigned ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + i * 16 + g + (q & 1) * 8;
        const int c = kk + t + (q >> 1) * 4;
        split(A_KM ? As[c * LDA + r] : As[r * LDA + c], ah[q], al[q]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma(d, al, bh[j]);
        mma(d, ah, bl[j]);
        mma(d, ah, bh[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += d[q];
      }
    }
  }
}

// Store one warp's accumulators to dst (rows x cols, row stride ld), rows
// from r0 and columns from c0 of the warp's tile, masked at the edges.
template <int MT, int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][NT][4],
                                           float* dst, long long rows,
                                           int cols, long long ld,
                                           long long r0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = r0 + i * 16 + g + h * 8;
      if (r >= rows) continue;
      float* row = dst + r * ld;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + j * 8 + 2 * t;
        if (c < cols) row[c] = acc[i][j][2 * h];
        if (c + 1 < cols) row[c + 1] = acc[i][j][2 * h + 1];
      }
    }
}

// store_tile through a row map: the warp's tile row r (from r0, below
// rows) goes to dst row rowmap[r]
template <int MT, int NT>
__device__ __forceinline__ void store_tile_rows(
    const float (&acc)[MT][NT][4], float* dst, const int* rowmap, int rows,
    int cols, long long ld, int r0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + i * 16 + g + h * 8;
      if (r >= rows) continue;
      float* row = dst + (long long)rowmap[r] * ld;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + j * 8 + 2 * t;
        if (c < cols) row[c] = acc[i][j][2 * h];
        if (c + 1 < cols) row[c + 1] = acc[i][j][2 * h + 1];
      }
    }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace tc

namespace gather_gemm {

constexpr int kStages = 3;

template <int BM, int BN, int BK, int WM, int WN>
struct Cfg {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int LDA = BK + 4, LDB = BN + 8;
  static constexpr int A_FLOATS = BM * LDA, B_FLOATS = BK * LDB;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static_assert(MT >= 1 && NT >= 1 && BM % (16 * WM) == 0 &&
                    BN % (8 * WN) == 0 && BK % 8 == 0,
                "tile shape");
};

// position of the q-th set bit of mask (q < popc(mask))
__device__ __forceinline__ int nth_bit(unsigned mask, int q) {
  for (int i = 0; i < q; ++i) mask &= mask - 1;
  return __ffs(mask) - 1;
}

template <int BM, int BN, int BK, int WM, int WN, bool kPerm>
__global__ void __launch_bounds__(WM * WN * 32, 2)
kernel(const float* __restrict__ feats, const int* __restrict__ idx,
       const float* __restrict__ w, float* __restrict__ out, int n,
       long long m, int k, int cin, int cout, int vec_a, int vec_b,
       const int* __restrict__ perm) {
  using C = Cfg<BM, BN, BK, WM, WN>;
  constexpr int T = C::kThreads;
  extern __shared__ __align__(16) float smem[];
  int* rows = reinterpret_cast<int*>(smem + kStages * C::STAGE_FLOATS);
  __shared__ unsigned warp_mask[T / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long tile_rows = m - m0 < BM ? m - m0 : BM;

  // the tile's rulebook slice, and the offsets that hit some row of it.
  // kPerm: the tile's rows are staged first (in the BM ints after the
  // slice), then the slice is copied by cp.async, all of it in flight at
  // once: the grouped rows are scattered, and a tile of few steps would
  // otherwise wait on its rulebook reads one after another
  unsigned mine = 0;
  if constexpr (kPerm) {
    int* prow = rows + BM * k;
    for (int r = tid; r < BM; r += T)
      prow[r] = r < tile_rows ? perm[m0 + r] : 0;
    __syncthreads();
    for (int e = tid; e < BM * k; e += T) {
      const int r = e / k;
      const bool ok = r < tile_rows;
      tc::cp_async4(rows + e,
                    ok ? idx + (long long)prow[r] * k + (e - r * k) : idx,
                    ok ? 4 : 0);
    }
    tc::cp_commit();
    tc::cp_wait<0>();
    for (int e = tid; e < BM * k; e += T) {  // this thread's own copies
      const int r = e / k;
      const int row = r < tile_rows ? rows[e] : n;
      rows[e] = row;
      if ((unsigned)row < (unsigned)n) mine |= 1u << (e - r * k);
    }
  } else {
    for (int e = tid; e < BM * k; e += T) {
      const int r = e / k;
      const int row = r < tile_rows ? idx[m0 * k + e] : n;
      rows[e] = row;
      if ((unsigned)row < (unsigned)n) mine |= 1u << (e - r * k);
    }
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if (lane == 0) warp_mask[warp] = mine;
  __syncthreads();
  unsigned mask = 0;
#pragma unroll
  for (int i = 0; i < T / 32; ++i) mask |= warp_mask[i];
  const int chunks = (cin + BK - 1) / BK;
  const int steps = __popc(mask) * chunks;

  // step s: the q-th offset that hits, channel chunk s % chunks
  auto load = [&](int s, int buf) {
    const int q = s / chunks;
    const int j = nth_bit(mask, q);
    const int c0 = (s - q * chunks) * BK;
    float* As = smem + buf * C::STAGE_FLOATS;
    float* Bs = As + C::A_FLOATS;
    const int* rj = rows + j;
    if (vec_a) {
      for (int e = tid; e < BM * (BK / 4); e += T) {
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const int row = rj[r * k], cc = c0 + c;
        const bool ok = (unsigned)row < (unsigned)n && cc < cin;
        tc::cp_async16(As + r * C::LDA + c,
                       ok ? feats + (long long)row * cin + cc : feats,
                       ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += T) {
        const int r = e / BK, c = e % BK;
        const int row = rj[r * k], cc = c0 + c;
        const bool ok = (unsigned)row < (unsigned)n && cc < cin;
        tc::cp_async4(As + r * C::LDA + c,
                      ok ? feats + (long long)row * cin + cc : feats,
                      ok ? 4 : 0);
      }
    }
    const float* wj = w + (long long)j * cin * cout;
    if (vec_b) {
      for (int e = tid; e < BK * (BN / 4); e += T) {
        const int kr = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int cc = c0 + kr, nn = n0 + c;
        const bool ok = cc < cin && nn < cout;
        tc::cp_async16(Bs + kr * C::LDB + c,
                       ok ? wj + (long long)cc * cout + nn : w, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BK * BN; e += T) {
        const int kr = e / BN, c = e % BN;
        const int cc = c0 + kr, nn = n0 + c;
        const bool ok = cc < cin && nn < cout;
        tc::cp_async4(Bs + kr * C::LDB + c,
                      ok ? wj + (long long)cc * cout + nn : w, ok ? 4 : 0);
      }
    }
  };

  float acc[C::MT][C::NT][4] = {};
  const int wm0 = (warp % WM) * (BM / WM), wn0 = (warp / WM) * (BN / WN);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    tc::cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_wait<kStages - 2>();
    __syncthreads();  // step s landed for every thread; step s-1 is done
    const int next = s + kStages - 1;
    if (next < steps) load(next, next % kStages);
    tc::cp_commit();
    const float* As = smem + (s % kStages) * C::STAGE_FLOATS;
    tc::mma_stage<C::MT, C::NT, BK, C::LDA, C::LDB, false>(
        As, As + C::A_FLOATS, acc, wm0, wn0, lane);
  }
  tc::cp_wait<0>();

  if constexpr (kPerm)
    tc::store_tile_rows(acc, out, rows + BM * k, (int)tile_rows, cout, cout,
                        wm0, n0 + wn0, lane);
  else
    tc::store_tile(acc, out, m, cout, cout, m0 + wm0, n0 + wn0, lane);
}

template <int BM, int BN, int BK, int WM, int WN, bool kPerm>
cudaError_t launch_cfg(const float* feats, const int* idx, const float* w,
                       float* out, int n, long long m, int k, int cin,
                       int cout, int vec_a, int vec_b, const int* perm,
                       cudaStream_t s) {
  using C = Cfg<BM, BN, BK, WM, WN>;
  const size_t smem = sizeof(float) * kStages * C::STAGE_FLOATS +
                      sizeof(int) * BM * (k + (kPerm ? 1 : 0));
  auto fn = kernel<BM, BN, BK, WM, WN, kPerm>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
  fn<<<grid, C::kThreads, smem, s>>>(feats, idx, w, out, n, m, k, cin, cout,
                                     vec_a, vec_b, perm);
  return cudaGetLastError();
}

// The block tile follows Cout: 64 x 128 over 8 warps above 64 columns,
// 128 x 64 over 8 warps above 32, else 128 x 32 or 128 x 16 over 4 warps;
// every warp holds a 32 x 32 (or 32 x 16) accumulator.  (Measured on the
// card: 128 x 128 tiles leave SMs idle at 15k rows; 64 x 64 tiles re-read
// W[j] twice as often.)
template <int BK, bool kPerm>
cudaError_t launch_bk(const float* feats, const int* idx, const float* w,
                      float* out, int n, long long m, int k, int cin,
                      int cout, int vec_a, int vec_b, const int* perm,
                      cudaStream_t s) {
  if (cout > 64)
    return launch_cfg<64, 128, BK, 2, 4, kPerm>(
        feats, idx, w, out, n, m, k, cin, cout, vec_a, vec_b, perm, s);
  if (cout > 32)
    return launch_cfg<128, 64, BK, 4, 2, kPerm>(
        feats, idx, w, out, n, m, k, cin, cout, vec_a, vec_b, perm, s);
  if (cout > 16)
    return launch_cfg<128, 32, BK, 4, 1, kPerm>(
        feats, idx, w, out, n, m, k, cin, cout, vec_a, vec_b, perm, s);
  return launch_cfg<128, 16, BK, 4, 1, kPerm>(
      feats, idx, w, out, n, m, k, cin, cout, vec_a, vec_b, perm, s);
}

// The channel chunk follows Cin: 32 above 16 channels, else 16 or 8
// (Cin 4 and 5 pad their chunk with zero-filled copies).  K above 32 does
// not fit the offset mask and is refused.  kPerm: the block's rows are
// perm[m0 .. m0 + BM) (a permutation of the M rows), both for the rulebook
// rows read and for the output rows written, so that rows which hit the
// same offsets can share a tile (the strided backward's row grouping);
// without it, row i of the tile is row m0 + i.
template <bool kPerm = false>
inline cudaError_t launch(const float* feats, const int* idx, const float* w,
                          float* out, int n, long long m, int k, int cin,
                          int cout, cudaStream_t s,
                          const int* perm = nullptr) {
  if (k < 1 || k > 32 || cin < 1 || cout < 0 || n < 0 || m < 0)
    return cudaErrorInvalidValue;
  if (m == 0 || cout == 0) return cudaSuccess;
  const int vec_a = cin % 4 == 0 && tc::aligned16(feats);
  const int vec_b = cout % 4 == 0 && tc::aligned16(w);
  if (cin > 16)
    return launch_bk<32, kPerm>(feats, idx, w, out, n, m, k, cin, cout,
                                vec_a, vec_b, perm, s);
  if (cin > 8)
    return launch_bk<16, kPerm>(feats, idx, w, out, n, m, k, cin, cout,
                                vec_a, vec_b, perm, s);
  return launch_bk<8, kPerm>(feats, idx, w, out, n, m, k, cin, cout, vec_a,
                             vec_b, perm, s);
}

}  // namespace gather_gemm
