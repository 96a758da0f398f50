// Sparse-conv gather-GEMM device code, float32 through 3xTF32 tensor-core
// MMAs or bfloat16 through bf16 MMAs (the element type is the kernel's
// template parameter), shared by gather_conv.cu (the forward, K1) and
// gather_conv_bwd.cu (the dfeats half of the backward, K3 and K4; its dW
// pass uses the tc:: helpers below):
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
//
// bfloat16 (the compute_dtype="bfloat16" model).  feats, W and out are
// bf16; the kernel takes W transposed, Wt (K, Cout, Cin), so that both
// operands' rows run along the reduction (Cin) and every fragment register
// (two bf16 values) is one 32-bit shared load.  Each 16-deep step is one
// mma.sync m16n8k16 bf16 with f32 accumulation into a fresh register tile,
// added to the running f32 sum round-to-nearest as in the f32 path; there
// is no split: a product of two bf16 values is exact in f32.  The sum is
// rounded to bf16 once, on the store (__float2bfloat16_rn).  Rows are
// gathered by 16-byte copies of 8 channels, so Cin must be a multiple of 8
// with 16-byte aligned rows (the wrapper pads Cin 5 to 8 with zeros);
// shared rows are padded by 8 bf16 (16 bytes), which keeps a warp's 32
// fragment loads on 32 banks.  The tile shapes are the f32 path's, with the
// channel chunk at least 16 (one MMA's depth).

#pragma once

#include <cuda_bf16.h>
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

// ---- bfloat16

// two bf16 at p (4-byte aligned), low half the first
__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// two bf16 from two places, low half lo
__device__ __forceinline__ unsigned pack_pair(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  const unsigned l = *reinterpret_cast<const unsigned short*>(lo);
  const unsigned h = *reinterpret_cast<const unsigned short*>(hi);
  return l | (h << 16);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's MT x NT m16n8 tiles over a BK-deep bf16 stage.  A element
// (m, k) is As[m * LDA + k], or As[k * LDA + m] when KM; B element (k, n)
// is Bs[n * LDB + k], or Bs[k * LDB + n] when KM.  A k-contiguous operand
// loads a fragment register whole; a k-major one packs it from two rows.
// Each 16-deep step goes to a fresh tile, added to acc round-to-nearest.
// Fragments (PTX m16n8k16 .bf16): lane = 4 g + t; A regs (g, 2t..2t+1)
// (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..), B regs (2t..2t+1, g)
// (2t+8.., g), C as the TF32 shape's.
template <int MT, int NT, int BK, int LDA, int LDB, bool KM>
__device__ __forceinline__ void mma_stage_bf16(const __nv_bfloat16* As,
                                               const __nv_bfloat16* Bs,
                                               float (&acc)[MT][NT][4],
                                               int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    unsigned b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j * 8 + g;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int kc = kk + 2 * t + q * 8;
        b[j][q] = KM ? pack_pair(Bs + kc * LDB + n, Bs + (kc + 1) * LDB + n)
                     : ld_pair(Bs + n * LDB + kc);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      unsigned a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + i * 16 + g + (q & 1) * 8;
        const int kc = kk + 2 * t + (q >> 1) * 8;
        a[q] = KM ? pack_pair(As + kc * LDA + r, As + (kc + 1) * LDA + r)
                  : ld_pair(As + r * LDA + kc);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, a, b[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += d[q];
      }
    }
  }
}

// store_tile for a bf16 dst: each sum rounded to bf16 once
template <int MT, int NT>
__device__ __forceinline__ void store_tile_bf16(
    const float (&acc)[MT][NT][4], __nv_bfloat16* dst, long long rows,
    int cols, long long ld, long long r0, int c0, int lane,
    const int* rowmap = nullptr) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = r0 + i * 16 + g + h * 8;
      if (r >= rows) continue;
      __nv_bfloat16* row = dst + (rowmap ? (long long)rowmap[r] : r) * ld;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + j * 8 + 2 * t;
        if (c < cols) row[c] = __float2bfloat16_rn(acc[i][j][2 * h]);
        if (c + 1 < cols)
          row[c + 1] = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
      }
    }
}

}  // namespace tc

namespace gather_gemm {

constexpr int kStages = 3;

// E: float (B staged k-major, (BK, BN)) or __nv_bfloat16 (B staged
// n-major, (BN, BK), from the transposed weights); sizes in elements
template <typename E, int BM, int BN, int BK, int WM, int WN>
struct Cfg {
  static constexpr bool kBf16 = sizeof(E) == 2;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int LDA = kBf16 ? BK + 8 : BK + 4;
  static constexpr int LDB = kBf16 ? BK + 8 : BN + 8;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = kBf16 ? BN * LDB : BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static_assert(MT >= 1 && NT >= 1 && BM % (16 * WM) == 0 &&
                    BN % (8 * WN) == 0 && BK % (kBf16 ? 16 : 8) == 0,
                "tile shape");
};

// position of the q-th set bit of mask (q < popc(mask))
__device__ __forceinline__ int nth_bit(unsigned mask, int q) {
  for (int i = 0; i < q; ++i) mask &= mask - 1;
  return __ffs(mask) - 1;
}

// w: W (K, Cin, Cout) for float, Wt (K, Cout, Cin) for bf16
template <typename E, int BM, int BN, int BK, int WM, int WN, bool kPerm>
__global__ void __launch_bounds__(WM * WN * 32, 2)
kernel(const E* __restrict__ feats, const int* __restrict__ idx,
       const E* __restrict__ w, E* __restrict__ out, int n,
       long long m, int k, int cin, int cout, int vec_a, int vec_b,
       const int* __restrict__ perm) {
  using C = Cfg<E, BM, BN, BK, WM, WN>;
  constexpr int T = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  int* rows = reinterpret_cast<int*>(smem + kStages * C::STAGE);
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
    E* As = smem + buf * C::STAGE;
    E* Bs = As + C::A_ELEMS;
    const int* rj = rows + j;
    if constexpr (C::kBf16) {
      // 16-byte copies of 8 channels (Cin % 8 == 0, 16-byte aligned rows)
      for (int e = tid; e < BM * (BK / 8); e += T) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int row = rj[r * k], cc = c0 + c;
        const bool ok = (unsigned)row < (unsigned)n && cc < cin;
        tc::cp_async16(As + r * C::LDA + c,
                       ok ? feats + (long long)row * cin + cc : feats,
                       ok ? 16 : 0);
      }
      const E* wj = w + (long long)j * cin * cout;     // Wt[j] (Cout, Cin)
      for (int e = tid; e < BN * (BK / 8); e += T) {
        const int nr = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int nn = n0 + nr, cc = c0 + c;
        const bool ok = nn < cout && cc < cin;
        tc::cp_async16(Bs + nr * C::LDB + c,
                       ok ? wj + (long long)nn * cin + cc : w, ok ? 16 : 0);
      }
    } else {
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
    const E* As = smem + (s % kStages) * C::STAGE;
    if constexpr (C::kBf16)
      tc::mma_stage_bf16<C::MT, C::NT, BK, C::LDA, C::LDB, false>(
          As, As + C::A_ELEMS, acc, wm0, wn0, lane);
    else
      tc::mma_stage<C::MT, C::NT, BK, C::LDA, C::LDB, false>(
          As, As + C::A_ELEMS, acc, wm0, wn0, lane);
  }
  tc::cp_wait<0>();

  if constexpr (C::kBf16) {
    if constexpr (kPerm)
      tc::store_tile_bf16(acc, out, tile_rows, cout, cout, wm0, n0 + wn0,
                          lane, rows + BM * k);
    else
      tc::store_tile_bf16(acc, out, m, cout, cout, m0 + wm0, n0 + wn0, lane);
  } else if constexpr (kPerm) {
    tc::store_tile_rows(acc, out, rows + BM * k, (int)tile_rows, cout, cout,
                        wm0, n0 + wn0, lane);
  } else {
    tc::store_tile(acc, out, m, cout, cout, m0 + wm0, n0 + wn0, lane);
  }
}

template <typename E, int BM, int BN, int BK, int WM, int WN, bool kPerm>
cudaError_t launch_cfg(const E* feats, const int* idx, const E* w, E* out,
                       int n, long long m, int k, int cin, int cout,
                       int vec_a, int vec_b, const int* perm,
                       cudaStream_t s) {
  using C = Cfg<E, BM, BN, BK, WM, WN>;
  const size_t smem = sizeof(E) * kStages * C::STAGE +
                      sizeof(int) * BM * (k + (kPerm ? 1 : 0));
  auto fn = kernel<E, BM, BN, BK, WM, WN, kPerm>;
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
template <typename E, int BK, bool kPerm>
cudaError_t launch_bk(const E* feats, const int* idx, const E* w, E* out,
                      int n, long long m, int k, int cin, int cout,
                      int vec_a, int vec_b, const int* perm,
                      cudaStream_t s) {
  if (cout > 64)
    return launch_cfg<E, 64, 128, BK, 2, 4, kPerm>(
        feats, idx, w, out, n, m, k, cin, cout, vec_a, vec_b, perm, s);
  if (cout > 32)
    return launch_cfg<E, 128, 64, BK, 4, 2, kPerm>(
        feats, idx, w, out, n, m, k, cin, cout, vec_a, vec_b, perm, s);
  if (cout > 16)
    return launch_cfg<E, 128, 32, BK, 4, 1, kPerm>(
        feats, idx, w, out, n, m, k, cin, cout, vec_a, vec_b, perm, s);
  return launch_cfg<E, 128, 16, BK, 4, 1, kPerm>(
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
    return launch_bk<float, 32, kPerm>(feats, idx, w, out, n, m, k, cin,
                                       cout, vec_a, vec_b, perm, s);
  if (cin > 8)
    return launch_bk<float, 16, kPerm>(feats, idx, w, out, n, m, k, cin,
                                       cout, vec_a, vec_b, perm, s);
  return launch_bk<float, 8, kPerm>(feats, idx, w, out, n, m, k, cin, cout,
                                    vec_a, vec_b, perm, s);
}

// The bf16 gather-GEMM: feats (N, Cin), wt (K, Cout, Cin) the transposed
// weights, out (M, Cout), all bf16.  Cin % 8 == 0 and every base 16-byte
// aligned (else invalid value: the 16-byte row copies need both).  The
// channel chunk is 32 above 16 channels, else 16; the block tiles follow
// Cout as in the f32 path.
template <bool kPerm = false>
inline cudaError_t launch_bf16(const __nv_bfloat16* feats, const int* idx,
                               const __nv_bfloat16* wt, __nv_bfloat16* out,
                               int n, long long m, int k, int cin, int cout,
                               cudaStream_t s, const int* perm = nullptr) {
  if (k < 1 || k > 32 || cin < 1 || cout < 0 || n < 0 || m < 0 ||
      cin % 8 != 0 || !tc::aligned16(feats) || !tc::aligned16(wt))
    return cudaErrorInvalidValue;
  if (m == 0 || cout == 0) return cudaSuccess;
  if (cin > 16)
    return launch_bk<__nv_bfloat16, 32, kPerm>(feats, idx, wt, out, n, m, k,
                                               cin, cout, 1, 1, perm, s);
  return launch_bk<__nv_bfloat16, 16, kPerm>(feats, idx, wt, out, n, m, k,
                                             cin, cout, 1, 1, perm, s);
}

}  // namespace gather_gemm
