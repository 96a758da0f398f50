// Key-table rulebook lookup through a hash table built on the card, CUDA
// C++ for sm_90a.
//
// Replaces the TPU kernel srfdet3d_tpu/ops/pallas_rulebook.py::rulebook_lookup
// (kernel body _kernel).  For each query key of each kernel offset it finds
// the equal key in an ascending key array and returns that key's row:
//
//     out[m, k] = rows[pos]   where pos is the first position with
//                             keys[pos] == queries[m, k]
//     out[m, k] = n_keys      (the miss row) for a key that is absent, and
//                             for an invalid query (< 0 or >= sentinel)
//
// `rows` lets the key array be a sorted view of rows in any order: the
// table rulebook's stage-0 voxels arrive plan-major, and their z-major keys
// are sorted once with the permutation kept as `rows`.  Later stages are
// already in key order and pass rows = 0..n_keys-1.
//
// Design.  A stage's key table serves two lookups (the stage's subm
// rulebook and the next strided conv's input rows), so it is hashed once
// per stage into an open-addressing table of 2^ceil(log2 2N) slots (load
// factor at most 0.5).  A slot is one 64-bit word, key << 24 | row (keys
// below 2^40, rows below 2^24), all ones when empty, so one 64-bit
// atomicCAS inserts a key with its row.  Slots group into buckets of 4,
// one 32-byte sector: a key's home bucket is the top bits of
// key * 0x9E3779B97F4A7C15 (Fibonacci hashing), it is inserted by linear
// probing from the bucket's first slot, and a lookup reads a whole bucket
// a round (two 16-byte loads) until the equal key or an empty slot.  Each
// key in [0, sentinel) that is the first of its run in the sorted array
// goes in, so the row found equals the one a search for the leftmost equal
// key gives (the per-sample padding keys, one run a sample, are the only
// repeats), and the result does not depend on the order of insertion
// although the slots do.  At load <= 0.5 an empty slot always exists, so
// every probe ends.
//
// Why buckets: a warp waits for its longest probe, and each probe round is
// a dependent L2 load.  One 16-byte slot a round (this kernel's first
// design) took a warp ~11 rounds at KITTI stage 0 (load 0.5, ~96% of the
// queries missing) and ran no faster than the old 17-deep binary search;
// a 4-slot bucket a round takes ~3.3.  The insert, too, reads a bucket a
// round and spends an atomicCAS only on the slots it saw empty.
//
// What bounds it: the bytes.  A lookup reads its query (8 B) and writes its
// row (4 B); the table (1-2 MB at the shipped stages) stays in L2.  The
// TPU kernel's super-row windows, lane-wise equality sums, out-of-window
// flags and correction pass exist because Mosaic has no dynamic gather;
// here a probe reads any slot directly, so the kernel is exact for any
// query order and needs none.
//
// Interface: plain C, pointers from torch tensors, launched on the caller's
// stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kEmpty = ~0ull;
constexpr int kRowBits = 24;
constexpr unsigned long long kRowMask = (1ull << kRowBits) - 1;

// first slot of the key's home bucket (buckets of 4 slots)
__device__ __forceinline__ unsigned long long home(long long key, int shift) {
  return (((unsigned long long)key * 0x9E3779B97F4A7C15ull) >> shift) << 2;
}

__global__ void key_hash_fill_kernel(ulonglong2* __restrict__ table,
                                     long long pairs) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < pairs; i += stride)
    table[i] = make_ulonglong2(kEmpty, kEmpty);
}

__global__ void key_hash_insert_kernel(const long long* __restrict__ keys,
                                       const int* __restrict__ rows,
                                       long long n_keys, long long sentinel,
                                       unsigned long long* __restrict__ table,
                                       unsigned long long mask, int shift) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_keys) return;
  long long key = keys[i];
  if (key < 0 || key >= sentinel) return;
  if (i > 0 && keys[i - 1] == key) return;   // not the first of its run
  const unsigned long long word =
      ((unsigned long long)key << kRowBits) | (unsigned long long)rows[i];
  // read a bucket (from L2: other threads' inserts land there), then try
  // its empty slots in order; a slot never empties again, so a stale
  // "empty" only costs a failed atomicCAS, which returns the slot's word
  unsigned long long h = home(key, shift);
  while (true) {
    const ulonglong2* bucket = reinterpret_cast<const ulonglong2*>(table + h);
    ulonglong2 a = __ldcg(bucket), b = __ldcg(bucket + 1);
    unsigned long long slot[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned long long seen = slot[j];
      if (seen == kEmpty) {
        seen = atomicCAS(table + h + j, kEmpty, word);
        if (seen == kEmpty) return;            // inserted
      }
      if ((seen >> kRowBits) == (unsigned long long)key) return;  // repeat
    }
    h = (h + 4) & mask;
  }
}

__global__ void rulebook_lookup_kernel(
    const unsigned long long* __restrict__ table, unsigned long long mask,
    int shift, const long long* __restrict__ queries, long long n_queries,
    long long sentinel, int miss, int* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_queries) return;
  long long q = __ldg(queries + t);
  int res = miss;
  if (q >= 0 && q < sentinel) {
    const unsigned long long uq = (unsigned long long)q;
    unsigned long long h = home(q, shift);
    bool done = false;
    while (!done) {
      const ulonglong2* bucket = reinterpret_cast<const ulonglong2*>(table + h);
      ulonglong2 a = __ldg(bucket), b = __ldg(bucket + 1);
      unsigned long long slot[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
      for (int j = 0; j < 4 && !done; ++j) {
        if (slot[j] == kEmpty) {
          done = true;
        } else if ((slot[j] >> kRowBits) == uq) {
          res = (int)(slot[j] & kRowMask);
          done = true;
        }
      }
      h = (h + 4) & mask;
    }
  }
  out[t] = res;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// table (2^log2_slots words) <- the first occurrence of each valid key
int key_hash_build(const void* keys, const void* rows, long long n_keys,
                   long long sentinel, void* table, int log2_slots,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long slots = 1ull << log2_slots;
  long long pairs = (long long)(slots / 2);
  long long fill_blocks = (pairs + 255) / 256;
  if (fill_blocks > 4096) fill_blocks = 4096;
  key_hash_fill_kernel<<<(unsigned)fill_blocks, 256, 0, st>>>(
      (ulonglong2*)table, pairs);
  if (n_keys > 0) {
    const int threads = 256;
    long long blocks = (n_keys + threads - 1) / threads;
    key_hash_insert_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        (const long long*)keys, (const int*)rows, n_keys, sentinel,
        (unsigned long long*)table, slots - 1, 64 - (log2_slots - 2));
  }
  return (int)cudaGetLastError();
}

int rulebook_lookup(const void* table, int log2_slots, const void* queries,
                    long long n_queries, long long sentinel, int miss,
                    void* out, void* stream) {
  if (n_queries > 0) {
    const int threads = 256;
    long long blocks = (n_queries + threads - 1) / threads;
    unsigned long long slots = 1ull << log2_slots;
    rulebook_lookup_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (const unsigned long long*)table, slots - 1, 64 - (log2_slots - 2),
        (const long long*)queries, n_queries, sentinel, miss, (int*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
