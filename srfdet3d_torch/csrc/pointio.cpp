// Host-side point-cloud kernels of the data pipeline, with a plain C
// interface bound through ctypes (srfdet3d_torch/data/native.py).
//
// The per-sample hot loop of a LiDAR sample (load the .bin file, keep the
// points inside pc_range, shuffle them, pad to the fixed capacity) runs
// here in C++ instead of numpy.  The caller allocates every output; no
// function touches a Python object, so ctypes calls them with the
// interpreter lock released and the loader's threads run them in parallel.
//
// The shuffle is the JAX package's C++ route's (native/pointio.cpp): a
// Fisher-Yates pass over the in-range row indices drawing
// std::mt19937_64(seed)() % i, whose draws the C++ standard defines, so
// both give the same rows in the same order.
//
// Entries (each returns 0 or a negative error code unless noted):
//   pointio_count_rows(path, load_dim, &rows, &bytes)
//       rows of a float32 (N, load_dim) .bin file; -1 cannot open,
//       -2 a trailing partial row (bytes holds the file's size)
//   pointio_load(path, load_dim, rows, out)
//       reads rows x load_dim floats into out; -1 cannot open, -3 the file
//       does not hold exactly that many rows
//   pointio_filter_pad(src, n, d, range6, cap, shuffle, seed, dst, mask)
//       -> the kept count; dst (cap, d) and mask (cap,) come zeroed
//   pointio_transform(points, n, d, rot3x3, trans3)
//       xyz' = R xyz + t in place

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <utility>
#include <vector>

extern "C" {

int pointio_count_rows(const char* path, int load_dim, int64_t* rows,
                       int64_t* bytes) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fclose(f);
  *bytes = size;
  const long row_bytes = static_cast<long>(sizeof(float)) * load_dim;
  if (size % row_bytes != 0) return -2;
  *rows = size / row_bytes;
  return 0;
}

int pointio_load(const char* path, int load_dim, int64_t rows, float* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const size_t want = static_cast<size_t>(rows) * load_dim;
  const size_t got = std::fread(out, sizeof(float), want, f);
  // one more byte means the file grew since it was counted
  const bool longer = std::fgetc(f) != EOF;
  std::fclose(f);
  return (got != want || longer) ? -3 : 0;
}

int64_t pointio_filter_pad(const float* src, int64_t n, int64_t d,
                           const float* r, int64_t cap, int shuffle,
                           uint64_t seed, float* dst, uint8_t* mask) {
  std::vector<int64_t> idx;
  idx.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    const float* p = src + i * d;
    if (p[0] >= r[0] && p[0] <= r[3] && p[1] >= r[1] && p[1] <= r[4] &&
        p[2] >= r[2] && p[2] <= r[5])
      idx.push_back(i);
  }
  if (shuffle) {
    std::mt19937_64 gen(seed);
    for (size_t i = idx.size(); i > 1; --i) {
      const size_t j = gen() % i;
      std::swap(idx[i - 1], idx[j]);
    }
  }
  int64_t kept = static_cast<int64_t>(idx.size());
  if (kept > cap) kept = cap;
  for (int64_t i = 0; i < kept; ++i) {
    std::memcpy(dst + i * d, src + idx[i] * d, sizeof(float) * d);
    mask[i] = 1;
  }
  return kept;
}

void pointio_transform(float* p, int64_t n, int64_t d, const float* R,
                       const float* t) {
  for (int64_t i = 0; i < n; ++i) {
    float* q = p + i * d;
    const float x = q[0], y = q[1], z = q[2];
    q[0] = R[0] * x + R[1] * y + R[2] * z + t[0];
    q[1] = R[3] * x + R[4] * y + R[5] * z + t[1];
    q[2] = R[6] * x + R[7] * y + R[8] * z + t[2];
  }
}

}  // extern "C"
