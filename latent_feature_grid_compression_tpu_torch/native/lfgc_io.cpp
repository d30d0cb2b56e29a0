// Host-side I/O helper of the PyTorch port: the port's own copy of two
// routines of the JAX package's native/lfgc_io.cpp, with the same
// algorithms, built with g++ at first use (native/lib.py) and called
// through ctypes:
//   * LZ4 block decompression with a streaming dictionary (.cvol slices);
//   * 1-D k-means (k-means++ seeds from std::mt19937_64, then Lloyd on the
//     sorted data) for the container's quantization.
// The k-means is the JAX helper's code line for line, so that the port
// writes the JAX package's container bytes for the same parameters (the
// container's bit packing is numpy's, io/container.py, and gives the JAX
// helper's bytes).  The LZ4 decoder refuses a malformed block (-1) where
// the JAX helper copies what it can: literals or a match past the block or
// the slice, and a match offset reaching before the dictionary.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// One LZ4 block into dst (dst_cap bytes).  `hist` (hist_len bytes, may be
// null) logically precedes dst: a match may reach back into it (cvol slices
// are compressed in streaming mode).  Returns the bytes written, or -1 on a
// malformed block.
int64_t lfgc_lz4_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                            int64_t dst_cap, const uint8_t* hist, int64_t hist_len) {
  int64_t ip = 0, op = 0;
  if (hist == nullptr) hist_len = 0;
  while (ip < src_len && op < dst_cap) {
    const uint8_t token = src[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= src_len) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > src_len || op + lit > dst_cap) return -1;
    std::memcpy(dst + op, src + ip, size_t(lit));
    ip += lit;
    op += lit;
    if (ip >= src_len) break;   // the last sequence holds literals only
    if (ip + 2 > src_len) return -1;
    const int64_t offset = src[ip] | (int64_t(src[ip + 1]) << 8);
    ip += 2;
    if (offset == 0 || offset > op + hist_len) return -1;
    int64_t mlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (ip >= src_len) return -1;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    if (op + mlen > dst_cap) return -1;
    const int64_t start = op - offset;
    for (int64_t k = 0; k < mlen; ++k) {
      const int64_t s = start + k;
      dst[op + k] = s >= 0 ? dst[s] : hist[hist_len + s];
    }
    op += mlen;
  }
  return op;
}

// 1-D k-means of n >= k >= 1 values: k-means++ seeds on the sorted data,
// then Lloyd iterations (at most max_iter), where each cluster is a run of
// the sorted values between the midpoints of neighbouring centers.
// centers (k, ascending), labels (n, in the data's order).
void lfgc_kmeans_1d(const float* data, int64_t n, int32_t k, int32_t max_iter, uint64_t seed,
                    float* centers, int32_t* labels) {
  std::vector<float> sorted(data, data + n);
  std::sort(sorted.begin(), sorted.end());

  std::mt19937_64 rng(seed);
  std::vector<float> c(k);
  std::uniform_int_distribution<int64_t> uni(0, n - 1);
  c[0] = sorted[uni(rng)];
  std::vector<double> d2(n);
  for (int64_t i = 0; i < n; ++i) {
    const double d = double(sorted[i]) - double(c[0]);
    d2[i] = d * d;
  }
  for (int32_t j = 1; j < k; ++j) {
    double sum = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      const double d = double(sorted[i]) - double(c[j - 1]);
      d2[i] = std::min(d2[i], d * d);
      sum += d2[i];
    }
    if (sum <= 0) {
      c[j] = sorted[uni(rng)];
      continue;
    }
    std::uniform_real_distribution<double> ur(0.0, sum);
    const double r = ur(rng);
    double acc = 0.0;
    int64_t pick = n - 1;
    for (int64_t i = 0; i < n; ++i) {
      acc += d2[i];
      if (acc >= r) {
        pick = i;
        break;
      }
    }
    c[j] = sorted[pick];
  }
  std::sort(c.begin(), c.end());

  std::vector<int64_t> cnt(k);
  std::vector<double> sum(k);
  for (int32_t it = 0; it < max_iter; ++it) {
    std::fill(cnt.begin(), cnt.end(), 0);
    std::fill(sum.begin(), sum.end(), 0.0);
    int32_t j = 0;
    for (int64_t i = 0; i < n; ++i) {
      const float x = sorted[i];
      while (j + 1 < k && std::abs(x - c[j + 1]) <= std::abs(x - c[j])) ++j;
      cnt[j]++;
      sum[j] += x;
    }
    bool changed = false;
    for (int32_t q = 0; q < k; ++q) {
      if (cnt[q] == 0) continue;
      const float nc = float(sum[q] / cnt[q]);
      if (nc != c[q]) {
        c[q] = nc;
        changed = true;
      }
    }
    std::sort(c.begin(), c.end());
    if (!changed) break;
  }

  std::memcpy(centers, c.data(), size_t(k) * sizeof(float));
  for (int64_t i = 0; i < n; ++i) {
    const float x = data[i];
    int32_t lo = 0, hi = k - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi) / 2;
      const float boundary = 0.5f * (c[mid] + c[mid + 1]);
      if (x <= boundary) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    labels[i] = lo;
  }
}

}  // extern "C"
